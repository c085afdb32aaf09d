"""Step functions and command-line drivers of the port (counterpart of
``repro.launch``): the train, prefill and serve steps, and ``train`` and
``serve`` as ``python -m repro_torch.launch.train`` / ``.serve``."""
