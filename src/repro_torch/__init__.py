"""PyTorch/CUDA port of the node-aware communication-model engine.

The package mirrors :mod:`repro` module for module (``repro_torch.comm.stack``
is the counterpart of ``repro.comm.stack``, and so on) and imports nothing
of it.  Host-side construction (the sparse substrate, ``CommPhase.build``,
the strategy rewrites, receive-order assembly) stays numpy; every pricing
pass over a :class:`~repro_torch.comm.stack.PhaseStack` runs on a torch
device, and its two reductions go through the hand-written CUDA kernels in
:mod:`repro_torch.kernels.comm_stack`.

Every entry point takes ``device=None``, which means CUDA
(:func:`repro_torch.device.resolve_device`); the host runs only when the
caller passes ``device="cpu"``, and then each kernel wrapper takes its plain
PyTorch version.
"""
