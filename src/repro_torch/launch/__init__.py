"""Step functions of the port (counterpart of ``repro.launch``): prefill and
serve only so far."""
