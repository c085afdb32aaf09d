"""Hand-written CUDA kernels for the PhaseStack passes, with plain versions."""
