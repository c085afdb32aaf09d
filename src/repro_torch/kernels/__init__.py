"""Hand-written CUDA kernels of the port (the PhaseStack passes and the
block-ELL SpMV), each with its plain PyTorch version."""
