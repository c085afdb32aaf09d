"""Hand-written CUDA kernels of the port (the PhaseStack passes, the
block-ELL SpMV, flash attention and the SSD intra-chunk step), each with its
plain PyTorch version."""
