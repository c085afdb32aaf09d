"""The plain references the benchmark judges the program by: float32
PyTorch with TF32 off, written from the models' equations, importing
nothing of the program and taking nothing it made."""
