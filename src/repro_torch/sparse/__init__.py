"""Sparse substrate: CSR matrices, model problems, partitions and AMG."""
