"""Sparse substrate: CSR matrices, model problems, partitions and AMG,
with the AMG V-cycle on the device."""
from .csr import CSR, eye, diag
from .problems import poisson_3d, elasticity_like_3d
from .partition import (RowPartition, CommPattern, spmv_comm_pattern,
                        spgemm_comm_pattern, stack_patterns)
from .amg import build_hierarchy, vcycle, AMGLevel, DeviceHierarchy

__all__ = [
    "CSR", "eye", "diag",
    "poisson_3d", "elasticity_like_3d",
    "RowPartition", "CommPattern", "spmv_comm_pattern", "spgemm_comm_pattern",
    "stack_patterns",
    "build_hierarchy", "vcycle", "AMGLevel", "DeviceHierarchy",
]
