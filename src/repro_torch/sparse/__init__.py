"""Sparse substrate: CSR matrices, model problems, partitions and AMG,
with the AMG V-cycle on the device, and the model-guided partition search
priced incrementally on the device."""
from .csr import CSR, eye, diag
from .problems import poisson_3d, elasticity_like_3d
from .partition import (RowPartition, CommPattern, spmv_comm_pattern,
                        spgemm_comm_pattern, stack_patterns,
                        SpmvPatternState, spmv_comm_pattern_delta)
from .amg import build_hierarchy, vcycle, AMGLevel, DeviceHierarchy
from .optimize import Move, OptimizeResult, optimize_partition

__all__ = [
    "CSR", "eye", "diag",
    "poisson_3d", "elasticity_like_3d",
    "RowPartition", "CommPattern", "spmv_comm_pattern", "spgemm_comm_pattern",
    "stack_patterns", "SpmvPatternState", "spmv_comm_pattern_delta",
    "build_hierarchy", "vcycle", "AMGLevel", "DeviceHierarchy",
    "Move", "OptimizeResult", "optimize_partition",
]
