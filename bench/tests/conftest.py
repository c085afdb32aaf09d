"""Shared helpers of the benchmark's tests: ``bench/`` and ``src/`` on the
path, and the benchmark's cells cut to a size a CPU test holds."""
import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Each configuration at a size the CPU holds: every kind of layer, two
#: layers after the leading dense one, small widths.
SMOKE = {
    "hymba-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, vocab_size=256, ssm_state=8,
                       ssm_head_dim=16, ssm_chunk=16),
    "deepseek-moe-16b": dict(n_layers=3, d_model=64, n_heads=4,
                             n_kv_heads=4, d_head=16, d_ff=128,
                             vocab_size=256, n_experts=8,
                             n_experts_active=2, n_shared_experts=1,
                             moe_d_ff=32, first_dense_layers=1,
                             moe_chunk_tokens=128),
}

SMOKE_TRAFFIC = {
    "prefill_closed": dict(lengths=[32, 64], steps=[2, 1],
                           tokens_per_step=128, cache_extra=8,
                           check={"steps_per_length": 1}),
    "train_steps": dict(rows=2, seq=64, microbatches=1, check_steps=3),
}


def smoke_cell(name: str):
    """The benchmark's cell ``name`` at smoke size (the configuration's
    numbers and the mix's lengths replaced, its kind and limits kept)."""
    from harness import manifest

    cell = manifest.load_cell(name)
    config = dict(cell.config, **SMOKE[cell.config_name])
    traffic = dict(cell.traffic, **SMOKE_TRAFFIC[cell.driver])
    return dataclasses.replace(cell, config=config, traffic=traffic)


@pytest.fixture
def cpu():
    import torch
    torch.manual_seed(0)
    return torch.device("cpu")
