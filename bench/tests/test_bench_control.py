"""The control, the reference computed in float8 put in the program's
place, fails each cell's limits, where the program passes them: on the
card at each cell's own size (marked ``gpu``: ``pytest -m gpu bench/tests``
on a machine that has one), through ``calibrate.readings``.  On the CPU at
smoke size, where the limits set for the card do not apply, it separates
from the program."""
import pytest
import torch

from conftest import smoke_cell
from harness import checks, manifest

CELLS = ("hymba-1.5b.prefill-long", "deepseek-moe-16b.prefill-chat",
         "hymba-1.5b.prefill-short", "hymba-1.5b.train-4k")


def _fails(numbers, limits):
    return [c.name for c in checks.against(numbers, limits) if not c.ok]


def _readings(cell, seed, device, seconds):
    import calibrate
    return calibrate.readings(cell, seed, seconds, True, device)


@pytest.mark.parametrize("name", CELLS)
def test_control_separates_from_the_program_at_smoke_size(name):
    # the limits are set at each cell's own size; at smoke size the control
    # reads three times the program's reading or more on one of them
    cell = smoke_cell(name)
    row = _readings(cell, 2**33 + 1, torch.device("cpu"), 0.3)
    assert any(row["control"][k] >= 3 * row["program"][k]
               for k in cell.limits), row


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full size")
    cell = manifest.load_cell(name)
    row = _readings(cell, 2**34 + 3, torch.device("cuda", 0), 4.0)
    assert not _fails(row["program"], cell.limits), row
    assert _fails(row["control"], cell.limits), row


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["half_batch", "attn_dq_doubled",
                                   "ssd_bwd_negated"])
def test_training_faults_fail_on_the_card(fault):
    # at smoke size a doubled dq moves the change too little to fail the
    # limits set for the card; at the card's size it fails them
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full size")
    import calibrate

    cell = manifest.load_cell("hymba-1.5b.train-4k")
    with calibrate.FAULTS[fault]():
        row = _readings(cell, 2**34 + 7, torch.device("cuda", 0), 0.0)
    assert _fails(row["program"], cell.limits), row
