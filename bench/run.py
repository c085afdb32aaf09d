"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
                         --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration, traffic mix, per-layer metrics and the limits
of its output check are files under ``bench/`` found by name
(:mod:`harness.manifest`).  The run sets up the program (``repro_torch``)
with weights and inputs made from ``--seed`` on the card, warms every shape
the cell uses, measures for ``--seconds``, checks the outputs against the
plain float32 reference in ``bench/reference/`` and prints one JSON object
as the last line of standard output.  With ``--trace 1`` the line carries
the cell's per-layer metrics, read from ``torch.profiler`` over a short
stretch after the window, instead of its end-to-end ones.

It exits with a code other than 0, and prints no result, when there is no
CUDA device (or fewer than the cell asks for), when ``repro_torch`` is not
in the checkout, or when ``jax`` or the JAX package was loaded.
"""
import time

# set-up counts from the process's start, before torch is imported
_T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches a library of the program could write go inside the checkout, at a
# fixed path, so that only the first run of a cell there builds
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(HERE / ".cache" / _sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="cell name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    from harness.cli import main

    sys.exit(main(parse(), _T0))
