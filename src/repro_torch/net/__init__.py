"""Machine descriptions and the event simulator (stack path).

Re-exports the names of ``repro.net``'s ``__all__`` that the port defines
in the same submodules; the per-phase simulator and the ping-pong
measurements wait for ROADMAP item 9.
"""
from .machine import (MachineSpec, blue_waters_machine, tpu_v5e_machine,
                      lassen_machine, frontier_machine)
from .simulator import PhaseResult, simulate_many

__all__ = [
    "MachineSpec", "blue_waters_machine", "tpu_v5e_machine",
    "lassen_machine", "frontier_machine",
    "PhaseResult", "simulate_many",
]
