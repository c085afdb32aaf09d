"""Machine descriptions, the event simulator and the ping-pong
measurements (paper Algorithm 1).

Re-exports every name of ``repro.net``'s ``__all__``.
"""
from .machine import (MachineSpec, blue_waters_machine, tpu_v5e_machine,
                      lassen_machine, frontier_machine)
from .simulator import (PhaseResult, SequenceResult, simulate, simulate_phase,
                        simulate_many, simulate_sequence)
from .pingpong import (
    pingpong_time, pingpong_sweep, ppn_sweep, high_volume_pingpong,
    contention_line_test,
)

__all__ = [
    "MachineSpec", "blue_waters_machine", "tpu_v5e_machine",
    "lassen_machine", "frontier_machine",
    "PhaseResult", "SequenceResult", "simulate", "simulate_phase",
    "simulate_many", "simulate_sequence",
    "pingpong_time", "pingpong_sweep", "ppn_sweep", "high_volume_pingpong",
    "contention_line_test",
]
