"""Strategy execution: lower rewrites to runnable schedules, run them as
virtual ranks on one device, and close the measured-vs-predicted loop.

Pipeline: :func:`~repro_torch.exec.plan.build_schedule` lowers one strategy
of a bound phase to permutation rounds (:mod:`repro_torch.exec.plan`); the
serial numpy executor replays them as the bit-identity oracle
(:mod:`repro_torch.exec.reference`, whose digest sums through K1); the
virtual-rank executor runs them on the device, each simulated rank a row
of one tensor, or, given a rank mesh, each simulated rank a member of its
process group (:mod:`repro_torch.exec.lower`); timed runs and ordering
comparisons live in :mod:`repro_torch.exec.measure`; fitted parameter
tables from recorded sweeps in :mod:`repro_torch.exec.calibrate`; and
:mod:`repro_torch.exec.presets` ships the 8-rank host-scale machines.

Re-exports every name of ``repro.exec``'s ``__all__``.  Entry points that
touch a device take ``device=None``, meaning CUDA, and raise without one.
"""
from .calibrate import (CalibrationResult, SweepRecord, calibrate,
                        record_sweeps)
from .lower import build_executor, execute
from .measure import (Measurement, launch_overhead, measure_strategies,
                      ordering, pairwise_agreement, predicted_costs,
                      time_schedule)
from .plan import (COLORINGS, UNIT_BYTES, ExecPhase, ExecRound, ExecSchedule,
                   build_schedule, pairs_subset_of_plan, synth_payload,
                   units_for)
from .presets import (HOST_PROCS, blue_waters_8, frontier_8, host_machines,
                      lassen_8, tpu_v5e_8)
from .reference import delivered_digest, reference_delivered, run_reference

__all__ = [
    "COLORINGS", "UNIT_BYTES", "ExecPhase", "ExecRound", "ExecSchedule",
    "build_schedule", "pairs_subset_of_plan", "synth_payload", "units_for",
    "reference_delivered", "run_reference", "delivered_digest",
    "build_executor", "execute",
    "Measurement", "time_schedule", "launch_overhead", "measure_strategies",
    "predicted_costs", "ordering", "pairwise_agreement",
    "SweepRecord", "CalibrationResult", "record_sweeps", "calibrate",
    "HOST_PROCS", "blue_waters_8", "tpu_v5e_8", "lassen_8", "frontier_8",
    "host_machines",
]
