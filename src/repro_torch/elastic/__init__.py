"""Elastic, fault-tolerant training (paper §7.2): the port's copy of
``repro.elastic``, with imports rewritten to ``repro_torch``.  On a
``TorchExecutor`` session (the default, on ``cuda``) every migration runs
on the torch comm lowering.

Two halves:

* :mod:`repro_torch.elastic.driver` — the LIVE trace driver: real
  ``train_step``s through device loss/join, strategy re-selection via
  ``repro_torch.search``, fused-BSR weight+optimizer migration through
  ``Session.switch``, durable checkpoints, and crash/resume under a
  different topology.  :mod:`repro_torch.elastic.faults` injects kills /
  joins / crashes at trace-specified (step, phase) points.
* :mod:`repro_torch.elastic.pricing` — the ANALYTIC C1..C7 trace pricing
  (Fig 14), re-exported by the legacy ``repro_torch.scenarios.elastic`` shim.

:mod:`repro_torch.elastic.fixtures` holds the shared probe program whose
weight/optimizer trajectory is bitwise strategy-invariant — the
differential oracle used by the port's tests and ``chip_smoke.py``.
"""

from .driver import (ElasticDriver, ElasticError, ElasticRun, StepRecord,
                     TraceEvent, TransitionRecord, classify_transition,
                     latest_checkpoint)
from .faults import Fault, FaultError, FaultPlan, inject
from .pricing import (TRACE_HETERO, TRACE_HOMOG, TransitionReport,
                      checkpoint_restart_baseline, run_trace,
                      two_pipeline_strategy)

__all__ = [
    "ElasticDriver", "ElasticError", "ElasticRun", "Fault", "FaultError",
    "FaultPlan", "StepRecord", "TRACE_HETERO", "TRACE_HOMOG",
    "TraceEvent", "TransitionRecord", "TransitionReport",
    "checkpoint_restart_baseline", "classify_transition", "inject",
    "latest_checkpoint", "run_trace", "two_pipeline_strategy",
]
