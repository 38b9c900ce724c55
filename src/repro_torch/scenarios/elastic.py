"""Shim — the elastic scenario grew into the :mod:`repro_torch.elastic`
package.

The analytic trace pricing (paper §7.2, Fig 14) lives in
:mod:`repro_torch.elastic.pricing`; the live trace driver that actually runs
``train_step``s through device loss/join is
:mod:`repro_torch.elastic.driver`.  Everything previously importable from
here keeps working.
"""

from repro_torch.elastic.pricing import (TRACE_HETERO, TRACE_HOMOG,
                                         TransitionReport,
                                         checkpoint_restart_baseline, run_trace,
                                         two_pipeline_strategy)

__all__ = ["TRACE_HETERO", "TRACE_HOMOG", "TransitionReport",
           "checkpoint_restart_baseline", "run_trace",
           "two_pipeline_strategy"]
