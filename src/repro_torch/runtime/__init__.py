"""Execution of deduced graphs: on one torch device, the comm lowering
(``lowering``), the torch op semantics (``torch_ops``), the whole-graph
lowering behind ``api.TorchExecutor`` (``program``) and the per-stage
lowering behind ``api.AsyncExecutor`` (``async_program``); across
``torch.distributed`` ranks, the rank comm lowering (``dist_lowering``),
the plan backend (``backend``), the rank graph lowering behind
``api.DistExecutor`` (``dist_program``), the per-stage rank lowering
behind ``api.DistAsyncExecutor`` (``dist_async_program``), the rank
launcher (``harness``) and the differential checks against the simulator
(``diff``, ``selftest``)."""
