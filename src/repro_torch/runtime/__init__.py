"""Execution of deduced graphs on one torch device: the comm lowering
(``lowering``), the torch op semantics (``torch_ops``) and the whole-graph
lowering behind ``api.TorchExecutor`` (``program``)."""
