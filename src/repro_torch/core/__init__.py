"""The planning half of the port: copies of ``repro.core`` (HSPMD
annotations, deduction, comm resolution, progressive specialization, the
specialization-class IR, schedules, the cost model, switching and the
numpy simulator), with ``repro.`` imports rewritten to ``repro_torch.``."""
