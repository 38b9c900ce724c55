"""The trace reader and the per-layer metrics on a hand-made trace."""

import json

import pytest

from bench import trace as tracing
from bench.metrics import Context, reader
from bench.peaks import attention_bound_s


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


CALL = ((1, 12, 512, 128), (1, 2, 512, 128), (1, 2, 512, 128), True, None,
        "float32")


@pytest.fixture
def trace(tmp_path):
    events = [
        # two steps, 0-100 and 100-200 us
        ev("user_annotation", "bench.step", 0, 100),
        ev("user_annotation", "bench.step", 100, 100),
        ev("user_annotation", "bench.attention_forward", 5, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=1),
        ev("kernel", "flash_f32_kernel<128>", 10, 20, tid=7, corr=1),
        ev("cpu_op", "aten::mm", 20, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=2),
        ev("kernel", "sm90_xmma_gemm_f32f32", 30, 40, tid=7, corr=2),
        ev("user_annotation", "plain backward: flash_attention_ref", 110,
           20, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 111, 1, tid=2, corr=3),
        ev("kernel", "softmax_kernel", 120, 10, tid=7, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 115, 1, tid=2, corr=4),
        ev("kernel", "ampere_sgemm_128x64", 130, 30, tid=7, corr=4),
        ev("gpu_memcpy", "Memcpy HtoD", 165, 5, tid=7),
        ev("cpu_op", "aten::item", 171, 25),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.load(path)


def ctx(trace, calls=(CALL,)):
    return Context(setup_s=1.0, window_s=2.0, steps=4, tokens_per_step=10,
                   flops_per_step=67e12, peak_flops=67e12,
                   window_peak_bytes=2**31, trace=trace,
                   trace_window=trace.window("bench.step"),
                   attention_calls=list(calls))


def test_window_and_busy(trace):
    assert trace.window("bench.step") == (0, 200, 2)
    # kernels 10-30, 30-70, 120-130, 130-160, copy 165-170: 105 us busy
    assert tracing.busy_us(trace, 0, 200) == 105
    assert reader("device_idle_pct")(ctx(trace)) == pytest.approx(47.5)


def test_ranges(trace):
    c = ctx(trace)
    assert reader("attn_bwd_ms_per_step")(c) == pytest.approx(0.040 / 2)
    assert reader("gemm_ms_per_step")(c) == pytest.approx(0.070 / 2)
    bound = attention_bound_s(*CALL)
    assert reader("b1_roofline")(c) == pytest.approx(100 * bound / 20e-6)
    # a call the trace does not hold: nothing to read
    assert reader("b1_roofline")(ctx(trace, calls=(CALL, CALL))) is None


def test_end_to_end_readers(trace):
    c = ctx(trace)
    assert reader("tokens_per_s")(c) == 20
    assert reader("mfu")(c) == pytest.approx(200.0)
    assert reader("peak_mem_gib")(c) == 2
    assert reader("setup_s")(c) == 1


def test_breakdown(trace):
    b = tracing.breakdown(trace, 0, 200, 1)
    assert b["device_ops"][0] == ["sm90_xmma_gemm_f32f32", 40e-6]
    # idle 0-10, 70-120, 160-165 and 170-200, each begun inside a step
    # range of thread 1 and outside its other events (aten::item from 171)
    assert b["idle_gaps"] == [["bench.step", pytest.approx(95e-6)]]
    assert tracing.breakdown(trace, 0, 200, 2)["idle_gaps"] == [
        ["host: outside any operation", pytest.approx(95e-6)]]


def test_no_trace_reads_nothing():
    c = Context(setup_s=1.0, window_s=2.0, steps=4, tokens_per_step=10,
                flops_per_step=1.0, peak_flops=1.0, window_peak_bytes=0)
    for name in ("gemm_ms_per_step", "attn_bwd_ms_per_step", "b1_roofline",
                 "device_idle_pct"):
        assert reader(name)(c) is None
