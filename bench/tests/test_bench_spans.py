"""The readers of the program's spans (``bench/spans.py``:
``forward_ms_per_step``, ``backward_ms_per_step``, ``remat_ms_per_step``,
``optimizer_ms_per_step``, ``attn_fwd_ms_per_step``) on a hand-made trace
of one recorded step: two microbatches, the backward's kernels launched
from the autograd engine's thread inside the main thread's
``train.backward``, and a trace without the spans, which reads None."""

import json

import pytest

from bench import trace as tracing
from bench.metrics import Context, reader

ATTN = ("kernels.attention q=3x12x4096x128 k=3x2x4096x128 v=3x2x4096x128 "
        "float32 causal=True window=None")
SPANS = ("forward_ms_per_step", "backward_ms_per_step", "remat_ms_per_step",
         "optimizer_ms_per_step", "attn_fwd_ms_per_step")


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def kernel(corr, launch, start, dur, tid=1, name="k"):
    """A launch on host thread ``tid`` at ``launch`` and its kernel."""
    return [ev("cuda_runtime", "cudaLaunchKernel", launch, 1, tid=tid,
               corr=corr),
            ev("kernel", name, start, dur, tid=7, corr=corr)]


def step_events(spans=True):
    """One step, 0-1000 us: per microbatch a forward (attention inside)
    and a backward on thread 1 whose kernels thread 2 launches, a recompute
    span and a plain backward on thread 2; then the optimizer."""
    out = [ev("user_annotation", "bench.step", 0, 1000)]
    rng = [] if not spans else [
        ev("user_annotation", "train.forward", 10, 90),
        ev("user_annotation", ATTN, 20, 10),
        ev("user_annotation", "train.backward", 100, 300),
        ev("user_annotation", "model.remat_recompute", 110, 40, tid=2),
        ev("user_annotation", ATTN, 120, 10, tid=2),
        ev("user_annotation", "plain backward: flash_attention_ref", 160,
           30, tid=2),
        ev("user_annotation", "train.forward", 400, 90),
        ev("user_annotation", ATTN, 410, 10),
        ev("user_annotation", "train.backward", 500, 300),
        ev("user_annotation", "model.remat_recompute", 510, 40, tid=2),
        ev("user_annotation", ATTN, 520, 10, tid=2),
        ev("user_annotation", "train.optimizer", 850, 100),
    ]
    out += rng
    out += kernel(1, 15, 15, 20)                       # forward
    out += kernel(2, 22, 40, 30, name="flash_f32_kernel<128>")  # its attn
    out += kernel(3, 115, 115, 10, tid=2)              # recompute
    out += kernel(4, 122, 130, 25, tid=2, name="flash_f32_kernel<128>")
    out += kernel(5, 165, 165, 40, tid=2)              # plain backward
    out += kernel(6, 300, 300, 50, tid=2)              # backward's own
    out += kernel(7, 405, 405, 20)
    out += kernel(8, 415, 430, 30, name="flash_f32_kernel<128>")
    out += kernel(9, 515, 515, 10, tid=2)
    out += kernel(10, 525, 530, 25, tid=2, name="flash_f32_kernel<128>")
    out += kernel(11, 600, 600, 50, tid=2)
    out += kernel(12, 860, 860, 60)                    # AdamW
    out += kernel(13, 980, 980, 5)                     # loss mean: no span
    # launched before the step (the warm-up's), ending inside it: not read
    out += kernel(14, -50, -40, 45)
    out.append(ev("gpu_memcpy", "Memcpy HtoD", 2, 3, tid=7))
    return out


def load(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.load(path)


def ctx(trace, steps=None):
    win = trace.window("bench.step")
    if steps is not None:
        win = (win[0], win[1], steps)
    return Context(setup_s=1.0, window_s=2.0, steps=4, tokens_per_step=10,
                   flops_per_step=1.0, peak_flops=1.0,
                   window_peak_bytes=0, trace=trace, trace_window=win)


def test_span_readers(tmp_path):
    c = ctx(load(tmp_path, step_events()))
    # forward: kernels 1, 2, 7, 8; backward: 3-6 and 9-11 (launched from
    # thread 2 inside thread 1's train.backward); recompute 3, 4, 9, 10;
    # optimizer 12; attention 2, 4, 8, 10
    assert reader("forward_ms_per_step")(c) == pytest.approx(0.100)
    assert reader("backward_ms_per_step")(c) == pytest.approx(0.210)
    assert reader("remat_ms_per_step")(c) == pytest.approx(0.070)
    assert reader("optimizer_ms_per_step")(c) == pytest.approx(0.060)
    assert reader("attn_fwd_ms_per_step")(c) == pytest.approx(0.110)
    assert reader("attn_bwd_ms_per_step")(c) == pytest.approx(0.040)
    # per step: a window of two steps halves each reading
    assert reader("forward_ms_per_step")(ctx(c.trace, steps=2)) == \
        pytest.approx(0.050)


def test_coverage_and_nesting(tmp_path):
    """What PERF.md checks on the card, here on the hand-made step: the
    three phases hold all the kernels but the loss mean's; the recompute
    and the plain backward lie inside the backward."""
    c = ctx(load(tmp_path, step_events()))
    r = {n: reader(n)(c) for n in SPANS + ("attn_bwd_ms_per_step",)}
    lo, hi, _ = c.trace_window
    kernels_ms = sum(min(k[1], hi) - max(k[0], lo) for k in c.trace.kernels
                     if k[1] > lo and k[0] < hi) / 1e3
    phases = r["forward_ms_per_step"] + r["backward_ms_per_step"] + \
        r["optimizer_ms_per_step"]
    assert phases == pytest.approx(kernels_ms - 0.005 - 0.005)
    assert r["remat_ms_per_step"] < r["backward_ms_per_step"]
    assert r["attn_bwd_ms_per_step"] <= r["backward_ms_per_step"] - \
        r["remat_ms_per_step"]


def test_no_spans_read_nothing(tmp_path):
    """The parent's program has none of the spans: each reader returns
    None, so the line leaves the metric out."""
    c = ctx(load(tmp_path, step_events(spans=False)))
    for name in SPANS:
        assert reader(name)(c) is None
    bare = Context(setup_s=1.0, window_s=2.0, steps=4, tokens_per_step=10,
                   flops_per_step=1.0, peak_flops=1.0, window_peak_bytes=0)
    for name in SPANS:
        assert reader(name)(bare) is None


def test_attention_prefix_is_its_own(tmp_path):
    """``attn_fwd_ms_per_step`` reads the ``kernels.attention <shapes>``
    spans alone, not the benchmark's ``bench.attention_forward`` nor a
    range whose name merely starts alike."""
    events = step_events(spans=False) + [
        ev("user_annotation", "bench.attention_forward", 20, 10),
        ev("user_annotation", "kernels.attentionless", 410, 10)]
    assert reader("attn_fwd_ms_per_step")(ctx(load(tmp_path, events))) \
        is None
