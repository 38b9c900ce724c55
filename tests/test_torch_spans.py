"""The spans inside the port's training step (``repro_torch/spans.py``),
on the CPU at reduced size, read back through the benchmark's trace
reader (``bench/trace.py``) from ``torch.profiler``'s chrome trace.

* one ``train.forward`` and one ``train.backward`` a microbatch, one
  ``train.optimizer`` a step, layers x microbatches
  ``model.remat_recompute`` spans, each inside a ``train.backward``;
  every ``kernels.attention`` call inside a ``train.forward`` or a
  recompute; each ``aten::mm`` inside the forward or the backward, the
  recompute's the forward's less the head's;
* with no profiler a step never enters ``record_function``, and a span
  is gated when it is entered, not when it is made;
* a ``kernels.attention`` name parses back to the tuple the benchmark's
  ``attention_spans`` records for the same call;
* a profiled step and an unprofiled one give the same bits.

On the CPU the model's attention takes the plain path; ``via_ops`` sends
it through ``kernels.ops.attention`` (which runs the plain version on CPU
tensors), as the card does.
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.data.pipeline import CorpusConfig, SyntheticCorpus
from repro_torch.kernels import ops
from repro_torch.launch.train import make_batch
from repro_torch.models import layers
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.steps import build_train_step
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import trace as tracing  # noqa: E402
from bench.harness import attention_spans  # noqa: E402

MICRO, ROWS, SEQ = 2, 4, 128


@pytest.fixture
def via_ops(monkeypatch):
    """The model's attention through ``kernels.ops.attention``."""
    monkeypatch.setattr(layers, "use_kernels", lambda device: True)


def _step(arch="qwen2-1.5b", micro=MICRO, remat=True, seed=0):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    opt = init_opt_state(params)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                            num_microbatches=micro, remat=remat)
    g = torch.Generator().manual_seed(seed + 1)
    batch = {k: torch.randint(0, cfg.vocab, (ROWS, SEQ), generator=g)
             for k in ("tokens", "labels")}
    return cfg, params, opt, step, batch


def _profiled(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, tracing.load(path)


def _inside(r, outer) -> bool:
    return any(o[0] <= r[0] and r[1] <= o[1] for o in outer)


def _named(tr, name):
    return [h for h in tr.host if h[2] == name]


def test_train_step_spans_count_and_nest(tmp_path, via_ops):
    cfg, params, opt, step, batch = _step()
    _, tr = _profiled(tmp_path, lambda: step(params, opt, batch))
    fwd, bwd = _named(tr, spans.FORWARD), _named(tr, spans.BACKWARD)
    opt_r, remat = _named(tr, spans.OPTIMIZER), _named(tr, spans.REMAT)
    attn = tr.ranges(spans.ATTENTION + " ")
    assert (len(fwd), len(bwd), len(opt_r)) == (MICRO, MICRO, 1)
    assert len(remat) == cfg.n_layers * MICRO
    assert all(_inside(r, bwd) for r in remat)
    # the phases follow one another: forward, backward per microbatch,
    # then the optimizer
    order = sorted(fwd + bwd + opt_r)
    assert [r[2] for r in order] == [spans.FORWARD, spans.BACKWARD] * MICRO \
        + [spans.OPTIMIZER]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    # attention: once a layer in the forward, once in its recompute
    assert len(attn) == 2 * cfg.n_layers * MICRO
    assert sum(_inside(r, fwd) for r in attn) == cfg.n_layers * MICRO
    assert sum(_inside(r, remat) for r in attn) == cfg.n_layers * MICRO
    # every matmul of the step is the forward's or the backward's; the
    # recompute re-runs the blocks' but not the head's (one a microbatch)
    mm = _named(tr, "aten::mm")
    where = Counter(next((n for n, rs in (("fwd", fwd), ("bwd", bwd),
                                         ("opt", opt_r)) if _inside(m, rs)),
                         "outside") for m in mm)
    assert set(where) == {"fwd", "bwd"}
    in_remat = sum(_inside(m, remat) for m in mm)
    assert in_remat == where["fwd"] - MICRO > 0


@pytest.mark.parametrize("arch", ["whisper-large-v3", "mamba2-370m"])
def test_remat_spans_cover_every_stack(tmp_path, arch):
    """The encoder's blocks (``run_encoder``) and a recurrent stack are
    recomputed in spans too: one a block and microbatch."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    stacks = list(params["groups"].values()) + (
        [params["encoder"]] if cfg.encdec else [])
    blocks = sum(len(tree_leaves(g)[0]) for g in stacks)
    corpus = SyntheticCorpus(CorpusConfig(vocab=cfg.vocab, max_len=32,
                                          seed=0))
    batch = make_batch(corpus, cfg, ROWS, 32, np.random.default_rng(0),
                       "cpu")
    step = build_train_step(cfg, AdamWConfig(), num_microbatches=MICRO)
    _, tr = _profiled(tmp_path, lambda: step(params, init_opt_state(params),
                                             batch))
    remat = _named(tr, spans.REMAT)
    assert len(remat) == blocks * MICRO
    assert all(_inside(r, _named(tr, spans.BACKWARD)) for r in remat)


class _Counting:
    """``record_function`` that counts its ranges entered."""
    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_unprofiled_step_never_enters_record_function(monkeypatch, via_ops):
    _, params, opt, step, batch = _step()
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Counting)
    step(params, opt, batch)
    assert _Counting.entered == 0
    # the same step under a profiler enters the spans through it
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, opt, batch)
    assert _Counting.entered > 0


def test_span_is_gated_when_entered(tmp_path):
    made_outside = spans.span("made outside")

    def inside():
        with made_outside:
            pass
        made_inside = spans.span("made inside")
        return made_inside
    made_inside, tr = _profiled(tmp_path, inside)
    assert len(_named(tr, "made outside")) == 1
    with made_inside:     # entered with no profiler: nothing, no error
        pass
    assert not spans.recording()


@pytest.mark.parametrize("q,k,v,causal,window,dtype", [
    ((1, 4, 128, 32), (1, 2, 128, 32), (1, 2, 128, 32), True, None,
     torch.float32),
    ((2, 4, 128, 24), (2, 4, 256, 24), (2, 4, 256, 16), False, None,
     torch.float32),
    ((1, 2, 128, 16), (1, 1, 128, 16), (1, 1, 128, 16), True, 64,
     torch.bfloat16),
], ids=["gqa-causal", "mla-like-noncausal", "window-bf16"])
def test_attention_span_name_parses_to_the_recorded_call(
        tmp_path, q, k, v, causal, window, dtype):
    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(s, generator=g).to(dtype) for s in (q, k, v)]
    calls = []

    def call():
        with attention_spans(calls):
            return ops.attention(*qkv, causal=causal, window=window)
    _, tr = _profiled(tmp_path, call)
    (rng,) = tr.ranges(spans.ATTENTION + " ")
    assert spans.parse_attention_name(rng[2]) == calls[0]
    assert rng[2] == spans.attention_name(*qkv, causal, window)
    assert spans.parse_attention_name("train.forward") is None


def test_profiled_step_gives_the_same_bits(tmp_path, via_ops):
    """The spans change no arithmetic: a step under the profiler and one
    without, from the same state and batch, agree bit for bit."""
    _, p1, o1, step1, batch = _step()
    _, p2, o2, step2, _ = _step()
    p1, o1, m1 = step1(p1, o1, batch)
    (p2, o2, m2), _ = _profiled(tmp_path, lambda: step2(p2, o2, batch))
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p2, o2))):
        assert torch.equal(a, b)
