"""Graph-IR transformer blocks train on the port's ``TorchExecutor``.

``block_program`` of reduced ``qwen2_1_5b`` under dp2×tp2 and reduced
``llama_32b`` under tp2×pp2 (the configurations of
``tests/test_archs.py``) runs ``train_step`` on ``TorchExecutor`` on the
CPU at seq 128, and the loss and every gradient must match the JAX
package's ``SimulatorExecutor`` on the same numpy weights, at
``test_archs``' tolerance (loss rtol 1e-5; grads atol 1e-6, rtol 2e-4).
The same flat ``{name: np.ndarray}`` weights load into both packages'
``Session``: no converter.  The dispatch tally shows every attention class
on the plain version here (the kernel runs only on the card; see
``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.graph_block import block_program as jblock  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.models.graph_block import block_program  # noqa: E402

B, S = 2, 128
CONFIGS = [("qwen2_1_5b", dict(dp=2, tp=2, pp=1), 1, "1f1b"),
           ("llama_32b", dict(dp=1, tp=2, pp=2), 1, "1f1b"),
           ("llama_32b", dict(dp=1, tp=2, pp=2), 2, "1f1b"),
           ("llama_32b", dict(dp=1, tp=2, pp=2), 2, "gpipe")]


def block_weights(prog, rng):
    """Norm weights at one, the rest N(0, 0.05^2): ``test_archs``' draw."""
    return {t.name: np.ones(t.shape, np.float32)
            if "norm" in t.name.split("/")[-1]
            else (rng.standard_normal(t.shape) * 0.05).astype(np.float32)
            for t in prog.graph.parameters()}


@pytest.mark.parametrize("arch,par,m,kind", CONFIGS,
                         ids=[f"{c[0]}-m{c[2]}-{c[3]}" for c in CONFIGS])
def test_block_trains_to_the_reference_simulator(arch, par, m, kind):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    prog = block_program(cfg, batch=B, seq=S, **par)
    ws = block_weights(prog, rng)
    feeds = {"ids": ids, "labels": labels}

    ref = japi.Session(jblock(jget_config(arch).reduced(), batch=B, seq=S,
                              **par), 0, executor=japi.SimulatorExecutor())
    ref.load(ws)
    ex = api.TorchExecutor(device="cpu")
    sess = api.Session(prog, 0, executor=ex)
    sess.load(ws)
    before = fa.launches
    for step in range(2):
        want = ref.train_step(dict(feeds), num_microbatches=m,
                              schedule=kind)
        got = sess.train_step(dict(feeds), num_microbatches=m,
                              schedule=kind)
        np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5,
                                   atol=1e-9)
        for n in ws:
            np.testing.assert_allclose(
                got.grad_value(n), want.grad_value(n), atol=1e-6,
                rtol=2e-4, err_msg=f"{arch} step {step} grad {n}")
            np.testing.assert_allclose(
                sess.weight_value(n), ref.weight_value(n), atol=1e-6,
                rtol=2e-4, err_msg=f"{arch} step {step} weight {n}")

    # the tally: every attention class went to the plain version on the
    # CPU, once per layer (one class per layer in these layouts)
    tplan = prog.compile_train(0, num_microbatches=m)
    stats = ex.lowered(tplan, [tplan.loss_name] + [
        tplan.grad_map[t.name] for t in tplan.graph.parameters()], m).stats
    assert stats.ref_dispatches == cfg.n_layers
    assert stats.kernel_dispatches == 0
    assert fa.launches == before


def test_attention_gate_follows_the_jax_gate():
    """Per class on a device the policy sends to the kernels: B1 wherever
    the JAX gate takes the Pallas kernel, and also where B1's masked
    tiles take a shape the Pallas tiling rule refuses; a raise where B1
    cannot take the shapes, never the plain version on the card.  The
    plain version on the CPU and under ``ref``."""
    from repro.kernels.policy import attention_eligible as jax_eligible
    sel = policy.select_attention_impl
    q, kv = (2, 6, 512, 128), (2, 1, 512, 128)
    assert jax_eligible(q, kv)
    assert sel(q, kv, "cpu") == "ref"
    assert sel(q, kv, "cuda") == "cuda"
    # Sq = 200 is no multiple of the Pallas block (128): the JAX gate
    # sends it to its reference, B1 takes it on the card
    ragged = (2, 6, 200, 128), (2, 1, 200, 128)
    assert not jax_eligible(*ragged)
    assert sel(*ragged, "cuda") == "cuda"
    # head dim 96 passes the JAX gate but not B1: raise, never fall back
    odd = (2, 6, 128, 96), (2, 1, 128, 96)
    assert jax_eligible(*odd)
    with pytest.raises(ValueError, match="does not take"):
        sel(*odd, "cuda")
    policy.set_policy("ref")
    try:
        assert sel(q, kv, "cuda") == "ref"
        assert sel(*odd, "cuda") == "ref"
    finally:
        policy.set_policy("auto")


def test_executor_defaults_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.TorchExecutor()
    assert api.TorchExecutor(device="cpu").device.type == "cpu"
