"""``python -m repro_torch.serve`` against the JAX serving pair, and the
port's import hygiene.

The server runs in-process on the CPU on the reduced qwen2-1.5b with the
JAX ``init_params(PRNGKey(0))`` weights; its greedy tokens must equal those
of the JAX ``build_prefill_step`` / ``build_decode_step`` pair on the same
weights and prompts.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
B, P, GEN = 4, 128, 4


def _jax_serve(jcfg, jparams, prompts):
    prefill = jax.jit(jsteps.build_prefill_step(jcfg))
    step = jax.jit(jsteps.build_decode_step(jcfg))
    logits = prefill(jparams, {"tokens": prompts})
    state = jm.init_decode_state(jcfg, B, max_len=P + GEN)
    for t in range(P):
        _, state = step(jparams, state, {"tokens": prompts[:, t:t + 1]})
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(GEN - 1):
        logits, state = step(jparams, state, {"tokens": tok})
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


def test_serve_greedy_tokens_match_jax_serving_pair(monkeypatch, capsys):
    jcfg = jax_get_config("qwen2-1.5b").reduced()
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      get_config("qwen2-1.5b").reduced(),
                                      device="cpu")
    monkeypatch.setattr(serve, "init_params", lambda *a, **k: tparams)
    res = serve.main(["--device", "cpu", "--reduced", "--prompt-len",
                      str(P), "--gen", str(GEN)])
    printed = capsys.readouterr().out
    assert "prefill 128 tokens" in printed and "agree=True" in printed
    assert res["agree"]
    assert res["prefill_launches"] == res["launches"] == {
        "flash": 0, "ssd": 0, "rglru": 0}
    assert res["tokens"].shape == (B, GEN)

    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (B, P))
    want = _jax_serve(jcfg, jparams, jnp.asarray(prompts, jnp.int32))
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_serving_placement_report_matches_the_reference(arch):
    """``serve.placement_report`` through the copied api prints what
    ``examples/serve.py`` computes through ``repro.api``."""
    from repro import api as japi
    cfg = jax_get_config(arch).reduced()
    shapes = {"wq": (cfg.d_model, cfg.d_model),
              "wo": (cfg.d_model, cfg.d_model)}
    tp4 = japi.Strategy("serve-tp4", {
        n: japi.spmd([0, 1, 2, 3], japi.DS({1: 4})) for n in shapes})
    tp2 = japi.Strategy("serve-tp2", {
        n: japi.spmd([0, 1], japi.DS({1: 2})) for n in shapes})
    compiled = japi.Program(japi.weights_graph(shapes),
                            [tp4, tp2]).compile("serve-tp4")
    drain = japi.estimate_switch(
        [(n, tp4.annots[n], tp2.annots[n], shapes[n], 2) for n in shapes])
    want = (f"serving placement: {compiled.strategy.name} over "
            f"{len(compiled.devices)} devices; drain to tp2 = "
            f"{drain.summary()}")
    got = serve.placement_report(get_config(arch).reduced())

    def untimed(line):     # the planner's own wall time varies per call
        return re.sub(r"plan [0-9.]+ ms", "plan _ ms", line)
    assert untimed(got) == untimed(want)


def test_serve_rejects_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--prompt-len", "8", "--gen", "2"])


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
print(len(sys.modules), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    banned = re.compile(r"^\s*(import jax|from jax|from repro[. ]|"
                        r"import repro(\.|\s|$))", re.M)
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 10
    for path in sources:
        assert not banned.search(path.read_text()), path


_IMPORT_ONE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("modules", [
    ("repro_torch.api", "repro_torch.runtime.program"),
    ("repro_torch.core",), ("repro_torch.runtime",), ("repro_torch.optim",),
    ("repro_torch.optim.adamw", "repro_torch.models.graph_block"),
    ("repro_torch.launch.train",), ("repro_torch.checkpoint.store",),
    ("repro_torch.data.pipeline",), ("repro_torch.search",),
    ("repro_torch.tree",), ("repro_torch.models.moe",),
    ("repro_torch.train.steps", "repro_torch.kernels.autograd"),
    ("repro_torch.elastic", "repro_torch.scenarios.elastic",
     "repro_torch.scenarios.hetero", "repro_torch.scenarios.mixed_length",
     "repro_torch.scenarios.search")],
    ids=lambda m: "+".join(m))
def test_graph_ir_half_imports_no_jax_and_no_reference_package(modules):
    """A fresh process that imports only the graph-IR half of the port
    (the planning copies, the torch runtime, the optimizer) or only the
    trainer's modules (launcher, checkpoints, data, search, train step)
    or only the elastic driver and the scenario cost models holds neither ``jax`` nor any ``repro.*`` module."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ONE, *modules],
                          cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
