"""The port's production training path against the JAX package's, on the
CPU at reduced size: ``loss_fn`` and its gradients (with and without
remat), AdamW's ``apply_updates``, three steps of ``build_train_step``
(one and two microbatches; also for DeepSeek-V2, Grok-1, Qwen2-VL and
Whisper on the trainers' batches, their MoE dropping tokens at capacity),
the copied data pipeline, checkpoints written by either package and read
by the other, the trainer CLI (and its ``--experts`` cut), and the copied
strategy search.

Parameters come from the JAX ``init_params(PRNGKey(0))`` and are carried
over by ``convert.params_from_jax``; batches are numpy arrays from a seed.
Tolerances (fp32 sums in other orders on the two sides):

* loss: relative error <= 1e-5;
* gradients, AdamW's m, and parameters after three steps: per-leaf
  normwise error ||port - jax|| / ||jax|| <= 1e-4.  The attention key
  bias ``bk`` is left out of the parameter check (its m is checked):
  it starts at zero and its gradient is nearly zero (softmax is
  shift-invariant along the keys; only RoPE leaves a remainder), so
  AdamW's normalized step turns rounding-level gradient differences into
  whole steps of +-lr (1.1e-3 normwise after three steps at reduced
  Qwen2, every other leaf <= 2e-5);
* ``apply_updates`` on the same inputs: per-leaf normwise <= 1e-6;
* data pipeline, checkpoints, strategy search: exact.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro import search as jsearch  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import search as tsearch  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.tree import (named_leaves, tree_leaves,  # noqa: E402
                              unflatten_like)

ARCHS = ["qwen2-1.5b", "mamba2-370m", "recurrentgemma-9b"]
#: MLA with MoE, MoE, embedding inputs with M-RoPE, the audio
#: encoder-decoder: the train-step parity cases of their own, at batch B x
#: FAMILY_S.  Their MoE runs the capacity dispatch (``exact`` off) at half
#: the mean load (capacity factor FAMILY_CAPACITY), so that every step
#: drops tokens: at the published 1.25 the reduced DeepSeek-V2's near-even
#: routing at init drops none
FAMILY_ARCHS = ["deepseek-v2-236b", "grok-1-314b", "qwen2-vl-72b",
                "whisper-large-v3"]
FAMILY_S, FAMILY_CAPACITY = 32, 0.5
LOSS_RTOL = 1e-5
GRAD_NORMWISE = 1e-4
PARAM_NORMWISE = 1e-4
UPDATE_NORMWISE = 1e-6
B, S = 4, 64


def _configs(arch):
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _jax_params(jcfg, dtype=jnp.float32):
    return jm.init_params(jax.random.PRNGKey(0), jcfg, dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, b=B, s=S):
    """Packed synthetic documents from the reference pipeline: tokens,
    labels, loss_mask and positions that restart at each document."""
    corpus = jpipe.SyntheticCorpus(jpipe.CorpusConfig(
        vocab=cfg.vocab, max_len=s, seed=seed))
    return jpipe.pack_batch(corpus.sample_sequences(3 * b), b, s)


def _normwise(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return np.linalg.norm(got - want) / norm if norm else \
        float(np.abs(got).max())


def _worst(port_tree, jax_tree, cfg, skip=()):
    """The largest per-leaf normwise error of a port tree against a JAX
    tree of the same layout, leaves named in ``skip`` left out."""
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_jax(port_tree, cfg))
    want = jax.tree.leaves(_np(jax_tree))
    assert len(got) == len(want)
    return max(_normwise(a, b) for (path, a), b in zip(got, want)
               if path[-1].key not in skip)


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg, cfg = _configs(arch)
    jparams = _jax_params(jcfg)
    nb = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg,
        remat=remat)

    params = convert.params_from_jax(_np(jparams), cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(params, _torch_batch(nb), cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)

    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert abs(met["nll"].item() - float(jmet["nll"])) <= \
        LOSS_RTOL * abs(float(jmet["nll"]))
    grads = unflatten_like(params, grads)
    assert _worst(grads, jgrads, cfg) <= GRAD_NORMWISE


def test_loss_mask_all_zero_divides_by_one():
    """``max(sum(mask), 1)``: an all-masked batch has loss 0, not NaN."""
    _, cfg = _configs("qwen2-1.5b")
    params = tm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    nb = _batch(cfg)
    nb["loss_mask"] = np.zeros_like(nb["loss_mask"])
    loss, _ = tm.loss_fn(params, _torch_batch(nb), cfg)
    assert loss.item() == 0.0


def _random_tree(rng, like, scale, positive=False):
    return jax.tree.map(
        lambda a: (np.abs if positive else (lambda x: x))(
            rng.standard_normal(a.shape) * scale).astype(np.float32), like)


@pytest.mark.parametrize("count", [1, 5])
@pytest.mark.parametrize("clip", ["bites", "does-not-bite"])
def test_apply_updates_matches_jax(clip, count):
    """The same params, grads and state through both updates: clipping
    that bites (norm ~64 against 1.0) and that does not (norm ~0.06), at
    the first step and the fifth."""
    jcfg, cfg = _configs("recurrentgemma-9b")
    rng = np.random.default_rng(count)
    params = _np(_jax_params(jcfg))
    grads = _random_tree(rng, params, 0.1 if clip == "bites" else 1e-4)
    state = {"m": _random_tree(rng, params, 1e-3 * (count > 1)),
             "v": _random_tree(rng, params, 1e-6 * (count > 1),
                               positive=True),
             "count": np.int32(count - 1)}
    ocfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=3)
    jp, js, jmet = jadamw.apply_updates(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), ocfg)

    tp = convert.params_from_jax(params, cfg, device="cpu")
    tg = convert.params_from_jax(grads, cfg, device="cpu")
    ts = convert.opt_state_from_jax(state, cfg, device="cpu")
    tp2, ts2, tmet = tadamw.apply_updates(tp, tg, ts, tadamw.AdamWConfig(
        lr=1e-3, warmup_steps=3))
    assert tp2 is tp and ts2 is ts      # updated in place
    bites = float(jmet["grad_norm"]) > ocfg.grad_clip
    assert bites == (clip == "bites")
    assert abs(tmet["grad_norm"].item() - float(jmet["grad_norm"])) <= \
        UPDATE_NORMWISE * float(jmet["grad_norm"])
    assert tmet["lr"].item() == pytest.approx(float(jmet["lr"]), rel=1e-7)
    assert int(ts2["count"]) == int(js["count"]) == count
    for port, ref in ((tp2, jp), (ts2["m"], js["m"]), (ts2["v"], js["v"])):
        assert _worst(port, ref, cfg) <= UPDATE_NORMWISE


def _family_configs(arch):
    """The reduced configs, MoE's capacity dispatch at FAMILY_CAPACITY."""
    out = []
    for cfg in _configs(arch):
        if cfg.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, exact=False, capacity_factor=FAMILY_CAPACITY))
        out.append(cfg)
    return out


def _trainer_batches(jcfg, cfg, seed):
    """The two trainers' batches (``make_batch``) from one seed: the JAX
    package's (jnp arrays) and the port's (CPU tensors); embedding inputs
    carry ``positions3``, Whisper ``audio_embeds``."""
    from repro.launch import train as jtrain
    mk = dict(vocab=cfg.vocab, max_len=FAMILY_S, seed=seed)
    want = jtrain.make_batch(jpipe.SyntheticCorpus(jpipe.CorpusConfig(**mk)),
                             jcfg, B, FAMILY_S, np.random.default_rng(seed))
    got = tlaunch.make_batch(tpipe.SyntheticCorpus(tpipe.CorpusConfig(**mk)),
                             cfg, B, FAMILY_S, np.random.default_rng(seed),
                             "cpu")
    return want, got


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_train_step_matches_jax_over_three_steps(arch, micro):
    """Three steps of ``build_train_step`` from the JAX package's init.
    The families take the trainers' batches (the ``positions3`` split of
    M-RoPE, the encoder's inputs) and drop tokens at MoE capacity: each
    step of the port drops some, and routes as the JAX package's does, or
    the losses would part."""
    family = arch in FAMILY_ARCHS
    jcfg, cfg = _family_configs(arch) if family else _configs(arch)
    ocfg = dict(lr=1e-3, warmup_steps=2)
    jparams = _jax_params(jcfg)
    jopt = jadamw.init_opt_state(jparams)
    jstep = jax.jit(jsteps.build_train_step(
        jcfg, jadamw.AdamWConfig(**ocfg), num_microbatches=micro))
    params = convert.params_from_jax(_np(jparams), cfg, device="cpu")
    opt = tadamw.init_opt_state(params)
    step = tsteps.build_train_step(cfg, tadamw.AdamWConfig(**ocfg),
                                   num_microbatches=micro)
    for i in range(3):
        if family:
            jb, tb = _trainer_batches(jcfg, cfg, seed=i)
        else:
            nb = _batch(cfg, seed=i)
            jb = {k: jnp.asarray(v) for k, v in nb.items()}
            tb = _torch_batch(nb)
        jparams, jopt, jmet = jstep(jparams, jopt, jb)
        tmoe.routing_log = [] if cfg.moe else None
        try:
            params, opt, met = step(params, opt, tb)
            routes = tmoe.routing_log
        finally:
            tmoe.routing_log = None
        if cfg.moe:
            assert any(not bool(keep.all()) for _, keep in routes), i
        want = float(jmet["loss"])
        assert abs(met["loss"].item() - want) <= LOSS_RTOL * abs(want), i
        assert abs(met["grad_norm"].item() - float(jmet["grad_norm"])) <= \
            GRAD_NORMWISE * float(jmet["grad_norm"]), i
    assert int(opt["count"]) == 3
    assert _worst(params, jparams, cfg, skip=("bk",)) <= PARAM_NORMWISE
    assert _worst(opt["m"], jopt["m"], cfg) <= GRAD_NORMWISE


def test_microbatches_split_the_batch_in_order():
    """Microbatch j holds rows j*G/n .. (j+1)*G/n - 1, as the reference's
    (G, ...) -> (n, G/n, ...) reshape; a leaf whose leading dim does not
    divide goes whole."""
    batch = {"tokens": torch.arange(24).reshape(6, 4),
             "odd": torch.arange(5), "scalar": torch.tensor(1.0)}
    mbs = tsteps._split(batch, 3)
    assert [mb["tokens"][:, 0].tolist() for mb in mbs] == \
        [[0, 4], [8, 12], [16, 20]]
    assert all(mb["odd"] is batch["odd"] and mb["scalar"] is batch["scalar"]
               for mb in mbs)


def test_data_pipeline_copy_matches_reference():
    for name in ("commoncrawl", "github"):
        jc = jpipe.SyntheticCorpus(jpipe.CorpusConfig(name=name, vocab=1000,
                                                      seed=3, max_len=4096))
        tc = tpipe.SyntheticCorpus(tpipe.CorpusConfig(name=name, vocab=1000,
                                                      seed=3, max_len=4096))
        np.testing.assert_array_equal(jc.sample_lengths(50),
                                      tc.sample_lengths(50))
        jseqs, tseqs = jc.sample_sequences(12), tc.sample_sequences(12)
        for a, b in zip(jseqs, tseqs, strict=True):
            np.testing.assert_array_equal(a, b)
        jb, tb = jpipe.pack_batch(jseqs, 3, 700), tpipe.pack_batch(tseqs, 3,
                                                                   700)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
        jbk = jpipe.bucketize(jseqs, jpipe.DEFAULT_BUCKETS_16K)
        tbk = tpipe.bucketize(tseqs, tpipe.DEFAULT_BUCKETS_16K)
        assert [(b.lo, b.hi, [len(s) for s in v]) for b, v in jbk.items()] \
            == [(b.lo, b.hi, [len(s) for s in v]) for b, v in tbk.items()]
        js = list(jpipe.step_stream(jc, 5000, 3))
        ts = list(tpipe.step_stream(tc, 5000, 3))
        assert [[len(s) for s in st] for st in js] == \
            [[len(s) for s in st] for st in ts]
    with pytest.raises(KeyError):
        tpipe.SyntheticCorpus(tpipe.CorpusConfig(name="wiki"))


def _states(dtype):
    """The same (params, opt_state) in both packages: params in ``dtype``
    (the fp32 leaves stay fp32), random m and v, count 7."""
    jcfg, cfg = _configs("recurrentgemma-9b")
    jparams = _jax_params(jcfg, dtype)
    rng = np.random.default_rng(0)
    npp = _np(jax.tree.map(lambda a: a.astype(jnp.float32), jparams))
    state = {"m": _random_tree(rng, npp, 1e-3),
             "v": _random_tree(rng, npp, 1e-6, positive=True),
             "count": np.int32(7)}
    jtree = (jparams, jax.tree.map(jnp.asarray, state))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    ttree = (convert.params_from_jax(npp, cfg, device="cpu", dtype=tdtype),
             convert.opt_state_from_jax(state, cfg, device="cpu"))
    return cfg, jtree, ttree


def _assert_same(cfg, ttree, jtree):
    tparams, tstate = ttree
    jparams, jstate = jtree
    for port, ref in ((tparams, jparams), (tstate["m"], jstate["m"]),
                      (tstate["v"], jstate["v"])):
        got = jax.tree.leaves(convert.params_to_jax(port, cfg))
        want = jax.tree.leaves(jax.tree.map(
            lambda a: np.asarray(a, np.float32), ref))
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
    assert tstate["count"].dtype == torch.int32
    assert int(tstate["count"]) == int(jstate["count"]) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_restore_bitwise_across_packages(tmp_path, dtype):
    cfg, jtree, ttree = _states(getattr(jnp, dtype))
    # JAX writes, the port reads into its own skeleton
    jstore.save(str(tmp_path / "j"), jtree, 11, {"arch": cfg.name})
    got, step = tstore.restore(str(tmp_path / "j"), ttree)
    assert step == 11
    assert got[0]["embed"].dtype == ttree[0]["embed"].dtype
    _assert_same(cfg, got, jtree)
    # the port writes, JAX reads into its own skeleton
    tstore.save(str(tmp_path / "t"), ttree, 12, {"arch": cfg.name})
    assert tstore.peek(str(tmp_path / "t")) == jstore.peek(
        str(tmp_path / "j")) | {"step": 12}
    back, step = jstore.restore(str(tmp_path / "t"), jtree)
    assert step == 12
    assert str(back[0]["embed"].dtype) == dtype
    _assert_same(cfg, ttree, back)
    # the port's save replaces a checkpoint in place
    tstore.save(str(tmp_path / "t"), ttree, 13)
    assert tstore.peek(str(tmp_path / "t"))["step"] == 13
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".ck-")]


def _break(kind, path, skel_extra):
    mf, npz = path / "manifest.json", path / "arrays.npz"
    if kind == "no manifest":
        mf.unlink()
    elif kind == "malformed manifest":
        mf.write_text("[1, 2]")
    elif kind == "unreadable manifest":
        mf.write_text("{")
    elif kind == "no arrays":
        npz.unlink()
    elif kind == "truncated arrays":
        data = npz.read_bytes()
        npz.write_bytes(data[:len(data) // 2])
    elif kind == "key drift":
        text = mf.read_text().replace('"keys": {', '"keys": {"ghost": '
                                      '{"shape": [1], "dtype": "float32"},')
        mf.write_text(text)
    elif kind == "skeleton mismatch":
        skel_extra["extra"] = 0


@pytest.mark.parametrize("kind", [
    "no manifest", "malformed manifest", "unreadable manifest", "no arrays",
    "truncated arrays", "key drift", "skeleton mismatch"])
def test_checkpoint_faults_raise_the_references_errors(tmp_path, kind):
    """Both packages refuse the same broken checkpoint with a
    ``CheckpointError`` and the same message."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.ones(2, np.float32)]}
    jstore.save(str(tmp_path / "ck"), tree, 1)
    extra = {}
    _break(kind, tmp_path / "ck", extra)
    jskel = {**tree, **extra}
    tskel = {"a": torch.zeros(2, 3), "b": [torch.zeros(2)], **extra}
    with pytest.raises(jstore.CheckpointError) as jerr:
        jstore.restore(str(tmp_path / "ck"), jskel)
    with pytest.raises(tstore.CheckpointError) as terr:
        tstore.restore(str(tmp_path / "ck"), tskel)
    assert str(terr.value) == str(jerr.value)


def test_params_to_jax_inverts_params_from_jax():
    jcfg, cfg = _configs("recurrentgemma-9b")
    npp = _np(_jax_params(jcfg))
    back = convert.params_to_jax(convert.params_from_jax(npp, cfg,
                                                         device="cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(npp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(npp)):
        np.testing.assert_array_equal(a, b)
    extra = convert.params_from_jax(npp, cfg, device="cpu")
    extra["stray"] = torch.zeros(1)
    with pytest.raises(ValueError, match="stray"):
        convert.params_to_jax(extra, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_flattens_in_jax_order(arch):
    """The port's one flattening order is ``jax.tree_util``'s: the same
    leaves under the same ``keystr`` names in the same order, and
    ``unflatten_like`` puts them back where they came from."""
    jcfg, cfg = _configs(arch)
    npp = _np(_jax_params(jcfg))
    params = convert.params_from_jax(npp, cfg, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(npp)
    got = list(named_leaves(params))
    assert [n for n, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    back = unflatten_like(params, [t + 1 for t in tree_leaves(params)])
    assert [n for n, _ in named_leaves(back)] == [n for n, _ in got]
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_frees_its_gradients_without_the_collector(arch):
    """A warm step leaves no tensor in reference cycles: the step's
    gradients are freed when it returns, not when the cyclic garbage
    collector next runs (a recursive closure in ``unflatten_like`` held
    them, one parameter set's worth of device memory past the step)."""
    import gc
    _, cfg = _configs(arch)
    params = tm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    opt = tadamw.init_opt_state(params)
    step = tsteps.build_train_step(cfg, tadamw.AdamWConfig(), 2)
    batch = _torch_batch(_batch(cfg, b=4, s=16))
    params, opt, _ = step(params, opt, batch)
    gc.collect()
    gc.disable()
    try:
        params, opt, _ = step(params, opt, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [x for x in gc.garbage if torch.is_tensor(x)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cyclic == []


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_cli_runs_on_the_cpu(arch, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = tlaunch.main(["--device", "cpu", "--reduced", "--arch", arch,
                        "--steps", "3", "--batch", "4", "--seq", "32",
                        "--microbatches", "2", "--log-every", "1",
                        "--ckpt", ck, "--no-strategy-report"])
    text = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss\s+(\S+)", text)]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses == pytest.approx(out["losses"], abs=1e-4)
    assert np.isfinite(out["grad_norms"]).all()
    assert out["launches"] == [{"flash": 0, "ssd": 0, "rglru": 0}] * 3
    assert tstore.peek(ck)["step"] == 3
    # resume continues from the checkpoint's step
    more = tlaunch.main(["--device", "cpu", "--reduced", "--arch", arch,
                         "--steps", "1", "--batch", "4", "--seq", "32",
                         "--resume", ck, "--no-strategy-report"])
    assert f"resumed from {ck} @ step 3" in capsys.readouterr().out
    assert np.isfinite(more["losses"]).all()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b",
                                  "qwen2-vl-72b", "whisper-large-v3"])
def test_trainer_cli_runs_the_new_families(arch):
    """MoE with MLA, MoE, embedding inputs with M-RoPE, and the audio
    encoder-decoder train through the CLI: two steps, finite losses that
    change, finite gradient norms."""
    out = tlaunch.main(["--device", "cpu", "--reduced", "--arch", arch,
                        "--steps", "2", "--batch", "4", "--seq", "32",
                        "--microbatches", "2", "--no-strategy-report"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][0] != out["losses"][1]
    assert np.isfinite(out["grad_norms"]).all()
    assert out["launches"] == [{"flash": 0, "ssd": 0, "rglru": 0}] * 2


def test_trainer_cli_cuts_experts(capsys, monkeypatch):
    """``--experts N`` cuts an MoE layer's routed experts and keeps top-k,
    the expert width, the shared experts and the dense layer; it is
    refused on a config without MoE and below top-k."""
    full = get_config("deepseek-v2-236b").reduced()
    seen = {}

    def spy(cfg, **kw):
        seen["cfg"] = cfg
        return tm.init_params(cfg, **kw)
    monkeypatch.setattr(tlaunch, "init_params", spy)
    args = ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "32", "--no-strategy-report"]
    out = tlaunch.main(args + ["--arch", "deepseek-v2-236b", "--experts",
                               "2"])
    assert "experts=2 " in capsys.readouterr().out
    moe = seen["cfg"].moe
    assert out["experts"] == moe.n_experts == 2
    assert moe == dataclasses.replace(full.moe, n_experts=2)
    assert moe.top_k == 2 and moe.n_shared == full.moe.n_shared == 1
    assert dataclasses.replace(seen["cfg"], moe=full.moe) == full
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all()
    for bad, why in ((["--arch", "qwen2-1.5b", "--experts", "2"],
                      "has no MoE layers"),
                     (["--arch", "deepseek-v2-236b", "--experts", "1"],
                      "below deepseek-v2-236b's top_k of 2")):
        with pytest.raises(SystemExit):
            tlaunch.main(args + bad)
        assert why in capsys.readouterr().err


def test_trainer_cli_runs_the_elastic_probe(capsys):
    """``--elastic-probe`` runs the reference's probe trace (shrink, then
    grow into the pipelined class, m=2) on ``TorchExecutor`` and prints
    each transition before training starts."""
    out = tlaunch.main(["--device", "cpu", "--reduced", "--elastic-probe",
                        "--steps", "1", "--batch", "4", "--seq", "32",
                        "--no-strategy-report"])
    text = capsys.readouterr().out
    assert "elastic probe: 6 step(s), 2 transition(s)" in text
    lines = [ln for ln in text.splitlines() if "(trace)" in ln]
    assert len(lines) >= 2
    assert "shrink (trace) [0, 1, 2, 3] -> [0, 1]" in lines[0]
    assert "grow (trace) [0, 1] -> [0, 1, 2, 3]" in lines[1]
    assert text.index("elastic probe") < text.index("step     0")
    assert np.isfinite(out["losses"]).all()


def test_trainer_cli_rejects_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_strategy_report_matches_the_reference(arch, capsys):
    """The startup report through the copied api and search prints what
    the reference's prints on one device."""
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.train import strategy_report as jreport
    jcfg, cfg = _configs(arch)
    jparams = _jax_params(jcfg)
    jreport(jparams, make_smoke_mesh(), num_microbatches=2, cfg=jcfg,
            global_batch=4, seq_len=32)
    want = capsys.readouterr().out
    params = convert.params_from_jax(_np(jparams), cfg, device="cpu")
    tlaunch.strategy_report(params, 1, num_microbatches=2, cfg=cfg,
                            global_batch=4, seq_len=32)
    assert capsys.readouterr().out == want
    assert "winner" in want


@pytest.mark.parametrize("cluster", ["cpu1", "cpu4", "cpu8", "hetero2+2",
                                     "hetero4+4"])
def test_search_copy_picks_the_references_winner(cluster):
    def make(pkg):
        if cluster.startswith("cpu"):
            return pkg.cpu_cluster(int(cluster[3:]))
        fast, slow = map(int, cluster[6:].split("+"))
        return pkg.cpu_hetero_cluster(fast, slow)

    kw = dict(global_batch=16, seq_len=256)
    want = jsearch.search(make(jsearch), jsearch.tiny_spec(), **kw)
    got = tsearch.search(make(tsearch), tsearch.tiny_spec(), **kw)
    assert got.prune_report.summary() == want.prune_report.summary()
    assert [r.describe() for r in got.ranked] == \
        [r.describe() for r in want.ranked]
    assert got.best.describe() == want.best.describe()


def test_search_copy_rejects_what_the_reference_rejects():
    """A model too large for the CPU fixture's memory: every candidate is
    pruned, and both packages raise the same ``SearchError``."""
    from repro.core.costmodel import ModelSpec as JSpec
    from repro_torch.core.costmodel import ModelSpec as TSpec
    big = ("huge", 80, 16384, 65536)
    with pytest.raises(jsearch.SearchError) as jerr:
        jsearch.search(jsearch.cpu_cluster(2), JSpec(*big, vocab=256000),
                       global_batch=8)
    with pytest.raises(tsearch.SearchError) as terr:
        tsearch.search(tsearch.cpu_cluster(2), TSpec(*big, vocab=256000),
                       global_batch=8)
    assert str(terr.value) == str(jerr.value)
    assert "memory" in str(terr.value)


def test_search_copy_validates_on_the_simulator_as_the_reference():
    """Top-2 candidates executed as proxy programs on each package's
    SimulatorExecutor: the same first-step losses.  The port validates on
    a ``TorchExecutor`` too (``executors=("sim", "torch")``): its first
    step's loss and every gradient bitwise the simulator's, for every
    executed candidate; ``"jax"`` is refused."""
    kw = dict(global_batch=16, seq_len=256, validate_top=2, repeats=1)
    want = jsearch.search(jsearch.cpu_cluster(4), jsearch.tiny_spec(), **kw)
    got = tsearch.search(tsearch.cpu_cluster(4), tsearch.tiny_spec(),
                         executors=("sim", "torch"), device="cpu", **kw)
    assert [(e.name, e.m, e.schedule, e.loss, e.error)
            for e in got.validation.executed] == \
        [(e.name, e.m, e.schedule, e.loss, e.error)
         for e in want.validation.executed]
    assert len(got.validation.executed) == 2
    assert all(e.bit_exact is True for e in got.validation.executed)
    with pytest.raises(NotImplementedError, match="'jax'"):
        tsearch.search(tsearch.cpu_cluster(4), tsearch.tiny_spec(),
                       executors=("sim", "jax"), **kw)


def test_ssd_plain_gradient_is_finite_where_the_reference_overflows():
    """At a full chunk of 256 the intra-chunk decay exp(cum_i - cum_j)
    overflows above the diagonal.  The JAX oracle's
    ``where(causal, exp(diff), 0)`` then back-propagates 0 * inf = NaN into
    dt and A; the port masks before the exp, so its forward is the same
    and its gradient finite, and equal to the float64 gradient (normwise
    1e-4)."""
    from repro.models.ssm import ssd_chunked
    from repro_torch.kernels.ref import ssd_scan_ref
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 1, 256, 2, 8, 4, 256
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.ones(h, np.float32)
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32)
            for _ in range(2))
    args = (x, dt, A, B, C)

    def jloss(*a):
        y, st = ssd_chunked(*a, chunk)
        return jnp.sum(y) + jnp.sum(st)
    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    assert not np.isfinite(np.asarray(jgrads[1])).all()   # the reference

    def grads(dtype):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
        y, st = ssd_scan_ref(*ts, chunk)
        return (y, st), torch.autograd.grad(y.sum() + st.sum(), ts)
    (y, st), g32 = grads(torch.float32)
    _, g64 = grads(torch.float64)
    jy, jst = ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(jst),
                               atol=1e-3, rtol=1e-4)
    for a, b64 in zip(g32, g64):
        assert torch.isfinite(a).all()
        assert _normwise(a.numpy(), b64.numpy()) <= GRAD_NORMWISE


def test_sharded_adamw_in_chunks_matches_the_jax_package(monkeypatch):
    """The sharded AdamW's flat elementwise chain, run a few elements at
    a time (chunks that cut across tiles), against the JAX package's
    ``sharded_apply_updates`` over three steps, bit for bit: replicated,
    split and Partial-free tiles, the first step's concatenation and the
    later steps' in-place reuse."""
    from repro import api as japi
    from repro.core.simulator import scatter as jscatter
    from repro_torch import api
    from repro_torch.core.simulator import scatter

    monkeypatch.setattr(tadamw, "FLAT_CHUNK", 5)
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 4), "b": (3, 5), "c": (8,)}
    annots = {"a": lambda m: m.spmd([0, 1, 2, 3], m.DS({m.DUP: 2, 0: 2})),
              "b": lambda m: m.spmd([0, 1, 2, 3], m.DS({m.DUP: 4})),
              "c": lambda m: m.spmd([0, 1], m.DS({0: 2}))}
    values = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=2, weight_decay=0.1)
    sides = {}
    for pkg, adamw, sc in (("torch", tadamw, scatter),
                           ("jax", jadamw, jscatter)):
        m = api if pkg == "torch" else japi
        params = {k: sc(v, annots[k](m)) for k, v in values.items()}
        state = adamw.init_sharded_state(params)
        out = []
        for step in range(3):
            g = np.random.default_rng(10 + step)
            grads = {k: sc(g.standard_normal(shapes[k]).astype(np.float32),
                           annots[k](m)) for k in shapes}
            params, state, metrics = adamw.sharded_apply_updates(
                params, grads, state, adamw.AdamWConfig(**cfg))
            out.append(({k: dict(st.parts) for k, st in params.items()},
                        {k: dict(st.parts) for k, st in state["m"].items()},
                        {k: dict(st.parts) for k, st in state["v"].items()},
                        metrics["grad_norm"]))
        sides[pkg] = out
    for step, (got, want) in enumerate(zip(sides["torch"], sides["jax"])):
        assert got[3] == want[3], step
        for tree_got, tree_want in zip(got[:3], want[:3]):
            for k in shapes:
                for dev, arr in tree_want[k].items():
                    np.testing.assert_array_equal(
                        tree_got[k][dev], np.asarray(arr),
                        err_msg=f"step {step} {k} dev {dev}")
