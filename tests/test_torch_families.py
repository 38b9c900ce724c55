"""The port's MLA, M-RoPE, MoE-stack and audio encoder-decoder against the
JAX package, on the CPU at reduced size: DeepSeek-V2 (MLA, a dense layer
then MoE with a shared expert), Grok-1 (GQA MoE, GELU), Qwen2-VL
(embedding inputs, M-RoPE) and Whisper (LayerNorm, encoder, cross-
attention).

Parameters come from the JAX ``init_params(PRNGKey(0))`` and are carried
over by ``convert.params_from_jax``; inputs are numpy arrays from a seed.
The JAX side runs under kernel policy ``ref`` (its Pallas flash kernel
cannot take MLA's unequal head dims).  Tolerances follow
``tests/test_archs.py`` and ``tests/test_torch_train.py``: layers doing the
same fp32 math at 1e-5; logits at atol 2e-3, rtol 1e-3; the loss at
relative 1e-5 and each gradient at normwise 1e-4.  The reduced MoE
configs have ``moe.exact`` (no drops), so decode agrees with the forward.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.kernels import policy as jpolicy  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as ALL_ARCHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.tree import (paths, tree_leaves,  # noqa: E402
                              unflatten_like)

ARCHS = ["deepseek-v2-236b", "grok-1-314b", "qwen2-vl-72b",
         "whisper-large-v3"]
LOGITS_TOL = dict(atol=2e-3, rtol=1e-3)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL, GRAD_NORMWISE = 1e-5, 1e-4
B, S = 2, 64


@pytest.fixture(autouse=True)
def _jax_ref_policy():
    jpolicy.set_policy("ref")
    yield
    jpolicy.set_policy("auto")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_CACHE: dict = {}


def _setup(arch):
    """(jcfg, tcfg, JAX params, port params), built once per arch."""
    if arch not in _CACHE:
        jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
        _CACHE[arch] = (jcfg, tcfg, jparams, convert.params_from_jax(
            _np(jparams), tcfg, device="cpu"))
    return _CACHE[arch]


def _inputs(cfg, seed, b=B, s=S):
    """A numpy batch for the config's input kind: packed documents'
    tokens, labels, loss_mask and positions; for embedding inputs the
    tokens as one_hot(token % d) * 0.02 and distinct t / h / w M-RoPE
    streams (an 4 x 4 image grid, then text); audio frames for Whisper."""
    corpus = jpipe.SyntheticCorpus(jpipe.CorpusConfig(
        vocab=cfg.vocab, max_len=s, seed=seed))
    out = jpipe.pack_batch(corpus.sample_sequences(3 * b), b, s)
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        tok = out.pop("tokens")
        out["embeds"] = (np.eye(cfg.d_model, dtype=np.float32)[
            tok % cfg.d_model] * 0.02).astype(np.float32)
        out["positions3"] = _positions3(b, s)
    elif cfg.input_kind == "audio":
        out["audio_embeds"] = (rng.standard_normal(
            (b, cfg.encdec.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _positions3(b, s, g=4):
    r = np.arange(g * g)
    image = np.stack([np.zeros_like(r), r // g, r % g])
    text = np.broadcast_to(np.arange(g, g + s - g * g), (3, s - g * g))
    return np.broadcast_to(np.concatenate([image, text], 1)[:, None],
                           (3, b, s)).astype(np.int32)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _normwise(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return np.linalg.norm(got - want) / norm if norm else \
        float(np.abs(got).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_the_reference(arch):
    assert repr(get_config(arch)) == repr(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_last_only_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    batch = _inputs(tcfg, 1)
    jlog, jaux = jm.forward(jparams, _jax(batch), jcfg, last_only=True)
    tlog, taux = tm.forward(tparams, _torch(batch), tcfg, last_only=True)
    assert tlog.shape == (B, 1, tcfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **LAYER_TOL)
    assert (taux.item() > 0) == bool(tcfg.moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax_and_forward(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    n = 20
    batch = _inputs(tcfg, 2, s=n)
    jb, tb = _jax(batch), _torch(batch)
    enc_j = enc_t = None
    if tcfg.encdec:
        enc_j = jm._run_encoder(jparams, jb, jcfg)
        enc_t = tm.run_encoder(tparams, tb, tcfg)
    jstate = jm.init_decode_state(jcfg, B, n, enc_out=enc_j)
    tstate = tm.init_decode_state(tcfg, B, n, device="cpu", enc_out=enc_t)
    jstep = jax.jit(lambda p, s, b: jm.decode_step(p, s, b, jcfg))
    keys = ("embeds", "positions3") if tcfg.input_kind == "embeds" \
        else ("tokens",)
    touts = []
    for t in range(n):
        step = {k: batch[k][:, :, t:t + 1] if k == "positions3"
                else batch[k][:, t:t + 1] for k in keys}
        jlog, jstate = jstep(jparams, jstate, _jax(step))
        tlog, tstate = tm.decode_step(tparams, tstate, _torch(step), tcfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGITS_TOL)
        touts.append(tlog[:, 0])
    assert tstate["pos"] == n
    full_batch = {k: tb[k] for k in keys + (("audio_embeds",)
                                            if tcfg.encdec else ())}
    full, _ = tm.forward(tparams, full_batch, tcfg)
    np.testing.assert_allclose(torch.stack(touts, 1).numpy(), full.numpy(),
                               **LOGITS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    batch = _inputs(tcfg, 3)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, _jax(batch), jcfg)
    params = convert.params_from_jax(_np(jparams), tcfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tm.loss_fn(params, _torch(batch), tcfg)
    grads = unflatten_like(params, torch.autograd.grad(loss, leaves))
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    np.testing.assert_allclose(met["aux"].item(), float(jmet["aux"]),
                               **LAYER_TOL)
    got = jax.tree_util.tree_leaves_with_path(
        convert.params_to_jax(grads, tcfg))
    want = jax.tree.leaves(_np(jgrads))
    assert len(got) == len(want)
    worst = max((_normwise(a, b), jax.tree_util.keystr(path))
                for (path, a), b in zip(got, want))
    assert worst[0] <= GRAD_NORMWISE, worst


def test_run_encoder_matches_jax():
    jcfg, tcfg, jparams, tparams = _setup("whisper-large-v3")
    batch = _inputs(tcfg, 4)
    want = jm._run_encoder(jparams, _jax(batch), jcfg)
    got = tm.run_encoder(tparams, _torch(batch), tcfg)
    assert got.shape == (B, tcfg.encdec.n_frames, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("layer", [0, 1], ids=["dense", "moe"])
def test_apply_mla_prefill_and_decode_match_jax(layer):
    jcfg, tcfg, jparams, tparams = _setup("deepseek-v2-236b")
    gname = "g0_dense" if layer == 0 else "g1_moe"
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][gname]["attn"])
    tp = {k: v[0] for k, v in tparams["groups"][gname]["attn"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 16, tcfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(16)[None], (B, 16)).astype(np.int32)
    want, _ = jl.apply_mla(jp, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos))
    got, _ = tl.apply_mla(tp, torch.from_numpy(x), tcfg,
                          positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)

    m = tcfg.mla
    jc = {"c_kv": jnp.zeros((B, 16, m.kv_lora)),
          "k_rope": jnp.zeros((B, 16, m.qk_rope_dim)), "idx": jnp.int32(0)}
    tc = {"c_kv": torch.zeros((B, 16, m.kv_lora)),
          "k_rope": torch.zeros((B, 16, m.qk_rope_dim)), "idx": 0}
    for t in range(16):
        jy, jc = jl.apply_mla(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                              positions=jnp.asarray(pos[:, t:t + 1]),
                              cache=jc)
        ty, tc = tl.apply_mla(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                              positions=torch.from_numpy(pos[:, t:t + 1]),
                              cache=tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(ty[:, 0].numpy(), got[:, t].numpy(),
                                   **LAYER_TOL)
    assert tc["idx"] == 16
    np.testing.assert_allclose(tc["c_kv"].numpy(), np.asarray(jc["c_kv"]),
                               **LAYER_TOL)
    np.testing.assert_allclose(tc["k_rope"].numpy(),
                               np.asarray(jc["k_rope"]), **LAYER_TOL)


@pytest.mark.parametrize("hd", [64, 128])
def test_apply_mrope_matches_jax_with_distinct_streams(hd):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, 3, hd), dtype=np.float32)
    p3 = _positions3(2, 40, g=5)
    assert not (p3[0] == p3[1]).all() and not (p3[1] == p3[2]).all()
    want = jl.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # on equal streams M-RoPE is RoPE
    same = np.ascontiguousarray(np.broadcast_to(p3[2:3], p3.shape))
    np.testing.assert_allclose(
        tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                       1e6).numpy(),
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(p3[2]),
                      1e6).numpy(), **LAYER_TOL)


def test_cross_attention_matches_jax():
    jcfg, tcfg, jparams, tparams = _setup("whisper-large-v3")
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["g0_dec"]["xattn"])
    tp = {k: v[0] for k, v in tparams["groups"]["g0_dec"]["xattn"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 12, tcfg.d_model), dtype=np.float32)
    src = rng.standard_normal((B, 8, tcfg.d_model), dtype=np.float32)
    want, _ = jl.apply_attention(jp, jnp.asarray(x), jcfg, causal=False,
                                 kv_src=jnp.asarray(src), use_rope=False)
    got, _ = tl.apply_attention(tp, torch.from_numpy(x), tcfg, causal=False,
                                kv_src=torch.from_numpy(src),
                                use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_at_unequal_head_dims(causal):
    """B1's plain version with q / k at 48 and v at 32 (the reduced MLA's
    head dims; 192 / 128 at published width) against the JAX package's
    plain ``_sdpa_block``: the output takes v's head dim, the scale q's."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 128, 4, 48), dtype=np.float32)
    k = rng.standard_normal((2, 128, 2, 48), dtype=np.float32)
    v = rng.standard_normal((2, 128, 2, 32), dtype=np.float32)
    want = jl._sdpa_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, window=None, q_offset=0,
                          length_mask=None)
    got = ref.flash_attention_ref(*(torch.from_numpy(a).transpose(1, 2)
                                    for a in (q, k, v)), causal=causal)
    assert got.shape == (2, 4, 128, 32)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_jax_tree(arch):
    _, tcfg, jparams, _ = _setup(arch)
    own = tm.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_leaves_with_path(jparams)}
    got = {"".join(f"[{k!r}]" for k in p): tuple(s) for p, s in
           convert.param_shapes(tcfg).items()}
    assert got == want
    assert {"".join(f"[{k!r}]" for k in p): tuple(t.shape) for p, t in
            paths(own)} == want
    assert ("embed" in own) == (tcfg.input_kind != "embeds")


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_batch_matches_the_reference(arch):
    """``make_batch`` builds the JAX trainer's inputs: embeddings and
    M-RoPE ids from the tokens for Qwen2-VL, audio frames for Whisper."""
    from repro.launch import train as jtrain
    _, tcfg, _, _ = _setup(arch)
    jcfg = jget_config(arch).reduced()
    corpus_j = jpipe.SyntheticCorpus(jpipe.CorpusConfig(vocab=tcfg.vocab,
                                                        max_len=32, seed=0))
    from repro_torch.data.pipeline import CorpusConfig, SyntheticCorpus
    corpus_t = SyntheticCorpus(CorpusConfig(vocab=tcfg.vocab, max_len=32,
                                            seed=0))
    want = jtrain.make_batch(corpus_j, jcfg, 4, 32,
                             np.random.default_rng(0))
    got = tlaunch.make_batch(corpus_t, tcfg, 4, 32,
                             np.random.default_rng(0), "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=0)


def test_microbatches_cut_positions3_along_the_batch():
    """Two microbatches of a Qwen2-VL batch: ``positions3`` (3, B, S) is
    cut along B with the embeddings, and the accumulated loss is the mean
    of the two halves' losses, as the JAX train step's reshape gives."""
    from repro_torch.train import steps as tsteps
    _, tcfg, jparams, _ = _setup("qwen2-vl-72b")
    batch = _inputs(tcfg, 5, b=4, s=32)
    batch["positions3"] = batch["positions3"] + np.arange(4)[None, :, None]
    tb = _torch(batch)
    halves = tsteps._split(tb, 2)
    for j, mb in enumerate(halves):
        assert mb["positions3"].shape == (3, 2, 32)
        assert torch.equal(mb["positions3"],
                           tb["positions3"][:, 2 * j:2 * j + 2])
        assert torch.equal(mb["embeds"], tb["embeds"][2 * j:2 * j + 2])
    params = convert.params_from_jax(_np(jparams), tcfg, device="cpu")
    loss, _ = tsteps.accumulate_grads(params, tb, tcfg, 2, remat=False)
    want = [tm.loss_fn(params, mb, tcfg)[0].item() for mb in halves]
    assert loss.item() == pytest.approx(np.mean(want), rel=1e-6)


def _jax_serve(jcfg, jparams, prompt, gen):
    """The JAX serving pair over the port's prompt batch (numpy): prefill,
    the teacher-forced cache fill, greedy decode; generated tokens go back
    as one_hot(token % d) * 0.02 for embedding inputs."""
    from repro.train import steps as jsteps
    prefill = jax.jit(jsteps.build_prefill_step(jcfg))
    step = jax.jit(jsteps.build_decode_step(jcfg))
    logits = prefill(jparams, _jax(prompt))
    lead = prompt.get("tokens", prompt.get("embeds"))
    b, p = lead.shape[:2]
    enc = (jm._run_encoder(jparams, _jax(prompt), jcfg) if jcfg.encdec
           else None)
    state = jm.init_decode_state(jcfg, b, p + gen, enc_out=enc)
    embeds = jcfg.input_kind == "embeds"
    for t in range(p):
        one = ({"embeds": prompt["embeds"][:, t:t + 1],
                "positions3": prompt["positions3"][:, :, t:t + 1]}
               if embeds else {"tokens": prompt["tokens"][:, t:t + 1]})
        _, state = step(jparams, state, _jax(one))
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        if embeds:
            one = {"embeds": jax.nn.one_hot(tok % jcfg.d_model, jcfg.d_model,
                                            dtype=jnp.float32) * 0.02,
                   "positions3": jnp.asarray(
                       prompt["positions3"][:, :, -1:] + 1 + i)}
        else:
            one = {"tokens": tok}
        logits, state = step(jparams, state, one)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_the_jax_serving_pair(arch):
    """``serve.generate`` on ``serve.make_prompt``'s batch (tokens; an image
    grid and text as embeddings with M-RoPE ids; audio frames beside the
    tokens) generates the JAX serving pair's greedy tokens, and its
    teacher-forced decode agrees with its prefill."""
    from repro_torch import serve
    jcfg, tcfg, jparams, tparams = _setup(arch)
    prompt = serve.make_prompt(tcfg, B, 32, np.random.default_rng(0), "cpu")
    if tcfg.input_kind == "embeds":
        p3 = prompt["positions3"]
        assert (p3[:, 0, :16] == torch.tensor(
            [[0] * 16, [r // 4 for r in range(16)],
             [r % 4 for r in range(16)]])).all()
        assert (p3[:, 0, 16:] == torch.arange(4, 20)).all()
    res = serve.generate(tparams, tcfg, prompt, 4)
    assert res["agree"] and res["tokens"].shape == (B, 4)
    want = _jax_serve(jcfg, jparams, {k: v.numpy() for k, v in
                                      prompt.items()}, 4)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_runs_init_forward_and_decode(arch):
    """All twelve configs (reduced) through the port's entry points on the
    CPU: init, a forward with its loss, one decode step; logits finite and
    of the vocabulary's width."""
    from repro_torch import serve
    cfg = get_config(arch).reduced()
    params = tm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = serve.make_prompt(cfg, 2, 16, np.random.default_rng(0), "cpu")
    batch = dict(prompt, labels=torch.zeros((2, 16), dtype=torch.long))
    loss, met = tm.loss_fn(params, batch, cfg)
    assert np.isfinite(loss.item()) and (met["aux"].item() > 0) == bool(
        cfg.moe)
    enc = tm.run_encoder(params, prompt, cfg) if cfg.encdec else None
    state = tm.init_decode_state(cfg, 2, 4, device="cpu", enc_out=enc)
    logits, state = tm.decode_step(params, state,
                                   serve.decode_batch(cfg, prompt, 0), cfg)
    assert logits.shape == (2, 1, cfg.vocab) and state["pos"] == 1
    assert torch.isfinite(logits).all()
