"""Transformer block expressed in the differentiable graph IR.

``build_block`` grows a :class:`~repro_torch.core.graph.Graph` into the
standard pre-norm decoder block stack of a :class:`ModelConfig` —
embedding lookup, per-layer (rmsnorm -> QKV projections -> multi-head
``attention`` -> output projection -> residual) and (rmsnorm -> SwiGLU /
GeLU MLP -> residual), final norm and a softmax+gather loss head — using
only graph-IR op kinds, so HSPMD deduction, reverse-mode autodiff and
both executors apply to a real architecture end to end.

The math mirrors ``models.layers`` with ``positions=None`` (no RoPE;
rotary embeddings need interleaved trig kernels the IR does not carry
yet) and the loss head is ``mean(softmax(logits)[labels])`` — ``gather``
of the label column, a scalar training loss that exercises softmax and
gather VJPs without a ``log`` op kind.

``block_strategy`` then annotates the SAME graph for a TP x DP x PP
layout: activations batch-split over DP and duplicated over TP, column
weights (wq/wk/wv, gate/up, lm head) split over TP on their output dim,
row weights (wo, down) on their contraction dim (producing Partial
partial-sums that the per-layer CommOps all-reduce), norm weights
replicated, and consecutive layer spans placed on consecutive pipeline
stages with boundary CommOps carrying the residual stream — the
annotation-entry orders are chosen so deduction composes without any
further resharding.  ``block_program`` bundles both into an
``api.Program`` ready for ``compile_train``.
"""

from __future__ import annotations

from ..core.annotations import DS, DUP, spmd

# roles an annotation point can play under the TP x DP x PP layout;
# ``block_strategy`` maps each to a DS whose entry ORDER (outermost
# first) keeps the device -> shard decomposition consistent across ops
ACT = "act"            # (B, ...) activation: [(0, dp), (DUP, tp)]
ACT_LAST = "act_last"  # activation split on its LAST dim over tp
COL = "col"            # (k, n) weight: [(DUP, dp), (1, tp)]
ROW = "row"            # (k, ...) weight/bias: [(DUP, dp), (0, tp)]
REP = "rep"            # fully replicated: [(DUP, dp*tp)]


def _mark(g, t, role: str, stage: int):
    g.block_roles[t.name] = role
    g.block_stages[t.name] = stage
    return t


def _bias_add(g, y, bias, stage: int, name: str):
    """Lift a 1-D column-split bias onto the activation layout: two
    ``bcast`` ops insert (S, B), then a CommOp slices the broadcast onto
    the batch-split placement (an intra-group Slice — no wire traffic)."""
    B, S, _ = y.shape
    bb = g.bcast(g.bcast(bias, 0, S), 0, B)
    bb = _mark(g, g.comm(bb, name=f"{name}_b"), ACT_LAST, stage)
    return g.add(y, bb, name=name)


def build_block(g, cfg, *, batch: int = 4, seq: int = 8,
                n_layers: "int | None" = None, pp: int = 1,
                embed: bool = True, loss_head: bool = True):
    """Grow ``g`` into the block stack of ``cfg``; returns the scalar
    loss tensor (or the residual-stream output when ``loss_head`` is
    off).  ``pp`` fixes where the stage-boundary CommOps go — the graph
    must agree with the strategies later installed on it."""
    B, S, d = batch, seq, cfg.d_model
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = cfg.n_layers if n_layers is None else n_layers
    if pp < 1 or pp > L:
        raise ValueError(f"pp={pp} must be in 1..{L} (one layer span "
                         f"per stage at minimum)")
    g.block_roles = {}
    g.block_stages = {}

    def stage_of(i):
        return i * pp // L

    if embed:
        ids = _mark(g, g.placeholder("ids", (B, S)), ACT, 0)
        table = _mark(g, g.parameter("embed", (cfg.vocab, d)), REP, 0)
        x = g.embedding(table, ids, name="x0")
    else:
        x = _mark(g, g.placeholder("X", (B, S, d)), ACT, 0)

    for i in range(L):
        st = stage_of(i)
        if i > 0 and st != stage_of(i - 1):
            x = _mark(g, g.comm(x, name=f"pp{st}/x"), ACT, st)
        p = f"l{i}/"

        # -- attention half-layer -------------------------------------
        a_in = g.rmsnorm(
            x, _mark(g, g.parameter(p + "attn_norm", (d,)), REP, st),
            eps=cfg.norm_eps, name=p + "attn_in")
        q = g.dot(a_in, _mark(g, g.parameter(p + "wq", (d, H * hd)),
                              COL, st), name=p + "q0")
        k = g.dot(a_in, _mark(g, g.parameter(p + "wk", (d, K * hd)),
                              COL, st), name=p + "k0")
        v = g.dot(a_in, _mark(g, g.parameter(p + "wv", (d, K * hd)),
                              COL, st), name=p + "v0")
        if cfg.qkv_bias:
            q = _bias_add(g, q, _mark(g, g.parameter(p + "bq", (H * hd,)),
                                      ROW, st), st, p + "q")
            k = _bias_add(g, k, _mark(g, g.parameter(p + "bk", (K * hd,)),
                                      ROW, st), st, p + "k")
            v = _bias_add(g, v, _mark(g, g.parameter(p + "bv", (K * hd,)),
                                      ROW, st), st, p + "v")
        qh = g.transpose(g.reshape(q, (B, S, H, hd)), (0, 2, 1, 3),
                         name=p + "qh")
        kh = g.transpose(g.reshape(k, (B, S, K, hd)), (0, 2, 1, 3),
                         name=p + "kh")
        vh = g.transpose(g.reshape(v, (B, S, K, hd)), (0, 2, 1, 3),
                         name=p + "vh")
        att = g.attention(qh, kh, vh, causal=True, name=p + "att")
        ao = g.reshape(g.transpose(att, (0, 2, 1, 3)), (B, S, H * hd),
                       name=p + "ao")
        proj = g.dot(ao, _mark(g, g.parameter(p + "wo", (H * hd, d)),
                               ROW, st), name=p + "proj")
        proj = _mark(g, g.comm(proj, name=p + "attn_out"), ACT, st)
        x = g.add(x, proj, name=p + "x_attn")

        # -- MLP half-layer -------------------------------------------
        m_in = g.rmsnorm(
            x, _mark(g, g.parameter(p + "mlp_norm", (d,)), REP, st),
            eps=cfg.norm_eps, name=p + "mlp_in")
        up = g.dot(m_in, _mark(g, g.parameter(p + "w_up", (d, cfg.d_ff)),
                               COL, st), name=p + "up")
        if cfg.mlp in ("swiglu", "geglu"):
            gate = g.dot(m_in, _mark(g, g.parameter(p + "w_gate",
                                                    (d, cfg.d_ff)),
                                     COL, st), name=p + "gate")
            act = g.silu(gate) if cfg.mlp == "swiglu" else g.gelu(gate)
            h = g.mul(act, up, name=p + "h")
        else:
            h = g.gelu(up, name=p + "h")
        down = g.dot(h, _mark(g, g.parameter(p + "w_down", (cfg.d_ff, d)),
                              ROW, st), name=p + "down")
        down = _mark(g, g.comm(down, name=p + "mlp_out"), ACT, st)
        x = g.add(x, down, name=p + "x")

    if not loss_head:
        return x

    last = stage_of(L - 1)
    xf = g.rmsnorm(
        x, _mark(g, g.parameter("final_norm", (d,)), REP, last),
        eps=cfg.norm_eps, name="xf")
    if embed and cfg.tie_embeddings:
        # tied head: reuse the embedding table, resharded onto the last
        # stage in column-parallel layout (grads from both uses of the
        # table accumulate through the CommOp's VJP)
        lm = _mark(g, g.comm(g.transpose(g.tensors["embed"], (1, 0)),
                             name="lm_head"), COL, last)
    else:
        lm = _mark(g, g.parameter("lm_head", (d, cfg.vocab)), COL, last)
    logits = g.dot(xf, lm, name="logits0")
    # softmax spans the full vocab: gather the TP-split logits first
    logits = _mark(g, g.comm(logits, name="logits"), ACT, last)
    probs = g.softmax(logits, name="probs")
    labels = _mark(g, g.placeholder("labels", (B, S)), ACT, last)
    pl = g.gather(probs, labels, name="pl")
    return g.scale(g.sum(g.sum(pl, 1), 0), 1.0 / (B * S), name="loss")


def block_strategy(g, *, dp: int = 1, tp: int = 1, pp: int = 1,
                   devices=None, name: "str | None" = None):
    """Annotate a ``build_block`` graph for a dp x tp x pp layout:
    ``pp`` consecutive stage groups of ``dp * tp`` devices each, DP
    outermost within a group."""
    from repro_torch import api

    per = dp * tp
    n_stages = max(g.block_stages.values(), default=0) + 1
    if pp != n_stages:
        raise ValueError(
            f"strategy pp={pp} but the graph was built with "
            f"{n_stages} stage span(s); rebuild with pp={pp}")
    devices = list(devices) if devices is not None \
        else list(range(per * pp))
    if len(devices) != per * pp:
        raise ValueError(f"{len(devices)} devices for dp*tp*pp = "
                         f"{per * pp}")
    stage_devs = [devices[s * per:(s + 1) * per] for s in range(pp)]
    annots = {}
    for t in g.annotation_points():
        role = g.block_roles[t.name]
        sd = stage_devs[g.block_stages[t.name]]
        if role == ACT:
            ds = DS([(0, dp), (DUP, tp)])
        elif role == ACT_LAST:
            ds = DS([(0, dp), (len(t.shape) - 1, tp)])
        elif role == COL:
            ds = DS([(DUP, dp), (1, tp)])
        elif role == ROW:
            ds = DS([(DUP, dp), (0, tp)])
        elif role == REP:
            ds = DS({DUP: per})
        else:
            raise ValueError(f"unknown block role {role!r} for {t.name}")
        annots[t.name] = spmd(sd, ds)
    return api.Strategy(name or f"dp{dp}tp{tp}pp{pp}", annots)


def block_program(cfg, *, batch: int = 4, seq: int = 8,
                  n_layers: "int | None" = None, dp: int = 1, tp: int = 1,
                  pp: int = 1, embed: bool = True, loss_head: bool = True,
                  name: "str | None" = None):
    """One-call bundle: a ``build_block`` graph of ``cfg`` under a
    single dp x tp x pp strategy, as an ``api.Program``."""
    from repro_torch import api

    g = api.Graph()
    build_block(g, cfg, batch=batch, seq=seq, n_layers=n_layers, pp=pp,
                embed=embed, loss_head=loss_head)
    strat = block_strategy(g, dp=dp, tp=tp, pp=pp, name=name)
    return api.Program(g, [strat])
