"""Train / prefill / decode step builders: the PyTorch counterpart of
``repro/train/steps.py``.

``build_train_step``: gradient accumulation over microbatches (the global
batch is cut into ``num_microbatches`` along dim 0 inside the step), remat
around each block, fp32 gradient accumulation, AdamW update in place.

``build_prefill_step`` / ``build_decode_step``: the serving pair -- prefill
runs a full forward over the context; decode consumes one token with the
KV caches as carried state.  Both run without autograd, and pass the
batch through whole: ``tokens``, or ``embeds`` and ``positions3`` for
embedding inputs, and ``audio_embeds`` for an encoder-decoder's prefill
(its decode state carries ``enc_out``).

Under an active mesh each microbatch is pinned back to the batch axes
(``repro/train/steps.py:45-52``).  The reference's ``build_graph_train_step`` and
``build_switch_step``, thin wrappers of ``Session.train_step`` and
``execute_switch``, are not ported: callers use ``repro_torch.api.Session``
directly.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import decode_step, forward, loss_fn
from ..optim.adamw import AdamWConfig, apply_updates
from ..sharding.hints import active, batch_axes, hint, like
from ..tree import tree_leaves, unflatten_like


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of ``batch``: each tensor whose leading dim
    divides by ``n`` is cut into ``n`` consecutive slices along it, as the
    reference's ``(G, ...) -> (n, G/n, ...)`` reshape cuts it, and M-RoPE's
    ``positions3`` (3, G, S) along its batch dim; any other leaf goes whole
    to every microbatch.  (The reference takes any leaf of shape (3, ...)
    for ``positions3``; the port goes by its name.)"""
    def cut(k, v):
        if k == "positions3":
            return torch.chunk(v, n, dim=1)
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] % n == 0:
            return torch.chunk(v, n)
        return None

    def pin(k, v):
        # re-pin the batch sharding the cut loses (identity without a mesh)
        bd = batch_axes()
        if not bd or not torch.is_tensor(v):
            return v
        return hint(v, None, bd) if k == "positions3" else hint(v, bd)

    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: pin(k, batch[k] if parts[k] is None else parts[k][j])
             for k in batch} for j in range(n)]


def accumulate_grads(params, batch, cfg: ModelConfig,
                     num_microbatches: int = 1, remat: bool = True):
    """The loss and the gradients of one training step -> (loss, grads).

    One forward and backward per microbatch.  The fp32 gradients add up in
    the reference's order: from zero, each microbatch in turn, then divided
    by the count; the loss is the mean of the microbatch losses.  The
    parameters are made leaves that require grad."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    n = num_microbatches
    acc, losses = None, []
    for mb in (_split(batch, n) if n > 1 else [batch]):
        loss, _ = loss_fn(params, mb, cfg, remat=remat)
        grads = [like(g, p) for g, p in
                 zip(torch.autograd.grad(loss, leaves), leaves)]
        losses.append(loss.detach())
        if acc is None:    # 0 + g is g
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        del grads, loss
    if n > 1:
        for a in acc:
            a.div_(n)
    loss = torch.mean(torch.stack(losses)) if n > 1 else losses[0]
    return loss, unflatten_like(params, acc)


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     num_microbatches: int = 1, remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``; the parameters and the optimizer state
    are updated in place and returned."""
    def train_step(params, opt_state, batch):
        loss, grads = accumulate_grads(params, batch, cfg, num_microbatches,
                                       remat)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def _serving():
    """Inference mode; under the dry run's DTensor mesh no_grad (DTensor
    does not run in inference mode)."""
    a = active()
    return torch.no_grad() if a is not None and a.device_mesh is not None \
        else torch.inference_mode()


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        # the head on the last position only: what a server samples from
        with _serving():
            logits, _ = forward(params, batch, cfg, last_only=True)
            return logits[:, -1, :]

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    def serve_step(params, state, batch):
        with _serving():
            logits, new_state = decode_step(params, state, batch, cfg)
            return logits[:, -1, :], new_state

    return serve_step
