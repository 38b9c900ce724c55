"""The serving pair: the PyTorch counterpart of ``build_prefill_step`` and
``build_decode_step`` in ``repro/train/steps.py``.  Prefill runs a full
forward over the context; decode consumes one token with the KV caches as
carried state.  Both run without autograd.  The training steps come with
the slice that ports training.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import decode_step, forward


def build_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        # the head on the last position only: what a server samples from
        logits, _ = forward(params, batch, cfg, last_only=True)
        return logits[:, -1, :]

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def serve_step(params, state, batch):
        logits, new_state = decode_step(params, state, batch, cfg)
        return logits[:, -1, :], new_state

    return serve_step
