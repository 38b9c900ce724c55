"""Input specs for every (architecture x input shape): the PyTorch
counterpart of ``repro/launch/specs.py``.

:func:`input_specs` builds stand-ins for every input of a step -- batches,
parameters, optimizer state, decode caches -- as tensors on the ``meta``
device (the counterpart of ``jax.eval_shape``): shapes and dtypes, no
storage.  bf16 by default, as in the reference.

The four input shapes:

  train_4k      seq 4,096    global_batch 256   (training)
  prefill_32k   seq 32,768   global_batch 32    (inference prefill)
  decode_32k    seq 32,768   global_batch 128   (one-token decode w/ cache)
  long_500k     seq 524,288  global_batch 1     (long-context decode;
                                                 sub-quadratic archs only)

For embedding inputs the batch carries embeddings and M-RoPE positions;
for an encoder-decoder it carries decoder tokens and the stub frontend's
frame embeddings.  The port's decode state keeps its step counters
(``idx``, ``pos``) as Python ints on the host, where the reference keeps
int32 scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ModelConfig
from ..models.model import init_decode_state, init_params

META = torch.device("meta")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention architecture: long_500k requires "
                       "sub-quadratic decode")
    return True, ""


def _s(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: InputShape,
                    dtype=torch.bfloat16) -> dict:
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch: dict = {}
    if cfg.input_kind == "embeds":
        batch["embeds"] = _s((b, s, cfg.d_model), dtype)
        batch["positions3"] = _s((3, b, s), torch.int32)
    elif cfg.input_kind == "audio":
        batch["tokens"] = _s((b, s), torch.int32)
        if shape.kind != "decode":
            batch["audio_embeds"] = _s((b, cfg.encdec.n_frames, cfg.d_model),
                                       dtype)
    else:
        batch["tokens"] = _s((b, s), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _s((b, s), torch.int32)
        batch["loss_mask"] = _s((b, s), torch.float32)
    return batch


def param_structs(cfg: ModelConfig, dtype=torch.bfloat16):
    return init_params(cfg, device=META, dtype=dtype,
                       generator=torch.Generator().manual_seed(0))


def opt_structs(params_struct):
    from ..optim.adamw import init_opt_state
    return init_opt_state(params_struct)


def decode_state_structs(cfg: ModelConfig, shape: InputShape,
                         dtype=torch.bfloat16):
    enc_out = None
    if cfg.encdec:
        enc_out = _s((shape.global_batch, cfg.encdec.n_frames, cfg.d_model),
                     dtype)
    return init_decode_state(cfg, shape.global_batch, shape.seq_len, dtype,
                             device=META, enc_out=enc_out)


def input_specs(cfg: ModelConfig, shape_name, dtype=torch.bfloat16):
    """-> (kind, {"batch", "params"[, "opt_state"][, "state"]}), every
    tensor on the meta device.  ``shape_name`` names one of
    :data:`INPUT_SHAPES`, or is an :class:`InputShape` of its own."""
    shape = (shape_name if isinstance(shape_name, InputShape)
             else INPUT_SHAPES[shape_name])
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name}: {why}")
    out = {"batch": batch_specs_for(cfg, shape, dtype),
           "params": param_structs(cfg, dtype)}
    if shape.kind == "train":
        out["opt_state"] = opt_structs(out["params"])
    if shape.kind == "decode":
        out["state"] = decode_state_structs(cfg, shape, dtype)
    return shape.kind, out
