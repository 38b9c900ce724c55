"""Device choice for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``"cpu"``.
With no GPU and no request for the CPU it raises; it never moves to the CPU
on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device needs a visible GPU; choosing
    one also turns TF32 off, so fp32 products are full fp32 as in the
    reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"('meta' builds shapes without storage)")
    return dev
