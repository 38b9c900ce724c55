"""Global kernel dispatch policy of the port.

* ``"auto"`` (the default): CUDA tensors of an eligible shape go to the
  Hopper kernels; CPU tensors take the plain versions.
* ``"cuda"``: the kernels, and a CPU tensor raises.
* ``"ref"``: the plain versions everywhere (tests and yardsticks).

The decision for attention is memoized per distinct (q, kv) shape pair and
device type, as ``repro.kernels.policy.select_attention_impl_per_class``
memoizes it per shard-shape pair; :func:`set_policy` clears the memo.
"""

from __future__ import annotations

import torch

from .flash_attention import HEAD_DIMS

VALID_POLICIES = ("auto", "cuda", "ref")

_POLICY = "auto"

#: (q_shape, kv_shape, device type) -> "cuda" | "ref"
_impl_cache: dict[tuple, str] = {}


def set_policy(policy: str) -> None:
    if policy not in VALID_POLICIES:
        raise ValueError(
            f"unknown kernel policy {policy!r}; valid policies: "
            f"{', '.join(VALID_POLICIES)}")
    global _POLICY
    _POLICY = policy
    _impl_cache.clear()


def get_policy() -> str:
    return _POLICY


def use_kernels(device) -> bool:
    """Whether tensors on ``device`` go to the kernels under the policy.
    Raises under ``"cuda"`` for a tensor that is not on a CUDA device."""
    device = torch.device(device)
    if _POLICY == "ref":
        return False
    if device.type == "cuda":
        return True
    if _POLICY == "cuda":
        raise RuntimeError(
            f"kernel policy 'cuda' needs CUDA tensors, got {device}")
    return False


def attention_eligible(q_shape, kv_shape) -> bool:
    """Whether the Hopper flash-attention kernel takes these shapes:
    ``q (B, H, Sq, D)``, ``k/v (B, K, Sk, D)`` with an integral GQA ratio
    ``H % K == 0``, equal head dims, ``D`` 64 or 128, and ``Sq, Sk >= 1``.
    The kernel masks its ragged tiles, so no multiple of the tile is
    needed (the JAX kernel needs multiples of 128)."""
    if len(q_shape) != 4 or len(kv_shape) != 4:
        return False
    b, h, sq, d = q_shape
    kb, kh, sk, kd = kv_shape
    return (b == kb and kh >= 1 and h % kh == 0 and d == kd
            and d in HEAD_DIMS and sq >= 1 and sk >= 1)


def select_attention_impl(q_shape, kv_shape, device) -> str:
    """``"cuda"`` or ``"ref"`` for one attention call, memoized per shape
    pair and device type."""
    dev = torch.device(device).type
    key = (tuple(q_shape), tuple(kv_shape), dev)
    impl = _impl_cache.get(key)
    if impl is None:
        impl = _impl_cache[key] = (
            "cuda" if use_kernels(device)
            and attention_eligible(q_shape, kv_shape) else "ref")
    return impl
