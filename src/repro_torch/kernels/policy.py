"""Global kernel dispatch policy of the port.

* ``"auto"`` (the default): CUDA tensors go to the Hopper kernels; CPU
  tensors take the plain versions.  A CUDA call that the model sends to a
  kernel (under the JAX package's gate) and that the kernel cannot take
  raises: nothing goes to a plain version on the card without being asked.
* ``"cuda"``: the kernels, and a CPU tensor raises.
* ``"ref"``: the plain versions everywhere (tests and yardsticks).

The decision for attention is memoized per distinct (q, kv) shape pair and
device type, as ``repro.kernels.policy.select_attention_impl_per_class``
memoizes it per shard-shape pair; :func:`set_policy` clears the memo.

The graph IR's ``attention`` op asks :func:`select_attention_impl` once
per specialization class, with the class's device-local shapes, as the JAX
package's ``select_attention_impl_per_class`` does (memoized, part of the
class partition).  B1 decides by its own rule, :func:`attention_eligible`:
it masks ragged tiles, so it takes shapes that the Pallas kernel's tiling
rule refuses, and a CUDA class it cannot take raises.
"""

from __future__ import annotations

import torch

from . import rglru_scan, ssd_scan
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


def _select(device, eligible: bool, what: str) -> str:
    """``"cuda"`` where the policy sends ``device`` to the kernels and the
    kernel takes the call, ``"ref"`` where the policy sends it to the plain
    versions; raises where the policy sends it to a kernel that cannot
    take it."""
    if not use_kernels(device):
        return "ref"
    if not eligible:
        raise ValueError(
            f"{what}: the kernel does not take this call and the policy "
            f"{_POLICY!r} sends {torch.device(device)} tensors to the "
            f"kernels; set_policy('ref') runs the plain versions")
    return "cuda"


def attention_eligible(q_shape, kv_shape) -> bool:
    """Whether the Hopper flash-attention kernel takes these shapes:
    ``q (B, H, Sq, D)``, ``k/v (B, K, Sk, D)`` with an integral GQA ratio
    ``H % K == 0``, equal head dims, ``D`` in 64, 128 or 256, and
    ``Sq, Sk >= 1``.  The kernel masks its ragged tiles, so no multiple of
    the tile is needed (the JAX kernel needs multiples of 128)."""
    if len(q_shape) != 4 or len(kv_shape) != 4:
        return False
    b, h, sq, d = q_shape
    kb, kh, sk, kd = kv_shape
    return (b == kb and kh >= 1 and h % kh == 0 and d == kd
            and d in HEAD_DIMS and sq >= 1 and sk >= 1)


def select_attention_impl(q_shape, kv_shape, device) -> str:
    """``"cuda"`` or ``"ref"`` for one attention call, memoized per shape
    pair and device type; raises for a shape the kernel cannot take on a
    device the policy sends to the kernels."""
    dev = torch.device(device).type
    key = (tuple(q_shape), tuple(kv_shape), dev)
    impl = _impl_cache.get(key)
    if impl is None:
        impl = _impl_cache[key] = _select(
            device, attention_eligible(q_shape, kv_shape),
            f"flash attention, q {tuple(q_shape)}, kv {tuple(kv_shape)}")
    return impl


def select_ssd_impl(x_shape, n: int, chunk: int, device) -> str:
    """``"cuda"`` or ``"ref"`` for one SSD scan; raises for a shape the
    kernel cannot take on a device the policy sends to the kernels."""
    return _select(device, ssd_scan.eligible(x_shape, n, chunk),
                   f"SSD scan, x {tuple(x_shape)}, d_state {n}, chunk "
                   f"{chunk}")


def select_rglru_impl(x_shape, device) -> str:
    """``"cuda"`` or ``"ref"`` for one RG-LRU scan; raises for a shape the
    kernel cannot take on a device the policy sends to the kernels."""
    return _select(device, rglru_scan.eligible(x_shape),
                   f"RG-LRU scan, x {tuple(x_shape)}")
