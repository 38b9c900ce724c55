"""Differential testing layer: rank execution vs the simulator.

The counterpart of ``repro/runtime/diff.py``.  Every plan the ranks
execute can be checked **bit exactly** against the port's
``core.simulator.apply_plan``, the executable specification of the
paper's §4 semantics: ``reduction="exact"`` reproduces the simulator's
float64 fold in ``srcs`` order for arbitrary data; the ``"fast"``
``all_reduce`` path is checked with integer-valued shards (sums exact in
any order), via :func:`integer_decompose`.  Every rank calls each check
with the same arguments; each returns the same result on every rank.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.annotations import HSPMD
from repro_torch.core.comm_resolve import resolve
from repro_torch.core.plan import CommPlan
from repro_torch.core.simulator import (ShardedTensor, apply_plan, gather,
                                        scatter)
from repro_torch.core.topology import Topology

from .backend import compile_plan, execute_plan


def integer_decompose(value: np.ndarray, k: int,
                      rng: np.random.Generator) -> list[np.ndarray]:
    """Summand decomposition over small integers: float32 sums of these are
    exact in ANY association order, making ``all_reduce`` bit-comparable."""
    if k == 1:
        return [value]
    pieces = [rng.integers(-8, 9, size=value.shape).astype(value.dtype)
              for _ in range(k - 1)]
    pieces.append(value - sum(pieces))
    return pieces


def differential_check(value: np.ndarray, src: HSPMD, dst: HSPMD,
                       mesh=None, *, plan: CommPlan | None = None,
                       topology: Topology | None = None,
                       reduction: str = "exact",
                       rng: np.random.Generator | None = None,
                       decompose=None):
    """Resolve (src, dst), execute on the simulator AND across the ranks,
    assert per-device bit-exact agreement.  Returns the plan, the
    scattered source, the ranks' destination shards and the lowering's
    stats (this rank's traffic), so callers can assert which operator
    kinds were exercised and keep what moved."""
    shape = tuple(value.shape)
    if plan is None:
        plan = resolve(src, dst, shape, topology)
    st = scatter(value, src, rng=rng, decompose=decompose)
    sim = apply_plan(st, plan)
    compiled = compile_plan(plan, shape, mesh, reduction=reduction)
    real = compiled(st.parts)
    assert set(real) == set(sim.parts), (sorted(real), sorted(sim.parts))
    for dev, arr in sim.parts.items():
        np.testing.assert_array_equal(
            real[dev], arr,
            err_msg=f"dev {dev} differs from simulator "
                    f"(plan {plan.kind}, reduction={reduction})")
        assert real[dev].dtype == arr.dtype, (dev, real[dev].dtype)
    return plan, st, real, compiled.stats


def roundtrip_check(value: np.ndarray, src: HSPMD, dst: HSPMD,
                    mesh=None, *, topology: Topology | None = None,
                    reduction: str = "exact"):
    """src -> dst -> src across the ranks recovers the tensor: final shards
    equal the initial scatter exactly, and the gathered global value is
    unchanged.  Returns (source shards, midway shards, final shards)."""
    shape = tuple(value.shape)
    there = resolve(src, dst, shape, topology)
    back = resolve(dst, src, shape, topology)
    st = scatter(value, src)
    mid = execute_plan(there, st.parts, shape, mesh, reduction=reduction)
    out = execute_plan(back, mid, shape, mesh, reduction=reduction)
    for dev, arr in st.parts.items():
        np.testing.assert_array_equal(out[dev], arr,
                                      err_msg=f"dev {dev} round-trip drift")
    recon = gather(ShardedTensor(shape, src, out))
    np.testing.assert_allclose(recon, value, atol=1e-5)
    return st.parts, mid, out
