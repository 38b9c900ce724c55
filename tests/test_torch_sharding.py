"""The port's production sharding rules (``repro_torch/sharding/rules.py``)
against the JAX package's (``repro/sharding/rules.py``), leaf for leaf, on
every config, and the port's hints (``repro_torch/sharding/hints.py``).

The JAX rules read only a mesh's ``shape`` and ``axis_names``, so they get
a stand-in object of the mesh's shape: no 512-device JAX process is
needed.  The JAX trees come from its own ``launch/specs.py`` (eval_shape),
the port's from its meta-device specs.  The reference keeps its decode
step counters (``idx``, one per layer, and ``pos``) as int32 arrays; the
port keeps them as Python ints on the host, so its ``idx`` specs are
``P()`` where the reference's stacked counter gets ``P(None)``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.annotations import spmd  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import (LogicalMesh,  # noqa: E402
                                     make_production_mesh, make_smoke_mesh)
from repro_torch.sharding import hints, rules  # noqa: E402
from repro_torch.tree import paths  # noqa: E402

MESHES = {
    "16x16": make_production_mesh(),
    "2x16x16": make_production_mesh(multi_pod=True),
    # widths and batches that 3 and 6 do not divide: the drop to None
    "3x6": LogicalMesh(("data", "model"), (3, 6)),
}


class StandIn:
    """What the JAX rules read of a mesh."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.axis_names = tuple(mesh.axis_names)
        self.devices = np.arange(mesh.size).reshape(mesh.axis_sizes)


def _flat(tree, is_jax):
    """(path, spec as a tuple) of a spec tree, in the port's order."""
    if is_jax:
        from jax.sharding import PartitionSpec
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
        out = {}
        for kp, spec in leaves:
            key = tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in kp)
            out[key] = tuple(spec)
        return out
    return {p: tuple(s) for p, s in paths(tree, ())
            if isinstance(s, rules.P)} | _specs_at(tree)


def _specs_at(tree, prefix=()):
    out = {}
    if isinstance(tree, rules.P):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out |= _specs_at(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out |= _specs_at(v, prefix + (i,))
    return out


def _compare(jtree, ttree):
    j, t = _flat(jtree, True), _specs_at(ttree)
    assert set(j) == set(t), sorted(set(j) ^ set(t))[:6]
    for path in j:
        if path[-1] == "idx":
            assert t[path] == (), (path, t[path])
            continue
        assert t[path] == j[path], (path, t[path], j[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_rules(arch):
    """param_specs (train and serve), batch_specs of every applicable input
    shape and decode_state_specs, on 16x16, 2x16x16 and 3x6."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jparams, tparams = jspecs.param_structs(jcfg), tspecs.param_structs(tcfg)
    for name, mesh in MESHES.items():
        jm = StandIn(mesh)
        for mode in ("train", "serve"):
            _compare(jrules.param_specs(jparams, jcfg, jm, mode=mode),
                     rules.param_specs(tparams, tcfg, mesh, mode=mode))
        for sname, shape in tspecs.INPUT_SHAPES.items():
            if not tspecs.shape_applicable(tcfg, shape)[0]:
                continue
            jshape = jspecs.INPUT_SHAPES[sname]
            _compare(jrules.batch_specs(jspecs.batch_specs_for(jcfg, jshape),
                                        jm),
                     rules.batch_specs(tspecs.batch_specs_for(tcfg, shape),
                                       mesh))
            if shape.kind == "decode":
                jstate = jspecs.decode_state_structs(jcfg, jshape)
                tstate = tspecs.decode_state_structs(tcfg, shape)
                _compare(jrules.decode_state_specs(jstate, jcfg, jm),
                         rules.decode_state_specs(tstate, tcfg, mesh))
                assert rules.serve_mode_fits(tparams, tstate, mesh) == \
                    jrules.serve_mode_fits(jparams, jstate, jm)


@pytest.mark.parametrize("entries,axes", [
    ({0: 4, 1: 2}, ("data", "model")),
    ({1: 8}, ("model",)),
    ({-1: 2, 0: 4}, ("data", "model")),
])
def test_annot_spec_round_trip(entries, axes):
    """annot_to_spec and spec_to_annot as the JAX package's, and back."""
    from repro.core.annotations import spmd as jspmd
    annot = spmd(list(range(8)), entries)
    spec = rules.annot_to_spec(annot, axes)
    assert tuple(spec) == tuple(jrules.annot_to_spec(
        jspmd(list(range(8)), entries), axes))
    sizes = tuple(n for _, n in annot.dss[0].entries)
    mesh = LogicalMesh(axes, sizes)
    shape = (8, 16)
    back = rules.spec_to_annot(spec, mesh, shape)
    jback = jrules.spec_to_annot(jax.sharding.PartitionSpec(*spec),
                                 _JaxMeshLike(mesh), shape)
    assert back.dss[0].entries == jback.dss[0].entries
    assert tuple(back.devices) == tuple(jback.devices)
    if -1 not in entries:   # spec_to_annot puts a duplicate entry last
        assert tuple(rules.annot_to_spec(back, axes)) == tuple(spec)


class _JaxMeshLike(StandIn):
    """A stand-in whose devices carry ``.id``, as spec_to_annot reads."""

    def __init__(self, mesh):
        super().__init__(mesh)

        class Dev:
            def __init__(self, i):
                self.id = int(i)
        self.devices = np.vectorize(Dev, otypes=[object])(self.devices)


def test_to_placements_order():
    """A tuple entry shards one dim over several mesh dims, the first
    major, in the mesh's order; the other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    class DM:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    pl = rules.to_placements(rules.P(("pod", "data"), None, "model"), DM)
    assert pl == (Shard(0), Shard(0), Shard(2))
    DM.shape = (2, 1, 16)         # a mesh dim of one device shards nothing
    assert rules.to_placements(rules.P(("pod", "data"), None, "model"),
                               DM) == (Shard(0), Replicate(), Shard(2))
    DM.shape = (2, 16, 16)
    assert rules.to_placements(rules.P(None), DM) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        rules.to_placements(rules.P(("data", "pod")), DM)


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_sizes == (2, 16, 16)
    m = make_smoke_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert make_smoke_mesh(4, axes=("model",)).shape == {"model": 4}
    assert LogicalMesh(("a", "b"), (2, 3)).coords(4) == {"a": 1, "b": 1}


def test_hint_identity_on_plain_tensors():
    """No mesh, or a mesh without a DeviceMesh: the input itself."""
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert hints.hint(x, "data", "model") is x
    with hints.use_mesh(make_smoke_mesh()):
        assert hints.batch_axes() == ("data",)
        assert hints.hint(x, "data", "model") is x
        assert hints.hint_tokens(x) is x
        assert hints.gather_weights({"w": x})["w"] is x
        assert hints.pin_residual(x) is x
    assert hints.active_mesh() is None and hints.batch_axes() is None


def test_hint_pins_reference_spec_on_dtensor():
    """Under the dry run's fake 4x4 mesh a DTensor is redistributed to the
    spec the reference's fixed rule keeps: axes that exist and divide."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import production_mesh
    mesh = LogicalMesh(("data", "model"), (4, 4))
    with production_mesh(mesh) as (dm, _):
        x = DTensor.from_local(torch.empty(8, 6, 16), dm,
                               [Replicate(), Replicate()], run_check=False)
        assert x.shape == (8, 6, 16)
        y = hints.hint(x, ("data",), "model", "model")
        # dim 1 (6) does not divide by 4: dropped; dim 2 takes "model"
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (2, 6, 4)
        assert hints.hint(x, "pod") is x          # no such axis
    assert not torch.distributed.is_initialized()
