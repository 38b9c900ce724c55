"""The port's production dry run (``repro_torch/launch/dryrun.py``,
``specs.py``, ``hardware.py``, ``roofline.py``) on the CPU: a fake process
group and fake tensors, nothing allocated.

The JAX dry run's per-device argument bytes come from a child process
(``python -m repro.launch.dryrun``, which forces 512 host devices), as
``tests/test_dryrun.py`` runs it, so that the flag never reaches this
process.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hardware, roofline, specs
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSIGNED = dryrun.assigned_archs()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("arch", ASSIGNED[:4] + ["deepseek-v2-236b"])
def test_input_specs_allocate_nothing(arch):
    cfg = get_config(arch)
    for shape in specs.INPUT_SHAPES.values():
        if not specs.shape_applicable(cfg, shape)[0]:
            continue
        _, out = specs.input_specs(cfg, shape.name)
        for leaf in tree_leaves(out):
            if torch.is_tensor(leaf):
                assert leaf.device.type == "meta", leaf.device
        assert out["params"]["final_norm"]["w"].dtype == torch.bfloat16


def test_fake_world_torn_down_after_run_and_error():
    cfg = get_config("qwen2-1.5b").reduced()
    mesh = LogicalMesh(("data", "model"), (2, 2))
    shape = specs.InputShape("tiny", 32, 4, "prefill")
    r = dryrun.dryrun_one("qwen2-1.5b", "tiny", mesh=mesh, cfg=cfg,
                          shape=shape, verbose=False)
    assert r["bytes_per_device"]["peak"] > 0
    assert not dist.is_initialized()
    bad = dataclasses.replace(cfg, n_heads=3)       # d 256 is not 3 heads
    with pytest.raises(Exception):
        dryrun.dryrun_one("qwen2-1.5b", "tiny", mesh=mesh, cfg=bad,
                          shape=shape, verbose=False)
    assert not dist.is_initialized()


def test_argument_bytes_match_jax_dryrun(tmp_path):
    """qwen2-1.5b x decode_32k on 16x16: the port's per-device argument
    bytes against XLA's ``argument_size_in_bytes``.  They differ by the
    reference's int32 decode counters alone (``idx``, stacked per layer,
    and ``pos``: 4 x (layers + 1) bytes), which the port keeps on the host
    as Python ints."""
    out = tmp_path / "jax.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "qwen2-1.5b",
         "--shape", "decode_32k", "--json", str(out)],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    jargs = json.loads(out.read_text().splitlines()[-1])[
        "bytes_per_device"]["arguments"]
    r = dryrun.dryrun_one("qwen2-1.5b", "decode_32k", verbose=False)
    cfg = get_config("qwen2-1.5b")
    counters = 4 * (cfg.n_layers + 1)
    assert r["layout"] == "serve"
    assert r["bytes_per_device"]["arguments"] + counters == jargs


def test_flops_cover_the_unsharded_step():
    """Per-device matmul FLOPs x 4 on a (2, 2) mesh against the same step
    on one device (reduced Qwen2, training, 2 microbatches).  No product
    may go missing: at least the unsharded count.  Replicated work adds
    at most the attention of the heads that a shard picks twice and the
    the loss's (B, S, vocab / 2) head: bounded here by 10% of the step."""
    cfg = get_config("qwen2-1.5b").reduced()
    shape = specs.InputShape("tiny", 64, 8, "train")
    one = dryrun.dryrun_one("qwen2-1.5b", "tiny", cfg=cfg, shape=shape,
                            mesh=LogicalMesh(("data", "model"), (1, 1)),
                            num_microbatches=2, verbose=False)
    four = dryrun.dryrun_one("qwen2-1.5b", "tiny", cfg=cfg, shape=shape,
                             mesh=LogicalMesh(("data", "model"), (2, 2)),
                             num_microbatches=2, verbose=False)
    f1 = one["per_device"]["flops"]
    f4 = four["per_device"]["flops"] * 4
    assert f1 > 0 and f1 <= f4 <= 1.10 * f1, (f1, f4)
    assert four["per_device"]["collective_bytes"] > 0
    assert one["per_device"]["collective_bytes"] == 0


def test_gpu_constants_and_links():
    g = hardware.get_gpu("NVIDIA H100 80GB HBM3")
    assert g is hardware.get_gpu("h100-sxm")
    assert g.peak_flops["bfloat16"] == 989e12 and g.hbm_bw == 3.35e12
    with pytest.raises(KeyError, match="unknown GPU"):
        hardware.get_gpu("NVIDIA A100-SXM4-80GB")
    links = hardware.axis_links(LogicalMesh(("data", "model"), (16, 16)), g)
    assert links == {"data": ("network", 50e9), "model": ("network", 50e9)}
    links = hardware.axis_links(LogicalMesh(("data", "model"), (4, 8)), g)
    assert links["model"][0] == "nvlink" and links["data"][0] == "network"


def test_roofline_components_reduced():
    """The per-component roofline on a (2, 2) mesh: every component once,
    multiplied by its trip count."""
    cfg = get_config("deepseek-v2-236b").reduced()
    r = roofline.roofline("deepseek-v2-236b", "decode_32k", cfg=cfg,
                          mesh=LogicalMesh(("data", "model"), (2, 2)),
                          verbose=False)
    names = [c["name"] for c in r["components"]]
    assert names == ["layer:dense", "layer:moe", "embed_head"]
    assert [c["mult"] for c in r["components"]] == [1, 1, 1]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert not dist.is_initialized()


def test_cli_exits_zero_and_names_unknown_card():
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen2-1.5b", "--shape", "decode_32k"]
    proc = subprocess.run(cmd + ["--gpu", "h100-sxm"], capture_output=True,
                          text=True, env=_env(), timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "1/1 combinations OK" in proc.stdout
    proc = subprocess.run(cmd + ["--gpu", "a100"], capture_output=True,
                          text=True, env=_env(), timeout=120, cwd=ROOT)
    assert proc.returncode == 2 and "unknown GPU" in proc.stderr
