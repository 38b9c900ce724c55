"""The bf16 prefill: the port's ``build_prefill_step`` on bf16 parameters
against the JAX package's, for Qwen2-1.5B, Mamba2-370M and
RecurrentGemma-9B at ``reduced()`` size.

The JAX parameters are made by ``init_params(PRNGKey(0), cfg,
jnp.bfloat16)`` and carried over by ``convert.params_from_jax(...,
dtype=torch.bfloat16)``; the tokens are drawn with numpy from a seed and
handed to both.  On the CPU the port's wrappers run their plain versions
and launch nothing.

Tolerance: the last position's logits within ``PREFILL_NORMWISE`` = 2e-2,
normwise relative (||port - jax|| / ||jax||).  Both sides keep the same
leaves in fp32 and widen to fp32 in the same places (softmax, norms, the
scans' carries), but they round to bf16 at other places: XLA fuses chains
of elementwise ops and keeps their intermediates in fp32, where PyTorch
rounds every op's output to bf16, and the two frameworks' matrix products
sum in other orders.  Each such rounding is 2^-9 relative; over the two or
three reduced layers they add up to about 1e-2 of the logits' norm
(0.65e-2 to 1.1e-2 for the three archs, a little less than the JAX
package's own bf16 prefill differs from its fp32 one).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import policy  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.tree import paths  # noqa: E402

ARCHS = ("qwen2-1.5b", "mamba2-370m", "recurrentgemma-9b")
PREFILL_NORMWISE = 2e-2
BATCH, PROMPT = 2, 128


@pytest.fixture(autouse=True)
def _counts():
    policy.set_policy("auto")
    for mod in serve.KERNELS.values():
        mod.launches = 0
    yield
    policy.set_policy("auto")


def _cfgs(arch):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _jax_tree(jcfg, dtype):
    return jax.tree.map(np.asarray,
                        jm.init_params(jax.random.PRNGKey(0), jcfg, dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_keep_the_fp32_leaves(arch):
    """Under a bf16 model the JAX package keeps ``FP32_LEAVES`` in fp32 and
    every other leaf in bf16; the port's carried-over tree has the same
    types, leaf for leaf, and the same values."""
    jcfg, tcfg = _cfgs(arch)
    jtree = _jax_tree(jcfg, jnp.bfloat16)
    tparams = convert.params_from_jax(jtree, tcfg, device="cpu",
                                      dtype=torch.bfloat16)
    jleaves = dict(paths(jtree))
    kept = set()
    for path, leaf in paths(tparams):
        fp32 = path[-1] in convert.FP32_LEAVES
        kept |= {path[-1]} if fp32 else set()
        assert leaf.dtype == (torch.float32 if fp32 else torch.bfloat16), path
        assert jleaves[path].dtype == (np.float32 if fp32 else jnp.bfloat16)
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      jleaves[path].astype(np.float32))
    assert kept == {"qwen2-1.5b": set(), "mamba2-370m": {"A_log", "dt_bias"},
                    "recurrentgemma-9b": {"lam"}}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_cast_params_follows_the_jax_rule(arch):
    """``cast_params`` on fp32 parameters gives what ``params_from_jax``
    gives in bf16 from the same JAX tree, leaf for leaf."""
    jcfg, tcfg = _cfgs(arch)
    jtree = _jax_tree(jcfg, jnp.float32)
    cast = convert.cast_params(
        convert.params_from_jax(jtree, tcfg, device="cpu"), torch.bfloat16)
    want = dict(paths(convert.params_from_jax(jtree, tcfg, device="cpu",
                                              dtype=torch.bfloat16)))
    for path, leaf in paths(cast):
        assert leaf.dtype == want[path].dtype, path
        assert torch.equal(leaf, want[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jtree = _jax_tree(jcfg, jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, jtree)
    tparams = convert.params_from_jax(jtree, tcfg, device="cpu",
                                      dtype=torch.bfloat16)
    toks = np.random.default_rng(26).integers(0, tcfg.vocab,
                                              (BATCH, PROMPT))
    want = np.asarray(jsteps.build_prefill_step(jcfg)(
        jparams, {"tokens": jnp.asarray(toks)}), dtype=np.float64)
    got = tsteps.build_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (BATCH, tcfg.vocab) and got.dtype == torch.bfloat16
    got = got.double().numpy()
    assert np.isfinite(got).all()
    normwise = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert normwise <= PREFILL_NORMWISE, normwise
    assert serve.launch_counts() == {"flash": 0, "ssd": 0, "rglru": 0}
