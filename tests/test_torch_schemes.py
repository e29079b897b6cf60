"""Port parity: single-device pair forwards of all three schemes on a JAX
``plan_pair`` carried across through ``checkpoint.save`` ->
``repro_torch.interop``, at the tolerances of the reference's
``tests/test_kernels.py::test_kernel_matches_scheme_forward``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reorder
from repro.core.policy import ExecutionPolicy as JaxPolicy
from repro.train import checkpoint
from repro_torch import interop
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.reorder import PlannedPair


@pytest.mark.parametrize("scheme", ["naive-actorder", "exllama", "tp-aware"])
@pytest.mark.parametrize("backend", ["torch", "ref"])
def test_pair_forward_matches_jax(scheme, backend, tmp_path):
    rng = np.random.default_rng(12)
    w_up, w_gate = (rng.standard_normal((128, 608)).astype(np.float32)
                    for _ in range(2))
    w_down = rng.standard_normal((608, 128)).astype(np.float32)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    pp = reorder.plan_pair(jnp.asarray(w_up), jnp.asarray(w_down),
                           w_gate=jnp.asarray(w_gate), scheme=scheme,
                           group_size_up=32, group_size_down=76,
                           rng=jax.random.PRNGKey(12))
    ref = np.asarray(pp.forward(x, JaxPolicy(backend="jnp"),
                                activation="silu"))

    path = checkpoint.save(str(tmp_path / "pair.npz"), {"mlp": pp})
    port = interop.load_tree(path, device="cpu")["mlp"]
    assert isinstance(port, PlannedPair) and port.scheme == scheme
    y = port.forward(torch.from_numpy(x), ExecutionPolicy(
        scheme=scheme, backend=backend), activation="silu")
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-3)


def test_policy_auto_and_unported_options():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ExecutionPolicy.auto("tp-aware", device=cuda).backend == "cuda"
    assert ExecutionPolicy.auto("tp-aware", device=cpu).backend == "torch"
    assert ExecutionPolicy.auto("naive-actorder",
                                device=cuda).backend == "torch"
    pol = ExecutionPolicy(collective="quant-int8:64:fused", mesh="dp1xtp2")
    assert pol.collective.shorthand() == "quant-int8:64:fused"
    assert pol.mesh.tp == 2
    assert ExecutionPolicy(kv="paged:16").kv.shorthand() == "paged:16"
    # the options an earlier slice refused are ported: the :overlap ring
    # and dp > 1 grids; a grid whose ep does not divide dp still raises
    pol = ExecutionPolicy(collective="quant-int8:overlap", mesh="dp2xtp2")
    assert pol.collective.overlap and pol.collective.name == "quant-int8"
    assert (pol.mesh.dp, pol.mesh.tp) == (2, 2)
    with pytest.raises(ValueError, match="must divide"):
        ExecutionPolicy(mesh="dp2xtp2xep3")
