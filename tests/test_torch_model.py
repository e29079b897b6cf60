"""Port parity on the qwen3-4b smoke model: JAX params carried across
through ``checkpoint.save`` -> ``repro_torch.interop``, then the port's
decode, forward and engine against the JAX reference's.

Logit tolerance: 5e-3 of max|logits|.  Both frameworks carry activations
between layers in bf16 (``cfg.dtype``); a last-bit float32 difference in
a GEMM sum (the two sum in different orders) can move an activation by
one bf16 ulp (2^-8 relative), which then propagates.  Measured on this
model: 8.6e-4.  Decode is held against decode and forward against forward,
never decode against forward (the reference's own two paths differ by up
to 2.2% on the granite smoke model)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import REPLICATED
from repro.models.registry import build_model as jax_build_model
from repro.runtime.serve import make_engine as jax_make_engine
from repro.train import checkpoint
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.core.reorder import PlannedPair
from repro_torch.models.registry import build_model
from repro_torch.runtime.serve import Engine

REL_TOL = 5e-3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX engine, port engine) over the same params."""
    jeng = jax_make_engine(jax_smoke_config("qwen3-4b"),
                           jax.random.PRNGKey(0), max_seq=24)
    path = checkpoint.save(str(tmp_path_factory.mktemp("ckpt") / "p.npz"),
                           jeng.params)
    model = build_model(get_smoke_config("qwen3-4b"))
    teng = Engine(model=model, params=interop.load_params(path, device=CPU),
                  device=CPU, max_seq=24)
    return jeng, teng


def _leaf(tree, path):
    """Port leaf at a JAX checkpoint key path; JAX's stacked layer leaves
    are compared against the port's per-layer list, re-stacked."""
    if path[0] == "layers":
        return torch.stack([_leaf(layer, path[1:]) for layer in tree["layers"]])
    node = tree
    for p in path:
        node = node[p] if isinstance(node, dict) else getattr(node, p)
    return node


def test_config_matches_jax():
    import dataclasses

    a = dataclasses.asdict(get_smoke_config("qwen3-4b"))
    b = dataclasses.asdict(jax_smoke_config("qwen3-4b"))
    assert a == b


def test_carried_leaves_bit_equal(carried):
    jeng, teng = carried
    flat = checkpoint.flatten_keys(jeng.params)
    assert len(teng.params["layers"]) == 2
    mlp = teng.params["layers"][0]["mlp"]
    assert isinstance(mlp, PlannedPair) and isinstance(mlp.up,
                                                       QuantizedLinear)
    assert (mlp.scheme, mlp.up.kind, mlp.down.group_size) == \
        ("tp-aware", "ordered", 32)
    for key, leaf in flat.items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        got = _leaf(teng.params, key.split("||")).numpy()
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


def test_decode_steps_match_jax(carried):
    jeng, teng = carried
    b, steps = 3, 10
    toks = np.random.default_rng(1).integers(
        0, teng.model.cfg.vocab_size, (b, steps)).astype(np.int32)
    jcache = jeng.init_cache(b)
    tcache = teng.init_cache(b)
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        ref, jcache = jeng.model.decode_step(
            jeng.params, jcache, jnp.asarray(toks[:, t]), jnp.asarray(pos),
            jeng.ctx)
        got, tcache = teng.decode(tcache, torch.from_numpy(toks[:, t]).long(),
                                  torch.from_numpy(pos).long())
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= REL_TOL * np.abs(ref).max(), (t, err)


def test_forward_matches_jax(carried):
    jeng, teng = carried
    toks = np.random.default_rng(2).integers(
        0, teng.model.cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jeng.model.forward(jeng.params,
                                        {"tokens": jnp.asarray(toks)},
                                        REPLICATED))
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()


def test_engine_greedy_ids_match_jax(carried):
    jeng, teng = carried
    rng = np.random.default_rng(3)
    toks = rng.integers(0, teng.model.cfg.vocab_size, (4, 8)).astype(np.int32)
    plen = np.array([8, 5, 7, 6], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(toks)},
                                   jnp.asarray(plen), max_new_tokens=8))
    got = teng.generate(None, torch.from_numpy(toks).long(),
                        torch.from_numpy(plen), max_new_tokens=8).numpy()
    if not np.array_equal(got, ref):
        row, step = np.argwhere(got != ref)[0]
        # re-run the reference up to the divergent step for its margin
        lg = _jax_logits_at(jeng, toks, plen, ref, step)[row]
        top2 = np.sort(lg)[-2:]
        pytest.fail(f"greedy ids diverge at row {row} step {step}: port "
                    f"{got[row, step]} vs jax {ref[row, step]}, reference "
                    f"top-2 margin {top2[1] - top2[0]:.3g}")


def _jax_logits_at(jeng, toks, plen, ids, step):
    """The JAX engine's logits that chose token ``step`` of ``ids``."""
    cache = jeng.init_cache(toks.shape[0])
    logits, cache = jeng.prefill({"tokens": jnp.asarray(toks)}, cache,
                                 jnp.asarray(plen))
    pos = int(plen.max())
    for i in range(step):
        logits, cache = jeng._decode(jeng.params, cache,
                                     jnp.asarray(ids[:, i]), pos + i)
    return np.asarray(logits)


def test_policy_of_carried_engine_is_plain_torch(carried):
    _, teng = carried
    assert teng.policy == ExecutionPolicy(scheme="tp-aware", backend="torch",
                                          kv="dense")


def test_raw_params_forward_matches_jax(tmp_path):
    """Unquantized MLPs (``quant.mode`` "none"): the dense ``mlp_forward``
    path on JAX's raw params carried across."""
    cfg = jax_smoke_config("qwen3-4b").with_quant(mode="none")
    jmodel = jax_build_model(cfg)
    raw = jmodel.init(jax.random.PRNGKey(4))
    path = checkpoint.save(str(tmp_path / "raw.npz"), raw)
    model = build_model(get_smoke_config("qwen3-4b").with_quant(mode="none"))
    params = interop.load_params(path, device=CPU)
    assert set(params["layers"][0]["mlp"]) == {"w_up", "w_gate", "w_down"}
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ref = np.asarray(jmodel.forward(raw, {"tokens": jnp.asarray(toks)},
                                    REPLICATED))
    got = model.forward(params, {"tokens": torch.from_numpy(toks).long()},
                        ExecutionPolicy()).numpy()
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()


def test_load_without_card_names_it(tmp_path, monkeypatch):
    """Without ``device="cpu"`` the readers want the card, and raise
    naming it when there is none."""
    path = checkpoint.save(str(tmp_path / "p.npz"),
                           {"w": np.ones((2, 3), np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (interop.load_params, interop.load_tree):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            load(path)
    assert interop.load_tree(path, device="cpu")["w"].device == CPU
