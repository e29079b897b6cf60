"""Port parity on the qwen3-4b smoke model: JAX params carried across
through ``checkpoint.save`` -> ``repro_torch.interop``, then the port's
decode, forward and engine against the JAX reference's, for the tp-aware
plan and the naive act-order one (rows gather their groups through
``g_idx``), and the forward's flash attention against the reference's
``attn_backend="flash"``.

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
from repro.models.common import REPLICATED, ParallelContext
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


def _carry(tmp_path_factory, scheme):
    """(JAX engine, port engine) over the same params of a ``scheme``
    plan."""
    jeng = jax_make_engine(
        jax_smoke_config("qwen3-4b").with_quant(scheme=scheme),
        jax.random.PRNGKey(0), max_seq=24)
    path = checkpoint.save(str(tmp_path_factory.mktemp("ckpt") / "p.npz"),
                           jeng.params)
    model = build_model(get_smoke_config("qwen3-4b").with_quant(
        scheme=scheme))
    teng = Engine(model=model, params=interop.load_params(path, device=CPU),
                  device=CPU, max_seq=24)
    return jeng, teng


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    return _carry(tmp_path_factory, "tp-aware")


@pytest.fixture(scope="module")
def carried_naive(tmp_path_factory):
    return _carry(tmp_path_factory, "naive-actorder")


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


def _assert_leaves_bit_equal(jeng, teng):
    flat = checkpoint.flatten_keys(jeng.params)
    for key, leaf in flat.items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        got = _leaf(teng.params, key.split("||")).numpy()
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


def test_carried_leaves_bit_equal(carried):
    jeng, teng = carried
    assert len(teng.params["layers"]) == 2
    mlp = teng.params["layers"][0]["mlp"]
    assert isinstance(mlp, PlannedPair) and isinstance(mlp.up,
                                                       QuantizedLinear)
    assert (mlp.scheme, mlp.up.kind, mlp.down.group_size) == \
        ("tp-aware", "ordered", 32)
    _assert_leaves_bit_equal(jeng, teng)


def test_carried_naive_leaves_bit_equal(carried_naive):
    """The naive act-order plan, ``g_idx`` leaves included."""
    jeng, teng = carried_naive
    mlp = teng.params["layers"][0]["mlp"]
    assert (mlp.scheme, mlp.up.kind, mlp.down.kind) == \
        ("naive-actorder", "naive", "naive")
    assert mlp.up.g_idx.dtype == torch.int32 and mlp.p1_up is None
    keys = checkpoint.flatten_keys(jeng.params)
    assert any(key.endswith("g_idx") for key in keys)
    _assert_leaves_bit_equal(jeng, teng)


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


def test_per_slot_decode_matches_jax_jitted_step(carried):
    """The port's step on unequal per-slot positions (the path the CUDA
    graph captures) against the reference's jitted ``Engine._decode``."""
    jeng, teng = carried
    offsets = np.array([0, 3, 7], np.int32)
    steps = 10
    toks = np.random.default_rng(7).integers(
        0, teng.model.cfg.vocab_size, (len(offsets), steps)).astype(np.int32)
    jcache = jeng.init_cache(len(offsets))
    tcache = teng.init_cache(len(offsets))
    for t in range(steps):
        pos = offsets + t
        ref, jcache = jeng._decode(jeng.params, jcache,
                                   jnp.asarray(toks[:, t]), jnp.asarray(pos))
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
    _assert_greedy_ids_match(*carried)


def test_engine_greedy_ids_match_jax_naive(carried_naive):
    """The naive act-order plan: every MLP GEMM gathers through g_idx."""
    _assert_greedy_ids_match(*carried_naive)


def _assert_greedy_ids_match(jeng, teng):
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


def test_flash_forward_matches_jax_flash(carried):
    """The forward with ``attn_backend="flash"`` (the kernel's plain
    version on the CPU) against the JAX forward under
    ``ParallelContext(attn_backend="flash")`` (the Pallas kernel in
    interpret mode)."""
    jeng, teng = carried
    toks = np.random.default_rng(4).integers(
        0, teng.model.cfg.vocab_size, (2, 16)).astype(np.int32)
    ref = np.asarray(jeng.model.forward(
        jeng.params, {"tokens": jnp.asarray(toks)},
        ParallelContext(attn_backend="flash")))
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy, attn_backend="flash").numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL_TOL * np.abs(ref).max()
    with pytest.raises(ValueError, match="unknown attn_backend"):
        teng.model.forward(teng.params,
                           {"tokens": torch.from_numpy(toks).long()},
                           teng.policy, attn_backend="pallas")


@pytest.mark.parametrize("attn_backend", ["xla", "flash"])
def test_engine_prefill_logits_is_the_forward(carried, attn_backend):
    """``Engine.prefill_logits`` is ``Model.forward`` under the engine's
    plan and attention backend."""
    _, teng = carried
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, teng.model.cfg.vocab_size, (2, 12))).long()
    eng = Engine(model=teng.model, params=teng.params, device=CPU,
                 max_seq=24, attn_backend=attn_backend)
    want = teng.model.forward(teng.params, {"tokens": toks}, teng.policy,
                              attn_backend=attn_backend)
    assert torch.equal(eng.prefill_logits(toks), want)


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
