"""GPTQ in the port (``core/quantization.py``: ``make_hessian``,
``cholesky_hinv_upper``, ``_gptq_codes``, ``quantize(use_gptq=True)``,
``quant_error``; ``core/reorder.py``: ``quantize_pair``/``plan_pair``
with Hessians; ``quant/gptq.py``) against the reference, on the CPU.

Inputs are made from a seed with numpy; K 512, N 96, group 128, a
Hessian from 256 rows unless named.  Tolerances:

* ``make_hessian`` within 1e-6 of max|H| (measured: equal);
* ``_gptq_codes`` bit-equal given the reference's factor (the row loop
  updates only the rows below ``i``; the reference's masked update
  leaves the others ``w - 0``);
* ``cholesky_hinv_upper`` within 1e-5 absolute (measured 6.8e-6 against
  a largest entry of 0.33): ``torch.linalg`` and ``jnp.linalg`` are not
  bit-equal;
* ``quantize(use_gptq=True)`` with the port's own factor: at most 0.5%
  of the codes differ (measured 0 to 0.29% over seeds 0-3, with and
  without act-order), each by at most 2, and the calibration output
  error within 1% of the reference's (measured within 0.21%);
* with the reference's Hessians and factors, ``quantize_pair`` and
  ``plan_pair`` give the reference's leaves bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import quantization as qz
from repro_torch.core import reorder
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.quant.gptq import quantize_model
from repro_torch.train import checkpoint

K, N, GS, ROWS = 512, 96, 128, 256
FACTOR_ATOL = 1e-5
CODE_SHARE, CODE_STEP, ERR_REL = 5e-3, 2, 1e-2


def _inputs(seed: int, k: int = K, n: int = N, rows: int = ROWS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal((rows, k)).astype(np.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _codes(ql) -> np.ndarray:
    return qz.unpack_int4(ql.qweight).numpy()


def test_make_hessian_matches_jax():
    from repro.core import quantization as jq

    _, x = _inputs(0)
    want = np.asarray(jq.make_hessian(x))
    got = qz.make_hessian(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    damped = qz.make_hessian(torch.from_numpy(x), damp=0.5).numpy()
    np.testing.assert_allclose(damped - got, 0.5 * np.eye(K), atol=1e-3)


def test_gptq_codes_bit_equal_given_the_references_factor():
    import jax.numpy as jnp
    from repro.core import quantization as jq

    w, x = _inputs(1)
    h = jq.make_hessian(x)
    u = jq.cholesky_hinv_upper(h)
    scales, zeros = jq._group_metadata(jnp.asarray(w).reshape(K // GS, GS, N))
    want = np.asarray(jq._gptq_codes(jnp.asarray(w), scales, zeros, GS, u))
    got = qz._gptq_codes(torch.from_numpy(w), _t(scales), _t(zeros), GS, _t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cholesky_factor_within_tolerance():
    from repro.core import quantization as jq

    _, x = _inputs(0)
    h = jq.make_hessian(x)
    want = np.asarray(jq.cholesky_hinv_upper(h))
    got = qz.cholesky_hinv_upper(_t(h)).numpy()
    assert np.abs(got - want).max() <= FACTOR_ATOL
    assert np.allclose(np.tril(got, -1), 0.0)
    # U^T U is the inverse of the damped Hessian
    hd = np.asarray(h) + (0.01 * np.mean(np.diag(h)) + 1e-8) * np.eye(K)
    np.testing.assert_allclose(got.T @ got @ hd, np.eye(K), atol=1e-3)


@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_gptq_quantize_with_its_own_factor(seed, act_order):
    import jax.numpy as jnp
    from repro.core import quantization as jq

    w, x = _inputs(seed)
    h = jq.make_hessian(x)
    ref = jq.quantize(jnp.asarray(w), GS, act_order=act_order, hessian=h,
                      use_gptq=True)
    got = qz.quantize(torch.from_numpy(w), GS, act_order=act_order,
                      hessian=_t(h), use_gptq=True)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(got.g_idx.numpy(), np.asarray(ref.g_idx))
    np.testing.assert_array_equal(got.naive.scales.numpy(),
                                  np.asarray(ref.naive.scales))
    a, b = _codes(got.naive), np.asarray(jq.unpack_int4(ref.naive.qweight))
    assert (a != b).mean() <= CODE_SHARE
    assert np.abs(a - b).max() <= CODE_STEP
    y = x @ w
    err_ref = np.mean((y - x @ np.asarray(jq.dequantize(ref.naive))) ** 2)
    err = np.mean((y - x @ qz.dequantize(got.naive).numpy()) ** 2)
    assert abs(err - err_ref) <= ERR_REL * err_ref


def _correlated(seed: int, k: int, skew: bool):
    """The reference's calibration setups (``tests/test_quantization.py``)
    made with numpy: correlated inputs, or channels of skewed scale."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, 32)).astype(np.float32)
    x = rng.standard_normal((512, k)).astype(np.float32)
    if skew:
        x = x * np.exp(np.linspace(0, 3, k)).astype(np.float32)
    else:
        mix = np.eye(k) + 0.4 * rng.standard_normal((k, k)) / k ** 0.5
        x = (x @ mix).astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(x)


def test_gptq_hessian_reduces_error():
    """GPTQ error feedback beats RTN on a correlated-input quadratic loss
    (the reference's ``test_gptq_hessian_reduces_error``)."""
    w, x = _correlated(4, 64, skew=False)
    h = qz.make_hessian(x)
    rtn = qz.quantize(w, 16, act_order=False, use_gptq=False)
    gptq = qz.quantize(w, 16, act_order=False, use_gptq=True, hessian=h)
    y = x @ w
    err_rtn = torch.mean(torch.square(y - x @ qz.dequantize(rtn.naive)))
    err_gptq = torch.mean(torch.square(y - x @ qz.dequantize(gptq.naive)))
    assert float(err_gptq) < float(err_rtn)


def test_actorder_with_hessian_importance_reduces_error():
    """Processing the important rows first (``diag(H)`` order) lowers the
    error further (the reference's act-order Hessian case)."""
    w, x = _correlated(6, 64, skew=True)
    h = qz.make_hessian(x)
    plain = qz.quantize(w, 16, act_order=False, use_gptq=True, hessian=h)
    ao = qz.quantize(w, 16, act_order=True, use_gptq=True, hessian=h)
    np.testing.assert_array_equal(
        ao.perm.numpy(), np.argsort(ao.g_idx.numpy(), kind="stable"))
    y = x @ w
    err_plain = torch.mean(torch.square(y - x @ qz.dequantize(plain.naive)))
    err_ao = torch.mean(torch.square(y - x @ qz.dequantize(ao.naive)))
    assert float(err_ao) < float(err_plain)


def test_order_precedence_is_the_references():
    """``proc_order`` beats ``importance``, which beats ``diag(H)``, which
    beats the generator; without act-order the identity."""
    import jax.numpy as jnp
    from repro.core import quantization as jq

    w, x = _inputs(2, k=256, n=16)
    rng = np.random.default_rng(9)
    imp = rng.random(256).astype(np.float32)
    order = rng.permutation(256).astype(np.int32)
    h = jq.make_hessian(x)
    gen = torch.Generator().manual_seed(0)
    for kw, jkw in (
            ({"proc_order": _t(order), "importance": _t(imp)},
             {"proc_order": jnp.asarray(order), "importance": imp}),
            ({"importance": _t(imp), "hessian": _t(h), "generator": gen},
             {"importance": imp, "hessian": h}),
            ({"hessian": _t(h), "generator": gen}, {"hessian": h})):
        got = qz.quantize(torch.from_numpy(w), 64, **kw)
        ref = jq.quantize(jnp.asarray(w), 64, **jkw)
        np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
        np.testing.assert_array_equal(_codes(got.ordered),
                                      np.asarray(jq.unpack_int4(
                                          ref.ordered.qweight)))
    plain = qz.quantize(torch.from_numpy(w), 64, act_order=False,
                        importance=_t(imp), generator=gen)
    np.testing.assert_array_equal(plain.perm.numpy(), np.arange(256))


def test_quant_error_matches_jax():
    import jax.numpy as jnp
    from repro.core import quantization as jq

    w, _ = _inputs(3, k=256, n=32)
    order = np.random.default_rng(1).permutation(256).astype(np.int32)
    ref = jq.quantize(jnp.asarray(w), 64, proc_order=jnp.asarray(order))
    got = qz.quantize(torch.from_numpy(w), 64, proc_order=_t(order))
    for kind in ("naive", "ordered"):
        want = float(jq.quant_error(getattr(ref, kind), jnp.asarray(w),
                                    ref.perm))
        have = float(qz.quant_error(getattr(got, kind),
                                    torch.from_numpy(w), got.perm))
        assert abs(have - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="perm"):
        qz.quant_error(got.ordered, torch.from_numpy(w))


def _reference_factor(monkeypatch):
    """Make the port's GPTQ use the reference's factor of each permuted
    Hessian it is given."""
    from repro.core import quantization as jq

    def factor(h, damp_frac=0.01):
        return _t(jq.cholesky_hinv_upper(h.numpy(), damp_frac))

    monkeypatch.setattr(qz, "cholesky_hinv_upper", factor)


def _pair_inputs(seed: int):
    rng = np.random.default_rng(seed)
    k1, n1, n2 = 128, 256, 64
    w = {name: rng.standard_normal(shape).astype(np.float32)
         for name, shape in (("w_up", (k1, n1)), ("w_gate", (k1, n1)),
                             ("w_down", (n1, n2)))}
    x = rng.standard_normal((256, k1)).astype(np.float32)
    hid = (x @ w["w_gate"]) * (x @ w["w_up"])
    return w, x, hid


@pytest.mark.parametrize("scheme", ["tp-aware", "exllama",
                                    "naive-actorder"])
def test_plan_pair_with_hessians_bit_equal(monkeypatch, scheme):
    """GPTQ pairs (gate in up's ``perm``, the reference's quirk) with the
    reference's Hessians and factors: every leaf of ``plan_pair`` and of
    ``quantize_pair``'s bundle is the reference's."""
    import jax.numpy as jnp
    from repro.core import reorder as jreorder
    from repro.core import quantization as jq
    from repro.train import checkpoint as jcheckpoint

    _reference_factor(monkeypatch)
    w, x, hid = _pair_inputs(5)
    h_up, h_down = jq.make_hessian(x), jq.make_hessian(hid)
    kw = dict(group_size_up=64, group_size_down=64, use_gptq=True)
    ref = jreorder.plan_pair(
        jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
        w_gate=jnp.asarray(w["w_gate"]), scheme=scheme, hessian_up=h_up,
        hessian_down=h_down, **kw)
    got = reorder.plan_pair(
        torch.from_numpy(w["w_up"]), torch.from_numpy(w["w_down"]),
        w_gate=torch.from_numpy(w["w_gate"]), scheme=scheme,
        hessian_up=_t(h_up), hessian_down=_t(h_down), **kw)
    want = {k: np.asarray(v)
            for k, v in jcheckpoint.flatten_keys(ref).items()}
    have = checkpoint.flatten_keys(got)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        arr = have[key].numpy()
        if leaf.dtype == np.uint32:
            arr = arr.view(np.uint32)
        np.testing.assert_array_equal(arr, leaf, err_msg=key)
    bundle = reorder.quantize_pair(
        torch.from_numpy(w["w_up"]), torch.from_numpy(w["w_down"]),
        w_gate=torch.from_numpy(w["w_gate"]), hessian_up=_t(h_up),
        hessian_down=_t(h_down), **kw)
    np.testing.assert_array_equal(
        bundle.gate.g_idx.numpy(),
        np.asarray(jreorder.quantize_pair(
            jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
            w_gate=jnp.asarray(w["w_gate"]), hessian_up=h_up,
            hessian_down=h_down, **kw).gate.g_idx))


def test_plan_pair_importance_and_calibration_error():
    """``importance_*`` orders the rows as the reference does, and a GPTQ
    pair's calibration output error is below the RTN pair's."""
    import jax.numpy as jnp
    from repro.core import reorder as jreorder

    w, x, hid = _pair_inputs(7)
    rng = np.random.default_rng(8)
    imp_up, imp_down = rng.random(128), rng.random(256)
    ref = jreorder.plan_pair(
        jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
        group_size_up=64, group_size_down=64,
        importance_up=jnp.asarray(imp_up),
        importance_down=jnp.asarray(imp_down))
    got = reorder.plan_pair(
        torch.from_numpy(w["w_up"]), torch.from_numpy(w["w_down"]),
        group_size_up=64, group_size_down=64,
        importance_up=torch.from_numpy(imp_up),
        importance_down=torch.from_numpy(imp_down))
    np.testing.assert_array_equal(got.p1_up.numpy(), np.asarray(ref.p1_up))
    np.testing.assert_array_equal(got.p2.numpy(), np.asarray(ref.p2))

    xt, tw = torch.from_numpy(x), {k: torch.from_numpy(v)
                                   for k, v in w.items()}
    y = (torch.nn.functional.silu(xt @ tw["w_gate"]) * (xt @ tw["w_up"])
         ) @ tw["w_down"]
    hid_t = torch.nn.functional.silu(xt @ tw["w_gate"]) * (xt @ tw["w_up"])
    errs = {}
    for gptq in (False, True):
        pp = reorder.plan_pair(
            tw["w_up"], tw["w_down"], w_gate=tw["w_gate"], group_size_up=64,
            group_size_down=64, use_gptq=gptq,
            hessian_up=qz.make_hessian(xt) if gptq else None,
            hessian_down=qz.make_hessian(hid_t) if gptq else None)
        out = pp.forward(xt, activation="silu")
        errs[gptq] = float(torch.mean(torch.square(out - y)))
    assert errs[True] < errs[False]


def test_quantize_model_is_compile_params():
    """``quant/gptq.quantize_model`` is the compiler's quantize and layout
    stages, overrides applied to the config (``Model.init``'s layers for
    the same generator)."""
    cfg = get_smoke_config("qwen3-4b")
    raw = build_model(cfg).init_raw(0, device="cpu")
    got = quantize_model(cfg, raw, generator=compiler.plan_generator(0))
    want = build_model(cfg).init(0, device="cpu")
    fa, fb = checkpoint.flatten_keys(got), checkpoint.flatten_keys(want)
    assert list(fa) == list(fb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    naive = quantize_model(cfg, raw, scheme="naive-actorder",
                           group_size=32)
    pp = naive["layers"][0]["mlp"]
    assert pp.scheme == "naive-actorder" and pp.up.group_size == 32
