"""Port parity: ``repro_torch.core.quantization`` against the JAX
reference ``repro.core.quantization``.  Codes, metadata and perms must be
bit-equal: both round half to even and divide in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jqz
from repro_torch.core import quantization as tqz


def _np(a) -> np.ndarray:
    """A JAX array as numpy, uint32 as its int32 bit view (the port's)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("k,n", [(64, 24), (256, 40)])
def test_pack_unpack_round_trip_int32_views(k, n):
    q = np.random.default_rng(k).integers(0, 16, (k, n)).astype(np.int32)
    packed = tqz.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int32 and packed.shape == (k // 8, n)
    assert (packed < 0).any()      # words with the top nibble >= 8
    np.testing.assert_array_equal(packed.numpy(),
                                  _np(jqz.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tqz.unpack_int4(packed).numpy(), q)


@pytest.mark.parametrize("k,n,gs", [(256, 48, 32), (256, 48, 64),
                                    (608, 40, 76)])
def test_quantize_bit_equal_to_jax(k, n, gs):
    rng = np.random.default_rng(k + gs)
    w = rng.standard_normal((k, n)).astype(np.float32)
    proc = rng.permutation(k).astype(np.int32)
    ref = jqz.quantize(jnp.asarray(w), gs, proc_order=jnp.asarray(proc))
    got = tqz.quantize(torch.from_numpy(w), gs,
                       proc_order=torch.from_numpy(proc))
    for layout in ("naive", "ordered"):
        a, b = getattr(got, layout), getattr(ref, layout)
        assert (a.group_size, a.kind) == (b.group_size, b.kind)
        for field in ("qweight", "scales", "zeros"):
            np.testing.assert_array_equal(getattr(a, field).numpy(),
                                          _np(getattr(b, field)),
                                          err_msg=f"{layout}.{field}")
    np.testing.assert_array_equal(got.naive.g_idx.numpy(),
                                  _np(ref.naive.g_idx))
    np.testing.assert_array_equal(got.perm.numpy(), _np(ref.perm))
    np.testing.assert_array_equal(got.g_idx.numpy(), _np(ref.g_idx))

    for layout in ("naive", "ordered"):
        np.testing.assert_array_equal(
            tqz.dequantize(getattr(got, layout)).numpy(),
            _np(jqz.dequantize(getattr(ref, layout))))
    p = rng.permutation(n).astype(np.int32)
    pa = tqz.permute_columns(got.ordered, torch.from_numpy(p))
    pb = jqz.permute_columns(ref.ordered, jnp.asarray(p))
    for field in ("qweight", "scales", "zeros"):
        np.testing.assert_array_equal(getattr(pa, field).numpy(),
                                      _np(getattr(pb, field)))


def test_choose_group_size_matches_jax():
    for k, pref in ((608, 128), (9728 // 16, 128), (2560, 128), (96, 64)):
        assert tqz.choose_group_size(k, pref) == jqz.choose_group_size(k, pref)
    assert tqz.choose_group_size(9728 // 16, 128) == 76


def test_quantize_from_generator_is_seeded():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (128, 16)).astype(np.float32))

    def perm(seed):
        return tqz.quantize(w, 32, generator=torch.Generator().manual_seed(
            seed)).perm

    assert torch.equal(perm(3), perm(3))
    assert not torch.equal(perm(3), perm(4))
