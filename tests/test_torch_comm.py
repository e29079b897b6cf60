"""Port parity of the collective plan (``repro_torch.comm`` and
``repro_torch.dist.topology``) against ``repro.comm`` and
``repro.dist.topology``, in one process: the ring quantizers bit for bit
(exact .5-step ties and all-zero blocks included), ``wire_params``,
``bytes_on_wire`` of every strategy at tp 1, 2, 4 and 8, the spec, plan
and mesh shorthands and the plan's glob resolution.  The rings
themselves run on gloo ranks in ``tests/test_torch_tp.py``."""

import numpy as np
import pytest
import torch

from repro.comm import dispatch as jcomm
from repro.comm import spec as jspec
from repro.comm.wire import wire_params as jwire_params
from repro.dist.topology import MeshPlan as JMeshPlan
from repro_torch.comm import dispatch as comm
from repro_torch.comm.spec import (CollectivePlan, CollectiveSpec,
                                   parse_collective)
from repro_torch.comm.wire import wire_params
from repro_torch.dist.topology import MeshPlan

SHORTHANDS = ["psum", "psum_scatter", "none", "cast", "cast:float16",
              "cast:bf16", "quant-int8", "quant-int8:64", "quant-int8:fused",
              "quant-int8:64:fused", "quant-int4", "quant-int4:12:fused"]
PLANS = ["per-layer:*.mlp=quant-int8:64,*=psum",
         "per-layer:attn*=cast:bfloat16,layers.mlp=quant-int4:fused,"
         "*=psum_scatter",
         "per-layer:mlp=none"]
PATHS = ["layers.mlp", "layers.attn.mlp", "attn.vo", "super.layers.mlp",
         "moe.experts", None]


def _blocks(bits: int, bs: int) -> np.ndarray:
    """(6, 4 * bs) float32 rows of random blocks, blocks whose values sit
    on exact .5 steps of their scale (ties), and all-zero blocks."""
    rng = np.random.default_rng(bits * 100 + bs)
    v = (rng.standard_normal((6, 4 * bs)) * 3).astype(np.float32)
    ties = (np.arange(bs) % 15 + 0.5).astype(np.float32)
    if bits == 8:
        # max|v| = 127 -> s = 1, every other value an odd half
        ties[0] = 127.0
        v[1, :bs] = ties
        v[1, bs:2 * bs] = -ties
    else:
        # vmax - vmin = 15 -> s = 1; -vmin = 7.5 is itself a tie for z
        v[1, :bs] = np.clip(ties - 7.0, -7.5, 7.5)
        v[1, 0], v[1, 1] = -7.5, 7.5
        v[1, bs:2 * bs] = np.clip(ties, 0, 15)
        v[1, bs] = 15.0
    v[2, :] = 0.0
    v[3, bs:2 * bs] = 0.0
    v[4] *= 1e-30                                   # tiny scales
    return v


@pytest.mark.parametrize("bs", [4, 12, 32, 128])
def test_int8_quantizer_bit_equal(bs):
    v = _blocks(8, bs)
    jq, js = jcomm._blockwise_quantize(v, bs)
    q, s = comm._blockwise_quantize(torch.from_numpy(v), bs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(
        comm._blockwise_dequantize(q, s, bs).numpy(),
        np.asarray(jcomm._blockwise_dequantize(jq, js, bs)))


@pytest.mark.parametrize("bs", [4, 12, 32])
def test_int4_quantizer_and_packing_bit_equal(bs):
    v = _blocks(4, bs)
    jq, js, jz = jcomm._blockwise_quantize_int4(v, bs)
    q, s, z = comm._blockwise_quantize_int4(torch.from_numpy(v), bs)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    jp = jcomm._pack4_last(jq)
    p = comm._pack4_last(q)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp).view(np.int32))
    assert p.shape == (6, 4 * bs // 8) and p.dtype == torch.int32
    np.testing.assert_array_equal(comm._unpack4_last(p).numpy(),
                                  np.asarray(jq))
    np.testing.assert_array_equal(
        comm._blockwise_dequantize_int4(q, s, z, bs).numpy(),
        np.asarray(jcomm._blockwise_dequantize_int4(jq, js, jz, bs)))


def test_quantizers_round_half_to_even():
    """Exact ties go to the even level, as ``jnp.round`` does."""
    v = torch.tensor([[127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 0.0]])
    q, _ = comm._blockwise_quantize(v, 8)
    assert q.tolist() == [[127, 2, 4, -2, 0, 0, 2, 0]]


def test_wire_params_sweep_matches_jax():
    for n in (1, 7, 8, 90, 100, 128, 2560, 9728):
        for tp in (1, 2, 4, 8):
            for bits in (4, 8):
                for block in (1, 12, 32, 128, 1000):
                    assert wire_params(n, tp, bits, block) == \
                        jwire_params(n, tp, bits, block), (n, tp, bits, block)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_bytes_on_wire_matches_jax(tp):
    for short in SHORTHANDS:
        spec, jsp = CollectiveSpec.parse(short), jspec.CollectiveSpec.parse(
            short)
        for shape in ((4, 2560), (16, 128), (3, 5, 90), (1, 100)):
            got = spec.bytes_on_wire(shape, tp)
            assert got == jsp.bytes_on_wire(shape, tp), (short, shape, tp)
            assert comm.bytes_on_wire(spec, shape, tp) == got


def test_spec_shorthands_match_jax():
    for short in SHORTHANDS:
        spec, jsp = CollectiveSpec.parse(short), jspec.CollectiveSpec.parse(
            short)
        assert spec.shorthand() == jsp.shorthand(), short
        assert CollectiveSpec.parse(spec.shorthand()) == spec
        assert (spec.name, spec.block_size, spec.bits, spec.fused) == \
            (jsp.name, jsp.block_size, jsp.bits, jsp.fused)
        assert comm.scatters_output(spec) == jcomm.scatters_output(jsp)
    assert comm.strategies() == jcomm.strategies()


def test_plan_shorthand_and_resolution_match_jax():
    for short in PLANS:
        plan, jplan = parse_collective(short), jspec.parse_collective(short)
        assert isinstance(plan, CollectivePlan)
        assert plan.shorthand() == jplan.shorthand()
        assert CollectivePlan.parse(plan.shorthand()) == plan
        assert [s.shorthand() for s in plan.specs()] == \
            [s.shorthand() for s in jplan.specs()]
        for path in PATHS:
            assert plan.resolve(path).shorthand() == \
                jplan.resolve(path).shorthand(), (short, path)
    assert isinstance(parse_collective("quant-int8"), CollectiveSpec)
    assert parse_collective(None) == CollectiveSpec()


@pytest.mark.parametrize("bad", [
    "quant-int8:fused:fused", "quant-int8:64:32", "psum:fused", "cast:int3",
    "bogus", "per-layer:*=psum,mlp=none", "per-layer:mlp"])
def test_bad_shorthands_raise_like_jax(bad):
    with pytest.raises(ValueError):
        jspec.parse_collective(bad)
    with pytest.raises(ValueError):
        parse_collective(bad)


def test_overlap_is_not_ported_yet():
    """Once a refusal, now the ported flag: ``:overlap`` parses and prints
    as the reference's (``:fused`` first), and both refuse it on a
    collective that is not a quantized ring."""
    for short in ("quant-int8:overlap", "quant-int4:32:fused:overlap",
                  "quant-int4:32:overlap:fused"):
        spec, jsp = CollectiveSpec.parse(short), jspec.CollectiveSpec.parse(
            short)
        assert spec.shorthand() == jsp.shorthand(), short
        assert (spec.fused, spec.overlap) == (jsp.fused, jsp.overlap)
        assert spec.overlap and CollectiveSpec.parse(spec.shorthand()) == spec
    for bad in ("cast", "psum"):
        with pytest.raises(ValueError, match="only applies to quant"):
            jspec.CollectiveSpec(name=bad, overlap=True)
        with pytest.raises(ValueError, match="only applies to quant"):
            CollectiveSpec(name=bad, overlap=True)


def test_mesh_plan_matches_jax_and_refuses_dp():
    """Once a refusal of ``dp > 1``, now the ported grid: every shorthand
    parses and prints as the reference's, ``dp`` and ``ep`` included; an
    ``ep`` that does not divide ``dp`` is refused by both."""
    for short in ("dp1xtp1", "dp1xtp2", "tp4xdp1", "dp1xtp8", "dp2xtp4",
                  "dp2xtp1xep2", "ep2xtp2xdp4"):
        plan, jplan = MeshPlan.parse(short), JMeshPlan.parse(short)
        assert plan.shorthand() == jplan.shorthand()
        assert (plan.dp, plan.tp, plan.ep, plan.size) == \
            (jplan.dp, jplan.tp, jplan.ep, jplan.size)
    assert MeshPlan.parse(None) == MeshPlan()
    for bad in ("dp2xtp4xep3", "dp1xtp2xtp2"):
        with pytest.raises(ValueError):
            JMeshPlan.parse(bad)
        with pytest.raises(ValueError):
            MeshPlan.parse(bad)


def test_single_rank_strategies_are_the_identity():
    y = torch.randn(3, 10)
    for short in SHORTHANDS:
        assert comm.apply(y, None, CollectiveSpec.parse(short)) is y
    assert comm.axis_size(None) == 1 and comm.axis_index(None) == 0
