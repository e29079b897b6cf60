"""Port parity of the other dense decoders (granite-3-8b, starcoder2-3b,
mistral-large-123b) at smoke size, on the CPU, as
``tests/test_torch_model.py`` holds qwen3-4b: JAX params carried across
through ``checkpoint.save`` -> ``repro_torch.interop``, then the port's
forward, decode and greedy ids against the reference's, for the tp-aware
plan and the naive act-order one.

* Configs, full and smoke, equal the reference's field for field and by
  ``config_hash``; the pairs' group sizes and K steps are the reference's.
* Logit tolerance 5e-3 of max|logit| (``tests/test_torch_model.py``'s
  bound and reasoning); decode is held against the reference's decode,
  never its forward (ROADMAP caveat b: granite's JAX decode and forward
  differ by 2.2%).
* The serve CLI at smoke size for each arch.  (A vocab that does not
  divide the ranks: ``tests/test_torch_archs_tp.py``; the 8192-token
  Q-chunked forward and RoPE at far positions:
  ``tests/test_torch_long.py``.)
* ``gpu``: each kernel against its plain version at the archs'
  full-width MLP shapes (skips without a card).

JAX is imported inside the tests and fixtures that run it, so the
``gpu`` tests run on a machine without JAX."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.reorder import PlannedPair
from repro_torch.kernels import dequant_matmul as tdk
from repro_torch.models import common
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.runtime.serve import Engine

ARCHS = ("granite-3-8b", "starcoder2-3b", "mistral-large-123b")
SCHEMES = ("tp-aware", "naive-actorder")
REL_TOL = 5e-3
CPU = torch.device("cpu")
MAX_SEQ = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run (as the
    spawned ranks of ``launch/mesh.py`` do on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(tmp_path_factory, jcfg, cfg):
    """(JAX engine, port engine) over the same params."""
    import jax
    from repro.runtime.serve import make_engine as jax_make_engine
    from repro.train import checkpoint as jax_checkpoint

    jeng = jax_make_engine(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ)
    path = jax_checkpoint.save(
        str(tmp_path_factory.mktemp("ckpt") / "p.npz"), jeng.params)
    teng = Engine(model=build_model(cfg),
                  params=interop.load_params(path, device=CPU), device=CPU,
                  max_seq=MAX_SEQ)
    return jeng, teng


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(arch, scheme, activation dtype) -> (JAX engine, port engine), each
    built once."""
    from repro.configs import get_smoke_config as jax_smoke_config

    made = {}

    def get(arch, scheme="tp-aware", dtype="bfloat16"):
        if (arch, scheme, dtype) not in made:
            made[arch, scheme, dtype] = _carry(
                tmp_path_factory,
                jax_smoke_config(arch).with_(dtype=dtype).with_quant(
                    scheme=scheme),
                get_smoke_config(arch).with_(dtype=dtype).with_quant(
                    scheme=scheme))
        return made[arch, scheme, dtype]

    return get


def _leaf(tree, path):
    """Port leaf at a JAX checkpoint key path (layers re-stacked)."""
    if path[0] == "layers":
        return torch.stack([_leaf(layer, path[1:])
                            for layer in tree["layers"]])
    node = tree
    for p in path:
        node = node[p] if isinstance(node, dict) else getattr(node, p)
    return node


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan.artifact import config_hash as jax_hash

    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert part.config_hash(port) == jax_hash(ref)


@pytest.mark.parametrize("arch", ARCHS + ("qwen3-4b",))
def test_pair_group_sizes_and_k_steps_are_the_references(arch):
    """Each full-width pair's group sizes (the down projection's tiles the
    K shard of up to 16 ranks: granite's is 100) and each GEMM's K step,
    whole and at the tp=2 down shard, as the reference picks them."""
    from repro.configs import get_config as jax_config
    from repro.kernels.dequant_matmul import pick_block_k as jax_block_k
    from repro.plan import compiler as jax_compiler

    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    w_up, w_down = (types.SimpleNamespace(shape=s) for s in ((d, ff),
                                                              (ff, d)))
    gs_up, gs_down = compiler._pair_group_sizes(cfg, w_up, w_down)
    assert (gs_up, gs_down) == jax_compiler._pair_group_sizes(
        jax_config(arch), w_up, w_down)
    for k, gs in ((d, gs_up), (ff, gs_down), (ff // 2, gs_down)):
        assert tdk.pick_block_k(k, gs) == jax_block_k(k, gs), (k, gs)
    if arch == "granite-3-8b":
        assert gs_down == 100 and tdk.pick_block_k(ff, gs_down) == 200


# ---------------------------------------------------------------------------
# the three archs against JAX at smoke size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_carried_leaves_bit_equal(carried, arch, scheme):
    from repro.train import checkpoint as jax_checkpoint

    jeng, teng = carried(arch, scheme)
    mlp = teng.params["layers"][0]["mlp"]
    assert isinstance(mlp, PlannedPair) and mlp.scheme == scheme
    assert (mlp.gate is not None) == teng.model.cfg.mlp_gated
    for key, leaf in jax_checkpoint.flatten_keys(jeng.params).items():
        ref = np.asarray(leaf)
        if ref.dtype == np.uint32:
            ref = ref.view(np.int32)
        got = _leaf(teng.params, key.split("||")).numpy()
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(carried, arch):
    import jax.numpy as jnp
    from repro.models.common import REPLICATED

    jeng, teng = carried(arch)
    toks = np.random.default_rng(2).integers(
        0, teng.model.cfg.vocab_size, (2, 12)).astype(np.int32)
    ref = np.asarray(jeng.model.forward(jeng.params,
                                        {"tokens": jnp.asarray(toks)},
                                        REPLICATED))
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy).numpy()
    assert got.shape == ref.shape
    assert _rel_gap(got, ref) <= REL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(carried, arch):
    """Lockstep steps, then steps on unequal per-slot positions (the path
    the CUDA graph captures), against the reference's jitted step."""
    import jax.numpy as jnp

    jeng, teng = carried(arch)
    b, steps = 3, 10
    toks = np.random.default_rng(1).integers(
        0, teng.model.cfg.vocab_size, (b, steps)).astype(np.int32)
    for offsets in (np.zeros(b, np.int32), np.array([0, 3, 7], np.int32)):
        jcache, tcache = jeng.init_cache(b), teng.init_cache(b)
        for t in range(steps):
            pos = offsets + t
            ref, jcache = jeng._decode(jeng.params, jcache,
                                       jnp.asarray(toks[:, t]),
                                       jnp.asarray(pos))
            got, tcache = teng.decode(tcache,
                                      torch.from_numpy(toks[:, t]).long(),
                                      torch.from_numpy(pos).long())
            assert _rel_gap(got.numpy(), np.asarray(ref)) <= REL_TOL, (
                offsets, t)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_ids_match_jax(carried, arch, scheme):
    import jax
    import jax.numpy as jnp

    jeng, teng = carried(arch, scheme)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, teng.model.cfg.vocab_size, (4, 8)).astype(np.int32)
    plen = np.array([8, 5, 7, 6], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(toks)},
                                   jnp.asarray(plen), max_new_tokens=8))
    got = teng.generate(None, torch.from_numpy(toks).long(),
                        torch.from_numpy(plen), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_forward_matches_jax_flash(carried, arch):
    """``attn_backend="flash"`` (the kernel's plain version on the CPU)
    against the reference's (the Pallas kernel in interpret mode)."""
    import jax.numpy as jnp
    from repro.models.common import ParallelContext

    jeng, teng = carried(arch)
    toks = np.random.default_rng(4).integers(
        0, teng.model.cfg.vocab_size, (2, 16)).astype(np.int32)
    ref = np.asarray(jeng.model.forward(
        jeng.params, {"tokens": jnp.asarray(toks)},
        ParallelContext(attn_backend="flash")))
    got = teng.model.forward(teng.params,
                             {"tokens": torch.from_numpy(toks).long()},
                             teng.policy, attn_backend="flash").numpy()
    assert _rel_gap(got, ref) <= REL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_is_its_layers(carried, arch):
    """``transformer.layer_forward`` (the reference's scan body, before the
    carry's cast) composed layer by layer is the forward, bit for bit:
    what ``chip_smoke.py`` holds two plans to layer by layer."""
    from repro_torch.models import transformer

    _, teng = carried(arch)
    cfg, params = teng.model.cfg, teng.params
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 12))).long()
    x = common.embed_tokens(cfg, params["embed"], toks)
    for lp in params["layers"]:
        y = transformer.layer_forward(cfg, lp, x, teng.policy)
        assert y.dtype == torch.float32 and x.dtype == torch.bfloat16
        x = y.to(x.dtype)
    x = common.apply_norm(cfg, params["final_norm"], x)
    assert torch.equal(common.lm_head(cfg, params["embed"], x),
                       teng.model.forward(params, {"tokens": toks},
                                          teng.policy))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_arch_at_smoke_size(arch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --smoke --device
    cpu --requests 2 --max-new 4`` (its ``main``, in this process): two
    requests served, the banner naming the plan."""
    from repro_torch.launch import serve

    outputs = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert sorted(outputs) == [0, 1]
    assert all(len(o) == 4 for o in outputs.values())
    assert len([ln for ln in out.splitlines() if ln.startswith("req ")]) == 2
    assert "[scheme=tp-aware backend=torch collective=psum" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_kernels_at_the_arch_shapes(arch):
    """K1, K4 and K5 at the arch's full-width MLP shapes (M = 4), and K3
    at its tp=2 down shard (int8 and int4 wires), against their plain
    versions on the card: K1, K4 within 1e-5 of max|ref| + 1e-4, K5 bit
    for bit, K3 bit-equal to K1 followed by the collective's quantizer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.comm.wire import wire_params
    from repro_torch.core import quantization as tqz
    from repro_torch.kernels import ops

    cfg = get_config(arch)
    d, ff = cfg.d_model, cfg.d_ff
    w_up, w_down = (types.SimpleNamespace(shape=s) for s in ((d, ff),
                                                              (ff, d)))
    gs_up, gs_down = compiler._pair_group_sizes(cfg, w_up, w_down)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for k, n, gs in ((d, ff, gs_up), (ff, d, gs_down)):
        q = tqz.quantize(torch.randn(k, n, generator=gen, device="cuda"), gs,
                         generator=gen)
        x = torch.randn(4, k, generator=gen, device="cuda")
        for ql, plain in (
                (q.ordered, lambda ql: tdk.dequant_matmul_ordered_torch(
                    x, ql.qweight, ql.scales, ql.zeros, group_size=gs)),
                (q.naive, lambda ql: tdk.dequant_matmul_gidx_torch(
                    x, ql.qweight, ql.scales, ql.zeros, ql.g_idx))):
            y, ref = ops.dequant_matmul(x, ql), plain(ql)
            err = (y - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item() + 1e-4, (k, n, err)
        o = q.ordered
        assert torch.equal(ops.dequantize(o), tdk.dequantize_ordered_torch(
            o.qweight, o.scales, o.zeros, group_size=gs))
        del q, o
    shard = tqz.quantize(torch.randn(ff // 2, d, generator=gen,
                                     device="cuda"), gs_down,
                         generator=gen).ordered
    x = torch.randn(4, ff // 2, generator=gen, device="cuda")
    for bits, blk in ((8, 128), (4, 32)):
        n_pad, _, bs = wire_params(d, 2, bits, blk)
        got = ops.dequant_matmul_wire(x, shard, tp=2, wire_bits=bits,
                                      wire_block=blk)
        want = tdk.quantize_wire(ops.dequant_matmul(x, shard), n_pad=n_pad,
                                 wire_block=bs, wire_bits=bits)
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, want)), bits
