"""A vocab that does not divide the ranks: granite-3-8b's smoke model
with an odd vocab (``smoke_reduce(granite, vocab_size=515)``) takes the
reference's ``d_model`` split of the embedding (by columns) and the head
(by rows) at tp 2, on the CPU.

* The port's ranks over gloo against the single-device JAX forward
  (within 5e-3 of max|logit|, ``tests/test_torch_model.py``'s bound;
  ROADMAP caveat a: the reference's own model-level TP is not the
  yardstick), greedy ids equal.
* A JAX-prepared tp 2 artifact loads bit-equal with ``leaf_shards`` 1
  (embedding) and 0 (lm_head); the port's manifest is the reference's
  and its rank r is ``Model.init(0, tp=2, rank=r)``.
* The serve CLI's ``--artifact`` path serves it at tp 2, each rank
  reading only its own file.

JAX is imported inside the fixtures and tests that run it: the gloo rank
processes import this module."""

import argparse

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config, smoke_reduce
from repro_torch.launch import mesh
from repro_torch.models import common
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime.serve import Engine
from repro_torch.train import checkpoint

REL_TOL = 5e-3
CPU = torch.device("cpu")
#: an odd vocab: 515 does not divide 2 ranks
ODD_VOCAB = 515
MAX_SEQ = 24


def _odd_cfg():
    return smoke_reduce(get_config("granite-3-8b"), vocab_size=ODD_VOCAB)


def _jax_odd_cfg():
    from repro.configs import get_config as jax_config
    from repro.configs.base import smoke_reduce as jax_smoke_reduce

    return jax_smoke_reduce(jax_config("granite-3-8b"), vocab_size=ODD_VOCAB)


def _rel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_odd_vocab_splits_d_model_as_the_reference():
    from repro.models.common import embed_specs as jax_embed_specs

    cfg = _odd_cfg()
    assert cfg.padded_vocab() == ODD_VOCAB
    for tp in (1, 2):
        ref = jax_embed_specs(_jax_odd_cfg(), "model", tp)
        want = {k: next(i for i, a in enumerate(spec) if a == "model")
                for k, spec in ref.items()}
        assert common.embed_specs(cfg, tp) == want
    assert common.embed_specs(cfg, 2) == {"embedding": 1, "lm_head": 0}
    assert common.embed_specs(get_smoke_config("granite-3-8b"), 2) == {
        "embedding": 0, "lm_head": 1}
    params = build_model(cfg).init(0, device="cpu", tp=2, rank=1)
    assert tuple(params["embed"]["embedding"].shape) == (ODD_VOCAB, 128)
    assert tuple(params["embed"]["lm_head"].shape) == (128, ODD_VOCAB)


def _jax_prepare_odd(out: str) -> str:
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.plan import compiler as jax_compiler

    cfg = _jax_odd_cfg()
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=2))
    return jax_compiler.prepare(cfg, tp=2, seed=0, policy=policy,
                                extra_manifest={"smoke": True}).save(out)


@pytest.fixture(scope="module")
def odd(tmp_path_factory):
    """The odd-vocab model's reference outputs and files: JAX's params
    (carried), its forward logits and greedy ids, and its tp=2
    artifact."""
    import jax
    import jax.numpy as jnp
    from repro.models.common import REPLICATED
    from repro.runtime.serve import make_engine as jax_make_engine
    from repro.train import checkpoint as jax_checkpoint

    jeng = jax_make_engine(_jax_odd_cfg(), jax.random.PRNGKey(0),
                           max_seq=MAX_SEQ)
    ckpt = jax_checkpoint.save(str(tmp_path_factory.mktemp("ckpt") / "p.npz"),
                               jeng.params)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, ODD_VOCAB, (2, 12)).astype(np.int32)
    prompts = rng.integers(0, ODD_VOCAB, (4, 8)).astype(np.int32)
    plen = np.array([8, 5, 7, 6], np.int32)
    return {
        "ckpt": ckpt, "tokens": toks, "prompts": prompts, "plen": plen,
        "logits": np.asarray(jeng.model.forward(
            jeng.params, {"tokens": jnp.asarray(toks)}, REPLICATED)),
        "ids": np.asarray(jeng.generate(
            jax.random.PRNGKey(0), {"tokens": jnp.asarray(prompts)},
            jnp.asarray(plen), max_new_tokens=8)),
        "artifact": _jax_prepare_odd(str(tmp_path_factory.mktemp("jax2")))}


def _serve_args(artifact: str) -> argparse.Namespace:
    """What ``repro_torch.launch.serve --artifact DIR --device cpu
    --requests 2 --max-new 4`` parses to."""
    return argparse.Namespace(
        artifact=artifact, tp=2, backend="auto", requests=2, max_new=4,
        prompt_budget=32, max_batch=4, temperature=0.8, seed=0,
        device="cpu", arch="granite-3-8b", smoke=True, scheme="tp-aware",
        collective="psum", kv_page_size=None, kv_bits=None)


def _odd_rank(ctx, ref: dict):
    """One rank at tp=2: the carried params' forward and greedy ids, then
    the serve CLI's ``--artifact`` path on the JAX artifact (its smoke
    config made the odd-vocab one: the manifest names the arch and
    ``smoke``, not the vocab)."""
    from repro_torch.launch import serve

    cfg = _odd_cfg()
    params = interop.load_params(ref["ckpt"], device="cpu")
    trees, shards = compiler.shard_params(cfg, params, ctx.tp)
    eng = Engine(model=build_model(cfg), params=trees[ctx.rank], device=CPU,
                 max_seq=MAX_SEQ, group=ctx.group)
    out = {"leaf_shards": {k: v for k, v in shards.items()
                           if k.startswith("embed")},
           "embed_shapes": [tuple(t.shape) for t in
                            trees[ctx.rank]["embed"].values()],
           "logits": eng.prefill_logits(
               torch.from_numpy(ref["tokens"]).long()).numpy(),
           "ids": eng.generate(
               None, torch.from_numpy(ref["prompts"]).long(),
               torch.from_numpy(ref["plen"]), max_new_tokens=8).numpy()}
    serve.get_smoke_config = lambda arch: cfg
    ids, lines, resident = serve._serve(_serve_args(ref["artifact"]),
                                        ctx.device, ctx.group, ctx.transport)
    out.update(served=ids, lines=lines, resident=resident)
    return out


@pytest.fixture(scope="module")
def odd_ranks(odd):
    ref = {k: odd[k] for k in ("ckpt", "tokens", "prompts", "plen",
                               "artifact")}
    return mesh.run(_odd_rank, 2, ref, device_type="cpu", timeout=180)


def test_odd_vocab_tp2_matches_single_device_jax(odd, odd_ranks):
    for r in odd_ranks:
        assert r["leaf_shards"] == {"embed||embedding": 1,
                                    "embed||lm_head": 0}
        assert r["embed_shapes"] == [(ODD_VOCAB, 128), (128, ODD_VOCAB)]
        assert r["logits"].shape == odd["logits"].shape
        assert _rel_gap(r["logits"], odd["logits"]) <= REL_TOL
        np.testing.assert_array_equal(r["ids"], odd["ids"])
    np.testing.assert_array_equal(odd_ranks[0]["logits"],
                                  odd_ranks[1]["logits"])


def test_jax_odd_vocab_artifact_loads_bit_equal(odd):
    from repro.plan import DeploymentArtifact as JaxArtifact
    from repro.train import checkpoint as jax_checkpoint

    ref = JaxArtifact.load(odd["artifact"])
    art = DeploymentArtifact.load(odd["artifact"], device="cpu")
    shards = art.manifest["leaf_shards"]
    assert (shards["embed||embedding"], shards["embed||lm_head"]) == (1, 0)
    assert art.manifest == ref.manifest
    art.validate(cfg=_odd_cfg(), policy=art.policy(), tp=2)
    for got, want in ((art.rank_tree(r), ref.rank_tree(r)) for r in (0, 1)):
        want = jax_checkpoint.flatten_keys(want)
        have = checkpoint.flatten_keys(interop.to_reference_layout(got))
        assert sorted(have) == sorted(want)
        for key, leaf in want.items():
            leaf = np.asarray(leaf)
            t = have[key].numpy()
            if leaf.dtype == np.uint32:
                t = t.view(np.uint32)
            assert t.dtype == leaf.dtype, key
            np.testing.assert_array_equal(t, leaf, err_msg=key)
    emb = art.rank_tree(0)["embed"]["embedding"]
    assert tuple(emb.shape) == (ODD_VOCAB, 128)
    np.testing.assert_array_equal(
        art.params()["embed"]["embedding"].numpy(),
        np.asarray(ref.params()["embed"]["embedding"]))


def test_port_odd_vocab_manifest_is_the_references(odd):
    """The port's prepare at tp=2: the reference's manifest, and rank r is
    ``Model.init(0, tp=2, rank=r)`` bit for bit."""
    art = compiler.prepare(_odd_cfg(), tp=2, seed=0, device="cpu",
                           extra_manifest={"smoke": True})
    assert art.manifest == DeploymentArtifact.load_manifest(odd["artifact"])
    model = build_model(_odd_cfg())
    for r in (0, 1):
        want = checkpoint.flatten_keys(model.init(0, device="cpu", tp=2,
                                                  rank=r))
        got = checkpoint.flatten_keys(art.rank_tree(r))
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_odd_vocab_artifact_served_at_tp2(odd, odd_ranks):
    """The CLI's ``--artifact`` path at tp=2: each rank reads only its own
    file, both emit the same ids, and those are the ids of one device
    serving the reassembled plan."""
    for r, res in enumerate(odd_ranks):
        loaded, total = map(int, res["resident"].split("=")[1].split()[0]
                            .split("/"))
        assert res["resident"].endswith(f"ranks=[{r}]") and loaded < total
        assert res["served"] == odd_ranks[0]["served"]
    assert f"artifact={odd['artifact']}]" in odd_ranks[0]["lines"][-2]
    art = DeploymentArtifact.load(odd["artifact"], device="cpu")
    args = _serve_args(odd["artifact"])
    one = Engine(model=build_model(_odd_cfg()), params=art.params(),
                 device=CPU, max_seq=args.prompt_budget + args.max_new + 1)
    assert _serve_one(one, args) == odd_ranks[0]["served"]


def _serve_one(engine, args) -> dict:
    """``launch/serve._serve``'s requests and scheduler on ``engine``."""
    from repro_torch.runtime.sampling import SamplingConfig
    from repro_torch.runtime.scheduler import Request, Scheduler

    sched = Scheduler(engine, max_batch=args.max_batch,
                      prompt_budget=args.prompt_budget,
                      scfg=SamplingConfig(temperature=args.temperature,
                                          top_k=40), seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt_budget))
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, engine.model.cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))
    return {rid: r.output for rid, r in sched.run().items()}
