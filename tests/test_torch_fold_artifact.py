"""Fold and tuned artifacts across the two packages (``plan/artifact.py``'s
aux tree, ``dist/loader.load_aux``, the serve CLI), qwen3-4b smoke with
``attn_tp_aware``, on the CPU.

* An artifact the port prepares at tp=2 with ``--autotune-collectives``
  loads and validates in the reference and lints clean
  (``repro.analysis.manifest_lint.lint_artifact``: no error finding);
  its ``collective_tuner`` has the reference's keys; its ``aux.npz`` has
  the reference's flat keys, dtypes and shapes.
* The reference's engine serves the port's tp=1 fold artifact within
  5e-3 of max|logit| of the port's engine (its step un-jitted, see
  ``tests/test_torch_attention_fold.py``), greedy ids equal.
* The port serves the reference's fold artifact at tp=2 over gloo, each
  rank with its heads of the fold: logits within 5e-3 of max|logit| of
  the single-device un-jitted reference forward (ROADMAP caveat a: the
  reference's own model-level TP is not the yardstick), greedy ids equal
  on both ranks and to the one-device port's.
* The CLI serves a fold artifact at tp 1 and 2 and its banner names the
  fold.

JAX is imported inside the fixtures and tests that run it: the gloo rank
processes import this module."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh
from repro_torch.models.registry import build_model
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact, PlanMismatchError
from repro_torch.runtime.serve import Engine, make_engine
from repro_torch.train import checkpoint

REL_TOL = 5e-3
MAX_SEQ = 24
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _fold_cfg():
    return get_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)


def _jax_prepare(tp: int, out: str, **kw) -> str:
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import compiler as jcompiler

    cfg = jax_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)
    return jcompiler.prepare(cfg, tp=tp, seed=0, extra_manifest={
        "smoke": True}, **kw).save(out)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Artifact directories: the port's tuned tp=2 and plain tp=1 folds,
    and the reference's tuned and plain (psum) tp=2 folds."""
    cfg = _fold_cfg()
    port2 = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True,
                             extra_manifest={"smoke": True}).save(
        str(tmp_path_factory.mktemp("port2")))
    port1 = compiler.prepare(cfg, tp=1, seed=0, device="cpu",
                             extra_manifest={"smoke": True}).save(
        str(tmp_path_factory.mktemp("port1")))
    jax2 = _jax_prepare(2, str(tmp_path_factory.mktemp("jax2")),
                        autotune=True)
    psum2 = _jax_prepare(2, str(tmp_path_factory.mktemp("psum2")))
    return {"port2": port2, "port1": port1, "jax2": jax2, "psum2": psum2}


def test_jax_loads_validates_and_lints_port_fold_artifact(dirs):
    from repro.analysis.manifest_lint import lint_artifact
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import DeploymentArtifact as JaxArtifact

    path = dirs["port2"]
    ref = JaxArtifact.load(path)
    cfg = jax_smoke_config("qwen3-4b").with_quant(**ref.manifest["quant"])
    assert ref.validate(cfg=cfg, policy=ref.policy(), tp=2) is ref
    assert "layers.attn" in ref.aux["attn_plans"]
    errors = [f for f in lint_artifact(path) if f.severity == "error"]
    assert errors == []
    want = DeploymentArtifact.load_manifest(dirs["jax2"])
    have = ref.manifest
    assert set(have) == set(want)
    for got, site in zip(have["collective_tuner"], want["collective_tuner"]):
        assert set(got) == set(site) and got["path"] == site["path"]
        assert got["kind"] == site["kind"]
    assert [p for p, _ in have["collective_plan"]["entries"]] == \
        [p for p, _ in want["collective_plan"]["entries"]]


def test_aux_flat_keys_are_the_references(dirs):
    """The port's ``aux.npz`` and the reference's have the same keys, and
    each leaf the same dtype and shape (the draws differ: each package
    keeps its own seed stream)."""
    keys = {}
    for name in ("port2", "jax2"):
        with np.load(os.path.join(dirs[name], "aux.npz")) as data:
            keys[name] = {k: (data[k].dtype, data[k].shape)
                          for k in data.files if k != "__tree__"}
    assert keys["port2"] == keys["jax2"]
    assert "attn_plans||layers.attn||up||qweight" in keys["port2"]
    assert keys["port2"]["attn_plans||layers.attn||up||qweight"][0] == \
        np.uint32
    art = DeploymentArtifact.load(dirs["port2"], device="cpu")
    again = compiler.prepare(_fold_cfg(), tp=2, seed=0, device="cpu",
                             autotune=True)
    fa = checkpoint.flatten_keys(art.aux)
    fb = checkpoint.flatten_keys(again.aux)
    assert list(fa) == list(fb) and all(torch.equal(fa[k], fb[k])
                                        for k in fa)


def test_validate_refuses_a_fold_the_model_does_not_consume(dirs, tmp_path):
    art = DeploymentArtifact.load(dirs["port1"], device="cpu")
    art.validate(cfg=_fold_cfg(), policy=art.policy(), tp=1)
    plans = art.aux["attn_plans"]
    moved = DeploymentArtifact(manifest=art.manifest,
                               rank_params=art.rank_params,
                               aux={"attn_plans": {"layers.xattn":
                                                   plans["layers.attn"]}})
    with pytest.raises(PlanMismatchError, match="consumes folds at"):
        moved.validate(cfg=_fold_cfg())


def test_jax_serves_port_fold_artifact_like_the_port(dirs):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime.serve import make_engine as jax_make_engine

    path = dirs["port1"]
    manifest = DeploymentArtifact.load_manifest(path)
    jeng = jax_make_engine(
        jax_smoke_config("qwen3-4b").with_quant(**manifest["quant"]),
        jax.random.PRNGKey(0), max_seq=MAX_SEQ, artifact=path)
    assert jeng.aux is not None
    teng = make_engine(_fold_cfg(), device="cpu", max_seq=MAX_SEQ,
                       artifact=path)
    rng = np.random.default_rng(5)
    jcache, tcache = jeng.init_cache(3), teng.init_cache(3)
    for t in range(6):
        tok = rng.integers(0, 512, 3).astype(np.int32)
        with jax.disable_jit():
            want, jcache = jeng.model.decode_step(
                jeng.params, jcache, jnp.asarray(tok), jnp.int32(t),
                jeng.ctx, aux=jeng.aux)
        have, tcache = teng.decode(tcache, torch.from_numpy(tok).long(), t)
        want = np.asarray(want)
        assert np.abs(have.numpy() - want).max() <= \
            REL_TOL * np.abs(want).max(), t
        np.testing.assert_array_equal(have.numpy().argmax(-1),
                                      want.argmax(-1))


def _fold_rank(ctx, ref: dict):
    """One rank at tp=2 on the reference's fold artifact: this rank's file
    and its heads of the fold; the forward's logits and greedy ids."""
    plan = DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
        ref["path"])).policy(backend="auto", device=ctx.device)
    eng = make_engine(_fold_cfg(), device="cpu", max_seq=MAX_SEQ,
                      group=ctx.group, policy=plan, artifact=ref["path"])
    vo = eng.aux["attn_plans"]["layers.attn"][0]
    return {"logits": eng.prefill_logits(
                torch.from_numpy(ref["tokens"]).long()).numpy(),
            "ids": eng.generate(None, torch.from_numpy(ref["prompts"]).long(),
                                torch.from_numpy(ref["plen"]),
                                max_new_tokens=6).numpy(),
            "fold_shapes": (tuple(vo.up.qweight.shape),
                            tuple(vo.down.qweight.shape)),
            "aux_bytes": eng.load_stats.aux_bytes_loaded}


def test_port_serves_jax_fold_artifact_at_tp2(dirs):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.common import REPLICATED
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import DeploymentArtifact as JaxArtifact

    path = dirs["psum2"]
    rng = np.random.default_rng(6)
    ref = {"path": path,
           "tokens": rng.integers(0, 512, (2, 10)).astype(np.int32),
           "prompts": rng.integers(0, 512, (3, 6)).astype(np.int32),
           "plen": np.array([6, 4, 5], np.int32)}
    ranks = mesh.run(_fold_rank, 2, ref, device_type="cpu", timeout=180)

    jart = JaxArtifact.load(path)
    jcfg = jax_smoke_config("qwen3-4b").with_quant(**jart.manifest["quant"])
    with jax.disable_jit():
        want = np.asarray(jax_build_model(jcfg).forward(
            jart.params(), {"tokens": jnp.asarray(ref["tokens"])},
            REPLICATED, aux=jart.aux))
    art = DeploymentArtifact.load(path, device="cpu")
    one = Engine(model=build_model(_fold_cfg()), params=art.params(),
                 device=torch.device("cpu"), max_seq=MAX_SEQ, aux=art.aux)
    ids = one.generate(None, torch.from_numpy(ref["prompts"]).long(),
                       torch.from_numpy(ref["plen"]),
                       max_new_tokens=6).numpy()
    aux_bytes = os.path.getsize(os.path.join(path, "aux.npz"))
    for r in ranks:
        gap = np.abs(r["logits"] - want).max() / np.abs(want).max()
        assert gap <= REL_TOL
        np.testing.assert_array_equal(r["ids"], ids)
        # V: d_model/8 packed rows, this rank's KV heads; O: its heads' rows
        assert r["fold_shapes"] == ((32, 64), (16, 256))
        assert r["aux_bytes"] == aux_bytes
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name,tp", [("port1", 1), ("port2", 2)])
def test_cli_serves_fold_artifact(dirs, name, tp):
    """``--artifact`` of a fold artifact: the banner names the fold, at
    tp=2 over gloo both ranks served, and an artifact without a fold says
    ``none``."""
    out = _cli("--artifact", dirs[name], "--device", "cpu", "--requests",
               "2", "--max-new", "3")
    assert "attn V->O fold: 2 layers" in out
    assert len([ln for ln in out.splitlines()
                if ln.startswith("req ")]) == 2
    if tp == 2:
        assert "over gloo" in out
        assert "collective=per-layer:layers.mlp=" in out
    plain = _cli("--smoke", "--device", "cpu", "--requests", "1",
                 "--max-new", "2") if tp == 1 else None
    if plain is not None:
        assert "attn V->O fold: none" in plain
