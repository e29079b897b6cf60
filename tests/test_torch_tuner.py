"""The collective tuner in the port (``plan/tuner.py``; ``prepare
--autotune-collectives``) against the reference's, on the CPU.

* ``simulate_wire`` on the same partials: the int8 ring bit-equal, the
  int4 ring within one quantization step (under ``jit`` XLA may multiply
  by 1/15 where the port divides, ``tests/test_torch_tp.py``), psum and
  cast equal.
* ``autotune_collectives`` on the planned params and folds of an
  artifact the reference prepared at tp=2 (qwen3-4b smoke,
  ``attn_tp_aware``), with the reference's calibration rows: per site
  ``rel_err`` within 1e-6 absolute, ``bytes_per_token`` equal, and the
  same ``chosen``, ``fused`` and ``eligibility``, at budgets 10.0, 0.05
  and 1e-9 (the reference's ``tests/test_plan.py`` and
  ``tests/test_fused_wire.py`` cases).
* ``tune_overlap`` and ``--overlap-collectives`` are ROADMAP.md queue 1,
  item 9: they raise, and the CLI exits 1 naming it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm.spec import CollectivePlan, CollectiveSpec
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.dist.topology import MeshPlan
from repro_torch.plan import compiler, tuner
from repro_torch.plan.artifact import DeploymentArtifact

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BUDGETS = (10.0, 0.05, 1e-9)
ERR_ATOL = 1e-6


def _fold_cfg():
    return get_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)


# ---------------------------------------------------------------------------
# the simulated wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("spec", ["psum", "cast", "quant-int8",
                                  "quant-int8:24", "quant-int4",
                                  "quant-int4:12"])
def test_simulate_wire_matches_jax(tp, spec):
    from repro.comm.spec import CollectiveSpec as JaxSpec
    from repro.plan import tuner as jtuner

    rng = np.random.default_rng(tp)
    parts = [rng.standard_normal((5, 90)).astype(np.float32)
             for _ in range(tp)]
    want = np.asarray(jtuner.simulate_wire(parts, JaxSpec.parse(spec)))
    got = tuner.simulate_wire([torch.from_numpy(p) for p in parts],
                              CollectiveSpec.parse(spec)).numpy()
    assert got.shape == want.shape
    if spec.startswith("quant-int4"):
        # one quantization step of the coarsest block of phase 2
        step = np.abs(want).max() * 2 / 15
        assert np.abs(got - want).max() <= step
    else:
        np.testing.assert_array_equal(got, want)


def test_candidate_specs_are_the_references():
    from repro.plan import tuner as jtuner

    assert [s.shorthand() for s in tuner.candidate_specs()] == \
        [s.shorthand() for s in jtuner.candidate_specs()]
    assert tuner.DEFAULT_BUDGET == jtuner.DEFAULT_BUDGET


# ---------------------------------------------------------------------------
# the tuner on the reference's plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tuned(tmp_path_factory):
    """{budget: (the reference's manifest, its artifact directory)} of
    qwen3-4b smoke with the fold, tuned at tp=2 from seed 0; and the
    reference's calibration rows by site path."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import compiler as jcompiler
    from repro.plan import tuner as jtuner

    cfg = jax_smoke_config("qwen3-4b").with_quant(attn_tp_aware=True)
    out = {}
    for budget in BUDGETS:
        art = jcompiler.prepare(cfg, tp=2, seed=0, autotune=True,
                                tune_budget=budget,
                                extra_manifest={"smoke": True})
        path = art.save(str(tmp_path_factory.mktemp(f"jtuned{budget}")))
        out[budget] = (art.manifest, path)
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), jcompiler.PLAN_RNG_STREAM),
        jtuner.TUNE_RNG_STREAM)
    sites = [m["path"] for m in out[BUDGETS[0]][0]["pairs"]] + ["layers.attn"]
    k1 = {"layers.mlp": cfg.d_model, "layers.attn": cfg.d_model}
    rows = {path: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (8, k1[path]))))
        for i, path in enumerate(sites)}
    return out, rows


@pytest.mark.parametrize("budget", BUDGETS)
def test_autotune_matches_jax(jax_tuned, budget):
    tuned, rows = jax_tuned
    manifest, path = tuned[budget]
    art = DeploymentArtifact.load(path, device="cpu")
    cfg = _fold_cfg()
    policy = ExecutionPolicy.from_config(cfg).with_(mesh=MeshPlan(tp=2))
    got_policy, report = tuner.autotune_collectives(
        cfg, art.params(), manifest["pairs"], policy, 2,
        attn_plans=art.aux["attn_plans"], budget=budget, calib_rows=rows)
    want = {s["path"]: s for s in manifest["collective_tuner"]}
    assert [s["path"] for s in report] == list(want) == ["layers.mlp",
                                                         "layers.attn"]
    for site in report:
        ref = want[site["path"]]
        for key in ("kind", "tp", "budget", "status", "chosen", "fused",
                    "overlap", "eligibility"):
            assert site[key] == ref[key], (budget, site["path"], key)
        assert sorted(site["candidates"]) == sorted(ref["candidates"])
        for short, score in site["candidates"].items():
            other = ref["candidates"][short]
            assert score["bytes_per_token"] == other["bytes_per_token"]
            assert abs(score["rel_err"] - other["rel_err"]) <= ERR_ATOL, \
                (budget, site["path"], short)
    assert got_policy.collective.shorthand() == \
        manifest["policy"]["collective"]
    plan = manifest["collective_plan"]
    assert [[p, s.shorthand()] for p, s in got_policy.collective.entries] \
        == plan["entries"]


def test_budget_decides_the_choice(jax_tuned):
    """A loose budget takes the int4 ring fused on the MLP, a tight one
    psum everywhere (the reference's ``test_autotune_respects_budget``);
    the fold site is never fused."""
    tuned, _ = jax_tuned
    loose = dict(tuned[10.0][0]["collective_plan"]["entries"])
    tight = dict(tuned[1e-9][0]["collective_plan"]["entries"])
    assert loose["layers.mlp"] == "quant-int4:32:fused"
    assert not loose["layers.attn"].endswith(":fused")
    assert set(tight.values()) == {"psum"}


def test_port_prepare_autotune_writes_the_references_keys():
    """The port's ``prepare(autotune=True)`` at tp=2: a per-layer plan in
    the policy and its structural echo, a report with the reference's
    keys per site, the seeded calibration stream (the same plan twice),
    and tp=1 sites recorded as such."""
    cfg = _fold_cfg()
    art = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True,
                           extra_manifest={"smoke": True})
    again = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True)
    man = art.manifest
    assert man["collective_tuner"] == again.manifest["collective_tuner"]
    plan = CollectivePlan.parse(man["policy"]["collective"])
    assert [p for p, _ in plan.entries] == ["layers.mlp", "layers.attn"]
    assert man["collective_plan"]["default"] == "psum"
    keys = {"path", "kind", "tp", "budget", "status", "chosen", "fused",
            "overlap", "eligibility", "candidates"}
    for site in man["collective_tuner"]:
        assert set(site) == keys and site["status"] == "tuned"
        assert site["budget"] == tuner.DEFAULT_BUDGET
    one = compiler.prepare(cfg, tp=1, seed=0, device="cpu", autotune=True)
    assert {s["status"] for s in one.manifest["collective_tuner"]} == {
        "tp=1 (no collective)"}


def test_overlap_is_item_9():
    """Item 9's ``:overlap`` marks, once refused, as the reference makes
    them: the quantized pair site marked, the attn_vo site never, and
    nothing to mark without sites."""
    cfg = _fold_cfg()
    art = compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True,
                           tune_overlap=True)
    sites = {s["path"]: s for s in art.manifest["collective_tuner"]}
    assert sites["layers.mlp"]["overlap"]
    assert sites["layers.mlp"]["chosen"].endswith(":overlap")
    assert not sites["layers.attn"]["overlap"]
    assert ":overlap" not in sites["layers.attn"]["chosen"]
    pol, report = tuner.autotune_collectives(cfg, {}, [], ExecutionPolicy(),
                                             2, overlap=True)
    assert report == [] and pol.collective.shorthand() == "per-layer:*=psum"


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_prepare_autotune_and_overlap(tmp_path):
    """``prepare --autotune-collectives --tune-budget 10
    --overlap-collectives`` prints the reference's ``tuned <path>
    [<kind>]: <chosen> (<status>)`` lines and writes the plan, its
    quantized choice marked ``:overlap``; ``--overlap-collectives``
    without ``--autotune-collectives`` exits 2."""
    out = str(tmp_path / "tuned")
    done = _cli("prepare", "--smoke", "--tp", "2", "--out", out,
                "--device", "cpu", "--autotune-collectives",
                "--tune-budget", "10", "--overlap-collectives")
    assert done.returncode == 0, done.stderr
    with open(os.path.join(out, "manifest.json")) as f:
        man = json.load(f)
    (site,) = man["collective_tuner"]
    assert f"  tuned layers.mlp [pair]: {site['chosen']} (tuned)" in \
        done.stdout.splitlines()
    assert site["chosen"] == "quant-int4:32:fused:overlap"
    assert site["overlap"] and site["fused"]
    refused = _cli("prepare", "--smoke", "--tp", "2", "--out",
                   str(tmp_path / "x"), "--device", "cpu",
                   "--overlap-collectives")
    assert refused.returncode == 2
    assert "requires --autotune-collectives" in refused.stderr
    assert not os.path.exists(str(tmp_path / "x"))


