"""The port's analysis package (``repro_torch.analysis``) and ``serve
verify``, on the CPU: the reference's ``tests/test_analysis.py`` cases on
the port's modules (without its HL and BN cases: the port has no HLO, and
its benchmark brings BN001), and the port's manifest findings held equal
to the reference's on the same directories.

* The catalog refuses unregistered IDs (HL and BN among them), severities
  default from it, and the summary has the reference's shape.
* AS001-AS004 fire on planted sources (calls resolved through each
  module's imports), stay quiet inside ``comm/``, ``dist/`` and
  ``kernels/``, and the port's tree has no finding.
* CT002 fires on planted wire bytes, a dtype cast and changed values at
  tp=1; CT001 on a dtype leak planted inside the tp=2 gloo ranks; CT003
  on a planted cache geometry; CT004 on planted logits; the contracts are
  clean at tp 1 and 2.
* MF001-MF006 fire as in the reference; a clean artifact has none.
* ``serve verify`` and ``python -m repro_torch.analysis`` exit 0 on a
  clean artifact and 1 on a planted copy (rank_01 renamed rank_05, an
  unreachable plan glob), in-process with ``--device cpu``.
* Parity: on a qwen3-4b smoke artifact prepared at tp=2 with the tuner by
  the reference and by the port, and on each planted defect, the port's
  ``lint_artifact`` gives the reference's ``(rule, severity, location)``
  list."""

import json
import os
import shutil

import pytest
import torch

from repro_torch.analysis import ast_lint, contracts, manifest_lint
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.findings import (RULES, Finding, has_errors,
                                           summarize)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.plan import compiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests: the smoke models' ops
    are tiny, so one thread runs them as fast alone, and it does not
    spin against the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(findings):
    return {f.rule for f in findings}


def _keys(findings):
    """The findings as sorted ``(rule, severity, location)``."""
    return sorted((f.rule, f.severity, f.location) for f in findings)


# ---------------------------------------------------------------------------
# findings plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["ZZ999", "HL001", "HL004", "BN001"])
def test_unregistered_rule_refused(rule):
    with pytest.raises(ValueError, match="unregistered rule"):
        Finding(rule, "nope")


def test_severity_defaults_from_catalog():
    f = Finding("AS001", "raw")
    assert f.severity == "error"
    waived = Finding("MF005", "waived", severity="info")
    assert not has_errors([waived])
    assert has_errors([waived, f])
    with pytest.raises(ValueError, match="unknown severity"):
        Finding("AS001", "raw", severity="fatal")


def test_summary_shape_is_the_references():
    from repro.analysis.findings import Finding as JaxFinding
    from repro.analysis.findings import summarize as jax_summarize

    s = summarize([Finding("AS004", "m", location="a.py:1")])
    want = jax_summarize([JaxFinding("AS004", "m", location="a.py:1")])
    assert s["counts"] == want["counts"] == {"error": 1, "warn": 0,
                                             "info": 0}
    assert s["rules_checked"] == sorted(RULES)
    assert s["findings"] == want["findings"]
    assert set(s) == set(want)
    # the port's catalog is the reference's CT, AS and MF rules
    from repro.analysis.findings import RULES as JAX_RULES

    assert set(RULES) == {r for r in JAX_RULES
                          if not r.startswith(("HL", "BN"))}
    assert all(RULES[r].severity == JAX_RULES[r].severity for r in RULES)


# ---------------------------------------------------------------------------
# AST rules
# ---------------------------------------------------------------------------

RAW_COLLECTIVE_SRC = """\
import torch.distributed as dist

def leak(y):
    dist.all_reduce(y)
    return y
"""


@pytest.mark.parametrize("src", [
    RAW_COLLECTIVE_SRC,
    "import torch\n\n\ndef leak(y):\n    return torch.distributed.broadcast"
    "(y, 0)\n",
    "from torch.distributed import all_to_all_single as a2a\n\n\n"
    "def leak(o, y):\n    return a2a(o, y)\n",
    "from torch import distributed\n\n\ndef leak(o, y):\n"
    "    return distributed.all_gather_into_tensor(o, y)\n"],
    ids=["alias", "torch.distributed", "from-import", "from-torch"])
def test_as001_raw_collective_fires(src):
    fs = ast_lint.lint_source(src, "repro_torch/models/foo.py")
    assert _rules(fs) == {"AS001"}
    assert fs[0].location.startswith("repro_torch/models/foo.py:")


def test_as001_allowed_inside_comm_and_dist_and_for_the_comm_facade():
    for rel in ("repro_torch/comm/foo.py", "repro_torch/dist/foo.py"):
        assert ast_lint.lint_source(RAW_COLLECTIVE_SRC, rel) == []
    # the comm layer's own all_to_all, and group set-up, are no raw calls
    ok = ("import torch.distributed as dist\n"
          "from repro_torch.comm import dispatch as comm\n"
          "def f(x, g):\n"
          "    dist.new_group([0, 1])\n"
          "    return comm.all_to_all(x, g, split_axis=0, concat_axis=1)\n")
    assert ast_lint.lint_source(ok, "repro_torch/models/foo.py") == []


def test_as002_kernel_bypass_fires():
    src = ("from repro_torch.kernels import ops\n"
           "from repro_torch.kernels import dequant_matmul as dk\n"
           "def f(x, ql):\n"
           "    y = ops.dequant_matmul(x, ql)\n"
           "    return dk.dequant_matmul_ordered(x, ql.qweight, ql.scales,\n"
           "                                     ql.zeros, group_size=8)\n")
    fs = ast_lint.lint_source(src, "repro_torch/models/foo.py")
    assert [f.rule for f in fs] == ["AS002", "AS002"]
    assert ast_lint.lint_source(src, "repro_torch/kernels/foo.py") == []
    # the registry, the flash kernel's wrapper and a same-named function
    # of another module are allowed
    ok = ("from repro_torch.kernels import dispatch as kdispatch\n"
          "from repro_torch.kernels import ops\n"
          "from repro_torch.core import quantization as qz\n"
          "def f(x, ql, q, policy):\n"
          "    w = qz.dequantize(ql)\n"
          "    o = ops.flash_attention(q, q, q)\n"
          "    return kdispatch.qmatmul(x, ql, policy)\n")
    assert ast_lint.lint_source(ok, "repro_torch/models/foo.py") == []


def test_as003_unfrozen_spec_dataclass_fires():
    src = ("import dataclasses\n"
           "@dataclasses.dataclass\n"
           "class LooseSpec:\n"
           "    name: str = 'x'\n")
    fs = ast_lint.lint_source(src, "repro_torch/comm/spec.py")
    assert _rules(fs) == {"AS003"}
    frozen = src.replace("@dataclasses.dataclass",
                         "@dataclasses.dataclass(frozen=True)")
    assert ast_lint.lint_source(frozen, "repro_torch/comm/spec.py") == []
    assert ast_lint.lint_source(src, "repro_torch/models/foo.py") == []


def test_as004_mutable_default_fires():
    fs = ast_lint.lint_source("def f(x, acc=[]):\n    return acc\n",
                              "repro_torch/core/foo.py")
    assert _rules(fs) == {"AS004"}
    fs = ast_lint.lint_source("def f(*, acc=dict()):\n    return acc\n",
                              "repro_torch/core/foo.py")
    assert _rules(fs) == {"AS004"}


def test_clean_tree_has_zero_ast_findings():
    assert ast_lint.run() == []


def test_cli_gate_exits_nonzero_on_a_planted_tree(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "models"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(RAW_COLLECTIVE_SRC)
    fs = ast_lint.run(src_root=str(tmp_path / "src"))
    assert _rules(fs) == {"AS001"}
    assert "repro_torch/models/bad.py:4" in fs[0].location


# ---------------------------------------------------------------------------
# contract rules
# ---------------------------------------------------------------------------

def test_ct002_nonzero_bytes_fires(monkeypatch):
    from repro_torch.comm.spec import CollectiveSpec

    monkeypatch.setattr(CollectiveSpec, "bytes_on_wire",
                        lambda self, shape, tp: 42.0)
    fs = contracts.lint_collectives(specs=["psum"], tps=(1,), device="cpu")
    assert _rules(fs) == {"CT002"}
    assert any("42.0" in f.message for f in fs)


@pytest.mark.parametrize("change", [
    lambda y: y.to(torch.bfloat16), lambda y: y + 1],
    ids=["dtype", "values"])
def test_ct002_identity_violation_fires(monkeypatch, change):
    from repro_torch.comm import dispatch as comm_dispatch

    orig = comm_dispatch.apply
    monkeypatch.setattr(
        comm_dispatch, "apply",
        lambda y, group, spec, policy=None: change(orig(y, group, spec,
                                                        policy)))
    fs = contracts.lint_collectives(specs=["psum"], tps=(1,), device="cpu")
    assert _rules(fs) == {"CT002"}
    assert all("not the identity" in f.message for f in fs)


def _leaky_probe_rank(ctx, shorts):
    """``contracts._probe_rank`` in a rank whose collectives leak bf16."""
    from repro_torch.comm import dispatch as comm_dispatch

    orig = comm_dispatch.apply
    comm_dispatch.apply = (lambda y, group, spec, policy=None:
                           orig(y, group, spec, policy).to(torch.bfloat16))
    return contracts._probe_rank(ctx, shorts)


def test_ct001_dtype_leak_fires_at_tp2(monkeypatch):
    monkeypatch.setattr(contracts, "_probe_rank", _leaky_probe_rank)
    fs = contracts.lint_collectives(specs=["psum"], tps=(2,), device="cpu")
    assert [(f.rule, f.location) for f in fs] == [
        ("CT001", "psum[float32]@tp=2")]
    assert "bfloat16" in fs[0].message


def test_contracts_clean_at_tp1_and_tp2():
    fs = contracts.lint_collectives(tps=(1, 2), device="cpu")
    assert fs == [], [str(f) for f in fs]
    assert len(contracts._default_specs()) >= 8


def _dense_only(monkeypatch):
    cfg = get_smoke_config("qwen3-4b")
    monkeypatch.setattr(contracts, "_family_smoke_cfgs",
                        lambda: {"dense": cfg})


def test_ct003_wrong_cache_geometry_fires(monkeypatch):
    from repro_torch.models import transformer

    _dense_only(monkeypatch)
    monkeypatch.setattr(
        transformer, "init_paged_cache",
        lambda cfg, n, p, bits=None, dtype=torch.bfloat16, device=None,
        tp=1: {"k": torch.zeros((1, n, p, 3, 5), dtype=dtype,
                                device=device)})
    fs = contracts.lint_families(device="cpu")
    assert _rules(fs) == {"CT003"}


def test_ct004_wrong_logits_dtype_fires(monkeypatch):
    from repro_torch.models import transformer

    _dense_only(monkeypatch)
    orig = transformer.forward
    monkeypatch.setattr(
        transformer, "forward",
        lambda *a, **k: orig(*a, **k).to(torch.bfloat16))
    fs = contracts.lint_families(device="cpu")
    assert _rules(fs) == {"CT004"}
    assert "forward logits are torch.bfloat16" in fs[0].message


def test_families_clean():
    fs = contracts.lint_families(device="cpu")
    assert fs == [], [str(f) for f in fs]


# ---------------------------------------------------------------------------
# manifest rules
# ---------------------------------------------------------------------------

def _plan_manifest(entries, default="psum", pairs=("layers.mlp",),
                   tuner=None):
    short = "per-layer:" + ",".join(
        f"{p}={s}" for p, s in entries) + f",*={default}"
    man = {
        "format_version": 1,
        "tp": 2,
        "policy": {"collective": short},
        "pairs": [{"path": p, "stacked": [2]} for p in pairs],
        "collective_plan": {"entries": [list(e) for e in entries],
                            "default": default},
    }
    if tuner is not None:
        man["collective_tuner"] = tuner
    return man


def _tuner(fusable: bool, reason: str = ""):
    return [{"path": "layers.mlp", "kind": "pair", "tp": 2,
             "status": "tuned", "chosen": "quant-int8:128:fused",
             "fused": True, "overlap": False,
             "eligibility": {"fusable": fusable, "reason": reason}}]


def test_mf001_unreachable_glob_fires():
    man = _plan_manifest([("bogus.path", "quant-int8:128"),
                          ("layers.mlp", "psum")])
    assert _rules(manifest_lint.lint_manifest_dict(man)) == {"MF001"}


def test_mf002_shadowed_glob_fires():
    man = _plan_manifest([("*mlp", "quant-int8:128"),
                          ("layers.mlp", "psum")])
    assert _rules(manifest_lint.lint_manifest_dict(man)) == {"MF002"}


def test_mf003_unprovenanced_fused_mark_fires():
    man = _plan_manifest([("layers.mlp", "quant-int8:128:fused")])
    fs = manifest_lint.lint_manifest_dict(man)
    assert _rules(fs) == {"MF003"}
    assert "no tuner record" in fs[0].message


def test_mf003_contradicted_eligibility_fires():
    man = _plan_manifest([("layers.mlp", "quant-int8:128:fused")],
                         tuner=_tuner(False, "K=24 is not a multiple of 256"))
    fs = manifest_lint.lint_manifest_dict(man)
    assert _rules(fs) == {"MF003"}
    assert "not a multiple" in fs[0].message


def test_mf003_recorded_eligibility_passes():
    man = _plan_manifest([("layers.mlp", "quant-int8:128:fused")],
                         tuner=_tuner(True))
    assert manifest_lint.lint_manifest_dict(man) == []


def test_mf006_shorthand_echo_mismatch_fires():
    man = _plan_manifest([("layers.mlp", "psum")])
    man["collective_plan"]["entries"] = [["layers.mlp", "cast:bfloat16"]]
    assert "MF006" in _rules(manifest_lint.lint_manifest_dict(man))


def test_mf006_unparseable_shorthand_fires():
    man = _plan_manifest([("layers.mlp", "psum")])
    man["policy"]["collective"] = "per-layer:*=psum,layers.mlp=cast"
    assert "MF006" in _rules(manifest_lint.lint_manifest_dict(man))


def test_mf005_unconsumed_fold_fires():
    fs = manifest_lint._lint_fold_coverage(
        {"arch_id": "qwen3-4b"},
        {"attn_plans": {"bogus.attn": None}}, location="t")
    assert _rules(fs) == {"MF005"}
    assert fs[0].severity == "error"


def test_mf005_waived_fold_is_info():
    fs = manifest_lint._lint_fold_coverage(
        {"arch_id": "whisper-large-v3"},
        {"attn_plans": {"dec_layers.attn": None,
                        "dec_layers.xattn": None,
                        "enc_layers.attn": None}}, location="t")
    # the consumed path is silent, the two waived paths are info
    assert [f.rule for f in fs] == ["MF005", "MF005"]
    assert {f.severity for f in fs} == {"info"}
    assert not has_errors(fs)


# ---------------------------------------------------------------------------
# artifacts on disk: clean, planted, and the reference's findings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    """The port's qwen3-4b smoke plan at tp=2, tuned, saved."""
    cfg = get_smoke_config("qwen3-4b")
    out = str(tmp_path_factory.mktemp("port") / "plan")
    compiler.prepare(cfg, tp=2, seed=0, device="cpu", autotune=True,
                     extra_manifest={"smoke": True}).save(out)
    return out


@pytest.fixture(scope="module")
def jax_artifact_dir(tmp_path_factory):
    """The reference's prepare of the same plan."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import compiler as jax_compiler

    out = str(tmp_path_factory.mktemp("jax") / "plan")
    jax_compiler.prepare(jax_smoke_config("qwen3-4b"), tp=2, seed=0,
                         autotune=True).save(out)
    return out


def _linked_copy(src: str, dst: str) -> str:
    """``src`` copied to ``dst`` with its ``.npz`` files hard-linked (the
    manifest is a file of its own, so editing it leaves ``src``'s)."""
    def copy(a, b):
        return os.link(a, b) if a.endswith(".npz") else shutil.copy2(a, b)

    shutil.copytree(src, dst, copy_function=copy)
    return dst


def _edit_manifest(dirpath: str, fn) -> None:
    path = os.path.join(dirpath, "manifest.json")
    with open(path) as f:
        man = json.load(f)
    fn(man)
    with open(path, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)


def _add_unreachable_glob(man: dict) -> None:
    """A ``bogus.*`` entry first in the plan, shorthand and echo alike."""
    from repro_torch.comm.spec import CollectivePlan, CollectiveSpec

    plan = CollectivePlan.parse(man["policy"]["collective"])
    plan = CollectivePlan(entries=(("bogus.*", CollectiveSpec()),)
                          + plan.entries, default=plan.default)
    man["policy"]["collective"] = plan.shorthand()
    man["collective_plan"] = {
        "entries": [[p, s.shorthand()] for p, s in plan.entries],
        "default": plan.default.shorthand()}


def _planted(src: str, dst: str) -> str:
    """rank_01 renamed rank_05 and an unreachable glob in the plan."""
    _linked_copy(src, dst)
    os.rename(os.path.join(dst, "rank_01.npz"),
              os.path.join(dst, "rank_05.npz"))
    _edit_manifest(dst, _add_unreachable_glob)
    return dst


def test_clean_artifact_has_zero_findings(artifact_dir):
    assert manifest_lint.lint_artifact(artifact_dir) == []
    assert manifest_lint.run(artifact=None) == []


def test_leaf_shapes_from_the_schema_equal_the_loaded_leaves(
        artifact_dir, jax_artifact_dir, tmp_path):
    """MF004 reads each rank file's leaf shapes from its schema alone
    (``checkpoint.leaf_shapes``): they are the loaded tree's, for both
    packages' files, and a file missing an array of its schema raises."""
    import numpy as np

    from repro_torch.train import checkpoint

    for d in (artifact_dir, jax_artifact_dir):
        for name in ("rank_00.npz", "rank_01.npz"):
            path = os.path.join(d, name)
            assert checkpoint.leaf_shapes(path) == {
                k: tuple(t.shape) for k, t in
                checkpoint.flatten_keys(checkpoint.load(path)).items()}
    with np.load(os.path.join(artifact_dir, "rank_00.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    arrays.pop(sorted(k for k in arrays if k != "__tree__")[0])
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **arrays)
    with pytest.raises(ValueError, match="not both in the file"):
        checkpoint.leaf_shapes(cut)


def test_mf004_missing_and_stray_rank_files_fire(artifact_dir, tmp_path):
    broken = _linked_copy(artifact_dir, str(tmp_path / "broken"))
    os.rename(os.path.join(broken, "rank_01.npz"),
              os.path.join(broken, "rank_05.npz"))
    fs = manifest_lint.lint_artifact(broken)
    msgs = [f.message for f in fs if f.rule == "MF004"]
    assert any("missing rank shard" in m for m in msgs)
    assert any("stray rank shard" in m for m in msgs)


def _naive_fused_artifact(art) -> str:
    """A ':fused' mark whose rank-0 shard cannot take the wire epilogue:
    forged provenance says fusable, but the pair on disk is a
    naive-actorder layout, which has no wire-epilogue kernel."""
    from repro_torch.core import reorder
    from repro_torch.train import checkpoint

    gen = torch.Generator().manual_seed(0)
    w_up = torch.randn(16, 32, generator=gen) * 0.02
    w_down = torch.randn(32, 16, generator=gen) * 0.02
    pp = reorder.plan_pair(w_up, w_down, scheme="naive-actorder",
                           group_size_up=8, group_size_down=8,
                           generator=gen)
    os.makedirs(art)
    tree = {"layers": {"mlp": pp}}
    for r in (0, 1):
        checkpoint.save(os.path.join(art, f"rank_{r:02d}"), tree)
    forged = "quant-int4:12:fused"
    man = {
        "format_version": 1, "tp": 2, "arch_id": "qwen3-4b",
        "policy": {"collective": f"per-layer:layers.mlp={forged},*=psum"},
        "pairs": [{"path": "layers.mlp", "stacked": []}],
        "leaf_shards": {k: None for k in checkpoint.flatten_keys(tree)},
        "collective_plan": {"entries": [["layers.mlp", forged]],
                            "default": "psum"},
        "collective_tuner": [
            {"path": "layers.mlp", "kind": "pair", "tp": 2,
             "status": "tuned", "chosen": forged, "fused": True,
             "overlap": False,
             "eligibility": {"fusable": True, "reason": ""}}],
    }
    with open(os.path.join(art, "manifest.json"), "w") as f:
        json.dump(man, f)
    return art


def test_mf003_on_disk_rederivation_fires(tmp_path):
    fs = manifest_lint.lint_artifact(_naive_fused_artifact(
        str(tmp_path / "plan")))
    assert any(f.rule == "MF003" and "on disk" in f.message
               for f in fs), [str(f) for f in fs]


def test_serve_verify_exits_0_clean_and_1_planted(artifact_dir, tmp_path,
                                                  capsys):
    out = str(tmp_path / "findings.json")
    assert serve.main(["verify", "--artifact", artifact_dir, "--json", out,
                       "--device", "cpu"]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["counts"]["error"] == 0
    assert report["rules_checked"] == sorted(RULES)
    assert f"verify {artifact_dir}: 0 finding(s), 0 error(s)" in (
        capsys.readouterr().out)
    bad = _planted(artifact_dir, str(tmp_path / "planted"))
    assert serve.main(["verify", "--artifact", bad, "--json", out,
                       "--device", "cpu"]) == 1
    with open(out) as f:
        rules = {x["rule"] for x in json.load(f)["findings"]}
    assert rules == {"MF001", "MF004"}


def test_analysis_cli_exits_0_clean_and_1_planted(artifact_dir, tmp_path,
                                                  capsys):
    out = str(tmp_path / "cli.json")
    assert analysis_main(["--artifact", artifact_dir, "--ast",
                          "--json", out]) == 0
    text = capsys.readouterr().out
    assert "ast_lint: 0 finding(s)" in text
    assert "manifest_lint: 0 finding(s)" in text
    bad = _planted(artifact_dir, str(tmp_path / "planted"))
    assert analysis_main(["--artifact", bad]) == 1
    text = capsys.readouterr().out
    assert "[MF004/error]" in text and "[MF001/error]" in text
    with pytest.raises(SystemExit):
        analysis_main([])


def _parity_dirs(src: str, tmp_path, tag: str) -> list:
    """``src`` and planted copies of it: each defect alone, then two."""
    out = [src]

    def copy(name, edit=None, rename=None):
        d = _linked_copy(src, str(tmp_path / f"{tag}-{name}"))
        if rename:
            os.rename(os.path.join(d, rename[0]), os.path.join(d, rename[1]))
        if edit:
            _edit_manifest(d, edit)
        out.append(d)

    def shadow(man):
        man["policy"]["collective"] = man["policy"]["collective"].replace(
            "per-layer:", "per-layer:*mlp=psum,")
        man["collective_plan"]["entries"].insert(0, ["*mlp", "psum"])

    def echo(man):
        man["collective_plan"]["default"] = "cast:bfloat16"

    def strip_tuner(man):
        del man["collective_tuner"]

    def tp3(man):
        man["tp"] = 3

    copy("stray", rename=("rank_01.npz", "rank_05.npz"))
    copy("glob", edit=_add_unreachable_glob)
    copy("shadow", edit=shadow)
    copy("echo", edit=echo)
    copy("tuner", edit=strip_tuner)
    copy("tp3", edit=tp3)
    copy("both", edit=_add_unreachable_glob,
         rename=("rank_01.npz", "rank_05.npz"))
    return out


def test_manifest_findings_equal_the_references(artifact_dir,
                                                jax_artifact_dir, tmp_path):
    """The port's ``lint_artifact`` against the reference's on the same
    directories: both packages' clean artifacts, each planted defect
    (stray and missing rank files, unreachable and shadowed globs, a
    mismatched echo, a fused mark without its tuner record, a wrong TP
    degree, two defects at once), the forged fused mark on a naive layout
    and an unconsumed fold in ``aux.npz``."""
    from repro.analysis import manifest_lint as jax_manifest_lint

    from repro_torch.train import checkpoint

    dirs = (_parity_dirs(artifact_dir, tmp_path, "port")
            + _parity_dirs(jax_artifact_dir, tmp_path, "jax"))
    dirs.append(_naive_fused_artifact(str(tmp_path / "naive")))
    fold = _linked_copy(artifact_dir, str(tmp_path / "fold"))
    pair = checkpoint.load(os.path.join(fold, "rank_00.npz"))["layers"][
        "mlp"]
    checkpoint.save(os.path.join(fold, "aux.npz"),
                    {"attn_plans": {"bogus.attn": pair}})
    dirs.append(fold)
    seen = set()
    for d in dirs:
        got = manifest_lint.lint_artifact(d)
        want = jax_manifest_lint.lint_artifact(d)
        assert _keys(got) == _keys(want), (d, [str(f) for f in got],
                                           [str(f) for f in want])
        seen |= _rules(got)
    assert seen == {"MF001", "MF002", "MF003", "MF004", "MF005", "MF006"}
