"""The port's deployment artifact (``plan/artifact.py``, ``dist/loader.py``,
``train/checkpoint.py``, ``compiler.prepare``) against the reference's, on
the qwen3-4b smoke model, on the CPU.

* Artifacts JAX prepares (tp 1 and 2) load into the port leaf for leaf
  bit-equal to JAX's own load, and ``params()`` reassembles bit-equal.
* The port's config hash is the manifest's; its manifest is JAX's.
* ``validate`` refuses every mismatch, and what the port cannot serve,
  with ``PlanMismatchError``; the backend names map both ways and are not
  compared.
* An artifact the port prepares: rank r is ``Model.init(seed, tp, r)``
  bit for bit, JAX loads and validates it bit-equal, and a rank reads
  only its own file.
* The port serving a JAX artifact against JAX serving it: greedy ids
  equal, decode logits within 5e-3 of max|logit|
  (``tests/test_torch_model.py``'s bound; decode against decode only,
  ROADMAP caveat b).
* The CLI's ``prepare`` then ``--artifact``, at tp 1 and at tp 2 over
  gloo, gives the in-memory serve's ids.

JAX is imported inside the tests that run it, so the ``gpu`` test runs on
a machine without JAX (``python -m pytest -q -m gpu
tests/test_torch_artifact.py``)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.quantization import QuantizedLinear
from repro_torch.dist import loader
from repro_torch.models.registry import build_model
from repro_torch.plan import artifact as part
from repro_torch.plan import compiler
from repro_torch.plan.artifact import DeploymentArtifact, PlanMismatchError
from repro_torch.runtime.serve import make_engine
from repro_torch.train import checkpoint

CPU = torch.device("cpu")
REL_TOL = 5e-3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: the reference's manifest hashes of the qwen3-4b configs (smoke, full)
SMOKE_HASH, FULL_HASH = "37096233ba494f03", "a6da8cf8305ffe04"


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


def _jax_prepare(tp: int, out: str, collective: str = "psum") -> str:
    """What ``repro.launch.serve prepare --smoke --tp tp --collective
    collective`` writes."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.plan import compiler as jax_compiler

    cfg = jax_smoke_config("qwen3-4b").with_quant(collective=collective)
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=tp))
    return jax_compiler.prepare(cfg, tp=tp, seed=0, policy=policy,
                                extra_manifest={"smoke": True}).save(out)


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """{tp: directory} of artifacts the reference prepared from seed 0."""
    return {tp: _jax_prepare(tp, str(tmp_path_factory.mktemp(f"jax{tp}")))
            for tp in (1, 2)}


@pytest.fixture(scope="module")
def port_artifact(tmp_path_factory):
    """(artifact, directory): the port's prepare at tp 2, saved."""
    cfg = get_smoke_config("qwen3-4b")
    art = compiler.prepare(cfg, tp=2, seed=0, device="cpu",
                           extra_manifest={"smoke": True})
    return art, art.save(str(tmp_path_factory.mktemp("port2")))


def _reference_leaves(tree) -> dict:
    """{key: numpy} of a port tree in the reference's stacked layout, the
    packed words as the reference's uint32."""
    out = {}
    stacked = interop.to_reference_layout(tree)
    for key, t in checkpoint.flatten_keys(stacked).items():
        arr = t.numpy()
        out[key] = arr.view(np.uint32) if key.endswith("qweight") else arr
    return out


def _assert_matches_jax(port_tree, jax_tree):
    """Every leaf of the port's tree equals the JAX tree's, bit for bit,
    with the same dtype, and neither has a leaf the other lacks."""
    from repro.train import checkpoint as jax_checkpoint

    want = {k: np.asarray(v)
            for k, v in jax_checkpoint.flatten_keys(jax_tree).items()}
    got = _reference_leaves(port_tree)
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype, key
        np.testing.assert_array_equal(got[key], ref, err_msg=key)


def _assert_trees_equal(a, b):
    fa, fb = checkpoint.flatten_keys(a), checkpoint.flatten_keys(b)
    assert list(fa) == list(fb)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        assert torch.equal(fa[key], fb[key]), key


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_jax_reads_it(tmp_path):
    """port -> file -> port is bit-equal for every node kind; packed
    words are written as uint32, and the reference reads the file with
    every leaf bit-equal."""
    from repro.train import checkpoint as jax_checkpoint

    gen = torch.Generator().manual_seed(0)
    ql = QuantizedLinear(
        qweight=torch.randint(-2**31, 2**31 - 1, (4, 6), generator=gen,
                              dtype=torch.int32),
        scales=torch.rand(2, 6, generator=gen), zeros=torch.rand(2, 6),
        g_idx=None, group_size=16, kind="ordered")
    tree = {"w": torch.randn(3, 5, generator=gen), "q": ql,
            "seq": [torch.arange(4, dtype=torch.int32), None],
            "pair": (torch.ones(2), torch.zeros(1, dtype=torch.int32))}
    path = checkpoint.save(str(tmp_path / "t"), tree)
    assert path.endswith(".npz")
    with np.load(path) as data:
        assert data["q||qweight"].dtype == np.uint32
    _assert_trees_equal(checkpoint.load(path), tree)
    ref = jax_checkpoint.load(path)
    assert isinstance(ref["seq"], list) and ref["seq"][1] is None
    assert isinstance(ref["pair"], tuple)
    assert ref["q"].group_size == 16 and ref["q"].kind == "ordered"
    for key, t in checkpoint.flatten_keys(tree).items():
        got = np.asarray(jax_checkpoint.flatten_keys(ref)[key])
        want = t.numpy()
        if key == "q||qweight":
            want = want.view(np.uint32)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_checkpoint_bfloat16_as_the_reference_writes_it(tmp_path):
    """bfloat16 goes to disk as 2-byte void, the bytes the reference's
    ``save`` writes for the same values, and comes back bit-equal from
    either package's file.  (The reference cannot read bfloat16 leaves
    back itself: ``jnp.asarray`` has no cast from void.)"""
    import jax.numpy as jnp
    from repro.train import checkpoint as jax_checkpoint

    t = torch.randn(3, 4).to(torch.bfloat16)
    mine = checkpoint.save(str(tmp_path / "port"), {"a": t})
    theirs = jax_checkpoint.save(
        str(tmp_path / "jax"),
        {"a": jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)})
    with np.load(mine) as a, np.load(theirs) as b:
        assert a["a"].dtype == b["a"].dtype == np.dtype("V2")
        assert a["a"].tobytes() == b["a"].tobytes()
    for path in (mine, theirs):
        got = checkpoint.load(path)["a"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, t)


# ---------------------------------------------------------------------------
# (a) a JAX artifact, loaded by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_port_loads_jax_artifact_bit_equal(jax_artifacts, tp):
    from repro.plan import DeploymentArtifact as JaxArtifact

    ref = JaxArtifact.load(jax_artifacts[tp])
    art = DeploymentArtifact.load(jax_artifacts[tp], device="cpu")
    assert art.tp == tp and art.manifest == ref.manifest
    assert len(art.rank_params) == tp
    assert len(art.rank_tree(0)["layers"]) == 2
    for r in range(tp):
        _assert_matches_jax(art.rank_tree(r), ref.rank_tree(r))
    _assert_matches_jax(art.params(), ref.params())


# ---------------------------------------------------------------------------
# (b) the config hash; the manifest
# ---------------------------------------------------------------------------

def test_config_hash_is_the_manifests(jax_artifacts):
    from repro.configs import get_config as jax_config
    from repro.plan.artifact import config_hash as jax_hash

    manifest = DeploymentArtifact.load_manifest(jax_artifacts[1])
    assert part.config_hash(get_smoke_config("qwen3-4b")) == \
        manifest["config_hash"] == SMOKE_HASH
    assert part.config_hash(get_config("qwen3-4b")) == FULL_HASH == \
        jax_hash(jax_config("qwen3-4b"))


PER_LAYER = "per-layer:*.mlp=quant-int8:64:fused,*=psum"


@pytest.mark.parametrize("collective", ["psum", PER_LAYER])
def test_port_manifest_is_the_references(jax_artifacts, port_artifact,
                                         tmp_path, collective):
    """The same plan prepared by either package: the same manifest; a
    per-layer collective plan is echoed under ``collective_plan``, and the
    port serves JAX's as it resolves it in memory."""
    if collective == "psum":
        art, _ = port_artifact
        ref_dir = jax_artifacts[2]
    else:
        cfg = get_smoke_config("qwen3-4b").with_quant(collective=collective)
        art = compiler.prepare(cfg, tp=2, seed=0, device="cpu",
                               extra_manifest={"smoke": True})
        ref_dir = _jax_prepare(2, str(tmp_path / "jax"), collective)
        ref = DeploymentArtifact.load(ref_dir, device="cpu")
        assert ref.manifest["collective_plan"] == {
            "entries": [["*.mlp", "quant-int8:64:fused"]], "default": "psum"}
        policy = ref.policy()
        assert policy.collective.resolve("layers.mlp").shorthand() == \
            "quant-int8:64:fused"
        ref.validate(cfg=cfg, policy=policy, tp=2)
    assert art.manifest == DeploymentArtifact.load_manifest(ref_dir)


def test_leaf_shards_convert_between_layouts(jax_artifacts):
    """``shard_params`` records per-layer keys and dims; the manifest's are
    the stacked tree's (dim + 1 under ``layers``), and ``layer_dim`` turns
    them back."""
    cfg = get_smoke_config("qwen3-4b")
    params = build_model(cfg).init(0, device="cpu")
    _, per_layer = compiler.shard_params(cfg, params, 2)
    assert per_layer["layers||1||attn||wq"] == 1
    assert per_layer["layers||0||mlp||p1_up"] is None
    stacked = part.stacked_shards(per_layer)
    assert stacked == DeploymentArtifact.load_manifest(
        jax_artifacts[2])["leaf_shards"]
    assert stacked["layers||attn||wq"] == 2 and \
        stacked["embed||lm_head"] == 1
    assert {k: part.layer_dim(stacked, k) for k in per_layer} == per_layer
    with pytest.raises(ValueError, match="different dims"):
        part.stacked_shards({"layers||0||attn||wq": 1,
                             "layers||1||attn||wq": 0})


# ---------------------------------------------------------------------------
# (c) the backend mapping and validate's refusals
# ---------------------------------------------------------------------------

def test_backend_names_map_both_ways(jax_artifacts):
    """The manifest names the reference's backends; ``policy()`` turns
    them back into the port's, or applies the port's own rule, and
    ``validate`` does not refuse on the backend."""
    cfg = get_smoke_config("qwen3-4b")
    for port, ref in (("torch", "jnp"), ("cuda", "pallas"), ("ref", "ref")):
        pol = ExecutionPolicy(backend=port)
        assert part.policy_fields(pol)["backend"] == ref
        art = DeploymentArtifact(manifest={
            "tp": 1, "policy": part.policy_fields(pol)})
        assert art.policy().backend == port
    art = DeploymentArtifact.load(jax_artifacts[1], device="cpu")
    assert art.manifest["policy"]["backend"] == "jnp"
    assert art.policy().backend == "torch"
    assert art.policy(backend="auto", device=CPU).backend == "torch"
    on_card = art.policy(backend="auto", device=torch.device("cuda"))
    assert on_card.backend == "cuda"
    for pol in (on_card, art.policy(backend="ref")):
        art.validate(cfg=cfg, policy=pol, tp=1)
    naive = DeploymentArtifact(manifest=dict(art.manifest, policy=dict(
        art.manifest["policy"], scheme="naive-actorder")))
    assert naive.policy(backend="auto",
                        device=torch.device("cuda")).backend == "torch"


def _refusal(case, dirs, tmp_path):
    """(artifact, validate kwargs) of one refusal case."""
    cfg = get_smoke_config("qwen3-4b")
    if case in ("format_version", "aux", "null_leaf"):
        src = dirs[2 if case == "null_leaf" else 1]
        dst = str(tmp_path / case)
        shutil.copytree(src, dst)
        mpath = os.path.join(dst, part.MANIFEST)
        with open(mpath) as f:
            manifest = json.load(f)
        if case == "format_version":
            manifest["format_version"] = 2
        if case == "null_leaf":
            manifest["leaf_shards"]["layers||attn||wq"] = None
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        if case == "aux":
            checkpoint.save(os.path.join(dst, "aux"), {"x": torch.ones(1)})
        return (lambda: DeploymentArtifact.load(dst, device="cpu")), {
            "cfg": cfg}
    art = DeploymentArtifact.load(dirs[1], device="cpu")
    pol = art.policy()
    kw = {"arch": {"cfg": cfg.with_(arch_id="granite-3-8b")},
          "hash": {"cfg": cfg.with_(rope_theta=10_000.0)},
          "scheme": {"policy": pol.with_(scheme="exllama")},
          "collective": {"policy": pol.with_(collective="quant-int8")},
          "tp": {"tp": 2}}[case]
    return (lambda: art), kw


@pytest.mark.parametrize("case,match", [
    ("arch", "compiled for 'qwen3-4b'"),
    ("hash", "config hash"),
    ("scheme", "policy .* != artifact's plan"),
    ("collective", "policy .* != artifact's plan"),
    ("tp", "2 TP rank"),
    ("format_version", "format v2"),
    ("aux", "aux.npz .*cannot serve"),
    ("null_leaf", "layers\\|\\|attn\\|\\|wq"),
])
def test_validate_refuses(jax_artifacts, tmp_path, case, match):
    load, kw = _refusal(case, jax_artifacts, tmp_path)
    with pytest.raises(PlanMismatchError, match=match):
        load().validate(**kw)


def test_engine_refuses_before_reading_rank_files(jax_artifacts, monkeypatch):
    """``make_engine`` checks the manifest before it opens a rank file."""
    opened = []
    monkeypatch.setattr(checkpoint, "load",
                        lambda path: opened.append(path))
    with pytest.raises(PlanMismatchError, match="config hash"):
        make_engine(get_smoke_config("qwen3-4b").with_quant(group_size=32),
                    device="cpu", artifact=jax_artifacts[1])
    assert opened == []


# ---------------------------------------------------------------------------
# (d) an artifact the port prepares
# ---------------------------------------------------------------------------

def test_port_prepare_is_model_init(port_artifact):
    """Rank r of the port's prepare is ``Model.init(seed, tp=2, rank=r)``
    bit for bit (the same seed means the same plan), and comes back from
    its file bit-equal."""
    art, path = port_artifact
    model = build_model(get_smoke_config("qwen3-4b"))
    loaded = DeploymentArtifact.load(path, device="cpu")
    for r in range(2):
        want = model.init(0, device="cpu", tp=2, rank=r)
        _assert_trees_equal(art.rank_tree(r), want)
        _assert_trees_equal(loaded.rank_tree(r), want)
    _assert_trees_equal(loaded.params(), model.init(0, device="cpu"))


def test_jax_loads_and_validates_port_artifact(port_artifact):
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.plan import DeploymentArtifact as JaxArtifact

    art, path = port_artifact
    ref = JaxArtifact.load(path)
    cfg = jax_smoke_config("qwen3-4b").with_quant(**ref.manifest["quant"])
    assert ref.validate(cfg=cfg, policy=ref.policy(), tp=2) is ref
    for r in range(2):
        _assert_matches_jax(art.rank_tree(r), ref.rank_tree(r))
    _assert_matches_jax(art.params(), ref.params())


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_reads_only_its_own_file(port_artifact, monkeypatch, rank):
    art, path = port_artifact
    opened = []
    load = checkpoint.load

    def spy(p):
        opened.append(os.path.basename(p))
        return load(p)

    monkeypatch.setattr(checkpoint, "load", spy)
    tree, stats = loader.load_per_rank(
        path, DeploymentArtifact.load_manifest(path), rank, device="cpu")
    assert opened == [f"rank_{rank:02d}.npz"]
    assert stats.ranks == (rank,)
    assert stats.file_bytes_loaded == os.path.getsize(
        loader.rank_file(path, rank))
    assert stats.file_bytes_loaded < stats.file_bytes_total
    assert 0.4 < stats.resident_fraction < 0.6
    _assert_trees_equal(tree, art.rank_tree(rank))
    one = DeploymentArtifact.load_rank(path, rank, device="cpu")
    assert one.rank_params[1 - rank] is None and one.load_stats == stats
    with pytest.raises(ValueError, match="was not loaded"):
        one.rank_tree(1 - rank)
    with pytest.raises(ValueError, match="one rank"):
        one.save(path)


# ---------------------------------------------------------------------------
# (e) the port serving a JAX artifact, against JAX serving it
# ---------------------------------------------------------------------------

def test_port_serves_jax_artifact_like_jax(jax_artifacts):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.runtime.serve import make_engine as jax_make_engine

    path = jax_artifacts[1]
    manifest = DeploymentArtifact.load_manifest(path)
    jeng = jax_make_engine(
        jax_smoke_config("qwen3-4b").with_quant(**manifest["quant"]),
        jax.random.PRNGKey(0), max_seq=24, artifact=path)
    teng = make_engine(get_smoke_config("qwen3-4b").with_quant(
        **manifest["quant"]), device="cpu", max_seq=24, artifact=path)
    assert teng.policy.backend == "torch" and teng.load_stats is None

    rng = np.random.default_rng(3)
    toks = rng.integers(0, 512, (4, 8)).astype(np.int32)
    plen = np.array([8, 5, 7, 6], np.int32)
    ref = np.asarray(jeng.generate(jax.random.PRNGKey(0),
                                   {"tokens": jnp.asarray(toks)},
                                   jnp.asarray(plen), max_new_tokens=8))
    got = teng.generate(None, torch.from_numpy(toks).long(),
                        torch.from_numpy(plen), max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, ref)

    jcache, tcache = jeng.init_cache(3), teng.init_cache(3)
    for t in range(8):
        tok = rng.integers(0, 512, 3).astype(np.int32)
        want, jcache = jeng._decode(jeng.params, jcache, jnp.asarray(tok), t)
        have, tcache = teng.decode(tcache, torch.from_numpy(tok).long(), t)
        want = np.asarray(want)
        assert np.abs(have.numpy() - want).max() <= \
            REL_TOL * np.abs(want).max(), t


# ---------------------------------------------------------------------------
# (f) the CLI: prepare, then --artifact
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _ids(out: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith("req ")]


@pytest.mark.parametrize("tp", [1, 2])
def test_cli_prepare_then_serve_artifact(tmp_path, tp):
    """``prepare`` then ``--artifact`` (the TP degree from the manifest)
    emits the in-memory serve's ids; at tp 2 each rank read only its own
    file."""
    out = str(tmp_path / "plan")
    plan = ["--smoke", "--collective", "quant-int8:fused"] if tp > 1 else \
        ["--smoke"]
    done = _cli("prepare", *plan, "--tp", str(tp), "--out", out,
                "--device", "cpu")
    assert f"tp={tp}) -> {out}" in done
    serve = ["--device", "cpu", "--requests", "2", "--max-new", "4"]
    got = _cli("--artifact", out, *serve)
    want = _cli(*plan, "--tp", str(tp), *serve)
    assert len(_ids(got)) == 2 and _ids(got) == _ids(want)
    assert f"artifact={out}]" in got and "in-memory plan]" in want
    resident = [ln for ln in got.splitlines() if "resident_artifact" in ln]
    assert len(resident) == (tp if tp > 1 else 0)
    for r, ln in enumerate(resident):
        loaded, total = map(int, ln.split("=")[1].split()[0].split("/"))
        assert ln.startswith(f"rank {r}: ") and loaded < total


def test_cli_refuses_artifact_at_another_tp(tmp_path):
    out = str(tmp_path / "plan")
    _cli("prepare", "--smoke", "--out", out, "--device", "cpu")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--artifact", out,
         "--tp", "2", "--device", "cpu", "--requests", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "PlanMismatchError" in proc.stderr and "re-run prepare" in \
        proc.stderr


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_card_artifact_serves_bit_equal(tmp_path):
    """On the card: prepared on the card, saved, served from the files
    through the captured step, the greedy logits equal the in-memory
    engine's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3-4b")
    path = compiler.prepare(cfg, tp=1, seed=0, device="cuda").save(
        str(tmp_path / "plan"))
    mem = make_engine(cfg, 0, device="cuda", max_seq=24)
    disk = make_engine(cfg, device="cuda", max_seq=24, artifact=path)
    assert disk.policy == mem.policy and disk.policy.backend == "cuda"
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 2))).cuda()
    caches = mem.init_cache(2), disk.init_cache(2)
    for t, tok in enumerate(toks):
        want, _ = mem.decode(caches[0], tok, t)
        got, _ = disk.decode(caches[1], tok, t)
        assert torch.equal(got, want), t
    assert disk.captures == 1
