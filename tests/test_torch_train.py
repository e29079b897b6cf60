"""Port parity of the training path (``repro_torch/train``,
``launch/train.py``) on the CPU, at smoke size.

* The reference's own ``tests/test_train.py`` cases on the port: the
  AdamW first step, clipping, the cosine schedule, cross-entropy, the
  data pipeline's shapes, determinism and file stream.
* The port's synthetic and file streams give the reference's tokens bit
  for bit for the same seed.
* AdamW against the reference's ``apply_updates`` on the same params
  and gradients; a leaf with no gradient updates as with a zero one, a
  zero-size leaf passes through.
* Three steps of qwen3-4b smoke in float32 against the reference's
  jitted ``make_train_step`` from the same params: the metrics, and the
  params within 1e-6 of max|ref| but where AdamW's direction
  ``m / (sqrt(v) + eps)`` is ill-conditioned (see
  ``test_three_steps_follow_the_reference``); ten steps' losses within
  1e-4 relative, falling.
* The MoE load-balance loss within 1e-6 of ``moe_forward(return_aux=
  True)``.
* Checkpoints: ``save(step=)`` naming, ``latest``, ``restore`` (either
  layout, its errors), the port trainer's file read by the reference's
  ``load`` bit for bit and the reference trainer's by the port's
  ``restore``.
* ``param_count`` and ``active_param_count`` equal the reference's.
* The CLI in-process: the reference's lines, ``--tp 2`` exits 1, no card
  without ``--device cpu``.

Gradients of every smoke config against ``jax.value_and_grad``:
``tests/test_torch_train_archs.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.launch import train as train_cli
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint, data as data_lib, optimizer as opt
from repro_torch.train import trainstep

CPU = torch.device("cpu")
F32_ULP = 2.0 ** -23


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's tests (as the other heavy
    port test files): the smoke models' ops are tiny, and one thread does
    not spin against the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# the reference's test_train.py cases, on the port
# ---------------------------------------------------------------------------

def test_adamw_first_step_matches_reference():
    """After one step from a zero state, AdamW moves by -lr * sign(g)."""
    ocfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=None,
                           warmup_steps=0, total_steps=10**9)
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, -0.25])}
    state = opt.init_state(params)
    new_params, new_state, _ = opt.apply_updates(ocfg, params, grads,
                                                 state)
    np.testing.assert_allclose(_np(new_params["w"]), [1.0 - 0.1, -2.0 + 0.1],
                               rtol=1e-4)
    assert int(new_state["step"]) == 1
    assert new_params is params            # in place


def test_grad_clipping():
    ocfg = opt.AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    g = {"w": torch.full((4,), 100.0)}
    norm = float(opt.global_norm(g))
    assert norm > 1.0
    params = {"w": torch.zeros(4)}
    state = opt.init_state(params)
    _, st2, gn = opt.apply_updates(ocfg, params, g, state)
    assert float(gn) == norm               # the norm before the clip
    # m after the clip: (1 - b1) * g_clipped, |g_clipped| = 1
    m = _np(st2["m"]["w"])
    np.testing.assert_allclose(np.linalg.norm(m / 0.1), 1.0, rtol=1e-4)


def test_cosine_schedule_shape():
    ocfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                           min_lr_frac=0.1)
    lrs = [float(opt.cosine_lr(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 60, 110, 200)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6          # mid-warmup
    assert abs(lrs[2] - 1.0) < 1e-6          # peak
    assert 0.1 < lrs[3] < 1.0                # decaying
    assert abs(lrs[4] - 0.1) < 1e-6          # floor
    assert abs(lrs[5] - 0.1) < 1e-6          # clamped past the end


def test_cosine_schedule_equals_the_references():
    """Every step of a schedule within 2 float32 ulps of the reference's
    (``cos`` and the float32 ops are each the library's own)."""
    from repro.train import optimizer as jopt

    for kw in ({"warmup_steps": 5, "total_steps": 40},
               {"warmup_steps": 1, "total_steps": 8, "lr": 1e-3}):
        steps = np.arange(0, 50, dtype=np.int32)
        got = _np(opt.cosine_lr(opt.AdamWConfig(**kw), torch.from_numpy(steps)))
        want = np.asarray(jopt.cosine_lr(jopt.AdamWConfig(**kw),
                                         jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=2 * F32_ULP, atol=0)


def test_cross_entropy_matches_manual():
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 4, 8)).astype(np.float32))
    labels = torch.tensor([[1, 2, 3, 4], [0, 7, -1, 2]])
    got = trainstep.cross_entropy(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    want, n = 0.0, 0
    for b in range(2):
        for t in range(4):
            if int(labels[b, t]) != -1:
                want -= float(logp[b, t, int(labels[b, t])])
                n += 1
    np.testing.assert_allclose(float(got), want / n, rtol=1e-5)
    from repro.train import trainstep as jts
    ref = jts.cross_entropy(jnp.asarray(_np(logits)), jnp.asarray(_np(labels)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_data_pipeline_shapes_and_determinism():
    dcfg = data_lib.DataConfig(seq_len=16, global_batch=4, vocab_size=97,
                               seed=3)
    a = next(data_lib.batches(dcfg, device="cpu"))
    b = next(data_lib.batches(dcfg, device="cpu"))
    assert a["tokens"].shape == (4, 16) and a["labels"].shape == (4, 16)
    assert a["tokens"].device == CPU
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].max()) < 97


def test_file_backed_data(tmp_path):
    toks = np.arange(1000, dtype=np.uint16) % 50
    f = tmp_path / "corpus.bin"
    toks.tofile(str(f))
    dcfg = data_lib.DataConfig(seq_len=8, global_batch=2, vocab_size=50,
                               path=str(f))
    batch = next(data_lib.batches(dcfg, device="cpu"))
    t, lab = _np(batch["tokens"]), _np(batch["labels"])
    np.testing.assert_array_equal(t[:, 1:], lab[:, :-1])   # shifted by one
    short = tmp_path / "short.bin"
    toks[:5].tofile(str(short))
    with pytest.raises(ValueError, match="too small"):
        next(data_lib.batches(data_lib.DataConfig(
            seq_len=8, global_batch=2, vocab_size=50, path=str(short)),
            device="cpu"))


def test_batches_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        next(data_lib.batches(data_lib.DataConfig(
            seq_len=4, global_batch=1, vocab_size=11)))


# ---------------------------------------------------------------------------
# the streams and AdamW against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab", [(0, 512), (3, 97), (7, 151936)])
def test_synthetic_stream_bit_equal_to_the_references(seed, vocab):
    from repro.train import data as jdata

    kw = dict(seq_len=24, global_batch=3, vocab_size=vocab, seed=seed)
    ours = data_lib.batches(data_lib.DataConfig(**kw), device="cpu")
    ref = jdata.batches(jdata.DataConfig(**kw))
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(_np(a[k]), np.asarray(b[k]))


def test_file_stream_bit_equal_to_the_references(tmp_path):
    from repro.train import data as jdata

    f = tmp_path / "corpus.bin"
    np.random.default_rng(1).integers(0, 60000, 5000).astype(
        np.uint16).tofile(str(f))
    kw = dict(seq_len=16, global_batch=4, vocab_size=60000, seed=5,
              path=str(f))
    ours = data_lib.batches(data_lib.DataConfig(**kw), device="cpu")
    ref = jdata.batches(jdata.DataConfig(**kw))
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(_np(a[k]), np.asarray(b[k]))


def _random_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((8, 16)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32),
                  "d": (rng.standard_normal((3, 4, 2)) * scale).astype(
                      np.float32)}}


@pytest.mark.parametrize("clip", [1.0, None])
def test_apply_updates_equals_the_references(clip):
    """Four steps on the same params and gradients: params, m and v
    within 2 float32 ulps of the reference's (relative to each leaf's
    max), step equal."""
    from repro.train import checkpoint as jck
    from repro.train import optimizer as jopt

    def port(tree):
        return checkpoint.map_tensors(
            {"a": tree["a"], "b": dict(tree["b"])}, lambda _, t: t)

    rng = np.random.default_rng(0)
    p0 = _random_tree(rng)
    ocfg = dict(lr=1e-2, clip_norm=clip, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = jopt.init_state(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    tst = opt.init_state(tp)
    for _ in range(4):
        g = _random_tree(rng, scale=3.0)
        jp, jst = jopt.apply_updates(jopt.AdamWConfig(**ocfg), jp,
                                     jax.tree.map(jnp.asarray, g), jst)
        opt.apply_updates(opt.AdamWConfig(**ocfg), tp,
                          jax.tree.map(torch.from_numpy, g), tst)
    assert int(tst["step"]) == int(jst["step"]) == 4
    for ours, ref in ((tp, jp), (tst["m"], jst["m"]), (tst["v"], jst["v"])):
        want = jck.flatten_keys(ref)
        got = checkpoint.flatten_keys(port(ours))
        assert set(got) == set(want)
        for key, leaf in got.items():
            w = np.asarray(want[key])
            np.testing.assert_allclose(
                _np(leaf), w, rtol=0,
                atol=2 * F32_ULP * float(np.abs(w).max()))


def test_missing_and_empty_gradients():
    """A leaf whose gradient is None updates as with a zero gradient (JAX's
    grad of an unused leaf); a zero-size leaf passes through."""
    ocfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones(3), "u": torch.full((2,), 2.0),
              "e": torch.zeros((0, 4))}
    zeros = {"w": torch.ones(3), "u": torch.full((2,), 2.0),
             "e": torch.zeros((0, 4))}
    state_a, state_b = opt.init_state(params), opt.init_state(zeros)
    opt.apply_updates(ocfg, params, {"w": torch.tensor([0.5, -1.0, 2.0]),
                                     "u": None, "e": None}, state_a)
    opt.apply_updates(ocfg, zeros, {"w": torch.tensor([0.5, -1.0, 2.0]),
                                    "u": torch.zeros(2),
                                    "e": torch.zeros((0, 4))}, state_b)
    for k in params:
        assert torch.equal(params[k], zeros[k]), k
    # weight decay alone moved u
    assert float(params["u"][0]) < 2.0
    assert params["e"].shape == (0, 4)


# ---------------------------------------------------------------------------
# train steps against the reference's jitted step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_f32(tmp_path_factory):
    """qwen3-4b smoke, dense, float32 carry: the reference's model and
    params, and a function that carries them into fresh port params."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jck

    jcfg = jax_smoke_config("qwen3-4b").with_quant(mode="none").with_(
        dtype="float32")
    jmodel = jax_build_model(jcfg)
    jp = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    path = jck.save(str(tmp_path_factory.mktemp("qwen") / "p.npz"), jp)
    model = build_model(get_smoke_config("qwen3-4b").with_quant(
        mode="none").with_(dtype="float32"))

    def carried():
        return trainstep.trainable(interop.load_params(path, device=CPU))

    return jmodel, jp, model, carried


def _run_both(qwen_f32, steps: int, lr: float = 1e-3):
    """``steps`` train steps of the reference (jitted) and of the port
    from the same params on the same synthetic batches."""
    from repro.models.common import REPLICATED
    from repro.train import data as jdata, optimizer as jopt
    from repro.train import trainstep as jts

    jmodel, jp, model, carried = qwen_f32
    kw = dict(lr=lr, total_steps=30, warmup_steps=2)
    jstep = jax.jit(jts.make_train_step(jmodel, REPLICATED,
                                        jopt.AdamWConfig(**kw)))
    tstep = trainstep.make_train_step(model, opt.AdamWConfig(**kw))
    jstate = {"params": jp, "opt": jopt.init_state(jp)}
    params = carried()
    tstate = {"params": params, "opt": opt.init_state(params)}
    dkw = dict(seq_len=32, global_batch=4, vocab_size=model.cfg.vocab_size)
    jit_ = jdata.batches(jdata.DataConfig(**dkw))
    tit = data_lib.batches(data_lib.DataConfig(**dkw), device=CPU)
    metrics = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, next(jit_))
        tstate, tm = tstep(tstate, next(tit))
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    return jstate, tstate, metrics


def _param_gaps(jparams, tparams):
    """(element count, |port - ref| per element, max|ref|) over the tree
    in the reference's layout."""
    from repro.train import checkpoint as jck

    ref = jck.flatten_keys(jparams)
    ours = checkpoint.flatten_keys(interop.to_reference_layout(
        checkpoint.map_tensors(tparams, lambda _, t: t.detach())))
    assert set(ref) == set(ours)
    gaps = {k: np.abs(_np(ours[k]) - np.asarray(ref[k])) for k in ref}
    return (sum(g.size for g in gaps.values()), gaps,
            max(float(np.abs(np.asarray(v)).max()) for v in ref.values()))


def test_three_steps_follow_the_reference(qwen_f32):
    """Three AdamW steps of qwen3-4b smoke (float32): loss and grad_norm
    within 1e-6 relative, lr within 2 float32 ulps, step equal.  The
    params are within 1e-6 of max|ref| at all but a few elements: AdamW's
    direction ``m / (sqrt(v) + eps)`` at an element whose gradient is
    near zero (below the float32 agreement of the two gradients) is ill
    conditioned, so the two can step it apart.  The first step shows it:
    every element outside the bound has a reference gradient within
    1e-4 of its leaf's max|grad| of zero (the gradient tolerance of
    ``tests/test_torch_train_archs.py``).  Over three steps such
    elements stay under 1e-4 of the tree (20 of 1.44M measured), each
    within the steps' summed lr."""
    from repro.models.common import REPLICATED
    from repro.train import data as jdata, trainstep as jts
    from repro.train import checkpoint as jck

    jstate, tstate, metrics = _run_both(qwen_f32, 3)
    for ref, ours in metrics:
        assert ours["step"] == ref["step"]
        for k in ("loss", "grad_norm"):
            assert abs(ours[k] - ref[k]) <= 1e-6 * abs(ref[k]), (k, ours, ref)
        assert abs(ours["lr"] - ref["lr"]) <= 2 * F32_ULP * ref["lr"]
    n, gaps, pmax = _param_gaps(jstate["params"], tstate["params"])
    outside = sum(int((g > 1e-6 * pmax).sum()) for g in gaps.values())
    assert outside <= 1e-4 * n, (outside, n)
    lr_sum = sum(ref["lr"] for ref, _ in metrics)
    assert max(float(g.max()) for g in gaps.values()) <= lr_sum

    # the first step: outside the bound only where the gradient is ~0
    jstate1, tstate1, _ = _run_both(qwen_f32, 1)
    jmodel, jp, _, _ = qwen_f32
    batch = next(jdata.batches(jdata.DataConfig(
        seq_len=32, global_batch=4, vocab_size=jmodel.cfg.vocab_size)))
    grads = jck.flatten_keys(jax.grad(
        lambda p: jts.loss_fn(jmodel, p, batch, REPLICATED))(jp))
    n, gaps, pmax = _param_gaps(jstate1["params"], tstate1["params"])
    for k, gap in gaps.items():
        g = np.abs(np.asarray(grads[k]))
        far = gap > 1e-6 * pmax
        assert (g[far] <= 1e-4 * g.max()).all(), k


def test_ten_steps_follow_the_reference_and_fall(qwen_f32):
    _, _, metrics = _run_both(qwen_f32, 10)
    ref = [r["loss"] for r, _ in metrics]
    ours = [o["loss"] for _, o in metrics]
    for a, b in zip(ours, ref):
        assert abs(a - b) <= 1e-4 * abs(b), (ours, ref)
    assert ours[-1] < ours[0] and all(math.isfinite(x) for x in ours)


# ---------------------------------------------------------------------------
# the MoE load-balance loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_aux_loss_equals_the_references(arch, tmp_path):
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import moe as jmoe
    from repro.models.common import REPLICATED
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jck

    jcfg = jax_smoke_config(arch).with_quant(mode="none").with_(
        dtype="float32")
    jp = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0))
    path = jck.save(str(tmp_path / "p.npz"), jp)
    params = interop.load_params(path, device=CPU)
    cfg = get_smoke_config(arch).with_quant(mode="none").with_(
        dtype="float32")
    x = np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jy, jaux = jmoe.moe_forward(jcfg, jlayer, jnp.asarray(x), REPLICATED,
                                return_aux=True)
    y, aux = moe.moe_forward(cfg, params["layers"][0]["moe"],
                             torch.from_numpy(x), DEFAULT_POLICY,
                             return_aux=True)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    ref = np.asarray(jy)
    assert np.abs(_np(y) - ref).max() <= 1e-5 * np.abs(ref).max()
    # return_aux=False gives the same y alone
    assert torch.equal(moe.moe_forward(cfg, params["layers"][0]["moe"],
                                       torch.from_numpy(x), DEFAULT_POLICY),
                       y)
    # the raw experts run on one device only
    for kw in ({"group": object()}, {"ep_group": object()}):
        with pytest.raises(ValueError, match="one device only"):
            moe.moe_forward(cfg, params["layers"][0]["moe"],
                            torch.from_numpy(x), DEFAULT_POLICY, **kw)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_step_naming_latest_and_restore(tmp_path):
    model = build_model(get_smoke_config("granite-3-8b").with_quant(
        mode="none"))
    params = model.init(0, device=CPU)
    path = checkpoint.save(str(tmp_path / "ck"), params, step=7)
    assert path.endswith("_step00000007.npz")
    later = checkpoint.save(str(tmp_path / "ck.npz"), params, step=12)
    assert later.endswith("ck_step00000012.npz")
    checkpoint.save(str(tmp_path / "other"), params, step=99)
    assert checkpoint.latest(str(tmp_path), "ck") == later
    assert checkpoint.latest(str(tmp_path / "nowhere"), "ck") is None
    restored = checkpoint.restore(path, params)
    flat = checkpoint.flatten_keys(params)
    for k, t in checkpoint.flatten_keys(restored).items():
        assert torch.equal(t, flat[k]) and t.dtype == flat[k].dtype, k
    # the template's dtypes rule
    half = checkpoint.map_tensors(params, lambda _, t: t.to(torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in checkpoint.flatten_keys(
        checkpoint.restore(path, half)).values())
    bad = dict(params, final_norm={"scale": torch.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, bad)
    extra = dict(params, final_norm=dict(params["final_norm"],
                                         bias=torch.zeros(256)))
    with pytest.raises(KeyError, match="missing"):
        checkpoint.restore(path, extra)


def test_port_trainer_checkpoint_loads_in_the_reference(tmp_path, capsys):
    """The port trainer's ``--ckpt`` file: the reference's ``load`` gives
    the trained params bit for bit (layers stacked), and its ``restore``
    fills the reference's own template."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import build_model as jax_build_model
    from repro.train import checkpoint as jck

    prefix = str(tmp_path / "run")
    train_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--ckpt", prefix])
    path = checkpoint.latest(str(tmp_path), "run")
    assert path.endswith("run_step00000002.npz")
    assert f"saved {path}" in capsys.readouterr().out
    theirs = jck.load(path)
    ours = checkpoint.load(path)
    a, b = jck.flatten_keys(theirs), checkpoint.flatten_keys(ours)
    assert set(a) == set(b) and "layers||attn||wq" in a
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), _np(b[k]))
    template = jax.eval_shape(jax_build_model(jax_smoke_config(
        "qwen3-4b").with_quant(mode="none")).init, jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    back = jck.flatten_keys(jck.restore(path, template))
    for k in a:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(a[k]))


def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path):
    from repro.launch import train as jtrain

    prefix = str(tmp_path / "jrun")
    jtrain.main(["--arch", "qwen3-4b", "--smoke", "--steps", "2",
                 "--batch", "2", "--seq", "16", "--ckpt", prefix])
    path = checkpoint.latest(str(tmp_path), "jrun")
    assert path is not None and path.endswith("_step00000002.npz")
    model = build_model(get_smoke_config("qwen3-4b").with_quant(mode="none"))
    template = model.init(1, device=CPU)
    restored = checkpoint.restore(path, template)
    stacked = checkpoint.load(path)
    want = checkpoint.flatten_keys(interop.to_port_layout(stacked))
    got = checkpoint.flatten_keys(restored)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    # and the port trains on from it
    state = {"params": trainstep.trainable(restored),
             "opt": opt.init_state(restored)}
    step = trainstep.make_train_step(model, opt.AdamWConfig())
    batch = next(data_lib.batches(data_lib.DataConfig(
        seq_len=16, global_batch=2, vocab_size=model.cfg.vocab_size),
        device=CPU))
    _, metrics = step(state, batch)
    assert math.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# configs and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_references(arch):
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config

    for ours, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()


def test_train_state_specs_mirror_the_params():
    model = build_model(get_smoke_config("qwen3-4b").with_quant(mode="none"))
    state = trainstep.init_train_state(model, 0, device=CPU)
    specs = trainstep.train_state_specs(model, state["params"], 2)
    assert specs["params"] == model.param_specs(state["params"], 2)
    assert specs["opt"] == {"m": specs["params"], "v": specs["params"],
                            "step": None}
    assert specs["params"]["layers"][0]["mlp"] == {
        "w_up": 1, "w_gate": 1, "w_down": 0}
    assert all(p.requires_grad for p in checkpoint.flatten_keys(
        state["params"]).values())
    assert int(state["opt"]["step"]) == 0


def test_cli_smoke_prints_the_references_lines(capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "4",
                    "--batch", "2", "--seq", "16", "--log-every", "2"])
    out = capsys.readouterr().out.splitlines()
    steps = [ln for ln in out if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["0", "2", "3"]
    assert all("loss" in ln and "gnorm" in ln and "s/step" in ln
               for ln in steps)
    mem = next(ln for ln in out if ln.startswith("memory:"))
    cfg = get_smoke_config("qwen3-4b")
    assert f"param_count {cfg.param_count()}" in mem
    assert f"{16 * cfg.param_count()} B of train state" in mem


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_cli_feeds_the_stubs(arch, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "1", "--seq", "8"])
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("step "))
    assert math.isfinite(float(line.split()[3]))


def test_cli_refuses_tp_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--smoke", "--device", "cpu", "--tp", "2"])
    assert "item 11" in str(e.value.code) and "tp > 1" in str(e.value.code)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--smoke", "--steps", "1"])
    assert "no CUDA card" in str(e.value.code)
    with pytest.raises(ValueError, match="mode"):
        trainstep.init_train_state(build_model(get_smoke_config("qwen3-4b")),
                                   device=CPU)
