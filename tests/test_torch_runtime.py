"""The port's serving runtime on the CPU: the scheduler's in-port
contracts, the sampler against the reference's mask pipeline, the CLI,
and the import boundary (no JAX, nothing of ``repro``)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as jax_sampling
from repro_torch.configs import get_smoke_config
from repro_torch.runtime import sampling
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import Engine, make_engine

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


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


@pytest.fixture(scope="module")
def engine():
    return make_engine(get_smoke_config("qwen3-4b"), 0, device="cpu",
                       max_seq=24)


def _requests(vocab):
    rng = np.random.default_rng(5)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=n).astype(
        np.int32), max_new_tokens=6) for i, n in enumerate((5, 7, 4, 6, 3))]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_scheduler_batched_equals_solo(engine, temperature):
    """Five requests through two lanes (so three are admitted mid-stream)
    emit what each emits alone.  Solo runs use the same fixed program
    shape (max_batch=2): torch's CPU GEMM rows differ in the last bit
    between M=1 and M>1, so only same-shape runs are bit-comparable."""
    scfg = sampling.SamplingConfig(temperature=temperature, top_k=40)
    vocab = engine.model.cfg.vocab_size
    sched = Scheduler(engine, max_batch=2, prompt_budget=8, scfg=scfg, seed=9)
    for req in _requests(vocab):
        sched.submit(req)
    batched = sched.run()
    assert any(step > 0 for step, _ in sched.admissions)
    for req in _requests(vocab):
        solo = Scheduler(engine, max_batch=2, prompt_budget=8, scfg=scfg,
                         seed=9)
        solo.submit(req)
        out = solo.run()[req.rid].output
        assert len(out) == 6
        assert out == batched[req.rid].output, req.rid


def test_scheduler_request_seed_pins_stream(engine):
    vocab = engine.model.cfg.vocab_size
    outs = []
    for sched_seed in (1, 2):
        sched = Scheduler(engine, max_batch=2, prompt_budget=8,
                          scfg=sampling.SamplingConfig(temperature=1.0),
                          seed=sched_seed)
        req = _requests(vocab)[0]
        req.seed = 42
        sched.submit(req)
        outs.append(sched.run()[0].output)
    assert outs[0] == outs[1]


def test_scheduler_cancel_frees_slot(engine):
    """A cancelled live request retires at the next step boundary and its
    slot admits the next queued request; a cancelled queued one never
    runs."""
    vocab = engine.model.cfg.vocab_size
    sched = Scheduler(engine, max_batch=1, prompt_budget=8)
    reqs = _requests(vocab)[:3]
    for req in reqs:
        sched.submit(req)
    sched.step()                          # admits request 0
    assert sched.cancel(0) and sched.cancel(2)
    assert not sched.cancel(99)
    events = sched.step()
    assert {(e.rid, e.cancelled) for e in events if e.cancelled} == {
        (0, True), (2, True)}
    done = sched.run()
    assert done[0].cancelled and done[2].cancelled and not done[2].output
    assert len(done[1].output) == 6
    assert [rid for _, rid in sched.admissions] == [0, 1]


def test_engine_holds_policy_mesh_to_its_ranks(engine):
    """``policy.mesh`` names the TP degree the plan was made for: an engine
    whose ranks do not match it raises, and so does ``make_engine``
    before it makes any weight; a derived policy takes the group's
    degree (one rank here; two in ``tests/test_torch_tp.py``)."""
    assert engine.policy.mesh.shorthand() == "dp1xtp1"
    pol = engine.policy.with_(mesh="dp1xtp2")
    with pytest.raises(ValueError, match="plans tp=2, but 1 rank"):
        Engine(model=engine.model, params=engine.params, device="cpu",
               policy=pol)
    with pytest.raises(ValueError, match="plans tp=2, but 1 rank"):
        make_engine(get_smoke_config("qwen3-4b"), 0, device="cpu",
                    policy=pol)


@pytest.mark.parametrize("t,p,k", [(0.7, 0.9, 0), (1.2, 0.5, 0),
                                   (0.9, 1.0, 10), (1.0, 0.8, 5)])
def test_masked_logits_matches_jax(t, p, k):
    logits = np.random.default_rng(0).standard_normal((3, 64)).astype(
        np.float32)
    args = [np.full(3, t, np.float32), np.full(3, p, np.float32),
            np.full(3, k, np.int32)]
    ref = np.asarray(jax_sampling._masked_logits(
        jnp.asarray(logits), *map(jnp.asarray, args)))
    got = sampling._masked_logits(torch.from_numpy(logits),
                                  *map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got[~np.isinf(ref)], ref[~np.isinf(ref)],
                               rtol=1e-6)


def test_sample_slots_row_equals_sample():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 64)).astype(np.float32))
    cfg = sampling.SamplingConfig(temperature=0.9, top_k=10, top_p=0.8)
    a = sampling.sample(torch.Generator().manual_seed(3), logits, cfg)
    b = sampling.sample_slots(
        [torch.Generator().manual_seed(3)], logits, torch.tensor([0.9]),
        torch.tensor([0.8]), torch.tensor([10]))
    assert torch.equal(a, b)
    top = set(torch.topk(logits[0], 10).indices.tolist())
    for seed in range(8):
        tok = sampling.sample(torch.Generator().manual_seed(seed), logits, cfg)
        assert int(tok) in top


def test_gumbel_noise_at_a_zero_draw_is_the_references(monkeypatch):
    """A draw of exactly 0 gets the reference's noise at ``tiny``
    (``jax.random.gumbel`` draws from [tiny, 1)), -4.47, not -inf: the
    token then wins against noise 0.3665 (draws of 0.5) iff its logit
    beats the reference's threshold."""
    tiny = jnp.finfo(jnp.float32).tiny
    ref = float(-jnp.log(-jnp.log(jnp.asarray(tiny))))
    half = float(-jnp.log(-jnp.log(jnp.float32(0.5))))
    assert -4.48 < ref < -4.46
    draws = torch.full((8,), 0.5)
    draws[0] = 0.0
    monkeypatch.setattr(torch, "rand", lambda *a, **k: draws.clone())
    for margin, want in ((1e-3, 0), (-1e-3, 1)):
        row = torch.zeros(8)
        row[0] = half - ref + margin
        assert int(sampling._gumbel_argmax(row, None)) == want, margin


def _run(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC, **(env_extra or {}))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=300)


def test_cli_smoke_on_cpu():
    proc = _run(["-m", "repro_torch.launch.serve", "--arch", "qwen3-4b",
                 "--smoke", "--device", "cpu", "--requests", "2",
                 "--max-new", "4"])
    assert proc.returncode == 0, proc.stderr
    assert "req 1: prompt" in proc.stdout
    assert "tok/s" in proc.stdout and "backend=torch" in proc.stdout


def test_cli_tp_on_cpu_names_transport_and_matches_tp1():
    """``--tp 2`` spawns two gloo ranks; rank 0 prints the banner, which
    names the transport, and the ranks emit the one-device run's ids
    (the quantized wire does not flip a greedy-or-sampled token of this
    smoke model)."""
    base = ["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
            "--requests", "2", "--max-new", "4"]
    tp = _run(base + ["--tp", "2", "--collective", "quant-int8:fused"])
    one = _run(base)
    assert tp.returncode == 0 and one.returncode == 0, tp.stderr
    assert "mesh=dp1xtp2 (gloo, 2 ranks on the CPU)" in tp.stdout
    assert "collective=quant-int8:128:fused" in tp.stdout
    ids = [ln for ln in tp.stdout.splitlines() if ln.startswith("req ")]
    assert len(ids) == 2
    assert ids == [ln for ln in one.stdout.splitlines()
                   if ln.startswith("req ")]
    # the :overlap ring, once refused, serves (at one rank it is the GEMM)
    ov = _run(base + ["--collective", "quant-int8:overlap"])
    assert ov.returncode == 0, ov.stderr
    assert "collective=quant-int8:128:overlap" in ov.stdout
    assert ids == [ln for ln in ov.stdout.splitlines()
                   if ln.startswith("req ")]


def test_cli_without_card_names_it():
    proc = _run(["-m", "repro_torch.launch.serve", "--smoke", "--requests",
                 "1", "--max-new", "2"], {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
