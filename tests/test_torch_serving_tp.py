"""The HTTP/SSE front end over tensor-parallel ranks
(``repro_torch.serving.controller``, ``ServingServer(group=...)``, the
CLI's ``--tp 2 --http``) on the CPU, two gloo ranks.

One spawn of two ranks (the ``ranks`` fixture) runs every case in turn:
rank 0 serves each case's clients from its own ``ServingServer`` while
rank 1 follows its boundaries on a ``Scheduler`` built with the same
arguments; after each case both ranks report their scheduler's
admissions, results and token log.

* (a) qwen3-4b smoke, ``quant-int8:fused``, over a tp=2 artifact JAX
  prepared: concurrent SSE streams well formed; seeded, unseeded (rank
  0's rid sets the stream) and greedy ids equal the same requests
  through an in-process tp=2 ``Scheduler`` on the same ranks; rank 1's
  log equals rank 0's; the greedy ids equal the reference's
  ``Scheduler`` at tp=1 (``REPLICATED``; ROADMAP caveat a rules out its
  tp=2 mesh) on the artifact's params (equality, as
  ``tests/test_torch_runtime.py`` holds tp=2 ``quant-int8:fused`` to
  tp=1).
* (b) a client disconnect frees the slot on both ranks.
* (c) a full wait line answers 429; the shed request reaches no rank.
* (d) idle beats every 0.05 s keep rank 1 waiting in a broadcast on a
  group whose timeout is 2 s through a 3 s idle spell.
* (e) rwkv6-3b smoke with more requests than slots: ``Engine.reset_slot``
  runs on both ranks, and the ids equal the in-process tp=2 scheduler's.
* (f) the CLI serves at ``--tp 2`` (banner ``tp=2``, the ids of the same
  request through the CLI's scheduler on two ranks), drains on SIGINT
  and exits 0; ``--mesh dp2xtp1 --http`` exits 1.

Every client read has a timeout.  JAX is imported inside the fixture and
test that run it: the rank processes import this module."""

import datetime
import http.client
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh
from repro_torch.launch import serve as cli
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import make_engine
from repro_torch.serving import ServingServer, follow

MAX_SEQ = 64
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
COLLECTIVE = "quant-int8:fused"
CLI_ARGS = ["--smoke", "--device", "cpu", "--tp", "2", "--collective",
            COLLECTIVE]
CLI_REQUEST = {"prompt": [1, 2, 3], "max_new_tokens": 3, "seed": 0}
SEEDED = SamplingConfig(temperature=0.8, top_k=40)
GREEDY = SamplingConfig(temperature=0.0)
#: (d)'s group timeout, idle spell and beat, seconds
SHORT_TIMEOUT, IDLE_SPELL, BEAT = 2.0, 3.0, 0.05


def _case_a() -> list:
    """Two seeded, two unseeded and two greedy requests."""
    rng = np.random.default_rng(5)

    def prompt(n):
        return rng.integers(0, 512, n).tolist()

    return [
        {"prompt": prompt(6), "max_new_tokens": 6, "temperature": 0.9,
         "top_p": 0.8, "seed": 7},
        {"prompt": prompt(4), "max_new_tokens": 8, "seed": 11},
        {"prompt": prompt(9), "max_new_tokens": 5},
        {"prompt": prompt(3), "max_new_tokens": 7, "top_p": 0.5},
        {"prompt": prompt(7), "max_new_tokens": 6, "temperature": 0.0},
        {"prompt": prompt(5), "max_new_tokens": 8, "temperature": 0.0},
    ]


def _case_e() -> list:
    rng = np.random.default_rng(6)
    return [{"prompt": rng.integers(0, 512, 3 + i).tolist(),
             "max_new_tokens": 4 + i, **({"seed": i} if i % 2 else {})}
            for i in range(5)]


# ----------------------------------------------------------------------
# clients (rank 0)
# ----------------------------------------------------------------------

def _post(port, body, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _events(resp):
    """A full SSE body as [(event, payload), ...]."""
    out, event = [], None
    for raw in resp.read().decode("utf-8").split("\n"):
        if raw.startswith("event: "):
            event = raw[len("event: "):]
        elif raw.startswith("data: "):
            out.append((event, json.loads(raw[len("data: "):])))
    return out


def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _stream(port, body) -> dict:
    """One whole SSE exchange: its event kinds, rid and token ids."""
    conn, resp = _post(port, body)
    try:
        assert resp.status == 200, (resp.status, resp.read())
        events = _events(resp)
    finally:
        conn.close()
    return {"kinds": [k for k, _ in events], "rid": events[0][1]["rid"],
            "ids": [p["token"] for k, p in events if k == "token"]}


def _concurrent(port, bodies) -> list:
    results = [None] * len(bodies)

    def client(i):
        results[i] = _stream(port, bodies[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return results


def _wait_live(port, n):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if _get_json(port, "/v1/stats")[1]["engine"]["live_slots"] >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"fewer than {n} live requests after 30 s")


def _clients_a(srv) -> dict:
    return {"streams": _concurrent(srv.port, _case_a())}


def _clients_b(srv) -> dict:
    """Request A holds the only slot and hangs up after two tokens; B
    then takes the slot."""
    conn, resp = _post(srv.port, {"prompt": [5, 6, 7], "max_new_tokens": 50,
                                  "seed": 1})
    assert resp.status == 200
    got = 0
    for line in resp:
        if line.startswith(b"data: ") and b"token" in line:
            got += 1
            if got >= 2:
                break
    resp.close()
    conn.close()
    b = _stream(srv.port, {"prompt": [8, 9], "max_new_tokens": 3, "seed": 2})
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        stats = _get_json(srv.port, "/v1/stats")[1]
        if stats["requests"]["cancelled"] >= 1:
            break
        time.sleep(0.05)
    return {"b": b, "stats": stats}


def _clients_c(srv) -> dict:
    """The slot and the one seat of the wait line held: the next request
    is shed with 429."""
    held = []
    for i in range(2):
        held.append(_post(srv.port, {"prompt": [1, 2], "max_new_tokens": 40,
                                     "seed": i}))
        if i == 0:
            _wait_live(srv.port, 1)
    deadline = time.monotonic() + 30
    status, retry = None, None
    while time.monotonic() < deadline:
        conn, resp = _post(srv.port, {"prompt": [3], "max_new_tokens": 2})
        status, retry = resp.status, resp.getheader("Retry-After")
        resp.read()
        conn.close()
        if status == 429:
            break
        time.sleep(0.02)
    kinds = []
    for conn, resp in held:
        kinds.append([k for k, _ in _events(resp)])
        conn.close()
    return {"status": status, "retry_after": retry, "held": kinds,
            "stats": _get_json(srv.port, "/v1/stats")[1]}


def _clients_d(srv) -> dict:
    """A request, an idle spell longer than the group's timeout, another
    request."""
    first = _stream(srv.port, {"prompt": [4, 5], "max_new_tokens": 3,
                               "seed": 3})
    time.sleep(IDLE_SPELL)
    second = _stream(srv.port, {"prompt": [6], "max_new_tokens": 3,
                                "seed": 4})
    return {"streams": [first, second]}


def _clients_e(srv) -> dict:
    return {"streams": _concurrent(srv.port, _case_e())}


# ----------------------------------------------------------------------
# the ranks
# ----------------------------------------------------------------------

def _case(ctx, engine, kw: dict, clients, *, group=None, beat=30.0,
          queue_capacity=8, replay=False) -> dict:
    """Rank 0 serves ``clients`` from a ``ServingServer`` over ``group``
    (default the engine's); rank 1 follows on a ``Scheduler(engine,
    **kw)``.  Both report their scheduler's admissions, steps and
    results, and with ``replay`` the same requests (rank 0's rids, in
    admission order) through an in-process scheduler of ``kw``."""
    group = ctx.group if group is None else group
    if ctx.rank == 0:
        srv = ServingServer(engine, group=group, beat=beat,
                            queue_capacity=queue_capacity, retry_after=0.25,
                            **kw)
        srv.start()
        try:
            out = clients(srv)
        finally:
            srv.shutdown(drain=True, timeout=60)
        sched, ctl = srv.loop.scheduler, srv.loop.controller
        out.update(log=ctl.log, sent=ctl.sent, error=repr(srv.loop.error))
    else:
        sched = Scheduler(engine, **kw)
        out = follow(sched, group)
    out.update(admissions=list(sched.admissions), steps=sched.steps,
               finished={rid: (r.output, r.cancelled)
                         for rid, r in sched.finished.items()})
    if replay:
        solo = Scheduler(engine, **kw)
        for _, rid in sched.admissions:
            r = sched.finished[rid]
            solo.submit(Request(rid=rid, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                temperature=r.temperature, top_p=r.top_p,
                                seed=r.seed))
        out["replay"] = {rid: r.output for rid, r in solo.run().items()}
    return out


def _http_rank(ctx, path: str) -> dict:
    """Every case, in turn, on this rank."""
    manifest = DeploymentArtifact.load_manifest(path)
    plan = DeploymentArtifact(manifest=manifest).policy(
        backend="auto", device=ctx.device)
    qwen = make_engine(get_smoke_config("qwen3-4b").with_quant(
        **manifest["quant"]), device=ctx.device, max_seq=MAX_SEQ,
        group=ctx.group, policy=plan, artifact=path)
    kw = {"prompt_budget": 16, "seed": 0}
    out = {"rank": ctx.rank, "collective": qwen.policy.collective.shorthand()}
    out["a"] = _case(ctx, qwen, dict(kw, max_batch=2, scfg=SEEDED),
                     _clients_a, replay=True)
    out["b"] = _case(ctx, qwen, dict(kw, max_batch=1, scfg=GREEDY),
                     _clients_b)
    out["c"] = _case(ctx, qwen, dict(kw, max_batch=1, scfg=GREEDY),
                     _clients_c, queue_capacity=1)
    short = dist.new_group([0, 1], timeout=datetime.timedelta(
        seconds=SHORT_TIMEOUT))
    dist.barrier(group=ctx.group)
    out["d"] = _case(ctx, qwen, dict(kw, max_batch=1, scfg=SEEDED),
                     _clients_d, group=short, beat=BEAT)
    del qwen

    args = cli.serve_parser().parse_args(
        ["--arch", "rwkv6-3b", *CLI_ARGS])
    _, rwkv = cli._engine(args, ctx.device, ctx.group)
    resets = []
    reset_slot = rwkv.reset_slot

    def counted(cache, slot):
        resets.append(slot)
        return reset_slot(cache, slot)

    rwkv.reset_slot = counted
    out["e"] = _case(ctx, rwkv, dict(kw, max_batch=2, scfg=SEEDED),
                     _clients_e, replay=True)
    out["e"]["resets"] = len(resets)
    del rwkv

    # (f): the CLI's request through the CLI's engine and scheduler
    args = cli.serve_parser().parse_args(CLI_ARGS)
    _, engine = cli._engine(args, ctx.device, ctx.group)
    sched = Scheduler(engine, **cli._http_kwargs(args))
    sched.submit(Request(rid=0, prompt=np.asarray(CLI_REQUEST["prompt"],
                                                  np.int32),
                         max_new_tokens=CLI_REQUEST["max_new_tokens"],
                         seed=CLI_REQUEST["seed"]))
    out["f"] = sched.run()[0].output
    return out


# ----------------------------------------------------------------------
# fixtures
# ----------------------------------------------------------------------

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
def artifact(tmp_path_factory):
    """What ``repro.launch.serve prepare --smoke --tp 2 --collective
    quant-int8:fused`` writes."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.policy import ExecutionPolicy as JaxPolicy
    from repro.dist import MeshPlan as JaxMeshPlan
    from repro.plan import compiler as jax_compiler

    cfg = jax_smoke_config("qwen3-4b").with_quant(collective=COLLECTIVE)
    policy = JaxPolicy.from_config(cfg).with_(mesh=JaxMeshPlan(dp=1, tp=2))
    return jax_compiler.prepare(cfg, tp=2, seed=0, policy=policy,
                                extra_manifest={"smoke": True}).save(
        str(tmp_path_factory.mktemp("jax2")))


@pytest.fixture(scope="module")
def ranks(artifact):
    return mesh.run(_http_rank, 2, artifact, device_type="cpu", timeout=300)


def _followed(ranks, case: str):
    """Both ranks' reports of ``case``; rank 1 followed rank 0 exactly."""
    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["error"] == "None"
    assert r1["log"] == r0["log"] and r0["log"]
    assert r1["admissions"] == r0["admissions"]
    assert r1["finished"] == r0["finished"]
    assert r1["steps"] == r0["steps"]
    assert r1["received"] == r0["sent"]
    return r0, r1


# ----------------------------------------------------------------------
# (a)-(e)
# ----------------------------------------------------------------------

def test_streams_equal_in_process_tp2_scheduler_and_jax(ranks, artifact):
    r0, r1 = _followed(ranks, "a")
    assert ranks[0]["collective"] == "quant-int8:128:fused"
    cases = _case_a()
    streams = r0["streams"]
    for case, s in zip(cases, streams):
        n = case["max_new_tokens"]
        assert s["kinds"] == ["start"] + ["token"] * n + ["done"], s
    # slots were reused: max_batch 2 for six requests
    assert any(step > 0 for step, _ in r0["admissions"])
    ids = {s["rid"]: s["ids"] for s in streams}
    assert ids == r0["replay"] == r1["replay"]
    assert {rid: out for rid, (out, _) in r0["finished"].items()} == ids

    # the greedy requests against the reference's scheduler at tp=1
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.common import REPLICATED
    from repro.models.registry import build_model as jax_build_model
    from repro.plan import DeploymentArtifact as JaxArtifact
    from repro.runtime.sampling import SamplingConfig as JaxSampling
    from repro.runtime.scheduler import Request as JaxRequest
    from repro.runtime.scheduler import Scheduler as JaxScheduler
    from repro.runtime.serve import Engine as JaxEngine

    jart = JaxArtifact.load(artifact)
    jcfg = jax_smoke_config("qwen3-4b").with_quant(**jart.manifest["quant"])
    jeng = JaxEngine(model=jax_build_model(jcfg), params=jart.params(),
                     ctx=REPLICATED, max_seq=MAX_SEQ)
    jsched = JaxScheduler(jeng, max_batch=2, prompt_budget=16,
                          scfg=JaxSampling(temperature=0.0), seed=0)
    greedy = [(c, s) for c, s in zip(cases, streams)
              if c.get("temperature") == 0.0]
    assert len(greedy) == 2
    for case, s in greedy:
        jsched.submit(JaxRequest(rid=s["rid"], prompt=np.asarray(
            case["prompt"], np.int32),
            max_new_tokens=case["max_new_tokens"]))
    want = {rid: list(map(int, r.output))
            for rid, r in jsched.run().items()}
    assert {s["rid"]: s["ids"] for _, s in greedy} == want


def test_client_disconnect_frees_the_slot_on_both_ranks(ranks):
    r0, _ = _followed(ranks, "b")
    (step_a, rid_a), (step_b, rid_b) = r0["admissions"]
    assert step_a == 0 and step_b > 0
    out_a, cancelled_a = r0["finished"][rid_a]
    assert cancelled_a and len(out_a) < 45
    assert r0["finished"][rid_b] == (r0["b"]["ids"], False)
    assert r0["b"]["kinds"] == ["start", "token", "token", "token", "done"]
    stats = r0["stats"]
    assert stats["requests"]["cancelled"] == 1
    assert stats["requests"]["in_flight"] == 0
    assert stats["engine"]["live_slots"] == 0


def test_full_queue_answers_429(ranks):
    r0, _ = _followed(ranks, "c")
    assert r0["status"] == 429 and float(r0["retry_after"]) > 0
    for kinds in r0["held"]:
        assert kinds == ["start"] + ["token"] * 40 + ["done"]
    assert r0["stats"]["queue"]["rejected"] >= 1
    # the shed request reached neither rank's scheduler
    assert len(r0["finished"]) == 2


def test_idle_beats_keep_the_follower_past_the_group_timeout(ranks):
    r0, r1 = _followed(ranks, "d")
    assert [s["kinds"] for s in r0["streams"]] == \
        [["start", "token", "token", "token", "done"]] * 2
    # one beat every BEAT seconds of quiet, over a spell of IDLE_SPELL
    assert r1["received"]["idle"] >= IDLE_SPELL / (4 * BEAT)
    assert r1["received"]["stop"] == 1


def test_recurrent_slot_reuse_follows_on_both_ranks(ranks):
    r0, r1 = _followed(ranks, "e")
    cases = _case_e()
    for case, s in zip(cases, r0["streams"]):
        n = case["max_new_tokens"]
        assert s["kinds"] == ["start"] + ["token"] * n + ["done"], s
    assert r0["resets"] == r1["resets"] > 0
    ids = {s["rid"]: s["ids"] for s in r0["streams"]}
    assert ids == r0["replay"] == r1["replay"]


# ----------------------------------------------------------------------
# (f) the CLI
# ----------------------------------------------------------------------

def test_cli_tp2_http_serves_and_drains(ranks):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI_ARGS,
         "--http", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "no banner within 120 s"
        banner = proc.stdout.readline()
        assert "tp=2 (gloo, 2 ranks on the CPU)" in banner, (
            banner, proc.stderr.read() if proc.poll() is not None else "")
        assert "collective=quant-int8:128:fused" in banner
        port = int(banner.split("http://127.0.0.1:")[1].split()[0])
        s = _stream(port, CLI_REQUEST)
        assert s["kinds"] == ["start", "token", "token", "token", "done"]
        assert s["ids"] == ranks[0]["f"] == ranks[1]["f"]
        status, health = _get_json(port, "/v1/health")
        assert status == 200 and health["status"] == "ok"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    grid = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--mesh", "dp2xtp1", "--http", "127.0.0.1:0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert grid.returncode == 1
    assert "item 9" in grid.stderr
