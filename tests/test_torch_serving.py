"""The port's HTTP/SSE front end (``repro_torch.serving``) on the CPU: the
reference's ``tests/test_serving.py`` cases against the port's
``ServingServer`` on ``127.0.0.1:0``, and the CLI's ``--http``.

One smoke engine is shared module-wide; each test builds its own
``ServingServer`` on an ephemeral port with the queue/batch geometry it
needs.  Every client read has a timeout, so a hang fails the test rather
than holding the suite."""

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

from repro_torch.cache import PageSpec
from repro_torch.configs import get_smoke_config
from repro_torch.runtime import sampling
from repro_torch.runtime.serve import make_engine
from repro_torch.serving import ServingServer, tokenize_stub

MAX_SEQ = 64
CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def engine():
    return make_engine(get_smoke_config("qwen3-4b"), 0, device=CPU,
                       max_seq=MAX_SEQ)


@pytest.fixture(scope="module")
def paged_engine(engine):
    """The same params under ``paged:8:int8``."""
    return make_engine(get_smoke_config("qwen3-4b"), 0, device=CPU,
                       max_seq=MAX_SEQ, policy=engine.policy.with_(
                           kv=PageSpec(page_size=8, bits=8)))


@pytest.fixture()
def paged_server(paged_engine, request):
    params = getattr(request, "param", {})
    srv = ServingServer(paged_engine,
                        max_batch=params.get("max_batch", 2),
                        prompt_budget=params.get("prompt_budget", 16),
                        queue_capacity=params.get("queue_capacity", 4),
                        retry_after=0.25,
                        n_pages=params.get("n_pages"),
                        cache_idle=params.get("cache_idle", 30.0),
                        scfg=sampling.SamplingConfig(temperature=0.0))
    srv.start()
    yield srv
    srv.shutdown(drain=False, timeout=10.0)


@pytest.fixture()
def server(engine, request):
    params = getattr(request, "param", {})
    srv = ServingServer(engine, max_batch=params.get("max_batch", 2),
                        prompt_budget=params.get("prompt_budget", 16),
                        queue_capacity=params.get("queue_capacity", 4),
                        retry_after=0.25,
                        scfg=sampling.SamplingConfig(temperature=0.0))
    srv.start()
    yield srv
    srv.shutdown(drain=False, timeout=10.0)


def _post(port, body, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _events(resp):
    """Parse a full SSE body into [(event, payload_dict), ...]."""
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


def _wait_live(port, n):
    """Wait until the engine runs ``n`` requests (under a loaded machine
    a request may not have left the wait line yet)."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if _get_json(port, "/v1/stats")[1]["engine"]["live_slots"] >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"fewer than {n} live requests after 30 s")


# ----------------------------------------------------------------------
# SSE framing + routes
# ----------------------------------------------------------------------

def test_sse_event_framing(server):
    conn, resp = _post(server.port, {"prompt": [1, 2, 3],
                                     "max_new_tokens": 4, "seed": 0})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode("utf-8")
    conn.close()
    # every frame is "event: <name>\ndata: <json>\n\n"
    frames = [f for f in raw.split("\n\n") if f]
    kinds = []
    for frame in frames:
        lines = frame.split("\n")
        assert len(lines) == 2, frame
        assert lines[0].startswith("event: ") and \
            lines[1].startswith("data: "), frame
        json.loads(lines[1][len("data: "):])      # valid JSON payload
        kinds.append(lines[0][len("event: "):])
    assert kinds[0] == "start"
    assert kinds[1:-1] == ["token"] * 4
    assert kinds[-1] == "done"
    # token events carry contiguous indices; done carries usage
    payloads = [json.loads(f.split("\n")[1][6:]) for f in frames]
    assert [p["index"] for p in payloads[1:-1]] == [0, 1, 2, 3]
    usage = payloads[-1]["usage"]
    assert usage["prompt_tokens"] == 3
    assert usage["completion_tokens"] == 4
    assert usage["finish_reason"] == "length"
    assert usage["ttft_ms"] > 0


def test_health_and_text_stub(server):
    status, health = _get_json(server.port, "/v1/health")
    assert status == 200 and health["status"] == "ok"
    assert health["arch"] == "qwen3-4b"

    ids = tokenize_stub("hello", 512)
    assert ids.dtype == np.int32 and ids.size == 5

    conn, resp = _post(server.port, {"text": "hi", "max_new_tokens": 2})
    events = _events(resp)
    conn.close()
    assert events[-1][0] == "done"

    for bad in ({}, {"prompt": []}, {"prompt": [1, 999999]},
                {"prompt": [1], "max_new_tokens": 0},
                {"prompt": [1], "top_p": 2.0},
                {"prompt": list(range(40))}):       # > prompt_budget
        conn, resp = _post(server.port, bad)
        assert resp.status == 400, bad
        resp.read()
        conn.close()


# ----------------------------------------------------------------------
# backpressure
# ----------------------------------------------------------------------

@pytest.mark.parametrize("server", [{"max_batch": 1,
                                     "queue_capacity": 1}],
                         indirect=True)
def test_queue_backpressure_429(server):
    # fill the single slot and the single queue seat with long
    # generations, then the next request must be shed with 429
    held = []
    for i in range(2):
        held.append(_post(server.port, {"prompt": [1, 2],
                                        "max_new_tokens": 40, "seed": i}))
        if i == 0:     # in the slot before the next one takes the seat
            _wait_live(server.port, 1)
    deadline = time.monotonic() + 30
    status = None
    while time.monotonic() < deadline:
        conn, resp = _post(server.port, {"prompt": [3],
                                         "max_new_tokens": 2})
        status = resp.status
        resp.read()
        conn.close()
        if status == 429:
            assert float(resp.getheader("Retry-After")) > 0
            break
        time.sleep(0.02)    # a held request may not have queued yet
    assert status == 429
    _, stats = _get_json(server.port, "/v1/stats")
    assert stats["queue"]["rejected"] >= 1
    assert stats["queue"]["capacity"] == 1
    for conn, resp in held:
        assert _events(resp)[-1][0] == "done"
        conn.close()


# ----------------------------------------------------------------------
# cancellation frees the slot
# ----------------------------------------------------------------------

@pytest.mark.parametrize("server", [{"max_batch": 1,
                                     "queue_capacity": 4}],
                         indirect=True)
def test_client_disconnect_frees_slot(server):
    # request A occupies the ONLY slot with a long generation; read two
    # events then hang up mid-stream
    conn, resp = _post(server.port, {"prompt": [5, 6, 7],
                                     "max_new_tokens": 50, "seed": 1})
    assert resp.status == 200
    got_tokens = 0
    for line in resp:
        if line.startswith(b"data: ") and b"token" in line:
            got_tokens += 1
            if got_tokens >= 2:
                break
    resp.close()              # hang up mid-generation (closes the
    conn.close()              # socket under the half-read SSE stream)

    # the slot must free at the next step boundary: request B (on the
    # same 1-slot engine) completes, and /v1/stats records the cancel
    conn2, resp2 = _post(server.port, {"prompt": [8, 9],
                                       "max_new_tokens": 3, "seed": 2},
                         timeout=60)
    assert resp2.status == 200
    events = _events(resp2)
    conn2.close()
    assert events[-1][0] == "done"
    assert sum(1 for k, _ in events if k == "token") == 3

    deadline = time.monotonic() + 20
    stats = None
    while time.monotonic() < deadline:
        _, stats = _get_json(server.port, "/v1/stats")
        if stats["requests"]["cancelled"] >= 1:
            break
        time.sleep(0.05)
    assert stats["requests"]["cancelled"] == 1
    assert stats["requests"]["in_flight"] == 0
    assert stats["engine"]["live_slots"] == 0
    # the cancelled request was cut well short of its 50 tokens
    assert stats["tokens"]["generated"] < 45


# ----------------------------------------------------------------------
# per-request sampling params == solo Engine.generate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("server", [{"max_batch": 4}], indirect=True)
def test_per_request_params_bit_identical_to_solo(server, engine):
    """Three concurrent HTTP requests with different temperature/top_p/
    seed each produce exactly the tokens of a solo ``Engine.generate``
    run with the same params — per-slot sampling-param vectors and
    per-request PRNG chains isolate requests completely."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(5)
    cases = [
        {"prompt": rng.integers(0, cfg.vocab_size, 6).tolist(),
         "max_new_tokens": 6, "temperature": 0.9, "top_p": 0.8,
         "seed": 7},
        {"prompt": rng.integers(0, cfg.vocab_size, 4).tolist(),
         "max_new_tokens": 8, "temperature": 1.3, "top_p": 0.5,
         "seed": 11},
        {"prompt": rng.integers(0, cfg.vocab_size, 9).tolist(),
         "max_new_tokens": 5, "temperature": 0.0, "seed": 3},
    ]
    results = [None] * len(cases)

    def client(i):
        conn, resp = _post(server.port, cases[i], timeout=60)
        results[i] = [p["token"] for k, p in _events(resp)
                      if k == "token"]
        conn.close()

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()

    for i, case in enumerate(cases):
        scfg = sampling.SamplingConfig(
            temperature=case["temperature"], top_p=case.get("top_p"))
        prompt = torch.from_numpy(np.asarray(case["prompt"], np.int64))
        gen = torch.Generator().manual_seed(case["seed"])
        ref = engine.generate(gen, prompt[None], [prompt.numel()],
                              max_new_tokens=case["max_new_tokens"],
                              scfg=scfg)[0]
        assert results[i] == ref.tolist(), f"case {i}"


# ----------------------------------------------------------------------
# stats counters
# ----------------------------------------------------------------------

def test_stats_counters_and_histograms(server):
    for i in range(3):
        conn, resp = _post(server.port, {"prompt": [i + 1, i + 2],
                                         "max_new_tokens": 3, "seed": i})
        assert _events(resp)[-1][0] == "done"
        conn.close()
    _, stats = _get_json(server.port, "/v1/stats")
    assert stats["requests"]["admitted"] == 3
    assert stats["requests"]["completed"] == 3
    assert stats["requests"]["cancelled"] == 0
    assert stats["requests"]["in_flight"] == 0
    assert stats["queue"]["offered"] == 3
    assert stats["queue"]["depth"] == 0
    assert stats["tokens"]["generated"] == 9
    ttft = stats["latency_ms"]["ttft"]
    itl = stats["latency_ms"]["itl"]
    assert ttft["count"] == 3
    assert itl["count"] == 6          # 2 gaps per 3-token request
    for hist in (ttft, itl):
        assert hist["p50"] <= hist["p99"]
        assert sum(hist["buckets"].values()) == hist["count"]
    status, _ = _get_json(server.port, "/v1/nope")
    assert status == 404


def test_stats_cache_fields_dense(server):
    conn, resp = _post(server.port, {"prompt": [1, 2],
                                     "max_new_tokens": 2, "seed": 0})
    assert _events(resp)[-1][0] == "done"
    conn.close()
    _, stats = _get_json(server.port, "/v1/stats")
    cache = stats["cache"]
    assert cache["allocated"] is True
    assert cache["spec"] == "dense"
    assert cache["builds"] == 1
    assert cache["bytes"]["pool"] > 0


# ----------------------------------------------------------------------
# paged cache over HTTP (DESIGN.md §9)
# ----------------------------------------------------------------------

def test_paged_stats_and_prefix_share_hits(paged_server):
    """Two identical 2-page prompts served back-to-back: the second
    resurrects the first's prompt pages from the prefix LRU — the stats
    endpoint reports the pool, the hit count, and bytes saved by both
    sharing and int8 pages."""
    _, health = _get_json(paged_server.port, "/v1/health")
    assert health["kv"] == "paged:8:int8"

    prompt = list(range(1, 17))          # 16 tokens == 2 full pages
    for seed in (0, 1):
        conn, resp = _post(paged_server.port,
                           {"prompt": prompt, "max_new_tokens": 4,
                            "seed": seed})
        assert _events(resp)[-1][0] == "done"
        conn.close()

    _, stats = _get_json(paged_server.port, "/v1/stats")
    cache = stats["cache"]
    assert cache["spec"] == "paged:8:int8"
    assert cache["page_size"] == 8
    pages = cache["pages"]
    assert pages["total"] == 2 * (MAX_SEQ // 8)   # max_batch * pmax
    assert pages["live"] == 0                     # all retired
    assert pages["free"] + pages["cached"] == pages["total"]
    assert pages["cached"] >= 2                   # prompt pages parked
    prefix = cache["prefix"]
    assert prefix["hits"] >= 2                    # both pages reused
    assert prefix["hit_rate"] > 0
    assert cache["bytes"]["saved_prefix"] > 0
    assert cache["bytes"]["saved_quantized"] > 0
    assert cache["bytes"]["per_page"] < cache["bytes"]["dense_equiv"]
    assert cache["per_request_pages"] == {}       # nothing in flight


@pytest.mark.parametrize("paged_server",
                         [{"max_batch": 2, "queue_capacity": 1,
                           "n_pages": 6}],
                         indirect=True)
def test_paged_pool_exhaustion_backpressure_429(paged_server):
    """A pool sized for ONE worst-case request: the second request parks
    waiting for pages (never a mid-decode failure), the wait line fills,
    and the next arrival is shed with 429 — then everything still
    finishes once pages free up."""
    held = []
    for i in range(2):                   # each needs 6 pages worst-case
        held.append(_post(paged_server.port, {"prompt": [1, 2],
                                              "max_new_tokens": 40,
                                              "seed": i}))
        if i == 0:
            _wait_live(paged_server.port, 1)
    deadline = time.monotonic() + 30
    status = None
    while time.monotonic() < deadline:
        conn, resp = _post(paged_server.port,
                           {"prompt": [3], "max_new_tokens": 2})
        status = resp.status
        body = resp.read()
        conn.close()
        if status == 429:
            break
        time.sleep(0.02)
    assert status == 429, body
    for conn, resp in held:
        assert _events(resp)[-1][0] == "done"
        conn.close()
    _, stats = _get_json(paged_server.port, "/v1/stats")
    assert stats["queue"]["rejected"] >= 1
    assert stats["requests"]["completed"] >= 2
    assert stats["cache"]["pages"]["live"] == 0


@pytest.mark.parametrize("paged_server", [{"cache_idle": 0.3}],
                         indirect=True)
def test_cache_released_when_idle(paged_server):
    """A long-lived loop must not pin peak-batch cache memory: after the
    idle grace the pool (and its prefix LRU) is freed, and the next
    request lazily rebuilds it."""
    conn, resp = _post(paged_server.port, {"prompt": [1, 2, 3],
                                           "max_new_tokens": 2, "seed": 0})
    assert _events(resp)[-1][0] == "done"
    conn.close()
    deadline = time.monotonic() + 20
    cache = None
    while time.monotonic() < deadline:
        _, stats = _get_json(paged_server.port, "/v1/stats")
        cache = stats["cache"]
        if not cache["allocated"]:
            break
        time.sleep(0.05)
    assert cache["allocated"] is False
    assert cache["pages"]["live"] == 0 and cache["pages"]["cached"] == 0

    conn, resp = _post(paged_server.port, {"prompt": [4, 5],
                                           "max_new_tokens": 2, "seed": 1})
    assert _events(resp)[-1][0] == "done"
    conn.close()
    _, stats = _get_json(paged_server.port, "/v1/stats")
    assert stats["cache"]["builds"] == 2


def test_drain_on_shutdown(engine):
    srv = ServingServer(engine, max_batch=2, prompt_budget=16,
                        queue_capacity=4,
                        scfg=sampling.SamplingConfig(temperature=0.0))
    srv.start()
    conn, resp = _post(srv.port, {"prompt": [1, 2], "max_new_tokens": 6,
                                  "seed": 0}, timeout=60)
    assert resp.status == 200
    t = threading.Thread(target=srv.shutdown,
                         kwargs={"drain": True, "timeout": 60})
    t.start()
    # draining: the in-flight request still completes...
    events = _events(resp)
    conn.close()
    assert events[-1][0] == "done"
    t.join(timeout=60)
    assert not t.is_alive()


# ----------------------------------------------------------------------
# the CLI's --http
# ----------------------------------------------------------------------

def test_cli_http_serves_sse_frames():
    """``--smoke --device cpu --kv-page-size 4 --kv-bits 8 --http
    127.0.0.1:0`` prints its address and layout, answers
    ``/v1/generate`` with SSE frames and ``/v1/health`` with the layout,
    and drains on an interrupt."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--kv-page-size", "4", "--kv-bits", "8",
         "--http", "127.0.0.1:0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "no banner within 120 s"
        banner = proc.stdout.readline()
        assert "kv=paged:4:int8" in banner, (banner, proc.stderr.read())
        port = int(banner.split("http://127.0.0.1:")[1].split()[0])
        conn, resp = _post(port, {"prompt": [1, 2, 3], "max_new_tokens": 3,
                                  "seed": 0})
        kinds = [k for k, _ in _events(resp)]
        conn.close()
        assert kinds == ["start", "token", "token", "token", "done"]
        status, health = _get_json(port, "/v1/health")
        assert status == 200 and health["kv"] == "paged:4:int8"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
