"""Serving entry point of the port; port of ``repro/launch/serve.py`` (the
one-shot lifecycle, and prepare-once / serve-many).

* one-shot (the plan made in memory at startup):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        [--smoke] [--scheme tp-aware] [--backend auto|cuda|torch|ref] \
        [--tp 2 --collective quant-int8:fused] \
        [--requests 8 --max-new 16 --prompt-budget 32 --max-batch 4 \
         --temperature 0.8 --seed 0] [--kv-page-size 16 [--kv-bits 8]] \
        [--http [HOST]:PORT [--queue-capacity 64]] [--device cpu]

* prepare once, serve many (the paper's a-priori plan, on disk):

    PYTHONPATH=src python -m repro_torch.launch.serve prepare \
        --arch qwen3-4b --smoke --scheme tp-aware --tp 2 --out DIR \
        [--collective quant-int8:fused --seed 0] [--device cpu] \
        [--autotune-collectives [--tune-budget 0.05] \
         [--overlap-collectives]]
    PYTHONPATH=src python -m repro_torch.launch.serve --artifact DIR \
        [--tp 2] [--backend auto] [--requests 8 ...] [--device cpu]

* the offline audit of an artifact (``repro_torch.analysis``'s MF rules,
  then the collective contracts of the specs its plan resolves, at tp=1
  and its TP degree); exits 1 on an error finding:

    PYTHONPATH=src python -m repro_torch.launch.serve verify \
        --artifact DIR [--json OUT] [--device cpu]

* a grid of data-parallel replicas of a TP plan (the reference's
  multi-process launch):

    PYTHONPATH=src python -m repro_torch.launch.serve --artifact DIR \
        --mesh dp2xtp2 [--max-batch 4 --max-new 16 --seed 0] [--device cpu]

  ``prepare`` runs the plan compiler from the seed (quantize, lay out,
  pre-shard for ``--tp`` ranks) and writes a ``DeploymentArtifact`` in
  the reference's format; ``--autotune-collectives`` chooses a per-layer
  collective plan (``plan/tuner.py``) and prints each site's choice;
  ``--overlap-collectives`` (which needs it) marks the quantized pair
  choices ``:overlap``, the ring pipelined against the down GEMM
  (``dist/overlap.py``).  A
  config with ``quant.attn_tp_aware`` (no flag, as in the reference:
  ``compiler.prepare`` of ``cfg.with_quant(attn_tp_aware=True)``) also
  writes the attention V->O folds, which ``--artifact`` serves (the
  banner says ``attn V->O fold: N layers``).  Serving from an artifact
  quantizes nothing: the manifest is the plan (``--arch``, ``--smoke``,
  ``--scheme`` and ``--collective`` are ignored), ``--tp`` defaults to
  the artifact's, and the manifest is validated against the config, the
  policy and the TP degree, so a mismatched plan refuses to serve.
  ``--backend`` (default auto: the CUDA kernels on the card for ordered
  layouts) is the port's choice at load, whatever backend the manifest
  names (``plan/artifact.py``).

The recurrent families (``--arch rwkv6-3b``, ``recurrentgemma-2b``) are
served by the continuous scheduler, as the dense ones, at any ``--tp``
that splits their heads (and under ``--mesh``, from ``prepare --tp``'s
artifacts too); each rank steps its share of the recurrent state.

The audio and vision families (``--arch whisper-large-v3``,
``llama-3.2-vision-90b``) are served in-process by the scheduler's
batch-drain mode (zero frames or patches beside each batch of prompts,
as in the reference); ``--http`` refuses them and exits 1, as the
reference's loop refuses them.

``--kv-page-size N [--kv-bits 8|4]`` serves from the paged KV cache
(``cache/``): on the in-memory plan through the config, and over an
``--artifact`` as a runtime override of its policy, never of its config
(the cache layout is runtime-only).  ``--http [HOST]:PORT`` serves the
same engine over HTTP/SSE (``serving/``: ``POST /v1/generate``,
``GET /v1/health``, ``GET /v1/stats``; ``:0`` binds a free port) instead
of the synthetic requests, and drains on Ctrl-C.  At ``--tp N`` (or
``--mesh dp1xtpN``) rank 0 binds, prints the banner and serves, and its
loop sends every admission, cancel and cache release to the other
ranks, which follow it step for step (``serving/controller.py``); the
run has no deadline, an interrupt reaches rank 0 alone, and a rank that
raises stops the server with its error.  ``--mesh`` with ``dp > 1``
refuses ``--http``, as the reference serves no front end over a grid.

``--mesh dpNxtpM`` spawns ``N * M`` processes in a ``(dp, tp)`` grid
(``launch/mesh.py``); ``M`` must be the plan's TP degree (an artifact's
rank files are split for it; ``dp`` needs no new prepare).  Each row of
``M`` processes is one TP engine, a data-parallel replica; each process
reads only its model-axis rank file.  As the reference's multi-process
launch does, the grid serves one lockstep synthetic batch instead of the
scheduler's requests: ``--max-batch`` prompts of ``--prompt-budget // 2``
tokens drawn from ``--seed``, split over the data axis (``max_batch % N
== 0``), each row generating ``--max-new`` tokens for its share.  Each
process prints its ``mesh=... process=i/n resident_artifact_bytes=...``
line and its ``first=`` ids.

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
exits with an error naming the missing card.  ``--tp N`` spawns N rank
processes (``launch/mesh.py``): each builds its slices of the plan from
the same seed, or reads only its own rank file of the artifact, and runs
the same scheduler, so all emit the same tokens; rank 0 prints the
banner, which names the transport, and the results, and under an
artifact every rank's ``resident_artifact_bytes`` follow.
"""

from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.cache.spec import PageSpec
from repro_torch.comm.spec import parse_collective
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.reorder import SCHEMES
from repro_torch.device import resolve_device
from repro_torch.dist.topology import MeshPlan
from repro_torch.launch import mesh
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime.sampling import SamplingConfig
from repro_torch.runtime.scheduler import Request, Scheduler
from repro_torch.runtime.serve import make_engine


def _build_cfg(args, backend: str = "auto"):
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return cfg.with_quant(mode="mlp", scheme=args.scheme, backend=backend,
                          collective=args.collective,
                          kv_page_size=args.kv_page_size,
                          kv_bits=args.kv_bits)


def _mesh_plan(value: str) -> MeshPlan:
    try:
        return MeshPlan.parse(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def _collective(value: str) -> str:
    try:
        parse_collective(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return value


def _plan_args(ap: argparse.ArgumentParser):
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS,
                    help="model config: " + ", ".join(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scheme", default="tp-aware", choices=SCHEMES)
    ap.add_argument("--collective", default="psum", type=_collective,
                    help="row-TP epilogue: psum, psum_scatter, cast[:dtype], "
                         "quant-int8[:block][:fused][:overlap], "
                         "quant-int4[:block][:fused][:overlap], none, or a "
                         "'per-layer:<glob>=<spec>,...' plan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="serve from the paged KV cache with pages of this "
                         "many tokens (default: dense per-slot rows)")
    ap.add_argument("--kv-bits", type=int, default=None, choices=[8, 4],
                    help="quantize the pages to int8 or int4 (needs "
                         "--kv-page-size)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")


def _device(args) -> torch.device:
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None


def prepare(argv=None) -> str:
    """Offline compile: write a ``DeploymentArtifact`` directory."""
    from repro_torch.plan import compiler

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve prepare")
    _plan_args(ap)
    ap.add_argument("--tp", type=int, default=1,
                    help="TP degree the rank files are split for (serving "
                         "must use the same)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--autotune-collectives", action="store_true",
                    help="score every full-output collective per pair and "
                         "fold site (wire bytes and a calibration error "
                         "probe; plan/tuner.py) and compile the chosen "
                         "per-layer plan into the artifact (overrides "
                         "--collective)")
    ap.add_argument("--tune-budget", type=float, default=None,
                    help="max relative activation error a tuned "
                         "collective may introduce (default: the tuner's "
                         "DEFAULT_BUDGET, 0.05)")
    ap.add_argument("--overlap-collectives", action="store_true",
                    help="mark tuned quantized pair epilogues ':overlap': "
                         "the ring pipelined against the down GEMM one row "
                         "microbatch at a time (bit-identical; requires "
                         "--autotune-collectives)")
    args = ap.parse_args(argv)
    if args.overlap_collectives and not args.autotune_collectives:
        ap.error("--overlap-collectives requires --autotune-collectives")
    device = _device(args)
    cfg = _build_cfg(args)
    policy = ExecutionPolicy.from_config(cfg, device=device).with_(
        mesh=MeshPlan(tp=args.tp))
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=args.tp, seed=args.seed, policy=policy,
                           extra_manifest={"smoke": bool(args.smoke)},
                           device=device,
                           autotune=args.autotune_collectives,
                           tune_budget=args.tune_budget,
                           tune_overlap=args.overlap_collectives)
    path = art.save(args.out)
    print(f"prepared {args.arch} (scheme={args.scheme} "
          f"collective={art.manifest['policy']['collective']} "
          f"mesh={policy.mesh.shorthand()} tp={args.tp}) -> {path}: "
          f"{len(art.manifest['pairs'])} planned pair(s), "
          f"{len(art.manifest['leaf_shards'])} leaves, "
          f"{time.perf_counter() - t0:.1f}s on {device}")
    for site in art.manifest.get("collective_tuner", ()):
        # ':fused' choices run the wire kernel; attn_vo sites are the
        # attention folds' epilogues
        print(f"  tuned {site['path']} [{site.get('kind', 'pair')}]: "
              f"{site['chosen']} ({site['status']})")
    return path


def _artifact_plan(args, device):
    """(cfg, policy) of the artifact at ``args.artifact``: the manifest's
    arch and quant config, its plan at ``args.tp`` ranks, served by the
    backend ``--backend`` picks for ``device``."""
    art = DeploymentArtifact(
        manifest=DeploymentArtifact.load_manifest(args.artifact))
    man = art.manifest
    cfg = (get_smoke_config(man["arch_id"]) if man.get("smoke")
           else get_config(man["arch_id"]))
    cfg = cfg.with_quant(**man["quant"])
    policy = art.policy(backend=args.backend, device=device).with_(
        mesh=getattr(args, "mesh", None) or MeshPlan(tp=args.tp))
    if args.kv_page_size is not None or args.kv_bits is not None:
        # the cache layout is runtime-only: the flags override the
        # manifest's on the policy, never on cfg (its hash is the plan's)
        policy = policy.with_(kv=PageSpec(page_size=args.kv_page_size,
                                          bits=args.kv_bits))
    return cfg, policy


def _engine(args, device, group=None, ep_group=None):
    """(cfg, the engine: this rank's slices under TP).  Under ``--mesh``
    the policy names the grid, and a process reads only its own rank
    file of an artifact; an MoE model keeps its data rank's share of the
    experts (``ep_group``, expert parallelism)."""
    grid = getattr(args, "mesh", None)
    if args.artifact:
        cfg, policy = _artifact_plan(args, device)
    else:
        cfg, policy = _build_cfg(args, args.backend), None
        if grid is not None:
            policy = ExecutionPolicy.from_config(cfg, device=device).with_(
                mesh=grid)
    max_seq = args.prompt_budget + args.max_new + 1
    return cfg, make_engine(cfg, args.seed, device=device, max_seq=max_seq,
                            policy=policy, group=group,
                            artifact=args.artifact, ep_group=ep_group,
                            row_block=args.max_batch)


def _serve(args, device, group=None, transport="1 device"):
    """Build the engine, serve the seeded requests, and return (ids by
    request, the lines rank 0 prints, this rank's artifact ledger or
    None)."""
    cfg, engine = _engine(args, device, group)
    policy = engine.policy
    sched = Scheduler(engine, max_batch=args.max_batch,
                      prompt_budget=args.prompt_budget,
                      scfg=SamplingConfig(temperature=args.temperature,
                                          top_k=40),
                      seed=args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt_budget))
        sched.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new))
    done = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done.values())
    lines = [f"req {rid}: prompt {len(r.prompt):3d} -> {r.output[:8]}..."
             for rid, r in sorted(done.items())]
    source = f"artifact={args.artifact}" if args.artifact else \
        "in-memory plan"
    lines.append(
        f"\n{len(done)} requests, {total_new} tokens in {dt:.1f}s "
        f"({total_new / dt:.1f} tok/s) [scheme={policy.scheme} "
        f"backend={policy.backend} collective="
        f"{policy.collective.shorthand()} kv={policy.kv.shorthand()} "
        f"mesh={policy.mesh.shorthand()} ({transport}) "
        f"device={device} {source}]")
    lines.append(f"decode step: {engine.decode_mode}; "
                 f"attn V->O fold: {fold_layers(engine)}")
    st = engine.load_stats
    resident = None if st is None else (
        f"resident_artifact_bytes={st.file_bytes_loaded}/"
        f"{st.file_bytes_total} ranks={list(st.ranks)}")
    return {rid: r.output for rid, r in done.items()}, lines, resident


def fold_layers(engine) -> str:
    """How many layers' attention the engine runs through a V->O fold
    (``"36 layers"``), or ``"none"``."""
    def count(node) -> int:
        return sum(map(count, node)) if isinstance(node, list) else 1

    plans = (engine.aux or {}).get("attn_plans") or {}
    n = sum(count(v) for v in plans.values())
    return f"{n} layers" if n else "none"


def _http_kwargs(args) -> dict:
    """The scheduler's arguments under ``--http``, as every rank builds
    its scheduler."""
    return {"max_batch": args.max_batch, "prompt_budget": args.prompt_budget,
            "scfg": SamplingConfig(temperature=args.temperature, top_k=40),
            "seed": args.seed}


def _http_server(args, cfg, engine, device, group=None, tp_text="tp=1"):
    """Bind the server and print the banner."""
    from repro_torch.serving import ServingServer

    policy = engine.policy
    host, _, port = args.http.rpartition(":")
    try:
        srv = ServingServer(
            engine, host=host or "127.0.0.1", port=int(port or 0),
            queue_capacity=args.queue_capacity, group=group,
            **_http_kwargs(args))
    except ValueError as e:
        # the loop refuses batch-drain families (audio, vision)
        raise SystemExit(f"error: {e}") from None
    source = f"artifact={args.artifact}" if args.artifact else \
        "in-memory plan"
    print(f"serving {cfg.arch_id} on http://{srv.address[0]}:{srv.port} "
          f"[scheme={policy.scheme} backend={policy.backend} "
          f"collective={policy.collective.shorthand()} "
          f"kv={policy.kv.shorthand()} {tp_text} max_batch={args.max_batch} "
          f"queue={args.queue_capacity} device={device} {source}]",
          flush=True)
    return srv


def _serve_http(args, device):
    """Serve the engine over HTTP/SSE until interrupted (then drain)."""
    cfg, engine = _engine(args, device)
    _http_server(args, cfg, engine, device).serve_forever()


def _serve_http_rank(ctx, args):
    """One rank of ``--tp N --http``: rank 0 serves until an interrupt,
    then drains and sends ``stop``; the other ranks follow its
    boundaries on schedulers built as its own."""
    from repro_torch.serving import follow

    if ctx.rank:
        # a terminal's Ctrl-C reaches every process of its group: a
        # follower waits for rank 0's stop instead
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        _, engine = _engine(args, ctx.device, ctx.group)
        follow(Scheduler(engine, **_http_kwargs(args)), ctx.group)
        return None
    interrupted = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: interrupted.set())
    cfg, engine = _engine(args, ctx.device, ctx.group)
    srv = _http_server(args, cfg, engine, ctx.device, ctx.group,
                       f"tp={ctx.tp} ({ctx.transport})")
    srv.start()
    while not (interrupted.wait(0.2) or srv.loop.error is not None):
        pass
    srv.shutdown(drain=True)
    if srv.loop.error is not None:
        raise RuntimeError("the engine loop failed") from srv.loop.error
    return None


def _serve_rank(ctx, args):
    """One TP rank of ``--tp N``."""
    return _serve(args, ctx.device, ctx.group, ctx.transport)


def _serve_mesh(ctx, args) -> dict:
    """One process of ``--mesh``: its row's engine generates the data
    rank's share of the lockstep synthetic batch (the reference's
    ``_run_multiprocess``).  An MoE model spreads its experts over the
    process's data group (expert parallelism): every process steps in
    lockstep, as the all-to-alls need."""
    cfg, engine = _engine(args, ctx.device, ctx.group, ctx.data_group)
    b, dp = args.max_batch, ctx.dp
    plen = min(max(4, args.prompt_budget // 2), args.prompt_budget)
    tokens = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(b, plen))
    lo, hi = ctx.dp_rank * b // dp, (ctx.dp_rank + 1) * b // dp
    gen = torch.Generator(ctx.device).manual_seed(args.seed)
    t0 = time.perf_counter()
    ids = engine.generate(
        gen, torch.from_numpy(tokens[lo:hi]), [plen] * (hi - lo),
        max_new_tokens=args.max_new,
        scfg=SamplingConfig(temperature=args.temperature, top_k=40))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    st = engine.load_stats
    return {"process": ctx.process, "dp_rank": ctx.dp_rank,
            "rank": ctx.rank, "rows": (lo, hi),
            "ids": ids.cpu().tolist(), "seconds": time.perf_counter() - t0,
            "policy": engine.policy, "decode_mode": engine.decode_mode,
            "resident": None if st is None else (
                f"resident_artifact_bytes={st.file_bytes_loaded}/"
                f"{st.file_bytes_total} ranks={list(st.ranks)}" + (
                    f" resident_expert_bytes={st.expert_bytes_resident}/"
                    f"{st.expert_bytes_loaded}"
                    if engine.ep_group is not None else ""))}


def _run_mesh(args, device) -> list:
    """Serve the lockstep batch on the ``--mesh`` grid; print the banner
    and each process's lines, and return the ids row by row of the whole
    batch (the rows of each data rank's TP rank 0; the other ranks of a
    row must agree with it)."""
    plan = args.mesh
    if args.max_batch % plan.dp:
        raise SystemExit(f"error: --max-batch {args.max_batch} does not "
                         f"split over the {plan.dp} data ranks of --mesh "
                         f"{plan.shorthand()}")
    if plan.size == 1:
        results = [_serve_mesh(mesh.RankContext(rank=0, tp=1, group=None,
                                                device=device), args)]
    else:
        results = mesh.run(_serve_mesh, plan.tp, args, dp=plan.dp,
                           device_type=device.type)
    pol = results[0]["policy"]
    source = f"artifact={args.artifact}" if args.artifact else \
        "in-memory plan"
    carrier = mesh.transport(plan.tp, device.type, plan.dp)
    print(f"mesh={plan.shorthand()} ({carrier}) "
          f"[scheme={pol.scheme} backend={pol.backend} "
          f"collective={pol.collective.shorthand()} kv={pol.kv.shorthand()} "
          f"device={device} {source}]; decode step: "
          f"{results[0]['decode_mode']}")
    rows = []
    for r in results:
        resident = r["resident"] or \
            "resident_artifact_bytes=n/a (in-memory plan)"
        n = len(r["ids"]) * args.max_new
        print(f"mesh={plan.shorthand()} process={r['process']}/{plan.size} "
              f"{resident}")
        print(f"process {r['process']}/{plan.size}: data rank "
              f"{r['dp_rank']} rows {r['rows'][0]}-{r['rows'][1] - 1}: "
              f"generated {len(r['ids'])}x{args.max_new} tokens in "
              f"{r['seconds']:.1f}s ({n / r['seconds']:.1f} tok/s) "
              f"first={r['ids'][0][:8]}", flush=True)
        if r["rank"] == 0:
            rows += r["ids"]
        elif r["ids"] != results[r["process"] - r["rank"]]["ids"]:
            raise SystemExit(f"error: process {r['process']} emitted other "
                             f"tokens than its row's rank 0")
    return rows


def verify(argv=None) -> int:
    """``serve verify --artifact DIR``: the offline audit of a prepared
    artifact (``repro_torch.analysis``'s MF rules), then the collective
    contracts (CT001, CT002) for exactly the specs the artifact's plan
    resolves, at tp=1 and at the artifact's TP degree (its rank processes
    on ``--device``).  Prints every finding and ``verify DIR: N
    finding(s), E error(s)``; returns 1 on error findings, else 0."""
    from repro_torch.analysis import contracts, manifest_lint
    from repro_torch.analysis.findings import has_errors, to_json_text

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve verify")
    ap.add_argument("--artifact", required=True,
                    help="prepared DeploymentArtifact directory")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="write the findings as JSON")
    ap.add_argument("--device", default=None,
                    help="where the contracts' ranks run (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    device = _device(args)
    manifest = DeploymentArtifact.load_manifest(args.artifact)
    findings = manifest_lint.run(artifact=args.artifact)
    try:
        specs = parse_collective(manifest["policy"]["collective"]).specs()
    except ValueError:
        specs = ()              # MF006 reports the unparseable plan
    if specs:
        findings += contracts.lint_collectives(
            specs=[s.shorthand() for s in specs],
            tps=(1, int(manifest["tp"])), device=device)
    for f in findings:
        print(f"  {f}")
    errs = sum(1 for f in findings if f.severity == "error")
    print(f"verify {args.artifact}: {len(findings)} finding(s), "
          f"{errs} error(s)")
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(to_json_text(findings))
    return 1 if has_errors(findings) else 0


def serve_parser() -> argparse.ArgumentParser:
    """The serve command's arguments."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    _plan_args(ap)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch", "ref"],
                    help="dequant-GEMM kernel (cuda: the hand-written "
                         "kernels, for ordered layouts and for "
                         "naive-actorder's g_idx layout; auto: cuda for "
                         "ordered layouts on the card, else torch)")
    ap.add_argument("--artifact", default=None,
                    help="serve a prepared DeploymentArtifact directory "
                         "(its manifest is the plan: --arch, --smoke, "
                         "--scheme and --collective are ignored)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-budget", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ranks, one process each "
                         "(default: the artifact's, else 1)")
    ap.add_argument("--mesh", type=_mesh_plan, default=None,
                    help="serve a dpNxtpM grid of processes (M the plan's "
                         "TP degree): N data-parallel replicas of the TP "
                         "plan, each process reading only its own rank "
                         "file, over one lockstep synthetic batch")
    ap.add_argument("--http", default=None, metavar="[HOST]:PORT",
                    help="serve over HTTP/SSE instead of the synthetic "
                         "requests: POST /v1/generate streams token events, "
                         "GET /v1/health, GET /v1/stats (':0' binds a free "
                         "port)")
    ap.add_argument("--queue-capacity", type=int, default=64,
                    help="admission queue bound; a full wait line answers "
                         "429 + Retry-After (HTTP mode)")
    return ap


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "prepare":
        return prepare(argv[1:])
    if argv and argv[0] == "verify":
        return verify(argv[1:])
    args = serve_parser().parse_args(argv)

    device = _device(args)
    manifest = (DeploymentArtifact.load_manifest(args.artifact)
                if args.artifact else None)
    plan_tp = manifest["tp"] if manifest else args.tp
    if args.mesh is not None:
        tp = plan_tp or args.mesh.tp
        if args.mesh.tp != tp:
            raise SystemExit(
                f"error: --mesh {args.mesh.shorthand()} (tp={args.mesh.tp}) "
                f"disagrees with the plan's TP degree {tp}")
        args.tp = tp
    elif args.tp is None:
        args.tp = plan_tp or 1
    if args.http is not None:
        if args.mesh is not None and args.mesh.dp > 1:
            raise SystemExit(
                f"error: --http serves one TP group; --mesh "
                f"{args.mesh.shorthand()} has {args.mesh.dp} data-parallel "
                "replicas, and a front end over them needs a router "
                "(ROADMAP.md queue 1, item 9)")
        if args.tp == 1:
            return _serve_http(args, device)
        family = get_config(manifest["arch_id"] if manifest
                            else args.arch).family
        if family in ("audio", "vlm"):
            raise SystemExit(f"error: HTTP serving needs token-granularity "
                             f"stepping; family '{family}' only supports "
                             "batch-drain scheduling")
        mesh.run(_serve_http_rank, args.tp, args, device_type=device.type,
                 timeout=None, interrupt_to=0)
        return None
    if args.mesh is not None:
        return _run_mesh(args, device)
    if args.tp > 1:
        results = mesh.run(_serve_rank, args.tp, args,
                           device_type=device.type)
    else:
        results = [_serve(args, device)]
    outputs, lines, _ = results[0]
    print("\n".join(lines))
    for r, (_, _, resident) in enumerate(results):
        if resident is not None:
            print(f"rank {r}: {resident}")
    return outputs


if __name__ == "__main__":
    import sys

    # ``verify`` returns its exit code; the other commands return output
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
