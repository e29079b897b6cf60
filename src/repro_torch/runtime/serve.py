"""Serving engine: prefill and decode steps over a registry model; port of
``repro/runtime/serve.py`` (``Engine``, ``make_engine``: params made in
memory from a seed, or served from a prepared ``DeploymentArtifact``).

Prefill replays the prompt through the decode step, exactly as the
reference does, so prompt and generation share one numeric path.
``prefill_logits`` is the full-sequence forward (the reference's
``prefill_logits``), whose attention ``attn_backend`` picks.  Batching
across requests is the scheduler's job (``runtime/scheduler.py``); under
a paged policy (``policy.kv``) it steps a page pool (``init_paged_cache``)
through ``decode(..., pages=table)``, while ``prefill`` and ``generate``
keep the dense cache, as the reference's do.

The reference jits its decode step once (``jax.jit(decode,
donate_argnums=1)``) and replays that program for every token.  The
port's counterpart is a CUDA graph: on the card, ``Engine.decode``
captures the step once per batch size and replays it, writing into the
cache in place as the donated buffers let XLA do.  A paged step's graph
also reads the page table from a static buffer that each replay fills
from the scheduler's table, as it fills tokens and positions.
``decode_eager`` is the step run op by op; it is what the CPU runs, and
what tp > 1 runs.

Under tensor parallelism every rank runs its own ``Engine`` over its
slices of the params with its row's process group (``group``: the ``tp``
ranks of one row of a ``dp x tp`` grid, ``launch/mesh.py``, so each row
is an engine of its own, a data-parallel replica); the logits are
gathered whole on every rank, so every rank samples the same tokens from
identically seeded generators.  The policy's ``mesh`` names the grid the
plan is served on; its TP degree must be the group's.  With a
group the step stays eager: the collectives go through gloo and host
memory (``launch/mesh.py``), which a CUDA graph cannot hold.

An MoE engine of a grid with ``dp > 1`` also takes its data group
(``ep_group``): it keeps only its ``1 / dp`` of each layer's experts
(``Model.keep_experts``) and every MoE layer sends its tokens to the
experts' owners by an all-to-all over that group, so the data ranks
step in lockstep and the step stays eager.

The audio and vision families (whisper, the vision model) attend to a
source besides their tokens: ``prefill`` and ``generate`` take the
reference's ``batch_inputs`` dict, encode its ``"frames"`` (under
``attn_backend``) or take its ``"patches"``, and write their cross K/V
into the cache in place (``Model.prefill_cross``) before the prompt
replay, so a captured step keeps the cache's addresses; the cache is
nested (``{"self": ..., "cross_k", "cross_v"}``) and a step's graph is
keyed by every leaf.  These families are batch-drained by the
scheduler (``supports_continuous``).

The recurrent families (rwkv6, recurrentgemma) step continuously: their
fixed-size per-slot state (shift rows, wkv, conv and LRU states, the
local K/V ring) is written in place by every step like the KV cache, and
``reset_slot`` zeroes a slot's lane in place before a new request
enters it.  Under a paged policy they keep that dense state
(``uses_page_table``).

An artifact's aux plans (attention V->O folds, ``Engine.aux``) are kept
once, at construction, as (nested) lists of per-layer folds on the
engine's device, each rank's heads of them under TP; every forward and
decode step runs them, and the captured step holds their addresses as
it holds the params'.  Folds the family waives (whisper's encoder and
cross folds, the vision model's cross folds) are not kept.

Every forward and decode step runs its library products in blocks of
``Engine.row_block`` rows (``models/common.row_stable``), so a row's
bits do not depend on how many rows come with it: a request served in a
batch gets the logits it gets alone.  ``row_block`` is best the
scheduler's ``max_batch`` (the serve CLI makes it so): a full batch then
runs each product once, unpadded, and a lone request pads to it.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Optional

import torch

from repro_torch.comm import dispatch as comm
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.topology import MeshPlan
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.registry import Model, build_model
from repro_torch.plan.artifact import DeploymentArtifact
from repro_torch.runtime import sampling
from repro_torch.train.checkpoint import flatten_keys, map_tensors


@dataclasses.dataclass
class StepGraph:
    """One captured decode step: the CUDA graph, the static buffers every
    replay reads and writes, the cache it writes into, and what its
    capture counted and cost."""

    graph: Any                  # torch.cuda.CUDAGraph
    cache: tuple                # _step_key of the cache and page table
    tokens: torch.Tensor        # (B,) int64, read by each replay
    pos: torch.Tensor           # (B,) int64, read by each replay
    pages: Optional[torch.Tensor]  # (B, Pmax) page table (paged), or None
    logits: torch.Tensor        # (B, V) float32, written by each replay
    launches: tuple             # ops.launch_counts() of one replay
    seconds: float              # wall time of the capture
    pool_bytes: int             # device memory the capture reserved


def _cache_key(cache) -> tuple:
    """Where a cache's tensors live, every leaf by its key path, nested
    entries included (a dense cache's k/v, a pool's k/v and its quantized
    pages' scales and zeros, the audio and vision families' ``self``
    entry beside their cross K/V): a graph reads and writes these
    addresses."""
    return tuple((name, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for name, t in sorted(flatten_keys(cache).items()))


def _step_key(cache, pages) -> tuple:
    """What a captured step is bound to: the cache's addresses, and the
    shape and dtype of the page table it reads (None: a dense step)."""
    table = None if pages is None else (tuple(pages.shape), pages.dtype)
    return _cache_key(cache), table


def _fill_positions(buf: torch.Tensor, pos) -> None:
    """Write ``pos`` (an int for every slot, or a (B,) tensor) into the
    (B,) buffer ``buf`` on the card, with no copy from the host."""
    if torch.is_tensor(pos):
        buf.copy_(pos.expand(buf.shape))
    else:
        buf.fill_(int(pos))


@dataclasses.dataclass
class Engine:
    model: Model
    params: Any
    device: torch.device
    max_seq: int = 2048
    window: Optional[int] = None
    # The deployment plan every quantized GEMM runs under; None derives
    # it from the model config for ``device`` and the group's TP degree.
    policy: Optional[ExecutionPolicy] = None
    # Attention of the full-sequence forward (``prefill_logits``): "xla"
    # (einsum) or "flash" (the kernel); the reference's
    # ``ParallelContext.attn_backend``.  Decode never uses it.
    attn_backend: str = "xla"
    # The process group of the TP ranks (``launch/mesh.py``); None runs on
    # one device.  ``params`` are then this rank's slices.
    group: Any = None
    #: what this rank read of an artifact (``dist.loader.RankLoadStats``);
    #: None for params made in memory or loaded whole
    load_stats: Any = None
    #: the data ranks an MoE model's experts are spread over (expert
    #: parallelism; ``params`` then hold this rank's experts only); None:
    #: every expert is here
    ep_group: Any = None
    #: the artifact's aux plans (``{"attn_plans": {path: fold}}``, folds
    #: stacked over the layers or per-layer lists); kept as per-layer
    #: lists of this rank's heads on ``device``
    aux: Any = None
    #: the row block of every step's library products (``cm.row_blocks``)
    row_block: int = cm.ROW_BLOCK
    #: the captured decode steps by batch size (``decode`` on the card)
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)
    #: decode-step captures so far: one per batch size, and one more each
    #: time a batch size's cache moves
    captures: int = dataclasses.field(default=0, init=False)
    _stream: Any = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.policy is None:
            self.policy = default_policy(self.model.cfg, self.device,
                                         self.tp)
        check_mesh(self.policy, self.tp)
        self.aux = self._rank_aux(self.aux)

    def _rank_aux(self, aux):
        """The aux tree as this rank serves it: the fold the model
        consumes (at ``attn_vo_path``; the folds its family waives are
        dropped) as (nested) lists of per-layer folds of this rank's
        heads, contiguous on ``device``.  A fold stacked over the layer
        dims (as the artifact holds it) is split and sliced; a list is
        taken as this rank's already (so an engine ``dataclasses.replace``
        makes from this one keeps it)."""
        from repro_torch.core.attention_fold import shard_attention_vo
        from repro_torch.models.common import head_grid

        if not aux:
            return None
        cfg = self.model.cfg
        kvp, _, hp = head_grid(cfg)
        rank = comm.axis_index(self.group)

        def mine(vo):
            if isinstance(vo, list):
                return vo
            if vo.up.qweight.dim() > 2:
                return [mine(map_tensors(vo, lambda _, t, i=i: t[i]))
                        for i in range(vo.up.qweight.shape[0])]
            return shard_attention_vo(vo, self.tp, n_heads=hp,
                                      n_kv_heads=kvp,
                                      head_dim=cfg.head_dim)[rank]

        plans = {path: map_tensors(mine(vo), lambda _, t: t.to(self.device))
                 for path, vo in (aux.get("attn_plans") or {}).items()
                 if path == self.model.attn_vo_path}
        return dict(aux, attn_plans=plans)

    @property
    def tp(self) -> int:
        return comm.axis_size(self.group)

    def init_cache(self, batch: int):
        return self.model.init_cache(batch, self.max_seq, window=self.window,
                                     device=self.device, tp=self.tp)

    @property
    def supports_continuous(self) -> bool:
        """The scheduler may step this model at token granularity on
        per-slot positions.  The dense and MoE families qualify because
        their whole decode state is the position-masked KV cache: a
        reused slot's stale rows are hidden by the ``j <= pos`` mask.  The
        recurrent families (``hybrid``, ``ssm``) carry per-slot state with
        no mask; the scheduler zeroes a re-admitted slot's lane
        (``reset_slot``), the fresh cache's state, so they step
        continuously too.  The audio and vision families are
        batch-drained: their cross-attention prefill (frames, patches) is
        batch-global."""
        return self.model.cfg.family in ("dense", "moe", "hybrid", "ssm")

    @torch.inference_mode()
    def reset_slot(self, cache, slot: int):
        """Zero lane ``slot`` (dim 1, the batch of every leaf: ``(L, B,
        ...)``) of every leaf of ``cache``, the local attention's K/V
        included, **in place**, so a captured step's addresses stay
        valid; returns the cache.  A recurrent family's re-admitted slot
        so starts from the fresh cache's state."""
        for leaf in flatten_keys(cache).values():
            leaf[:, slot].zero_()
        return cache

    @property
    def uses_page_table(self) -> bool:
        """Decode steps take a page table: a paged policy and a family
        whose KV grows with the sequence."""
        return self.policy.kv.paged and self.model.supports_paged

    def init_paged_cache(self, n_pages: int):
        """The page pool of ``policy.kv`` with ``n_pages`` physical pages
        (the manager's ``pool_pages``), this rank's KV heads."""
        spec = self.policy.kv
        return self.model.init_paged_cache(n_pages, spec.page_size,
                                           bits=spec.bits,
                                           device=self.device, tp=self.tp)

    def release(self, cache) -> None:
        """Drop the captured steps that write into ``cache`` (it is being
        freed), so their graph pools go with it."""
        key = _cache_key(cache)
        for b in [b for b, g in self.graphs.items() if g.cache[0] == key]:
            del self.graphs[b]

    def _batch(self, batch_inputs) -> dict:
        """The reference's ``batch_inputs`` dict (``"tokens"``, and the
        audio and vision families' ``"frames"`` or ``"patches"``) on
        ``device``; a bare tokens tensor is ``{"tokens": tokens}``."""
        if torch.is_tensor(batch_inputs):
            batch_inputs = {"tokens": batch_inputs}
        return {k: v.to(self.device) for k, v in batch_inputs.items()}

    @torch.inference_mode()
    def prefill_logits(self, batch_inputs) -> torch.Tensor:
        """The full-sequence forward: tokens (B, S), or the reference's
        ``batch_inputs`` dict -> logits (B, S, V) (the reference's
        ``prefill_logits``)."""
        with cm.row_blocks(self.row_block):
            return self.model.forward(self.params, self._batch(batch_inputs),
                                      self.policy, window=self.window,
                                      attn_backend=self.attn_backend,
                                      group=self.group, aux=self.aux,
                                      ep_group=self.ep_group)

    @property
    def decode_mode(self) -> str:
        """How ``decode`` runs the step, as the serve banner names it."""
        if self.group is not None or self.ep_group is not None:
            group = self.group if self.group is not None else self.ep_group
            backend = torch.distributed.get_backend(group)
            ep = ("" if self.ep_group is None else
                  f"ep={comm.axis_size(self.ep_group)} ")
            return f"eager ({ep}tp={self.tp} over {backend})"
        if self.device.type != "cuda":
            return f"eager ({self.device.type})"
        return f"CUDA graph, {self.captures} captures"

    @torch.inference_mode()
    def decode(self, cache, tokens: torch.Tensor, pos, pages=None):
        """One decode step: tokens (B,), pos int or (B,) -> (logits, cache).
        The cache is updated in place; the logits are the caller's own.
        ``pages``: the (B, Pmax) page table of a page pool ``cache``.

        On the card with one rank this replays the step's CUDA graph, the
        counterpart of the reference's jitted step, bit-equal to
        ``decode_eager``.  The graph is captured at the first call of a
        batch size, and again when that batch size's cache is at other
        addresses or the step changes between dense and paged; a
        capturing call runs its step eagerly first on the capture stream
        (the kernels build at first use, cuBLAS makes its handle and
        workspace) and returns that step's logits.  A capture
        or a replay that fails raises.  On the CPU, and with a TP group
        (gloo through host memory, which no graph can hold), this is
        ``decode_eager``; so it is with an ``ep_group``.
        """
        if (self.device.type != "cuda" or self.group is not None
                or self.ep_group is not None):
            return self.decode_eager(cache, tokens, pos, pages)
        step = self.graphs.get(tokens.shape[0])
        if step is None or step.cache != _step_key(cache, pages):
            return self._capture(cache, tokens, pos, pages)
        step.tokens.copy_(tokens)
        _fill_positions(step.pos, pos)
        if pages is not None:
            step.pages.copy_(pages)
        step.graph.replay()
        ops.add_launch_counts(step.launches)
        return step.logits.clone(), cache

    @torch.inference_mode()
    def decode_eager(self, cache, tokens: torch.Tensor, pos, pages=None):
        """The decode step run op by op (the reference's un-jitted
        ``decode``): tokens (B,), pos int or (B,) -> (logits, cache).  A
        paged step's attention reads ``max_seq`` positions, the dense
        cache's capacity."""
        with cm.row_blocks(self.row_block):
            return self.model.decode_step(
                self.params, cache, tokens, pos, self.policy,
                window=self.window, group=self.group, pages=pages,
                kv_len=self.max_seq, aux=self.aux, ep_group=self.ep_group)

    def _capture(self, cache, tokens: torch.Tensor, pos, pages=None):
        """Run this call's step eagerly on the capture stream, capture the
        step on per-slot positions (the path that reads its positions from
        the card) for this batch size and cache, and return the eager
        step's result.  The capture's launch counts are taken back, since
        it launched nothing, and each replay adds them."""
        dev = self.device
        b = tokens.shape[0]
        self.graphs.pop(b, None)            # its graph and pool go first
        static_tokens = torch.empty(b, dtype=torch.int64, device=dev)
        static_pos = torch.empty(b, dtype=torch.int64, device=dev)
        static_tokens.copy_(tokens)
        _fill_positions(static_pos, pos)
        static_pages = None
        if pages is not None:
            static_pages = torch.empty(pages.shape, dtype=pages.dtype,
                                       device=dev)
            static_pages.copy_(pages)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        current = torch.cuda.current_stream(dev)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            logits, _ = self.decode_eager(cache, static_tokens, static_pos,
                                          static_pages)
        logits.record_stream(current)
        torch.cuda.synchronize(dev)
        # dead cycles are collected now, and no collection runs during the
        # capture: a graph the cyclic collector frees there (of an engine
        # dropped earlier) resets itself, which the capturing stream
        # forbids, and the capture is invalidated
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                static_logits, _ = self.decode_eager(
                    cache, static_tokens, static_pos, static_pages)
        finally:
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        launches = tuple(a - c for a, c in zip(ops.launch_counts(), counts))
        ops.add_launch_counts(-n for n in launches)
        self.graphs[b] = StepGraph(
            graph=graph, cache=_step_key(cache, pages),
            tokens=static_tokens, pos=static_pos, pages=static_pages,
            logits=static_logits, launches=launches,
            seconds=seconds,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved)
        self.captures += 1
        return logits, cache

    @torch.inference_mode()
    def prefill(self, batch_inputs, cache, prompt_len: torch.Tensor):
        """Replay right-padded prompts (B, S) through the decode step;
        returns (logits at each row's last prompt token (B, V), cache).
        ``batch_inputs``: the tokens, or the reference's dict of them and,
        for the audio and vision families, the ``"frames"`` or
        ``"patches"``: those are first encoded (under ``attn_backend``)
        or taken as they are, and their cross K/V written into the cache
        in place (``Model.prefill_cross``), as the reference's prefill
        does before the replay."""
        batch = self._batch(batch_inputs)
        tokens = batch["tokens"]
        if self.model.has_cross:
            with cm.row_blocks(self.row_block):
                self.model.prefill_cross(self.params, batch, cache,
                                         self.policy,
                                         attn_backend=self.attn_backend,
                                         group=self.group)
        b, s = tokens.shape
        last = torch.zeros((b, self.model.cfg.vocab_size),
                           dtype=torch.float32, device=self.device)
        for t in range(s):
            logits, cache = self.decode(cache, tokens[:, t], t)
            keep = (prompt_len == t + 1)[:, None]
            last = torch.where(keep, logits, last)
        return last, cache

    @torch.inference_mode()
    def generate(self, gen: Optional[torch.Generator], batch_inputs,
                 prompt_len, *, max_new_tokens: int = 32,
                 scfg: sampling.SamplingConfig = sampling.SamplingConfig()):
        """Batched generation; returns (B, max_new_tokens) token ids.
        ``batch_inputs``: the tokens (B, S) or the reference's dict
        (``prefill``); ``gen`` draws the samples (unused when greedy)."""
        batch = self._batch(batch_inputs)
        prompt_len = torch.as_tensor(prompt_len, device=self.device)
        cache = self.init_cache(batch["tokens"].shape[0])
        logits, cache = self.prefill(batch, cache, prompt_len)
        pos = int(prompt_len.max())
        tok = sampling.sample(gen, logits, scfg)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.decode(cache, tok, pos + i)
            tok = sampling.sample(gen, logits, scfg)
            out.append(tok)
        return torch.stack(out, dim=1)


def default_policy(cfg, device: torch.device, tp: int) -> ExecutionPolicy:
    """The config's plan for ``device`` and ``tp`` ranks."""
    return ExecutionPolicy.from_config(cfg, device=device).with_(
        mesh=MeshPlan(tp=tp))


def check_mesh(policy: ExecutionPolicy, tp: int) -> None:
    """Raise unless ``policy.mesh`` plans the ``tp`` ranks that run it (the
    TP degree only: a ``dp2xtp2`` policy runs on each row's 2 ranks)."""
    if policy.mesh.tp != tp:
        raise ValueError(
            f"policy mesh {policy.mesh.shorthand()} plans tp="
            f"{policy.mesh.tp}, but {tp} rank(s) run it")


def make_engine(cfg, seed: int = 0, *, device: DeviceLike = None,
                max_seq: int = 2048, window=None,
                policy: Optional[ExecutionPolicy] = None,
                group=None, artifact=None, ep_group=None,
                row_block: int = cm.ROW_BLOCK) -> Engine:
    """Build an engine on ``device`` (default: the CUDA card); with the TP
    ranks' ``group`` (a row of the grid), over this rank's slices of the
    params.  A ``policy`` whose mesh's TP degree does not match the group
    raises before any weight is made.

    Without ``artifact``, ``Model.init`` makes the params from ``seed``.
    With one (a ``DeploymentArtifact`` or its directory), the engine
    serves its plan: no quantize and no layout at load.  From a
    directory, a rank of a group (and a process of a grid whose policy
    mesh has ``dp > 1``, at tp=1 too) reads only its own ``rank_NN.npz``
    (``dist.loader.load_per_rank``; ``Engine.load_stats`` keeps the
    ledger), one device all of them (``DeploymentArtifact.load``); either
    way onto the host first, with the artifact's aux plans (the attention
    folds, ``Engine.aux``).  The artifact is validated against ``cfg``,
    the effective policy and the group's TP degree before any weight
    reaches ``device``: a mismatched plan raises ``PlanMismatchError``.
    The params are in place before the first decode step, so the captured
    step holds their addresses.

    ``ep_group``: this process's data group (``RankContext.data_group``).
    For a model with MoE experts it is the engine's expert-parallel
    group: the process keeps only its data rank's ``1 / dp`` of each
    layer's experts: made from the seed, it stages every expert but
    keeps only its own (``Model.init(ep=)``); read from an artifact
    (rank files are cut by the model axis only), it cuts them from the
    whole file, and ``load_stats`` records the expert bytes kept against
    those read.  Other families ignore it.  ``row_block``: the row
    block of the steps' library products (``Engine.row_block``; best the
    scheduler's ``max_batch``)."""
    dev = resolve_device(device)
    tp = comm.axis_size(group)
    rank = comm.axis_index(group)
    if policy is not None:
        check_mesh(policy, tp)
    model = build_model(cfg)
    load_stats = aux = None
    ep = comm.axis_size(ep_group) if model.supports_experts else 1
    if ep == 1:
        ep_group = None
    if artifact is None:
        params = model.init(seed, device=dev, tp=tp, rank=rank, ep=ep,
                            ep_rank=comm.axis_index(ep_group))
    else:
        plan = dict(cfg=cfg, tp=tp, policy=(
            policy if policy is not None else default_policy(cfg, dev, tp)))
        if not isinstance(artifact, DeploymentArtifact):
            # the manifest alone first, before any rank file is read
            DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
                artifact)).validate(**plan)
            artifact = (
                DeploymentArtifact.load_rank(artifact, rank, device="cpu")
                if group is not None or (policy is not None
                                         and policy.mesh.dp > 1)
                else DeploymentArtifact.load(artifact, device="cpu"))
        artifact.validate(**plan)
        params, load_stats, aux = (artifact.rank_tree(rank),
                                   artifact.load_stats, artifact.aux)
        if ep > 1:
            read = model.expert_bytes(params)
            params = model.keep_experts(params, ep,
                                        comm.axis_index(ep_group))
            if load_stats is not None:
                load_stats = dataclasses.replace(
                    load_stats, expert_bytes_loaded=read,
                    expert_bytes_resident=model.expert_bytes(params))
        params = map_tensors(params, lambda _, t: t.to(dev))
    return Engine(model=model, params=params, device=dev, max_seq=max_seq,
                  window=window, policy=policy, group=group,
                  load_stats=load_stats, aux=aux, ep_group=ep_group,
                  row_block=row_block)
