"""Request scheduler; port of ``repro/runtime/scheduler.py``
(``Request``, ``StepEvent``, ``Scheduler`` in continuous mode, on the
dense cache or the paged one, and in batch-drain mode).

``run()`` picks the mode by the engine (``Engine.supports_continuous``):
the dense, MoE and recurrent families step continuously; the audio and
vision families, whose cross-attention prefill (frames, patches) is
batch-global, are batch-drained (``_run_batch``): up to ``max_batch``
queued requests at a time, their prompts right-padded to
``prompt_budget``, beside zero frames or patches (the reference's
stand-in for the stubbed front ends), through one ``Engine.generate``
of the longest ``max_new_tokens``, sampled from one generator per batch
drawn from the scheduler's seed; every request keeps its own
``max_new_tokens`` of the ids.  ``step()`` refuses these families.

One fixed-shape decode program steps all ``max_batch`` slots together,
each slot on its own clock; a finished slot takes the next queued request
at the next step boundary.  Prompt replay and generation are the same
decode loop.  The causal mask hides other slots' cache rows, so a
request's tokens do not depend on which other requests share the batch.
The recurrent families' state has no mask: a slot's lane is dirty once a
decode step has run over it (a request's, or the filler of an idle
slot), and a request admitted into a dirty lane has it zeroed first
(``Engine.reset_slot``, in place), the fresh cache's state, so its
tokens are those of a solo run through slot reuse too.  Under tensor
parallelism every rank runs the same scheduler over the same tokens, so
each resets the same lanes of its own share of the state.

Paged mode (``engine.uses_page_table``): a ``PagedCacheManager`` owns
per-slot page tables over a shared page pool.  Admission reserves each
request's worst-case page count, so growth never deadlocks mid-decode,
and credits prefix-shared pages: complete leading prompt pages that an
earlier request wrote skip replay (``fed0``).  The queue is FIFO; a head
the pool cannot hold yet waits (``can_admit``) rather than failing.

Cache lifetime: the decode cache (dense rows or the pool) is built on the
first step and freed by ``release_cache`` while idle, with the engine's
captured steps on it and the prefix LRU.

Each request owns a ``torch.Generator`` seeded from ``req.seed`` or from
(scheduler seed, rid); it draws only on the steps where the request emits
a token, so its stream does not depend on the batch either.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.cache import PagedCacheManager
from repro_torch.cache import paged as paged_pool
from repro_torch.device import derive_seed, new_generator
from repro_torch.runtime import sampling
from repro_torch.runtime.serve import Engine
from repro_torch.train.checkpoint import flatten_keys

#: seed part of batch-drain mode's per-batch sample streams
DRAIN_STREAM = 0x4452414E  # "DRAN"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (L,) int32
    max_new_tokens: int = 16
    # per-request overrides of the scheduler's SamplingConfig
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None
    family: Optional[str] = None   # None: the engine's own
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """What one decode step did to one request."""

    rid: int
    token: Optional[int]           # None for a pure retire (cancel)
    final: bool
    cancelled: bool = False


@dataclasses.dataclass
class _Slot:
    req: Request
    gen: torch.Generator           # this request's private sample stream
    fed: int = 0                   # tokens fed so far == this slot's pos
    last: int = 0                  # last sampled token


class Scheduler:
    def __init__(self, engine: Engine, *, max_batch: int = 8,
                 prompt_budget: int = 128,
                 scfg: sampling.SamplingConfig = sampling.SamplingConfig(),
                 seed: int = 0, n_pages: Optional[int] = None):
        self.engine = engine
        self.max_batch = max_batch
        self.prompt_budget = prompt_budget
        self.scfg = scfg
        self.seed = seed
        self.queue: deque[Request] = deque()
        self.finished: dict[int, Request] = {}
        #: (step, rid) admissions; step > 0 entries entered retired slots
        self.admissions: list[tuple[int, int]] = []
        self._cache = None
        self._slots: list[Optional[_Slot]] = []
        #: lanes a decode step has run over since the cache was built (a
        #: recurrent family's lane must be reset before its next request)
        self._dirty: list[bool] = []
        self._recurrent = engine.model.cfg.family in ("hybrid", "ssm")
        self._step_no = 0
        self._cache_builds = 0
        self._drained = 0               # batches of batch-drain mode
        self.manager = None
        if engine.uses_page_table:
            self.manager = PagedCacheManager(
                engine.policy.kv, max_batch=max_batch,
                max_seq=engine.max_seq, n_pages=n_pages)

    def submit(self, req: Request):
        family = self.engine.model.cfg.family
        if req.family is not None and req.family != family:
            raise ValueError(
                f"request {req.rid} is for family '{req.family}' but this "
                f"scheduler's engine serves '{family}': run one Scheduler "
                "per family")
        if req.prompt.size > self.prompt_budget:
            raise ValueError(
                f"prompt {req.prompt.size} > budget {self.prompt_budget}")
        if req.prompt.size + req.max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt {req.prompt.size} + max_new {req.max_new_tokens} "
                f"> engine max_seq {self.engine.max_seq}")
        if self.manager is not None:
            worst = self.manager.pages_needed(req.prompt.size,
                                              req.max_new_tokens)
            if worst > self.manager.n_pages:
                raise ValueError(
                    f"request {req.rid} needs {worst} pages worst-case but "
                    f"the pool only has {self.manager.n_pages} — it can "
                    "never be admitted")
        self.queue.append(req)

    def can_admit(self, req: Request) -> bool:
        """Would ``step()`` admit this request now, given a free slot?
        Always for a dense cache; in paged mode its worst-case pages must
        fit the pool beside everything live or already queued."""
        if self.manager is None:
            return True
        pending = sum(self.manager.pages_needed(r.prompt.size,
                                                r.max_new_tokens)
                      for r in self.queue)
        return self.manager.can_admit(req.prompt.size, req.max_new_tokens,
                                      pending_pages=pending)

    def cancel(self, rid: int) -> bool:
        """Retire a request: a queued one at once, a live one at the next
        step boundary.  False for unknown or finished rids."""
        live = [s.req for s in self._slots if s is not None]
        for req in (*self.queue, *live):
            if req.rid == rid and not req.cancelled:
                req.cancelled = True
                return True
        return False

    @property
    def live_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def steps(self) -> int:
        """Decode steps run so far."""
        return self._step_no

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.live_slots > 0

    def run(self) -> dict[int, Request]:
        """Drain the queue; returns {rid: finished request}.  Continuous
        families step at token granularity; the others drain the queue a
        batch at a time (``_run_batch``)."""
        if self.engine.supports_continuous:
            while self.has_work:
                self.step()
            return self.finished
        while self.queue:
            batch = [self.queue.popleft()
                     for _ in range(min(self.max_batch, len(self.queue)))]
            self._run_batch(batch)
        return self.finished

    def _run_batch(self, batch: list[Request]):
        """Batch-drain mode: serve ``batch`` through one
        ``Engine.generate`` (the reference's ``_run_batch``)."""
        b, s = len(batch), self.prompt_budget
        cfg, dev = self.engine.model.cfg, self.engine.device
        tokens = np.zeros((b, s), np.int64)
        plen = np.zeros((b,), np.int64)
        for i, r in enumerate(batch):
            tokens[i, :r.prompt.size] = r.prompt
            plen[i] = r.prompt.size
        inputs = {"tokens": torch.from_numpy(tokens)}
        if cfg.family == "audio":
            inputs["frames"] = torch.zeros(
                (b, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        if cfg.family == "vlm":
            inputs["patches"] = torch.zeros(
                (b, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        max_new = max(r.max_new_tokens for r in batch)
        gen = new_generator(derive_seed(self.seed, DRAIN_STREAM,
                                        self._drained), dev)
        self._drained += 1
        out = self.engine.generate(gen, inputs, torch.from_numpy(plen),
                                   max_new_tokens=max_new,
                                   scfg=self.scfg).cpu().numpy()
        for i, r in enumerate(batch):
            r.output = out[i, :r.max_new_tokens].tolist()
            r.done = True
            self.finished[r.rid] = r

    def _request_generator(self, req: Request) -> torch.Generator:
        seed = req.seed if req.seed is not None else derive_seed(self.seed,
                                                                 req.rid)
        return new_generator(seed, self.engine.device)

    def _finish(self, i: int, events: list, *, cancelled: bool = False):
        req = self._slots[i].req
        req.done = True
        self.finished[req.rid] = req
        if cancelled:
            events.append(StepEvent(req.rid, None, True, cancelled=True))
        self._retire_slot(i)

    def _retire_slot(self, i: int):
        """Free slot ``i``: in paged mode its pages go back (complete
        shared prefix pages park in the allocator's LRU)."""
        self._slots[i] = None
        if self.manager is not None:
            self.manager.release(i)

    def _build_cache(self):
        b = self.max_batch
        if self.manager is not None:
            # pool_pages = n_pages + 1: idle lanes scatter into the
            # trailing scratch page (cache/manager.py)
            self._cache = self.engine.init_paged_cache(
                self.manager.pool_pages)
            (self.manager.page_bytes,
             self.manager.page_bytes_fp) = paged_pool.pool_page_bytes(
                 self._cache, self.manager.pool_pages)
        else:
            self._cache = self.engine.init_cache(b)
        self._slots = [None] * b
        self._dirty = [False] * b
        self._cache_builds += 1

    def release_cache(self) -> bool:
        """Drop the decode cache while idle, so a long-lived serving loop
        does not hold peak-batch cache memory between bursts; the engine's
        captured steps on it and the prefix LRU (whose pages index the
        pool) go with it.  False (a no-op) while a request is live or
        queued, or with no cache; the next ``step()`` builds it again."""
        if self.live_slots or self.queue or self._cache is None:
            return False
        if self.manager is not None:
            self.manager.reset()
        self.engine.release(self._cache)
        self._cache = None
        self._slots = []
        self._dirty = []
        return True

    def cache_stats(self) -> dict:
        """Cache telemetry for the stats endpoint, in the reference's
        keys."""
        out: dict = {"allocated": self._cache is not None,
                     "builds": self._cache_builds}
        if self.manager is None:
            out["spec"] = "dense"
            if self._cache is not None:
                out["bytes"] = {"pool": sum(
                    t.numel() * t.element_size()
                    for t in flatten_keys(self._cache).values())}
            return out
        out.update(self.manager.stats())
        out["per_request_pages"] = {
            s.req.rid: self.manager.slot_pages(i)
            for i, s in enumerate(self._slots) if s is not None}
        return out

    def step(self) -> list[StepEvent]:
        """One admission + decode step; returns a ``StepEvent`` per request
        that emitted a token or was retired.  Raises for a batch-drain
        family (use ``run()``)."""
        if not self.engine.supports_continuous:
            raise RuntimeError(
                f"family '{self.engine.model.cfg.family}' does not support "
                "token-granularity stepping (batch-drain only) — use run()")
        b = self.max_batch
        if self._cache is None:
            self._build_cache()
        slots = self._slots
        events: list[StepEvent] = []

        if any(r.cancelled for r in self.queue):
            kept: deque[Request] = deque()
            for req in self.queue:
                if req.cancelled:
                    req.done = True
                    self.finished[req.rid] = req
                    events.append(StepEvent(req.rid, None, True,
                                            cancelled=True))
                else:
                    kept.append(req)
            self.queue = kept
        for i in range(b):
            if slots[i] is not None and slots[i].req.cancelled:
                self._finish(i, events, cancelled=True)

        # FIFO admission into free slots; in paged mode the head waits
        # until its worst-case pages fit (no later request jumps it)
        for i in range(b):
            if slots[i] is None and self.queue:
                req = self.queue[0]
                fed0 = 0
                if self.manager is not None:
                    if not self.manager.can_admit(req.prompt.size,
                                                  req.max_new_tokens):
                        break
                    fed0 = self.manager.admit(i, req.prompt,
                                              req.max_new_tokens)
                elif self._recurrent and self._dirty[i]:
                    self._cache = self.engine.reset_slot(self._cache, i)
                    self._dirty[i] = False
                self.queue.popleft()
                slots[i] = _Slot(req=req, gen=self._request_generator(req),
                                 fed=fed0)
                self.admissions.append((self._step_no, req.rid))
        if not any(slots):
            return events

        tokens = np.zeros((b,), np.int64)
        pos = np.zeros((b,), np.int64)
        temperature = np.zeros((b,), np.float32)
        top_p = np.ones((b,), np.float32)
        top_k = np.zeros((b,), np.int64)
        gens: list[Optional[torch.Generator]] = [None] * b
        for i, s in enumerate(slots):
            if s is None:
                continue
            plen = s.req.prompt.size
            tokens[i] = s.req.prompt[s.fed] if s.fed < plen else s.last
            pos[i] = s.fed
            temperature[i] = (self.scfg.temperature if s.req.temperature
                              is None else s.req.temperature)
            p = self.scfg.top_p if s.req.top_p is None else s.req.top_p
            top_p[i] = 1.0 if p is None else p
            top_k[i] = 0 if self.scfg.top_k is None else self.scfg.top_k
            if s.fed + 1 >= plen:          # this step emits a token
                gens[i] = s.gen

        dev = self.engine.device
        pages = None
        if self.manager is not None:
            for i, s in enumerate(slots):
                if s is not None:
                    self.manager.ensure(i, s.fed)   # page for this scatter
            pages = torch.from_numpy(self.manager.table()).to(dev)
        logits, self._cache = self.engine.decode(
            self._cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev), pages)
        self._dirty = [True] * b
        sampled = sampling.sample_slots(
            gens, logits, torch.from_numpy(temperature).to(dev),
            torch.from_numpy(top_p).to(dev),
            torch.from_numpy(top_k).to(dev)).tolist()

        for i, s in enumerate(slots):
            if s is None:
                continue
            s.fed += 1
            if self.manager is not None:
                # owned prompt pages now fully written become shareable
                self.manager.advance(i, s.fed)
            if s.fed >= s.req.prompt.size:
                s.last = int(sampled[i])
                s.req.output.append(s.last)
                final = len(s.req.output) >= s.req.max_new_tokens
                events.append(StepEvent(s.req.rid, s.last, final))
                if final:
                    self._finish(i, events)
        self._step_no += 1
        return events
