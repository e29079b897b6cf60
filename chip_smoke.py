#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root, one H100

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
  2. build: nvcc of the five kernels for sm_90a, all started together;
     each one's build seconds, ptxas registers and shared memory (K2's at
     head dims 128 and 256), and the registers and spill bytes of K2's
     head-dim-256 instances and of K1's float32 decode loop's instances
     in K1 and K3 (none may spill)
  3. check: each CUDA kernel against its plain torch version, float32 and
     bfloat16: the ordered dequant-GEMM (K1) and the g_idx dequant-GEMM
     (K4) at the reference's test shapes, gs=76, ragged edges, the
     full-width qwen3-4b MLP shapes and, at M 1 and 4, the other archs'
     (granite's down gs 100, mistral-large's down G 224: K4's largest
     table on a path) (K4 also at G 304, N 130, and M 1, 5,
     17 and 33 at both full-width shapes, and its batch invariance: rows
     of M=4 and M=17 calls bit-equal to M=1 calls, and its 16- and
     32-column tiles bit-equal), and K1 at large M (its tensor-core
     loop in float32: the full-width shapes at M=2048, ragged M around the
     loop's threshold, ragged N and K) and K1's float32 batch invariance
     (rows of M 4, 8, 17, 64 and 255 calls bit-equal to M=1 calls at both
     full-width shapes: its decode loop on the tensor cores); the
     dequantize kernel (K5)
     bit-equal (also at granite's shapes, gs 100);
     flash attention (K2) at the reference's test shapes, the edges of
     its 128-query, 64-key tiling (ragged S, windows, S != T, every head
     dim at S 2048) and the full-width forward's, and at head dim 256 the
     edges of its 64-query, 32-key tiling and recurrentgemma's forward
     shape (B1 H10 S2048, window 2048), float32 and bfloat16; the fused
     dequant-GEMM
     + wire quantize (K3) bit-equal to K1 followed by the collective's
     quantizer (also above K1's tensor-core threshold, at quant blocks
     that make epilogue units of several tiles, and at granite's and
     starcoder2's tp=2 down shards), and within one
     quantization level of its plain version; K3's repeat check (the same
     call twice and after a call of another shape bit-equal: its counters
     reset) and one device kernel a call (the nodes of its CUDA graph),
     in both loops
  4. timing: full-width launches (CUDA-graph replay, weights beyond L2)
     against their bounds and plain versions: K1 and K4 at M=4 (their
     ratio is the naive-versus-ordered comparison; K4's up/gate and down
     apart, each with the table bytes it reads), K5, K2 against its
     3xTF32 tensor-core bound and the float32 CUDA-core bound, beside
     torch's scaled_dot_product_attention (its backend named, and the
     memory-efficient and math backends timed alone), the same at
     recurrentgemma's B1 H10 S2048 D256 causal, K3 at the tp=2 down
     projection (int8 and int4; its device kernels a call) beside K1
     followed by the plain quantizer and K1 alone,
     K3 at M 2 and 1 and K1 at M 2 at that shard (the ``:overlap``
     paths' microbatches), and K1 at the forward's M=2048 (up/gate and
     down; its tensor-core
     loop) against its bounds, its plain version and, as context,
     ``torch.matmul`` on the weight pre-dequantized by K5 (the cuBLAS
     kernel named); K1 and K4 at M=4 at the other archs' MLP shapes and
     K3 at their tp=2 down shards, against their bytes bounds
  5. serve: full-width qwen3-4b (36 layers) built by the port's
     ``make_engine`` on the card from seed 0, four requests through the
     ``Scheduler``, each decode step a replay of the engine's CUDA graph
     (one capture; its seconds and pool bytes); every decode step must
     launch K1 108 times (a replay adds what its capture counted)
  6. trace: device time of a few full-width captured decode steps by
     kernel (torch.profiler) against their wall time: the device's busy
     share, and K1's and the split-add's time and launches per step (108
     K1 kernels a step among the kernel nodes of the step's CUDA graph,
     every one of them the float32 decode loop on the tensor cores, the
     trace's count beside); the eager step's wall time and
     busy share beside them
  7. capture: the captured step against ``Engine.decode_eager`` at full
     width: logits and the whole KV cache bit for bit over 16 decode
     steps, lockstep and on unequal per-slot positions; a second cache of
     the same batch size recaptures; the four requests of phase 5 give
     the same ids through an engine whose scheduler runs the eager step
     (its ms per step beside)
  8. backend cross-check: greedy decode with backend=cuda and
     backend=torch on the same params
  9. serve naive-actorder: the same four requests with the paper's naive
     act-order plan on backend=cuda; every decode step must launch K4
     108 times and K1 never
 10. trace-naive: as 6 for the naive-actorder engine: K4's device time
     per decode step, 108 K4 kernels per step and no split-add kernel
 11. scheme cross-check: greedy decode, naive-actorder (K4) against
     tp-aware (K1), both planned from seed 0
 12. forward flash: the full-sequence forward (``Engine.prefill_logits``)
     of 2048 tokens with attn_backend="flash" (36 K2 launches) against
     attn_backend="xla" on the same params; all 108 K1 launches take its
     tensor-core loop, and the profiler's K1 and split-add times
 13. dequantize: every MLP weight of the full-width engine materialized
     through ``ops.dequantize`` (108 K5 launches), bit-equal to the plain
     dequantize
 14. serve-tp: full-width qwen3-4b at tp=2 with ``quant-int8:fused``, two
     rank processes (``launch/mesh.py``'s group set-up; on one card: gloo
     via host; started here, their start-up printed as ``rank-pool``,
     and kept for the rank functions of phases 17, 19, 20, 26, 32, 42
     and 43, then stopped before phase 40), the
     same four requests, the decode step eager (no CUDA graph holds the
     gloo collectives); every decode step must launch K3 36 times and
     K1 72 times on each rank; then a few decode steps traced on rank 0
     (torch.profiler): kernels per step, K3's and K1's kernels and ms per
     step (36 K3 kernels and none of the earlier wire epilogue, else it
     fails)
 15. tp-crosscheck: greedy decode on the same two ranks, ``quant-int8:fused``
     against ``quant-int8`` and ``quant-int4:fused`` against
     ``quant-int4`` (logits bit-identical on every rank, ids equal), and
     ``psum`` at tp=2 against the tp=1 engine of phase 5 (ids equal)
 16. artifact: the tp=1 tp-aware plan prepared from seed 0 on the card
     (``compiler.prepare``), saved to a temporary directory (its bytes
     reckoned first against the free disk), and served by a fresh
     ``make_engine(artifact=DIR)``: phase 5's four requests give the same
     ids, every decode step a replay of the captured step launching K1
     108 times, and greedy logits over 8 steps bit-equal to phase 5's
     in-memory engine; bytes on disk and the seconds to prepare, save
     and load
 17. artifact-tp: the tp=2 ``quant-int8:fused`` plan prepared and saved
     as two rank files; two rank processes each read only their own
     (``RankLoadStats``: resident fraction below 1), serve the four
     requests (36 K3 and 72 K1 launches a decode step per rank; the ids
     of phase 14) and give phase 14's greedy ids and logits bit for bit;
     ``python -m repro_torch.launch.serve verify`` of the directory, run
     beside the ranks, exits 0 with no finding (its seconds)

 18. serve-archs: granite-3-8b (40 layers), starcoder2-3b (30) and
     mistral-large-123b (full width, depth cut to 4 layers, the cut
     printed), each built from seed 0 on the card: the four requests
     through the captured step, tp-aware, every decode step launching K1
     once for each MLP weight ((3 if gated else 2) x layers) and no other
     counted kernel; the same under naive-actorder on backend=cuda (K4
     only); naive against tp-aware layer by layer on the same input
     carries (each layer's float32 output within the GEMMs' float32
     tolerance), and, reported beside, their greedy ids and logits
     through the whole model and the same through one plan on
     backend=torch and cuda (the sum-order control: these random models
     without qk_norm amplify float32 rounding over their depth); for
     granite the captured step against decode_eager bit for bit over 4
     lockstep and 4 per-slot steps; each serve's steady step median,
     tok/s and peak memory
 19. serve-tp-archs: granite (its odd vocab, 49155, split by d_model) and
     starcoder2 at tp=2 with ``quant-int8:fused`` on two rank processes,
     full width, depth cut to 4 layers (printed; to keep the script
     within its time), as phases 14 and 15: K3 (one per
     layer) and K1 launches per step per rank, the fused ring
     bit-identical to the plain one, psum at tp=2 against phase 18's tp=1
     engine's first 4 layers layer by layer (the greedy ids of those
     layers reported)
 20. artifact-granite: as phases 16 and 17 for granite at full width,
     depth cut to 4 of its 40 layers (the cut printed; the files' save
     and load dominate the phase): the tp=1 and the tp=2 plans prepared,
     saved (bytes reckoned against the free disk first; each directory
     deleted after use) and served from their files, ids and logits
     bit-equal to in-memory engines of the same depth from seed 0 (at
     tp=1 served first in this process, at tp=2 in each rank process
     before it reads its file); the tp=2 manifest splits the embedding
     by columns and the head by rows
 21. long-forward: starcoder2 at full width, 2 layers, one 8192-token
     sequence under its 4096-token window: the Q-chunked einsum forward
     (4 chunks of 2048 query rows a layer, counted) against the flash
     forward (K2, one launch a layer; its device time against its
     bound): the last position's id equal, the argmax agreement share,
     and each forward's peak allocated memory beside the size of the
     unchunked score tensor
 22. serve-paged: qwen3-4b tp-aware on phase 5's params, 4 slots, eight
     seeded requests of 16 tokens, four of them sharing a 32-token prompt
     prefix (two full pages), served greedy and seeded from the dense
     cache and from a ``paged:16`` pool (``Scheduler`` paged mode), each
     run through the captured step with 108 K1 launches a step: greedy
     logits and ids bit-equal request by request, seeded ids equal,
     prefix hits, no live page after the drain; the greedy pair for the
     naive plan (K4) between phases 11 and 12; ``paged:16:int8`` and
     ``:int4`` against fp pages (ids agreeing, logit gap, bytes per
     page); the dense and paged pair at ``max_seq`` 1024 (bit-equal;
     steady step and max_memory_allocated); ``release_cache`` and a
     second serve (a new pool, a second capture, the same ids; allocated
     bytes); and at tp=2 ``quant-int8:fused`` (phase 14's ranks) the
     four requests from a ``paged:16`` pool: the dense ids on both
     ranks, 36 K3 and 72 K1 launches a step
 23. http: ``ServingServer`` on 127.0.0.1:0 over a ``paged:16`` engine
     whose step the server's loop thread captures: 8 concurrent SSE
     clients (start / 16 tokens / done), their seeded ids those of the
     same requests through a ``Scheduler``, 108 K1 launches a step,
     ``/v1/health`` naming the layout, ``/v1/stats`` TTFT and
     inter-token p50 / p90
 24. gptq: one qwen3-4b MLP pair at full width (2560 / 9728), random
     weights and 512 calibration rows made on the card: the Hessians,
     ``plan_pair(use_gptq=True)`` (the factors' and the codes' seconds)
     and RTN in the same orders; GPTQ's output error on the calibration
     rows must be below RTN's (held-out rows reported); the GPTQ pair's
     three GEMMs through K1 against their plain version at M 4 and 512
 25. fold: qwen3-4b at full width, 36 layers, with the attention V->O
     fold (``attn_tp_aware``): the port's prepare on the card, saved,
     served from the directory (the aux's bytes); the four requests
     through the captured step, which launches K1 for the MLP and for V
     and O (``fold_launches``: 180 a step); a few steps traced beside
     phase 6's dense step (K1, sgemm, split-add); the captured step
     bit-equal to ``decode_eager`` over 16 lockstep and 16 per-slot
     steps; with a float32 carry, each layer on the same input carry
     within the float32 GEMM tolerance of the same layer with the fold's
     effective dense ``wv``/``wo`` (``layerwise``); greedy ids against the
     effective-weights engine reported
 26. fold-tp: the fold tuned at tp=2 (``prepare`` with
     ``autotune=True``; full width, depth cut to 8 layers, printed): the
     tuned sites printed as the CLI prints them, the rank files and the
     aux saved and served on two rank processes over gloo, each with its
     heads of the fold: ids equal on both ranks, K3 where the tuner fused
     the MLP and K1 for the other GEMMs and V and O; with a float32
     carry under psum, each layer within the float32 GEMM tolerance of
     phase 25's tp=1 fold on the same input carries; beside the ranks,
     ``serve verify`` of the directory exits 0 with no finding, and of a
     copy of it (rank files linked) with rank_01.npz renamed rank_05.npz
     and an unreachable glob added to the plan exits 1 with MF004 and
     MF001
 27. overlap-tp: the ``:overlap`` epilogue (``dist/overlap.py``):
     qwen3-4b at full width, depth cut to 4 layers (printed), prepared
     at tp=2 with the tuner's ``:overlap`` marks (``prepare
     --autotune-collectives --overlap-collectives``), saved, and served
     from the rank files on two rank processes over gloo via host: the
     tuned MLP carries ``:overlap``; the four requests' ids equal on both
     ranks; K3 (fused) once per row microbatch and K1 for up and gate, a
     step per rank, as counted from the config; at how many pipelined
     sites mb0's ring was still in flight once mb1's GEMM was launched
     (at least one); greedy logits of the lockstep batch bit-equal to
     the same plan without ``:overlap``, fused and unfused (K1 runs the
     down projection per microbatch), and two rows at a time;
     torch.profiler over traced steps: every pipelined site's first
     microbatch's ring window (post to wait) holds a down-GEMM kernel,
     and no window of the synchronous ring does; the steps' wall time
     with and without ``:overlap`` in alternating blocks; K1 and K3 at a
     microbatch pair's halves bit-equal to the whole at M 2, 4 and
     2 kTcMinM + 88, and kTcMinM + 44 (whole on the large-M loop, halves
     not) not split;
     the library GEMM's rows at M 2 against M 4
 28. mesh-dp: the ``dp2xtp2`` grid, four processes on the card, from
     phase 27's tp=2 rank files: each process reads only its model-axis
     rank file (resident bytes), each row serves its data rank's two
     rows of the lockstep batch (K3 and K1 launches from the config), the
     greedy ids and logits row for row bit-equal to phase 27's
     ``dp1xtp2`` engine on the same rows, and against its whole 4-row
     batch ids equal or apart only after a near tie; tokens/s
 29. batch-solo: qwen3-4b at full width, tp=1, captured: phase 22's
     eight requests served greedy four slots at a time (an engine whose
     library products run in blocks of 4 rows, ``row_stable``) and
     seeded eight slots at a time (blocks of 8), then each alone
     through the same engine's ``Engine.generate`` (batch 1, one padded
     block): ids equal and every emitted logits row bit-equal; the
     head's time a step as one plain product and through ``row_stable``
     at blocks of 4 and 8, at M 1, 4 and 8
 30. serve-moe: qwen3-moe-235b-a22b and arctic-480b at full width, depth
     cut to 4 and 2 layers (printed), from seed 0 (experts quantized one
     at a time; the init's peak memory): the four requests through the
     captured step, K1 once per GEMM of every expert (and arctic's dense
     MLP) a step, counted and seen among the step graph's nodes; the
     captured step against ``decode_eager`` bit for bit; greedy ids on
     backend=cuda against torch; qwen3-moe under naive-actorder (K4)
 31. artifact-moe: qwen3-moe at 2 layers prepared on the card (peak
     memory), saved, served from the directory: the manifest's experts
     stacked [2, 128], greedy ids and logits bit-equal to the in-memory
     engine of that depth
 32. moe-ep: ``--mesh dp2xtp1``'s lockstep batch from phase 31's rank
     file, two processes over gloo via host, each keeping 64 of 128
     experts a layer (resident expert bytes 0.50 of the file's), tokens
     to their experts by all-to-all: ids equal the dp1 engine's over the
     same rows, logits bit-equal reported
 33. moe-tp: qwen3-moe at 2 layers, tp=2 within-expert over gloo via
     host: ``psum`` layer by layer within 1e-5 of max|.| + 1e-4 of the
     tp=1 engine on the same carries, ``quant-int8:128:fused`` bit-equal
     to its unfused ring, one stacked expert collective per MoE layer a
     step, K1 once per expert GEMM slice
 34. serve whisper-large-v3 (and, before it, ``kernels-av``: K1 and K4
     at whisper's decoder MLP shapes, K1 at the vision model's, at
     whisper's fold V and O and at its encoder's M = 4 x 1500 (the
     tensor-core loop), K2 at the vision forward's B1 H64 S2048 D128,
     each against its plain version, timed against its bound): full
     depth and width (32 encoder and 32 decoder layers) from seed 0,
     four requests (prompts padded to 32, frames from seed 0, 16 new
     tokens, greedy) through ``Engine.generate``: K1 64 a decode step
     and 64 on the tensor-core loop per encode (counted); the cross
     prefill, the first step with its capture and the steady step
     timed; greedy ids equal over two runs; the captured step against
     ``decode_eager`` bit for bit (the cross K/V of the request batch
     filled first); ``Scheduler.run()`` in batch-drain mode (zero
     frames) against ``Engine.generate`` on the same padded rows; a few
     captured steps traced (K1's device ms, busy share); the encoder and
     ``precompute_cross`` timed alone; naive-actorder (K4 only, 64 a
     step and 64 per encode)
 35. serve llama-3.2-vision-90b: full width, depth cut to 10 of its 100
     layers (2 of its 20 superblocks: 8 self and 2 cross layers), the
     cross layers' gates set to 0.5 (at their initial 0 the cross layers
     add nothing), patches from seed 0: the serve checks of 34 with K1
     30 a step; the 2048-token forward with the flash kernel (K2 8 a
     forward, one per self layer; cross-attention stays on the einsum
     path) against the einsum one: each layer on the einsum forward's
     input carries within 5e-3 of max|.| (the whole forward's logit gap
     and argmax agreement reported: this random model without qk_norm
     amplifies the two attentions' float32 sum order through its bf16
     carry)
 36. fold-whisper: whisper with the attention V->O fold
     (``attn_tp_aware``) prepared on the card at full depth, served in
     memory and from its saved directory: greedy ids and logits
     bit-equal, K1 128 a decode step (64 MLP, 32 V, 32 O) and the
     encoder's 64; the aux holds the waived encoder and cross folds,
     which no step launches; ``serve verify`` of the directory exits 0,
     its only findings the two waived folds (MF005, info)
 37. kernels-rec: K1 and K4 at the recurrent families' MLP shapes
     (rwkv6-3b's channel-mix pair 2560 -> 8960 -> 2560, ungated;
     recurrentgemma-2b's GeGLU 2560 -> 7680 -> 2560) against their plain
     versions at M 1, 4 and (K1) 64, and timed at M=4 against their bytes
     bounds, per layer; for phase 42's tp=2 path, K1 at each rank's up
     (and gate) shard (N 4480 and 3840) and K3 at its down shard (K 4480
     and 3840, int8 wire: bit-equal to K1 + the quantizer, within one
     level of its plain version), at M 1 and 4, timed at M=4
 38-39. serve rwkv6-3b (32 layers) and recurrentgemma-2b (26 layers), at
     full width and depth from seed 0: the four requests of phase 5
     through the continuous scheduler and the captured step (K1 64 and
     78 a step, counted; the first step with its capture, the steady
     step, the params and the init's peak); a few captured steps traced
     (K1's launches a step asserted from the step graph's kernel nodes,
     the busy share, the heaviest other kernels); the captured step
     against ``decode_eager`` bit for bit (logits and every state leaf);
     slot reuse: six greedy requests of
     unequal lengths at 4 slots, row block 4, so that later ones enter
     lanes that ``Engine.reset_slot`` zeroed, each request's ids and
     every emitted logits row bit-equal to its solo ``Engine.generate``;
     the 64-token forward (``prefill_logits``) against the replay
     through the decode step within 2e-2 of max|logit| in float32
     activations, state and K/V ring (in the config's bf16, reported:
     the bf16 ring's rounding, the reference's own, moves the random
     26-layer recurrentgemma far); rwkv6's tp=1
     artifact prepared, saved and served (ids and greedy logits bit-equal
     to the in-memory engine; bytes, seconds to prepare, save and load);
     recurrentgemma's forward of 4096 tokens (past its 2048-token window)
     with the flash kernel (K2 at head dim 256, 8 a forward, one per
     superblock) against the einsum one: each wall, K1 78 on the
     tensor-core loop, each local attention layer on the einsum
     forward's float32 carries within ``layerwise``'s tolerance, the
     whole bf16 forward's logit gap and greedy ids reported; then
     naive-actorder (K4 64 and 78 a step, K1 0)
 40. train: the dense qwen3-4b (``quant.mode="none"``, float32 params,
     the config's bf16 carry) at full width and depth trained for 8 steps
     at batch 2 x seq 128 on the synthetic stream through ``python -m
     repro_torch.launch.train`` in a child process, after this process
     has freed its cached memory (``torch.cuda.mem_get_info`` printed
     first): every loss finite, step 0's within 1.5 of ln(vocab), step
     7's below it; s/step after the first, tokens/s, the peak allocated
     beside the 16 B a param of state reckoned from ``param_count``, and
     no counted kernel launched; then one train step of each of the ten
     smoke configs (float32 carry and stubs) on the card and on the CPU
     from the same params and batch: every leaf's gradient within
     ``FAMILY_GRAD_TOL`` of its max, loss and grad_norm within
     ``FAMILY_RTOL`` (whisper's grad_norm within ``WHISPER_GNORM_RTOL``),
     the card's grad_norm within ``FAMILY_F64_RTOL`` of a float64
     gradient's, the params within ``FAMILY_PARAM_TOL`` of max|p| at all
     but ``FAMILY_PARAM_SHARE`` of the elements; no counted kernel
     launched
 41. analysis: ``python -m repro_torch.analysis --ast --contracts --tp 2``
     on the card (AS rules, CT002 in process, CT001 on two ranks sharing
     the card over gloo, CT003 and CT004 on each family's smoke model):
     exit 0, no finding; its seconds beside those of phases 17, 26 and
     36's ``serve verify`` runs
 42. serve-tp-rec (run after phase 39): rwkv6-3b at 4 of 32 layers and
     recurrentgemma-2b at 5 of 26 (one superblock and the two extra
     RG-LRU layers: every layer kind) at full width and tp=2 with
     quant-int8:fused on two rank processes over gloo via host, as phase
     19: per rank and decode step K3 once a layer and K1 once per up (and
     gate) weight (rwkv6 4 and 4, recurrentgemma 5 and 10), the ranks'
     tokens equal, the fused ring bit-identical to the plain one, psum at
     tp=2 held layer by layer to a tp=1 engine of the same cut config
     and seed (``layerwise``), the greedy trace against it reported; the
     eager tp=2 step's ms beside phases 38-39's captured tp=1 step
 43. http-tp (run after phase 42, in the same rank pair): K1 at one
     rank's qwen3-4b up shard (K 2560 N 4864) against its plain version
     and timed; then qwen3-4b at full width and 4 of 36 layers, tp=2
     quant-int8:fused from a paged:16 pool, behind the HTTP/SSE front end
     (``ServingServer`` over the group on rank 0, rank 1 following its
     boundaries, ``serving/controller.py``): 8 SSE clients at once
     (max_batch 4), each stream start / 16 tokens / done, the ids equal
     the same requests through an in-process tp=2 ``Scheduler`` on the
     same ranks, rank 1's token log, admissions, slot occupancy and
     results rank 0's; per rank K1 8 and K3 4 a decode step; a ninth
     client hangs up after 4 tokens, and its slot is taken by a later
     admission on both ranks; TTFT and ITL p50/p90, tokens/s and the
     phase's seconds beside the card's name and power limit

then the per-kernel JSON line (after the first six: K2 on the long
forward, the paged and HTTP serves' K1, K4 and K3 rows, the other
archs' K1, K4 and K3 rows, then K1 on the GPTQ pair and on the fold's V
and O, K3 where phase 26's tuner fused the MLP, K3 and K1 on the
``:overlap`` paths of phases 27 and 28, then K1 on phase 29's serves
and K1 and K4 on the MoE paths of phases 30-33, per expert, K1, K4
and K2 on the audio and vision paths of phases 34-36, K1 and K4 on
the recurrent paths of phases 38-39, K1 and K3 on their tp=2 paths of
phase 42 and of the HTTP front end at tp=2 of phase 43, and K2 at head
dim 256 on recurrentgemma's flash forward),
the total
seconds
and each phase's, the
card's nvidia-smi line
and, as the last line, ``{"ok": true, "device": {...}}``.  Every path
runs with the launch counts set to 0 just before it and read just
after.  Per-shape
details go to ``chiprun_out/chip_smoke.json``.  Any failure raises, so
the script exits non-zero and prints no result line; so does a machine
without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.comm import dispatch as comm  # noqa: E402
from repro_torch.comm.spec import CollectivePlan  # noqa: E402
from repro_torch.comm.spec import CollectiveSpec  # noqa: E402
from repro_torch.comm.spec import parse_collective  # noqa: E402
from repro_torch.comm.wire import wire_params  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import quantization as qz  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import dequant_matmul as dk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.core.policy import ExecutionPolicy  # noqa: E402
from repro_torch.dist import overlap  # noqa: E402
from repro_torch.dist.topology import MeshPlan  # noqa: E402
from repro_torch.kernels import dispatch as kdispatch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.train import stubs  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.plan import compiler  # noqa: E402
from repro_torch.plan.artifact import DeploymentArtifact  # noqa: E402
from repro_torch.runtime.sampling import SamplingConfig  # noqa: E402
from repro_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from repro_torch.runtime.serve import Engine, make_engine  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores (the GEMM kernels' float32 policy uses plain FMA), and
#: TF32 FLOP/s on the tensor cores (flash attention, split 3xTF32)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
#: full-width qwen3-4b MLP GEMMs: (name, K, N, group size); the down
#: projection's gs is choose_group_size(9728 / 16, 128) = 76
UP = ("up/gate", 2560, 9728, 128)
DOWN = ("down", 9728, 2560, 76)
QWEN = get_config("qwen3-4b")
#: the other dense decoders, served at full width in phases 18-20;
#: mistral-large's depth is cut to fit one card (its 88 layers hold about
#: 171 GB)
ARCHS = ("granite-3-8b", "starcoder2-3b", "mistral-large-123b")
TP_ARCHS = ARCHS[:2]
MISTRAL_LAYERS = 4
#: granite's depth in phase 20 (its artifact's save and load take about
#: half a second a layer each)
ARTIFACT_GRANITE_LAYERS = 4
#: granite's and starcoder2's depth at tp=2 (phase 19): the gloo step via
#: host costs 7-9 ms a layer; a depth-L model is the full one's first L
#: layers (the init draws them first), so phase 18's full engine gives
#: the reference of the first L
TP_ARCH_LAYERS = 4
#: the long forward (phase 21): starcoder2 at full width, two layers,
#: one sequence of 8192 tokens (the reference's Q_CHUNK_MIN_SEQ) under
#: its 4096-token window
LONG_LAYERS = 2
LONG_S = 8192
SWEEP = [(8, 128, 128, 32), (16, 256, 384, 64), (128, 512, 256, 128),
         (1, 256, 128, 64), (4, 1024, 128, 128), (4, 608, 128, 76),
         # ragged edges: N not a multiple of 4 (4-byte copies), M past a tile
         (5, 256, 102, 64), (33, 608, 200, 76)]
#: the reference's g_idx kernel sweep (tests/test_kernels.py)
GIDX_SWEEP = [(8, 128, 128, 32), (16, 256, 384, 64), (32, 512, 256, 128)]
#: K4's own edges: G 304 (K 9728, gs 32: the largest table a block
#: stages), N not a multiple of its 16- or 32-column tiles (102, 200) or
#: of 4 (130: 4-byte copies)
GIDX_EDGES = [(4, 9728, 2560, 32), (17, 9728, 200, 32), (4, 608, 130, 76),
              (1, 256, 130, 64), (33, 256, 102, 64)]
#: dequantize shapes (K, N, gs): the reference's, gs=76, ragged N, full
#: (qwen3-4b's, and granite's: its down projection's gs 100)
DEQUANT_SHAPES = [(128, 128, 32), (512, 384, 128), (608, 200, 76),
                  (256, 102, 64), UP[1:], DOWN[1:]]
#: flash shapes (B, H, S, D, causal, window): tests/test_kernels.py's
#: five (the fifth differs from the first only in the JAX blocks) and the
#: full-width forward's: 32 heads after the GQA repeat, S = T = 2048
FLASH_FULL = (1, 32, 2048, 128, True, None)
FLASH_SWEEP = [(1, 2, 128, 32, True, None), (2, 2, 256, 64, True, None),
               (1, 1, 128, 32, False, None), (1, 2, 256, 32, True, 64),
               (1, 2, 128, 32, True, None), FLASH_FULL]
#: (B, H, S, T, D, causal, window) the kernel's 128-query, 64-key tiling
#: can get wrong: S not a multiple of 16 or 64, windows below and across a
#: tile, S != T, the other head dims at S 2048
FLASH_EDGES = [(1, 2, 100, 100, 128, True, None),
               (1, 2, 1000, 1000, 128, True, None),
               (1, 2, 300, 300, 128, True, 16), (1, 2, 300, 300, 64, True, 48),
               (1, 2, 300, 300, 128, True, 80),
               (1, 2, 300, 300, 128, False, 80),
               (1, 2, 100, 300, 128, False, None),
               (2, 2, 300, 70, 64, False, None),
               (1, 2, 2048, 2048, 32, True, None),
               (1, 2, 2048, 2048, 64, True, None)]
#: recurrentgemma-2b's local attention in its forward: 10 heads of 256
#: after the MQA repeat, S = T = 2048 (its 2048-token window is then the
#: causal mask itself)
FLASH_REC = (1, 10, 2048, 256, True, None)
#: head dim 256 on its own tiling (64-query blocks, 32-key tiles): S not a
#: multiple of either, a window below one tile and one across tiles, S !=
#: T, and recurrentgemma's shape with its window
FLASH_EDGES_256 = [(1, 2, 100, 100, 256, True, None),
                   (2, 2, 77, 77, 256, False, None),
                   (1, 2, 300, 300, 256, True, 16),
                   (1, 2, 300, 300, 256, True, 80),
                   (1, 2, 300, 300, 256, False, 80),
                   (1, 2, 100, 300, 256, False, None),
                   (2, 2, 300, 70, 256, False, None),
                   (1, 10, 2048, 2048, 256, True, 2048)]
#: tolerance of a kernel against its plain version, (relative to
#: max|ref|, absolute): the GEMMs' float32 sums in another order, or one
#: bf16 ulp of the output; flash as the reference's own tests
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 0.0)}
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 0.0)}
#: tensor parallelism of the TP phases, and the down projection's shard
#: at that degree: (name, K, N, gs) of one rank
TP = 2
DOWN_TP = ("down tp=2", 9728 // TP, 2560, 76)


#: phases 30-33, the MoE family at full width: its depth on one card (int4
#: experts take about 1.2 GB a layer for qwen3-moe, 6.7 GB for arctic);
#: the depth of the artifact, EP and tp=2 phases (the 5 GB of qwen3-moe's
#: float32 embedding and head dominate its files); the tp=2 plans
MOE_ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
MOE_LAYERS = {"qwen3-moe-235b-a22b": 4, "arctic-480b": 2}
MOE_DIST_LAYERS = 2
MOE_TP_PLANS = ("psum", "quant-int8:128:fused")
MOE_TP_UNFUSED = "quant-int8:128"


def arch_config(arch: str):
    """The full config served for ``arch``; mistral-large at
    ``MISTRAL_LAYERS`` layers."""
    cfg = get_config(arch)
    if arch == "mistral-large-123b":
        cfg = cfg.with_(num_layers=MISTRAL_LAYERS)
    return cfg


def mlp_shapes(cfg, tp: int = 1) -> list:
    """(name, K, N, gs) of one layer's MLP GEMMs at full width: up/gate and
    down, the down projection's K split over ``tp`` ranks; the group sizes
    the plan compiler picks."""
    d, ff = cfg.d_model, cfg.d_ff
    gs_up, gs_down = compiler._pair_group_sizes(
        cfg, types.SimpleNamespace(shape=(d, ff)),
        types.SimpleNamespace(shape=(ff, d)))
    up = "up/gate" if cfg.mlp_gated else "up"
    return [(f"{cfg.arch_id} {up}", d, ff, gs_up),
            (f"{cfg.arch_id} down" + (f" tp={tp}" if tp > 1 else ""),
             ff // tp, d, gs_down)]


def rec_tp_shapes(cfg) -> list:
    """(name, K, N, gs) of one rank's MLP GEMMs at tp=``TP``: the up (and
    gate) weight's column shard and the down weight's row shard."""
    (name, d, ff, gs_up), down = mlp_shapes(cfg, TP)
    return [(f"{name} tp={TP}", d, ff // TP, gs_up), down]


def mlp_launches(cfg) -> int:
    """Dequant-GEMM launches of one decode step or forward: one for each
    MLP weight (up, gate where the MLP is gated, down) of every layer; in
    an MoE layer, of every expert (each runs over its capacity rows) and
    of arctic's dense residual MLP."""
    pair = 3 if cfg.mlp_gated else 2
    if not cfg.num_experts:
        return pair * cfg.num_layers
    return pair * (cfg.num_experts + cfg.dense_residual) * cfg.num_layers


def describe(cfg) -> str:
    return (f"{cfg.arch_id} {cfg.num_layers}L d{cfg.d_model} ff{cfg.d_ff} "
            f"vocab{cfg.vocab_size}")


def fold_shapes(cfg) -> list:
    """(name, K, N, gs) of the attention V->O fold's two GEMMs at ``cfg``
    (``compiler.stage_fold_attention``'s group sizes): V, d_model to the
    KV heads' channels, and O, the query heads' channels to d_model."""
    kvp, _, hp = cm.head_grid(cfg)
    hd = cfg.head_dim
    gs = qz.choose_group_size(hd, cfg.quant.group_size)
    return [(f"{cfg.arch_id} fold V", cfg.d_model, kvp * hd,
             qz.choose_group_size(cfg.d_model, gs)),
            (f"{cfg.arch_id} fold O", hp * hd, cfg.d_model,
             qz.choose_group_size(min(hd, hp * hd), gs))]


def fold_launches(cfg) -> int:
    """K1 launches of one decode step with the fold: the MLP's and V and
    O in every layer."""
    return mlp_launches(cfg) + 2 * cfg.num_layers


def moe_config(arch: str, layers: int | None = None):
    """The MoE ``arch`` at full width, depth cut to ``layers`` (default
    ``MOE_LAYERS``: what one card holds with room for the phases)."""
    return get_config(arch).with_(num_layers=layers or MOE_LAYERS[arch])


def expert_shapes(cfg, tp: int = 1) -> list:
    """(name, K, N, gs) of one expert's GEMMs at full width (arctic's
    dense residual MLP has the same shapes), or of one TP rank's slice of
    them (the inner dim split over ``tp`` ranks)."""
    up, down = mlp_shapes(cfg.with_(d_ff=cfg.moe_dff,
                                    arch_id=f"{cfg.arch_id} expert"), tp)
    if tp == 1:
        return [up, down]
    return [(up[0] + f" tp={tp}", up[1], up[2] // tp, up[3]), down]


ARCH_SHAPES = {a: mlp_shapes(arch_config(a)) for a in ARCHS}
MOE_SHAPES = {a: expert_shapes(get_config(a)) for a in MOE_ARCHS}
ARCH_TP_DOWN = {a: mlp_shapes(arch_config(a), TP)[1] for a in TP_ARCHS}
QWEN_KN = {(UP[1], UP[2]), (DOWN[1], DOWN[2])}
#: qwen3-4b's fold GEMMs (V: K 2560, N 1024; O: K 4096, N 2560; gs 128)
FOLD = fold_shapes(QWEN)
#: calibration rows of phase 24 (GPTQ on one full-width MLP pair)
GPTQ_ROWS = 512
#: phase 26's depth (the tp=2 tuned fold plan; full width): its files'
#: save and load and the gloo step dominate the phase
FOLD_TP_LAYERS = 8
DEQUANT_SHAPES += [shape[1:] for shape in ARCH_SHAPES["granite-3-8b"]]
#: K3's own edges, (k, n, gs, tp, bits, preferred block): blocks of 86
#: over n_pad 258 (blocks straddle 128-column tiles, and the padded
#: columns 256-257 lie in a tile with no GEMM blocks), and int4 blocks of
#: 48 across three tiles: epilogue units of several tiles
WIRE_EDGES = [(128, 256, 32, 3, 8, 128), (128, 384, 32, 2, 4, 48)]
#: the tp=2 down shard, int8 and int4 wires
WIRE_RANK = [DOWN_TP[1:] + (TP, 8, 128), DOWN_TP[1:] + (TP, 4, 32)]
#: the other archs' tp=2 down shards (granite's gs 100), int8 and int4
WIRE_ARCHS = [ARCH_TP_DOWN[a][1:] + (TP, bits, blk) for a in TP_ARCHS
              for bits, blk in ((8, 128), (4, 32))]
#: K3 checks: the reference's tests/test_fused_wire.py shapes, gs 76 with
#: padded wires (N 90 and 100, whose int4 wire ends in all-zero blocks),
#: int4 blocks of 10 (a packed word spans two blocks), the edges and the
#: rank shape; each at M 1, 4 and 64, the edges and the rank shape also
#: above K1's tensor-core threshold in float32
WIRE_SWEEP = [(128, 96, 32, 4, 8, 32), (64, 128, 8, 8, 8, 128),
              (128, 96, 32, 2, 4, 32), (256, 256, 64, 2, 4, 16),
              (608, 90, 76, 4, 8, 128), (608, 100, 76, 4, 4, 12),
              (608, 80, 76, 2, 4, 12)] + WIRE_EDGES + WIRE_RANK + WIRE_ARCHS
#: phases 27-28 (the :overlap epilogue and the dp2xtp2 grid): depth (full
#: width; the rank files' save and load and the gloo step dominate), the
#: rows of a 4-slot step's microbatch, the decode steps traced for the
#: ring windows, and the lockstep batch of ``serve --mesh --prompt-budget
#: 16 --max-new 8`` (4 prompts of 8 tokens from seed 0, 8 new tokens; the
#: gloo step's 0.1-0.2 s make every step count against the time limit)
OVERLAP_LAYERS = 4
OVERLAP_MB = 2
OVERLAP_TRACE_STEPS = 4
OVERLAP_WALL_BLOCKS = 8
MESH_BATCH, MESH_PLEN, MESH_NEW = 4, 8, 8
#: phases 34-36 (the audio and vision families): whisper at full depth,
#: the vision model at 10 of its 100 layers (2 of its 20 superblocks: all
#: 100 would hold ~100 GB), its gates opened; four requests of prompts
#: padded to 32 and 16 new tokens (max_seq 49, under whisper's 448
#: positions); the vision model's full-sequence forward's length
WHISPER = "whisper-large-v3"
VISION = "llama-3.2-vision-90b"
VISION_LAYERS = 10
VISION_GATE = 0.5
AV_BUDGET, AV_NEW = 32, 16
AV_MAX_SEQ = AV_BUDGET + AV_NEW + 1
AV_FORWARD_S = 2048
#: phases 37-39 (the recurrent families): both at full width and depth
#: (rwkv6-3b ~6.4 GB of params, recurrentgemma-2b ~6.2 GB); the four
#: requests of phase 5 (max_seq 49); six greedy requests of unequal
#: lengths at 4 slots for slot reuse; a 64-token forward
REC_ARCHS = ("rwkv6-3b", "recurrentgemma-2b")
REC_BUDGET = 32
REC_MAX_SEQ = REC_BUDGET + 16 + 1
REC_REUSE_NEW = (4, 16, 6, 12, 8, 10)
REC_FORWARD_S = 64
#: recurrentgemma's flash forward (phase 39): one sequence past its
#: 2048-token window, so the window masks
REC_FLASH_S = 4096
#: phase 42 (the recurrent families at tp=2 over gloo): full width, the
#: depth cut as phase 19 cuts its archs (the gloo step via the host
#: dominates); recurrentgemma at one superblock and the two extra RG-LRU
#: layers, so every layer kind runs
REC_TP_LAYERS = {"rwkv6-3b": 4, "recurrentgemma-2b": 5}
#: the collectives of the TP phases
TP_SERVE = "quant-int8:fused"
TP_PAIRS = (("quant-int8:fused", "quant-int8"),
            ("quant-int4:fused", "quant-int4"))
#: the launches of K1 that took its tensor-core loop (float32, large M),
#: counted beside the wrappers' own counts
TC = "dequant_matmul_ordered (tensor cores)"
#: the name of each of ``ops.COUNTERS``: its wrapper's, or ``TC``
COUNTED = tuple(fn.__name__ if attr == "launches" else TC
                for fn, attr in ops.COUNTERS)


#: (phase, seconds since the start) of each line this process printed
LINES: list[tuple[str, float]] = []
T0 = time.perf_counter()


def line(phase: str, text: str):
    LINES.append((phase, time.perf_counter() - T0))
    print(f"[{phase}] {text}", flush=True)


def phase_seconds() -> dict:
    """Each phase's seconds: from the last line before it to its own
    last line (a phase whose lines recur is summed)."""
    out, prev = {}, 0.0
    for i, (phase, t) in enumerate(LINES):
        if i + 1 < len(LINES) and LINES[i + 1][0] == phase:
            continue
        out[phase] = out.get(phase, 0.0) + t - prev
        prev = t
    return out


def reset_counts():
    ops.add_launch_counts(-n for n in ops.launch_counts())


def read_counts() -> dict:
    return dict(zip(COUNTED, ops.launch_counts(), strict=True))


def expect_counts(counts: dict, want: dict, what: str):
    """Each counted kernel launched exactly ``want[name]`` times (0 for
    those ``want`` does not name)."""
    full = {name: want.get(name, 0) for name in COUNTED}
    if counts != full:
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{full}")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    line("device", f"nvidia-smi: {smi} | torch {torch.__version__} cuda "
                   f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    return smi


def _wire_smem(lib, bits: int, blk: int) -> int:
    """Dynamic shared memory of a K3 block at the tp=2 down shard, M=4,
    float32."""
    sizes = (ctypes.c_longlong * 3)()
    k, n, gs = DOWN_TP[1:]
    err = lib.dequant_matmul_wire_sizes(
        4, n, k, gs, dk.pick_block_k(k, gs),
        *wire_params(n, TP, bits, blk)[::2], bits, 0, sizes)
    if err:
        raise RuntimeError(f"dequant_matmul_wire_sizes: error {err}")
    return sizes[2]


def _ptxas_instances(log: str, tag: str) -> dict:
    """Registers and spill bytes of each K2 instance whose mangled name
    holds ``tag`` (its head dim), from a build's ``ptxas -v`` lines, keyed
    by its element type."""
    types_ = {"If": "float32", "I13__nv_bfloat16": "bfloat16",
              "I6__half": "float16"}
    out, name = {}, None
    for text in log.splitlines():
        m = re.search(r"Function properties for (\S+)", text)
        if m:
            name = m.group(1)
            continue
        if name is None or tag not in name:
            continue
        key = types_.get(name.split("flash_attention_kernel", 1)[-1]
                         .split(tag)[0], name)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            out.setdefault(key, {})["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", text)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    if len(out) != len(fa.KERNEL_DTYPES) or any(
            len(r) != 3 for r in out.values()):
        raise AssertionError(f"ptxas: expected registers and spills of "
                             f"{len(fa.KERNEL_DTYPES)} {tag} instances, "
                             f"read {out}")
    return out


def _decode_loop_ptxas(log: str) -> dict:
    """Registers and spill bytes of each instance of K1's float32 decode
    loop (``dequant_matmul_decode_tc_kernel``) in a build's ``ptxas -v``
    lines, keyed by its mangled name's template arguments."""
    out, name = {}, None
    for text in log.splitlines():
        m = re.search(r"Function properties for (\S+)", text)
        if m:
            name = m.group(1)
            continue
        if name is None or "dequant_matmul_decode_tc_kernel" not in name:
            continue
        key = name.split("dequant_matmul_decode_tc_kernel", 1)[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            out.setdefault(key, {})["spill_stores"] = int(m.group(1))
            out[key]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", text)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def phase_build() -> dict:
    kernels = dk.KERNELS + (fa.FLASH,)
    t0 = time.perf_counter()
    kbuild.compile_all(*kernels)
    wall = time.perf_counter() - t0
    libs = {k.name: kbuild.load(k) for k in kernels}
    ordered, gidx = libs[dk.ORDERED.name], libs[dk.GIDX.name]
    # dynamic shared memory per block at the main paths' shapes (f32,
    # M<=4, and M=2048 for K1's tensor-core loop)
    smem = {
        dk.ORDERED.name: {
            f"{name} M={m}": ordered.dequant_matmul_smem_bytes(
                m, n, gs, dk.pick_block_k(k, gs), 0)
            for name, k, n, gs in (UP, DOWN) for m in (4, 2048)},
        # K3's launch: K1's main loop, its epilogue in the same memory
        dk.WIRE.name: {
            f"{DOWN_TP[0]} int{bits}": _wire_smem(libs[dk.WIRE.name], bits,
                                                  blk)
            for *_, bits, blk in WIRE_RANK},
        dk.GIDX.name: {
            f"{name} ({gidx.dequant_matmul_gidx_block_n(4, n, k // gs, 0)} "
            f"columns)": gidx.dequant_matmul_gidx_smem_bytes(4, n, k // gs,
                                                             0, 0)
            for name, k, n, gs in (UP, DOWN)},
        dk.DEQUANTIZE.name: 0,
        fa.FLASH.name: {
            f"{dt} D{d}": libs[fa.FLASH.name].flash_attention_smem_bytes(
                d, fa.KERNEL_DTYPES[dt]) for dt in FLASH_TOL
            for d in (128, 256)}}
    out = {"wall_seconds": wall, "kernels": {}}
    for k in kernels:
        info = kbuild.info[k.name]
        regs = [s.split(":", 1)[-1].strip() for s in info["ptxas"].splitlines()
                if "registers" in s]
        out["kernels"][k.name] = {"seconds": info["seconds"], "ptxas": regs,
                                  "smem_bytes": smem[k.name],
                                  "path": os.path.relpath(info["path"], ROOT)}
        line("build", f"{k.name}: {info['seconds']:.1f}s -> "
                      f"{out['kernels'][k.name]['path']}; dynamic smem "
                      f"{smem[k.name]}; ptxas: {' || '.join(regs)}")
    out["flash_d256"] = d256 = _ptxas_instances(
        kbuild.info[fa.FLASH.name]["ptxas"], "Li256E")
    line("build", "flash_attention at head dim 256, ptxas: " + "; ".join(
        f"{name}: {r['registers']} registers, spill stores "
        f"{r['spill_stores']} B, loads {r['spill_loads']} B"
        for name, r in d256.items()))
    # K1's float32 decode loop in K1 (4 and 8 rows, N a multiple of 4 or
    # not: 4 instances) and in K3 (the same with each wire's epilogue: 8)
    out["decode_loop"] = dec = {
        k.name: _decode_loop_ptxas(kbuild.info[k.name]["ptxas"])
        for k in (dk.ORDERED, dk.WIRE)}
    for lib, inst in dec.items():
        if len(inst) < 4 or any(len(r) != 3 or r["spill_stores"]
                                or r["spill_loads"] for r in inst.values()):
            raise AssertionError(f"{lib}: expected the float32 decode loop's "
                                 f"instances without spills, ptxas says "
                                 + "; ".join(f"{key[:12]}..{key[-40:]}: {r}"
                                             for key, r in inst.items()))
    line("build", "the float32 decode loop (dequant_matmul_decode_tc_kernel), "
                  "ptxas: " + "; ".join(
                      f"{lib}: {len(inst)} instances, " + "/".join(
                          str(r["registers"]) for r in inst.values())
                      + " registers" for lib, inst in dec.items())
                  + "; no spill stores or loads")
    line("build", f"{len(kernels)} kernels, nvcc in parallel: {wall:.1f}s")
    return out


def _quantized(gen, k, n, gs):
    w = torch.randn(k, n, generator=gen, device="cuda")
    return qz.quantize(w, gs, generator=gen)


def _within(rows: list, err: float, ref: torch.Tensor, rtol: float,
            atol: float, what: str, **case) -> float:
    """Record one case and raise if it is out of tolerance; returns the
    error relative to max|ref|."""
    scale = ref.float().abs().max().item()
    limit = rtol * scale + atol
    rows.append(dict(case, max_abs_err=err, limit=limit))
    if not (math.isfinite(err) and err <= limit):
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{rows[-1]}")
    return err / max(scale, 1e-30)


def _check_gemm(gen, name, shapes, layout, kernel, plain,
                phase: str = "check") -> dict:
    """A dequant-GEMM kernel against its plain version; returns the worst
    relative error per dtype, the largest float32 error at qwen3-4b's
    main path's shapes (M=4, full width) and at its forward's (M=2048,
    full width) where those run, and every case's record."""
    rows, worst, main, large = [], {}, 0.0, None
    for m, k, n, gs in shapes:
        ql = getattr(_quantized(gen, k, n, gs), layout)
        x = torch.randn(m, k, generator=gen, device="cuda")
        for dtype, (rtol, atol) in TOL.items():
            y = kernel(x, ql, dtype)
            ref = plain(x, ql, dtype)
            torch.cuda.synchronize()
            if y.shape != ref.shape:
                raise AssertionError(f"{name}: shape {tuple(y.shape)} != "
                                     f"{tuple(ref.shape)}")
            err = (y.float() - ref.float()).abs().max().item()
            rel = _within(rows, err, ref, rtol, atol, name, m=m, k=k, n=n,
                          gs=gs, dtype=str(dtype))
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), rel)
            if dtype == torch.float32 and (k, n) in QWEN_KN:
                if m == 4:
                    main = max(main, err)
                if m == 2048:
                    large = max(large or 0.0, err)
    line(phase, f"{name}: {len(rows)} cases within tolerance; max err / "
                  f"max|ref|: f32 {worst['torch.float32']:.3g}, bf16 "
                  f"{worst['torch.bfloat16']:.3g}; f32 max_abs_err at the "
                  f"main path's shapes {main:.3g}"
                  + ("" if large is None else
                     f", at the forward's (M=2048) {large:.3g}")
                  + "; tol f32 1e-5*max|ref|+1e-4, bf16 1e-2*max|ref|")
    return {"worst_rel": worst, "main_max_abs_err": main,
            "m2048_max_abs_err": large, "cases": rows}


def _check_dequantize(gen) -> dict:
    rows = []
    for k, n, gs in DEQUANT_SHAPES:
        ql = _quantized(gen, k, n, gs).ordered
        for dtype in TOL:
            w = dk.dequantize_ordered(ql.qweight, ql.scales, ql.zeros,
                                      group_size=gs, out_dtype=dtype)
            ref = dk.dequantize_ordered_torch(ql.qweight, ql.scales,
                                              ql.zeros, group_size=gs,
                                              out_dtype=dtype)
            torch.cuda.synchronize()
            equal = bool(torch.equal(w, ref))
            rows.append({"k": k, "n": n, "gs": gs, "dtype": str(dtype),
                         "bit_equal": equal})
            if not equal:
                raise AssertionError(f"dequantize_ordered is not bit-equal "
                                     f"to its plain version: {rows[-1]}")
    line("check", f"dequantize_ordered: {len(rows)} cases (f32/bf16) "
                  f"bit-equal to the plain version")
    return {"main_max_abs_err": 0.0, "cases": rows}


def _check_flash(gen) -> dict:
    rows, worst, main, main_rel = [], {}, 0.0, 0.0
    cases = [(b, h, s, s, d, causal, window)
             for b, h, s, d, causal, window in FLASH_SWEEP] + FLASH_EDGES
    worst_256, rec = {}, 0.0
    for case in cases + FLASH_EDGES_256:
        b, h, s, t, d, causal, window = case
        for dtype, (rtol, atol) in FLASH_TOL.items():
            q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn(b, h, t, d, generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            y = fa.flash_attention(q, k, v, causal=causal, window=window)
            ref = fa.flash_attention_torch(q, k, v, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            rel = _within(rows, err, ref, rtol, atol, "flash_attention",
                          shape=[b, h, s, t, d], causal=causal,
                          window=window, dtype=str(dtype))
            into = worst_256 if d == 256 else worst
            into[str(dtype)] = max(into.get(str(dtype), 0.0), rel)
            if (b, h, s, d, causal, window) == FLASH_FULL and (
                    dtype == torch.float32):
                main = err
                main_rel = rel
            if case == FLASH_EDGES_256[-1] and dtype == torch.float32:
                rec = err
            del q, k, v, y, ref
    line("check", f"flash_attention: {len(rows)} cases (the reference's, "
                  f"{len(FLASH_EDGES)} tiling edges, the full-width shape) "
                  f"within tolerance; max err / max|ref|: f32 "
                  f"{worst['torch.float32']:.3g}, bf16 "
                  f"{worst['torch.bfloat16']:.3g}; f32 max_abs_err at the "
                  f"full-width shape {main:.3g} ({main_rel:.3g} of max|ref|); "
                  f"tol f32 1e-5*max|ref|+1e-5, bf16 2e-2*max|ref|")
    line("check", f"flash_attention at head dim 256 (64-query blocks, "
                  f"32-key tiles): {len(FLASH_EDGES_256)} tiling edges x 2 "
                  f"dtypes within the same tolerance; max err / max|ref|: "
                  f"f32 {worst_256['torch.float32']:.3g}, bf16 "
                  f"{worst_256['torch.bfloat16']:.3g}; f32 max_abs_err at "
                  f"recurrentgemma's B1 H10 S2048 window 2048 {rec:.3g}")
    return {"worst_rel": worst, "main_max_abs_err": main,
            "main_rel_err": main_rel, "worst_rel_d256": worst_256,
            "rec_max_abs_err": rec, "cases": rows}


def _wire_values(p, s, z, bits, bs):
    """The float32 values a wire tuple carries."""
    if bits == 8:
        return comm._blockwise_dequantize(p, s, bs)
    return comm._blockwise_dequantize_int4(comm._unpack4_last(p), s, z, bs)


def _wire_case(ql, x, shape, dtype) -> dict:
    """K3 on one case (``shape``: k, n, gs, tp, bits, preferred block;
    ``x`` its M rows) against K1 followed by the collective's quantizer
    (bit-equal) and against its plain version (within one level beyond
    the GEMM outputs' own difference); raises on a disagreement, else
    returns the case's record."""
    k, n, gs, tp, bits, blk = shape
    n_pad, _, bs = wire_params(n, tp, bits, blk)
    got = ops.dequant_matmul_wire(x, ql, tp=tp, wire_bits=bits,
                                  wire_block=blk, compute_dtype=dtype)
    y_k1 = ops.dequant_matmul(x, ql, compute_dtype=dtype)
    unfused = dk.quantize_wire(y_k1, n_pad=n_pad, wire_block=bs,
                               wire_bits=bits)
    y_plain = dk.dequant_matmul_ordered_torch(
        x, ql.qweight, ql.scales, ql.zeros, group_size=gs,
        compute_dtype=dtype)
    plain = dk.dequant_matmul_wire_ordered_torch(
        x, ql.qweight, ql.scales, ql.zeros, group_size=gs, n_pad=n_pad,
        wire_block=bs, wire_bits=bits, compute_dtype=dtype)
    torch.cuda.synchronize()
    equal = all((a is None and b is None) or torch.equal(a, b)
                for a, b in zip(got, unfused))
    vals, ref = (_wire_values(*t, bits, bs) for t in (got, plain))
    step = torch.maximum(got[1], plain[1]).float().repeat_interleave(
        bs, dim=-1)
    diff = (vals - ref).abs()
    gemm_gap = F.pad((y_k1.float() - y_plain.float()).abs(), (0, n_pad - n))
    # an all-zero block's int8 scale is 0 in float16
    levels = torch.where(diff == 0, 0.0, diff / step).max().item()
    beyond = torch.where(diff <= gemm_gap, 0.0,
                         (diff - gemm_gap) / step).max().item()
    row = {"m": x.shape[0], "k": k, "n": n, "gs": gs, "tp": tp,
           "bits": bits, "block": bs, "n_pad": n_pad, "dtype": str(dtype),
           "bit_equal_to_k1": equal, "levels_from_plain": levels,
           "levels_beyond_gemm_gap": beyond, "max_abs_err": diff.max().item()}
    if not equal or not beyond <= 1.001:
        raise AssertionError(f"dequant_matmul_wire_ordered disagrees: {row}")
    return row


def _check_wire(gen) -> dict:
    """K3 against K1 followed by the collective's quantizer (bit-equal:
    payload, scales, zeros) and against its plain version, whose
    torch.matmul sums in another order: each side's quantizer is within
    half a level of its own GEMM output, so a wire value is within one
    level (the block's larger scale) of the plain one plus the two GEMM
    outputs' difference there (K1's, held to its plain version in its own
    check; in bfloat16 one ulp at a block's extreme moves the scale)."""
    rows, main = [], 0.0
    # above K1's tensor-core threshold at the tp=2 down shard and the
    # edges, in float32 (the one compute type that takes that loop)
    m_tc = dk.tensor_core_min_m() + 3
    for shape in WIRE_SWEEP:
        k, n, gs, tp, bits, blk = shape
        ql = _quantized(gen, k, n, gs).ordered
        above = shape in WIRE_EDGES + WIRE_RANK
        for m in (1, 4, 64) + ((m_tc,) if above else ()):
            x = torch.randn(m, k, generator=gen, device="cuda")
            for dtype in TOL if m != m_tc else (torch.float32,):
                rows.append(_wire_case(ql, x, shape, dtype))
                if (k, n, m, bits, dtype) == (DOWN_TP[1], DOWN_TP[2], 4, 8,
                                              torch.float32):
                    main = rows[-1]["max_abs_err"]
    worst = max(r["levels_from_plain"] for r in rows)
    beyond = max(r["levels_beyond_gemm_gap"] for r in rows)
    archs = {name: next(r["max_abs_err"] for r in rows if (
        r["k"], r["n"], r["m"], r["bits"], r["dtype"]) == (
            k, n, 4, 8, str(torch.float32)))
        for name, k, n, _ in ARCH_TP_DOWN.values()}
    line("check", f"dequant_matmul_wire_ordered: {len(rows)} cases (int8 "
                  f"and int4, f32 and bf16, M 1/4/64, padded wires, "
                  f"epilogue units of several tiles (blocks of 86 over "
                  f"n_pad 258, int4 blocks of 48) and the tp=2 down shard "
                  f"also at M={m_tc} in f32, the other archs' tp=2 down "
                  f"shards (K N gs: "
                  + ", ".join(f"{k} {n} {gs}"
                              for _, k, n, gs in ARCH_TP_DOWN.values())
                  + ")) bit-equal to K1 "
                  f"+ the collective's quantizer; against the plain "
                  f"version at most {worst:.3g} quantization levels, "
                  f"{beyond:.3g} beyond the GEMM outputs' own difference "
                  f"(tol 1); max_abs_err at the main path's shape (M=4, "
                  f"int8, f32) {main:.3g}")
    return {"main_max_abs_err": main, "arch_max_abs_err": archs,
            "worst_levels_beyond_gemm_gap": beyond,
            "worst_levels": worst, "cases": rows}


def _kernel_launches(fn) -> dict:
    """Device kernels (and copies) one call of ``fn`` launches, by name.
    A profiler session that records no device event at all is run again,
    up to ten times, a second apart: a call of a kernel's wrapper
    launches something, so then the profiler missed it (five empty
    sessions in a row have been seen on the card)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(10):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {e.key: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")}
        if out:
            break
    return out


#: ``CUgraphNodeType`` (cuda.h): the kinds of work a captured call holds
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               10: "mem_alloc", 11: "mem_free"}


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h): a kernel node's launch."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_nodes(fn) -> list:
    """The device work one call of ``fn`` enqueues, node by node, as
    (kind, name): the call captured in a CUDA graph (after one call on
    the capture's stream outside it), the graph's nodes read with
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` from libcuda, and
    each kernel node's (mangled) function name with
    ``cuGraphKernelNodeGetParams_v2`` and ``cuFuncGetName`` (or
    ``cuKernelGetName``); other nodes have the name None.  A capture
    holds every launch and copy the call makes, where a
    ``torch.profiler`` session on the card has recorded no device event
    at all ten times in a row, and others dropped a few kernels of a
    step.  What the wrappers count during the capture is taken back."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    counts = ops.launch_counts()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ops.add_launch_counts(c - a for a, c in zip(ops.launch_counts(), counts))
    raw = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        kind = _NODE_TYPES.get(kind.value, f"type {kind.value}")
        name = None
        if kind == "kernel":
            p = _KernelNodeParams()
            check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                   ctypes.byref(p)),
                  "cuGraphKernelNodeGetParams_v2")
            text = ctypes.c_char_p()
            if p.func:
                check(cu.cuFuncGetName(ctypes.byref(text),
                                       ctypes.c_void_p(p.func)),
                      "cuFuncGetName")
            else:
                check(cu.cuKernelGetName(ctypes.byref(text),
                                         ctypes.c_void_p(p.kern)),
                      "cuKernelGetName")
            name = text.value.decode()
        out.append((kind, name))
    del graph
    return out


def _graph_work(fn) -> dict:
    """The device work one call of ``fn`` enqueues, by kind
    (``"kernel"``, ``"memcpy"``, ``"memset"``, ...; ``_graph_nodes``)."""
    out = {}
    for kind, _ in _graph_nodes(fn):
        out[kind] = out.get(kind, 0) + 1
    return out


def _bits(t):
    """A wire tensor as raw bits (float16 scales as int16)."""
    return t.view(torch.int16) if t.dtype == torch.float16 else t


def _check_wire_repeat(gen) -> list:
    """K3's counters reset and a call is one launch: at the rank shape and
    the edges (M 4 and 64; also above K1's tensor-core threshold in
    float32, its other loop), the same call twice and once more after a
    call of another shape give the same bits, and one call enqueues
    exactly one kernel and no other device work (``_graph_work``)."""
    m_tc = dk.tensor_core_min_m() + 3
    other = _quantized(gen, 64, 128, 8).ordered
    rows = []
    for shape in WIRE_RANK + WIRE_EDGES:
        k, n, gs, tp, bits, blk = shape
        ql = _quantized(gen, k, n, gs).ordered
        for m, dtype in [(m, dt) for m in (4, 64) for dt in TOL] + [
                (m_tc, torch.float32)]:
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            ox = torch.randn(3, 64, generator=gen, device="cuda").to(dtype)

            def call():
                return ops.dequant_matmul_wire(x, ql, tp=tp, wire_bits=bits,
                                               wire_block=blk,
                                               compute_dtype=dtype)

            first, second = call(), call()
            ops.dequant_matmul_wire(ox, other, tp=3, wire_bits=4,
                                    wire_block=16, compute_dtype=dtype)
            third = call()
            torch.cuda.synchronize()
            same = all(a is None or (torch.equal(_bits(a), _bits(b))
                                     and torch.equal(_bits(a), _bits(c)))
                       for a, b, c in zip(first, second, third))
            work = _graph_work(call)
            row = {"m": m, "k": k, "n": n, "tp": tp, "bits": bits,
                   "dtype": str(dtype), "repeats_bit_equal": same,
                   "device_kernels_per_call": work.get("kernel", 0),
                   "device_work_per_call": work}
            rows.append(row)
            if not same or work != {"kernel": 1}:
                raise AssertionError(f"dequant_matmul_wire_ordered: repeated "
                                     f"calls differ or a call is not one "
                                     f"kernel: {row}")
    line("check", f"dequant_matmul_wire_ordered: {len(rows)} cases (the tp=2 "
                  f"down shard and the edges, M 4/64 f32 and bf16, M={m_tc} "
                  f"f32): the same call twice and after a call of another "
                  f"shape bit-equal (the counters reset), and one call = "
                  f"one kernel and no other device work (the nodes of its "
                  f"CUDA graph)")
    return rows


def _large_m_cases(t: int) -> list:
    """K1 cases (M, K, N, gs) at and around its tensor-core threshold
    ``t``: the full-width MLP shapes at M=2048 (blocks of 128 rows for
    up/gate, of 160 for down), ragged M (t - 1 on the decode loop, t,
    t + 1, 2047), ragged N (102 and 200, not multiples of 4; 2501, odd,
    in blocks of 160 rows) at gs 76 and 64, a K step past K (K 152), gs 8
    (many groups a K step)."""
    return [(2048,) + UP[1:], (2048,) + DOWN[1:],
            (t - 1, 608, 200, 76), (t, 608, 200, 76), (t + 1, 608, 200, 76),
            (2047, 608, 200, 76), (t + 1, 256, 102, 64), (2047, 256, 102, 64),
            (t + 3, 152, 200, 76), (t + 5, 64, 128, 8),
            (2047, 152, 2501, 76)]


def _check_gidx_invariance(gen) -> list:
    """K4's sum order depends on K alone: at both full-width shapes, in
    float32 and bfloat16, the rows of an M = 4 call (the decode loop's
    BM = 4) and of an M = 17 call (BM = 16) are bit-equal to the same rows
    run one at a time (M = 1), and the kernel's pick of columns per block
    to each width forced (16 and 32)."""
    rows = []
    for name, k, n, gs in (UP, DOWN):
        ql = _quantized(gen, k, n, gs).naive
        x = torch.randn(17, k, generator=gen, device="cuda")
        args = (ql.qweight, ql.scales, ql.zeros, ql.g_idx)
        for dtype in TOL:
            solo = torch.cat([dk.dequant_matmul_gidx(
                x[i:i + 1], *args, compute_dtype=dtype) for i in range(17)])
            batch4 = dk.dequant_matmul_gidx(x[:4], *args,
                                            compute_dtype=dtype)
            batch17 = dk.dequant_matmul_gidx(x, *args, compute_dtype=dtype)
            widths = [dk.dequant_matmul_gidx(x[:4], *args,
                                             compute_dtype=dtype, block_n=bn)
                      for bn in (16, 32)]
            torch.cuda.synchronize()
            row = {"shape": name, "dtype": str(dtype),
                   "m4_rows_equal_m1": bool(torch.equal(batch4, solo[:4])),
                   "m17_rows_equal_m1": bool(torch.equal(batch17, solo)),
                   "widths_equal": all(torch.equal(batch4, w)
                                       for w in widths)}
            rows.append(row)
            if not all(v for v in row.values() if isinstance(v, bool)):
                raise AssertionError(f"dequant_matmul_gidx depends on the "
                                     f"batch or the tile width: {row}")
    line("check", f"dequant_matmul_gidx: batch invariance at both full-width "
                  f"shapes, f32 and bf16: rows of M=4 and M=17 calls "
                  f"bit-equal to M=1 calls, and 16- and 32-column tiles "
                  f"bit-equal ({len(rows)} cases)")
    return rows


def _arch_errs(rows: list) -> dict:
    """The largest float32 error at M=4 at each of the other archs' MLP
    shapes and the MoE experts' (M 4 and 8), by shape name."""
    shapes = {**ARCH_SHAPES, **MOE_SHAPES}
    return {name: max(r["max_abs_err"] for r in rows
                      if r["m"] in (4, 8) and (r["k"], r["n"], r["gs"],
                                               r["dtype"])
                      == (k, n, gs, str(torch.float32)))
            for a in shapes for name, k, n, gs in shapes[a]}


def _arch_cases() -> list:
    """(M, K, N, gs) of the other archs' full-width MLP shapes at decode M
    (1 and 4), and of the MoE experts' at an expert's decode capacity (4)
    and a data rank's share under expert parallelism at dp=2 (8)."""
    archs = [(m, k, n, gs) for a in ARCHS for _, k, n, gs in ARCH_SHAPES[a]
             for m in (1, 4)]
    return archs + [(m, k, n, gs) for a in MOE_ARCHS
                    for _, k, n, gs in MOE_SHAPES[a] for m in (4, 8)]


def k1_cases(t: int) -> list:
    """K1's check cases (M, K, N, gs) around a tensor-core threshold ``t``:
    the sweep, qwen3-4b's full-width shapes at M 1, 4 and 32, the large-M
    cases, the other archs' and the experts' shapes, and the attention
    fold's V and O at decode M and the forward's."""
    full = [(m, k, n, gs) for _, k, n, gs in (UP, DOWN) for m in (1, 4, 32)]
    fold = [(m, k, n, gs) for _, k, n, gs in FOLD for m in (4, 2048)]
    return SWEEP + full + _large_m_cases(t) + _arch_cases() + fold


def _check_k1_invariance(gen) -> list:
    """K1's float32 sum order depends on N, K, the group size and the card,
    never on M: at both full-width shapes the rows of calls at M 4, 8, 17,
    64 and 255 (every M below the large-M loop's threshold takes the
    decode loop on the tensor cores) are bit-equal to the same rows run
    one at a time (M = 1)."""
    t = dk.tensor_core_min_m()
    ms = (4, 8, 17, 64, 255)
    if max(ms) >= t:
        raise AssertionError(f"the batch invariance check needs M < {t}")
    rows = []
    for name, k, n, gs in (UP, DOWN):
        ql = _quantized(gen, k, n, gs).ordered
        x = torch.randn(max(ms), k, generator=gen, device="cuda")
        solo = torch.cat([ops.dequant_matmul(x[i:i + 1], ql)
                          for i in range(max(ms))])
        row = {"shape": name, **{f"m{m}_rows_equal_m1": bool(torch.equal(
            ops.dequant_matmul(x[:m], ql), solo[:m])) for m in ms}}
        torch.cuda.synchronize()
        rows.append(row)
        if not all(v for v in row.values() if isinstance(v, bool)):
            raise AssertionError(f"dequant_matmul_ordered's float32 rows "
                                 f"depend on the batch: {row}")
    line("check", f"dequant_matmul_ordered: batch invariance at both "
                  f"full-width shapes, float32: rows of M "
                  f"{'/'.join(map(str, ms))} calls bit-equal to M=1 calls "
                  f"({len(rows)} shapes)")
    return rows


def phase_check(gen) -> dict:
    archs = _arch_cases()
    t = dk.tensor_core_min_m()
    cases = k1_cases(t)
    wire = _check_wire(gen)
    tc0 = dk.dequant_matmul_ordered.tensor_core_launches
    ordered = _check_gemm(
        gen, "dequant_matmul_ordered", cases, "ordered",
        lambda x, ql, dt: ops.dequant_matmul(x, ql, compute_dtype=dt),
        lambda x, ql, dt: dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros,
            group_size=ql.group_size, compute_dtype=dt))
    tc = dk.dequant_matmul_ordered.tensor_core_launches - tc0
    want = sum(m >= t for m, *_ in cases)  # f32
    if tc != want:
        raise AssertionError(f"K1's tensor-core loop ran {tc} times in the "
                             f"check, expected {want} (float32, M >= {t})")
    ordered["tensor_core_min_m"] = t
    ordered["tensor_core_launches"] = tc
    ordered["arch_max_abs_err"] = _arch_errs(ordered["cases"])
    ordered["batch_invariance"] = _check_k1_invariance(gen)
    ordered["fold_max_abs_err"] = {
        f"{name} M={m}": max(r["max_abs_err"] for r in ordered["cases"]
                             if (r["k"], r["n"], r["m"]) == (k, n, m)
                             and r["dtype"] == str(torch.float32))
        for name, k, n, _ in FOLD for m in (4, 2048)}
    line("check", "dequant_matmul_ordered at the fold's shapes, float32 "
                  "max_abs_err: " + ", ".join(
                      f"{key} {err:.3g}"
                      for key, err in ordered["fold_max_abs_err"].items()))
    line("check", f"dequant_matmul_ordered: tensor-core loop from M={t} "
                  f"(float32): {tc} of the cases above ran it")
    gidx_full = [(m, k, n, gs) for _, k, n, gs in (UP, DOWN)
                 for m in (1, 4, 5, 17, 32, 33)]
    gidx = _check_gemm(
        gen, "dequant_matmul_gidx", GIDX_SWEEP + SWEEP + GIDX_EDGES
        + gidx_full + archs, "naive",
        lambda x, ql, dt: ops.dequant_matmul(x, ql, compute_dtype=dt),
        lambda x, ql, dt: dk.dequant_matmul_gidx_torch(
            x, ql.qweight, ql.scales, ql.zeros, ql.g_idx, compute_dtype=dt))
    gidx["arch_max_abs_err"] = _arch_errs(gidx["cases"])
    gidx["batch_invariance"] = _check_gidx_invariance(gen)
    return {
        "dequant_matmul_wire_ordered": wire,
        "dequant_matmul_ordered": ordered,
        "dequant_matmul_gidx": gidx,
        "dequantize_ordered": _check_dequantize(gen),
        "flash_attention": _check_flash(gen),
    }


def _time(fn, args_list, reps: int, batches: int = 5,
          graph: bool = True) -> float:
    """Median over ``batches`` of the mean ms per call, cycling through
    ``args_list`` (distinct weight copies, so the 50 MB L2 holds none).

    With ``graph`` the ``reps`` calls are captured once as a CUDA graph and
    replayed: device time of back-to-back launches, without the host's
    launch overhead.  Without it, the calls are issued from Python."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()

    def run():
        for i in range(reps):
            fn(*args_list[i % len(args_list)])

    if graph:
        g = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(g)
        # one call on the capturing stream first: what a wrapper makes once
        # per stream (K3's counters) must exist before the capture
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args_list[0])
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with capture:
            run()
        run = g.replay
    run()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def _bound(nbytes: float, flops: float,
           peak: float = PEAK_F32) -> tuple[float, str]:
    """(least ms, what bounds it): the bytes over the memory rate or the
    operations over their rate (float32 on CUDA cores unless ``peak`` says
    otherwise), whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _copies(tensors, nbytes: int) -> list:
    """Enough clones of ``tensors`` that together they exceed L2 three
    times over."""
    return [tuple(t.clone() for t in tensors)
            for _ in range(max(2, math.ceil(150e6 / nbytes)))]


def _time_gemm(gen, layout: str, m: int = 4, shapes=(UP, DOWN)) -> dict:
    res = {}
    for name, k, n, gs in shapes:
        both = _quantized(gen, k, n, gs)
        ql = getattr(both, layout)
        meta = [ql.qweight, ql.scales, ql.zeros] + (
            [ql.g_idx] if layout == "naive" else [])
        wbytes = sum(t.numel() * t.element_size() for t in meta)
        quants = _copies(meta, wbytes)
        x = torch.randn(m, k, generator=gen, device="cuda")
        if layout == "ordered":
            def kernel(qw, s, z):
                return dk.dequant_matmul_ordered(x, qw, s, z, group_size=gs)

            def plain(qw, s, z):
                return dk.dequant_matmul_ordered_torch(x, qw, s, z,
                                                       group_size=gs)
        else:
            def kernel(qw, s, z, g):
                return dk.dequant_matmul_gidx(x, qw, s, z, g)

            def plain(qw, s, z, g):
                return dk.dequant_matmul_gidx_torch(x, qw, s, z, g)

        reps = 10 * len(quants)
        ms = _time(kernel, quants, reps=reps)
        eager_ms = _time(kernel, quants, reps=reps, graph=False)
        plain_ms = _time(plain, quants[:2], reps=10)
        nbytes = 4 * (m * k + m * n) + wbytes
        bound, by = _bound(nbytes, 2 * m * k * n)
        res[name] = {"m": m, "k": k, "n": n, "gs": gs, "ms": ms,
                     "eager_ms": eager_ms, "plain_ms": plain_ms,
                     "bytes": nbytes, "bound_ms": bound, "bound_by": by,
                     "weight_copies": len(quants)}
        if layout == "ordered":
            # context: torch.matmul on the pre-dequantized weight
            w_deq = [qz.dequantize(ql) for _ in range(2)]
            res[name]["matmul_dequantized_ms"] = _time(
                lambda w: torch.matmul(x, w), [(w,) for w in w_deq], reps=20)
            del w_deq
        else:
            # the table a launch reads once per column tile, and the tile
            res[name]["table_bytes"] = ql.scales.shape[0] * n * 8
            res[name]["block_n"] = kbuild.load(
                dk.GIDX).dequant_matmul_gidx_block_n(m, n, ql.scales.shape[0],
                                                     0)
            # the same kernel on the ordered layout (g_idx = k // gs): the
            # naive layout's cost inside one kernel design
            o = both.ordered
            rows = (torch.arange(k, device="cuda") // gs).to(torch.int32)
            res[name]["ordered_layout_ms"] = _time(
                kernel, _copies([o.qweight, o.scales, o.zeros, rows], wbytes),
                reps=reps)
        del quants
    return res


def _per_layer(res: dict, key: str, shapes=(UP, DOWN),
               gated: bool = True) -> float:
    """One layer's launches: up, gate (same shape, where the MLP is gated)
    and down."""
    up, down = (res[name][key] for name, *_ in shapes)
    return (2 if gated else 1) * up + down


def _time_dequantize(gen) -> dict:
    res = {}
    for name, k, n, gs in (UP, DOWN):
        ql = _quantized(gen, k, n, gs).ordered
        meta = [ql.qweight, ql.scales, ql.zeros]
        wbytes = sum(t.numel() * t.element_size() for t in meta)
        quants = _copies(meta, wbytes)
        ms = _time(lambda qw, s, z: dk.dequantize_ordered(
            qw, s, z, group_size=gs), quants, reps=4 * len(quants))
        plain_ms = _time(lambda qw, s, z: dk.dequantize_ordered_torch(
            qw, s, z, group_size=gs), quants[:2], reps=4)
        # the float32 output, written once per call, is most of the bytes
        nbytes = wbytes + 4 * k * n
        bound, by = _bound(nbytes, 2 * k * n)
        res[name] = {"k": k, "n": n, "gs": gs, "ms": ms, "plain_ms": plain_ms,
                     "bytes": nbytes, "bound_ms": bound, "bound_by": by}
        del quants
    return res


def _flash_flops(b, h, s, t, d, causal, window) -> float:
    """Multiply-adds of QK^T and PV over the keys each query sees."""
    mask = fa.attention_mask(s, t, causal=causal, window=window)
    return 4.0 * d * b * h * mask.sum().item()


def _kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches."""
    return sorted(_kernel_launches(fn))


def _time_sdpa(qkv) -> dict:
    """``scaled_dot_product_attention(is_causal=True)`` on the same
    tensors: the default call (the library yardstick), the backend behind
    it (the one whose kernels a call restricted to it launches), and the
    memory-efficient and math backends alone."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = qkv[0]
    default = _kernel_names(lambda: sdpa(q, k, v, is_causal=True))
    out = {"default_ms": _time(lambda q, k, v: sdpa(q, k, v, is_causal=True),
                               qkv, reps=6, batches=5),
           "default_kernels": default, "backend": None}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            # a backend that cannot take these inputs warns why, then raises
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore", UserWarning)
                names = _kernel_names(lambda: sdpa(q, k, v, is_causal=True))
        except RuntimeError:
            continue
        if names == default and out["backend"] is None:
            out["backend"] = backend.name
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel(backend):
            out[f"{backend.name.lower()}_ms"] = _time(
                lambda q, k, v: sdpa(q, k, v, is_causal=True), qkv,
                reps=6 if backend == SDPBackend.EFFICIENT_ATTENTION else 3,
                batches=5 if backend == SDPBackend.EFFICIENT_ATTENTION else 3)
    return out


def _time_flash(gen, shape=FLASH_FULL) -> dict:
    """K2 at the full-width forward's shape (or ``shape``) beside its plain
    version, the library call, and two bounds: its route's (3xTF32 on the
    tensor cores: three TF32 operations for each float32 one) and, for
    comparison with earlier CUDA-core versions, the float32 CUDA-core
    bound."""
    b, h, s, d, causal, window = shape
    qkv = [tuple(torch.randn(b, h, s, d, generator=gen, device="cuda")
                 for _ in range(3)) for _ in range(2)]
    ms = _time(lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                                  window=window),
               qkv, reps=6, batches=5)
    plain_ms = _time(lambda q, k, v: fa.flash_attention_torch(
        q, k, v, causal=causal, window=window), qkv, reps=4, batches=3)
    library = _time_sdpa(qkv)
    nbytes = 4 * 4 * b * h * s * d                  # q, k, v read; o written
    flops = _flash_flops(b, h, s, s, d, causal, window)
    bound, by = _bound(nbytes, 3 * flops, PEAK_TF32)
    f32_bound, _ = _bound(nbytes, flops)
    return {"shape": [b, h, s, d], "causal": causal, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library["default_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(is_causal=True)", "sdpa": library,
            "bytes": nbytes, "flops": flops, "bound_ms": bound,
            "bound_by": by, "f32_cuda_core_bound_ms": f32_bound}


def _time_flash_long(gen) -> dict:
    """K2 at starcoder2's long forward (B1 H24 S8192 D128, causal, its
    4096-token window) beside ``scaled_dot_product_attention`` on the
    same tensors with the boolean window mask (the library yardstick; the
    backend it picks named, as ``_time_sdpa`` names it) and K2's plain
    version.  K2 is held against the plain version on the same inputs
    (``FLASH_TOL`` float32; raises outside it), and its largest
    difference from the library's output is reported."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    cfg = arch_config("starcoder2-3b")
    h, d, s, window = cfg.n_heads, cfg.head_dim, LONG_S, cfg.attention_window
    qkv = [tuple(torch.randn(1, h, s, d, generator=gen, device="cuda")
                 for _ in range(3)) for _ in range(2)]
    mask = fa.attention_mask(s, s, causal=True, window=window, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, k, v):
        return sdpa(q, k, v, attn_mask=mask)

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, window=window)

    def plain(q, k, v):
        return fa.flash_attention_torch(q, k, v, causal=True, window=window)

    rtol, atol = FLASH_TOL[torch.float32]
    y, ref = kernel(*qkv[0]), plain(*qkv[0])
    err = (y - ref).abs().max().item()
    rel = _within([], err, ref, rtol, atol, "flash_attention",
                  shape=[1, h, s, s, d], causal=True, window=window,
                  dtype="torch.float32")
    gap = (y - library(*qkv[0])).abs().max().item()
    del y, ref
    ms = _time(kernel, qkv, reps=4, batches=3)
    library_ms = _time(library, qkv, reps=2, batches=3)
    plain_ms = _time(plain, qkv, reps=1, batches=2)
    default = _kernel_names(lambda: library(*qkv[0]))
    backend = None
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(b):
                warnings.simplefilter("ignore", UserWarning)
                if _kernel_names(lambda: library(*qkv[0])) == default:
                    backend = b.name
                    break
        except RuntimeError:
            continue
    flops = _flash_flops(1, h, s, s, d, True, window)
    bound, by = _bound(4 * 4 * h * s * d, 3 * flops, PEAK_TF32)
    out = {"shape": [1, h, s, d], "window": window, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch.nn.functional.scaled_dot_product_attention "
                      "(attn_mask: the boolean causal window mask)",
           "library_backend": backend, "library_kernels": default,
           "max_abs_err": err, "rel_err": rel,
           "max_abs_diff_vs_library": gap, "bound_ms": bound,
           "bound_by": by, "flops": flops}
    line("timing", f"K2 f32 B1 H{h} S=T={s} D{d} causal window {window} "
         f"(starcoder2's long forward): {ms:.4f} ms (bound {bound:.4f} by "
         f"{by}; plain {plain_ms:.3f}); scaled_dot_product_attention with "
         f"the boolean window mask {library_ms:.4f} [library; backend "
         f"{backend}, kernels "
         + ", ".join(k[:48] for k in default)
         + f"]; K2 vs plain max abs err {err:.3g} ({rel:.3g} of max|ref|, "
         f"tol 1e-5*max|ref|+1e-5); K2 vs library max abs difference "
         f"{gap:.3g}")
    return out


def _time_k1_large(gen, m: int = 2048, shapes=(UP, DOWN),
                   cfg=QWEN) -> dict:
    """K1 at the full-sequence forward's M (2048 tokens), up/gate and
    down, CUDA-graph replay: its tensor-core loop against its route's
    bound (three TF32 operations for each float32 one, at the TF32
    tensor-core rate) and the float32 CUDA-core bound, its plain version,
    and, as context, ``torch.matmul`` of the same x with the weight
    pre-dequantized by K5 (default float32 precision; the cuBLAS kernel
    it launches named).  ``shapes`` and ``cfg``: another model's MLP."""
    res = {}
    for name, k, n, gs in shapes:
        ql = _quantized(gen, k, n, gs).ordered
        meta = [ql.qweight, ql.scales, ql.zeros]
        wbytes = sum(t.numel() * t.element_size() for t in meta)
        x = torch.randn(m, k, generator=gen, device="cuda")
        ms = _time(lambda qw, s, z: dk.dequant_matmul_ordered(
            x, qw, s, z, group_size=gs), [tuple(meta)], reps=6, batches=5)
        plain_ms = _time(lambda qw, s, z: dk.dequant_matmul_ordered_torch(
            x, qw, s, z, group_size=gs), [tuple(meta)], reps=2, batches=3)
        w = dk.dequantize_ordered(*meta, group_size=gs)
        matmul_ms = _time(lambda w: torch.matmul(x, w), [(w,)], reps=6,
                          batches=5)
        matmul_kernels = _kernel_names(lambda: torch.matmul(x, w))
        del w
        flops = 2 * m * k * n
        nbytes = 4 * (m * k + m * n) + wbytes
        bound, by = _bound(nbytes, 3 * flops, PEAK_TF32)
        f32_bound, _ = _bound(nbytes, flops)
        res[name] = {"m": m, "k": k, "n": n, "gs": gs, "ms": ms,
                     "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
                     "bound_ms": bound, "bound_by": by,
                     "f32_cuda_core_bound_ms": f32_bound,
                     "tflops": flops / ms / 1e9,
                     "matmul_dequantized_ms": matmul_ms,
                     "matmul_kernels": matmul_kernels,
                     "over_matmul": ms / matmul_ms}
    for key in ("ms", "plain_ms", "bound_ms", "f32_cuda_core_bound_ms",
                "matmul_dequantized_ms"):
        res[f"per_layer_{key}"] = _per_layer(res, key, shapes,
                                             cfg.mlp_gated)
    res["per_forward_ms"] = cfg.num_layers * res["per_layer_ms"]
    return res


def _time_wire(gen, m: int = 4, shape=DOWN_TP) -> dict:
    """K3 at one rank's down projection (tp=2), int8 and int4, beside its
    plain version, its bound, and, as context, K1 followed by the plain
    quantizer (the unfused epilogue) and K1 alone."""
    _, k, n, gs = shape
    ql = _quantized(gen, k, n, gs).ordered
    meta = [ql.qweight, ql.scales, ql.zeros]
    wbytes = sum(t.numel() * t.element_size() for t in meta)
    quants = _copies(meta, wbytes)
    x = torch.randn(m, k, generator=gen, device="cuda")
    reps = 10 * len(quants)
    res = {"k1_alone_ms": _time(lambda qw, s, z: dk.dequant_matmul_ordered(
        x, qw, s, z, group_size=gs), quants, reps=reps)}
    for bits, blk in ((8, 128), (4, 32)):
        n_pad, _, bs = wire_params(n, TP, bits, blk)
        kw = dict(group_size=gs, n_pad=n_pad, wire_block=bs, wire_bits=bits)
        ms = _time(lambda qw, s, z: dk.dequant_matmul_wire_ordered(
            x, qw, s, z, **kw), quants, reps=reps)
        unfused_ms = _time(lambda qw, s, z: dk.quantize_wire(
            dk.dequant_matmul_ordered(x, qw, s, z, group_size=gs),
            n_pad=n_pad, wire_block=bs, wire_bits=bits), quants, reps=reps)
        plain_ms = _time(lambda qw, s, z: dk.dequant_matmul_wire_ordered_torch(
            x, qw, s, z, **kw), quants[:2], reps=10)
        # the kernel nodes of a captured call: late in the script the
        # profiler has recorded no device event ten times in a row
        work = _graph_work(
            lambda: dk.dequant_matmul_wire_ordered(x, *quants[0], **kw))
        out_bytes = m * n_pad * bits // 8 + m * (n_pad // bs) * 2 * (
            1 if bits == 8 else 2)
        nbytes = 4 * m * k + wbytes + out_bytes
        bound, by = _bound(nbytes, 2 * m * k * n)
        res[f"int{bits}"] = {"m": m, "k": k, "n": n, "gs": gs, "tp": TP,
                             "block": bs, "n_pad": n_pad, "ms": ms,
                             "device_kernels_per_call": work.get("kernel", 0),
                             "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                             "bytes": nbytes, "bound_ms": bound,
                             "bound_by": by, "weight_copies": len(quants)}
    del quants
    return res


def phase_timing(gen) -> dict:
    ordered = _time_gemm(gen, "ordered")
    gidx = _time_gemm(gen, "naive")
    deq = _time_dequantize(gen)
    flash = _time_flash(gen)
    flash_rec = _time_flash(gen, FLASH_REC)
    flash_long = _time_flash_long(gen)
    wire = _time_wire(gen)
    large = _time_k1_large(gen)
    fold = _time_gemm(gen, "ordered", shapes=FOLD)
    u, d = ordered[UP[0]], ordered[DOWN[0]]
    line("timing", "K1 f32 M=4, CUDA-graph replay: up/gate {:.4f} ms (bound "
         "{:.4f}, plain {:.4f}, matmul on dequantized weight {:.4f} "
         "[context], eager call {:.4f}); down {:.4f} ms (bound {:.4f}, "
         "plain {:.4f}, matmul {:.4f} [context], eager call {:.4f})".format(
             u["ms"], u["bound_ms"], u["plain_ms"],
             u["matmul_dequantized_ms"], u["eager_ms"], d["ms"],
             d["bound_ms"], d["plain_ms"], d["matmul_dequantized_ms"],
             d["eager_ms"]))
    ratio = _per_layer(gidx, "ms") / _per_layer(ordered, "ms")
    in_kernel = _per_layer(gidx, "ms") / _per_layer(gidx, "ordered_layout_ms")
    for name in (UP[0], DOWN[0]):
        g = gidx[name]
        line("timing", "K4 f32 M=4 {} (K {} N {} gs {}; {}-column tiles, "
             "one launch), CUDA-graph replay: {:.4f} ms (bound {:.4f} by {}: "
             "{:.2f} MB, of which the table read once per column tile "
             "{:.2f} MB; plain {:.4f}, eager call {:.4f}); on the ordered "
             "layout (g_idx = k // gs) {:.4f} ms".format(
                 name, g["k"], g["n"], g["gs"], g["block_n"], g["ms"],
                 g["bound_ms"], g["bound_by"], g["bytes"] / 1e6,
                 g["table_bytes"] / 1e6, g["plain_ms"], g["eager_ms"],
                 g["ordered_layout_ms"]))
    line("timing", "K4 per layer {:.4f} ms (bound {:.4f}) / K1 {:.4f} ms = "
         "{:.2f}x (naive g_idx vs ordered groups); K4 on the ordered layout "
         "per layer {:.4f} ms, so naive/ordered within K4 = {:.2f}x".format(
             _per_layer(gidx, "ms"), _per_layer(gidx, "bound_ms"),
             _per_layer(ordered, "ms"), ratio,
             _per_layer(gidx, "ordered_layout_ms"), in_kernel))
    du, dd = deq[UP[0]], deq[DOWN[0]]
    line("timing", "K5 f32 out, CUDA-graph replay: up/gate {:.4f} ms (bound "
         "{:.4f}, plain {:.4f}); down {:.4f} ms (bound {:.4f}, plain "
         "{:.4f})".format(du["ms"], du["bound_ms"], du["plain_ms"],
                          dd["ms"], dd["bound_ms"], dd["plain_ms"]))
    sd = flash["sdpa"]
    line("timing", "K2 f32 B1 H32 S=T=2048 D128 causal: {:.4f} ms (bound "
         "{:.4f} by {}: 3 x {:.3g} GFLOP at the TF32 tensor-core rate; "
         "float32 CUDA-core bound {:.4f}; plain {:.4f}); "
         "scaled_dot_product_attention {:.4f} [library; backend {}, kernels "
         "{}] (EFFICIENT_ATTENTION alone {:.4f}, MATH alone {:.4f})".format(
             flash["ms"], flash["bound_ms"], flash["bound_by"],
             flash["flops"] / 1e9, flash["f32_cuda_core_bound_ms"],
             flash["plain_ms"], flash["library_ms"], sd["backend"],
             ", ".join(k[:48] for k in sd["default_kernels"]),
             sd["efficient_attention_ms"], sd["math_ms"]))
    sd = flash_rec["sdpa"]
    line("timing", "K2 f32 B1 H10 S=T=2048 D256 causal (recurrentgemma-2b's "
         "forward): {:.4f} ms (bound {:.4f} by {}: 3 x {:.3g} GFLOP at the "
         "TF32 tensor-core rate; plain {:.4f}); "
         "scaled_dot_product_attention {:.4f} [library; backend {}, kernels "
         "{}] (EFFICIENT_ATTENTION alone {:.4f}, MATH alone {:.4f})".format(
             flash_rec["ms"], flash_rec["bound_ms"], flash_rec["bound_by"],
             flash_rec["flops"] / 1e9, flash_rec["plain_ms"],
             flash_rec["library_ms"], sd["backend"],
             ", ".join(k[:48] for k in sd["default_kernels"]),
             sd["efficient_attention_ms"], sd["math_ms"]))
    for bits in (8, 4):
        w = wire[f"int{bits}"]
        line("timing", "K3 int{} f32 M=4 K={} N={} (tp=2 down shard), "
             "CUDA-graph replay: {:.4f} ms in {} device kernel(s) a call "
             "(bound {:.4f} by {}, plain {:.4f}; K1 + plain quantizer "
             "{:.4f} [context: the unfused epilogue], K1 alone "
             "{:.4f})".format(
                 bits, w["k"], w["n"], w["ms"], w["device_kernels_per_call"],
                 w["bound_ms"], w["bound_by"], w["plain_ms"],
                 w["unfused_ms"], wire["k1_alone_ms"]))
    for name in (UP[0], DOWN[0]):
        r = large[name]
        line("timing", "K1 f32 M=2048 {} (the forward's MLP; tensor-core "
             "loop), CUDA-graph replay: {:.3f} ms, {:.1f} TFLOP/s (bound "
             "{:.3f} by {}: 3 x {:.1f} GFLOP at the TF32 tensor-core rate; "
             "float32 CUDA-core bound {:.3f}; plain {:.3f}); torch.matmul "
             "on the K5-dequantized weight {:.3f} ms [context; kernels {}], "
             "K1 / matmul = {:.2f}".format(
                 name, r["ms"], r["tflops"], r["bound_ms"], r["bound_by"],
                 r["flops"] / 1e9, r["f32_cuda_core_bound_ms"],
                 r["plain_ms"], r["matmul_dequantized_ms"],
                 ", ".join(k[:60] for k in r["matmul_kernels"]),
                 r["over_matmul"]))
    line("timing", "K1 f32 M=2048 per layer {:.3f} ms (bound {:.3f}, "
         "matmul {:.3f}), x {} layers = {:.1f} ms per forward ({} "
         "launches)".format(large["per_layer_ms"],
                            large["per_layer_bound_ms"],
                            large["per_layer_matmul_dequantized_ms"],
                            QWEN.num_layers, large["per_forward_ms"],
                            mlp_launches(QWEN)))
    for name, *_ in FOLD:
        r = fold[name]
        line("timing", "K1 f32 M=4 {} (K {} N {} gs {}), CUDA-graph "
             "replay: {:.4f} ms (bound {:.4f} by {}, {:.2f} MB; plain "
             "{:.4f}, matmul on dequantized weight {:.4f} [context], eager "
             "call {:.4f})".format(
                 name, r["k"], r["n"], r["gs"], r["ms"], r["bound_ms"],
                 r["bound_by"], r["bytes"] / 1e6, r["plain_ms"],
                 r["matmul_dequantized_ms"], r["eager_ms"]))
    archs = _time_archs(gen)
    moe_timing = _time_moe(gen)
    # the :overlap paths' microbatches (phases 27-28): K3 at the tp=2 down
    # shard at M=2 (half of a 4-slot step) and M=1 (half of a dp2 row's
    # 2 slots), K1 at M=2
    wire_mb = {m: _time_wire(gen, m=m) for m in (OVERLAP_MB, 1)}
    km = _time_gemm(gen, "ordered", m=OVERLAP_MB,
                    shapes=(DOWN_TP,))[DOWN_TP[0]]
    for m, w in wire_mb.items():
        line("timing", "the :overlap microbatch, M={} at the tp=2 down "
             "shard, CUDA-graph replay: K3 int8 {:.4f} ms (bound {:.4f}, "
             "plain {:.4f}), int4 {:.4f} ms (bound {:.4f}, plain "
             "{:.4f})".format(m, w["int8"]["ms"], w["int8"]["bound_ms"],
                              w["int8"]["plain_ms"], w["int4"]["ms"],
                              w["int4"]["bound_ms"], w["int4"]["plain_ms"]))
    line("timing", "the :overlap microbatch, M={}: K1 at the tp=2 down "
         "shard {:.4f} ms (bound {:.4f}, plain {:.4f})".format(
             OVERLAP_MB, km["ms"], km["bound_ms"], km["plain_ms"]))
    return {"dequant_matmul_ordered": ordered, "dequant_matmul_gidx": gidx,
            "dequant_matmul_wire_ordered_mb": wire_mb,
            "dequant_matmul_ordered_mb": km,
            "dequant_matmul_ordered_fold": fold,
            "dequant_matmul_ordered_m2048": large,
            "gidx_over_ordered_per_layer": ratio,
            "gidx_naive_over_ordered_layout_per_layer": in_kernel,
            "dequantize_ordered": deq, "flash_attention": flash,
            "flash_attention_rec": flash_rec,
            "flash_attention_long": flash_long,
            "dequant_matmul_wire_ordered": wire, "archs": archs,
            "moe": moe_timing}


def _time_archs(gen) -> dict:
    """K1 and K4 at M=4 at each other arch's full-width MLP shapes, per
    shape and per layer (up, gate where gated, down) against their bytes
    bounds, and K3 at the tp=2 down shards of the archs served at tp=2."""
    out = {}
    for a in ARCHS:
        shapes, gated = ARCH_SHAPES[a], arch_config(a).mlp_gated
        res = {"ordered": _time_gemm(gen, "ordered", shapes=shapes),
               "naive": _time_gemm(gen, "naive", shapes=shapes)}
        for layout, kernel in (("ordered", "K1"), ("naive", "K4")):
            r = res[layout]
            res[layout]["layer"] = _layer(r, shapes, gated)
            line("timing", f"{kernel} f32 M=4 {a}, CUDA-graph replay: "
                 + "; ".join(
                     "{} (K {} N {} gs {}) {:.4f} ms (bound {:.4f} by {}: "
                     "{:.2f} MB; plain {:.4f})".format(
                         name.split(" ", 1)[1], k, n, gs, r[name]["ms"],
                         r[name]["bound_ms"], r[name]["bound_by"],
                         r[name]["bytes"] / 1e6, r[name]["plain_ms"])
                     for name, k, n, gs in shapes)
                 + "; per layer {:.4f} ms (bound {:.4f})".format(
                     r["layer"]["ms"], r["layer"]["bound_ms"]))
        res["gidx_over_ordered_per_layer"] = (res["naive"]["layer"]["ms"]
                                              / res["ordered"]["layer"]["ms"])
        if a in ARCH_TP_DOWN:
            res["wire"] = w = _time_wire(gen, shape=ARCH_TP_DOWN[a])
            _, k, n, gs = ARCH_TP_DOWN[a]
            line("timing", f"K3 f32 M=4 {a} tp=2 down shard (K {k} N {n} gs "
                 f"{gs}), CUDA-graph replay: " + "; ".join(
                     "int{} {:.4f} ms in {} device kernel(s) a call (bound "
                     "{:.4f} by {}, plain {:.4f})".format(
                         bits, w[f"int{bits}"]["ms"],
                         w[f"int{bits}"]["device_kernels_per_call"],
                         w[f"int{bits}"]["bound_ms"],
                         w[f"int{bits}"]["bound_by"],
                         w[f"int{bits}"]["plain_ms"]) for bits in (8, 4))
                 + f"; K1 alone {w['k1_alone_ms']:.4f}")
        out[a] = res
        torch.cuda.empty_cache()
    return out


def _time_moe(gen) -> dict:
    """K1 and K4 at M=4 (an expert's decode capacity) at each MoE arch's
    full-width expert shapes, K1 at M=8 (a data rank's share under
    expert parallelism at dp=2) and at one tp=2 rank's slice, per shape
    and per expert (up, gate, down) against their bytes bounds."""
    out = {}
    for a in MOE_ARCHS:
        shapes = MOE_SHAPES[a]
        tp2 = expert_shapes(get_config(a), TP)
        res = {"ordered": _time_gemm(gen, "ordered", shapes=shapes),
               "naive": _time_gemm(gen, "naive", shapes=shapes),
               "ordered_m8": _time_gemm(gen, "ordered", m=8, shapes=shapes),
               "ordered_tp2": _time_gemm(gen, "ordered", shapes=tp2)}
        for key, kernel in (("ordered", "K1"), ("naive", "K4"),
                            ("ordered_m8", "K1"), ("ordered_tp2", "K1")):
            shapes = tp2 if key == "ordered_tp2" else MOE_SHAPES[a]
            r = res[key]
            r["expert"] = _layer(r, shapes)
            line("timing", f"{kernel} f32 M={r[shapes[0][0]]['m']} {a} "
                 "experts, CUDA-graph replay: " + "; ".join(
                     "{} (K {} N {} gs {}) {:.4f} ms (bound {:.4f} by {}: "
                     "{:.2f} MB; plain {:.4f})".format(
                         name.split(" ", 2)[2], k, n, gs, r[name]["ms"],
                         r[name]["bound_ms"], r[name]["bound_by"],
                         r[name]["bytes"] / 1e6, r[name]["plain_ms"])
                     for name, k, n, gs in shapes)
                 + "; per expert {:.4f} ms (bound {:.4f}), x {} experts = "
                 "{:.3f} ms a layer (bound {:.3f})".format(
                     r["expert"]["ms"], r["expert"]["bound_ms"],
                     get_config(a).num_experts,
                     r["expert"]["ms"] * get_config(a).num_experts,
                     r["expert"]["bound_ms"] * get_config(a).num_experts))
        out[a] = res
        torch.cuda.empty_cache()
    return out


def _submit_requests(sched, cfg):
    rng = np.random.default_rng(0)
    for i in range(4):
        plen = int(rng.integers(4, 32))
        sched.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=16))


def _run_steps(sched) -> tuple[dict, float, list]:
    """Drain the scheduler as ``Scheduler.run`` does, one step at a time:
    (finished requests, seconds, each step's ms).  A step ends in its
    sampled tokens' read back to the host, so its host time is its
    time."""
    step_ms = []
    t0 = time.perf_counter()
    while sched.has_work:
        t1 = time.perf_counter()
        sched.step()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    return sched.finished, time.perf_counter() - t0, step_ms


def phase_serve(cfg, kernel: str, phase: str = "serve"):
    """Full-width serve of four requests on backend=cuda; every decode
    step must launch ``kernel`` once for each MLP weight (108 times at
    qwen3-4b) and no other counted kernel."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # engines alive from earlier
    t0 = time.perf_counter()
    engine = make_engine(cfg, 0, device="cuda", max_seq=32 + 16 + 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    params_bytes = sum(t.nbytes for t in checkpoint.flatten_keys(
        engine.params).values())
    if engine.policy.backend != "cuda":
        raise AssertionError(f"policy picked {engine.policy.backend!r}")
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    done, dt, step_ms = _run_steps(sched)
    counts = read_counts()
    steps = sched.steps
    tokens = sum(len(r.output) for r in done.values())
    if sorted(done) != [0, 1, 2, 3] or any(
            len(r.output) != 16 or not all(0 <= t < cfg.vocab_size
                                           for t in r.output)
            for r in done.values()):
        raise AssertionError(f"requests incomplete: "
                             f"{ {k: r.output for k, r in done.items()} }")
    per = mlp_launches(cfg)
    expect_counts(counts, {kernel: per * steps},
                  f"{phase} ({steps} decode steps)")
    # the scheduler keeps one cache of max_batch slots: one capture
    graph = engine.graphs.get(sched.max_batch)
    if engine.captures != 1 or graph is None:
        raise AssertionError(f"{phase}: {engine.captures} captures of the "
                             f"decode step, expected 1 (batch 4)")
    peak = torch.cuda.max_memory_allocated()
    out = {"scheme": cfg.quant.scheme, "init_s": init_s, "run_s": dt,
           "tokens": tokens, "tokens_per_s": tokens / dt,
           "decode_steps": steps, "launches": counts[kernel],
           "counts": counts, "ms_per_step": dt / steps * 1e3,
           "decode_mode": engine.decode_mode,
           "capture_s": graph.seconds, "graph_pool_bytes": graph.pool_bytes,
           "first_step_ms": step_ms[0],
           "steady_ms_per_step": statistics.median(step_ms[1:]),
           "step_ms": step_ms,
           "peak_bytes": peak, "allocated_before_bytes": before,
           "init_peak_bytes": init_peak, "params_bytes": params_bytes,
           "outputs": {k: r.output for k, r in sorted(done.items())},
           "first_ids": {k: r.output[:4] for k, r in sorted(done.items())}}
    line(phase, f"{describe(cfg)} on cuda, "
                f"{cfg.quant.scheme}: 4 requests, {tokens} tokens in "
                f"{dt:.2f}s ({tokens / dt:.1f} tok/s, "
                f"{out['ms_per_step']:.1f} ms/step; the first step "
                f"{step_ms[0]:.1f} ms with the capture, then a median "
                f"{out['steady_ms_per_step']:.2f} ms), {steps} decode steps "
                f"(decode step: {engine.decode_mode}; the capture "
                f"{graph.seconds:.3f}s after its eager step, graph pool "
                f"{graph.pool_bytes / 2**20:.1f} MiB), "
                f"{kernel} launches {counts[kernel]} = {per} x {steps} (other "
                f"kernels 0), init {init_s:.1f}s (params "
                f"{params_bytes / 2**30:.2f} GiB, peak during the init "
                f"{init_peak / 2**30:.2f} GiB), max_memory_allocated "
                f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB of it "
                f"allocated before this engine), first ids "
                f"{out['first_ids']}")
    return engine, out


def _greedy_trace(engine, tokens, plen, n):
    cache = engine.init_cache(tokens.shape[0])
    logits, cache = engine.prefill(tokens, cache, plen)
    trace, ids = [logits], [logits.argmax(-1)]
    pos = int(plen.max())
    for i in range(n - 1):
        logits, cache = engine.decode(cache, ids[-1], pos + i)
        trace.append(logits)
        ids.append(logits.argmax(-1))
    return torch.stack(ids, 1), torch.stack(trace, 1)


def _agree(ids_a, ids_b, lg_a, lg_b, text: str,
           gate: bool = True) -> tuple[str, dict]:
    """Ids agree, or differ first where the reference's (``b``) top two
    logits are closer than the largest logit gap: a near tie.  The gap
    must stay within 5e-2 of max|logit|.  Without ``gate`` both are
    reported, not required (a random model that amplifies float32
    rounding over its depth, where ``layerwise`` is the check)."""
    gap = (lg_a - lg_b).abs().max().item()
    scale = lg_b.abs().max().item()
    agree = bool(torch.equal(ids_a, ids_b))
    text += f": max logit gap {gap:.3g} (max|logit| {scale:.3g}), ids " \
            f"agree: {agree}"
    out = {"max_logit_gap": gap, "max_logit": scale, "ids_agree": agree}
    if not agree:
        first = (ids_a != ids_b).nonzero()[0].tolist()
        top2 = lg_b[tuple(first)].topk(2).values
        margin = (top2[0] - top2[1]).item()
        text += f"; first divergence at {first}, top-2 margin {margin:.3g}"
        out.update(first_divergence=first, top2_margin=margin)
        if gate and margin > gap:
            raise AssertionError(f"disagreement beyond a near tie: {text}")
    if gate and not gap <= 5e-2 * scale:
        raise AssertionError(f"logit gap too large: {text}")
    return text, out


def _greedy_compare(eng_a, eng_b, cfg, text: str,
                    gate: bool = True) -> tuple[str, dict]:
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12))).cuda()
    plen = torch.tensor([12, 9], device="cuda")
    ids_a, lg_a = _greedy_trace(eng_a, toks, plen, 8)
    ids_b, lg_b = _greedy_trace(eng_b, toks, plen, 8)
    text, out = _agree(ids_a, ids_b, lg_a, lg_b, text, gate)
    out.update(ids_a=ids_a.tolist(), ids_b=ids_b.tolist())
    return text, out


def _layer_folds(engine) -> list:
    """The engine's V->O fold of each layer (its aux), or Nones."""
    n = len(engine.params["layers"])
    plans = (engine.aux or {}).get("attn_plans") or {}
    return plans.get("layers.attn") or [None] * n


def _layer_units(engine) -> list:
    """The engine's layers in order, each as (a function of the carry
    entering it that returns its float32 output before the cast to the
    carry's dtype, whether the next layer takes that output cast): the
    dense layers through each one's fold where the engine has one;
    rwkv6's layers; recurrentgemma's recurrent layers and each
    superblock's local attention with its MLP, rec2 and the attention
    taking the previous layer's output uncast, as ``super_forward``
    does."""
    cfg, params = engine.model.cfg, engine.params
    mod, policy, group = engine.model.module, engine.policy, engine.group
    if cfg.family == "ssm":
        return [(lambda x, lp=lp: mod.layer_forward(
            cfg, lp, x, policy, group=group)[0], True)
            for lp in params["layers"]]
    if cfg.family == "hybrid":
        def rec(lp, path):
            return lambda x: mod.rec_layer_forward(cfg, lp, x, policy, path,
                                                   group=group)[0]

        def attn(ap):
            return lambda x: mod._attn_mlp(
                cfg, ap, x, cm.attention_forward(
                    cfg, ap["attn"], cm.apply_norm(cfg, ap["ln1"], x),
                    window=cfg.local_window, group=group, policy=policy),
                policy, group)

        units = []
        for sp in mod.blocks(params["super"]):
            units += [(rec(sp["rec1"], mod.REC1_PATH), False),
                      (rec(sp["rec2"], mod.REC2_PATH), False),
                      (attn(sp["attn"]), True)]
        return units + [(rec(lp, mod.EXTRA_PATH), True)
                        for lp in mod.blocks(params["extra"])]
    return [(lambda x, lp=lp, vo=vo: mod.layer_forward(
        cfg, lp, x, policy, group=group, vo=vo), True)
        for lp, vo in zip(params["layers"], _layer_folds(engine))]


@torch.inference_mode()
def layer_trace(engine, tokens) -> tuple[list, list]:
    """``engine``'s full-sequence forward over ``tokens`` one layer at a
    time (``_layer_units``): the carry entering each layer and each
    layer's float32 output."""
    cfg, params = engine.model.cfg, engine.params
    x = cm.embed_tokens(cfg, params["embed"], tokens, group=engine.group)
    dtype = x.dtype
    carries, outputs = [], []
    for fn, cast in _layer_units(engine):
        carries.append(x)
        y = fn(x)
        outputs.append(y)
        x = y.to(dtype) if cast else y
    return carries, outputs


@torch.inference_mode()
def layer_outputs(engine, carries) -> list:
    """Each layer's float32 output on ``carries[l]`` entering layer l."""
    return [fn(x.to(engine.device))
            for (fn, _), x in zip(_layer_units(engine), carries)]


def layerwise(outs: list, refs: list, what: str) -> dict:
    """Layer by layer on the same input carry, two plans (or TP degrees)
    of one model: each layer's float32 output within the GEMM kernels'
    float32 tolerance of the reference's (1e-5 of its max|.| + 1e-4).
    The two compute one function up to float32 sum order in each layer,
    and holding each layer apart keeps the model's depth from amplifying
    that order's rounding (a free-running trace through a random model
    without qk_norm does: ``_agree``'s reports)."""
    rtol, atol = TOL[torch.float32]
    worst, worst_rel = 0.0, 0.0
    for i, (a, b) in enumerate(zip(outs, refs, strict=True)):
        a, b = a.float().cpu(), b.float().cpu()
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        if not (math.isfinite(err) and err <= rtol * scale + atol):
            raise AssertionError(f"{what}: layer {i}'s float32 output off "
                                 f"by {err:.3g} (max|ref| {scale:.3g}) on "
                                 f"the same input")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
    return {"layers": len(refs), "max_abs_err": worst,
            "max_rel_err": worst_rel}


def _device_kernels(run, per: int) -> tuple[float, float, dict, dict, dict]:
    """Profile ``run()`` with ``torch.profiler``: (device ms of kernels and
    copies, how many were launched, the five largest by ms, ms by name,
    launches by name), each per one of the ``per`` repetitions ``run``
    makes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}      # kernels only: host ops also report device time
    counts = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / per)
            counts[e.key] = counts.get(e.key, 0) + e.count / per
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (sum(by_name.values()), sum(counts.values()), dict(top), by_name,
            counts)


def _is_k3(name: str) -> bool:
    """A K3 kernel: K1's main loop with the wire epilogue."""
    return "WireEpilogue" in name


def _is_k1(name: str) -> bool:
    return ("dequant_matmul_ordered_kernel" in name
            or "dequant_matmul_decode_tc_kernel" in name
            or "dequant_matmul_tc_kernel" in name) and not _is_k3(name)


def _is_k1_decode(name: str) -> bool:
    """K1's float32 decode loop (on the tensor cores)."""
    return "dequant_matmul_decode_tc_kernel" in name and not _is_k3(name)


def _is_k4(name: str) -> bool:
    return "dequant_matmul_gidx_kernel" in name


def _is_split_add(name: str) -> bool:
    return "add_splits_kernel" in name


def _is_sgemm(name: str) -> bool:
    """A float32 library GEMM on the CUDA cores (the attention projections
    and the lm_head): CUTLASS's SIMT sgemm or cuBLAS's sgemm kernels."""
    return "sgemm" in name.lower()


def _is_old_wire_epilogue(name: str) -> bool:
    """A kernel of K3's earlier three-launch form."""
    return "wire_params" in name or "wire_payload" in name


def phase_trace(engine, kernels: dict, phase: str | None = "trace",
                rank: int = 0, expect: dict | None = None,
                steps: int = 3) -> dict | None:
    """Device time of full-width decode steps (4 slots, cache half full)
    through ``engine.decode`` (on one rank, the captured step) by kernel,
    from ``torch.profiler``, against the same steps' wall time measured
    without the profiler: the device's busy share, and the ms and
    launches per step of the kernels each entry of ``kernels`` (a label
    and a test of a kernel's name) picks; beside them the steps' device
    time between CUDA events.  On one rank the eager step
    (``decode_eager``) is timed and traced too, for comparison.  Every
    rank runs the steps, so that at tp > 1 the collectives pair up; rank
    0 alone traces them and returns the breakdown (other ranks return
    None), and prints its line unless ``phase`` is None.  Where
    ``expect`` gives launches per step by label, the steps run three
    times (on every rank, so the ranks stay in step) and rank 0 keeps the
    first trace that counts them, else the last: profiler sessions have
    dropped events (more often the more events a session holds, so a
    step of many kernels is traced over fewer ``steps``).  Each label's
    ``launches_per_step`` is the count of its kernels among the nodes of
    the step captured in a CUDA graph (``_graph_nodes``) where one
    process runs the step, else the trace's; ``traced_launches_per_step``
    is the trace's.  The caller checks the counts."""
    cache = engine.init_cache(4)
    tokens = torch.arange(4, device=engine.device)
    pos = torch.full((4,), 24, device=engine.device)

    def runner(step):
        def run():
            for i in range(steps):
                step(cache, tokens, pos + i)
            torch.cuda.synchronize()
        return run

    def wall_ms(run) -> float:
        run()
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3 / steps

    run = runner(engine.decode)
    wall = wall_ms(run)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        engine.decode(cache, tokens, pos + i)
    stop.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(stop) / steps

    def counted(out):
        return out is not None and all(
            out["kernels"][label]["traced_launches_per_step"] == n
            for label, n in (expect or {}).items())

    out = None
    for _ in range(3 if expect else 1):
        if rank != 0 or counted(out):
            run()                               # beside rank 0's trace
            continue
        device_ms, events, top, by_name, counts = _device_kernels(run, steps)
        out = {"decode_mode": engine.decode_mode, "wall_ms_per_step": wall,
               "event_ms_per_step": event_ms,
               "device_ms_per_step": device_ms,
               "busy_share": device_ms / wall,
               "device_events_per_step": events,
               "top_kernels_ms_per_step": top,
               "kernels": {label: {
                   "ms_per_step": sum(v for k, v in by_name.items()
                                      if test(k)),
                   "traced_launches_per_step": sum(
                       v for k, v in counts.items() if test(k))}
                           for label, test in kernels.items()}}
    if rank != 0:
        return None
    # launches a step from the step's own CUDA graph where one process
    # runs it; the trace's count beside it (a session may drop events)
    names = None
    if engine.group is None and engine.ep_group is None:
        names = [name for kind, name in _graph_nodes(
            lambda: engine.decode_eager(cache, tokens, pos))
                 if kind == "kernel"]
        out["graph_kernels_per_step"] = len(names)
    for label, test in kernels.items():
        k = out["kernels"][label]
        k["launches_per_step"] = (k["traced_launches_per_step"]
                                  if names is None else
                                  sum(1 for name in names if test(name)))
    if engine.group is None:
        eager = runner(engine.decode_eager)
        eager_wall = wall_ms(eager)
        device_ms, events, *_ = _device_kernels(eager, steps)
        out["eager"] = {"wall_ms_per_step": eager_wall,
                        "device_ms_per_step": device_ms,
                        "busy_share": device_ms / eager_wall,
                        "device_events_per_step": events}
    if phase is not None:
        _trace_line(phase, out)
    return out


def _trace_line(phase: str, out: dict) -> None:
    eager = out.get("eager")
    line(phase, f"decode step ({out['decode_mode']}) "
                f"{out['wall_ms_per_step']:.2f} ms wall (no profiler), "
                f"{out['device_ms_per_step']:.2f} ms of kernels "
                f"-> device busy {100 * out['busy_share']:.1f}% "
                f"({out['event_ms_per_step']:.2f} ms between CUDA events); "
                + ("" if eager is None else
                   f"eager step {eager['wall_ms_per_step']:.2f} ms wall, "
                   f"{eager['device_ms_per_step']:.2f} ms of kernels -> "
                   f"busy {100 * eager['busy_share']:.1f}%; ")
                + f"{out['device_events_per_step']:.0f} device "
                f"kernels/copies traced per step"
                + ("" if "graph_kernels_per_step" not in out else
                   f" ({out['graph_kernels_per_step']} kernel nodes in "
                   f"the step's graph)")
                + "; "
                + ", ".join(f"{label} {v['ms_per_step']:.3f} ms in "
                            f"{v['launches_per_step']:.0f} launches "
                            f"({v['traced_launches_per_step']:.0f} traced)"
                            for label, v in out["kernels"].items())
                + " per step; top kernels ms/step: "
                + ", ".join(f"{k[:40]} {v:.3f}"
                            for k, v in out["top_kernels_ms_per_step"].items()))


def _captured_vs_eager(engine, cfg, steps: int, phase: str,
                       fill=None) -> tuple:
    """The captured step against ``decode_eager`` at full width, 4 slots:
    logits and the whole KV cache bit for bit after each of ``steps``
    steps on lockstep positions (the eager step's int path; the graph's
    per-slot buffer) and ``steps`` on unequal per-slot positions; the
    second pair of caches moves the graph to other addresses (a
    recapture), and so does going back to the first.  Returns the
    captures counted along the way, the per-slot offsets and the
    recapture's seconds.  ``fill(cache)``: what a fresh cache holds first
    (the audio and vision families' cross K/V); the whole cache, nested
    entries included, is compared."""
    b = 4
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (steps + 1, b))).cuda()
    offsets = torch.tensor([0, 5, 11, 17], device="cuda")
    lock = (engine.init_cache(b), engine.init_cache(b))
    slot = (engine.init_cache(b), engine.init_cache(b))
    for cache in (*lock, *slot):
        if fill is not None:
            fill(cache)

    def check(caches, t, pos, what):
        graph_cache, eager_cache = caches
        got, _ = engine.decode(graph_cache, toks[t], pos)
        want, _ = engine.decode_eager(eager_cache, toks[t], pos)
        leaves = (checkpoint.flatten_keys(c) for c in caches)
        if not (torch.equal(got, want) and all(
                torch.equal(g, e) for g, e in zip(
                    *(list(f.values()) for f in leaves), strict=True))):
            raise AssertionError(
                f"{phase}, {what}, step {t}: the captured step's logits or "
                f"cache differ from decode_eager's (max logit gap "
                f"{(got - want).abs().max().item():.3g})")

    captures = [engine.captures]
    for t in range(steps):
        check(lock, t, t, "lockstep")
    captures.append(engine.captures)
    for t in range(steps):
        check(slot, t, offsets + t, "per-slot")
    captures.append(engine.captures)
    recapture_s = engine.graphs[b].seconds
    check(lock, steps, steps, "lockstep, back on the first cache")
    captures.append(engine.captures)
    if captures[2] != captures[1] + 1 or captures[3] != captures[2] + 1:
        raise AssertionError(f"{phase}: captures {captures}; a cache at "
                             f"other addresses must recapture")
    return captures, offsets.tolist(), recapture_s


def phase_capture(engine, cfg, serve: dict) -> dict:
    """``_captured_vs_eager`` over 16 steps each, then phase 5's four
    requests through an engine on the same params whose ``decode`` is the
    eager step: the same ids, and its time beside the captured one's."""
    steps = 16
    captures, offsets, recapture_s = _captured_vs_eager(engine, cfg, steps,
                                                        "capture")

    eager = dataclasses.replace(engine)
    eager.decode = eager.decode_eager
    sched = Scheduler(eager, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    done, dt, step_ms = _run_steps(sched)
    outputs = {k: r.output for k, r in sorted(done.items())}
    if outputs != serve["outputs"] or eager.captures:
        raise AssertionError(f"capture: the eager engine's ids {outputs} "
                             f"differ from the captured step's "
                             f"{serve['outputs']}")
    tokens = sum(len(o) for o in outputs.values())
    out = {"steps_each": steps, "offsets": offsets,
           "captures": captures, "recapture_s": recapture_s,
           "bit_equal": True, "serve_ids_equal": True,
           "eager_serve": {"run_s": dt, "decode_steps": sched.steps,
                           "ms_per_step": dt / sched.steps * 1e3,
                           "steady_ms_per_step": statistics.median(
                               step_ms[1:]),
                           "tokens_per_s": tokens / dt}}
    line("capture", f"B=4: {steps} lockstep steps and {steps} on per-slot "
                    f"positions (offsets {out['offsets']}) through the "
                    f"captured step bit-equal to decode_eager (logits and "
                    f"the whole KV cache after each step); a second cache "
                    f"of batch 4 recaptured and so did the first again "
                    f"(captures {captures}; recapture {recapture_s:.3f}s); "
                    f"the 4 requests' ids through the eager step equal the "
                    f"captured step's; eager serve "
                    f"{out['eager_serve']['ms_per_step']:.1f} ms/step "
                    f"(median {out['eager_serve']['steady_ms_per_step']:.2f} "
                    f"after the first; "
                    f"{out['eager_serve']['tokens_per_s']:.1f} tok/s) "
                    f"against captured {serve['ms_per_step']:.1f} ms/step "
                    f"(median {serve['steady_ms_per_step']:.2f}; "
                    f"{serve['tokens_per_s']:.1f} tok/s)")
    return out


def phase_crosscheck(engine, cfg) -> dict:
    other = Engine(model=engine.model, params=engine.params,
                   device=engine.device, max_seq=engine.max_seq,
                   policy=engine.policy.with_(backend="torch"))
    text, out = _greedy_compare(engine, other, cfg, "greedy 2 prompts x 8 "
                                "tokens, cuda vs torch backend")
    line("crosscheck", text)
    return out


def phase_scheme_crosscheck(tp_engine, naive_engine, cfg,
                            phase: str = "scheme-crosscheck") -> dict:
    """Both plans quantize the same weights from seed 0 into the same
    codes; naive-actorder keeps the original rows and tp-aware sorts them
    and folds P2, so the two compute one function up to float32 sum
    order."""
    text, out = _greedy_compare(
        naive_engine, tp_engine, cfg, "greedy 2 prompts x 8 tokens, "
        "naive-actorder (K4) vs tp-aware (K1)")
    line(phase, text)
    return out


def phase_forward_flash(engine, cfg) -> dict:
    """``prefill_logits`` of one 2048-token sequence with the flash kernel
    and with the einsum attention, on the same params."""
    s = 2048
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, s))).cuda()
    flash = dataclasses.replace(engine, attn_backend="flash")
    res = {}
    for name, eng in (("flash", flash), ("xla", engine)):
        eng.prefill_logits(toks)                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        logits = eng.prefill_logits(toks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        # every K1 launch of the forward (M = 2048) takes its tensor-core
        # loop
        expect_counts(counts, {
            "dequant_matmul_ordered": mlp_launches(cfg),
            TC: mlp_launches(cfg),
            "flash_attention": cfg.num_layers if name == "flash" else 0},
            f"forward {name}")
        res[name] = {"wall_ms": wall, "counts": counts, "logits": logits}
        device_ms, events, top, by_name, _ = _device_kernels(
            lambda eng=eng: (eng.prefill_logits(toks),
                             torch.cuda.synchronize()), 1)
        # K1's loops and the decode loop's split-add pass, by kernel name
        k1_ms = sum(v for key, v in by_name.items() if _is_k1(key))
        split_add_ms = sum(v for key, v in by_name.items()
                           if _is_split_add(key))
        res[name].update(device_ms=device_ms, device_events=events,
                         top_kernels_ms=top, k1_ms=k1_ms,
                         split_add_ms=split_add_ms)
        if split_add_ms != 0:
            raise AssertionError(f"forward {name}: K1's split-add ran "
                                 f"({split_add_ms:.3f} ms); the tensor-core "
                                 f"loop splits no K")
    lf, lx = res["flash"].pop("logits"), res["xla"].pop("logits")
    if lf.shape != (1, s, cfg.vocab_size) or not torch.isfinite(lf).all():
        raise AssertionError(f"flash forward logits {tuple(lf.shape)} not "
                             f"finite of the expected shape")
    gap = (lf - lx).abs().max().item()
    scale = lx.abs().max().item()
    if not gap <= 5e-2 * scale:
        raise AssertionError(f"flash vs xla forward: logit gap {gap:.3g} "
                             f"above 5e-2 of max|logit| {scale:.3g}")
    pos_agree = (lf.argmax(-1) == lx.argmax(-1)).float().mean().item()
    last_f, last_x = lf[:, -1:], lx[:, -1:]
    text, out = _agree(last_f.argmax(-1), last_x.argmax(-1), last_f, last_x,
                       "last-position greedy id, flash vs xla")
    text += f"; all positions: max logit gap {gap:.3g} (max|logit| " \
            f"{scale:.3g})"
    out.update(res, all_positions_max_logit_gap=gap,
               all_positions_max_logit=scale,
               positions_argmax_agree=pos_agree,
               flash_launches=res["flash"]["counts"]["flash_attention"])
    line("forward-flash", f"{describe(cfg)} B1 S{s}: flash "
                          f"{res['flash']['wall_ms']:.1f} ms, xla "
                          f"{res['xla']['wall_ms']:.1f} ms wall; "
                          f"flash_attention launches "
                          f"{out['flash_launches']} = {cfg.num_layers}; "
                          f"{text}; argmax "
                          f"agrees at {100 * pos_agree:.2f}% of positions")
    for name in ("flash", "xla"):
        r = res[name]
        line("forward-flash", f"{name} forward under torch.profiler: "
                              f"{r['device_ms']:.1f} ms of kernels, "
                              f"{r['device_events']:.0f} kernels/copies; "
                              f"K1 {r['k1_ms']:.1f} ms ({r['counts'][TC]} of "
                              f"its launches on the tensor-core loop), "
                              f"split-add {r['split_add_ms']:.1f} ms; "
                              f"top ms: " + ", ".join(
                                  f"{k[:40]} {v:.1f}"
                                  for k, v in r["top_kernels_ms"].items()))
    return out


def phase_dequantize(engine) -> dict:
    """Materialize every MLP weight through ``ops.dequantize``; each is
    bit-equal to the plain dequantize."""
    reset_counts()
    t0 = time.perf_counter()
    n = 0
    for layer in engine.params["layers"]:
        mlp = layer["mlp"]
        for ql in (mlp.up, mlp.gate, mlp.down):
            if ql is None:
                continue
            w = ops.dequantize(ql)
            if not torch.equal(w, qz.dequantize(ql)):
                raise AssertionError(f"ops.dequantize differs from the "
                                     f"plain dequantize at weight {n}")
            n += 1
            del w
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    per = mlp_launches(engine.model.cfg)
    expect_counts(counts, {"dequantize_ordered": per}, "dequantize")
    line("dequantize", f"{n} full-width MLP weights materialized through "
                       f"ops.dequantize in {dt:.2f}s (with the plain "
                       f"comparison), dequantize_ordered launches "
                       f"{counts['dequantize_ordered']} = {per}, all "
                       f"bit-equal")
    return {"weights": n, "seconds": dt,
            "launches": counts["dequantize_ordered"]}


def _pool_rank(process: int, tp: int, init_file: str, jobs, done,
               out_dir: str) -> None:
    """One process of ``RankPool``: join the group as ``mesh.run``'s ranks
    do, report ready, then run each job ``(fn, args)`` from ``jobs`` as
    ``fn(ctx, *args)`` (its result saved under ``out_dir``, its
    traceback reported on failure) until a None."""
    ctx = mesh.init_rank(process, tp, init_file, "cuda")
    try:
        done.put((process, None))
        for fn, args in iter(jobs.get, None):
            try:
                torch.save(fn(ctx, *args),
                           os.path.join(out_dir, f"rank{process}.pt"))
                err = None
            except BaseException:
                err = traceback.format_exc()
            gc.collect()
            torch.cuda.empty_cache()
            done.put((process, err))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``TP`` rank processes on the card, started once and kept until
    ``close``, that run the TP phases' rank functions in turn: each
    joins the group as ``mesh.run``'s ranks do (``mesh.init_rank``: on
    one card gloo via host), so a phase pays no rank start-up (a
    ``mesh.run`` of two ranks cost its phase 15-60 s on the H100's
    host).  ``run`` keeps ``mesh.run``'s contract: ``fn(ctx, *args)`` on
    every rank, the results in rank order; a rank that raises, dies, or
    outlasts ``timeout`` makes it raise, and stops the ranks.  Every
    rank function resets the launch counts (and the peak memory) before
    what it measures, as it would in a fresh process.  Phases 27-28's
    rank function, whose check reads profiler windows, runs in fresh
    processes (``mesh.run``): in a pool rank one of its traces lost a
    GEMM event and showed a GEMM inside a synchronous all-to-all."""

    def __init__(self, tp: int = TP):
        self.tp = tp
        self.procs: list = []

    def start(self, timeout: float = 300.0) -> float:
        """Start the ranks and wait until each has joined the group: the
        seconds that took."""
        t0 = time.perf_counter()
        spawn = multiprocessing.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="tp-pool-")
        self.jobs = [spawn.Queue() for _ in range(self.tp)]
        self.done = spawn.Queue()
        self.procs = [spawn.Process(
            target=_pool_rank, args=(r, self.tp,
                                     os.path.join(self.dir, "group"),
                                     self.jobs[r], self.done, self.dir))
            for r in range(self.tp)]
        for p in self.procs:
            p.start()
        self._wait(timeout, "joining the group")
        return time.perf_counter() - t0

    def _wait(self, timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        left = set(range(self.tp))
        try:
            while left:
                try:
                    rank, err = self.done.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in self.procs
                            if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"a pool rank exited (codes "
                                           f"{dead}) while {what}")
                    if time.monotonic() >= deadline:
                        raise TimeoutError(f"{self.tp} pool ranks did not "
                                           f"finish {what} within "
                                           f"{timeout:.0f} s")
                    continue
                if err:
                    raise RuntimeError(f"pool rank {rank}, {what}:\n{err}")
                left.discard(rank)
        except BaseException:
            self.close()
            raise

    def run(self, fn, *args, timeout: float = 600.0) -> list:
        if not self.procs:
            self.start()
        for q in self.jobs:
            q.put((fn, args))
        self._wait(timeout, fn.__name__)
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.tp)]

    def close(self) -> None:
        """Stop the ranks (a rank stuck in a collective is killed)."""
        for q, p in zip(self.jobs if self.procs else [], self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        if self.procs:
            shutil.rmtree(self.dir, ignore_errors=True)
        self.procs = []


#: the TP phases' two rank processes (``RankPool``), from phase 14 to
#: phase 43
POOL = RankPool()


def _serve_tp_rank(ctx, cfg, greedy_tokens, greedy_plen, specs,
                   carries=None, paged: bool = False) -> dict:
    """One rank of phases 14 and 15 (and 19): build this rank's slices of
    the full-width plan, serve the four requests under ``TP_SERVE`` with
    the launch counts set to 0 just before and read just after (with
    ``paged``, again from a ``PAGED`` pool of this rank's KV heads: phase
    22 at tp=2), trace a few decode steps (rank 0), then the greedy
    traces under each of ``specs`` on the same params, and, given the
    tp=1 engine's ``carries``, each layer's output under psum on
    them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg.with_quant(collective=TP_SERVE), 0,
                         device=ctx.device, max_seq=32 + 16 + 1,
                         group=ctx.group)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    out = {"rank": ctx.rank, "transport": ctx.transport,
           "decode_mode": engine.decode_mode,
           "backend": engine.policy.backend,
           "collective": engine.policy.collective.shorthand(),
           "init_s": init_s, "run_s": run_s, "decode_steps": sched.steps,
           "tokens": sum(len(r.output) for r in done.values()),
           "outputs": {k: r.output for k, r in sorted(done.items())},
           "counts": counts,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if paged:
        eng = dataclasses.replace(engine,
                                  policy=engine.policy.with_(kv=PAGED))
        sched = Scheduler(eng, max_batch=4, prompt_budget=32,
                          scfg=SamplingConfig(temperature=0.8, top_k=40),
                          seed=0)
        _submit_requests(sched, cfg)
        reset_counts()
        t0 = time.perf_counter()
        done = sched.run()
        torch.cuda.synchronize()
        out["paged"] = {"run_s": time.perf_counter() - t0,
                        "decode_steps": sched.steps,
                        "counts": read_counts(),
                        "decode_mode": eng.decode_mode,
                        "outputs": {k: r.output
                                    for k, r in sorted(done.items())},
                        "cache": sched.cache_stats()}
    out["trace"] = phase_trace(engine, {
        "K3": _is_k3, "K1": _is_k1, "split-add": _is_split_add,
        "earlier wire epilogue": _is_old_wire_epilogue}, None, ctx.rank,
        expect={"K3": cfg.num_layers, "earlier wire epilogue": 0})
    toks = torch.from_numpy(greedy_tokens).to(ctx.device)
    plen = torch.from_numpy(greedy_plen).to(ctx.device)
    traces = {}
    for spec in specs:
        eng = dataclasses.replace(
            engine, policy=engine.policy.with_(collective=spec))
        ids, logits = _greedy_trace(eng, toks, plen, 8)
        traces[spec] = (ids.cpu(), logits.cpu())
        if spec == "psum" and carries is not None:
            out["layer_outputs"] = [o.cpu()
                                    for o in layer_outputs(eng, carries)]
    out["traces"] = traces
    return out


def _greedy_inputs(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The prompts of the TP and artifact cross-checks: 2 x 12 tokens,
    lengths 12 and 9."""
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (2, 12)), np.array([12, 9])


def greedy_reference(engine, cfg) -> tuple:
    """``engine``'s greedy trace over ``_greedy_inputs``, on the host: the
    tp=1 reference of a psum cross-check."""
    toks, plen = _greedy_inputs(cfg)
    ids, logits = _greedy_trace(engine, torch.from_numpy(toks).cuda(),
                                torch.from_numpy(plen).cuda(), 8)
    return ids.cpu(), logits.cpu()


def phase_serve_tp(cfg, tp1_trace, pairs=TP_PAIRS, phase: str = "serve-tp",
                   cross_phase: str = "tp-crosscheck", tp1_layers=None,
                   paged: bool = False) -> tuple[dict, dict, list]:
    """Phases 14 and 15 (and 19) on ``TP`` rank processes; the tp=1
    reference of the psum cross-check is ``tp1_trace``, the greedy trace
    of a tp=1 engine of the same seed (so the same plan before sharding).
    Given ``tp1_layers`` (that engine's ``layer_trace``), psum is held
    to it layer by layer and the greedy trace is reported.  Also returns
    each rank's greedy trace under ``TP_SERVE``, the reference of phase
    17 (and 20).  With ``paged``, each rank serves the four requests from
    a ``PAGED`` pool too: the dense serve's ids, the same launches a step
    (phase 22 at tp=2)."""
    greedy_tokens, greedy_plen = _greedy_inputs(cfg)
    specs = [c for pair in pairs for c in pair] + ["psum"]
    torch.cuda.empty_cache()
    ranks = POOL.run(_serve_tp_rank, cfg, greedy_tokens, greedy_plen,
                     specs, tp1_layers and tp1_layers[0], paged,
                     timeout=600)
    steps = ranks[0]["decode_steps"]
    k3_per, k1_per = cfg.num_layers, mlp_launches(cfg) - cfg.num_layers
    for r in ranks:
        expect_counts(r["counts"], {
            "dequant_matmul_wire_ordered": k3_per * steps,
            "dequant_matmul_ordered": k1_per * steps},
            f"{phase} rank {r['rank']} ({steps} decode steps)")
        if r["outputs"] != ranks[0]["outputs"] or r["decode_steps"] != steps:
            raise AssertionError("the ranks emitted different tokens")
        if r["backend"] != "cuda" or r["collective"] != "quant-int8:128:fused":
            raise AssertionError(f"rank {r['rank']} ran {r['backend']} / "
                                 f"{r['collective']}")
    if sorted(ranks[0]["outputs"]) != [0, 1, 2, 3] or any(
            len(o) != 16 or not all(0 <= t < cfg.vocab_size for t in o)
            for o in ranks[0]["outputs"].values()):
        raise AssertionError(f"requests incomplete: {ranks[0]['outputs']}")
    r0 = ranks[0]
    serve = {"outputs": r0["outputs"],
             "transport": r0["transport"], "collective": r0["collective"],
             "decode_mode": r0["decode_mode"],
             "tokens": r0["tokens"], "decode_steps": steps,
             "tokens_per_s": [r["tokens"] / r["run_s"] for r in ranks],
             "ms_per_step": [r["run_s"] / steps * 1e3 for r in ranks],
             "init_s": [r["init_s"] for r in ranks],
             "launches": r0["counts"]["dequant_matmul_wire_ordered"],
             "counts": [r["counts"] for r in ranks],
             "peak_bytes": [r["peak_bytes"] for r in ranks],
             "first_ids": {k: o[:4] for k, o in r0["outputs"].items()}}
    line(phase, "{} at tp={} over {} with {}: 4 requests, {} tokens, "
         "{:.1f} tok/s, {:.1f} ms/step (rank 0; rank 1 {:.1f} ms/step), {} "
         "decode steps (decode step: {}; no CUDA graph holds the gloo "
         "collectives); per rank dequant_matmul_wire_ordered {} = {} x {} "
         "and dequant_matmul_ordered {} = {} x {} (other kernels 0); "
         "max_memory_allocated per rank {} GiB; first ids {}".format(
             describe(cfg), TP, r0["transport"], r0["collective"],
             r0["tokens"], serve["tokens_per_s"][0],
             serve["ms_per_step"][0], serve["ms_per_step"][1], steps,
             serve["decode_mode"], serve["launches"], k3_per, steps,
             r0["counts"]["dequant_matmul_ordered"], k1_per, steps,
             "/".join(f"{b / 2**30:.2f}" for b in serve["peak_bytes"]),
             serve["first_ids"]))
    if paged:
        for r in ranks:
            p = r["paged"]
            psteps = p["decode_steps"]
            expect_counts(p["counts"], {
                "dequant_matmul_wire_ordered": k3_per * psteps,
                "dequant_matmul_ordered": k1_per * psteps},
                f"{phase} {PAGED} rank {r['rank']} ({psteps} decode steps)")
            if p["outputs"] != r["outputs"] or p["cache"]["pages"]["live"]:
                raise AssertionError(
                    f"{phase} rank {r['rank']}: {PAGED} ids {p['outputs']} "
                    f"differ from the dense ids {r['outputs']}, or pages "
                    f"live {p['cache']['pages']}")
        serve["paged"] = [r["paged"] for r in ranks]
        p0 = ranks[0]["paged"]
        line("serve-paged", f"{describe(cfg)} at tp={TP} over "
             f"{r0['transport']} with {r0['collective']} from a {PAGED} "
             f"pool of each rank's KV heads: the 4 requests' ids equal the "
             f"dense serve's on both ranks; per rank "
             f"dequant_matmul_wire_ordered "
             f"{p0['counts']['dequant_matmul_wire_ordered']} and "
             f"dequant_matmul_ordered "
             f"{p0['counts']['dequant_matmul_ordered']} in "
             f"{p0['decode_steps']} steps; "
             f"{p0['run_s'] / p0['decode_steps'] * 1e3:.1f} ms/step (rank "
             f"0; decode step: {p0['decode_mode']})")
    tr = r0["trace"]
    serve["trace_rank0"] = tr
    _trace_line(f"{phase} rank 0", tr)
    k3 = tr["kernels"]["K3"]["launches_per_step"]
    old = tr["kernels"]["earlier wire epilogue"]["launches_per_step"]
    if k3 != k3_per or old:
        raise AssertionError(f"tp=2 decode step: {k3} K3 kernels and {old} "
                             f"of the earlier epilogue per step, expected "
                             f"{k3_per} and 0")

    cross = {}
    for fused, plain in pairs:
        for r in ranks:
            (ia, la), (ib, lb) = r["traces"][fused], r["traces"][plain]
            if not (torch.equal(la, lb) and torch.equal(ia, ib)):
                raise AssertionError(
                    f"{fused} vs {plain} on rank {r['rank']}: logits not "
                    f"bit-identical (max gap {(la - lb).abs().max():.3g}) "
                    f"or ids differ")
            if not torch.equal(r["traces"][fused][0],
                               ranks[0]["traces"][fused][0]):
                raise AssertionError(f"{fused}: the ranks' ids differ")
        cross[f"{fused} vs {plain}"] = {
            "bit_identical_logits": True, "ids_equal": True,
            "ids": ranks[0]["traces"][fused][0].tolist()}
    ids1, lg1 = (t.cuda() for t in tp1_trace)
    ids2, lg2 = (t.cuda() for t in ranks[0]["traces"]["psum"])
    text, out = _agree(ids2, ids1, lg2, lg1, "psum at tp=2 vs tp=1",
                       gate=tp1_layers is None)
    out.update(ids_tp2=ids2.tolist(), ids_tp1=ids1.tolist())
    if tp1_layers is not None:
        out["layerwise"] = [layerwise(r["layer_outputs"], tp1_layers[1],
                                      f"psum tp=2 rank {r['rank']} vs tp=1")
                            for r in ranks]
        lw = out["layerwise"]
        text = (f"psum at tp=2 vs tp=1 layer by layer on the tp=1 engine's "
                f"input carries: the {lw[0]['layers']} layers' float32 "
                f"outputs within 1e-5 of max|.| + 1e-4 on both ranks, worst "
                + "/".join(f"{r['max_abs_err']:.3g}" for r in lw)
                + f"; through the whole model (reported): {text}")
    cross["psum tp2 vs tp1"] = out
    line(cross_phase, f"{cfg.arch_id}: greedy 2 prompts x 8 tokens on both "
         "ranks: " + " and ".join(f"{a} vs {b}" for a, b in pairs)
         + " logits bit-identical and ids equal on every rank; " + text)
    return serve, cross, [r["traces"][TP_SERVE] for r in ranks]


def _artifact_dir(trees) -> tuple[str, int]:
    """A fresh temporary directory for the artifact of ``trees`` and the
    bytes its leaves hold, reckoned before any is written; raises when
    the disk has not that much room (and 1 GiB more) free."""
    nbytes = sum(t.nbytes for tree in trees
                 for t in checkpoint.flatten_keys(tree).values())
    path = tempfile.mkdtemp(prefix="artifact-")
    free = shutil.disk_usage(path).free
    if free < nbytes + 2**30:
        shutil.rmtree(path)
        raise AssertionError(f"artifact: {free / 2**30:.1f} GiB free under "
                             f"{path}, the artifact needs "
                             f"{nbytes / 2**30:.1f} GiB")
    return path, nbytes


def _prepare_and_save(cfg, tp: int, phase: str):
    """Prepare ``cfg``'s plan for ``tp`` ranks from seed 0 on the card and
    save it: (directory, reckoned bytes, {file: bytes}, seconds to
    prepare, seconds to save, the card's peak allocated bytes during the
    prepare, earlier phases' engines included).  The caller removes the
    directory."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=tp, seed=0, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if art.manifest["policy"]["backend"] != "pallas":
        raise AssertionError(f"{phase}: prepared for backend "
                             f"{art.manifest['policy']['backend']!r}")
    path, nbytes = _artifact_dir(art.rank_params)
    try:
        t0 = time.perf_counter()
        art.save(path)
        save_s = time.perf_counter() - t0
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    del art
    torch.cuda.empty_cache()
    files = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    return path, nbytes, files, prepare_s, save_s, peak


def memory_reference(engine, cfg, serve: dict) -> dict:
    """What an artifact served at tp=1 is held to: the in-memory engine's
    policy, cache length, serve ids and greedy trace."""
    return {"policy": engine.policy, "max_seq": engine.max_seq,
            "outputs": serve["outputs"],
            "trace": greedy_reference(engine, cfg)}


def phase_artifact(cfg, ref: dict, phase: str = "artifact") -> dict:
    """Phase 16 (and 20): prepare once, save, serve from the files at tp=1;
    ``ref`` is the in-memory engine's (``memory_reference``)."""
    path, nbytes, files, prepare_s, save_s, peak = _prepare_and_save(
        cfg, 1, phase)
    try:
        t0 = time.perf_counter()
        served = make_engine(cfg, device="cuda", max_seq=ref["max_seq"],
                             artifact=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path)
    if served.policy != ref["policy"]:
        raise AssertionError(f"{phase}: the engine serves {served.policy}, "
                             f"the in-memory one {ref['policy']}")
    sched = Scheduler(served, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    done, dt, step_ms = _run_steps(sched)
    counts = read_counts()
    steps = sched.steps
    per = mlp_launches(cfg)
    expect_counts(counts, {"dequant_matmul_ordered": per * steps},
                  f"{phase} ({steps} decode steps)")
    outputs = {k: r.output for k, r in sorted(done.items())}
    if outputs != ref["outputs"]:
        raise AssertionError(f"{phase}: ids {outputs} differ from the "
                             f"in-memory serve's {ref['outputs']}")
    if served.captures != 1:
        raise AssertionError(f"{phase}: {served.captures} captures of the "
                             f"decode step, expected 1 (batch 4)")
    decode_mode = served.decode_mode
    ids_a, lg_a = greedy_reference(served, cfg)
    ids_m, lg_m = ref["trace"]
    if not (torch.equal(ids_a, ids_m) and torch.equal(lg_a, lg_m)):
        raise AssertionError(f"{phase}: greedy logits not bit-equal to the "
                             f"in-memory engine's (max gap "
                             f"{(lg_a - lg_m).abs().max().item():.3g})")
    out = {"reckoned_bytes": nbytes, "file_bytes": files,
           "disk_bytes": sum(files.values()), "prepare_s": prepare_s,
           "prepare_peak_bytes": peak,
           "save_s": save_s, "load_s": load_s, "run_s": dt,
           "decode_steps": steps, "counts": counts,
           "decode_mode": decode_mode, "first_step_ms": step_ms[0],
           "steady_ms_per_step": statistics.median(step_ms[1:]),
           "ids_equal": True, "greedy_logits_bit_equal": True}
    line(phase, f"{describe(cfg)} tp-aware tp=1 prepared on the card in "
                     f"{prepare_s:.2f}s (max_memory_allocated "
                     f"{peak / 2**30:.2f} GiB), saved in {save_s:.2f}s "
                     f"({out['disk_bytes'] / 1e9:.3f} GB on disk, "
                     f"{nbytes / 1e9:.3f} GB of leaves), loaded by "
                     f"make_engine(artifact=DIR) in {load_s:.2f}s; 4 "
                     f"requests: ids equal to the in-memory serve's, "
                     f"dequant_matmul_ordered {counts['dequant_matmul_ordered']}"
                     f" = {per} x {steps} (decode step: {decode_mode}; "
                     f"first step {step_ms[0]:.1f} ms, then a median "
                     f"{out['steady_ms_per_step']:.2f} ms); "
                     f"greedy 2 prompts x 8 tokens: ids and logits "
                     f"bit-equal to the in-memory engine")
    del served, sched
    torch.cuda.empty_cache()
    return out


def _artifact_tp_rank(ctx, cfg, path, greedy_tokens, greedy_plen,
                      reference: bool = False) -> dict:
    """One rank of phase 17 (and 20): read this rank's file, serve the
    four requests with the counts set to 0 just before and read just
    after, then the greedy trace of phase 14's cross-check.  With
    ``reference``, first the same from this rank's in-memory plan built
    from seed 0 (what phase 20's depth is held to)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    toks = torch.from_numpy(greedy_tokens).to(ctx.device)
    plen = torch.from_numpy(greedy_plen).to(ctx.device)
    ref = None
    if reference:
        mem = make_engine(cfg, 0, device=ctx.device, max_seq=32 + 16 + 1,
                          group=ctx.group)
        sched = Scheduler(mem, max_batch=4, prompt_budget=32,
                          scfg=SamplingConfig(temperature=0.8, top_k=40),
                          seed=0)
        _submit_requests(sched, cfg)
        done = sched.run()
        ids, logits = _greedy_trace(mem, toks, plen, 8)
        ref = {"outputs": {k: r.output for k, r in sorted(done.items())},
               "trace": (ids.cpu(), logits.cpu())}
        del mem, sched
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=ctx.device, max_seq=32 + 16 + 1,
                         group=ctx.group, artifact=path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    ids, logits = _greedy_trace(engine, toks, plen, 8)
    return {"rank": ctx.rank, "load_s": load_s, "run_s": run_s,
            "reference": ref,
            "stats": dataclasses.asdict(engine.load_stats),
            "resident_fraction": engine.load_stats.resident_fraction,
            "decode_steps": sched.steps, "counts": counts,
            "collective": engine.policy.collective.shorthand(),
            "outputs": {k: r.output for k, r in sorted(done.items())},
            "trace": (ids.cpu(), logits.cpu())}


def _src_env() -> dict:
    """This process's environment with the repository's ``src`` on the
    path, for the CLIs it starts."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in (os.environ.get("PYTHONPATH"),) if p]))


def _verify_start(path: str) -> tuple:
    """Start ``python -m repro_torch.launch.serve verify --artifact path``
    as a user runs it (its contracts' tp ranks on the card), in the
    background: the phase's own work goes on beside it until
    ``_verify_finish``."""
    fd, report = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "verify",
         "--artifact", path, "--json", report], cwd=ROOT, env=_src_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, report, time.perf_counter()


def _verify_finish(started: tuple, phase: str, what: str,
                   want_exit: int = 0, want: dict | None = None) -> dict:
    """Wait for a ``_verify_start``: its exit code must be ``want_exit``
    and its findings, counted by rule and severity, exactly ``want``
    (none by default); its seconds from start to exit (the phase's own
    work ran beside it)."""
    proc, report, t0 = started
    try:
        text, _ = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        with open(report) as f:
            found = json.loads(f.read() or "null")
    finally:
        _verify_stop(started)
    if found is None:
        raise AssertionError(f"{phase}: serve verify {what} wrote no "
                             f"report (exit {proc.returncode})\n"
                             f"{text[-4000:]}")
    by_rule: dict = {}
    for x in found["findings"]:
        key = f"{x['rule']}/{x['severity']}"
        by_rule[key] = by_rule.get(key, 0) + 1
    out = {"exit": proc.returncode, "findings": len(found["findings"]),
           "errors": found["counts"]["error"], "by_rule": by_rule,
           "seconds": seconds,
           "summary": [t for t in text.splitlines() if "verify " in t]}
    line(phase, f"serve verify {what}: exit {proc.returncode}, "
                f"{out['findings']} finding(s)"
                f"{f' {by_rule}' if by_rule else ''}, {out['errors']} "
                f"error(s), {seconds:.1f}s (beside the phase's ranks)")
    if proc.returncode != want_exit or by_rule != (want or {}):
        raise AssertionError(f"{phase}: serve verify {what}: exit "
                             f"{proc.returncode}, findings {by_rule}; "
                             f"expected exit {want_exit} and {want or {}}"
                             f"\n{text[-4000:]}")
    return out


def _verify_stop(*started) -> None:
    """Stop every ``_verify_start`` still running (a phase that failed
    before it waited for them) and remove its report."""
    for proc, report, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if os.path.exists(report):
            os.unlink(report)


def _planted_copy(path: str) -> str:
    """A copy of the tp=2 artifact at ``path`` (rank files hard-linked,
    the manifest copied) with rank_01.npz renamed rank_05.npz and an
    unreachable glob first in its plan.  The caller removes it."""
    planted = tempfile.mkdtemp(prefix="artifact-planted-")
    for name in os.listdir(path):
        src, dst = os.path.join(path, name), os.path.join(planted, name)
        if name.endswith(".npz"):
            os.link(src, dst)
        else:
            shutil.copy2(src, dst)
    os.rename(os.path.join(planted, "rank_01.npz"),
              os.path.join(planted, "rank_05.npz"))
    mpath = os.path.join(planted, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    plan = CollectivePlan.parse(man["policy"]["collective"])
    plan = CollectivePlan(entries=(("bogus.*", CollectiveSpec()),)
                          + plan.entries, default=plan.default)
    man["policy"]["collective"] = plan.shorthand()
    man["collective_plan"] = {
        "entries": [[p, c.shorthand()] for p, c in plan.entries],
        "default": plan.default.shorthand()}
    with open(mpath, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
    return planted


#: what ``serve verify`` must find in the planted copy: the missing and
#: the stray rank file, the unreachable glob
PLANTED = {"MF004/error": 2, "MF001/error": 1}


def phase_artifact_tp(cfg, serve_tp: dict | None, tp_traces: list | None,
                      phase: str = "artifact-tp",
                      verify: bool = False) -> dict:
    """Phase 17 (and 20): prepare at tp=2, save the rank files, and serve
    them on two rank processes that each read only their own, held to
    ``serve_tp``'s ids and ``tp_traces`` (or, given None, to each rank's
    in-memory plan of ``cfg`` from seed 0).  The manifest's split of the
    embedding and the head must be the model's (by vocab, or by
    ``d_model`` where the vocab does not divide the ranks)."""
    tcfg = cfg.with_quant(collective=TP_SERVE)
    path, nbytes, files, prepare_s, save_s, peak = _prepare_and_save(
        tcfg, TP, phase)
    greedy_tokens, greedy_plen = _greedy_inputs(cfg)
    started = None
    try:
        shards = DeploymentArtifact.load_manifest(path)["leaf_shards"]
        embed = {k: shards[f"embed||{k}"] for k in ("embedding", "lm_head")}
        if embed != cm.embed_specs(cfg, TP):
            raise AssertionError(f"{phase}: the manifest splits the "
                                 f"embedding and head {embed}, the model "
                                 f"{cm.embed_specs(cfg, TP)}")
        torch.cuda.empty_cache()
        started = _verify_start(path) if verify else None
        ranks = POOL.run(_artifact_tp_rank, tcfg, path, greedy_tokens,
                         greedy_plen, serve_tp is None, timeout=600)
        checked = (_verify_finish(started, phase, f"{describe(cfg)} tp=2 "
                                  f"{TP_SERVE}") if verify else None)
    finally:
        if started is not None:
            _verify_stop(started)
        shutil.rmtree(path)
    k3_per, k1_per = cfg.num_layers, mlp_launches(cfg) - cfg.num_layers
    for r in ranks:
        steps = r["decode_steps"]
        expect_counts(r["counts"], {
            "dequant_matmul_wire_ordered": k3_per * steps,
            "dequant_matmul_ordered": k1_per * steps},
            f"{phase} rank {r['rank']} ({steps} decode steps)")
        st = r["stats"]
        if (tuple(st["ranks"]) != (r["rank"],) or st["file_bytes_loaded"]
                != files[f"rank_{r['rank']:02d}.npz"]
                or not r["resident_fraction"] < 1):
            raise AssertionError(f"{phase} rank {r['rank']}: read "
                                 f"{st}, expected its own file only")
        want = (serve_tp["outputs"] if serve_tp is not None
                else r["reference"]["outputs"])
        if r["outputs"] != want:
            raise AssertionError(f"{phase} rank {r['rank']}: ids "
                                 f"{r['outputs']} differ from the in-memory "
                                 f"tp=2 serve's {want}")
        (ia, la) = r["trace"]
        (ib, lb) = (tp_traces[r["rank"]] if tp_traces is not None
                    else r["reference"]["trace"])
        if not (torch.equal(ia, ib) and torch.equal(la, lb)):
            raise AssertionError(
                f"{phase} rank {r['rank']}: greedy logits not bit-equal "
                f"to the in-memory {TP_SERVE} engine's (max gap "
                f"{(la - lb).abs().max().item():.3g})")
    r0 = ranks[0]
    out = {"reckoned_bytes": nbytes, "file_bytes": files,
           "disk_bytes": sum(files.values()), "prepare_s": prepare_s,
           "prepare_peak_bytes": peak,
           "save_s": save_s, "collective": r0["collective"],
           "load_s": [r["load_s"] for r in ranks],
           "run_s": [r["run_s"] for r in ranks],
           "load_stats": [r["stats"] for r in ranks],
           "resident_fraction": [r["resident_fraction"] for r in ranks],
           "decode_steps": r0["decode_steps"],
           "counts": [r["counts"] for r in ranks], "embed_split": embed,
           "ids_equal": True, "greedy_logits_bit_equal": True,
           "verify": checked}
    line(phase, "{} tp=2 {} prepared on the card in "
         "{:.2f}s (max_memory_allocated {:.2f} GiB), saved in {:.2f}s as "
         "two rank files ({} GB; {:.3f} GB of leaves; embedding and head "
         "split along dims {}); each rank read only its own file, loaded "
         "in {} s: {}; per rank dequant_matmul_wire_ordered {} = {} x {} "
         "and dequant_matmul_ordered {} = {} x {}; the 4 requests' ids "
         "equal the in-memory tp=2 serve's; greedy ids and logits "
         "bit-equal to its on both ranks".format(
             describe(cfg), r0["collective"], prepare_s, peak / 2**30,
             save_s,
             " + ".join(f"{b / 1e9:.3f}" for b in files.values()
                        if b > 2**20), nbytes / 1e9,
             tuple(embed.values()),
             "/".join(f"{s:.2f}" for s in out["load_s"]),
             "; ".join(f"rank {r['rank']} resident_artifact_bytes="
                       f"{r['stats']['file_bytes_loaded']}/"
                       f"{r['stats']['file_bytes_total']} (fraction "
                       f"{r['resident_fraction']:.4f})" for r in ranks),
             r0["counts"]["dequant_matmul_wire_ordered"], k3_per,
             r0["decode_steps"], r0["counts"]["dequant_matmul_ordered"],
             k1_per, r0["decode_steps"]))
    return out


# ---------------------------------------------------------------------------
# phases 18-21: the other dense decoders
# ---------------------------------------------------------------------------

def phase_serve_archs() -> tuple[dict, dict]:
    """Phase 18: each of ``ARCHS`` at full width (mistral-large at
    ``MISTRAL_LAYERS`` layers, the cut printed), from seed 0: the four
    requests through the captured step, tp-aware (K1 only, one launch per
    MLP weight a step), and again under naive-actorder on backend=cuda
    (K4 only); naive against tp-aware layer by layer (``layerwise``),
    with the greedy traces through the whole model and the sum-order
    control reported; for granite the captured step against
    ``decode_eager`` bit for bit.  Each arch's engines are freed before
    the next.  Returns the results and, for the archs of the TP phases,
    what phase 19 holds its runs to (the tp=1 engine's greedy trace, and
    its layers' input carries and outputs)."""
    out, refs = {}, {}
    for arch in ARCHS:
        base = arch_config(arch)
        full = get_config(arch).num_layers
        if base.num_layers != full:
            line("serve-archs", f"{arch}: full width, depth cut from {full} "
                                f"to {base.num_layers} layers (the {full} "
                                f"layers do not fit one card)")
        cfg = base.with_quant(mode="mlp", scheme="tp-aware", backend="auto")
        engine, serve = phase_serve(cfg, "dequant_matmul_ordered",
                                    f"serve {arch}")
        res = {"layers": cfg.num_layers, "full_layers": full,
               "serve": serve}
        if arch == "granite-3-8b":
            steps = 4
            captures, offsets, recapture_s = _captured_vs_eager(
                engine, cfg, steps, f"capture {arch}")
            res["capture"] = {"steps_each": steps, "captures": captures,
                              "offsets": offsets, "bit_equal": True}
            line(f"capture {arch}", f"B=4: {steps} lockstep steps and "
                 f"{steps} on per-slot positions (offsets {offsets}) "
                 f"through the captured step bit-equal to decode_eager "
                 f"(logits and the whole KV cache after each step); "
                 f"captures {captures}")
        carries, outputs = layer_trace(
            engine, torch.from_numpy(_greedy_inputs(cfg)[0]).cuda())
        if arch in TP_ARCHS:
            # phase 19's reference: the first TP_ARCH_LAYERS layers
            cut = cfg.with_(num_layers=TP_ARCH_LAYERS)
            layers = engine.params["layers"][:cut.num_layers]
            first = Engine(model=build_model(cut),
                           params=dict(engine.params, layers=layers),
                           device=engine.device, max_seq=engine.max_seq,
                           policy=engine.policy)
            refs[arch] = {"trace": greedy_reference(first, cut),
                          "layers": ([c.cpu() for c in
                                      carries[:cut.num_layers]],
                                     [o.cpu() for o in
                                      outputs[:cut.num_layers]])}
            del first
        naive_cfg = base.with_quant(mode="mlp", scheme="naive-actorder",
                                    backend="cuda")
        naive, res["serve_naive"] = phase_serve(
            naive_cfg, "dequant_matmul_gidx", f"serve-naive {arch}")
        res["scheme_layerwise"] = lw = layerwise(
            layer_outputs(naive, carries), outputs,
            f"scheme-crosscheck {arch}")
        text, res["scheme_crosscheck"] = _greedy_compare(
            naive, engine, cfg, "naive-actorder (K4) vs tp-aware (K1)",
            gate=False)
        plain = Engine(model=engine.model, params=engine.params,
                       device=engine.device, max_seq=engine.max_seq,
                       policy=engine.policy.with_(backend="torch"))
        control, res["sum_order_control"] = _greedy_compare(
            engine, plain, cfg, "the same tp-aware plan, backend cuda vs "
            "torch", gate=False)
        line(f"scheme-crosscheck {arch}", f"layer by layer on the same "
             f"input carries (2 prompts x 12 tokens), naive-actorder (K4) "
             f"vs tp-aware (K1): the {lw['layers']} layers' float32 "
             f"outputs within 1e-5 of max|.| + 1e-4, worst "
             f"{lw['max_abs_err']:.3g} ({lw['max_rel_err']:.3g} of "
             f"max|.|); greedy 2 prompts x 8 tokens through the whole "
             f"model (reported): {text}; sum-order control (reported): "
             f"{control}")
        del engine, naive, plain
        torch.cuda.empty_cache()
        out[arch] = res
    return out, refs


def phase_serve_tp_archs(refs: dict) -> dict:
    """Phase 19: each of ``TP_ARCHS`` at tp=2 with ``TP_SERVE`` on two
    rank processes (granite's odd vocab split by ``d_model``), depth cut
    to ``TP_ARCH_LAYERS`` (printed), as phases 14 and 15: K3 and K1
    launches per step per rank, the fused ring bit-identical to the plain
    one, psum at tp=2 against phase 18's tp=1 engine's first layers layer
    by layer."""
    out = {}
    for arch in TP_ARCHS:
        cfg = arch_config(arch).with_(num_layers=TP_ARCH_LAYERS).with_quant(
            mode="mlp", scheme="tp-aware", backend="auto")
        line(f"serve-tp {arch}", f"full width, depth cut from "
             f"{arch_config(arch).num_layers} to {cfg.num_layers} layers "
             f"(the gloo step via host dominates; phase 18's reference is "
             f"the full engine's first {cfg.num_layers} layers)")
        serve, cross, _ = phase_serve_tp(
            cfg, refs[arch]["trace"], TP_PAIRS[:1], f"serve-tp {arch}",
            f"tp-crosscheck {arch}", refs[arch]["layers"])
        out[arch] = {"serve_tp": serve, "tp_crosscheck": cross,
                     "embed_split": cm.embed_specs(cfg, TP)}
    return out


def phase_artifact_granite() -> dict:
    """Phase 20: phases 16 and 17 for granite at full width and
    ``ARTIFACT_GRANITE_LAYERS`` layers, each held to in-memory engines of
    that depth from seed 0: at tp=1 one served here first (its four
    requests, the launch counts checked as in phase 18), at tp=2 one in
    each rank process."""
    full = get_config("granite-3-8b").num_layers
    cfg = get_config("granite-3-8b").with_(
        num_layers=ARTIFACT_GRANITE_LAYERS).with_quant(
            mode="mlp", scheme="tp-aware", backend="auto")
    line("artifact granite-3-8b", f"full width, depth cut from {full} to "
         f"{cfg.num_layers} layers (the artifact's save and load take most "
         f"of the phase)")
    engine, serve = phase_serve(cfg, "dequant_matmul_ordered",
                                f"serve granite-3-8b {cfg.num_layers}L")
    ref = memory_reference(engine, cfg, serve)
    del engine
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "full_layers": full,
            "tp1": phase_artifact(cfg, ref, "artifact granite-3-8b"),
            "tp2": phase_artifact_tp(cfg, None, None,
                                     "artifact-tp granite-3-8b")}


def phase_long_forward() -> dict:
    """Phase 21: starcoder2 at full width, ``LONG_LAYERS`` layers, one
    ``LONG_S``-token sequence under its 4096-token window: the Q-chunked
    einsum forward (``attn_backend="xla"``; the einsum attention run as
    ``LONG_S / Q_CHUNK`` chunks a layer, counted) against the flash
    forward (K2, one launch a layer); K1 on its tensor-core loop.  The
    last position's greedy id must be equal; the share of positions
    whose argmax agrees, each forward's peak allocated memory beside the
    size of the unchunked (S, S) score tensor, and K2's device time
    against its bound are printed."""
    cfg = get_config("starcoder2-3b").with_(
        num_layers=LONG_LAYERS).with_quant(mode="mlp", scheme="tp-aware",
                                           backend="auto")
    window = cfg.attention_window
    torch.cuda.empty_cache()
    engine = make_engine(cfg, 0, device="cuda", max_seq=64, window=window)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, LONG_S))).cuda()
    h, d = cfg.n_heads, cfg.head_dim
    score_bytes = 4 * h * LONG_S * LONG_S          # one layer's (S, S)
    res, logits = {}, {}
    sdpa = cm._sdpa
    for name in ("flash", "xla"):
        eng = dataclasses.replace(engine, attn_backend=name)
        eng.prefill_logits(toks)                    # warm-up
        torch.cuda.synchronize()
        calls = []

        def counted(q, k, v, mask):
            calls.append((q.shape[1], k.shape[1]))
            return sdpa(q, k, v, mask)

        cm._sdpa = counted
        try:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            logits[name] = eng.prefill_logits(toks)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated() - before
        finally:
            cm._sdpa = sdpa
        per = mlp_launches(cfg)
        expect_counts(counts, {
            "dequant_matmul_ordered": per, TC: per,
            "flash_attention": cfg.num_layers if name == "flash" else 0},
            f"long-forward {name}")
        chunks = ([] if name == "flash" else [(cm.Q_CHUNK, LONG_S)] * (
            LONG_S // cm.Q_CHUNK) * cfg.num_layers)
        if calls != chunks:
            raise AssertionError(f"long-forward {name}: einsum attention "
                                 f"calls {calls}, expected {chunks}")
        res[name] = {"wall_ms": wall, "counts": counts,
                     "peak_bytes": peak, "sdpa_calls": len(calls)}
    flash = dataclasses.replace(engine, attn_backend="flash")
    for _ in range(3):          # profiler sessions have dropped events
        device_ms, _, top, by_name, kcounts = _device_kernels(
            lambda: (flash.prefill_logits(toks), torch.cuda.synchronize()),
            1)
        k2_ms = sum(v for k, v in by_name.items() if "flash_attention" in k)
        k2_n = sum(v for k, v in kcounts.items() if "flash_attention" in k)
        if k2_n == cfg.num_layers:
            break
    if k2_n != cfg.num_layers:
        raise AssertionError(f"long-forward: the profiler saw {k2_n} K2 "
                             f"kernels, expected {cfg.num_layers}")
    flops = _flash_flops(1, h, LONG_S, LONG_S, d, True, window)
    bound, by = _bound(4 * 4 * h * LONG_S * d, 3 * flops, PEAK_TF32)
    lf, lx = logits.pop("flash"), logits.pop("xla")
    del engine, flash
    if lf.shape != (1, LONG_S, cfg.vocab_size) or not (
            torch.isfinite(lf).all() and torch.isfinite(lx).all()):
        raise AssertionError(f"long-forward logits {tuple(lf.shape)} not "
                             f"finite of the expected shape")
    gap = (lf - lx).abs().max().item()
    scale = lx.abs().max().item()
    last_f, last_x = lf[0, -1].argmax().item(), lx[0, -1].argmax().item()
    agree = (lf.argmax(-1) == lx.argmax(-1)).float().mean().item()
    if last_f != last_x or not gap <= 5e-2 * scale:
        raise AssertionError(f"long-forward: flash vs Q-chunked einsum: "
                             f"last-position ids {last_f} / {last_x}, logit "
                             f"gap {gap:.3g} (max|logit| {scale:.3g})")
    out = {"layers": cfg.num_layers, "s": LONG_S, "window": window,
           **res, "unchunked_score_bytes": score_bytes,
           "max_logit_gap": gap, "max_logit": scale, "last_id": last_f,
           "positions_argmax_agree": agree,
           "flash_launches": res["flash"]["counts"]["flash_attention"],
           "flash_device_ms": device_ms, "k2_ms_per_launch": k2_ms / k2_n,
           "k2_bound_ms": bound, "k2_bound_by": by, "k2_flops": flops,
           "top_kernels_ms": top}
    line("long-forward", f"{describe(cfg)} B1 S{LONG_S} window {window}: "
         f"Q-chunked einsum forward ({res['xla']['sdpa_calls']} chunks of "
         f"{cm.Q_CHUNK} query rows) {res['xla']['wall_ms']:.1f} ms wall, "
         f"peak {res['xla']['peak_bytes'] / 2**30:.2f} GiB allocated "
         f"(the unchunked (S, S) float32 scores of one layer: "
         f"{score_bytes / 2**30:.2f} GiB); flash forward "
         f"{res['flash']['wall_ms']:.1f} ms wall, peak "
         f"{res['flash']['peak_bytes'] / 2**30:.2f} GiB, flash_attention "
         f"launches {out['flash_launches']} = {cfg.num_layers}, K2 "
         f"{out['k2_ms_per_launch']:.3f} ms a launch on the device (bound "
         f"{bound:.3f} by {by}: 3 x {flops / 1e9:.1f} GFLOP at the TF32 "
         f"tensor-core rate); last-position id {last_f} in both; max "
         f"logit gap {gap:.3g} (max|logit| {scale:.3g}); argmax agrees at "
         f"{100 * agree:.2f}% of positions")
    return out


#: phases 22-23: the paged cache's layout and the requests' shapes (half
#: of them share a prompt prefix of two full pages); the engines' capacity,
#: and the larger one of the dense-against-paged pair at a long capacity
PAGE = 16
PAGED = f"paged:{PAGE}"
SHARED_PREFIX = 2 * PAGE
PAGED_MAX_SEQ = 64
LONG_MAX_SEQ = 1024
GREEDY = SamplingConfig(temperature=0.0)
SEEDED = SamplingConfig(temperature=0.8, top_k=40)


def _paged_requests(cfg) -> list:
    """Eight requests of 16 new tokens, each seeded by its rid: even rids
    a shared 32-token prefix and a tail of 1-6 tokens, odd rids 24-31
    tokens of their own.  The odd ones retire after the first wave's
    shared pages are complete, so the second wave's shared requests find
    them (prefix hits, replay skipped)."""
    rng = np.random.default_rng(22)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX)
    reqs = []
    for rid in range(8):
        if rid % 2 == 0:
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(1, 7)))
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(24, 32)))
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=16, seed=rid))
    return reqs


def _sibling(engine, kv: str = "dense", max_seq: int = PAGED_MAX_SEQ,
             row_block: int = cm.ROW_BLOCK):
    """A fresh engine (no captured step yet) on ``engine``'s params under
    the cache layout ``kv``, its library products in blocks of
    ``row_block`` rows."""
    return Engine(model=engine.model, params=engine.params,
                  device=engine.device, max_seq=max_seq,
                  policy=engine.policy.with_(kv=kv), row_block=row_block)


def _recorded_serve(engine, cfg, scfg, kernel: str, what: str,
                    sched=None, requests=None) -> dict:
    """Serve ``requests`` (default ``_paged_requests``) through a
    scheduler of 4 slots on ``engine`` (or ``sched``), the launch counts
    set to 0 just before and read just after: every step launches
    ``kernel`` once for each MLP weight and no other counted kernel.
    Each request's logits row of every step that emits is kept (the
    engine's ``decode`` wrapped)."""
    reqs = _paged_requests(cfg) if requests is None else requests
    if sched is None:
        sched = Scheduler(engine, max_batch=4, prompt_budget=40, scfg=scfg,
                          seed=0)
    rows = {}
    step = engine.decode

    def decode(cache, tokens, pos, pages=None):
        logits, cache = step(cache, tokens, pos, pages)
        for i, s in enumerate(sched._slots):
            if s is not None and s.fed + 1 >= s.req.prompt.size:
                rows.setdefault(s.req.rid, []).append(logits[i])
        return logits, cache

    engine.decode = decode
    for req in reqs:
        sched.submit(req)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    steps0 = sched.steps
    reset_counts()
    try:
        done, dt, step_ms = _run_steps(sched)
    finally:
        del engine.decode
    counts = read_counts()
    steps = sched.steps - steps0
    expect_counts(counts, {kernel: mlp_launches(cfg) * steps},
                  f"{what} ({steps} decode steps)")
    if sorted(done) != sorted(r.rid for r in reqs) or any(
            len(done[r.rid].output) != r.max_new_tokens for r in reqs):
        raise AssertionError(f"{what}: requests incomplete")
    if not engine.decode_mode.startswith("CUDA graph"):
        raise AssertionError(f"{what}: decode step {engine.decode_mode}")
    return {"sched": sched, "steps": steps, "run_s": dt,
            "steady_ms_per_step": statistics.median(step_ms[1:]),
            "first_step_ms": step_ms[0], "launches": counts[kernel],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before_bytes": before,
            "decode_mode": engine.decode_mode,
            "ids": {k: r.output for k, r in sorted(done.items())},
            "logits": {k: torch.stack(v) for k, v in sorted(rows.items())}}


def _bit_equal(a: dict, b: dict, what: str) -> None:
    """Equal ids and bit-equal emission logits, request by request."""
    for rid, ids in a["ids"].items():
        if ids != b["ids"][rid] or not torch.equal(a["logits"][rid],
                                                   b["logits"][rid]):
            gap = (a["logits"][rid] - b["logits"][rid]).abs().max().item()
            raise AssertionError(f"{what}: request {rid}'s ids or logits "
                                 f"differ (max logit gap {gap:.3g})")


def _quantized_gap(fp: dict, q: dict) -> dict:
    """A quantized-page serve against the fp one (greedy): ids agreeing,
    and the logit gap up to each request's first differing id."""
    gap, first, agree = 0.0, 0.0, 0
    for rid, ids in fp["ids"].items():
        same = next((i for i, (x, y) in enumerate(zip(ids, q["ids"][rid]))
                     if x != y), len(ids))
        agree += ids == q["ids"][rid]
        n = max(same, 1)
        d = (fp["logits"][rid][:n] - q["logits"][rid][:n]).abs()
        gap = max(gap, d.max().item())
        first = max(first, d[0].max().item())
    scale = max(v.abs().max().item() for v in fp["logits"].values())
    return {"requests_ids_equal": agree, "max_logit_gap": gap,
            "first_token_gap": first, "max_logit": scale}


def _paged_summary(run: dict) -> dict:
    st = run["sched"].cache_stats()
    return {k: v for k, v in run.items()
            if k not in ("sched", "logits")} | {"cache": st}


def phase_serve_paged_pair(engine, cfg, kernel: str, phase: str,
                           seeded: bool = True) -> tuple[dict, dict]:
    """The eight requests dense and ``PAGED`` on ``engine``'s params,
    greedy and (with ``seeded``) seeded, each run through the captured
    step: greedy logits and ids bit-equal request by request, seeded ids
    equal, prefix hits in the paged runs and no live page after the
    drain.  Returns the summary and the greedy paged run."""
    runs = {}
    samplings = (("greedy", GREEDY),) + ((("seeded", SEEDED),) if seeded
                                         else ())
    for name, scfg in samplings:
        for kv in ("dense", PAGED):
            runs[name, kv] = _recorded_serve(
                _sibling(engine, kv), cfg, scfg, kernel,
                f"{phase} {name} {kv}")
    _bit_equal(runs["greedy", "dense"], runs["greedy", PAGED],
               f"{phase} greedy")
    if seeded and runs["seeded", "dense"]["ids"] != runs["seeded",
                                                          PAGED]["ids"]:
        raise AssertionError(f"{phase}: seeded ids differ")
    for name, _ in samplings:
        st = runs[name, PAGED]["sched"].cache_stats()
        if st["prefix"]["hits"] < 1 or st["pages"]["live"]:
            raise AssertionError(f"{phase} {name}: prefix {st['prefix']}, "
                                 f"pages {st['pages']}")
    out = {f"{name} {kv}": _paged_summary(r)
           for (name, kv), r in runs.items()}
    g = runs["greedy", PAGED]
    st = g["sched"].cache_stats()
    line(phase, f"{describe(cfg)} {cfg.quant.scheme}, 8 requests (4 share a "
                f"{SHARED_PREFIX}-token prefix) x 16 tokens, 4 slots, max_seq "
                f"{PAGED_MAX_SEQ}: dense and {PAGED} greedy logits and ids "
                f"bit-equal request by request"
                + (", seeded ids equal; " if seeded else "; ") +
                f"{kernel} {mlp_launches(cfg)} a step in every run "
                f"({g['launches']} in {g['steps']} paged greedy steps, dense "
                f"{runs['greedy', 'dense']['steps']}); decode step: "
                f"{g['decode_mode']}; steady step dense "
                f"{runs['greedy', 'dense']['steady_ms_per_step']:.2f} / paged "
                f"{g['steady_ms_per_step']:.2f} ms; prefix hits "
                f"{st['prefix']['hits']} (hit rate "
                f"{st['prefix']['hit_rate']}), pages live {st['pages']['live']} peak "
                f"{st['pages']['peak_live']} of {st['pages']['total']}, bytes "
                f"pool {st['bytes']['pool']} peak_live "
                f"{st['bytes']['peak_live']} dense_equiv "
                f"{st['bytes']['dense_equiv']}")
    return out, g


def phase_serve_paged(engine, cfg) -> dict:
    """Phase 22 at tp=1 (tp=2 runs in phase 14's ranks): the dense and
    paged pair, int8 and int4 pages against fp, the pair at
    ``LONG_MAX_SEQ``, and a release of the cache and a second serve."""
    out, fp = phase_serve_paged_pair(engine, cfg, "dequant_matmul_ordered",
                                     "serve-paged")
    for bits in (8, 4):
        kv = f"{PAGED}:int{bits}"
        q = _recorded_serve(_sibling(engine, kv), cfg, GREEDY,
                            "dequant_matmul_ordered", f"serve-paged {kv}")
        st = q["sched"].cache_stats()
        if not st["bytes"]["saved_quantized"] > 0:
            raise AssertionError(f"{kv}: {st['bytes']}")
        out[kv] = _paged_summary(q) | {"vs_fp": _quantized_gap(fp, q)}
        gap = out[kv]["vs_fp"]
        line("serve-paged", f"{kv}: {gap['requests_ids_equal']} of 8 "
             f"requests' greedy ids equal fp pages'; logit gap "
             f"{gap['first_token_gap']:.3g} at the first token, "
             f"{gap['max_logit_gap']:.3g} up to the first differing id "
             f"(max|logit| {gap['max_logit']:.3g}); bytes per page "
             f"{st['bytes']['per_page']} (fp "
             f"{fp['sched'].cache_stats()['bytes']['per_page']}), "
             f"saved_quantized {st['bytes']['saved_quantized']}; steady "
             f"step {q['steady_ms_per_step']:.2f} ms")
    long = {kv: _recorded_serve(_sibling(engine, kv, LONG_MAX_SEQ), cfg,
                                GREEDY, "dequant_matmul_ordered",
                                f"serve-paged {kv} max_seq {LONG_MAX_SEQ}")
            for kv in ("dense", PAGED)}
    _bit_equal(long["dense"], long[PAGED], f"max_seq {LONG_MAX_SEQ}")
    out[f"max_seq {LONG_MAX_SEQ}"] = {kv: _paged_summary(r)
                                      for kv, r in long.items()}
    d, p = long["dense"], long[PAGED]
    line("serve-paged", f"max_seq {LONG_MAX_SEQ}: dense and {PAGED} greedy "
         f"logits and ids bit-equal; steady step dense "
         f"{d['steady_ms_per_step']:.2f} / paged {p['steady_ms_per_step']:.2f}"
         f" ms; max_memory_allocated above what was allocated before each "
         f"run (the params, earlier runs) dense "
         f"{(d['peak_bytes'] - d['allocated_before_bytes']) / 2**30:.3f} / "
         f"paged {(p['peak_bytes'] - p['allocated_before_bytes']) / 2**30:.3f}"
         f" GiB; paged "
         f"pool {p['sched'].cache_stats()['bytes']['pool']} bytes, peak live "
         f"{p['sched'].cache_stats()['bytes']['peak_live']}, dense_equiv "
         f"{p['sched'].cache_stats()['bytes']['dense_equiv']}")
    del long
    # release the pool (and its captured step), then serve again; the
    # allocated bytes are read with no recorded logits alive
    eng = _sibling(engine, PAGED)
    first = _recorded_serve(eng, cfg, GREEDY, "dequant_matmul_ordered",
                            "serve-paged before release_cache")
    sched = first["sched"]
    first_logits = {k: v.cpu() for k, v in first.pop("logits").items()}
    held = torch.cuda.memory_allocated()
    if not sched.release_cache() or eng.graphs:
        raise AssertionError("release_cache kept the pool or its graph")
    released = torch.cuda.memory_allocated()
    again = _recorded_serve(eng, cfg, GREEDY, "dequant_matmul_ordered",
                            "serve-paged after release_cache", sched)
    again["logits"] = {k: v.cpu() for k, v in again["logits"].items()}
    _bit_equal(first | {"logits": first_logits}, again,
               "after release_cache")
    if eng.captures != 2 or sched.cache_stats()["builds"] != 2:
        raise AssertionError(f"release: {eng.captures} captures")
    out["release"] = {"allocated_with_cache": held,
                      "allocated_released": released,
                      "allocated_again": torch.cuda.memory_allocated(),
                      "pool_bytes": sched.cache_stats()["bytes"]["pool"],
                      "captures": eng.captures, "ids_equal": True}
    r = out["release"]
    line("serve-paged", f"release_cache: {(held - released) / 2**20:.2f} "
         f"MiB freed (the pool {r['pool_bytes'] / 2**20:.2f} MiB, its "
         f"graph's buffers); serving the same requests again built a "
         f"second pool and a second capture "
         f"({(r['allocated_again'] - released) / 2**20:.2f} MiB allocated "
         f"again): ids and greedy logits equal the first serve's")
    return out


def _http_stream(port: int, body: dict, hang_up_after: int | None = None,
                 first=None) -> list:
    """One SSE exchange as [(event, payload), ...]; with ``hang_up_after``
    the client closes the socket once it has read that many tokens.
    ``first``: an Event set at the first token."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out, event = [], None
        for raw in resp:
            raw = raw.decode("utf-8").rstrip("\n")
            if raw.startswith("event: "):
                event = raw[len("event: "):]
            elif raw.startswith("data: "):
                out.append((event, json.loads(raw[len("data: "):])))
                tokens = sum(1 for k, _ in out if k == "token")
                if event == "token" and first is not None:
                    first.set()
                if hang_up_after is not None and tokens >= hang_up_after:
                    resp.close()
                    break
        return out
    finally:
        conn.close()


def _http_get(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase_http(engine, cfg) -> dict:
    """Phase 23: the HTTP/SSE front end (``ServingServer`` on
    127.0.0.1:0) over a ``PAGED`` engine on ``engine``'s params, whose
    step the server's loop thread captures and replays: 8 clients on
    threads at once, each SSE stream start / 16 tokens / done, the seeded
    ids those of the same requests through a ``Scheduler`` without the
    server, K1 108 a step; ``/v1/health`` names the layout and
    ``/v1/stats`` gives TTFT and inter-token latency."""
    import threading

    from repro_torch.serving import ServingServer

    served = _sibling(engine, PAGED)
    srv = ServingServer(served, max_batch=4, prompt_budget=40, scfg=SEEDED,
                        seed=0, queue_capacity=16)
    reqs = _paged_requests(cfg)
    results: dict = {}

    def client(req):
        results[req.rid] = _http_stream(srv.port, {
            "prompt": [int(t) for t in req.prompt], "max_new_tokens": 16,
            "seed": req.seed})

    reset_counts()
    srv.start()
    try:
        health = _http_get(srv.port, "/v1/health")
        threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("http: a client did not finish")
        stats = _http_get(srv.port, "/v1/stats")
    finally:
        srv.shutdown(drain=False, timeout=60)
    counts = read_counts()
    steps = srv.loop.scheduler.steps
    expect_counts(counts, {"dequant_matmul_ordered":
                           mlp_launches(cfg) * steps},
                  f"http ({steps} decode steps)")
    if health["kv"] != PAGED or served.captures != 1:
        raise AssertionError(f"http: health {health}, {served.captures} "
                             "captures")
    ids = {}
    for rid, events in sorted(results.items()):
        kinds = [k for k, _ in events]
        if kinds != ["start"] + ["token"] * 16 + ["done"]:
            raise AssertionError(f"http: request {rid}'s stream {kinds}")
        ids[rid] = [p["token"] for k, p in events if k == "token"]
    solo = Scheduler(_sibling(engine, PAGED), max_batch=4, prompt_budget=40,
                     scfg=SEEDED, seed=0)
    for req in reqs:
        solo.submit(req)
    want = {k: r.output for k, r in sorted(solo.run().items())}
    if ids != want:
        raise AssertionError(f"http: ids {ids} differ from the scheduler's "
                             f"{want}")
    lat = stats["latency_ms"]
    out = {"health": health, "stats": stats, "wall_s": wall,
           "decode_steps": steps, "launches": counts["dequant_matmul_ordered"],
           "decode_mode": served.decode_mode, "ids_equal": True}
    line("http", f"{describe(cfg)} behind ServingServer (kv "
         f"{health['kv']}): 8 concurrent SSE clients, 16 tokens each in "
         f"{wall:.2f}s, every stream start/token x16/done; seeded ids equal "
         f"the same requests through a Scheduler; dequant_matmul_ordered "
         f"{counts['dequant_matmul_ordered']} = {mlp_launches(cfg)} x "
         f"{steps} steps (the loop thread's captured step: "
         f"{served.decode_mode}); TTFT p50 {lat['ttft']['p50']} / p90 "
         f"{lat['ttft']['p90']} ms, ITL p50 {lat['itl']['p50']} / p90 "
         f"{lat['itl']['p90']} ms; tokens/s "
         f"{stats['tokens']['per_s']}; cache prefix hits "
         f"{stats['cache']['prefix']['hits']}")
    return out


# ---------------------------------------------------------------------------
# phases 24-26: offline planning (GPTQ, the attention fold, the tuner)
# ---------------------------------------------------------------------------

def _timed(fn, acc: list):
    """``fn`` with its seconds (after a synchronize) added to ``acc``."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        return out
    return run


@torch.inference_mode()
def phase_gptq() -> dict:
    """Phase 24: GPTQ on one qwen3-4b MLP pair at full width (2560 /
    9728), random weights and ``GPTQ_ROWS`` calibration rows made on the
    card from a seed: the Hessians of the pair's inputs (up and gate: x;
    down: the hidden activations), ``plan_pair(use_gptq=True)`` and, for
    comparison, the RTN plan in the same processing orders (diag(H));
    the seconds of the Hessians, the factors and the codes; each pair's
    output error on the calibration rows and on as many held-out rows
    (GPTQ's must be below RTN's on the calibration rows); and the GPTQ
    pair's three GEMMs through K1 against their plain version at M 4 and
    M ``GPTQ_ROWS``."""
    from repro_torch.core import reorder, schemes

    cfg = QWEN
    d, ff = cfg.d_model, cfg.d_ff
    gs_up, gs_down = mlp_shapes(cfg)[0][3], mlp_shapes(cfg)[1][3]
    gen = torch.Generator(device="cuda").manual_seed(24)
    w = {"w_up": cm.dense_init(gen, (d, ff)),
         "w_gate": cm.dense_init(gen, (d, ff)),
         "w_down": cm.dense_init(gen, (ff, d))}
    x = torch.randn(GPTQ_ROWS, d, generator=gen, device="cuda")
    held = torch.randn(GPTQ_ROWS, d, generator=gen, device="cuda")
    act = schemes.ACTIVATIONS[cfg.activation]

    def dense(rows):
        hid = act(rows @ w["w_gate"]) * (rows @ w["w_up"])
        return hid, hid @ w["w_down"]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hid, y = dense(x)
    h_up, h_down = qz.make_hessian(x), qz.make_hessian(hid)
    torch.cuda.synchronize()
    hessian_s = time.perf_counter() - t0
    _, y_held = dense(held)
    factor_s, codes_s = [], []
    factor, codes = qz.cholesky_hinv_upper, qz._gptq_codes
    qz.cholesky_hinv_upper = _timed(factor, factor_s)
    qz._gptq_codes = _timed(codes, codes_s)
    kw = dict(w_gate=w["w_gate"], group_size_up=gs_up,
              group_size_down=gs_down, hessian_up=h_up, hessian_down=h_down)
    try:
        t0 = time.perf_counter()
        gptq = reorder.plan_pair(w["w_up"], w["w_down"], use_gptq=True, **kw)
        torch.cuda.synchronize()
        gptq_s = time.perf_counter() - t0
    finally:
        qz.cholesky_hinv_upper, qz._gptq_codes = factor, codes
    t0 = time.perf_counter()
    rtn = reorder.plan_pair(w["w_up"], w["w_down"], **kw)
    torch.cuda.synchronize()
    rtn_s = time.perf_counter() - t0
    policy = ExecutionPolicy.auto("tp-aware", device=torch.device("cuda"))
    errs = {}
    launches = {}
    for name, pp in (("rtn", rtn), ("gptq", gptq)):
        reset_counts()
        calib = pp.forward(x, policy, activation=cfg.activation)
        counts = read_counts()
        launches[name] = counts["dequant_matmul_ordered"]
        expect_counts(counts, {"dequant_matmul_ordered": 3,
                               TC: 3 if GPTQ_ROWS >= dk.tensor_core_min_m()
                               else 0}, f"gptq: the {name} pair's forward")
        out = pp.forward(held, policy, activation=cfg.activation)
        errs[name] = {
            "calibration_mse": torch.mean(torch.square(calib - y)).item(),
            "held_out_mse": torch.mean(torch.square(out - y_held)).item()}
    if not errs["gptq"]["calibration_mse"] < errs["rtn"]["calibration_mse"]:
        raise AssertionError(f"gptq: GPTQ's calibration error is not below "
                             f"RTN's: {errs}")
    rows, worst = [], 0.0
    xg = x.index_select(-1, gptq.p1_up)
    y1 = act(ops.dequant_matmul(xg, gptq.gate)) * ops.dequant_matmul(
        xg, gptq.up)
    for name, xin, ql in (("up", xg, gptq.up), ("gate", xg, gptq.gate),
                          ("down", y1, gptq.down)):
        for m in (4, GPTQ_ROWS):
            got = ops.dequant_matmul(xin[:m], ql)
            ref = dk.dequant_matmul_ordered_torch(
                xin[:m], ql.qweight, ql.scales, ql.zeros,
                group_size=ql.group_size)
            err = (got - ref).abs().max().item()
            rtol, atol = TOL[torch.float32]
            _within(rows, err, ref, rtol, atol, f"gptq {name}", m=m,
                    k=ql.k, n=ql.n, gs=ql.group_size)
            worst = max(worst, err)
    ratio = errs["gptq"]["calibration_mse"] / errs["rtn"]["calibration_mse"]
    out = {"rows": GPTQ_ROWS, "hessian_s": hessian_s,
           "factor_s": factor_s, "codes_s": codes_s, "plan_pair_s": gptq_s,
           "rtn_plan_pair_s": rtn_s, "errors": errs,
           "calibration_mse_ratio": ratio, "k1_cases": rows,
           "launches": launches["gptq"],
           "k1_max_abs_err": worst}
    line("gptq", "qwen3-4b layer-0-shaped MLP pair at full width (up/gate "
         "{}x{} gs {}, down {}x{} gs {}), {} calibration rows on the card: "
         "Hessians {:.2f}s; plan_pair(use_gptq=True) {:.2f}s, of it the "
         "factors {} s (up, down, gate) and the codes {} s; RTN in the same "
         "orders {:.2f}s; output MSE on the calibration rows GPTQ {:.4g} "
         "vs RTN {:.4g} ({:.3f}x), held-out rows {:.4g} vs {:.4g}; the "
         "GPTQ pair through K1 (3 launches a forward) within 1e-5*max|ref|"
         "+1e-4 of its plain version at M 4 and {} (max_abs_err "
         "{:.3g})".format(
             d, ff, gs_up, ff, d, gs_down, GPTQ_ROWS, hessian_s, gptq_s,
             "/".join(f"{s:.2f}" for s in factor_s),
             "/".join(f"{s:.2f}" for s in codes_s), rtn_s,
             errs["gptq"]["calibration_mse"], errs["rtn"]["calibration_mse"],
             ratio, errs["gptq"]["held_out_mse"],
             errs["rtn"]["held_out_mse"], GPTQ_ROWS, worst))
    return out


def _effective_attention(engine) -> dict:
    """``engine``'s params with each layer's ``wv`` and ``wo`` replaced by
    its fold's effective dense weights (V's dequantized rows put back in
    the input's order; O's dequantized sorted rows): the dense attention
    then computes the fold's function."""
    layers = []
    for lp, vo in zip(engine.params["layers"], _layer_folds(engine)):
        wv = qz.dequantize(vo.up)
        back = torch.empty_like(wv)
        back[vo.p1_up.long()] = wv
        layers.append(dict(lp, attn=dict(lp["attn"], wv=back,
                                         wo=qz.dequantize(vo.down))))
    return dict(engine.params, layers=layers)


def _aux_bytes(aux) -> int:
    return sum(t.nbytes for t in checkpoint.flatten_keys(aux).values())


def phase_fold(dense_trace: dict) -> tuple[dict, tuple]:
    """Phase 25: qwen3-4b at full width, all 36 layers, with the attention
    fold: the port's ``prepare`` on the card, saved to a temporary
    directory, served from it; the four requests through the captured
    step, which launches K1 ``fold_launches`` times (the MLP's, and V and
    O in each layer); a few steps traced beside phase 6's dense step; the
    captured step against ``decode_eager`` bit for bit (16 lockstep and
    16 per-slot steps); and, with a float32 carry (the bfloat16 carry
    rounds the fold's V and output to bfloat16, as the reference's does,
    where dense float32 projections do not round), each layer's output on
    the same input carry within 1e-5 of max|.| + 1e-4 of the same layer
    with the fold's effective dense ``wv``/``wo`` (``layerwise``); the
    greedy ids of the served engine and the effective-weights engine
    reported.  Returns the results, and the float32-carry layer trace
    (carries, outputs) phase 26 is held to."""
    cfg = QWEN.with_quant(mode="mlp", scheme="tp-aware", backend="auto",
                          attn_tp_aware=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=1, seed=0, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    aux_bytes = _aux_bytes(art.aux)
    path, nbytes = _artifact_dir(list(art.rank_params) + [art.aux])
    try:
        t0 = time.perf_counter()
        art.save(path)
        save_s = time.perf_counter() - t0
        del art
        torch.cuda.empty_cache()
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        t0 = time.perf_counter()
        engine = make_engine(cfg, device="cuda", max_seq=32 + 16 + 1,
                             artifact=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path)
    folds = _layer_folds(engine)
    if engine.policy.backend != "cuda" or len(folds) != cfg.num_layers \
            or any(vo is None for vo in folds):
        raise AssertionError(f"fold: the engine serves {engine.policy} with "
                             f"{len(folds)} folds")
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    done, dt, step_ms = _run_steps(sched)
    counts = read_counts()
    steps, per = sched.steps, fold_launches(cfg)
    expect_counts(counts, {"dequant_matmul_ordered": per * steps},
                  f"fold ({steps} decode steps)")
    if engine.captures != 1 or sorted(done) != [0, 1, 2, 3] or any(
            len(r.output) != 16 for r in done.values()):
        raise AssertionError(f"fold: {engine.captures} captures, requests "
                             f"{ {k: r.output for k, r in done.items()} }")
    tokens = sum(len(r.output) for r in done.values())
    serve = {"decode_steps": steps, "launches": counts[
        "dequant_matmul_ordered"], "counts": counts, "run_s": dt,
        "tokens_per_s": tokens / dt, "first_step_ms": step_ms[0],
        "steady_ms_per_step": statistics.median(step_ms[1:]),
        "step_ms": step_ms, "decode_mode": engine.decode_mode,
        "outputs": {k: r.output for k, r in sorted(done.items())}}
    trace = phase_trace(engine, {"K1": _is_k1, "split-add": _is_split_add,
                                 "sgemm": _is_sgemm}, "trace-fold",
                        expect={"K1": per}, steps=2)
    # the wrappers' counts gate the launches (above); the step graph's
    # count is reported (torch.profiler has dropped a K1 event of this
    # step in all three of phase_trace's sessions in full runs)
    k1_device = trace["kernels"]["K1"]["launches_per_step"]
    captures, offsets, _ = _captured_vs_eager(engine, cfg, 16,
                                              "capture-fold")

    # layer by layer on one input carry, float32 carry
    f32 = build_model(cfg.with_(dtype="float32"))
    eff = Engine(model=f32, params=_effective_attention(engine),
                 device=engine.device, max_seq=engine.max_seq,
                 policy=engine.policy)
    fold32 = dataclasses.replace(engine, model=f32)
    toks = torch.from_numpy(_greedy_inputs(cfg)[0]).cuda()
    carries, outs = layer_trace(fold32, toks)
    refs = layer_outputs(eff, carries)
    lw = layerwise(outs, refs, "fold vs its effective dense weights")
    eff16 = dataclasses.replace(eff, model=engine.model)
    text, greedy = _greedy_compare(engine, eff16, cfg, "greedy 2 prompts x "
                                   "8 tokens, the fold (K1) vs its effective "
                                   "dense wv/wo (bfloat16 carry)",
                                   gate=False)
    d = dense_trace
    out = {"prepare_s": prepare_s, "prepare_peak_bytes": peak,
           "save_s": save_s, "load_s": load_s, "file_bytes": files,
           "reckoned_bytes": nbytes, "aux_bytes": aux_bytes,
           "aux_file_bytes": files.get("aux.npz"), "serve": serve,
           "trace": trace, "k1_device_launches_per_step": k1_device,
           "dense_trace": {
               k: d[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                 "busy_share", "kernels")},
           "capture": {"captures": captures, "offsets": offsets,
                       "bit_equal": True},
           "layerwise": lw, "greedy_vs_effective": greedy}
    k, dk1 = trace["kernels"], d["kernels"]
    line("fold", "{} with attn_tp_aware: prepared on the card in {:.2f}s "
         "(max_memory_allocated {:.2f} GiB; aux {:.3f} GB in memory, "
         "aux.npz {:.3f} GB), saved in {:.2f}s, loaded by "
         "make_engine(artifact=DIR) in {:.2f}s; 4 requests, {} tokens, "
         "{:.1f} tok/s, first step {:.1f} ms, then a median {:.2f} ms; "
         "dequant_matmul_ordered {} = {} x {} (decode step: {})".format(
             describe(cfg), prepare_s, peak / 2**30, aux_bytes / 1e9,
             files.get("aux.npz", 0) / 1e9, save_s, load_s, tokens,
             serve["tokens_per_s"], step_ms[0], serve["steady_ms_per_step"],
             counts["dequant_matmul_ordered"], per, steps,
             serve["decode_mode"]))
    line("fold", "captured step against the dense one (phase 6): wall "
         "{:.2f} vs {:.2f} ms, kernels {:.2f} vs {:.2f} ms, K1 {:.3f} ms in "
         "{:.2f} vs {:.3f} ms in {:.2f} (device kernels a step, "
         "torch.profiler), sgemm {:.3f} ms in {:.0f} vs {:.3f} "
         "ms in {:.0f}, split-add {:.3f} vs {:.3f} ms".format(
             trace["wall_ms_per_step"], d["wall_ms_per_step"],
             trace["device_ms_per_step"], d["device_ms_per_step"],
             k["K1"]["ms_per_step"], k["K1"]["launches_per_step"],
             dk1["K1"]["ms_per_step"], dk1["K1"]["launches_per_step"],
             k["sgemm"]["ms_per_step"], k["sgemm"]["launches_per_step"],
             dk1["sgemm"]["ms_per_step"], dk1["sgemm"]["launches_per_step"],
             k["split-add"]["ms_per_step"], dk1["split-add"]["ms_per_step"]))
    line("fold", f"captured step bit-equal to decode_eager over 16 "
         f"lockstep and 16 per-slot steps (captures {captures}); float32 "
         f"carry, layer by layer on the same input carries: the "
         f"{lw['layers']} layers through the fold (K1) within 1e-5 of "
         f"max|.| + 1e-4 of the effective dense wv/wo, worst "
         f"{lw['max_abs_err']:.3g} ({lw['max_rel_err']:.3g} of max|.|); "
         f"{text}")
    del engine, eff, eff16, fold32, sched
    torch.cuda.empty_cache()
    return out, ([c.cpu() for c in carries[:FOLD_TP_LAYERS]],
                 [o.cpu() for o in outs[:FOLD_TP_LAYERS]])


def _fold_tp_rank(ctx, cfg, path, carries) -> dict:
    """One rank of phase 26: read this rank's file and the aux, serve the
    four requests under the artifact's tuned plan with the counts set to
    0 just before and read just after, then each layer's float32-carry
    output under psum on ``carries``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
        path)).policy(backend="auto", device=ctx.device)
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=ctx.device, max_seq=32 + 16 + 1,
                         group=ctx.group, policy=plan, artifact=path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    f32 = dataclasses.replace(
        engine, model=build_model(cfg.with_(dtype="float32")),
        policy=engine.policy.with_(collective="psum"))
    vo = _layer_folds(engine)[0]
    return {"rank": ctx.rank, "load_s": load_s, "run_s": run_s,
            "stats": dataclasses.asdict(engine.load_stats),
            "decode_steps": sched.steps, "counts": counts,
            "collective": engine.policy.collective.shorthand(),
            "decode_mode": engine.decode_mode,
            "fold_shapes": [tuple(vo.up.qweight.shape),
                            tuple(vo.down.qweight.shape)],
            "outputs": {k: r.output for k, r in sorted(done.items())},
            "layer_outputs": [o.cpu() for o in layer_outputs(f32, carries)]}


def phase_fold_tp(tp1: tuple) -> dict:
    """Phase 26: ``prepare --autotune-collectives`` with the fold at tp=2
    (full width, depth cut to ``FOLD_TP_LAYERS``; the cut printed): the
    tuned sites' choices printed as the CLI prints them, the rank files
    and the aux saved, and served on two rank processes over gloo, each
    reading its own file and the whole aux and keeping its heads of the
    fold: the four requests' ids equal on both ranks, K3 launched where
    the tuner marked the MLP ``:fused`` (one a layer a step) and K1 for the
    other MLP GEMMs and V and O; then, with a float32 carry under psum,
    each layer's output on phase 25's tp=1 input carries within 1e-5 of
    max|.| + 1e-4 of its tp=1 output (the tp=2 plan is the tp=1 plan
    sharded: the same seed streams, and a prefix of layers is a prefix of
    the plan)."""
    full = QWEN.num_layers
    cfg = QWEN.with_(num_layers=FOLD_TP_LAYERS).with_quant(
        mode="mlp", scheme="tp-aware", backend="auto", attn_tp_aware=True)
    line("fold-tp", f"full width, depth cut from {full} to "
         f"{cfg.num_layers} layers (the files' save and load and the gloo "
         f"step dominate the phase)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=TP, seed=0, device="cuda", autotune=True)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    report = art.manifest["collective_tuner"]
    for site in report:
        line("fold-tp", f"  tuned {site['path']} [{site['kind']}]: "
             f"{site['chosen']} ({site['status']})")
    sites = {s["path"]: s for s in report}
    if set(sites) != {"layers.mlp", "layers.attn"} or any(
            s["status"] != "tuned" for s in report):
        raise AssertionError(f"fold-tp: tuner report {report}")
    path, nbytes = _artifact_dir(list(art.rank_params) + [art.aux])
    planted, started = None, ()
    try:
        t0 = time.perf_counter()
        art.save(path)
        save_s = time.perf_counter() - t0
        del art
        torch.cuda.empty_cache()
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        planted = _planted_copy(path)
        started = (_verify_start(path), _verify_start(planted))
        ranks = POOL.run(_fold_tp_rank, cfg, path, tp1[0], timeout=600)
        verify = {
            "clean": _verify_finish(started[0], "fold-tp",
                                    f"{describe(cfg)} tp=2 tuned fold"),
            "planted": _verify_finish(
                started[1], "fold-tp", "of a planted copy (rank files "
                "linked; rank_01.npz renamed rank_05.npz, plan glob "
                "'bogus.*' added)", want_exit=1, want=PLANTED)}
    finally:
        _verify_stop(*started)
        shutil.rmtree(path)
        if planted is not None:
            shutil.rmtree(planted, ignore_errors=True)
    fused = sites["layers.mlp"]["fused"]
    k3_per = cfg.num_layers if fused else 0
    k1_per = fold_launches(cfg) - k3_per
    r0 = ranks[0]
    for r in ranks:
        steps = r["decode_steps"]
        expect_counts(r["counts"], {
            "dequant_matmul_wire_ordered": k3_per * steps,
            "dequant_matmul_ordered": k1_per * steps},
            f"fold-tp rank {r['rank']} ({steps} decode steps)")
        if r["outputs"] != r0["outputs"] or steps != r0["decode_steps"]:
            raise AssertionError("fold-tp: the ranks emitted different "
                                 "tokens")
        if r["stats"]["aux_bytes_loaded"] != files["aux.npz"]:
            raise AssertionError(f"fold-tp rank {r['rank']}: read "
                                 f"{r['stats']}")
    lw = [layerwise(r["layer_outputs"], tp1[1],
                    f"fold psum tp=2 rank {r['rank']} vs tp=1")
          for r in ranks]
    out = {"layers": cfg.num_layers, "full_layers": full,
           "prepare_s": prepare_s, "save_s": save_s, "file_bytes": files,
           "reckoned_bytes": nbytes, "tuner": report,
           "collective": r0["collective"],
           "load_s": [r["load_s"] for r in ranks],
           "ms_per_step": [r["run_s"] / r["decode_steps"] * 1e3
                           for r in ranks],
           "decode_steps": r0["decode_steps"],
           "counts": [r["counts"] for r in ranks],
           "load_stats": [r["stats"] for r in ranks],
           "fold_shapes": r0["fold_shapes"], "outputs": r0["outputs"],
           "layerwise": lw, "verify": verify}
    line("fold-tp", "{} tp=2 tuned ({}) prepared on the card in {:.2f}s, "
         "saved in {:.2f}s ({}); each rank read its own file and the whole "
         "aux.npz ({} bytes) and kept its heads of the fold (V {} and O {} "
         "packed words), loaded in {} s; 4 requests: ids equal on both "
         "ranks, {:.1f} ms/step (rank 0; decode step: {}); per rank "
         "dequant_matmul_wire_ordered {} = {} x {} and dequant_matmul_"
         "ordered {} = {} x {}; psum, float32 carry, layer by layer on the "
         "tp=1 fold's carries: the {} layers within 1e-5 of max|.| + 1e-4 "
         "on both ranks, worst {}".format(
             describe(cfg), r0["collective"], prepare_s, save_s,
             ", ".join(f"{f} {b / 1e9:.3f} GB" for f, b in files.items()
                       if b > 2**20), files["aux.npz"],
             r0["fold_shapes"][0], r0["fold_shapes"][1],
             "/".join(f"{s:.2f}" for s in out["load_s"]),
             out["ms_per_step"][0], r0["decode_mode"],
             r0["counts"]["dequant_matmul_wire_ordered"], k3_per,
             r0["decode_steps"], r0["counts"]["dequant_matmul_ordered"],
             k1_per, r0["decode_steps"], lw[0]["layers"],
             "/".join(f"{x['max_abs_err']:.3g}" for x in lw)))
    return out

# ---------------------------------------------------------------------------
# phases 27-28: the :overlap epilogue at tp=2 and the dp2xtp2 grid
# ---------------------------------------------------------------------------

def microbatches(m: int, gs: int) -> int:
    """Row microbatches a pipelined down GEMM of ``m`` float32 rows on K1
    or K3 runs in: two where ``dist/overlap.split_rows`` splits under the
    kernels' loop rule (``kernels.dispatch.main_loop``), else one."""
    def loop(rows):
        return dk.takes_tensor_cores(rows, gs, torch.float32)

    return 1 if overlap.split_rows((m,), loop) is None else 2


def overlap_launches(cfg, m: int, fused: bool) -> dict:
    """K3 and K1 launches of one tp=2 decode step of ``m`` slots per rank
    under an ``:overlap`` ring on every MLP: up (and gate) whole, the down
    projection once per microbatch, on K3 where ``fused``."""
    mb = microbatches(m, mlp_shapes(cfg, TP)[1][3]) * cfg.num_layers
    col = (2 if cfg.mlp_gated else 1) * cfg.num_layers
    return {"dequant_matmul_wire_ordered": mb if fused else 0,
            "dequant_matmul_ordered": col + (0 if fused else mb)}


def _without(coll, flag: str):
    """``coll`` (a spec or a per-layer plan) with ``:flag`` taken off."""
    return parse_collective(coll.shorthand().replace(f":{flag}", ""))


def _mesh_batch(cfg) -> tuple[np.ndarray, np.ndarray]:
    """``serve --mesh``'s lockstep batch: ``MESH_BATCH`` prompts of
    ``MESH_PLEN`` tokens from seed 0 (the CLI's rule at --prompt-budget
    16)."""
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(MESH_BATCH, MESH_PLEN))
    return tokens, np.full((MESH_BATCH,), MESH_PLEN)


def _check_halves(gen) -> dict:
    """K1 and K3 (int8 and int4 wires) at the tp=2 down shard on a
    microbatch pair's halves against the whole call, at M 2 and 4 (the
    decode loop: phase 28's and phase 27's steps), 2 t + 88 (the large-M
    loop from t = kTcMinM, halves too) and t + 44 (whole on the large-M
    loop, halves on the decode loop: ``split_rows`` must refuse it;
    whether the halves would have differed is reported).  Returns each
    M's record and which M are the straddling and the large one."""
    _, k, n, gs = DOWN_TP
    ql = _quantized(gen, k, n, gs).ordered
    pol = ExecutionPolicy(backend="cuda")
    loop = kdispatch.main_loop(ql, pol, torch.device("cuda"))
    t = dk.tensor_core_min_m()
    straddle, large = t + 44, 2 * t + 88
    out = {}
    for m in (2, 4, straddle, large):
        x = torch.randn(m, k, generator=gen, device="cuda")
        split = overlap.split_rows((m,), loop)
        m0 = m // 2 if split is None else split[1]
        rows = (x[:m0], x[m0:])
        equal = {"K1": torch.equal(
            kdispatch.qmatmul(x, ql, pol),
            torch.cat([kdispatch.qmatmul(r, ql, pol) for r in rows]))}
        for short in ("quant-int8:128", "quant-int4:32"):
            spec = parse_collective(short)
            whole = kdispatch.qmatmul_wire(x, ql, pol, spec=spec, tp=TP)
            parts = [kdispatch.qmatmul_wire(r, ql, pol, spec=spec, tp=TP)
                     for r in rows]
            equal[f"K3 {short}"] = all(
                torch.equal(torch.cat([getattr(p, f) for p in parts]),
                            getattr(whole, f))
                for f in ("payload", "scales", "zeros")
                if getattr(whole, f) is not None)
        out[m] = {"split": split, "halves_bit_equal": equal}
        if split is not None and not all(equal.values()):
            raise AssertionError(f"overlap-tp: M={m} split at {m0}: "
                                 f"halves differ from the whole: {equal}")
    if out[straddle]["split"] is not None or any(
            out[m]["split"] is None for m in (2, 4, large)):
        raise AssertionError(f"overlap-tp: split rule {out}")
    return {"cases": out, "straddle": straddle, "large": large}


def _library_rows(gen) -> dict:
    """The library's float32 GEMM (``torch.matmul``, which the step runs
    for attention's projections and the head) at qwen3-4b's tp=2 decode
    shapes: whether the rows of two M=2 calls equal those of one M=4
    call, bit for bit (phase 28's grid runs M=2 where the dp1 engine runs
    M=4)."""
    h, kvh, hd = QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim
    d = QWEN.d_model
    out = {}
    for name, k, n in (("wq", d, h * hd // TP), ("wk", d, kvh * hd // TP),
                       ("wo", h * hd // TP, d),
                       ("head", d, QWEN.vocab_size // TP)):
        x = torch.randn(MESH_BATCH, 1, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        half = MESH_BATCH // 2
        out[name] = torch.equal(torch.cat([x[:half] @ w, x[half:] @ w]),
                                x @ w)
    return out


def _steps(engine):
    """A runner of ``OVERLAP_TRACE_STEPS`` decode steps of ``engine`` (4
    slots, the cache half full), synchronized at the end."""
    cache = engine.init_cache(MESH_BATCH)
    tokens = torch.arange(MESH_BATCH, device=engine.device)
    pos = torch.full((MESH_BATCH,), 24, device=engine.device)

    def run():
        for i in range(OVERLAP_TRACE_STEPS):
            engine.decode(cache, tokens, pos + i)
        torch.cuda.synchronize()

    return run


def _alternating_wall(engines: dict) -> dict:
    """Wall ms a decode step of the ``sync`` and the ``overlap`` engine
    (no profiler), in ``OVERLAP_WALL_BLOCKS`` blocks of
    ``OVERLAP_TRACE_STEPS`` steps in the order sync, overlap, overlap,
    sync, ... (each first as often as second), after a warm-up block
    each; and ``overlap.stats`` over the overlap blocks."""
    runs = {k: _steps(e) for k, e in engines.items()}
    for run in runs.values():
        run()
    order = ["sync", "overlap", "overlap", "sync"] * (OVERLAP_WALL_BLOCKS
                                                      // 4)
    blocks = {k: [] for k in runs}
    overlap.stats.reset()
    for k in order:
        t0 = time.perf_counter()
        runs[k]()
        blocks[k].append((time.perf_counter() - t0) * 1e3
                         / OVERLAP_TRACE_STEPS)
    return {"blocks": blocks, "sites": overlap.stats.sites,
            "in_flight": overlap.stats.in_flight}


def _windows(prof, kind: str) -> dict | None:
    """The ring windows of a traced run and how many hold a down-GEMM
    kernel (K3 or K1) wholly on the device timeline, or None when a
    window's ranges are missing.  ``kind`` "overlap": a pipelined site's
    window runs from the start of its ``overlap.post mb0`` range to the
    end of its ``overlap.wait mb0`` range; "sync": each
    ``c10d::alltoall_base_`` call of the synchronous ring."""
    cpu, gemms = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA"):
            if _is_k3(e.name) or _is_k1(e.name):
                gemms.append(span)
        else:
            cpu.append((e.name, span))
    if kind == "overlap":
        posts = sorted(a for name, (a, _) in cpu
                       if name == "overlap.post mb0")
        waits = sorted(b for name, (_, b) in cpu
                       if name == "overlap.wait mb0")
        sites = sum(name == "overlap.post mb1" for name, _ in cpu)
        wins = list(zip(posts, waits))
        if len(posts) != len(waits) or sites != len(wins):
            return None
    else:
        wins = [span for name, span in cpu if name == "c10d::alltoall_base_"]
        sites = len(wins)
    steps = OVERLAP_TRACE_STEPS
    return {"windows_per_step": len(wins) / steps,
            "pipelined_sites_per_step": sites / steps,
            "spanning_per_step": sum(any(a <= s and t <= b
                                         for s, t in gemms)
                                     for a, b in wins) / steps,
            "gemm_kernels_per_step": len(gemms) / steps}


def _ring_windows(engine, ctx, kind: str) -> dict | None:
    """``OVERLAP_TRACE_STEPS`` decode steps of ``engine`` on every rank,
    rank 0 under torch.profiler (CPU and CUDA), after a warm-up run; the
    run is repeated (at most three times) only while rank 0's trace
    lacks a window's ranges (profiler sessions have dropped events) or,
    for ``:overlap``, shows a pipelined window without a down GEMM, which
    rank 0 tells the others through the ring's group.  On the device
    mb1's GEMM ends before the host's copy of its payload in
    ``overlap.post mb1``, so before ``overlap.wait mb0`` starts: a trace
    that places it outside the window misplaces the device's timestamps
    against the host's.  Rank 0
    returns ``_windows``' of its last trace, with the traces taken and
    each earlier one's record."""
    from torch.profiler import ProfilerActivity, profile

    run = _steps(engine)
    run()
    out, earlier = None, []
    for _ in range(3):
        if ctx.rank == 0:
            if out is not None:
                earlier.append(out)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
            out = _windows(prof, kind)
        else:
            run()
        whole = out is not None and (
            kind != "overlap"
            or out["spanning_per_step"] == out["pipelined_sites_per_step"])
        have = torch.tensor([float(whole)], device=ctx.device)
        if comm.raw_psum(have, ctx.group).item() > 0:
            break
    if ctx.rank == 0 and out is None:
        raise AssertionError(f"overlap-tp: no {kind} trace held every "
                             f"window's ranges")
    if ctx.rank == 0:
        out["traces"] = len(earlier) + 1
        out["earlier"] = earlier
    return out


def _overlap_tp_rank(ctx, cfg, path, tokens, plen) -> dict:
    """One rank of phase 27: read this rank's file, serve the four requests
    under the tuned ``:overlap`` plan with the counts set to 0 just before
    and read just after (and ``overlap.stats``); greedy traces of the
    lockstep batch under the plan, under it without ``:overlap``, and
    both without ``:fused`` (each with its counts), and of the batch two
    rows at a time with and without ``:overlap`` (phase 28's rows); the
    ring windows of traced steps, with and without ``:overlap``; the
    steps' wall time, alternating."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
        path)).policy(backend="auto", device=ctx.device)
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=ctx.device, max_seq=32 + 16 + 1,
                         group=ctx.group, policy=plan, artifact=path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sched = Scheduler(engine, max_batch=4, prompt_budget=32,
                      scfg=SamplingConfig(temperature=0.8, top_k=40), seed=0)
    _submit_requests(sched, cfg)
    reset_counts()
    overlap.stats.reset()
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    served = {"sites": overlap.stats.sites,
              "in_flight": overlap.stats.in_flight}
    coll = engine.policy.collective

    def variant(c):
        return dataclasses.replace(engine,
                                   policy=engine.policy.with_(collective=c))

    engines = {"overlap": engine,
               "sync": variant(_without(coll, "overlap")),
               "overlap unfused": variant(_without(coll, "fused")),
               "sync unfused": variant(_without(_without(coll, "fused"),
                                                "overlap"))}
    toks = torch.from_numpy(tokens).to(ctx.device)
    pl = torch.from_numpy(plen).to(ctx.device)
    traces = {}
    for name, eng in engines.items():
        reset_counts()
        ids, logits = _greedy_trace(eng, toks, pl, MESH_NEW)
        traces[name] = {"ids": ids.cpu(), "logits": logits.cpu(),
                        "counts": read_counts()}
    # the batch as phase 28's data ranks split it, on this dp1 engine
    half = MESH_BATCH // 2
    for name in ("overlap", "sync"):
        reset_counts()
        parts = [_greedy_trace(engines[name], toks[i:i + half],
                               pl[i:i + half], MESH_NEW) for i in (0, half)]
        traces[f"{name} halves"] = {
            "ids": torch.cat([p[0] for p in parts]).cpu(),
            "logits": torch.cat([p[1] for p in parts]).cpu(),
            "counts": read_counts()}
    windows = {"sync": _ring_windows(engines["sync"], ctx, "sync"),
               "overlap": _ring_windows(engine, ctx, "overlap")}
    wall = _alternating_wall({k: engines[k] for k in ("sync", "overlap")})
    return {"rank": ctx.rank, "transport": ctx.transport, "load_s": load_s,
            "run_s": run_s, "stats": dataclasses.asdict(engine.load_stats),
            "decode_steps": sched.steps, "counts": counts, "served": served,
            "collective": coll.shorthand(),
            "decode_mode": engine.decode_mode,
            "outputs": {k: r.output for k, r in sorted(done.items())},
            "traces": traces, "windows": windows, "wall": wall}


def _wall_summary(wall: dict) -> dict:
    """The alternating blocks' medians, overlap over sync, and in how many
    adjacent (sync, overlap) block pairs overlap was the slower."""
    b = wall["blocks"]
    med = {k: statistics.median(v) for k, v in b.items()}
    return {"median_ms": med, "ratio": med["overlap"] / med["sync"],
            "pairs_overlap_slower": sum(o > y for y, o in zip(b["sync"],
                                                              b["overlap"])),
            "pairs": len(b["sync"])}


def phase_overlap_tp(gen) -> tuple[dict, str, dict]:
    """Phase 27: qwen3-4b at full width, depth cut to ``OVERLAP_LAYERS``
    (printed), ``prepare --autotune-collectives --overlap-collectives`` at
    tp=2 (``compiler.prepare(autotune=True, tune_overlap=True)``) on the
    card, saved, and served from the rank files on two rank processes
    over gloo via host: the tuned MLP carries ``:overlap``; the four
    requests' ids equal on both ranks; K3 and K1 launches a decode step
    per rank as ``overlap_launches`` counts them from the config (the
    down projection once per microbatch); every pipelined site of the
    serve recorded by ``overlap.stats``, and mb0's ring still in flight
    once mb1's GEMM was launched at some of them (reported, at least
    one); greedy logits of the lockstep batch bit-equal to the same plan
    without ``:overlap``, fused and unfused (K1 then runs the down
    projection per microbatch), and two rows at a time (phase 28's
    rows) too; the plan without ``:overlap`` two rows at a time against
    four (the step's own dependence on M, phase 28's witness); every
    pipelined site's mb0 window holds a down-GEMM kernel in every traced
    step, and no window of the synchronous ring does; the steps' wall
    time, alternating; K1 and K3 at the halves bit-equal to the whole
    (``_check_halves``); the library GEMM's rows at M 2 against M 4
    (``_library_rows``).  Returns the phase's record, the artifact's
    directory (phase 28 serves it; the caller removes it) and rank 0's
    greedy traces (phase 28's references)."""
    full = QWEN.num_layers
    cfg = QWEN.with_(num_layers=OVERLAP_LAYERS).with_quant(
        mode="mlp", scheme="tp-aware", backend="auto")
    line("overlap-tp", f"full width, depth cut from {full} to "
         f"{cfg.num_layers} layers (the files' save and load and the gloo "
         f"step dominate the phase)")
    halves = _check_halves(gen)
    library = _library_rows(gen)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=TP, seed=0, device="cuda", autotune=True,
                           tune_overlap=True)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    report = art.manifest["collective_tuner"]
    for site in report:
        line("overlap-tp", f"  tuned {site['path']} [{site['kind']}]: "
             f"{site['chosen']} ({site['status']})")
    mlp = {s["path"]: s for s in report}.get("layers.mlp")
    if (mlp is None or mlp["status"] != "tuned" or not mlp["overlap"]
            or not mlp["chosen"].endswith(":overlap")):
        raise AssertionError(f"overlap-tp: tuner report {report}")
    path, nbytes = _artifact_dir(art.rank_params)
    try:
        t0 = time.perf_counter()
        art.save(path)
        save_s = time.perf_counter() - t0
        del art
        torch.cuda.empty_cache()
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        tokens, plen = _mesh_batch(cfg)
        ranks = mesh.run(_overlap_tp_rank, TP, cfg, path, tokens, plen,
                         device_type="cuda", timeout=600)
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    fused = parse_collective(mlp["chosen"]).fused
    want = overlap_launches(cfg, MESH_BATCH, fused)
    steps_greedy = MESH_PLEN + MESH_NEW - 1
    r0 = ranks[0]
    for r in ranks:
        steps = r["decode_steps"]
        expect_counts(r["counts"], {k: v * steps for k, v in want.items()},
                      f"overlap-tp rank {r['rank']} ({steps} decode steps)")
        if r["served"]["sites"] != cfg.num_layers * steps:
            raise AssertionError(f"overlap-tp rank {r['rank']}: "
                                 f"{r['served']} pipelined sites in {steps} "
                                 f"steps of {cfg.num_layers} layers")
        if r["outputs"] != r0["outputs"] or steps != r0["decode_steps"]:
            raise AssertionError("overlap-tp: the ranks emitted different "
                                 "tokens")
        t = r["traces"]
        for a, b in (("overlap", "sync"),
                     ("overlap unfused", "sync unfused"),
                     ("overlap halves", "sync halves")):
            if not (torch.equal(t[a]["logits"], t[b]["logits"])
                    and torch.equal(t[a]["ids"], t[b]["ids"])):
                gap = (t[a]["logits"] - t[b]["logits"]).abs().max().item()
                raise AssertionError(
                    f"overlap-tp rank {r['rank']}: {a} differs from {b}: "
                    f"max |logit gap| {gap:.3g}")
            if not torch.equal(t[a]["ids"], r0["traces"][a]["ids"]):
                raise AssertionError(f"overlap-tp: {a} ids differ between "
                                     f"ranks")
        for name, fz, m, n in (
                ("overlap", fused, MESH_BATCH, 1),
                ("overlap unfused", False, MESH_BATCH, 1),
                ("overlap halves", fused, MESH_BATCH // 2, 2)):
            expect_counts(t[name]["counts"], {
                k: v * steps_greedy * n
                for k, v in overlap_launches(cfg, m, fz).items()},
                f"overlap-tp rank {r['rank']} greedy {name}")
    witness = {k: sum(r["served"][k] + r["wall"][k] for r in ranks)
               for k in ("sites", "in_flight")}
    if not witness["in_flight"]:
        raise AssertionError(f"overlap-tp: mb0's ring had completed before "
                             f"mb1's GEMM was launched at every site "
                             f"({witness})")
    t0r = r0["traces"]
    # the step's own dependence on M, without :overlap
    sync_m = _batch_agreement(t0r["sync halves"]["ids"],
                              t0r["sync halves"]["logits"],
                              t0r["sync"]["ids"], t0r["sync"]["logits"],
                              "overlap-tp: the synchronous plan at M=2")
    win = r0["windows"]
    ov, sy = win["overlap"], win["sync"]
    if not (ov["pipelined_sites_per_step"] == cfg.num_layers
            and ov["spanning_per_step"] == ov["pipelined_sites_per_step"]):
        raise AssertionError(f"overlap-tp: ring windows {ov}")
    if sy["windows_per_step"] < cfg.num_layers or sy["spanning_per_step"]:
        raise AssertionError(f"overlap-tp: synchronous windows {sy}")
    k1_down = {name: t0r[name]["counts"]["dequant_matmul_ordered"]
               - (2 if cfg.mlp_gated else 1) * cfg.num_layers * steps_greedy
               for name in ("overlap unfused", "sync unfused")}
    walls = [_wall_summary(r["wall"]) for r in ranks]
    straddled = halves["cases"][halves["straddle"]]["halves_bit_equal"]
    out = {"layers": cfg.num_layers, "full_layers": full,
           "prepare_s": prepare_s, "save_s": save_s, "file_bytes": files,
           "reckoned_bytes": nbytes, "tuner": report,
           "collective": r0["collective"], "halves": halves,
           "library_rows_m2_vs_m4": library,
           "load_s": [r["load_s"] for r in ranks],
           "ms_per_step": [r["run_s"] / r["decode_steps"] * 1e3
                           for r in ranks],
           "decode_steps": r0["decode_steps"],
           "launches_per_step": want,
           "counts": [r["counts"] for r in ranks],
           "greedy_counts": {k: v["counts"] for k, v in t0r.items()},
           "k1_down_launches_greedy": k1_down,
           "greedy_steps": steps_greedy,
           "load_stats": [r["stats"] for r in ranks],
           "outputs": r0["outputs"], "windows": win,
           "in_flight": {"served": [r["served"] for r in ranks],
                         "wall": [{k: r["wall"][k]
                                   for k in ("sites", "in_flight")}
                                  for r in ranks]},
           "sync_m2_vs_m4": sync_m,
           "wall_blocks_ms": [r["wall"]["blocks"] for r in ranks],
           "wall": walls,
           "transport": r0["transport"], "decode_mode": r0["decode_mode"]}
    served = [r["served"] for r in ranks]
    line("overlap-tp", "{} tp=2 tuned ({}) prepared on the card in {:.2f}s, "
         "saved in {:.2f}s ({}); {}; 4 requests: ids equal on both ranks, "
         "{:.1f} ms/step (rank 0; decode step: {}); per rank and step K3 {} "
         "and K1 {} (the down projection in {} microbatches of {} rows); "
         "mb0's ring still in flight once mb1's GEMM was launched at {} of "
         "{} pipelined sites of the serve (ranks 0/1) and {} of {} of the "
         "timed steps; greedy {}x{} lockstep batch: logits bit-equal to the "
         "plan without :overlap, fused and unfused (K1's down launches {} "
         "and {}), and two rows at a time; ring windows a traced step "
         "(trace {} of at most 3; earlier ones' holding {}): "
         "{:.0f} pipelined sites, {:.0f} holding a down GEMM, the "
         "synchronous ring's {:.0f} windows holding {:.0f}; wall ms a step "
         "(no profiler, {} alternating blocks of {} steps) sync {:.1f}, "
         "overlap {:.1f}: overlap/sync {:.3f}, overlap slower in {} of {} "
         "block pairs (rank 0; rank 1 {:.3f}, {} of {}); halves bit-equal "
         "at M 2, 4 and {} (K1, K3), M {} not split (its halves {})".format(
             describe(cfg), r0["collective"], prepare_s, save_s,
             ", ".join(f"{f} {b / 1e9:.3f} GB" for f, b in files.items()
                       if b > 2**20), r0["transport"],
             out["ms_per_step"][0], r0["decode_mode"],
             want["dequant_matmul_wire_ordered"],
             want["dequant_matmul_ordered"],
             microbatches(MESH_BATCH, mlp_shapes(cfg, TP)[1][3]),
             MESH_BATCH // 2,
             "/".join(str(x["in_flight"]) for x in served),
             "/".join(str(x["sites"]) for x in served),
             "/".join(str(r["wall"]["in_flight"]) for r in ranks),
             "/".join(str(r["wall"]["sites"]) for r in ranks),
             MESH_BATCH, MESH_PLEN,
             k1_down["overlap unfused"], k1_down["sync unfused"],
             ov["traces"], "/".join(f"{e['spanning_per_step']:.0f}"
                                    for e in ov["earlier"]) or "none",
             ov["pipelined_sites_per_step"], ov["spanning_per_step"],
             sy["windows_per_step"], sy["spanning_per_step"],
             OVERLAP_WALL_BLOCKS, OVERLAP_TRACE_STEPS,
             walls[0]["median_ms"]["sync"], walls[0]["median_ms"]["overlap"],
             walls[0]["ratio"], walls[0]["pairs_overlap_slower"],
             walls[0]["pairs"], walls[1]["ratio"],
             walls[1]["pairs_overlap_slower"], walls[1]["pairs"],
             halves["large"], halves["straddle"],
             "bit-equal" if all(straddled.values())
             else "would differ: " + ", ".join(
                 k for k, v in straddled.items() if not v)))
    line("overlap-tp", "the step's own dependence on M (phase 28's "
         "witness): the plan without :overlap, two rows at a time against "
         "four: ids {}, logit gap {:.3g} (max|logit| {:.3g}); the library's "
         "float32 GEMM, rows of two M=2 calls against an M=4 call at the "
         "tp=2 shapes: {}".format(
             "equal" if sync_m["ids_agree"] else
             f"apart from {sync_m['first_divergence']} on a near tie",
             sync_m["max_logit_gap"], sync_m["max_logit"],
             ", ".join(f"{k} {'bit-equal' if v else 'differ'}"
                       for k, v in library.items())))
    return out, path, {k: t0r[k] for k in ("overlap", "overlap halves")}


def _mesh_dp_rank(ctx, cfg, path, tokens, plen) -> dict:
    """One process of phase 28: its row's engine from its own rank file,
    the policy naming the grid; its data rank's rows of the lockstep
    batch, greedy, with the counts set to 0 just before and read just
    after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
        path)).policy(backend="auto", device=ctx.device).with_(
            mesh=MeshPlan(dp=ctx.dp, tp=ctx.tp))
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=ctx.device, max_seq=32 + 16 + 1,
                         group=ctx.group, policy=plan, artifact=path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lo = ctx.dp_rank * MESH_BATCH // ctx.dp
    hi = (ctx.dp_rank + 1) * MESH_BATCH // ctx.dp
    toks = torch.from_numpy(tokens[lo:hi]).to(ctx.device)
    pl = torch.from_numpy(plen[lo:hi]).to(ctx.device)
    reset_counts()
    t0 = time.perf_counter()
    ids, logits = _greedy_trace(engine, toks, pl, MESH_NEW)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    return {"process": ctx.process, "dp_rank": ctx.dp_rank,
            "rank": ctx.rank, "rows": (lo, hi), "ids": ids.cpu(),
            "logits": logits.cpu(), "counts": read_counts(),
            "run_s": run_s, "load_s": load_s,
            "stats": dataclasses.asdict(engine.load_stats),
            "mesh": engine.policy.mesh.shorthand(),
            "transport": ctx.transport,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _batch_agreement(ids, logits, ref_ids, ref_logits,
                     what: str = "mesh-dp: the grid") -> dict:
    """Greedy ids of a run against a reference run of other batch shapes
    (the card's library GEMMs may sum a row in another order at another
    M): the first step where they differ, the largest logit gap up to it
    (both runs fed the same tokens until then) and the reference's top-2
    margin there.  A difference must be a near tie: a margin within the
    gap."""
    diff = (ids != ref_ids).nonzero()
    upto = ids.shape[1] if not len(diff) else int(diff[:, 1].min()) + 1
    gap = (logits[:, :upto] - ref_logits[:, :upto]).abs().max().item()
    out = {"ids_agree": not len(diff), "max_logit_gap": gap,
           "max_logit": ref_logits.abs().max().item()}
    if len(diff):
        first = diff[diff[:, 1].argmin()].tolist()
        top2 = ref_logits[tuple(first)].topk(2).values
        out.update(first_divergence=first,
                   top2_margin=(top2[0] - top2[1]).item())
        if out["top2_margin"] > gap:
            raise AssertionError(f"{what}'s ids differ from the whole "
                                 f"batch's beyond a near tie: {out}")
    return out


def phase_mesh_dp(path: str, ref: dict, sync_m: dict) -> dict:
    """Phase 28: the ``dp2xtp2`` grid, four processes on the card (gloo
    via host), from phase 27's tp=2 rank files: each row of two
    processes an engine of its own over its data rank's two rows of the
    lockstep batch, each process reading only its model-axis rank file;
    K3 and K1 launches per process from the config; the greedy ids and
    logits row for row bit-equal to phase 27's ``dp1xtp2`` engine on the
    same rows two at a time (``ref["overlap halves"]``), and, against its
    whole 4-row batch (``ref["overlap"]``), ids equal or apart only after
    a near tie (the step's own dependence on M: ``sync_m``, phase 27's
    plan without ``:overlap`` two rows at a time against four, is
    printed beside it); resident bytes and tokens/s reported."""
    cfg = QWEN.with_(num_layers=OVERLAP_LAYERS).with_quant(
        mode="mlp", scheme="tp-aware", backend="auto")
    plan = MeshPlan(dp=2, tp=TP)
    tokens, plen = _mesh_batch(cfg)
    t0 = time.perf_counter()
    procs = mesh.run(_mesh_dp_rank, TP, cfg, path, tokens, plen, dp=plan.dp,
                     device_type="cuda", timeout=600)
    wall_s = time.perf_counter() - t0
    fused = parse_collective(DeploymentArtifact.load_manifest(path)[
        "policy"]["collective"]).resolve("layers.mlp").fused
    rows = MESH_BATCH // plan.dp
    steps = MESH_PLEN + MESH_NEW - 1
    want = overlap_launches(cfg, rows, fused)
    halves = ref["overlap halves"]
    for p in procs:
        expect_counts(p["counts"], {k: v * steps for k, v in want.items()},
                      f"mesh-dp process {p['process']} ({steps} steps)")
        st = p["stats"]
        if (p["mesh"] != plan.shorthand() or st["ranks"] != (p["rank"],)
                or p["rank"] != p["process"] % TP
                or not st["file_bytes_loaded"] < st["file_bytes_total"]):
            raise AssertionError(f"mesh-dp process {p['process']}: "
                                 f"{p['mesh']} read {st}")
        lo, hi = p["rows"]
        if not (torch.equal(p["ids"], halves["ids"][lo:hi])
                and torch.equal(p["logits"], halves["logits"][lo:hi])):
            raise AssertionError(
                f"mesh-dp process {p['process']}: rows {lo}-{hi - 1} differ "
                f"from the dp1xtp2 engine's on the same rows: ids "
                f"{p['ids'].tolist()} against "
                f"{halves['ids'][lo:hi].tolist()}")
    mine = [p for p in procs if p["rank"] == 0]
    whole = _batch_agreement(
        torch.cat([p["ids"] for p in mine]),
        torch.cat([p["logits"] for p in mine]), ref["overlap"]["ids"],
        ref["overlap"]["logits"])
    tok_s = [p["ids"].numel() / p["run_s"] for p in procs]
    out = {"mesh": plan.shorthand(), "transport": procs[0]["transport"],
           "launches_per_step": want, "steps": steps,
           "counts": [p["counts"] for p in procs],
           "load_stats": [p["stats"] for p in procs],
           "load_s": [p["load_s"] for p in procs],
           "run_s": [p["run_s"] for p in procs], "wall_s": wall_s,
           "tok_s": tok_s,
           "batch_tok_s": MESH_BATCH * MESH_NEW / max(
               p["run_s"] for p in procs),
           "peak_bytes": [p["peak_bytes"] for p in procs],
           "whole_batch": whole, "sync_m2_vs_m4": sync_m}
    line("mesh-dp", "{} ({}) from phase 27's tp=2 rank files: each process "
         "read only its model-axis rank file, resident_artifact_bytes {}; "
         "loaded in {} s; per process and step K3 {} and K1 {} (M={}); "
         "greedy ids and logits row for row bit-equal to the dp1xtp2 "
         "engine's on the same rows; against its whole {}-row batch ids "
         "{} (logit gap {:.3g} up to {}, max|logit| {:.3g}; the dp1 engine "
         "without :overlap at M=2 against M=4: gap {:.3g}); {} x {} "
         "tokens in {} s per process ({} tok/s; the batch {:.1f} "
         "tok/s)".format(
             plan.shorthand(), out["transport"],
             ", ".join(f"{st['file_bytes_loaded']}/{st['file_bytes_total']}"
                       for st in out["load_stats"]),
             "/".join(f"{s:.2f}" for s in out["load_s"]),
             want["dequant_matmul_wire_ordered"],
             want["dequant_matmul_ordered"], rows, MESH_BATCH,
             "equal" if whole["ids_agree"] else
             "apart from {} on a near tie (top-2 margin {:.3g})".format(
                 whole["first_divergence"], whole["top2_margin"]),
             whole["max_logit_gap"],
             "the end" if whole["ids_agree"] else "the divergence",
             whole["max_logit"], sync_m["max_logit_gap"], rows, MESH_NEW,
             "/".join(f"{s:.2f}" for s in out["run_s"]),
             "/".join(f"{t:.1f}" for t in tok_s), out["batch_tok_s"]))
    return out


# ---------------------------------------------------------------------------
# phase 29: decode rows independent of the batch (batched against solo)
# ---------------------------------------------------------------------------

def _solo_rows(engine, req, scfg) -> tuple[list, torch.Tensor]:
    """``req`` alone through ``Engine.generate`` (its own generator from
    its seed, as the scheduler draws it): its ids and the logits row of
    every step that emits (the last prompt step's, then each decode's)."""
    calls = []
    step = engine.decode

    def decode(cache, tokens, pos, pages=None):
        logits, cache = step(cache, tokens, pos, pages)
        calls.append(logits[0])
        return logits, cache

    engine.decode = decode
    try:
        ids = engine.generate(
            torch.Generator(device="cuda").manual_seed(req.seed),
            torch.from_numpy(req.prompt.astype(np.int64))[None].cuda(),
            [req.prompt.size], max_new_tokens=req.max_new_tokens,
            scfg=scfg)[0]
    finally:
        del engine.decode
    return ids.tolist(), torch.stack(calls[req.prompt.size - 1:])


def phase_batch_solo(engine, cfg) -> dict:
    """Phase 29: qwen3-4b at full width, tp=1, captured: phase 22's eight
    requests served greedy four slots at a time on an engine of row
    block 4, and seeded eight slots at a time on one of row block 8
    (``_recorded_serve``; ``Engine.row_block``, ``cm.row_stable``), then
    each alone through that engine's ``Engine.generate`` (batch 1):
    every request's ids equal and its logits rows bit-equal; the head's
    time a step as one plain product and through ``row_stable`` at
    blocks of 4 and 8, at M 1, 4 and 8."""
    out = {}
    for label, scfg, slots in (("greedy", GREEDY, 4), ("seeded", SEEDED, 8)):
        what = f"batch-solo {label} ({slots} slots)"
        eng = _sibling(engine, row_block=slots)
        sched = Scheduler(eng, max_batch=slots, prompt_budget=40, scfg=scfg,
                          seed=0)
        run = _recorded_serve(eng, cfg, scfg, "dequant_matmul_ordered", what,
                              sched=sched)
        solo_steps = 0
        reset_counts()
        for req in _paged_requests(cfg):
            ids, rows = _solo_rows(eng, req, scfg)
            solo_steps += req.prompt.size + req.max_new_tokens - 1
            if ids != run["ids"][req.rid] or not torch.equal(
                    rows, run["logits"][req.rid]):
                gap = (rows - run["logits"][req.rid]).abs().max().item()
                raise AssertionError(
                    f"{what}: request {req.rid} alone gave ids {ids[:8]} "
                    f"against {run['ids'][req.rid][:8]} batched (max "
                    f"logit gap {gap:.3g})")
        counts = read_counts()
        expect_counts(counts, {"dequant_matmul_ordered":
                               mlp_launches(cfg) * solo_steps},
                      f"{what}, solo ({solo_steps} decode steps)")
        out[label] = {"slots": slots, "row_block": eng.row_block,
                      "requests": len(run["ids"]), "batched_steps":
                      run["steps"], "batched_launches": run["launches"],
                      "steady_ms_per_step": run["steady_ms_per_step"],
                      "solo_steps": solo_steps,
                      "solo_launches": counts["dequant_matmul_ordered"],
                      "ids": run["ids"], "bit_equal": True}
        del eng, sched, run
        torch.cuda.empty_cache()
    embed = engine.params["embed"]
    x = torch.randn(8, 1, cfg.d_model, device="cuda")
    out["head_ms"] = {f"plain M={m}": _time(
        lambda t: t @ embed["lm_head"], [(x[:m],)], reps=20)
        for m in (1, 4, 8)}
    for blk in (4, 8):
        with cm.row_blocks(blk):
            for m in (1, 4, 8):
                out["head_ms"][f"row_stable({blk}) M={m}"] = _time(
                    lambda t: cm.lm_head(cfg, embed, t), [(x[:m],)],
                    reps=20)
    line("batch-solo", "qwen3-4b full width, captured: 8 requests x 16 "
         "tokens, greedy 4 slots at a time (row block 4) and seeded 8 at a "
         "time (row block 8), and each alone (Engine.generate, batch 1): "
         "ids equal and every emitted logits row bit-equal (greedy {} "
         "batched steps, {:.2f} ms a step; seeded {}, {:.2f} ms; {} solo "
         "steps each; K1 {} + {} launches greedy); head ms a step: ".format(
             out["greedy"]["batched_steps"],
             out["greedy"]["steady_ms_per_step"],
             out["seeded"]["batched_steps"],
             out["seeded"]["steady_ms_per_step"],
             out["greedy"]["solo_steps"], out["greedy"]["batched_launches"],
             out["greedy"]["solo_launches"])
         + ", ".join(f"{k} {v:.4f}" for k, v in out["head_ms"].items()))
    return out


# ---------------------------------------------------------------------------
# phases 30-33: the MoE family at full width
# ---------------------------------------------------------------------------

def _moe_cfg(arch: str, scheme: str = "tp-aware", layers=None):
    backend = "auto" if scheme == "tp-aware" else "cuda"
    return moe_config(arch, layers).with_quant(mode="mlp", scheme=scheme,
                                               backend=backend)


def _first_layers(engine, cfg):
    """An engine of ``cfg`` (a cut depth) over ``engine``'s first layers:
    a depth-L model from seed 0 is the full one's first L layers (the
    init draws them in order)."""
    layers = engine.params["layers"][:cfg.num_layers]
    return Engine(model=build_model(cfg),
                  params=dict(engine.params, layers=layers),
                  device=engine.device, max_seq=engine.max_seq,
                  policy=engine.policy)


def phase_serve_moe() -> tuple[dict, object]:
    """Phase 30: each of ``MOE_ARCHS`` at full width, depth cut to
    ``MOE_LAYERS`` (printed), from seed 0 (the experts quantized one at a
    time; the init's peak memory printed): the four requests through the
    captured step (K1 once per GEMM of every expert of every layer, and
    of arctic's dense MLP, ``mlp_launches``), the launches per step on
    the device (torch.profiler), the captured step against
    ``decode_eager`` bit for bit, and greedy ids on backend=cuda against
    backend=torch; for qwen3-moe the same requests under naive-actorder
    (K4 only).  Returns the results and qwen3-moe's tp-aware engine."""
    out, keep = {}, None
    for arch in MOE_ARCHS:
        cfg = _moe_cfg(arch)
        full = get_config(arch).num_layers
        line(f"serve {arch}", f"full width, depth cut from {full} to "
             f"{cfg.num_layers} layers ({cfg.num_experts} experts of d_ff "
             f"{cfg.moe_dff}, top-{cfg.top_k}"
             + (", a dense residual MLP" if cfg.dense_residual else "")
             + "; the full depth does not fit one card)")
        engine, serve = phase_serve(cfg, "dequant_matmul_ordered",
                                    f"serve {arch}")
        per = mlp_launches(cfg)
        res = {"layers": cfg.num_layers, "full_layers": full, "serve": serve,
               "launches_per_step": per}
        res["trace"] = tr = phase_trace(engine, {"K1": _is_k1},
                                        f"trace {arch}", expect={"K1": per},
                                        steps=1)
        k1 = tr["kernels"]["K1"]["launches_per_step"]
        if k1 != per:
            raise AssertionError(f"{arch}: {k1} K1 kernels per captured "
                                 f"step on the device, expected {per}")
        steps = 4
        captures, offsets, _ = _captured_vs_eager(engine, cfg, steps,
                                                  f"capture {arch}")
        res["capture"] = {"steps_each": steps, "captures": captures,
                          "offsets": offsets, "bit_equal": True}
        plain = Engine(model=engine.model, params=engine.params,
                       device=engine.device, max_seq=engine.max_seq,
                       policy=engine.policy.with_(backend="torch"))
        text, res["crosscheck"] = _greedy_compare(
            engine, plain, cfg, "greedy 2 prompts x 8 tokens, cuda vs torch "
            "backend")
        del plain
        line(f"capture {arch}", f"B=4: {steps} lockstep steps and {steps} "
             f"on per-slot positions (offsets {offsets}) through the "
             f"captured step bit-equal to decode_eager (logits and the whole "
             f"KV cache after each step; the combine adds each token's "
             f"slots in order); captures {captures}; {text}")
        if arch == MOE_ARCHS[0]:
            naive, res["serve_naive"] = phase_serve(
                _moe_cfg(arch, "naive-actorder"), "dequant_matmul_gidx",
                f"serve-naive {arch}")
            del naive
            keep = engine
        else:
            del engine
        torch.cuda.empty_cache()
        out[arch] = res
    return out, keep


def phase_artifact_moe(engine) -> tuple[dict, str, dict]:
    """Phase 31: qwen3-moe at full width and ``MOE_DIST_LAYERS`` layers,
    prepared from seed 0 on the card at tp=1 (one expert's raw weights
    at a time; the card's peak memory while preparing), saved, and
    served from the directory: the manifest's experts entry stacked
    ``[L, 128]``, and greedy ids and logits bit-equal to the in-memory
    engine of that depth (phase 30's engine's first layers).  Returns
    the record, the directory (phases 32-33 read it; the caller removes
    it) and the in-memory engine's greedy trace over the lockstep batch
    (phase 32's dp1 reference)."""
    arch = MOE_ARCHS[0]
    cfg = _moe_cfg(arch, layers=MOE_DIST_LAYERS)
    mem = _first_layers(engine, cfg)
    path, nbytes, files, prep_s, save_s, peak = _prepare_and_save(
        cfg, 1, "artifact-moe")
    try:
        pairs = {m["path"]: m["stacked"] for m in
                 DeploymentArtifact.load_manifest(path)["pairs"]}
        if pairs != {"layers.moe.experts": [cfg.num_layers,
                                            cfg.num_experts]}:
            raise AssertionError(f"artifact-moe: manifest pairs {pairs}")
        t0 = time.perf_counter()
        served = make_engine(cfg, device="cuda", max_seq=mem.max_seq,
                             artifact=path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        toks, plen = (torch.from_numpy(a).cuda() for a in
                      _greedy_inputs(cfg))
        reset_counts()
        ids_a, lg_a = _greedy_trace(served, toks, plen, 8)
        counts = read_counts()
        ids_m, lg_m = _greedy_trace(mem, toks, plen, 8)
        if not (torch.equal(ids_a, ids_m) and torch.equal(lg_a, lg_m)):
            raise AssertionError(
                "artifact-moe: the served files' greedy trace differs from "
                "the in-memory engine's (max logit gap "
                f"{(lg_a - lg_m).abs().max().item():.3g})")
        steps = int(plen.max()) + 8 - 1
        expect_counts(counts, {"dequant_matmul_ordered":
                               mlp_launches(cfg) * steps},
                      f"artifact-moe ({steps} steps)")
        tokens, mplen = _mesh_batch(cfg)
        ref_ids, ref_logits = _greedy_trace(
            mem, torch.from_numpy(tokens).cuda(),
            torch.from_numpy(mplen).cuda(), MESH_NEW)
        dp1 = {"ids": ref_ids.cpu(), "logits": ref_logits.cpu()}
        decode_mode = served.decode_mode
        del served, mem
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    out = {"layers": cfg.num_layers, "bytes": nbytes, "files": files,
           "prepare_s": prep_s, "save_s": save_s, "load_s": load_s,
           "prepare_peak_bytes": peak, "pairs": pairs,
           "launches": counts["dequant_matmul_ordered"],
           "decode_mode": decode_mode, "bit_equal": True}
    line("artifact-moe", f"{arch} full width, {cfg.num_layers} layers: "
         f"prepared on the card in {prep_s:.1f}s (one expert's raw weights "
         f"at a time; peak allocated {peak / 2**30:.2f} GiB, phase 30's "
         f"engine included), saved {nbytes / 1e9:.2f} GB in {save_s:.1f}s, "
         f"served from the directory (loaded in {load_s:.1f}s; decode step: "
         f"{decode_mode}): manifest experts stacked "
         f"{pairs['layers.moe.experts']}; greedy 2 prompts x 8 tokens, ids "
         f"and logits bit-equal to the in-memory engine; K1 "
         f"{out['launches']} = {mlp_launches(cfg)} x {steps}")
    return out, path, dp1


def _moe_ep_rank(ctx, cfg, path, tokens, plen) -> dict:
    """One process of phase 32: its engine from the tp=1 rank file, its
    data rank's half of the experts resident; its rows of the lockstep
    batch, greedy, the counts set to 0 just before and read just after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = DeploymentArtifact(manifest=DeploymentArtifact.load_manifest(
        path)).policy(backend="auto", device=ctx.device).with_(
            mesh=MeshPlan(dp=ctx.dp, tp=ctx.tp))
    t0 = time.perf_counter()
    engine = make_engine(cfg, device=ctx.device, max_seq=32 + 16 + 1,
                         policy=plan, artifact=path,
                         ep_group=ctx.data_group)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lo = ctx.dp_rank * MESH_BATCH // ctx.dp
    hi = (ctx.dp_rank + 1) * MESH_BATCH // ctx.dp
    reset_counts()
    t0 = time.perf_counter()
    ids, logits = _greedy_trace(engine,
                                torch.from_numpy(tokens[lo:hi]).cuda(),
                                torch.from_numpy(plen[lo:hi]).cuda(),
                                MESH_NEW)
    torch.cuda.synchronize()
    return {"process": ctx.process, "dp_rank": ctx.dp_rank,
            "rows": (lo, hi), "ids": ids.cpu(), "logits": logits.cpu(),
            "counts": read_counts(), "run_s": time.perf_counter() - t0,
            "load_s": load_s, "stats": dataclasses.asdict(engine.load_stats),
            "experts": engine.params["layers"][0]["moe"]["experts"]
            .up.qweight.shape[0],
            "decode_mode": engine.decode_mode, "transport": ctx.transport,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_moe_ep(path: str, dp1: dict) -> dict:
    """Phase 32: ``serve --mesh dp2xtp1``'s lockstep batch for qwen3-moe
    at ``MOE_DIST_LAYERS`` layers, two processes on the card over gloo
    via host, from phase 31's rank file (cut by the model axis only):
    each process keeps its data rank's 64 of 128 experts a layer
    (resident expert bytes 0.50 of the file's), its two rows' tokens go
    to the experts' owners by all-to-all (capacity 4 each: no drop), K1
    once per GEMM of its own experts a step; the greedy ids equal the
    dp1 engine's over the same 4 rows, and whether the logits are
    bit-equal is reported."""
    cfg = _moe_cfg(MOE_ARCHS[0], layers=MOE_DIST_LAYERS)
    tokens, plen = _mesh_batch(cfg)
    t0 = time.perf_counter()
    procs = mesh.run(_moe_ep_rank, 1, cfg, path, tokens, plen, dp=2,
                     device_type="cuda", timeout=600)
    wall_s = time.perf_counter() - t0
    steps = MESH_PLEN + MESH_NEW - 1
    per = mlp_launches(cfg) // 2
    for p in procs:
        st = p["stats"]
        expect_counts(p["counts"], {"dequant_matmul_ordered": per * steps},
                      f"moe-ep process {p['process']} ({steps} steps)")
        if (p["experts"] != cfg.num_experts // 2
                or 2 * st["expert_bytes_resident"]
                != st["expert_bytes_loaded"]):
            raise AssertionError(f"moe-ep process {p['process']}: "
                                 f"{p['experts']} experts resident, {st}")
        lo, hi = p["rows"]
        if not torch.equal(p["ids"], dp1["ids"][lo:hi]):
            raise AssertionError(
                f"moe-ep process {p['process']}: rows {lo}-{hi - 1} ids "
                f"{p['ids'].tolist()} against the dp1 engine's "
                f"{dp1['ids'][lo:hi].tolist()}")
    logits = torch.cat([p["logits"] for p in procs])
    out = {"mesh": "dp2xtp1", "transport": procs[0]["transport"],
           "decode_mode": procs[0]["decode_mode"], "steps": steps,
           "launches_per_step": per,
           "counts": [p["counts"] for p in procs],
           "load_stats": [p["stats"] for p in procs],
           "resident_expert_fraction": [
               p["stats"]["expert_bytes_resident"]
               / p["stats"]["expert_bytes_loaded"] for p in procs],
           "load_s": [p["load_s"] for p in procs],
           "run_s": [p["run_s"] for p in procs], "wall_s": wall_s,
           "ids_equal_dp1": True,
           "logits_bit_equal_dp1": bool(torch.equal(logits, dp1["logits"])),
           "max_logit_gap_dp1": (logits - dp1["logits"]).abs().max().item(),
           "peak_bytes": [p["peak_bytes"] for p in procs]}
    line("moe-ep", "dp2xtp1 ({}; decode step: {}) from phase 31's rank "
         "file: each process {} of {} experts a layer, resident expert bytes "
         "{} ({} of the file's), loaded in {} s; per process and step K1 {} "
         "(M=8: two rows' slots from both ranks); greedy ids of the {} "
         "rows equal the dp1 engine's; logits bit-equal: {} (max gap "
         "{:.3g}); {} x {} tokens in {} s per process".format(
             out["transport"], out["decode_mode"], cfg.num_experts // 2,
             cfg.num_experts,
             ", ".join(f"{st['expert_bytes_resident']}/"
                       f"{st['expert_bytes_loaded']}"
                       for st in out["load_stats"]),
             "/".join(f"{f:.3f}" for f in out["resident_expert_fraction"]),
             "/".join(f"{s:.1f}" for s in out["load_s"]), per, MESH_BATCH,
             out["logits_bit_equal_dp1"], out["max_logit_gap_dp1"],
             MESH_BATCH // 2, MESH_NEW,
             "/".join(f"{s:.2f}" for s in out["run_s"])))
    return out


def _count_expert_collectives(calls: list):
    """Record the spec of every collective over stacked expert partials
    (3-dim, ``(E, C, d)``) in ``calls``."""
    from repro_torch.models import moe

    real = moe.comm.apply

    def apply(y, group, spec, policy=None):
        if y.dim() == 3:
            calls.append(spec.shorthand())
        return real(y, group, spec, policy)

    moe.comm.apply = apply


def _moe_tp_rank(ctx, cfg, carries) -> dict:
    """One rank of phase 33: its slices of the plan from seed 0; under
    each of ``MOE_TP_PLANS`` (and the fused plan's unfused ring) each
    layer's float32 output on the tp=1 engine's input carries, and two
    eager decode steps with the stacked expert collectives and the
    kernel launches counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    calls: list = []
    _count_expert_collectives(calls)
    t0 = time.perf_counter()
    base = make_engine(cfg, 0, device=ctx.device, max_seq=32 + 16 + 1,
                       group=ctx.group)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"init_s": init_s, "plans": {}}
    for spec in MOE_TP_PLANS + (MOE_TP_UNFUSED,):
        eng = Engine(model=base.model, params=base.params,
                     device=base.device, max_seq=base.max_seq,
                     group=ctx.group,
                     policy=base.policy.with_(collective=spec))
        layers = [o.cpu() for o in layer_outputs(eng, carries)]
        cache = eng.init_cache(4)
        tokens = torch.arange(4, device=ctx.device)
        calls.clear()
        reset_counts()
        t0 = time.perf_counter()
        for i in range(2):
            eng.decode(cache, tokens, 24 + i)
        torch.cuda.synchronize()
        out["plans"][spec] = {
            "layers": layers, "collectives": list(calls),
            "counts": read_counts(),
            "ms_per_step": (time.perf_counter() - t0) * 1e3 / 2,
            "decode_mode": eng.decode_mode}
    return out


def phase_moe_tp(engine) -> dict:
    """Phase 33: qwen3-moe at full width and ``MOE_DIST_LAYERS`` layers at
    tp=2 over gloo via host, two rank processes each holding its half of
    every expert's inner dims: under ``psum`` each layer's float32 output
    within 1e-5 of max|.| + 1e-4 of phase 30's tp=1 engine's on the same
    input carries (``layerwise``); the ``quant-int8:128:fused`` plan's
    layers bit-equal to its unfused ring (the experts run K1 and then the
    stacked ring either way) and their gap to tp=1 reported; one
    collective closes each MoE layer's stacked experts a step; K1 once
    per GEMM of every expert a step per rank."""
    cfg = _moe_cfg(MOE_ARCHS[0], layers=MOE_DIST_LAYERS)
    ref = _first_layers(engine, cfg)
    carries, outputs = layer_trace(
        ref, torch.from_numpy(_greedy_inputs(cfg)[0]).cuda())
    carries = [c.cpu() for c in carries]
    outputs = [o.cpu() for o in outputs]
    del ref
    t0 = time.perf_counter()
    ranks = POOL.run(_moe_tp_rank, cfg, carries, timeout=600)
    wall_s = time.perf_counter() - t0
    fused, plain = MOE_TP_PLANS[-1], MOE_TP_UNFUSED
    per = mlp_launches(cfg)
    out = {"layers": cfg.num_layers, "wall_s": wall_s,
           "init_s": [r["init_s"] for r in ranks], "plans": {}}
    for spec in MOE_TP_PLANS:
        rec = {"collectives_per_step": [], "counts": [],
               "ms_per_step": [r["plans"][spec]["ms_per_step"]
                               for r in ranks],
               "decode_mode": ranks[0]["plans"][spec]["decode_mode"]}
        for k, r in enumerate(ranks):
            p = r["plans"][spec]
            want = parse_collective(spec).resolve("layers.moe.experts")
            if p["collectives"] != [want.shorthand()] * (2 * cfg.num_layers):
                raise AssertionError(f"moe-tp rank {k} {spec}: stacked "
                                     f"expert collectives {p['collectives']}")
            expect_counts(p["counts"], {"dequant_matmul_ordered": 2 * per},
                          f"moe-tp rank {k} {spec} (2 steps)")
            rec["collectives_per_step"].append(len(p["collectives"]) // 2)
            rec["counts"].append(p["counts"])
            if spec == fused and not all(
                    torch.equal(a, b) for a, b in zip(
                        p["layers"], r["plans"][plain]["layers"])):
                raise AssertionError(f"moe-tp rank {k}: {fused} layers "
                                     f"differ from {plain}'s")
        layers = ranks[0]["plans"][spec]["layers"]
        if spec == "psum":
            rec["layerwise"] = layerwise(layers, outputs,
                                         "moe-tp psum at tp=2 vs tp=1")
        else:
            rec["gap_to_tp1"] = max(
                ((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(layers, outputs))
        out["plans"][spec] = rec
    ps, q = out["plans"]["psum"], out["plans"][fused]
    line("moe-tp", "qwen3-moe full width, {} layers, tp=2 ({}; decode "
         "step: {}): psum layer by layer on the tp=1 engine's input "
         "carries within 1e-5 of max|.| + 1e-4 (worst {:.3g}, {:.3g} of "
         "max|.|); {} layers bit-equal to its unfused ring, {:.3g} of "
         "max|.| from tp=1 (reported); {} stacked expert collective(s) a "
         "MoE layer a step; K1 {} a step per rank; eager step {} ms "
         "(psum) / {} ms ({})".format(
             cfg.num_layers, mesh.transport(TP, "cuda"), ps["decode_mode"],
             ps["layerwise"]["max_abs_err"], ps["layerwise"]["max_rel_err"],
             fused, q["gap_to_tp1"],
             ps["collectives_per_step"][0] // cfg.num_layers, per,
             "/".join(f"{m:.1f}" for m in ps["ms_per_step"]),
             "/".join(f"{m:.1f}" for m in q["ms_per_step"]), fused))
    return out


# ---------------------------------------------------------------------------
# the audio and vision families (phases 34-36)
# ---------------------------------------------------------------------------

def av_config(arch: str, scheme: str = "tp-aware", **quant):
    """The audio or vision ``arch`` at full width, tp-aware on the
    kernels' auto backend (naive-actorder on backend=cuda); the vision
    model's depth cut to ``VISION_LAYERS`` (2 of its 20 superblocks)."""
    cfg = get_config(arch)
    if arch == VISION:
        cfg = cfg.with_(num_layers=VISION_LAYERS)
    backend = "auto" if scheme == "tp-aware" else "cuda"
    return cfg.with_quant(mode="mlp", scheme=scheme, backend=backend,
                          **quant)


def _av_key(cfg) -> str:
    return "frames" if cfg.family == "audio" else "patches"


def _av_batch(cfg) -> tuple[list, dict, torch.Tensor]:
    """Phase 5's four prompts (4-31 tokens from seed 0), right-padded to
    ``AV_BUDGET``, and frames or patches (B, encoder_seq | vision_tokens,
    d_model) drawn in bf16 from seed 0 on the card (``make_batch``):
    (prompts, batch, prompt lengths on the card)."""
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(4):
        plen = int(rng.integers(4, AV_BUDGET))
        prompts.append(rng.integers(0, cfg.vocab_size, size=plen))
    tokens = np.zeros((4, AV_BUDGET), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :p.size] = p
    gen = torch.Generator(device="cuda").manual_seed(0)
    src = build_model(cfg).make_batch(gen, 4, AV_BUDGET)[_av_key(cfg)]
    batch = {"tokens": torch.from_numpy(tokens).cuda(), _av_key(cfg): src}
    plen = torch.tensor([p.size for p in prompts], device="cuda")
    return prompts, batch, plen


def _av_greedy(engine, batch: dict, plen, n: int = AV_NEW):
    """``Engine.generate``'s greedy steps written out, each step's wall
    (ending in a read of its ids) and logits kept: the cross prefill
    (``Model.prefill_cross``), the prompt replay through ``decode`` (its
    first step captures), then ``n - 1`` steps.  Returns (ids (B, n),
    logits (B, n, V), cross prefill ms, each replay and decode step's
    ms)."""
    b = batch["tokens"].shape[0]
    cache = engine.init_cache(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cm.row_blocks(engine.row_block):
        engine.model.prefill_cross(engine.params, batch, cache,
                                   engine.policy,
                                   attn_backend=engine.attn_backend)
    torch.cuda.synchronize()
    cross_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    last = torch.zeros((b, engine.model.cfg.vocab_size), device="cuda")
    for t in range(batch["tokens"].shape[1]):
        t0 = time.perf_counter()
        logits, cache = engine.decode(cache, batch["tokens"][:, t], t)
        last = torch.where((plen == t + 1)[:, None], logits, last)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    trace, ids = [last], [last.argmax(-1)]
    pos = int(plen.max())
    for i in range(n - 1):
        t0 = time.perf_counter()
        logits, cache = engine.decode(cache, ids[-1], pos + i)
        ids.append(logits.argmax(-1))
        ids[-1].tolist()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        trace.append(logits)
    return torch.stack(ids, 1), torch.stack(trace, 1), cross_ms, step_ms


def _drain(engine, cfg, prompts) -> tuple[dict, dict]:
    """The scheduler's batch-drain mode (``Scheduler.run``) over the four
    prompts, greedy, and ``Engine.generate`` of the same padded rows
    beside zero frames or patches: (drained ids, generate's ids)."""
    sched = Scheduler(engine, max_batch=4, prompt_budget=AV_BUDGET,
                      scfg=GREEDY, seed=0)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p.astype(np.int32),
                             max_new_tokens=AV_NEW))
    done = {rid: r.output for rid, r in sched.run().items()}
    tokens = np.zeros((4, AV_BUDGET), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :p.size] = p
    t = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_tokens
    zeros = torch.zeros((4, t, cfg.d_model), dtype=torch.bfloat16,
                        device="cuda")
    ids = engine.generate(None, {"tokens": torch.from_numpy(tokens),
                                 _av_key(cfg): zeros},
                          [p.size for p in prompts], max_new_tokens=AV_NEW,
                          scfg=GREEDY)
    return done, {i: row for i, row in enumerate(ids.tolist())}


def _av_make(cfg, phase: str):
    """The engine of ``cfg`` from seed 0 (the vision model's gates set to
    ``VISION_GATE``: at their initial 0 the cross layers add nothing):
    (engine, init seconds, params bytes, peak bytes during the init)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = make_engine(cfg, 0, device="cuda", max_seq=AV_MAX_SEQ,
                         row_block=4)
    if cfg.family == "vlm":
        for sp in engine.params["super"]:
            for gate in ("gate_attn", "gate_mlp"):
                sp["cross"][gate].fill_(VISION_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.policy.backend != "cuda":
        raise AssertionError(f"{phase}: policy picked "
                             f"{engine.policy.backend!r}")
    nbytes = sum(t.nbytes for t in checkpoint.flatten_keys(
        engine.params).values())
    return engine, init_s, nbytes, torch.cuda.max_memory_allocated()


def _av_serve(engine, cfg, kernel: str, phase: str) -> dict:
    """Four requests through ``Engine.generate`` (greedy), counted: every
    decode step (the prompt replay's and generation's) launches
    ``kernel`` once per MLP weight of the decoder, and whisper's encoder
    launches K1 once per MLP weight on its tensor-core loop (M = 4 x
    1500); then the same greedy steps written out and timed, whose ids
    must be generate's, and a second generate with the same ids."""
    prompts, batch, plen = _av_batch(cfg)
    per = mlp_launches(cfg)
    enc = 2 * cfg.encoder_layers            # whisper's encoder MLPs
    steps = AV_BUDGET + AV_NEW - 1
    reset_counts()
    t0 = time.perf_counter()
    ids = engine.generate(None, batch, plen, max_new_tokens=AV_NEW,
                          scfg=GREEDY)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    want = {kernel: per * steps + enc}
    if kernel == "dequant_matmul_ordered" and enc:
        want[TC] = enc
    expect_counts(counts, want, f"{phase} generate ({steps} decode steps)")
    if ids.shape != (4, AV_NEW) or not ((ids >= 0) & (ids < cfg.vocab_size)
                                        ).all():
        raise AssertionError(f"{phase}: ids {tuple(ids.shape)} out of range")
    again, logits, cross_ms, step_ms = _av_greedy(engine, batch, plen)
    if not torch.equal(again, ids):
        raise AssertionError(f"{phase}: the timed greedy run's ids differ "
                             f"from generate's")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{phase}: logits not finite")
    return {"scheme": cfg.quant.scheme, "generate_s": gen_s,
            "decode_steps": steps, "launches": counts[kernel],
            "counts": counts, "launches_per_step": per,
            "encoder_tc_launches": counts[TC], "ids": ids.tolist(),
            "cross_prefill_ms": cross_ms, "first_step_ms": step_ms[0],
            "steady_ms_per_step": statistics.median(step_ms[1:]),
            "step_ms": step_ms, "decode_mode": engine.decode_mode,
            "tokens_per_s": 4 * AV_NEW / gen_s}, batch, plen, prompts


def _av_capture(engine, cfg, batch: dict, steps: int, phase: str):
    """``_captured_vs_eager`` with every cache's cross K/V filled from
    ``batch``'s frames or patches first."""
    def fill(cache):
        engine.model.prefill_cross(engine.params, batch, cache,
                                   engine.policy)
    return _captured_vs_eager(engine, cfg, steps, phase, fill=fill)


def phase_serve_av(arch: str) -> dict:
    """Phases 34-35 (``serve whisper-large-v3``, ``serve
    llama-3.2-vision-90b``): the arch at full width (the vision model at
    ``VISION_LAYERS`` layers, its gates at ``VISION_GATE``) built from
    seed 0; four requests with frames or patches from seed 0 through
    ``Engine.generate``, counted (``_av_serve``) and timed (the cross
    prefill, the first step with its capture, the steady step), greedy
    ids equal over two runs; the captured step against ``decode_eager``
    bit for bit; the scheduler's batch-drain mode against
    ``Engine.generate`` on the same padded rows with zero frames or
    patches; a few captured steps traced (K1's device ms a step against
    its bytes bound, the busy share); whisper's encoder and cross
    prefill timed alone (the encoder's K1 launches on the tensor-core
    loop); whisper under naive-actorder (K4 only); the vision model's
    2048-token forward with the flash kernel against the einsum one.
    Returns the record."""
    cfg = av_config(arch)
    phase = f"serve {arch}"
    engine, init_s, nbytes, init_peak = _av_make(cfg, phase)
    full = get_config(arch).num_layers
    line(phase, f"{describe(cfg)} full width"
         + (f", depth cut from {full} to {cfg.num_layers} layers "
            f"({cfg.num_layers // cfg.cross_attn_every} of "
            f"{full // cfg.cross_attn_every} superblocks; the gates set to "
            f"{VISION_GATE}: at 0 the cross layers add nothing)"
            if cfg.num_layers != full else
            f", encoder {cfg.encoder_layers} layers over "
            f"{cfg.encoder_seq} frames")
         + f": init {init_s:.1f}s, params {nbytes / 2**30:.2f} GiB (peak "
         f"during the init {init_peak / 2**30:.2f} GiB)")
    serve, batch, _, prompts = _av_serve(engine, cfg,
                                         "dequant_matmul_ordered", phase)
    out = {"layers": cfg.num_layers, "full_layers": full, "init_s": init_s,
           "params_bytes": nbytes, "init_peak_bytes": init_peak,
           "serve": serve}
    line(phase, "4 requests ({} + {} tokens each, greedy) through "
         "Engine.generate in {:.2f}s ({:.1f} tok/s): cross prefill {:.1f} "
         "ms, the first step with its capture {:.1f} ms, then a median "
         "{:.2f} ms a step (decode step: {}); K1 launches {} = {} x {} "
         "steps{}; greedy ids equal over two runs; first ids {}".format(
             AV_BUDGET, AV_NEW, serve["generate_s"], serve["tokens_per_s"],
             serve["cross_prefill_ms"], serve["first_step_ms"],
             serve["steady_ms_per_step"], serve["decode_mode"],
             serve["launches"], serve["launches_per_step"],
             serve["decode_steps"],
             (f" + {serve['encoder_tc_launches']} on the tensor-core loop "
              f"in the encoder (M = 4 x {cfg.encoder_seq})"
              if cfg.family == "audio" else ""),
             [row[:4] for row in serve["ids"]]))
    steps = 4
    captures, offsets, _ = _av_capture(engine, cfg, batch, steps,
                                       f"capture {arch}")
    out["capture"] = {"steps_each": steps, "captures": captures,
                      "offsets": offsets, "bit_equal": True}
    drained, generated = _drain(engine, cfg, prompts)
    if drained != generated:
        raise AssertionError(f"{phase}: batch-drain ids {drained} != "
                             f"Engine.generate's {generated}")
    out["batch_drain"] = {"ids": drained, "equal_to_generate": True}
    line(f"capture {arch}", f"B=4, cross K/V of the request batch: "
         f"{steps} lockstep and {steps} per-slot steps (offsets {offsets}) "
         f"through the captured step bit-equal to decode_eager (logits, "
         f"the self cache and the cross K/V after each step); captures "
         f"{captures}; Scheduler.run() in batch-drain mode (zero "
         f"{_av_key(cfg)}) gives Engine.generate's ids on the same padded "
         f"rows: {[row[:4] for row in drained.values()]}")
    per = mlp_launches(cfg)
    out["trace"] = tr = phase_trace(engine, {"K1": _is_k1},
                                    f"trace {arch}", expect={"K1": per},
                                    steps=2)
    k1 = tr["kernels"]["K1"]["launches_per_step"]
    if k1 != per:
        raise AssertionError(f"{arch}: {k1} K1 kernels per captured step on "
                             f"the device, expected {per}")
    if cfg.family == "audio":
        out["encode"] = _time_encode(engine, cfg, batch)
        naive = av_config(arch, "naive-actorder")
        nengine, *_ = _av_make(naive, f"serve-naive {arch}")
        out["serve_naive"] = _av_serve(nengine, naive,
                                       "dequant_matmul_gidx",
                                       f"serve-naive {arch}")[0]
        s = out["serve_naive"]
        line(f"serve-naive {arch}", "naive-actorder on backend=cuda: 4 "
             "requests through Engine.generate, K4 launches {} = {} x {} "
             "steps + {} in the encoder (K1 0), median step {:.2f} ms; ids "
             "{} those of tp-aware".format(
                 s["launches"], per, s["decode_steps"],
                 2 * cfg.encoder_layers, s["steady_ms_per_step"],
                 "equal to" if s["ids"] == serve["ids"] else "not all"))
        del nengine
    else:
        out["forward_flash"] = _av_forward_flash(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    return out


def _time_encode(engine, cfg, batch: dict) -> dict:
    """Whisper's encoder over the four requests' frames and the cross K/V
    of its states written into a cache, each timed alone (host wall
    ending in a synchronize, after a warm run), the encoder's K1 launches
    counted (all on the tensor-core loop)."""
    from repro_torch.models import whisper

    frames = batch["frames"]
    cache = engine.init_cache(frames.shape[0])

    def encode():
        return whisper.encode(cfg, engine.params, frames, engine.policy)

    with torch.inference_mode():
        enc = encode()
        whisper.precompute_cross(cfg, engine.params, enc, cache)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        enc = encode()
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        t0 = time.perf_counter()
        whisper.precompute_cross(cfg, engine.params, enc, cache)
        torch.cuda.synchronize()
        cross_ms = (time.perf_counter() - t0) * 1e3
    n = 2 * cfg.encoder_layers
    expect_counts(counts, {"dequant_matmul_ordered": n, TC: n},
                  "whisper encode")
    if not torch.isfinite(enc).all() or enc.shape != frames.shape:
        raise AssertionError("whisper encode: states not finite or of "
                             "another shape")
    cross_bytes = 2 * cache["cross_k"].nbytes
    line(f"serve {cfg.arch_id}", f"encode of 4 x {cfg.encoder_seq} frames "
         f"{enc_ms:.1f} ms ({counts[TC]} K1 launches, all on the "
         f"tensor-core loop), precompute_cross {cross_ms:.1f} ms "
         f"({cross_bytes / 1e6:.1f} MB of bf16 cross K/V, "
         f"{cross_bytes / 4 / 1e6:.1f} MB a request)")
    return {"encode_ms": enc_ms, "precompute_cross_ms": cross_ms,
            "counts": counts, "cross_bytes": cross_bytes}


@torch.inference_mode()
def _vision_layers(engine, batch: dict, attn_backend: str,
                   carries=None) -> tuple[list, list]:
    """The vision model's forward one layer at a time (self layers
    through ``transformer.layer_forward`` under ``attn_backend``, the
    gated cross layers on the einsum path): the carry entering each
    layer and each layer's float32 output, before its cast; on the input
    ``carries`` when given, else on its own."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import vision_llama as vl

    cfg, params = engine.model.cfg, engine.params
    x = cm.embed_tokens(cfg, params["embed"], batch["tokens"])
    own, outs = [], []
    for sp in params["super"]:
        for lp in sp["self"] + [None]:
            xin = x if carries is None else carries[len(outs)]
            own.append(xin)
            y = (tfm.layer_forward(cfg, lp, xin, engine.policy,
                                   attn_backend=attn_backend,
                                   path=vl.SELF_MLP_PATH) if lp is not None
                 else vl.cross_layer_forward(cfg, sp["cross"], xin,
                                             batch["patches"],
                                             engine.policy))
            outs.append(y)
            x = y.to(x.dtype)
    return own, outs


def _av_forward_flash(engine, cfg) -> dict:
    """The vision model's full-sequence forward of one 2048-token
    sequence beside patches from seed 0, with the flash kernel and with
    the einsum attention on the same params: K2 once per self layer
    (cross-attention stays on the einsum path), every K1 launch on its
    tensor-core loop, the logits finite.  Then layer by layer on the
    einsum forward's input carries: each layer's float32 output through
    the flash kernel within 5e-3 of max|.| of the einsum layer's (the
    two attentions differ by float32 sum order; free-running, this
    random model without qk_norm amplifies that through its bf16 carry,
    so the whole forward's logit gap and argmax agreement are reported,
    not held)."""
    s = AV_FORWARD_S
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = engine.model.make_batch(gen, 1, s)
    flash = dataclasses.replace(engine, attn_backend="flash")
    res, logits = {}, {}
    nself = cfg.num_layers - cfg.num_layers // cfg.cross_attn_every
    for name, eng in (("flash", flash), ("xla", engine)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[name] = eng.prefill_logits(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        expect_counts(counts, {
            "dequant_matmul_ordered": mlp_launches(cfg),
            TC: mlp_launches(cfg),
            "flash_attention": nself if name == "flash" else 0},
            f"vision forward {name}")
        res[name] = {"wall_ms": wall, "counts": counts}
    lf, lx = logits.pop("flash"), logits.pop("xla")
    if lf.shape != (1, s, cfg.vocab_size) or not (
            torch.isfinite(lf).all() and torch.isfinite(lx).all()):
        raise AssertionError("vision flash forward: logits not finite of "
                             "the expected shape")
    gap = (lf - lx).abs().max().item()
    scale = lx.abs().max().item()
    last_gap = (lf[:, -1] - lx[:, -1]).abs().max().item()
    last_scale = lx[:, -1].abs().max().item()
    agree = (lf.argmax(-1) == lx.argmax(-1)).float().mean().item()
    # the yardstick of that drift: the einsum forward again with one
    # patch element moved by one bf16 step
    nudged = dict(batch, patches=batch["patches"].clone())
    p0 = nudged["patches"][0, 0, 0]
    nudged["patches"][0, 0, 0] = p0 + p0.abs().clamp(min=1e-3) * 2 ** -7
    ln = engine.prefill_logits(nudged)
    nudge_agree = (ln.argmax(-1) == lx.argmax(-1)).float().mean().item()
    nudge_gap = (ln - lx).abs().max().item()
    del lf, lx, ln, nudged
    carries, refs = _vision_layers(engine, batch, "xla")
    _, outs = _vision_layers(engine, batch, "flash", carries)
    worst = 0.0
    for i, (a, b) in enumerate(zip(outs, refs, strict=True)):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        if not rel <= 5e-3:
            raise AssertionError(f"vision flash vs einsum, layer {i} on the "
                                 f"same input carry: {rel:.3g} of max|.|")
        worst = max(worst, rel)
    del carries, refs, outs
    out = dict(res, flash_launches=res["flash"]["counts"]["flash_attention"],
               layer_max_rel_err=worst, max_logit_gap=gap, max_logit=scale,
               last_gap=last_gap, last_max_logit=last_scale,
               argmax_agree=agree, nudged_argmax_agree=nudge_agree,
               nudged_max_logit_gap=nudge_gap)
    line(f"serve {cfg.arch_id}", "forward B1 S{} with patches: flash {:.1f} "
         "ms, xla {:.1f} ms wall; flash_attention launches {} = {} self "
         "layers, K1 {} on the tensor-core loop; layer by layer on the "
         "einsum forward's carries, flash within {:.3g} of max|.| (held "
         "at 5e-3); the whole forward free-running (reported): last "
         "position max logit gap {:.3g} (max|logit| {:.3g}), all positions "
         "{:.3g} (max|logit| {:.3g}), argmax agrees at {:.2f}% of "
         "positions; the einsum forward with one patch element moved by "
         "one bf16 step: max logit gap {:.3g}, argmax agrees at {:.2f}%"
         .format(s, res["flash"]["wall_ms"], res["xla"]["wall_ms"],
                 out["flash_launches"], nself, res["flash"]["counts"][TC],
                 worst, last_gap, last_scale, gap, scale, 100 * agree,
                 nudge_gap, 100 * nudge_agree))
    return out


def phase_fold_whisper() -> dict:
    """Phase 36: whisper at full depth with the attention V->O fold
    (``attn_tp_aware``): prepared on the card at tp=1, the in-memory plan
    served beside the same plan saved to a temporary directory and
    served from it (``make_engine(artifact=DIR)``): greedy ids and logits
    of the four requests bit-equal, every decode step launching K1 for
    the decoder's MLP and for V and O in each decoder layer
    (``fold_launches``: 128), the encoder's 64 on the tensor-core loop;
    the aux holds the waived encoder and cross folds beside the consumed
    one, and the engines keep only the decoder's."""
    cfg = av_config(WHISPER, attn_tp_aware=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    art = compiler.prepare(cfg, tp=1, seed=0, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    paths = sorted(art.aux["attn_plans"])
    if paths != ["dec_layers.attn", "dec_layers.xattn", "enc_layers.attn"]:
        raise AssertionError(f"fold-whisper: the aux folds {paths}")
    memory = Engine(model=build_model(cfg), params=art.rank_tree(0),
                    device=torch.device("cuda"), max_seq=AV_MAX_SEQ,
                    aux=art.aux, row_block=4)
    path, nbytes = _artifact_dir(list(art.rank_params) + [art.aux])
    started = None
    try:
        t0 = time.perf_counter()
        art.save(path)
        save_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        started = _verify_start(path)
        t0 = time.perf_counter()
        served = make_engine(cfg, device="cuda", max_seq=AV_MAX_SEQ,
                             artifact=path, row_block=4)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        # the encoder's and the cross folds are waived: info, not errors
        verify = _verify_finish(started, "fold-whisper",
                                f"{describe(cfg)} fold",
                                want={"MF005/info": 2})
    finally:
        if started is not None:
            _verify_stop(started)
        shutil.rmtree(path)
    del art
    for eng in (memory, served):
        folds = eng.aux["attn_plans"]
        if sorted(folds) != ["dec_layers.attn"] or len(
                folds["dec_layers.attn"]) != cfg.num_layers:
            raise AssertionError(f"fold-whisper: the engine keeps "
                                 f"{ {k: len(v) for k, v in folds.items()} }")
    _, batch, plen = _av_batch(cfg)
    per = fold_launches(cfg)
    steps = AV_BUDGET + AV_NEW - 1
    res = {}
    for name, eng in (("in-memory", memory), ("artifact", served)):
        reset_counts()
        ids, logits, cross_ms, step_ms = _av_greedy(eng, batch, plen)
        counts = read_counts()
        enc = 2 * cfg.encoder_layers
        expect_counts(counts, {"dequant_matmul_ordered": per * steps + enc,
                               TC: enc}, f"fold-whisper {name}")
        res[name] = {"ids": ids, "logits": logits, "counts": counts,
                     "first_step_ms": step_ms[0],
                     "steady_ms_per_step": statistics.median(step_ms[1:])}
    a, b = res["in-memory"], res["artifact"]
    if not (torch.equal(a["ids"], b["ids"])
            and torch.equal(a["logits"], b["logits"])):
        raise AssertionError("fold-whisper: the artifact's greedy ids or "
                             "logits differ from the in-memory plan's")
    tr = phase_trace(served, {"K1": _is_k1}, None, expect={"K1": per},
                     steps=2)
    out = {"prepare_s": prepare_s, "prepare_peak_bytes": peak,
           "save_s": save_s, "load_s": load_s, "file_bytes": files,
           "reckoned_bytes": nbytes, "aux_folds": paths,
           "launches": b["counts"]["dequant_matmul_ordered"],
           "counts": b["counts"], "launches_per_step": per,
           "decode_steps": steps, "bit_equal": True,
           "steady_ms_per_step": b["steady_ms_per_step"],
           "first_step_ms": b["first_step_ms"], "trace": tr,
           "ids": b["ids"].tolist(), "verify": verify}
    line("fold-whisper", "{} with attn_tp_aware: prepared on the card in "
         "{:.1f}s (peak {:.2f} GiB; aux folds {}), saved in {:.1f}s "
         "({:.2f} GB of files, aux.npz {:.3f} GB), loaded in {:.1f}s; the "
         "engines keep the {} decoder folds; 4 requests greedy: ids and "
         "logits of the artifact bit-equal to the in-memory plan's; K1 "
         "launches {} = {} x {} steps + {} in the encoder; median step "
         "{:.2f} ms; traced: {:.2f} ms of kernels a step, K1 {:.3f} ms in "
         "{:.0f} launches, busy {:.1f}%".format(
             describe(cfg), prepare_s, peak / 2**30, paths, save_s,
             sum(files.values()) / 1e9, files.get("aux.npz", 0) / 1e9,
             load_s, cfg.num_layers, out["launches"], per, steps,
             2 * cfg.encoder_layers, out["steady_ms_per_step"],
             tr["device_ms_per_step"], tr["kernels"]["K1"]["ms_per_step"],
             tr["kernels"]["K1"]["launches_per_step"],
             100 * tr["busy_share"]))
    del memory, served
    torch.cuda.empty_cache()
    return out


def _check_time_av(gen) -> dict:
    """The kernels at the audio and vision paths' shapes, each against its
    plain version (float32 and bfloat16, ``TOL``) and timed (CUDA-graph
    replay, weights beyond L2) against its bound: K1 and K4 at whisper's
    decoder MLP (M=4), K1 at the vision model's (M=4), K1 at whisper's
    encoder MLP (M = 4 x 1500: its tensor-core loop), K1 at whisper's
    fold V and O (M=4), and K2 at the vision forward's self-attention
    (B1 H64 S2048 D128, causal) against ``FLASH_TOL``, its bound and
    ``scaled_dot_product_attention``."""
    wcfg, vcfg = av_config(WHISPER), av_config(VISION)
    wsh, vsh, wfold = mlp_shapes(wcfg), mlp_shapes(vcfg), fold_shapes(wcfg)
    enc_m = 4 * wcfg.encoder_seq
    decode = [(4, k, n, gs) for _, k, n, gs in wsh + vsh + wfold]
    kernel = (lambda x, ql, dt: ops.dequant_matmul(x, ql, compute_dtype=dt))
    ordered = _check_gemm(
        gen, "dequant_matmul_ordered (audio and vision shapes)",
        decode + [(enc_m, k, n, gs) for _, k, n, gs in wsh], "ordered",
        kernel, lambda x, ql, dt: dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=ql.group_size,
            compute_dtype=dt), phase="kernels-av")
    gidx = _check_gemm(
        gen, "dequant_matmul_gidx (audio shapes)",
        [(4, k, n, gs) for _, k, n, gs in wsh], "naive", kernel,
        lambda x, ql, dt: dk.dequant_matmul_gidx_torch(
            x, ql.qweight, ql.scales, ql.zeros, ql.g_idx, compute_dtype=dt),
        phase="kernels-av")

    def err(res, shapes, m):
        return max(r["max_abs_err"] for r in res["cases"]
                   if r["m"] == m and r["dtype"] == str(torch.float32)
                   and (r["k"], r["n"]) in {(k, n) for _, k, n, _ in shapes})

    out = {"errs": {"whisper": err(ordered, wsh, 4),
                    "whisper_naive": err(gidx, wsh, 4),
                    "vision": err(ordered, vsh, 4),
                    "whisper_fold": err(ordered, wfold, 4),
                    "whisper_encoder": err(ordered, wsh, enc_m)},
           "check": {"ordered": ordered, "gidx": gidx}}
    for key, layout, shapes, gated in (
            ("whisper", "ordered", wsh, False),
            ("whisper_naive", "naive", wsh, False),
            ("vision", "ordered", vsh, True),
            ("whisper_fold", "ordered", wfold, False)):
        r = _time_gemm(gen, layout, shapes=shapes)
        r["layer"] = _layer(r, shapes, gated)
        out[key] = r
        line("kernels-av", "{} f32 M=4 {}, CUDA-graph replay: ".format(
            "K4" if layout == "naive" else "K1", key) + "; ".join(
                "{} (K {} N {} gs {}) {:.4f} ms (bound {:.4f} by {}: "
                "{:.2f} MB; plain {:.4f})".format(
                    name.split(" ", 1)[1], k, n, gs, r[name]["ms"],
                    r[name]["bound_ms"], r[name]["bound_by"],
                    r[name]["bytes"] / 1e6, r[name]["plain_ms"])
                for name, k, n, gs in shapes)
            + "; per layer {:.4f} ms (bound {:.4f})".format(
                r["layer"]["ms"], r["layer"]["bound_ms"]))
        torch.cuda.empty_cache()
    enc = _time_k1_large(gen, enc_m, shapes=wsh, cfg=wcfg)
    out["whisper_encoder"] = enc
    line("kernels-av", "K1 f32 M={} whisper encoder MLP (tensor-core loop), "
         "CUDA-graph replay: per layer {:.3f} ms (bound {:.3f} by "
         "operations, plain {:.3f}, matmul on the dequantized weight "
         "{:.3f} [context]), x {} layers = {:.1f} ms an encode".format(
             enc_m, enc["per_layer_ms"], enc["per_layer_bound_ms"],
             enc["per_layer_plain_ms"],
             enc["per_layer_matmul_dequantized_ms"], wcfg.encoder_layers,
             enc["per_layer_ms"] * wcfg.encoder_layers))
    h = vcfg.n_heads
    shape = (1, h, AV_FORWARD_S, vcfg.head_dim, True, None)
    q, k, v = (torch.randn(shape[:4], generator=gen, device="cuda")
               for _ in range(3))
    y = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention_torch(q, k, v, causal=True)
    rows = []
    _within(rows, (y - ref).abs().max().item(), ref,
            *FLASH_TOL[torch.float32], "flash_attention (vision shape)")
    del q, k, v, y, ref
    fl = _time_flash(gen, shape)
    fl["max_abs_err"] = rows[0]["max_abs_err"]
    out["flash_vision"] = fl
    line("kernels-av", "K2 f32 B1 H{} S=T={} D{} causal (the vision forward's "
         "self-attention): {:.4f} ms (bound {:.4f} by {}; plain {:.4f}); "
         "scaled_dot_product_attention {:.4f} [library, backend {}]; "
         "max_abs_err {:.3g} against the plain version".format(
             h, AV_FORWARD_S, vcfg.head_dim, fl["ms"], fl["bound_ms"],
             fl["bound_by"], fl["plain_ms"], fl["library_ms"],
             fl["sdpa"]["backend"], fl["max_abs_err"]))
    return out


# ---------------------------------------------------------------------------
# phases 37-39: the recurrent families at full depth
# ---------------------------------------------------------------------------

def rec_config(arch: str, scheme: str = "tp-aware"):
    """The recurrent ``arch`` at full width and depth, tp-aware on the
    kernels' auto backend (naive-actorder on backend=cuda)."""
    backend = "auto" if scheme == "tp-aware" else "cuda"
    return get_config(arch).with_quant(mode="mlp", scheme=scheme,
                                       backend=backend)


def _check_time_rec(gen) -> dict:
    """K1 and K4 at the recurrent families' MLP shapes (rwkv6's ungated
    channel-mix pair, recurrentgemma's GeGLU), each against its plain
    version (float32 and bfloat16, ``TOL``) at M 1 (a solo serve), 4
    (the serves) and, for K1, 64 (the forward, on the decode loop), then
    timed at M=4 (CUDA-graph replay, weights beyond L2) against its
    bytes bound, per shape and per layer."""
    shapes = {a: mlp_shapes(rec_config(a)) for a in REC_ARCHS}
    kernel = (lambda x, ql, dt: ops.dequant_matmul(x, ql, compute_dtype=dt))
    ordered = _check_gemm(
        gen, "dequant_matmul_ordered (recurrent shapes)",
        [(m, k, n, gs) for a in REC_ARCHS for _, k, n, gs in shapes[a]
         for m in (1, 4, REC_FORWARD_S)], "ordered", kernel,
        lambda x, ql, dt: dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=ql.group_size,
            compute_dtype=dt), phase="kernels-rec")
    gidx = _check_gemm(
        gen, "dequant_matmul_gidx (recurrent shapes)",
        [(m, k, n, gs) for a in REC_ARCHS for _, k, n, gs in shapes[a]
         for m in (1, 4)], "naive", kernel,
        lambda x, ql, dt: dk.dequant_matmul_gidx_torch(
            x, ql.qweight, ql.scales, ql.zeros, ql.g_idx, compute_dtype=dt),
        phase="kernels-rec")

    def err(res, a):
        kn = {(k, n) for _, k, n, _ in shapes[a]}
        return max(r["max_abs_err"] for r in res["cases"]
                   if r["m"] == 4 and r["dtype"] == str(torch.float32)
                   and (r["k"], r["n"]) in kn)

    # the tp=2 path of phase 42: K1 at each rank's up (and gate) shard, K3
    # at its down shard with the int8 wire
    tp_shapes = {a: rec_tp_shapes(rec_config(a)) for a in REC_ARCHS}
    ordered_tp = _check_gemm(
        gen, f"dequant_matmul_ordered (recurrent tp={TP} up shards)",
        [(m, k, n, gs) for a in REC_ARCHS for _, k, n, gs in tp_shapes[a][:1]
         for m in (1, 4)], "ordered", kernel,
        lambda x, ql, dt: dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=ql.group_size,
            compute_dtype=dt), phase="kernels-rec")
    wire = []
    for a in REC_ARCHS:
        _, k, n, gs = tp_shapes[a][1]
        ql = _quantized(gen, k, n, gs).ordered
        for m in (1, 4):
            x = torch.randn(m, k, generator=gen, device="cuda")
            wire += [dict(_wire_case(ql, x, (k, n, gs, TP, 8, 128), dtype),
                          arch=a) for dtype in TOL]
    line("kernels-rec", "dequant_matmul_wire_ordered at the recurrent "
         f"tp={TP} down shards (K N gs: " + ", ".join(
             "{} {} {}".format(*tp_shapes[a][1][1:]) for a in REC_ARCHS)
         + f"; int8 wire, M 1/4, f32 and bf16): {len(wire)} cases bit-equal "
         "to K1 + the collective's quantizer, at most {:.3g} quantization "
         "levels beyond the GEMM outputs' own difference from the plain "
         "version (tol 1)".format(
             max(r["levels_beyond_gemm_gap"] for r in wire)))

    def err_tp(a):
        (_, k, n, _), (_, kd, nd, _) = tp_shapes[a]
        f32 = str(torch.float32)
        return {"K1": max(r["max_abs_err"] for r in ordered_tp["cases"]
                          if (r["m"], r["k"], r["n"], r["dtype"]) ==
                          (4, k, n, f32)),
                "K3": max(r["max_abs_err"] for r in wire
                          if (r["m"], r["k"], r["n"], r["dtype"]) ==
                          (4, kd, nd, f32))}

    out = {"errs": {a: {"K1": err(ordered, a), "K4": err(gidx, a)}
                    for a in REC_ARCHS},
           "errs_tp": {a: err_tp(a) for a in REC_ARCHS},
           "check": {"ordered": ordered, "gidx": gidx,
                     "ordered_tp": ordered_tp, "wire_tp": wire}}
    for a in REC_ARCHS:
        gated = rec_config(a).mlp_gated
        out[a] = {}
        for layout, name in (("ordered", "K1"), ("naive", "K4")):
            r = _time_gemm(gen, layout, shapes=shapes[a])
            r["layer"] = _layer(r, shapes[a], gated)
            out[a][layout] = r
            line("kernels-rec", "{} f32 M=4 {}, CUDA-graph replay: ".format(
                name, a) + "; ".join(
                    "{} (K {} N {} gs {}) {:.4f} ms (bound {:.4f} by {}: "
                    "{:.2f} MB; plain {:.4f})".format(
                        nm.split(" ", 1)[1], k, n, gs, r[nm]["ms"],
                        r[nm]["bound_ms"], r[nm]["bound_by"],
                        r[nm]["bytes"] / 1e6, r[nm]["plain_ms"])
                    for nm, k, n, gs in shapes[a])
                + "; per layer {:.4f} ms (bound {:.4f}, plain {:.4f})".format(
                    r["layer"]["ms"], r["layer"]["bound_ms"],
                    r["layer"]["plain_ms"]))
            torch.cuda.empty_cache()
        (up, k, n, gs), down = tp_shapes[a]
        r = _time_gemm(gen, "ordered", shapes=[tp_shapes[a][0]])[up]
        # one rank's layer: the up (and gate) shard's K1 launches
        n_up = 2 if gated else 1
        r["layer"] = {key: n_up * r[key]
                      for key in ("ms", "plain_ms", "bound_ms")}
        r["layer"]["bound_by"] = r["bound_by"]
        w = _time_wire(gen, shape=down)
        out[a]["tp2"] = {"up": r, "wire": w}
        w8 = w["int8"]
        line("kernels-rec", f"f32 M=4 {a} tp={TP}, one rank, CUDA-graph "
             f"replay: K1 up shard (K {k} N {n} gs {gs}) {r['ms']:.4f} ms "
             f"(bound {r['bound_ms']:.4f} by {r['bound_by']}; plain "
             f"{r['plain_ms']:.4f}), x{n_up} a layer; K3 down shard (K "
             f"{down[1]} N {down[2]} gs {down[3]}) int8 {w8['ms']:.4f} ms in "
             f"{w8['device_kernels_per_call']} device kernel(s) a call "
             f"(bound {w8['bound_ms']:.4f} by {w8['bound_by']}: "
             f"{w8['bytes'] / 1e6:.2f} MB; plain {w8['plain_ms']:.4f}; K1 "
             f"+ plain quantizer {w8['unfused_ms']:.4f}), int4 "
             f"{w['int4']['ms']:.4f} ms; K1 alone {w['k1_alone_ms']:.4f}")
        torch.cuda.empty_cache()
    return out


def _reuse_requests(cfg) -> list:
    """Six greedy requests of 4-31 prompt tokens and unequal
    ``max_new_tokens`` (``REC_REUSE_NEW``), each seeded by its rid: at 4
    slots the early finishers' lanes take the last two."""
    rng = np.random.default_rng(29)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(4, 32))).astype(np.int32),
        max_new_tokens=n, seed=i) for i, n in enumerate(REC_REUSE_NEW)]


def _slot_reuse(engine, cfg, arch: str) -> dict:
    """The continuous scheduler over the recurrent state with slot reuse:
    ``_reuse_requests`` greedy at 4 slots (row block 4), then each alone
    through the same engine's ``Engine.generate`` (batch 1): every
    request's ids equal and every emitted logits row bit-equal; at least
    one request entered a lane another had used (``admissions``), which
    ``Engine.reset_slot`` zeroed first."""
    what = f"slot-reuse {arch}"
    eng = _sibling(engine, max_seq=REC_MAX_SEQ, row_block=4)
    sched = Scheduler(eng, max_batch=4, prompt_budget=REC_BUDGET,
                      scfg=GREEDY, seed=0)
    reqs = _reuse_requests(cfg)
    run = _recorded_serve(eng, cfg, GREEDY, "dequant_matmul_ordered", what,
                          sched=sched, requests=reqs)
    reused = [rid for step, rid in sched.admissions if step > 0]
    if not reused:
        raise AssertionError(f"{what}: no request entered a used lane "
                             f"(admissions {sched.admissions})")
    solo_steps = 0
    reset_counts()
    for req in reqs:
        ids, rows = _solo_rows(eng, req, GREEDY)
        solo_steps += req.prompt.size + req.max_new_tokens - 1
        if ids != run["ids"][req.rid] or not torch.equal(
                rows, run["logits"][req.rid]):
            gap = (rows - run["logits"][req.rid]).abs().max().item()
            raise AssertionError(
                f"{what}: request {req.rid} alone gave ids {ids[:8]} "
                f"against {run['ids'][req.rid][:8]} batched (max logit gap "
                f"{gap:.3g})")
    counts = read_counts()
    expect_counts(counts, {"dequant_matmul_ordered":
                           mlp_launches(cfg) * solo_steps},
                  f"{what}, solo ({solo_steps} decode steps)")
    out = {"requests": len(reqs), "max_new": list(REC_REUSE_NEW),
           "admissions": sched.admissions, "reused_lanes_by": reused,
           "batched_steps": run["steps"],
           "batched_launches": run["launches"],
           "steady_ms_per_step": run["steady_ms_per_step"],
           "solo_steps": solo_steps,
           "solo_launches": counts["dequant_matmul_ordered"],
           "ids": run["ids"], "bit_equal": True}
    line(what, f"{len(reqs)} greedy requests (max_new {list(REC_REUSE_NEW)}) "
         f"at 4 slots, row block 4, through the captured step: requests "
         f"{reused} entered used lanes (admissions {sched.admissions}); "
         f"each alone (Engine.generate, batch 1): ids equal and every "
         f"emitted logits row bit-equal ({run['steps']} batched steps, "
         f"{run['steady_ms_per_step']:.2f} ms a step; {solo_steps} solo "
         f"steps; K1 {run['launches']} + {out['solo_launches']} launches)")
    del eng, sched, run
    torch.cuda.empty_cache()
    return out


def _rec_forward(engine, cfg, arch: str) -> dict:
    """The full-sequence forward of ``REC_FORWARD_S`` tokens
    (``Engine.prefill_logits``; recurrentgemma's local attention on the
    einsum path) against the same tokens replayed through the captured
    decode step of an engine of ``max_seq`` past them, on ``engine``'s
    params: in float32 activations with a float32 state and K/V ring,
    within 2e-2 of max|logit| (the reference's bound); in the config's
    bf16 activations and bf16 K/V ring, reported (the ring's rounding of
    K and V, which the reference's decode also makes and its forward
    does not, moves a random 26-layer model's logits far).  K1 once per
    MLP weight in each forward (M = 64, its decode loop) and per step in
    each replay."""
    what = f"forward {arch}"
    per = mlp_launches(cfg)
    toks = torch.from_numpy(np.random.default_rng(30).integers(
        0, cfg.vocab_size, (1, REC_FORWARD_S))).cuda()
    out = {"tokens": REC_FORWARD_S}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        eng = Engine(model=build_model(cfg.with_(dtype=name)),
                     params=engine.params, device=engine.device,
                     max_seq=REC_FORWARD_S + 1, policy=engine.policy,
                     row_block=4)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = eng.prefill_logits(toks)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        expect_counts(read_counts(), {"dequant_matmul_ordered": per},
                      f"{what}, {name} (M = {REC_FORWARD_S})")
        cache = eng.model.init_cache(1, eng.max_seq, dtype=dtype,
                                     device=eng.device)
        outs = []
        reset_counts()
        t0 = time.perf_counter()
        for t in range(REC_FORWARD_S):
            logits, cache = eng.decode(cache, toks[:, t], t)
            outs.append(logits)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        expect_counts(read_counts(), {"dequant_matmul_ordered":
                                      per * REC_FORWARD_S},
                      f"{what}, {name} replay ({REC_FORWARD_S} steps)")
        dec = torch.stack(outs, dim=1)
        if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
            raise AssertionError(f"{what}, {name}: logits not finite")
        if tuple(full.shape) != (1, REC_FORWARD_S, cfg.vocab_size):
            raise AssertionError(f"{what}: forward {tuple(full.shape)}")
        gap = (dec - full).abs().max().item() / full.abs().max().item()
        out[name] = {"forward_s": forward_s, "replay_s": replay_s,
                     "gap_over_max_logit": gap, "argmax_agreement": (
                         dec.argmax(-1) == full.argmax(-1)).float().mean(
                         ).item()}
        if dtype == torch.float32 and gap >= 2e-2:
            raise AssertionError(f"{what}: the float32 forward against its "
                                 f"decode replay: gap {gap:.3g} of "
                                 f"max|logit|, bound 2e-2")
        del eng, cache, outs, dec, full
    f32, b16 = out["float32"], out["bfloat16"]
    line(what, f"prefill_logits of {REC_FORWARD_S} tokens "
         f"({'einsum local attention, ' if cfg.family == 'hybrid' else ''}"
         f"K1 {per} launches) against the replay through the captured "
         f"decode step ({per * REC_FORWARD_S} K1 launches): float32 "
         f"activations and state, max gap {f32['gap_over_max_logit']:.3g} "
         f"of max|logit| (bound 2e-2), argmax agreement "
         f"{f32['argmax_agreement']:.3f} (forward {f32['forward_s']:.2f}s, "
         f"replay {f32['replay_s']:.2f}s); bf16 activations and K/V ring "
         f"[reported]: gap {b16['gap_over_max_logit']:.3g}, argmax "
         f"agreement {b16['argmax_agreement']:.3f} (forward "
         f"{b16['forward_s']:.2f}s, replay {b16['replay_s']:.2f}s)")
    return out


@torch.inference_mode()
def _rec_attention_layers(engine, toks) -> tuple[list, list]:
    """recurrentgemma's forward over ``toks`` in float32 activations, one
    superblock at a time on the einsum forward's carries: for each local
    attention layer (its attention, then its MLP, on the residual), the
    float32 output through the flash kernel and through the einsum path
    on the same input."""
    from repro_torch.models import rglru

    cfg = engine.model.cfg.with_(dtype="float32")
    params, policy = engine.params, engine.policy
    x = cm.embed_tokens(cfg, params["embed"], toks)
    outs = {"flash": [], "xla": []}
    for sp in rglru.blocks(params["super"]):
        y, _ = rglru.rec_layer_forward(cfg, sp["rec1"], x, policy,
                                       rglru.REC1_PATH)
        y, _ = rglru.rec_layer_forward(cfg, sp["rec2"], y, policy,
                                       rglru.REC2_PATH)
        ap = sp["attn"]
        xn = cm.apply_norm(cfg, ap["ln1"], y)
        for backend, into in outs.items():
            h = cm.attention_forward(cfg, ap["attn"], xn,
                                     window=cfg.local_window,
                                     attn_backend=backend, policy=policy)
            into.append(rglru._attn_mlp(cfg, ap, y, h, policy, None))
        x = outs["xla"][-1].to(x.dtype)
    return outs["flash"], outs["xla"]


def _rec_flash_forward(engine, cfg, arch: str) -> dict:
    """recurrentgemma's full-sequence forward of ``REC_FLASH_S`` tokens
    (past its 2048-token window) with ``attn_backend="flash"``, K2 at head
    dim 256 once per superblock, against the einsum forward on the same
    params, in the config's bf16 carry, in turns (einsum, flash, flash,
    einsum: the first forward of a length pays the allocator's warm-up):
    each forward's wall, the counted launches (K1 once per MLP weight, on
    its tensor-core loop at M = ``REC_FLASH_S``), the logits finite; the
    whole-model gap and the
    greedy ids reported, not held (the random 26-layer model amplifies
    the two attentions' float32 sum order through its bf16 carry).  Then
    each local attention layer on the einsum forward's float32 carries,
    flash against einsum, held to ``layerwise``."""
    what = f"flash {arch}"
    s, per = REC_FLASH_S, mlp_launches(cfg)
    ns = cfg.num_layers // 3
    toks = torch.from_numpy(np.random.default_rng(31).integers(
        0, cfg.vocab_size, (1, s))).cuda()
    res = {b: {"wall_ms": []} for b in ("flash", "xla")}
    logits = {}
    for backend in ("xla", "flash", "flash", "xla"):
        eng = dataclasses.replace(engine, attn_backend=backend)
        logits.pop(backend, None)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[backend] = eng.prefill_logits(toks)
        torch.cuda.synchronize()
        res[backend]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        expect_counts(counts, {
            "dequant_matmul_ordered": per, TC: per,
            "flash_attention": ns if backend == "flash" else 0},
            f"{what}, {backend} forward of {s} tokens")
        res[backend]["counts"] = counts
    lf, lx = logits.pop("flash"), logits.pop("xla")
    if tuple(lf.shape) != (1, s, cfg.vocab_size) or not (
            torch.isfinite(lf).all() and torch.isfinite(lx).all()):
        raise AssertionError(f"{what}: logits not finite of the expected "
                             f"shape")
    gap = (lf - lx).abs().max().item() / lx.abs().max().item()
    ids_f, ids_x = lf[0].argmax(-1), lx[0].argmax(-1)
    agree = (ids_f == ids_x).float().mean().item()
    last = {"flash": ids_f[-8:].tolist(), "xla": ids_x[-8:].tolist()}
    del lf, lx, ids_f, ids_x
    torch.cuda.empty_cache()
    outs, refs = _rec_attention_layers(engine, toks)
    lw = layerwise(outs, refs, f"{what}: local attention flash vs einsum")
    del outs, refs
    torch.cuda.empty_cache()
    out = dict(res, tokens=s, window=cfg.local_window,
               flash_launches=res["flash"]["counts"]["flash_attention"],
               max_logit_gap=gap, argmax_agree=agree, last_ids=last,
               layerwise=lw)
    line(what, "forward B1 S{} (window {}), in turns einsum, flash, flash, "
         "einsum: flash {} ms, einsum {} ms wall; flash_attention launches "
         "{} = {} superblocks a forward (head dim "
         "{}), K1 {} on the tensor-core loop; each local attention layer "
         "on the einsum forward's float32 carries, flash within {:.3g} "
         "(max abs; {:.3g} of max|.|) of einsum, held at 1e-5 of max|.| + "
         "1e-4; the whole bf16 forward free-running (reported): max logit "
         "gap {:.3g} of max|logit|, argmax agrees at {:.2f}% of positions, "
         "last 8 ids flash {} einsum {}".format(
             s, cfg.local_window,
             "/".join(f"{t:.1f}" for t in res["flash"]["wall_ms"]),
             "/".join(f"{t:.1f}" for t in res["xla"]["wall_ms"]),
             out["flash_launches"], ns,
             cfg.head_dim, res["flash"]["counts"][TC], lw["max_abs_err"],
             lw["max_rel_err"], gap, 100 * agree, last["flash"],
             last["xla"]))
    return out


def phase_serve_recurrent(arch: str) -> dict:
    """Phases 38-39 (``serve rwkv6-3b``, ``serve recurrentgemma-2b``): the
    arch at full width and depth from seed 0, tp-aware: the four requests
    of phase 5 through the continuous scheduler and the captured step
    (``phase_serve``: K1 once per MLP weight a step, counted; the first
    step with its capture and the steady step; the params' bytes and the
    init's peak); a few captured steps traced (K1's launches a step
    asserted, the busy share, the heaviest kernels); the captured step
    against ``decode_eager`` bit for bit; slot reuse against solo runs
    (``_slot_reuse``); the forward against the decode replay
    (``_rec_forward``); rwkv6's tp=1 artifact (``phase_artifact``: ids
    and greedy logits bit-equal to the in-memory engine) or
    recurrentgemma's flash forward against its einsum one
    (``_rec_flash_forward``); then naive-actorder (K4 once
    per MLP weight a step, K1 never)."""
    cfg = rec_config(arch)
    per = mlp_launches(cfg)
    engine, serve = phase_serve(cfg, "dequant_matmul_ordered",
                                f"serve {arch}")
    out = {"layers": cfg.num_layers, "launches_per_step": per,
           "serve": serve}
    # one step a profiler run: the profiler drops events the more a run
    # holds (about 1900 and 3400 kernels a step here)
    out["trace"] = tr = phase_trace(engine, {"K1": _is_k1}, f"trace {arch}",
                                    expect={"K1": per}, steps=1)
    k1 = tr["kernels"]["K1"]["launches_per_step"]
    if k1 != per:
        raise AssertionError(f"{arch}: {k1} K1 kernels per captured step on "
                             f"the device, expected {per}")
    steps = 4
    captures, offsets, recapture_s = _captured_vs_eager(
        engine, cfg, steps, f"capture {arch}")
    out["capture"] = {"steps_each": steps, "captures": captures,
                      "offsets": offsets, "recapture_s": recapture_s,
                      "bit_equal": True}
    line(f"capture {arch}", f"B=4: {steps} lockstep and {steps} per-slot "
         f"steps (offsets {offsets}) through the captured step bit-equal to "
         f"decode_eager (logits and every state leaf after each step); "
         f"captures {captures}, the recapture {recapture_s:.3f}s")
    out["slot_reuse"] = _slot_reuse(engine, cfg, arch)
    out["forward"] = _rec_forward(engine, cfg, arch)
    if cfg.family == "ssm":
        out["artifact"] = phase_artifact(
            cfg, memory_reference(engine, cfg, serve), f"artifact {arch}")
    else:
        out["flash"] = _rec_flash_forward(engine, cfg, arch)
    del engine
    torch.cuda.empty_cache()
    naive = rec_config(arch, "naive-actorder")
    nengine, out["serve_naive"] = phase_serve(
        naive, "dequant_matmul_gidx", f"serve-naive {arch}")
    s = out["serve_naive"]
    line(f"serve-naive {arch}", "naive-actorder on backend=cuda: K4 {} = "
         "{} x {} steps (K1 0), median step {:.2f} ms against tp-aware's "
         "{:.2f}".format(s["launches"], per, s["decode_steps"],
                         s["steady_ms_per_step"],
                         serve["steady_ms_per_step"]))
    del nengine
    torch.cuda.empty_cache()
    return out


def phase_serve_tp_rec(serve_rec: dict) -> dict:
    """Phase 42 (``serve-tp-rec``): each of ``REC_ARCHS`` at full width and
    tp=2 on two rank processes, depth cut to ``REC_TP_LAYERS`` (printed),
    through ``phase_serve_tp`` as phase 19 runs the dense archs: per rank
    and decode step K3 once per layer and K1 once per up (and gate)
    weight, the fused int8 ring bit-identical to the plain one, the
    ranks' tokens equal, psum at tp=2 held layer by layer to a tp=1
    engine of the same cut config and seed (recurrentgemma's block kinds
    follow its depth, so the full engine's first layers are not its
    reference), the greedy trace against tp=1 reported; then the eager
    tp=2 step's ms beside phases 38-39's captured tp=1 step."""
    out = {}
    for arch in REC_ARCHS:
        full = rec_config(arch)
        cfg = full.with_(num_layers=REC_TP_LAYERS[arch])
        what = f"serve-tp-rec {arch}"
        line(what, f"full width, depth cut from {full.num_layers} to "
             f"{cfg.num_layers} layers (the gloo step via host dominates); "
             f"the reference is a tp=1 engine of the same cut config and "
             f"seed")
        one = make_engine(cfg, 0, device="cuda", max_seq=32 + 16 + 1)
        trace = greedy_reference(one, cfg)
        carries, outputs = layer_trace(
            one, torch.from_numpy(_greedy_inputs(cfg)[0]).cuda())
        layers = ([c.cpu() for c in carries], [o.cpu() for o in outputs])
        del one, carries, outputs
        torch.cuda.empty_cache()
        serve, cross, _ = phase_serve_tp(
            cfg, trace, TP_PAIRS[:1], what, f"tp-crosscheck-rec {arch}",
            layers)
        tp1 = serve_rec[arch]["serve"]["steady_ms_per_step"]
        line(what, "the eager tp={} step over {}: {} ms a step (ranks 0/1, "
             "{} layers, the serve's mean) against phases 38-39's captured "
             "tp=1 step at {} layers: {:.2f} ms (steady median)".format(
                 TP, serve["transport"], "/".join(
                     f"{ms:.1f}" for ms in serve["ms_per_step"]),
                 cfg.num_layers, full.num_layers, tp1))
        out[arch] = {"layers": cfg.num_layers,
                     "full_layers": full.num_layers, "serve_tp": serve,
                     "tp_crosscheck": cross,
                     "tp1_full_depth_steady_ms_per_step": tp1}
    return out


# ---------------------------------------------------------------------------
# phase 43: the HTTP/SSE front end over the tp=2 ranks
# ---------------------------------------------------------------------------

#: phase 43's depth, phase 19's: the gloo step via host dominates
HTTP_TP_LAYERS = TP_ARCH_LAYERS
#: one rank's qwen3-4b up (and gate) shard at tp=2
UP_TP = (f"up/gate tp={TP}", UP[1], UP[2] // TP, UP[3])


def _check_time_http_tp(gen) -> dict:
    """K1 at phase 43's up and gate shard (qwen3-4b at tp=2) against its
    plain version (M 1 and 4, float32 and bfloat16, ``TOL``), then timed
    at M=4 (CUDA-graph replay, weights beyond L2) against its bytes
    bound; K3 at the down shard is phase 3's and phase 4's (``DOWN_TP``)."""
    check = _check_gemm(
        gen, f"dequant_matmul_ordered (qwen3-4b tp={TP} up shard)",
        [(m, *UP_TP[1:]) for m in (1, 4)], "ordered",
        lambda x, ql, dt: ops.dequant_matmul(x, ql, compute_dtype=dt),
        lambda x, ql, dt: dk.dequant_matmul_ordered_torch(
            x, ql.qweight, ql.scales, ql.zeros, group_size=ql.group_size,
            compute_dtype=dt), phase="http-tp")
    err = max(r["max_abs_err"] for r in check["cases"]
              if r["m"] == 4 and r["dtype"] == str(torch.float32))
    r = _time_gemm(gen, "ordered", shapes=[UP_TP])[UP_TP[0]]
    # one rank's layer: the up and gate shards' two K1 launches
    r["layer"] = {key: 2 * r[key] for key in ("ms", "plain_ms", "bound_ms")}
    r["layer"]["bound_by"] = r["bound_by"]
    line("http-tp", f"K1 f32 M=4 at one rank's up shard (K {UP_TP[1]} N "
         f"{UP_TP[2]} gs {UP_TP[3]}), CUDA-graph replay: {r['ms']:.4f} ms "
         f"(bound {r['bound_ms']:.4f} by {r['bound_by']}: "
         f"{r['bytes'] / 1e6:.2f} MB; plain {r['plain_ms']:.4f}), x2 a layer")
    torch.cuda.empty_cache()
    return {"check": check, "max_abs_err": err, "up": r}


def _http_tp_rank(ctx, cfg, disconnect: dict, hang_up_after: int) -> dict:
    """One rank of phase 43: this rank's slices of ``cfg`` under
    ``TP_SERVE`` from a ``PAGED`` pool of its KV heads.  Rank 0 serves
    the clients from a ``ServingServer`` over the group (the
    disconnecting one first, then ``_paged_requests``' eight once it has
    a token); rank 1 follows its boundaries.  The launch counts are set
    to 0 just before and read just after; each step's slot occupancy is
    recorded; then both ranks serve the completed requests (rank 0's
    rids, in admission order) through an in-process ``Scheduler``."""
    import threading

    from repro_torch.serving import ServingServer, follow

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    engine = make_engine(cfg.with_quant(collective=TP_SERVE), 0,
                         device=ctx.device, max_seq=PAGED_MAX_SEQ,
                         group=ctx.group)
    engine = dataclasses.replace(engine, policy=engine.policy.with_(kv=PAGED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kw = {"max_batch": 4, "prompt_budget": 40, "scfg": SEEDED, "seed": 0}
    occupancy: list = []

    def recorded(sched):
        step = sched.step

        def run():
            events = step()
            occupancy.append(tuple(None if s is None else s.req.rid
                                   for s in sched._slots))
            return events

        sched.step = run
        return sched

    out = {"rank": ctx.rank, "transport": ctx.transport, "init_s": init_s,
           "decode_mode": engine.decode_mode,
           "backend": engine.policy.backend,
           "collective": engine.policy.collective.shorthand()}
    reset_counts()
    t0 = time.perf_counter()
    if ctx.rank == 0:
        srv = ServingServer(engine, queue_capacity=16, group=ctx.group,
                            **kw)
        sched = recorded(srv.loop.scheduler)
        results: dict = {}
        first = threading.Event()

        def client(key, body, **how):
            results[key] = _http_stream(srv.port, body, **how)

        srv.start()
        try:
            out["health"] = _http_get(srv.port, "/v1/health")
            threads = [threading.Thread(target=client, args=(
                "disconnect", disconnect), kwargs={
                    "hang_up_after": hang_up_after, "first": first})]
            threads[0].start()
            if not first.wait(timeout=120):
                raise AssertionError("http-tp: no first token in 120 s")
            threads += [threading.Thread(target=client, args=(
                req.rid, {"prompt": [int(t) for t in req.prompt],
                          "max_new_tokens": req.max_new_tokens,
                          "seed": req.seed}))
                for req in _paged_requests(cfg)]
            for t in threads[1:]:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if any(t.is_alive() for t in threads):
                raise AssertionError("http-tp: a client did not finish")
            out["wall_s"] = time.perf_counter() - t0
            out["stats"] = _http_get(srv.port, "/v1/stats")
        finally:
            srv.shutdown(drain=True, timeout=120)
        if srv.loop.error is not None:
            raise RuntimeError("http-tp: the engine loop failed") from \
                srv.loop.error
        out.update(streams=results, log=srv.loop.controller.log,
                   boundaries=srv.loop.controller.sent)
    else:
        sched = recorded(Scheduler(engine, **kw))
        res = follow(sched, ctx.group)
        out.update(log=res["log"], boundaries=res["received"])
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["counts"] = read_counts()
    out.update(steps=sched.steps, occupancy=occupancy,
               admissions=list(sched.admissions),
               finished={rid: (r.output, r.cancelled)
                         for rid, r in sched.finished.items()})
    sched.release_cache()
    solo = Scheduler(engine, **kw)
    for _, rid in sched.admissions:
        r = sched.finished[rid]
        if not r.cancelled:
            solo.submit(Request(rid=rid, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens,
                                seed=r.seed))
    t0 = time.perf_counter()
    out["replay"] = {rid: r.output for rid, r in solo.run().items()}
    out["replay_s"] = time.perf_counter() - t0
    return out


def phase_http_tp(kernels: dict, smi: str) -> dict:
    """Phase 43 (``http-tp``): qwen3-4b at full width, ``HTTP_TP_LAYERS``
    layers, tp=2 ``TP_SERVE`` with ``PAGED`` on the pool's two ranks
    behind the HTTP/SSE front end (``ServingServer(group=...)``, rank 1
    following rank 0's boundaries): 8 SSE clients on threads at once
    (max_batch 4, so slots are reused), each stream start / 16 tokens /
    done, the ids those of the same requests through an in-process tp=2
    ``Scheduler`` on the same ranks, rank 1's token log rank 0's; per
    rank K1 2 and K3 1 a layer a decode step; a ninth client hangs up
    mid-stream, and its slot is taken by the next admission on both
    ranks.  ``kernels``: ``_check_time_http_tp``'s."""
    full = QWEN.with_quant(mode="mlp", scheme="tp-aware", backend="auto")
    cfg = full.with_(num_layers=HTTP_TP_LAYERS)
    line("http-tp", f"full width, depth cut from {full.num_layers} to "
         f"{cfg.num_layers} layers (phase 19's: the gloo step via host "
         f"dominates)")
    rng = np.random.default_rng(43)
    disconnect = {"prompt": rng.integers(0, cfg.vocab_size, 8).tolist(),
                  "max_new_tokens": 40, "seed": 99}
    hang_up = 4
    t0 = time.perf_counter()
    ranks = POOL.run(_http_tp_rank, cfg, disconnect, hang_up, timeout=600)
    r0, r1 = ranks
    steps = r0["steps"]
    k1_per, k3_per = mlp_launches(cfg) - cfg.num_layers, cfg.num_layers
    for r in ranks:
        expect_counts(r["counts"], {
            "dequant_matmul_ordered": k1_per * r["steps"],
            "dequant_matmul_wire_ordered": k3_per * r["steps"]},
            f"http-tp rank {r['rank']} ({r['steps']} decode steps)")
        if r["backend"] != "cuda" or r["collective"] != "quant-int8:128:fused":
            raise AssertionError(f"http-tp rank {r['rank']} ran "
                                 f"{r['backend']} / {r['collective']}")
    for key in ("log", "steps", "occupancy", "admissions", "finished",
                "boundaries", "replay"):
        if r1[key] != r0[key]:
            raise AssertionError(f"http-tp: rank 1's {key} differs from "
                                 f"rank 0's")
    if not r0["log"] or r0["health"]["kv"] != PAGED:
        raise AssertionError(f"http-tp: empty log or health {r0['health']}")
    streams = dict(r0["streams"])
    cut = streams.pop("disconnect")
    ids = {}
    for rid, events in sorted(streams.items()):
        kinds = [k for k, _ in events]
        if kinds != ["start"] + ["token"] * 16 + ["done"]:
            raise AssertionError(f"http-tp: request {rid}'s stream {kinds}")
        ids[events[0][1]["rid"]] = [p["token"] for k, p in events
                                    if k == "token"]
    if ids != r0["replay"] or len(ids) != 8:
        raise AssertionError(f"http-tp: ids {ids} differ from the in-process "
                             f"tp=2 scheduler's {r0['replay']}")
    # the hung-up request: cancelled on both ranks, and its slot taken by
    # the next admission
    rid_cut = cut[0][1]["rid"]
    out_cut, cancelled = r0["finished"][rid_cut]
    if not cancelled or len(out_cut) >= disconnect["max_new_tokens"]:
        raise AssertionError(f"http-tp: the hung-up request {rid_cut} was "
                             f"not cut short ({len(out_cut)} tokens)")
    occ = r0["occupancy"]
    slot = next(row.index(rid_cut) for row in occ if rid_cut in row)
    last = max(i for i, row in enumerate(occ) if row[slot] == rid_cut)
    taken = next((row[slot] for row in occ[last + 1:]
                  if row[slot] is not None), None)
    later = [rid for _, rid in r0["admissions"]]
    if taken is None or later.index(taken) <= later.index(rid_cut):
        raise AssertionError(f"http-tp: slot {slot} of the hung-up request "
                             f"{rid_cut} was not taken by a later admission")
    stats = r0["stats"]
    lat = stats["latency_ms"]
    seconds = time.perf_counter() - t0
    out = {"layers": cfg.num_layers, "full_layers": full.num_layers,
           "transport": r0["transport"], "decode_steps": steps,
           "counts": [r["counts"] for r in ranks],
           "boundaries": r0["boundaries"], "stats": stats,
           "wall_s": r0["wall_s"], "run_s": [r["run_s"] for r in ranks],
           "replay_s": r0["replay_s"], "init_s": [r["init_s"] for r in ranks],
           "ms_per_step": [r["run_s"] / steps * 1e3 for r in ranks],
           "hung_up": {"rid": rid_cut, "tokens": len(out_cut),
                       "slot": slot, "taken_by": taken},
           "ids_equal": True, "seconds": seconds, "nvidia_smi": smi,
           "kernels": kernels}
    line("http-tp", f"{describe(cfg)} behind ServingServer at tp={TP} "
         f"({r0['transport']}; {r0['collective']}, kv "
         f"{r0['health']['kv']}): 8 concurrent SSE clients, every stream "
         f"start/token x16/done; ids equal the same requests through an "
         f"in-process tp={TP} Scheduler on the same ranks "
         f"({r0['replay_s']:.1f}s), rank 1's token log rank 0's; request "
         f"{rid_cut} hung up after {len(out_cut)} tokens and its slot "
         f"{slot} went to request {taken} on both ranks; {steps} decode "
         f"steps, boundaries {r0['boundaries']}; per rank "
         f"dequant_matmul_ordered {r0['counts']['dequant_matmul_ordered']} "
         f"= {k1_per} x {steps} and dequant_matmul_wire_ordered "
         f"{r0['counts']['dequant_matmul_wire_ordered']} = {k3_per} x "
         f"{steps} (decode step: {r0['decode_mode']})")
    line("http-tp", f"[{r0['transport']}: prices a function, not a TP "
         f"speed; {smi}] TTFT p50 {lat['ttft']['p50']} / p90 "
         f"{lat['ttft']['p90']} ms, ITL p50 {lat['itl']['p50']} / p90 "
         f"{lat['itl']['p90']} ms, tokens/s {stats['tokens']['per_s']}, "
         f"{out['ms_per_step'][0]:.1f} ms a step (rank 0), clients' wall "
         f"{r0['wall_s']:.2f}s; the phase {seconds:.1f}s")
    return out


#: the training phase: qwen3-4b's dense model at full width through the
#: trainer's CLI, in a child process
TRAIN_ARCH = "qwen3-4b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 128
#: the step-0 loss of the random model within this of ln(vocab)
TRAIN_LOSS0_GAP = 1.5
#: each family's smoke step, card against CPU (float32 carry and stubs),
#: from the same params and batch:
#: * every leaf's gradient within ``FAMILY_GRAD_TOL`` of that leaf's
#:   max|grad| on the CPU (the tolerance tests/test_torch_train_archs.py
#:   holds the port's gradients to against the reference), the same
#:   leaves without a gradient;
#: * the loss and the step's grad_norm within ``FAMILY_RTOL`` relative,
#:   but whisper's grad_norm within ``WHISPER_GNORM_RTOL``; and each
#:   card grad_norm within ``FAMILY_F64_RTOL`` of a float64 gradient's on
#:   the CPU.  Whisper's own bound has a measured cause: 77% of its
#:   |grad|^2 lies in attention projections (encoder layer 0's wk 42%, wv
#:   18%, decoder layer 0's self-attention wk 13%), and there the card's
#:   float32 and the CPU's round to opposite sides of the float64 value
#:   (|grad|^2 -9.4e-6 and +4.7e-6 of the total for encoder layer 0's
#:   wk; tools/train_grad_gaps.py), so they differ by 1.15e-5 where each
#:   is within 7e-6 of float64.  In the nine others the card's grad_norm
#:   lies within 1.3e-6 of float64, and card and CPU differ by 5.6e-6 at
#:   most.  Two runs on the card give bit-equal gradients, so no atomic
#:   adds are at play;
#: * the params after the step within ``FAMILY_PARAM_TOL`` of max|p| but
#:   at most ``FAMILY_PARAM_SHARE`` of the elements (AdamW's first
#:   direction g / (|g| + eps) is ill conditioned where g is near 0).
FAMILY_GRAD_TOL = 1e-4
FAMILY_RTOL = {"loss": 1e-5, "grad_norm": 1e-5}
WHISPER_GNORM_RTOL = 3e-5
FAMILY_F64_RTOL = 1e-5
FAMILY_PARAM_TOL = 1e-5
FAMILY_PARAM_SHARE = 1e-4
FAMILY_BATCH, FAMILY_SEQ = 2, 32
FAMILY_LR = 1e-3


def _train_child() -> dict:
    """The full-width trainer (``python -m repro_torch.launch.train``) in
    a child process, after this process has let go of its cached
    memory; its lines parsed and checked."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    line("train", f"before the trainer: {free} B free of {total} "
                  f"(torch.cuda.mem_get_info); this process holds {held} B "
                  f"allocated, {torch.cuda.memory_reserved()} B reserved")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([os.environ["PYTHONPATH"]]
                                       if os.environ.get("PYTHONPATH")
                                       else [])))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    out = proc.stdout.splitlines()
    for ln in out:
        line("train", f"trainer: {ln}")
    losses = [float(ln.split()[3]) for ln in out if ln.startswith("step ")]
    steps = re.search(r"first ([\d.]+) s, median of the rest ([\d.]+) "
                      r"s/step \(([\d.]+) s of it the batch\), ([\d.]+) "
                      r"tokens/s", proc.stdout)
    mem = re.search(r"param_count (\d+) \((\d+) param elements\), (\d+) B "
                    r"of train state reckoned .*, (\d+) B "
                    r"max_memory_allocated \((\d+) B reserved\)",
                    proc.stdout)
    launches = re.search(r"kernel launches: (\d+)", proc.stdout)
    if len(losses) != TRAIN_STEPS or not (steps and mem and launches):
        raise AssertionError(f"trainer output not understood:\n"
                             f"{proc.stdout}")
    vocab = get_config(TRAIN_ARCH).vocab_size
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"trainer: a loss is not finite: {losses}")
    if abs(losses[0] - math.log(vocab)) > TRAIN_LOSS0_GAP:
        raise AssertionError(f"trainer: step-0 loss {losses[0]} is not "
                             f"within {TRAIN_LOSS0_GAP} of ln({vocab}) = "
                             f"{math.log(vocab):.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"trainer: the loss did not fall: {losses}")
    if int(launches.group(1)):
        raise AssertionError(f"trainer: {launches.group(1)} counted kernel "
                             f"launches on the dense path, expected 0")
    res = {"cmd": " ".join(cmd[1:]), "losses": losses,
           "ln_vocab": math.log(vocab),
           "first_step_s": float(steps.group(1)),
           "s_per_step": float(steps.group(2)),
           "batch_s_per_step": float(steps.group(3)),
           "tokens_per_s": float(steps.group(4)),
           "param_count": int(mem.group(1)),
           "param_elements": int(mem.group(2)),
           "state_bytes_reckoned": int(mem.group(3)),
           "max_memory_allocated": int(mem.group(4)),
           "max_memory_reserved": int(mem.group(5)),
           "free_before": free, "total": total, "parent_allocated": held,
           "kernel_launches": int(launches.group(1)), "wall_s": wall}
    line("train", f"{TRAIN_ARCH} full width ({get_config(TRAIN_ARCH).num_layers}"
                  f" layers), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
                  f"{TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f} (ln V {math.log(vocab):.4f}); "
                  f"{res['s_per_step']:.4f} s/step after the first "
                  f"({res['first_step_s']:.4f} s), {res['tokens_per_s']:.1f} "
                  f"tokens/s; peak {res['max_memory_allocated'] / 2**30:.2f} "
                  f"GiB allocated against {res['state_bytes_reckoned'] / 1e9:.1f}"
                  f" GB ({res['state_bytes_reckoned'] / 2**30:.2f} GiB) of "
                  f"state reckoned; the child's {wall:.1f} s")
    return res


def _on(tree, device, dtype=torch.float32):
    """A copy of the tensors of ``tree`` on ``device``, its floating ones
    in ``dtype``."""
    return checkpoint.map_tensors(tree, lambda _, t: t.to(
        device, dtype if t.is_floating_point() else t.dtype, copy=True))


def _family_grads(model, params, batch, device, dtype=torch.float32):
    """The train loss of ``batch`` and every leaf's gradient (float64 on
    the CPU; None where autograd gives none) from a copy of ``params`` on
    ``device`` in ``dtype``."""
    params = trainstep.trainable(_on(params, device, dtype))
    loss = trainstep.loss_fn(model, params, _on(batch, device, dtype))
    loss.backward()
    return float(loss.detach()), {
        k: None if p.grad is None else p.grad.to("cpu", torch.float64)
        for k, p in checkpoint.flatten_keys(params).items()}


def _norm(grads: dict) -> float:
    return math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()
                         if g is not None))


def _family_step(model, params, batch, device):
    """One train step of ``model`` from a copy of ``params`` on
    ``device``: (metrics as floats, the params after it)."""
    params = trainstep.trainable(_on(params, device))
    state = {"params": params, "opt": topt.init_state(params)}
    step = trainstep.make_train_step(model, topt.AdamWConfig(
        lr=FAMILY_LR, warmup_steps=1, total_steps=TRAIN_STEPS))
    state, metrics = step(state, _on(batch, device))
    return {k: float(v) for k, v in metrics.items()}, state["params"]


def _train_families() -> dict:
    """One train step of each smoke config, float32 carry and stubs, the
    same port code on the card and on the CPU from the same params and
    batch, with each leaf's gradient beside it (and a float64 gradient
    on the CPU for scale); no counted kernel launched."""
    out = {}
    reset_counts()
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch).with_quant(mode="none").with_(
            dtype="float32")
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        batch = next(data_lib.batches(data_lib.DataConfig(
            seq_len=FAMILY_SEQ, global_batch=FAMILY_BATCH,
            vocab_size=cfg.vocab_size), device="cpu"))
        batch.update(stubs(cfg, FAMILY_BATCH, "cpu"))
        _, g_cpu = _family_grads(model, params, batch, "cpu")
        _, g_gpu = _family_grads(model, params, batch, "cuda")
        _, g_64 = _family_grads(build_model(cfg.with_(dtype="float64")),
                                params, batch, "cpu", torch.float64)
        graded = sorted(k for k, g in g_cpu.items() if g is not None)
        if graded != sorted(k for k, g in g_gpu.items() if g is not None):
            raise AssertionError(f"{arch}: the card and the CPU give "
                                 f"gradients to different leaves")
        grad_gap = {k: float((g_gpu[k] - g_cpu[k]).abs().max())
                    / max(float(g_cpu[k].abs().max()), 1e-30)
                    for k in graded if g_cpu[k].numel()}
        worst_leaf = max(grad_gap, key=grad_gap.get)
        n64 = _norm(g_64)
        vs64 = {"cpu": abs(_norm(g_cpu) - n64) / n64,
                "card": abs(_norm(g_gpu) - n64) / n64}
        m_cpu, p_cpu = _family_step(model, params, batch, "cpu")
        m_gpu, p_gpu = _family_step(model, params, batch, "cuda")
        torch.cuda.synchronize()
        a = {k: t.detach() for k, t in checkpoint.flatten_keys(p_cpu).items()}
        b = {k: t.detach().cpu() for k, t in
             checkpoint.flatten_keys(p_gpu).items()}
        pmax = max(float(t.abs().max()) for t in a.values() if t.numel())
        gaps = [(b[k] - a[k]).abs() for k in a if a[k].numel()]
        n = sum(g.numel() for g in gaps)
        outside = sum(int((g > FAMILY_PARAM_TOL * pmax).sum()) for g in gaps)
        rel = {k: abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k])
               for k in ("loss", "grad_norm")}
        rtol = dict(FAMILY_RTOL)
        if arch == "whisper-large-v3":
            rtol["grad_norm"] = WHISPER_GNORM_RTOL
        out[arch] = {"cpu": m_cpu, "card": m_gpu, "rel": rel,
                     "grad_norm_vs_float64": vs64,
                     "worst_grad_leaf": worst_leaf,
                     "worst_grad_gap": grad_gap[worst_leaf],
                     "param_elements": n, "outside": outside,
                     "max_param_gap": max(float(g.max()) for g in gaps),
                     "max_param": pmax}
        line("train", f"{arch} smoke step, card vs CPU: loss {m_gpu['loss']:.6f}"
                      f" / {m_cpu['loss']:.6f} (rel {rel['loss']:.2e}), "
                      f"grad_norm rel {rel['grad_norm']:.2e} (bound "
                      f"{rtol['grad_norm']:g}; against float64: card "
                      f"{vs64['card']:.2e}, bound {FAMILY_F64_RTOL:g}, CPU "
                      f"{vs64['cpu']:.2e}); worst "
                      f"gradient leaf {worst_leaf} at "
                      f"{grad_gap[worst_leaf]:.2e} of its max; params: "
                      f"{outside} of {n} beyond {FAMILY_PARAM_TOL:g} x "
                      f"max|p|")
        if (any(rel[k] > rtol[k] for k in rel)
                or vs64["card"] > FAMILY_F64_RTOL
                or grad_gap[worst_leaf] > FAMILY_GRAD_TOL
                or outside > FAMILY_PARAM_SHARE * n
                or m_gpu["step"] != m_cpu["step"]):
            raise AssertionError(f"{arch}: the card's train step is not the "
                                 f"CPU's within the stated tolerances: "
                                 f"{out[arch]}")
    counts = read_counts()
    expect_counts(counts, {}, "train steps of the ten smoke configs")
    out["counts"] = counts
    return out


def phase_train() -> dict:
    """Phase 40: the dense model trained on the card (see the module
    docstring)."""
    t0 = time.perf_counter()
    res = {"full": _train_child(), "families": _train_families()}
    res["seconds"] = time.perf_counter() - t0
    line("train", f"phase seconds {res['seconds']:.1f}; the path launched "
                  "none of the five kernels (counted in the trainer and in "
                  "this process)")
    return res


def phase_analysis(verified: dict) -> dict:
    """Phase 41: ``python -m repro_torch.analysis --ast --contracts --tp 2``
    as a user runs it, on the card (its AS rules over the port's sources;
    CT002 in process, CT001 on two rank processes sharing the card over
    gloo via host, CT003 and CT004 on every family's smoke model): exit
    0, no finding.  Beside it the ``serve verify`` runs of phases 17, 26
    and 36 (``verified``: name -> ``_verify_finish``'s result)."""
    fd, report_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--ast",
             "--contracts", "--tp", "2", "--json", report_path],
            cwd=ROOT, env=_src_env(), capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        with open(report_path) as f:
            report = json.load(f) if proc.returncode == 0 else None
    finally:
        os.unlink(report_path)
    counts = [text for text in proc.stdout.splitlines()
              if "finding(s)" in text]
    if proc.returncode != 0 or report["findings"]:
        raise AssertionError(f"analysis: exit {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-4000:]}")
    out = {"exit": proc.returncode, "lines": counts, "seconds": seconds,
           "rules_checked": report["rules_checked"], "verify": verified}
    line("analysis", f"python -m repro_torch.analysis --ast --contracts "
         f"--tp 2 on the card: exit 0 in {seconds:.1f}s ("
         + "; ".join(counts) + f"; {len(report['rules_checked'])} rules in "
         "the catalog); serve verify: " + "; ".join(
             f"{k} exit {v['exit']} {v['by_rule'] or 'no finding'} "
             f"{v['seconds']:.1f}s" for k, v in verified.items()))
    return out


def _entry(name, source, replaces, launches, max_abs_err, t: dict,
           library_ms=None) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": library_ms}


def _layer(res: dict, shapes=(UP, DOWN), gated: bool = True) -> dict:
    """One layer's launches (up, gate where gated, down) of a per-shape
    timing."""
    bound_by = ("bytes" if all(res[name]["bound_by"] == "bytes"
                               for name, *_ in shapes) else "operations")
    return {key: _per_layer(res, key, shapes, gated)
            for key in ("ms", "plain_ms", "bound_ms")} | {
                "bound_by": bound_by}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_device()
    build = phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = phase_check(gen)
    timing = phase_timing(gen)
    # after the timing phase, so that no CUDA graph of K3's calls is
    # captured before the kernels are timed
    checks["dequant_matmul_wire_ordered"]["repeats"] = _check_wire_repeat(gen)
    base = QWEN
    cfg = base.with_quant(mode="mlp", scheme="tp-aware", backend="auto")
    engine, serve = phase_serve(cfg, "dequant_matmul_ordered")
    per = mlp_launches(cfg)
    trace = phase_trace(engine, {"K1": _is_k1,
                                 "K1 decode loop": _is_k1_decode,
                                 "split-add": _is_split_add,
                                 "sgemm": _is_sgemm}, expect={"K1": per})
    k1, k1_decode = (trace["kernels"][label]["launches_per_step"]
                     for label in ("K1", "K1 decode loop"))
    if k1 != per or k1_decode != per:
        raise AssertionError(f"captured decode step: {k1} K1 kernels per "
                             f"step on the device, {k1_decode} of them the "
                             f"float32 decode loop's; expected {per} each")
    capture = phase_capture(engine, cfg, serve)
    cross = phase_crosscheck(engine, cfg)
    naive_cfg = base.with_quant(mode="mlp", scheme="naive-actorder",
                                backend="cuda")
    naive, serve_naive = phase_serve(naive_cfg, "dequant_matmul_gidx",
                                     "serve-naive")
    trace_naive = phase_trace(naive, {"K4": _is_k4,
                                      "split-add": _is_split_add},
                              "trace-naive",
                              expect={"K4": per, "split-add": 0})
    k4, split = (trace_naive["kernels"][label]["launches_per_step"]
                 for label in ("K4", "split-add"))
    if k4 != per or split:
        raise AssertionError(f"naive decode step: {k4} K4 kernels and "
                             f"{split} split-adds per step, expected {per} "
                             f"and 0")
    scheme_cross = phase_scheme_crosscheck(engine, naive, cfg)
    # (the greedy paged run it also returns holds the naive params)
    paged_naive = phase_serve_paged_pair(naive, naive_cfg,
                                         "dequant_matmul_gidx",
                                         "serve-paged-naive",
                                         seeded=False)[0]
    del naive
    torch.cuda.empty_cache()
    forward = phase_forward_flash(engine, cfg)
    materialize = phase_dequantize(engine)
    pool_s = POOL.start()
    line("rank-pool", f"{TP} rank processes over "
         f"{mesh.transport(TP, 'cuda')} up in {pool_s:.1f}s (imports, CUDA, "
         f"the group); the TP phases' rank functions run in them in turn")
    serve_tp, tp_cross, tp_traces = phase_serve_tp(
        cfg, greedy_reference(engine, cfg), paged=True)
    artifact = phase_artifact(cfg, memory_reference(engine, cfg, serve))
    artifact_tp = phase_artifact_tp(cfg, serve_tp, tp_traces, verify=True)
    serve_paged = phase_serve_paged(engine, cfg)
    serve_paged["naive"] = paged_naive
    serve_paged["tp2"] = serve_tp.pop("paged")
    http = phase_http(engine, cfg)
    batch_solo = phase_batch_solo(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    archs, refs = phase_serve_archs()
    tp_archs = phase_serve_tp_archs(refs)
    artifact_granite = phase_artifact_granite()
    long_forward = phase_long_forward()
    gptq = phase_gptq()
    fold, fold_ref = phase_fold(trace)
    fold_tp = phase_fold_tp(fold_ref)
    overlap_tp, overlap_dir, dp1_trace = phase_overlap_tp(gen)
    try:
        mesh_dp = phase_mesh_dp(overlap_dir, dp1_trace,
                                overlap_tp["sync_m2_vs_m4"])
    finally:
        shutil.rmtree(overlap_dir, ignore_errors=True)
    moe_serve, moe_engine = phase_serve_moe()
    moe_art, moe_dir, moe_dp1 = phase_artifact_moe(moe_engine)
    try:
        moe_ep = phase_moe_ep(moe_dir, moe_dp1)
    finally:
        shutil.rmtree(moe_dir, ignore_errors=True)
    moe_tp = phase_moe_tp(moe_engine)
    del moe_engine
    torch.cuda.empty_cache()
    av_kernels = _check_time_av(gen)
    serve_whisper = phase_serve_av(WHISPER)
    serve_vision = phase_serve_av(VISION)
    fold_whisper = phase_fold_whisper()
    rec_kernels = _check_time_rec(gen)
    serve_rec = {a: phase_serve_recurrent(a) for a in REC_ARCHS}
    serve_tp_rec = phase_serve_tp_rec(serve_rec)
    http_tp = phase_http_tp(_check_time_http_tp(gen), smi)
    POOL.close()                        # the trainer takes the whole card
    train = phase_train()
    analysis = phase_analysis({
        "artifact-tp (qwen3-4b tp=2)": artifact_tp["verify"],
        "fold-tp (clean)": fold_tp["verify"]["clean"],
        "fold-tp (planted)": fold_tp["verify"]["planted"],
        "fold-whisper": fold_whisper["verify"]})

    src = "src/repro_torch/csrc/"
    tpu = "src/repro/kernels/"
    large = timing["dequant_matmul_ordered_m2048"]
    kernels = [
        _entry("dequant_matmul_ordered", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", serve["launches"],
               checks["dequant_matmul_ordered"]["main_max_abs_err"],
               _layer(timing["dequant_matmul_ordered"])),
        # K1's tensor-core loop, on the forward's path (M=2048, per layer)
        _entry("dequant_matmul_ordered (tensor cores, M=2048)",
               src + "dequant_matmul_ordered.cuh",
               tpu + "dequant_matmul.py:104",
               forward["flash"]["counts"][TC],
               checks["dequant_matmul_ordered"]["m2048_max_abs_err"],
               {"ms": large["per_layer_ms"],
                "plain_ms": large["per_layer_plain_ms"],
                "bound_ms": large["per_layer_bound_ms"],
                "bound_by": "operations"}),
        _entry("dequant_matmul_gidx", src + "dequant_matmul_gidx.cu",
               tpu + "dequant_matmul.py:333", serve_naive["launches"],
               checks["dequant_matmul_gidx"]["main_max_abs_err"],
               _layer(timing["dequant_matmul_gidx"])),
        _entry("dequantize_ordered", src + "dequantize_ordered.cu",
               tpu + "dequant_matmul.py:398", materialize["launches"],
               checks["dequantize_ordered"]["main_max_abs_err"],
               _layer(timing["dequantize_ordered"])),
        _entry("flash_attention", src + "flash_attention.cu",
               tpu + "flash_attention.py:107", forward["flash_launches"],
               checks["flash_attention"]["main_max_abs_err"],
               timing["flash_attention"],
               timing["flash_attention"]["library_ms"]),
        _entry("dequant_matmul_wire_ordered",
               src + "dequant_matmul_wire_ordered.cu",
               tpu + "dequant_matmul.py:229", serve_tp["launches"],
               checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
               timing["dequant_matmul_wire_ordered"]["int8"]),
    ]
    # K2 on starcoder2's long forward (phase 21), timed in phase 4
    fl = timing["flash_attention_long"]
    kernels.append(_entry(
        "flash_attention (starcoder2-3b S8192 window 4096)",
        src + "flash_attention.cu", tpu + "flash_attention.py:107",
        long_forward["flash_launches"], fl["max_abs_err"], fl,
        fl["library_ms"]))
    # the same kernels on the paged cache's paths (phases 22 and 23)
    paged_key = f"greedy {PAGED}"
    kernels += [
        _entry(f"dequant_matmul_ordered ({PAGED} serve)",
               src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               serve_paged[paged_key]["launches"],
               checks["dequant_matmul_ordered"]["main_max_abs_err"],
               _layer(timing["dequant_matmul_ordered"])),
        _entry(f"dequant_matmul_gidx ({PAGED} serve)",
               src + "dequant_matmul_gidx.cu",
               tpu + "dequant_matmul.py:333",
               paged_naive[paged_key]["launches"],
               checks["dequant_matmul_gidx"]["main_max_abs_err"],
               _layer(timing["dequant_matmul_gidx"])),
        _entry(f"dequant_matmul_wire_ordered ({PAGED} serve, tp=2)",
               src + "dequant_matmul_wire_ordered.cu",
               tpu + "dequant_matmul.py:229",
               serve_paged["tp2"][0]["counts"]["dequant_matmul_wire_ordered"],
               checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
               timing["dequant_matmul_wire_ordered"]["int8"]),
        _entry("dequant_matmul_ordered (HTTP serve)",
               src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", http["launches"],
               checks["dequant_matmul_ordered"]["main_max_abs_err"],
               _layer(timing["dequant_matmul_ordered"])),
    ]
    # the same kernels on the other archs' paths (phases 18 and 19), per
    # layer at M=4 (K3: one rank's down projection, int8 wire)
    for a in ARCHS:
        for name, layout, key in (
                ("dequant_matmul_ordered", "ordered", "serve"),
                ("dequant_matmul_gidx", "naive", "serve_naive")):
            errs = checks[name]["arch_max_abs_err"]
            kernels.append(_entry(
                f"{name} ({a}, {archs[a]['layers']} layers)",
                src + f"{name}.cu", tpu + ("dequant_matmul.py:104"
                                           if layout == "ordered" else
                                           "dequant_matmul.py:333"),
                archs[a][key]["launches"],
                max(errs[shape[0]] for shape in ARCH_SHAPES[a]),
                timing["archs"][a][layout]["layer"]))
    for a in TP_ARCHS:
        kernels.append(_entry(
            f"dequant_matmul_wire_ordered ({a}, tp=2, {TP_ARCH_LAYERS} "
            f"layers)",
            src + "dequant_matmul_wire_ordered.cu",
            tpu + "dequant_matmul.py:229",
            tp_archs[a]["serve_tp"]["launches"],
            checks["dequant_matmul_wire_ordered"]["arch_max_abs_err"][
                ARCH_TP_DOWN[a][0]],
            timing["archs"][a]["wire"]["int8"]))
    # offline planning (phases 24-26): K1 on the GPTQ pair, on the fold's
    # V and O (per layer, M=4) beside the MLP's in the fold serve, and K3
    # where the tuner fused the tp=2 MLP
    k1_fold_err = max(checks["dequant_matmul_ordered"][
        "fold_max_abs_err"].values())
    kernels += [
        _entry("dequant_matmul_ordered (GPTQ pair)",
               src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", gptq["launches"],
               gptq["k1_max_abs_err"],
               _layer(timing["dequant_matmul_ordered"])),
        _entry("dequant_matmul_ordered (attn V->O fold serve; V and O per "
               "layer)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", fold["serve"]["launches"],
               k1_fold_err, _layer(timing["dequant_matmul_ordered_fold"],
                                   FOLD, gated=False)),
    ]
    chosen = parse_collective(fold_tp["collective"]).resolve("layers.mlp")
    if chosen.fused:
        kernels.append(_entry(
            f"dequant_matmul_wire_ordered (fold, tp=2 tuned "
            f"{chosen.shorthand()}, {fold_tp['layers']} layers)",
            src + "dequant_matmul_wire_ordered.cu",
            tpu + "dequant_matmul.py:229",
            fold_tp["counts"][0]["dequant_matmul_wire_ordered"],
            checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
            timing["dequant_matmul_wire_ordered"][f"int{chosen.bits}"]))
    # the :overlap epilogue (phases 27-28): K3 once per microbatch of the
    # fused ring, K1's down projection once per microbatch of the unfused
    # one (the greedy trace of phase 27), both timed at the microbatch
    k3_mb = timing["dequant_matmul_wire_ordered_mb"]
    ov_spec = parse_collective(overlap_tp["collective"]).resolve("layers.mlp")
    kernels += [
        _entry(f"dequant_matmul_wire_ordered (:overlap, tp=2 tuned "
               f"{ov_spec.shorthand()}, {overlap_tp['layers']} layers; once "
               f"per microbatch, M={OVERLAP_MB})",
               src + "dequant_matmul_wire_ordered.cu",
               tpu + "dequant_matmul.py:229",
               overlap_tp["counts"][0]["dequant_matmul_wire_ordered"],
               checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
               k3_mb[OVERLAP_MB][f"int{ov_spec.bits}"]),
        _entry(f"dequant_matmul_ordered (:overlap unfused ring, tp=2, "
               f"{overlap_tp['layers']} layers; the down projection once "
               f"per microbatch, M={OVERLAP_MB})",
               src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               overlap_tp["k1_down_launches_greedy"]["overlap unfused"],
               checks["dequant_matmul_ordered"]["main_max_abs_err"],
               timing["dequant_matmul_ordered_mb"]),
        _entry(f"dequant_matmul_wire_ordered ({mesh_dp['mesh']} grid, "
               f":overlap, {overlap_tp['layers']} layers; microbatches of "
               f"M={OVERLAP_MB // 2})",
               src + "dequant_matmul_wire_ordered.cu",
               tpu + "dequant_matmul.py:229",
               mesh_dp["counts"][0]["dequant_matmul_wire_ordered"],
               checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
               k3_mb[OVERLAP_MB // 2][f"int{ov_spec.bits}"]),
    ]
    # decode rows independent of the batch (phase 29): K1 on the batched
    # and the solo serves
    kernels.append(_entry(
        "dequant_matmul_ordered (batched against solo serves)",
        src + "dequant_matmul_ordered.cu", tpu + "dequant_matmul.py:104",
        sum(batch_solo[k]["batched_launches"] + batch_solo[k]["solo_launches"]
            for k in ("greedy", "seeded")),
        checks["dequant_matmul_ordered"]["main_max_abs_err"],
        _layer(timing["dequant_matmul_ordered"])))
    # the MoE family (phases 30-33): K1 (K4 under naive) once per GEMM of
    # every expert, per expert (up, gate, down) at its shapes
    errs = {name: max(checks[k]["arch_max_abs_err"][shape[0]]
                      for shape in MOE_SHAPES[a])
            for k, name in (("dequant_matmul_ordered", "K1"),
                            ("dequant_matmul_gidx", "K4"))
            for a in MOE_ARCHS[:1]}
    mt = timing["moe"]
    q = MOE_ARCHS[0]
    for a in MOE_ARCHS:
        kernels.append(_entry(
            f"dequant_matmul_ordered ({a} experts, "
            f"{moe_serve[a]['layers']} layers; per expert: up, gate, down, "
            "M=4)", src + "dequant_matmul_ordered.cu",
            tpu + "dequant_matmul.py:104", moe_serve[a]["serve"]["launches"],
            max(checks["dequant_matmul_ordered"]["arch_max_abs_err"][s[0]]
                for s in MOE_SHAPES[a]), mt[a]["ordered"]["expert"]))
    kernels += [
        _entry(f"dequant_matmul_gidx ({q} experts, naive-actorder; per "
               "expert, M=4)", src + "dequant_matmul_gidx.cu",
               tpu + "dequant_matmul.py:333",
               moe_serve[q]["serve_naive"]["launches"], errs["K4"],
               mt[q]["naive"]["expert"]),
        _entry(f"dequant_matmul_ordered ({q} artifact, {moe_art['layers']} "
               "layers; per expert, M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", moe_art["launches"],
               errs["K1"], mt[q]["ordered"]["expert"]),
        _entry(f"dequant_matmul_ordered ({q} dp2xtp1 expert parallelism, "
               f"process 0; per expert, M=8)",
               src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               moe_ep["counts"][0]["dequant_matmul_ordered"], errs["K1"],
               mt[q]["ordered_m8"]["expert"]),
        _entry(f"dequant_matmul_ordered ({q} tp=2 within-expert, rank 0; "
               "per expert slice, M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               sum(moe_tp["plans"][p]["counts"][0]["dequant_matmul_ordered"]
                   for p in MOE_TP_PLANS), errs["K1"],
               mt[q]["ordered_tp2"]["expert"]),
    ]
    # the audio and vision families (phases 34-36): K1 on whisper's
    # decoder MLP (per layer, M=4) and its encoder's (the tensor-core
    # loop, M = 4 x 1500), K4 under naive-actorder, K1 on the vision
    # model's MLP, K2 on its 2048-token forward, K1 on whisper's fold V
    # and O
    ak, sw, sv = av_kernels, serve_whisper, serve_vision
    enc = ak["whisper_encoder"]
    kernels += [
        _entry(f"dequant_matmul_ordered ({WHISPER} decoder MLP, 32 layers; "
               "per layer M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               sw["serve"]["launches"] - sw["serve"]["encoder_tc_launches"],
               ak["errs"]["whisper"], ak["whisper"]["layer"]),
        _entry(f"dequant_matmul_ordered (tensor cores, {WHISPER} encoder "
               f"MLP, M={4 * get_config(WHISPER).encoder_seq}; per layer)",
               src + "dequant_matmul_ordered.cuh",
               tpu + "dequant_matmul.py:104",
               sw["serve"]["encoder_tc_launches"],
               ak["errs"]["whisper_encoder"],
               {"ms": enc["per_layer_ms"],
                "plain_ms": enc["per_layer_plain_ms"],
                "bound_ms": enc["per_layer_bound_ms"],
                "bound_by": "operations"}),
        _entry(f"dequant_matmul_gidx ({WHISPER}, naive-actorder: decoder "
               "MLP and encoder MLP; timed per decoder layer, M=4)",
               src + "dequant_matmul_gidx.cu", tpu + "dequant_matmul.py:333",
               sw["serve_naive"]["launches"], ak["errs"]["whisper_naive"],
               ak["whisper_naive"]["layer"]),
        _entry(f"dequant_matmul_ordered ({VISION}, {VISION_LAYERS} layers; "
               "per layer M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", sv["serve"]["launches"],
               ak["errs"]["vision"], ak["vision"]["layer"]),
        _entry(f"flash_attention ({VISION} S{AV_FORWARD_S} forward, "
               f"{sv['forward_flash']['flash_launches']} self layers)",
               src + "flash_attention.cu", tpu + "flash_attention.py:107",
               sv["forward_flash"]["flash_launches"],
               ak["flash_vision"]["max_abs_err"], ak["flash_vision"],
               ak["flash_vision"]["library_ms"]),
        _entry(f"dequant_matmul_ordered ({WHISPER} V->O fold artifact: "
               "decoder MLP, V and O, encoder MLP; timed V and O per "
               "decoder layer, M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104", fold_whisper["launches"],
               ak["errs"]["whisper_fold"], ak["whisper_fold"]["layer"]),
    ]
    # the recurrent families (phases 37-39): K1 on each arch's MLP pairs
    # (per layer, M=4) on its tp-aware serve, K4 on its naive one
    for a in REC_ARCHS:
        rk, sr = rec_kernels, serve_rec[a]
        kernels += [
            _entry(f"dequant_matmul_ordered ({a}, {sr['layers']} layers; "
                   "per layer M=4)", src + "dequant_matmul_ordered.cu",
                   tpu + "dequant_matmul.py:104",
                   sr["serve"]["launches"], rk["errs"][a]["K1"],
                   rk[a]["ordered"]["layer"]),
            _entry(f"dequant_matmul_gidx ({a}, naive-actorder; per layer "
                   "M=4)", src + "dequant_matmul_gidx.cu",
                   tpu + "dequant_matmul.py:333",
                   sr["serve_naive"]["launches"], rk["errs"][a]["K4"],
                   rk[a]["naive"]["layer"]),
        ]
    # the recurrent families at tp=2 (phase 42), one rank: K1 on its up
    # (and gate) shards per layer, K3 on its down shard (int8 wire), each
    # timed at M=4
    for a in REC_ARCHS:
        rk, st = rec_kernels, serve_tp_rec[a]
        counts, n = st["serve_tp"]["counts"][0], st["layers"]
        kernels += [
            _entry(f"dequant_matmul_ordered ({a} tp=2, {n} layers; one "
                   "rank's up shards per layer, M=4)",
                   src + "dequant_matmul_ordered.cu",
                   tpu + "dequant_matmul.py:104",
                   counts["dequant_matmul_ordered"], rk["errs_tp"][a]["K1"],
                   rk[a]["tp2"]["up"]["layer"]),
            _entry(f"dequant_matmul_wire_ordered ({a} tp=2, {n} layers; "
                   f"down shard K {rec_tp_shapes(rec_config(a))[1][1]}, "
                   "int8 wire, M=4)",
                   src + "dequant_matmul_wire_ordered.cu",
                   tpu + "dequant_matmul.py:229",
                   counts["dequant_matmul_wire_ordered"],
                   rk["errs_tp"][a]["K3"], rk[a]["tp2"]["wire"]["int8"]),
        ]
    # the HTTP front end at tp=2 (phase 43), one rank: K1 on its up and
    # gate shards per layer, K3 on its down shard (int8 wire), at M=4
    ht = http_tp
    kernels += [
        _entry(f"dequant_matmul_ordered (HTTP serve at tp=2, "
               f"{ht['layers']} layers; one rank's up and gate shards per "
               "layer, M=4)", src + "dequant_matmul_ordered.cu",
               tpu + "dequant_matmul.py:104",
               ht["counts"][0]["dequant_matmul_ordered"],
               ht["kernels"]["max_abs_err"], ht["kernels"]["up"]["layer"]),
        _entry(f"dequant_matmul_wire_ordered (HTTP serve at tp=2, "
               f"{ht['layers']} layers; down shard, int8 wire, M=4)",
               src + "dequant_matmul_wire_ordered.cu",
               tpu + "dequant_matmul.py:229",
               ht["counts"][0]["dequant_matmul_wire_ordered"],
               checks["dequant_matmul_wire_ordered"]["main_max_abs_err"],
               timing["dequant_matmul_wire_ordered"]["int8"]),
    ]
    # K2 at head dim 256 on recurrentgemma's flash forward (phase 39),
    # timed at its S 2048 shape in phase 4
    fr, rg = timing["flash_attention_rec"], serve_rec["recurrentgemma-2b"]
    kernels.append(_entry(
        f"flash_attention (recurrentgemma-2b D256, S{REC_FLASH_S} window "
        f"2048 forward; timed at S2048)", src + "flash_attention.cu",
        tpu + "flash_attention.py:107", rg["flash"]["flash_launches"],
        checks["flash_attention"]["rec_max_abs_err"], fr,
        fr["library_ms"]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "build": build, "check": checks,
                   "timing": timing, "serve": serve, "trace": trace,
                   "capture": capture,
                   "crosscheck": cross, "serve_naive": serve_naive,
                   "trace_naive": trace_naive,
                   "scheme_crosscheck": scheme_cross,
                   "forward_flash": forward, "dequantize": materialize,
                   "serve_tp": serve_tp, "tp_crosscheck": tp_cross,
                   "artifact": artifact, "artifact_tp": artifact_tp,
                   "serve_archs": archs, "serve_tp_archs": tp_archs,
                   "artifact_granite": artifact_granite,
                   "long_forward": long_forward,
                   "serve_paged": serve_paged, "http": http,
                   "gptq": gptq, "fold": fold, "fold_tp": fold_tp,
                   "overlap_tp": overlap_tp, "mesh_dp": mesh_dp,
                   "batch_solo": batch_solo, "serve_moe": moe_serve,
                   "artifact_moe": moe_art, "moe_ep": moe_ep,
                   "moe_tp": moe_tp, "kernels_av": av_kernels,
                   "serve_whisper": serve_whisper,
                   "serve_vision": serve_vision,
                   "fold_whisper": fold_whisper,
                   "kernels_rec": rec_kernels, "serve_recurrent": serve_rec,
                   "serve_tp_recurrent": serve_tp_rec,
                   "http_tp": http_tp,
                   "rank_pool_startup_s": pool_s,
                   "train": train, "analysis": analysis,
                   "kernels": kernels,
                   "phase_seconds": phase_seconds(),
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    line("done", f"chip_smoke.py in {time.perf_counter() - t_start:.1f}s; "
                 "by phase: " + ", ".join(
                     f"{k} {v:.1f}" for k, v in phase_seconds().items()))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        POOL.close()
