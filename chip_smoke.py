#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only     # phases 18, 19, 27, 29's TP part
                                          # (several cards)
    python3 chip_smoke.py --faults-only   # phases 20-21 alone
    python3 chip_smoke.py --serve-only    # phases 22-24 and 18's shrink
    python3 chip_smoke.py --tp-decode-only    # phase 27, 29's TP part
    python3 chip_smoke.py --flash-only    # flash attention's phases 3, 25
    python3 chip_smoke.py --moe-only      # phase 28 alone
    python3 chip_smoke.py --families-only # phase 29 alone
    python3 chip_smoke.py --hybrid-audio-only # phase 30 alone
    python3 chip_smoke.py --tooling-only  # phase 31 alone

Drives the port (``src/repro_torch``) through its own entry points and
fails (non-zero exit, no result line) if any phase fails:

1. Environment: torch / CUDA versions, the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build: every kernel source under ``src/repro_torch/kernels/csrc/``,
   one ``nvcc`` each, all at once, into the git-ignored build directory.
3. Kernel parity at the serve path's shapes: each kernel against its
   plain PyTorch version on the same inputs (page gather bf16 and int8 ->
   bf16 bit-exact; flash attention on unit-variance q/k/v, the scale
   qk-norm gives, so scores have std ~1: bf16 at atol 4e-3 / rtol 8e-3,
   one output rounding, and f32 at atol 1e-4, S in {16, 64, 512}, plus a
   window 64 + softcap 2 case where the cap binds), then device times from
   CUDA events (median of repeats, calls queued behind a GPU sleep so host
   overhead is excluded, inputs rotated past the 50 MB L2) of the kernel,
   its plain version and the library yardstick (flash also at S 128 against
   SDPA, printed only).
4. Serve qwen3-0.6b at full width (28 layers, d_model 1024, bf16, seeded
   random weights) through ``ServeEngine`` on a 16-request trace with
   graph decode (the engine's default on the card: one captured CUDA graph
   per engine, warmed up and captured on a 2-request trace first), with an
   fp pool and with an int8 pool; an eager-decode engine serves a short
   trace (``SHORT_REQUESTS`` requests of ``SHORT_NEW`` new tokens), and
   the graph engine must serve it to
   the same tokens. Launch counters are set to 0 just before each run and
   read just after; the run must complete every request, capture decode
   once, and launch each kernel of its path (page gather twice per layer
   per decode step, also inside graph replays; flash attention once per
   layer per admission).
5. End to end, kernel vs plain: a 2-layer full-width f32 model serves one
   short trace with ``use_kernel=True`` and ``use_kernel=False`` (fp and
   int8 pools), and the smoke model serves one on the card (eager and
   graph decode) and one on the CPU; the greedy tokens must be identical.
6. Train qwen3-0.6b at full width (28 layers, bf16, remat full, tied
   151,936-vocab head) through ``run_experiment``: backup 6 + 2 workers,
   batch 2 per worker, seq 256, rmsprop_momentum, EMA 0.999, the spmd
   backend at mesh 1 x 1, 3 steps. The backup_reduce counter is set to 0
   just before and read just after: one launch per step. Step 1 again
   with ``use_kernel=False``: the same mask and sim_time, the loss within
   rel 1e-3, and the aggregated gradient bit-equal.
   Then the main path: the same 3 steps as one chunk (``chunk_size`` 3)
   through the trainer's CUDA graph (step 1 eager and the capture, then
   replays; counters set to 0 just before, read just after: 3 reduces),
   held to the eager run: the same masks and sim_time, losses and
   per-tensor parameter sums bit-equal; the capture time, a chunk of
   replays' host wall per step, the device busy per step (a profiled
   chunk) and the peak memory (allocated, reserved) are printed.
   Then backup_reduce against its plain version, bit-exact, at the run's
   [8, P] stack (P = 596,049,920 parameters) and at edge shapes W in
   {2, 3, 8}, P in {1, 3, 4097, 65536}, all-zero / all-one / mixed masks,
   aligned and unaligned bases, and its device times as in phase 3.
7. At reduced depth (2 layers, full width, f32): the sim and the spmd
   backends give the same parameters (atol 1e-5), and a checkpoint saved
   at step 1, restored and continued for 2 steps equals 3 steps run
   straight through.
8. The wkv kernels (``rwkv6_scan.cu``, forward and backward) against the
   plain twin at rwkv6-1.6b's training shape (B 2, S 256, H 32, D 64, bf16
   r/k/v, f32 w/u) and at edge shapes (D in {16, 32, 64}, S in {1, 16,
   40, 100}, f32 and bf16, with and without a final-state gradient): the
   forward's f32 output within atol 1e-4 x max|out|, the backward's f32
   gradients within rel 1e-4 of max|grad| (dw 5e-4: d log w / w amplifies
   rounding where w is small); then the kernels' device times as in
   phase 3: the forward with and without its chunk states (its column
   slice, the state columns a block carries, logged); the backward whole
   and pass by pass (the dS scan and the chunk-local gradients); and the plain
   twin's device busy time per call from torch.profiler (its hundreds of
   kernels per call overflow the launch queue, so they cannot be queued
   behind a sleep).
9. Train rwkv6-1.6b at full width (24 layers, d_model 2048, 32 wkv heads
   of 64, d_ff 7168, vocab 65,536, bf16, remat full) through
   ``run_experiment``: backup 3 + 1 workers (the most that fit: see
   ``launch/profile_train.WORKERS``), batch 2 per worker, seq 256,
   rmsprop_momentum, EMA 0.999, spmd at mesh 1 x 1, 3 steps. The counters
   are set to 0 just before and read just after: 2 wkv forwards per layer
   per worker per step (forward and remat recompute), of which 1 writes
   the chunk states (the recompute: the first pass's saved tensors are
   thrown away), 1 backward, 1 backup_reduce per step. Step 1 again with
   ``model.use_kernel = False`` (the plain wkv, no wkv launch; ~10 s a
   step): the same mask and sim_time, the loss within rel 1e-3 and
   finite. Then the main path, as in phase 6: the 3 steps as one chunk
   through the CUDA graph, with the eager run's launch counts (576 / 288 /
   288 / 3, replays included), bit-equal to the eager run.
10. At 2 layers, full width, f32: the kernel run against the plain run,
   step 1's loss within rel 1e-5 and the first aggregated gradient within
   rel L2 1e-4.
11. The event regimes on qwen3-0.6b at full width (``EVENT_LAYERS`` of
   28 layers, bf16,
   remat full, ``PaperCalibrated`` stragglers, seed 0, 2 x 256 tokens per
   arrival, rmsprop_momentum lr 0.02, EMA 0.999, the sim backend;
   ``launch/profile_train.event_config``): async with W = 8 (8 updates),
   softsync with W = 8, c = 4 (4 updates, 16 arrivals), each per arrival
   (``chunk_size`` 1) and then as one chunk through the event graphs (one
   captured graph for an arrival that applies, one for an arrival that
   buffers). The graph run equals the per-arrival run bit for bit:
   losses, per-tensor parameter sums, sim_time, staleness and selected.
   Captures, capture seconds, host wall per arrival and per update (a
   second run of as many updates on the same trainer) and peak memory are
   printed.
12. rwkv6-1.6b at full width (``EVENT_LAYERS`` of 24 layers, bf16, remat
   full), async W = 4, 4 updates, per arrival and through the graphs: the
   counters set to 0 just before and read just after each run count 32
   wkv forwards (2 x 4 x 4, replays included), 16 of them writing chunk
   states, 16 backwards and no backup_reduce; the two runs bit-equal.
13. The §2.1 rig: ``MnistCNN`` at its published widths (32, 32, 64, 64)
   on ``mnist_like`` (8,192 images), staleness tau 2 ramped over 5
   updates, 10 updates through ``Trainer`` with the model and batch_fn
   overrides, chunk 1 against chunk 4 (cuDNN deterministic): the same
   staleness sequence, bit-equal losses and parameters.
14. At 2 layers, full width, f32, async W = 4 and staleness tau 2, from
   the CPU port's draw of the weights: a checkpoint at update 2,
   restored and continued, equals the straight run (atol 1e-6), and the
   straight graph run equals the CPU port's per-arrival run (atol
   1e-5).
15. The paper's Figs. 5 and 6 at the tiny size (``repro_torch.benchmarks``,
   TF32 off): 20 synchronous SGD steps at N = 2 on the card against the
   same steps on the CPU port, every loss within 1e-4; then Fig. 5's
   steps to the target held-out loss for N in {1, 2, 4, 8} on the card,
   its fit iters(N) = a + c/N, and Fig. 6's best N + b split of 100
   machines from that fit (or the paper's, when the fit is too flat to
   extrapolate).
16. Figs. 8/9 at full width (``bench_sync_vs_async.run_full_width``):
   qwen3-0.6b (cut to ``FIGS89_LAYERS`` of 28 layers for the call's time,
   width unchanged; bf16) on the synthetic stream cut to 512 ids,
   2 x 256 tokens a worker, SGD at the swept base lr, backup 6 + 2 and
   full sync 8 (40 steps each, spmd: ``backup_reduce`` every step) and
   async W = 8 (160 updates) and softsync W = 8, c = 2 (80 updates) on
   the event graphs, every step a graph replay. The backup_reduce counter
   is set to 0 just before and read just after: one launch per mask step
   (80). Gates: every loss finite, and every regime's last train loss at
   least ``FALL_NATS`` below its first. Printed, not gated: steps,
   sim_time and card wall to the target loss, the final held-out loss,
   host wall per step or update, peak memory, and the paper's claims.
   Then rwkv6-1.6b at full width cut to ``RWKV_CONVERGING_LAYERS`` of its
   24 layers (backup 3 + 1, spmd, the same stream and base lr, 12 steps
   through the graph) through the wkv kernels (counted: 2 x L x 4
   forwards a step at L layers, half writing chunk states, L x 4
   backwards, one reduce) and with ``model.use_kernel = False`` (no wkv
   launch): both loss trajectories and the relative gap per step are
   printed (every loss finite). Then the ROADMAP Queue 3 controls on the
   same bf16 run, each printed per step beside the kernel's gap: (i) the
   plain twin against itself with ``NUDGED_LEAF`` nudged by one bf16 ulp;
   (ii) the kernel forward with the plain twin's backward, and the plain
   forward with the kernel backward (two ``autograd.Function`` classes
   here, not on the main path); and the verdict, the kernel's largest gap
   against ``CONTROL_FACTOR`` times control (i)'s. Then the kernel/plain
   pair at 2 layers in f32, a control without bf16 rounding.
17. Batched worker gradients at full width (``grad_batch``: the engine's
   ``torch.func.vmap`` over groups of workers), one chunk of 3 steps
   through the CUDA graph each: qwen3-0.6b (backup 6 + 2) at grad_batch 0
   and 2, rwkv6-1.6b (backup 3 + 1) at 2 (at 0 it does not fit the card).
   Each is held to phase 6's
   or 9's grad_batch 1 run: the same masks, selected and sim_time, step
   1's loss within rel 1e-3, and the first aggregated gradient no more
   than ``BATCHED_ERR_FACTOR`` times as far (rel L2) from the same step's
   gradient computed in f32 from the same weights as grad_batch 1's (the
   batched products round bf16 otherwise; the later steps' loss gaps are
   printed, not gated: RMSProp's
   first step at lr 0.12, eps 1e-8 turns rounding near g = 0 into
   full-size updates, which is why phase 9 gates its step 1 alone), and its
   launches counted through the replays (one backup_reduce a step; per
   layer and group of workers two wkv6 forwards, one writing the chunk
   states, and one backward). Host wall a step, device busy, peak memory
   and the capture time are printed. Then at 2 layers, full width, f32,
   TF32 off: grad_batch 0 and 2 against 1, parameters within atol 1e-5.
   Last, a record (not gated): qwen3-0.6b at ``EPS_RECORD_LAYERS`` of 28
   layers, grad_batch 0 against 1 at RMSProp eps 1e-3, the loss rel gap
   per step.
18. The spmd engine's ``'data'`` axis over ranks (``distributed.mesh.
   spawn``, one process each). With 2 or more cards: NCCL over 2 ranks
   (and 4 with 4 cards), one card each: qwen3-0.6b backup 6 + 2 at full
   width (W_local 4 or 2) and, on 4 cards, rwkv6-1.6b backup 6 + 2 (W_local
   2), 3 steps as one chunk through the graph with the all-reduce captured;
   every rank's parameter sums and losses bit-identical, the losses
   finite, one backup_reduce a step on every rank. With one card: 2 ranks
   over gloo on CUDA tensors on it (a line says NCCL was not run and why).
   Both: at 2 layers in f32 the mesh run within atol 1e-5 of the one-card
   run. Any rank that fails fails the script. Last, the rescale that
   shrinks the ``'data'`` axis (``Trainer.rescale`` over ranks): with one
   card 2 gloo ranks at 2 layers f32, chunk 1, full sync over 4 workers at
   a global batch of 12, one worker killed at step 2 (3 workers,
   ``mesh_data`` 2 -> 1): rank 1 idles (no step after the kill, every
   barrier), rank 0's losses within atol 1e-5 of the same plan on the
   card alone; with four cards 4 NCCL ranks at full width (the phase-6
   cell at grad_batch 0, chunks of 2 through the graph), 5 workers killed
   at step 2 (3 alive, 2 for the 16 sequences, ``mesh_data`` 4 -> 2): the
   live ranks bit-identical, the rebuilt graph (the shrunk data group's
   all-reduce inside) captured once and replayed, ``backup_reduce`` on
   each live rank's ``[1, P]``. ``python3 chip_smoke.py --mesh-only``
   runs the build and phases 18, 19 and 27 alone.
19. The ``'model'`` axis (tensor parallelism) over ranks: with one card 2
   gloo ranks at mesh 1 x 2 (the full-width run cut to ``TP_GLOO_LAYERS``
   layers), with 2 or more NCCL over one card a rank
   (``--mesh-only`` on four cards: 1 x 2, 1 x 4, 2 x 2).
20. The device straggler backend (``straggler_backend='device'``):
   each of the four samplers at ``SAMPLER_DRAWS`` f32 draws on the card
   against as many numpy draws of its ``LatencyModel`` (mean, std and the
   ``SAMPLER_QUANTILES`` within rel 0.05); ``device_batch_fn`` at noise 0
   on the card is the closed-form chain; qwen3-0.6b at full width (cut
   to ``DEVICE_LAYERS`` of 28 layers) on the
   sim backend (backup 6 + 2, the stream cut to ``DATA_VOCAB`` ids,
   rmsprop_momentum at ``FAULT_LR`` x N),
   8 steps as chunks of 4 + 4 and as one chunk of 8: losses, selected,
   sim_time and parameter checksums bit-equal, every chunk's device masks
   and times equal to the host ``BackupWorkers.select`` on the same
   arrivals copied back, row by row. The host backend's wall per step on
   the same cell is printed beside the device backend's (a record).
21. Faults on the spmd engine, qwen3-0.6b at full width cut to
   ``FAULT_LAYERS`` layers (a 28-layer checkpoint holds 8.35 GB and the
   runs write 7, past a chip call's disk budget; backup 6 + 2, grad_batch
   1, chunks of 4 through the graph, checkpoints every 4):
   ``FAULT_SPEC`` at fault seed 0 under ``run_supervised`` gives the
   recovery log ``FAULT_LOG``; the same plan without the preemption
   (checkpointed only at its rescale) matches the unfaulted run at steps
   1-2 bit for bit and ends in the supervised run's parameters and EMA
   bit for bit (the restore loses
   nothing); backup_reduce launches once a step (counted from 0 around
   the supervised run) and, on the first stack after the rescale (8 -> 4
   workers), equals its plain twin bit for bit; the peak device memory
   after the rescale lies within 1 GiB of the peak before it less the
   stack's freed rows ((8 - 4) x P x 4 bytes). Checkpoint bytes and save /
   restore seconds are printed. Then ``dynamic_backup`` at the same
   ``FAULT_LAYERS`` (cut from 28 for the call's time: its n is host
   logic, not the model's) (N = 8, b = 0, workers 6 and 7 slowed 5x, 16
   steps, no checkpoints): its adapted n below 8 and equal
   to the CPU port's host logic at the same seed; once more with
   ``latency_source='measured'``, n printed (a record).
22. Telemetry: the phase-6 cell at ``TELEMETRY_LAYERS`` of 28 layers
   (width unchanged), ``TELEMETRY_STEPS`` steps in chunks of
   ``TELEMETRY_CHUNK`` through the step graph, untraced and then with an
   ``obs.Tracer`` and an ``obs.MetricsRegistry``: losses, masks and
   parameter checksums bit-equal; span names within ``SPAN_NAMES``; one
   ``train/chunk`` root a chunk holding ``train/data_wait``,
   ``spmd/dispatch``, ``spmd/collective_wait`` and ``train/device_wait``;
   ``train/steps`` and the ``train/chunk_time_s`` count; the JSONL and the
   Chrome trace read back. The host wall a step of the replays-only chunk
   (untraced, traced, untraced again, in turns) and the fences' durations
   are printed.
23. The restore bridge: one step of the phase-6 cell cut to
   ``RESTORE_LAYERS`` layers (width unchanged; at 28 layers the 8.35 GB
   checkpoint's save and two reads took 62 s of the call), its checkpoint
   (saved and deleted here), ``serve.restore_params`` of the params and of
   the EMA: every tensor bit-equal to the trainer's (the EMA cast to
   bf16); the restored model and the trainer's in-memory model serve phase
   4's 16 requests to the same greedy tokens. Save and restore seconds are
   printed.
24. The replica router: ``ROUTER_REPLICAS`` ``StepSession`` replicas over
   one fp engine at full width, ``ROUTER_LAYERS`` of 28 layers (phase 4's
   geometry), ``ROUTER_REQUESTS``
   requests, hedging over ``ROUTER_HEDGE_AFTER``, the chaos plan
   ``ROUTER_FAULTS``: nothing lost, every completed request's tokens equal
   the single engine's, a second run's report bit-identical, page_gather
   and flash_attention counted (set to 0 just before, read just after)
   and each session's decode graph captured once; then an SLO shed run
   (target half the first run's p50): sheds, nothing lost, the same
   tokens. The router's counters, virtual p50 / p99 and wall tokens/s are
   printed.
25. The dense configs on the paged path. Flash attention at head_dim 256
   (``FLASH256_HEADS``, gemma3-1b's): the f32 and bf16 kernels against the
   plain twin (S 77 / 512 / 1000, causal, window 512, softcap 2; phase 3's
   tolerances), device times at gemma3-1b's prefill shape (B 1, S 512,
   bf16) against the plain twin, SDPA and the bound, and at its other
   prefill buckets (``FLASH256_TIMED_S``) against SDPA in the same call,
   each with the bf16 kernel's split (blocks, cluster size C, key tiles a
   block T) and the build's seconds; at S 512 the split against clusters
   of 1, 2, 4 and 8 blocks (forced through the capacity that
   ``split_plan`` reads, printed beside); the registers and spills ``nvcc
   -Xptxas -v`` reports for both D = 256 kernels (compiled beside the
   build), and for the bf16 D = 128 kernel, which must equal
   ``FLASH128_PTXAS``. gemma3-1b at full width (26 layers, d_model
   1152, head_dim 256, one kv head, windows of 512, vocab 262,144) serves
   phase 4's 16 requests as phase 4 does (fp and int8 pools, graph decode,
   the short trace eager, counters from 0, graph == eager), and at 2
   layers f32 the kernel path serves the plain path's tokens past its
   window. minitron-4b at full width and command-r-plus at
   ``COMMAND_R_LAYERS`` of 64 layers (width unchanged) serve ``DENSE_FEW``
   requests each through the decode graph, launches counted.
26. The toy path (``train.serve_step.greedy_generate`` over contiguous
   caches): gemma3-1b and qwen3-0.6b at full width (``TOY_RUNS``), fp and
   int8 caches; the stepped decode's last logits against ``prefill``'s
   within rel L2 ``TOY_LOGITS_REL`` (bf16); rwkv6-1.6b's ``prefill`` (the
   wkv6 forward kernel, one launch a layer) against ``TOY_RWKV_PROMPT``
   decode steps carrying the state, at full width within
   ``TOY_RWKV_CONTROL_FACTOR`` times the plain twin's own gap (bf16) and
   at 2 layers f32 within ``TOY_F32_REL``; gemma3-1b at 2 layers f32 past
   its window of 512 (the local layers' ring buffers wrap): the stepped
   decode's last logits against ``prefill``'s within ``TOY_F32_REL`` and
   ``greedy_generate`` with fp and int8 caches; at 2 layers f32 the card's
   greedy tokens equal the CPU port's (gemma3, qwen3, rwkv6).
27. Tensor-parallel decode, ``ServeEngine(mesh_model=M)``: with one card 2
   gloo ranks on it, qwen3-0.6b at 2 layers f32, fp and int8 pools, eager
   decode: tokens equal the one-card engine's, the first decode step's
   logits within ``TP_SMALL_LOGITS_REL``; with 2 or more cards
   (``--mesh-only`` / ``--tp-decode-only`` on four) NCCL at M = 2 and 4,
   qwen3-0.6b at full width on phase 4's 16 requests, the decode graph
   capturing the model group's all-reduces and the vocab all-gather: the
   first decode step's logits within ``TP_LOGITS_REL`` of one card's (the
   gate), tokens compared and the first differing step printed, ms a
   decode step and GB a card.
28. The MoE family. qwen2-moe-a2.7b at full width (24 layers, d_model
   2048, 60 routed experts top-4 + 4 shared, capacity factor 1.25, vocab
   151,936, bf16 with the router f32: ``MOE_PARAMS`` parameters, seeded
   random weights) serves phase 4's 16 requests as phase 4 does (fp and
   int8 pools, graph decode, the short trace eager, graph == eager,
   page_gather and flash_attention counted from 0); then a decode step's
   device ms with every slot live at ``MOE_TIMED_LEN`` tokens beside its
   bytes bound (every weight but the embedding: the capacity dispatch runs
   each expert's product however few tokens it holds), the paged
   prefill's device ms per bucket of ``MOE_PREFILL_BUCKETS`` and the
   serve runs' peak memory. At 2 layers f32 (full width, capacity 1.25:
   one token an expert at 8 slots, so decode drops) the kernel path serves
   the plain path's tokens, fp and int8 pools. Training at
   ``MOE_TRAIN_LAYERS`` of 24 layers (full width; the full model's [W, P]
   stack does not fit the card): backup 3 + 1, spmd at grad_batch 0, no
   EMA (with it the run came within a few GB of the card's memory),
   ``MOE_TRAIN_STEPS`` steps eagerly and as one chunk through the CUDA
   graph, bit-equal, losses and aux finite, one backup_reduce a step
   (counted from 0). ``--moe-only`` runs the build and this phase alone.
29. The remaining transformer families. deepseek-v2-lite-16b at full
   width (27 layers, d_model 2048, MLA with kv_lora 512, rope 64, nope
   128, v 128; a dense first layer, then 64 routed experts top-6 + 2
   shared; ``DEEPSEEK_PARAMS`` parameters, seeded random weights, bf16)
   on the toy path (MLA is not paged, as in the reference): each layer's
   MLA alone, the absorbed ``mla_decode`` stepped over the prompt against
   the expanded ``mla_attend``, within ``TOY_LOGITS_REL``; the whole
   model's stepped decode's last logits against ``prefill``'s on
   ``TOY_MLA_SEEDS`` prompts within ``TOY_MLA_LOGITS_REL``;
   ``greedy_generate`` batch 2, 16 + 8 tokens, fp and int8 (bf16 latents),
   eager ms a step and peak memory; at 2 layers f32 the card's greedy
   tokens equal the CPU port's and an int8 request gives bf16 latents;
   training at ``DEEPSEEK_TRAIN_LAYERS`` of 27 layers, backup 3 + 1, spmd
   at grad_batch 0 with the EMA, ``FAMILY_TRAIN_STEPS`` steps eagerly and
   as one chunk through the CUDA graph, bit-equal, one backup_reduce a
   step (counted from 0). internvl2-2b at full width (``INTERNVL_PARAMS``):
   ``prefill`` over 256 seeded prefix embeddings + ``VLM_TEXT`` tokens
   against ``forward``'s last row, its device ms; the toy path (text
   only); training through prefix batches at ``INTERNVL_TRAIN_LAYERS`` of
   24 layers, backup 3 + 1, spmd at grad_batch 1, eagerly; at 2 layers f32
   card == CPU (tokens, and the prefix prefill within ``TOY_F32_REL``).
   Then MoE under tensor parallelism: phase 27's run on qwen2-moe-a2.7b
   (one card: 2 gloo ranks at 2 layers f32, fp and int8 pools, tokens
   equal the one-card engine's; ``--mesh-only`` / ``--tp-decode-only`` on
   four cards: NCCL at M = 2 and 4, the decode graph capturing the model
   group's collectives, at 2 layers f32 with fp and int8 pools tokens
   equal to one card's and the first decode step's logits within
   ``TP_SMALL_LOGITS_REL`` (the gate), at full width on phase 4's 16
   requests ms a step, GB a card and the logits' gap printed); in every
   run each MoE layer's input through a prefill and ``TP_MOE_STEPS``
   decode steps is the same bits on every rank.
   ``--families-only`` runs the build and this phase alone.
30. The last model families. hymba-1.5b at full width (32
   layers, d_model 1,600, 25 / 5 heads of 64, SSD state 16, window 1,024,
   d_ff 5,504, vocab 32,001; ``HYMBA_PARAMS`` parameters, seeded random
   weights, bf16) on the toy path: the stepped decode's last logits
   against ``prefill``'s on ``HYMBA_SEEDS`` prompts within
   ``HYMBA_LOGITS_REL``, ``greedy_generate`` batch 2, 16 + 8 tokens, fp and
   int8, eager ms a step and peak memory; one layer's attention over
   ``CHUNKED_S`` tokens, ``gqa_attend_chunked`` against ``gqa_attend``
   within ``CHUNKED_REL``, device ms of each; the ring past the window
   (``HYMBA_RING_LAYERS`` layers f32 stepped over ``HYMBA_RING_STEPS``
   positions, the last ones held to ``forward`` within ``TOY_F32_REL``);
   at 2 layers f32 the card's tokens equal the CPU port's; ``ssd_chunked``
   against ``ssd_scan`` at the training shape in f32 (the reference's
   1e-4). One deepseek-v2-lite-16b MLA layer over ``CHUNKED_S`` tokens:
   the long path against the dense formula within ``CHUNKED_REL``, device
   ms of each. whisper-tiny at full width (4 + 4 layers, d_model 384, 6
   heads of 64, 1,500 frames, vocab 51,865, ``WHISPER_PARAMS``, bf16):
   ``prime_cross_cache`` and the stepped decode against ``forward`` over a
   16-token prompt within ``TOY_LOGITS_REL``, ``greedy_generate`` batch 2,
   16 + 8 tokens, eager ms a step; async over 4 workers through
   ``batch_fn`` (frames in every batch), ``WHISPER_UPDATES`` updates per
   arrival and as event graph chunks, bit-equal. Last, hymba-1.5b training
   at ``HYMBA_TRAIN_LAYERS`` of 32 layers (``HYMBA_TRAIN_PARAMS``
   parameters): backup 3 + 1, spmd at grad_batch 1 with the EMA,
   ``FAMILY_TRAIN_STEPS`` steps eagerly and as one chunk through the CUDA
   graph, bit-equal, one backup_reduce a step (counted from 0).
   ``--hybrid-audio-only`` runs the build and this phase alone.
31. The planning tools (``launch/dryrun.py``, ``benchmarks/roofline.py``,
   ``distributed/compression.py``, the four remaining figures), ~25 s of
   the default call. The dry run plans on ``meta`` tensors rwkv6-1.6b at
   grad_batch 0, which must not fit the card (not run), and qwen3-0.6b's
   phase-17 grad_batch 0 cell, whose resident bytes are held to what the
   card holds after that graph run's first chunk (within
   ``DRYRUN_RESIDENT_REL``), its predicted eager peak printed beside the
   graph peak. The roofline's terms and ``mfu`` of that step from its
   device busy, and ``hbm_share`` of phase 4's timed graph decode. Then
   ``compress_with_error_feedback`` on the card over phase 6's first
   aggregated gradient (P = 596,049,920), ``EF_STEPS`` steps, card == CPU
   bit for bit (the CPU's steps run beside the dry runs), the telescoping
   within f32 rounding; Figs. 3-4 and Table 1 on the host, equal to the
   CPU's rows. ``--tooling-only`` runs the build and this phase alone,
   with fresh eager steps of qwen3-0.6b at grad_batch 1 and 0 in place of
   the earlier phases' runs (resident bytes and the eager peak, within
   ``DRYRUN_PEAK_REL``, gated, or an out-of-memory step the plan
   predicted; the gradient and the mfu from grad_batch 1), and Fig. 2 and
   Table 2 / Fig. 7 on the card at the reference's quick sizes, their
   boolean rows held.
32. A JSON line of per-kernel numbers (``launches`` is the count of one
   run of the main path that launches the kernel, named by
   ``launches_run``: the graph-decode serve runs, whose prefills stay
   eager, and the graph training runs; ``launches_batched_and_mesh``: those
   of phases 17 and 18's runs, the shrink's included; ``launches_faults``:
   phase 21's supervised run; ``launches_telemetry``: phase 22's three
   runs; ``launches_router``: phase 24's first router run;
   ``launches_dense``: phase 25's runs; ``launches_toy``: phase 26's rwkv6
   prefill; ``launches_moe``: phase 28's serve runs and training chunk;
   ``launches_families``: phase 29's training runs and TP decode runs;
   ``launches_hybrid_audio``: phase 30's hymba training graph run;
   flash at head_dim 256 is its own row, with ``ptxas``), then, as the last
   line, ``{"ok": true, "device": {...}}``.

Needs one card; exits non-zero when ``torch.cuda.is_available()`` is false.
A line ``[time] phase N: s`` follows each of phases 3-31.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
GATHER_SHAPE = dict(b=8, ps=16, kv=8, hd=128)
# phases 4 and 25: the eager decode runs serve this short trace (requests,
# new tokens a request), held to the graph engine on it; the graph runs
# serve the 16-request trace (eager steps cost 40-90 ms each, host-bound:
# on the 16-request trace, qwen3-0.6b's and gemma3-1b's eager runs took
# ~80 s of the call)
SHORT_REQUESTS = 8
SHORT_NEW = (4, 8)
FLASH_HEADS = dict(h=16, kv=8, d=128)
FLASH_SHORT_S = 128                # a short prompt of the serve trace
REDUCE_WORKERS = 8                 # backup 6 + 2
REDUCE_EDGES = dict(w=(1, 2, 3, 8), p=(1, 3, 4097, 65536),
                    masks=("zeros", "ones", "mixed"))
WKV_SHAPE = dict(b=2, s=256, h=32, d=64)    # rwkv6-1.6b's training call
WKV_EDGES = dict(d=(16, 32, 64), s=(1, 16, 40, 100))
WKV_TOL = dict(dr=1e-4, dk=1e-4, dv=1e-4, dw=5e-4, du=1e-4)
RWKV_PARAMS = 1_584_095_232        # repro.models.registry.param_count
FIG5_HOLD = dict(n=2, steps=20, atol=1e-4)
# nats each full-width regime's train loss must fall over its run: from
# ln(151,936) = 11.93 the swept base reaches ~6.3 (PERF.md, Findings)
FALL_NATS = 3.0
RWKV_CONVERGING_STEPS = 12
# phase 16's rwkv6-1.6b runs, cut in depth (of 24 layers) so that phases
# 22-24 fit the call: five bf16 runs and the controls took ~130 s at 24
# (4, then 2 so that phase 28 fits too)
RWKV_CONVERGING_LAYERS = 2
# phase 16's Figs. 8/9 regimes on qwen3-0.6b and phase 17's eps record,
# cut in depth (of 28 layers) so that phases 25-27 fit the call: the
# regimes took 72 s at 28 layers (4, then 2 so that phase 28 fits too;
# the eps record 4, then 2 so that phase 30 fits)
FIGS89_LAYERS = 2
EPS_RECORD_LAYERS = 2
# phases 11-12's depth (of 28 and 24 layers; width unchanged): at full
# depth the eager per-arrival runs took ~27 s of the default call
EVENT_LAYERS = 4
# phase 17: (arch, grad_batch values) of the batched full-width runs.
# rwkv6-1.6b at 0 (all 4 workers) runs out of the card's memory: at 2 it
# peaks at 69.1 GB allocated, 82.2 GB reserved (PERF.md, Findings)
BATCHED_RUNS = (("qwen3-0.6b", (0, 2)), ("rwkv6-1.6b", (2,)))
MESH_TIMEOUT_S = 300.0
# phase 19 on one card: the full-width run over 2 gloo ranks (1,856 gloo
# all-reduces a step at 28 layers, through host memory) cut in depth for
# the call's time; its one-card reference is cut alike
TP_GLOO_LAYERS = 4
# phase 17: a batched run's first aggregated gradient may lie at most this
# factor farther (relative L2) from the same step's gradient computed in
# f32 than grad_batch 1's bf16 gradient does: the batched products round
# bf16 otherwise, not worse
BATCHED_ERR_FACTOR = 2.0
# Queue 3's control (i): the leaf nudged by one bf16 ulp, and the factor of
# its gap within which the kernel's gap counts as rounding sensitivity
NUDGED_LEAF = "blocks.0.ln1.scale"
CONTROL_FACTOR = 4.0
# phase 20: the token stream's ids (device_batch_fn computes in int32, as
# the reference does, and refuses vocabularies over 46340), steps, and the
# draws of each sampler's distribution check: at 2^20 draws the 0.99
# quantile of PaperCalibrated spreads by ~3% from seed to seed alone
DATA_VOCAB = 512
DEVICE_STEPS = 8
# phase 20's depth (of 28 layers; width unchanged): three runs of 8 steps
# and their captures took ~15 s of the default call at full depth
DEVICE_LAYERS = 4
# phases 20-21's lr (x N): at train_config's 0.02 x N RMSProp's first step
# moves every weight by ~0.38 and the loss runs from 12.1 to 739 in 8 steps
# (PERF.md §6)
FAULT_LR = 2e-4
SAMPLER_DRAWS = 2 ** 24
SAMPLER_QUANTILES = (0.1, 0.5, 0.9, 0.99)
# phase 21: the chaos plan, its steps, and the recovery log the CPU port
# gives for it at seed 0 (tests/test_torch_faults.py holds it to JAX)
FAULT_SPEC = "crash@2:w1,slowdown@3:w0:x4:d3,crash@5:w2,crash@6:w3,preempt@9"
FAULT_STEPS = 12
# the supervised part's depth: a full-width (28-layer) checkpoint holds
# 8.35 GB and the plan writes 7 of them, past a chip call's disk budget;
# 2 layers (4 before) for the call's time: 6 saves and 3 restores
FAULT_LAYERS = 2
FAULT_LOG = [
    {"event": "worker_crash", "step": 2, "worker": 1},
    {"event": "worker_slowdown", "step": 3, "worker": 0, "factor": 4.0,
     "until": 6},
    {"event": "worker_crash", "step": 5, "worker": 2},
    {"event": "worker_crash", "step": 6, "worker": 3},
    {"event": "rescale", "step": 6, "from_workers": 8, "to_workers": 4},
    {"event": "preempt", "step": 9, "grace": True},
    {"event": "restore", "step": 9, "attempt": 1},
]
DYNAMIC_STEPS = 16
# phase 18's last part: steps of the run whose kill shrinks the data axis
SHRINK_STEPS = 6
# phase 22: the phase-6 cell's steps and chunk, traced and untraced, and
# its depth (of 28 layers; cut so that phase 28 fits the call: three
# captures at 28 layers took ~10 s each on a slow host)
TELEMETRY_STEPS = 8
TELEMETRY_CHUNK = 4
TELEMETRY_LAYERS = 4
# phase 24: the router's replicas, trace (arrivals 4 virtual units apart on
# average, so the SLO run's gate trips while requests still arrive),
# hedging floor and chaos plan (virtual units: decode steps)
ROUTER_REPLICAS = 3
ROUTER_REQUESTS = 32
ROUTER_RATE = 0.25
ROUTER_HEDGE_AFTER = 24.0
ROUTER_FAULTS = "crash@30:r1,restart@60:r1,slowdown@10:r2:x3:d40"
# the router's model depth (of 28 layers; width unchanged): at 28 the
# phase took 39 s of a call on a slow host, and phase 30 needed the time
ROUTER_LAYERS = 4


# phase 23's depth (of 28 layers): the restore bridge saves and reads one
# checkpoint twice, and at full width (8.35 GB) that took 62 s of the call
# (4, then 2 so that phase 30 fits)
RESTORE_LAYERS = 2
# phase 25: gemma3-1b's heads (flash at head_dim 256), command-r-plus's
# depth (of 64 layers: the whole model is over 200 GB in bf16), and the
# requests of the minitron-4b and command-r-plus runs
FLASH256_HEADS = dict(h=4, kv=1, d=256)
# the prefill buckets the serve trace runs at head dim 256, each timed
# against SDPA (512 is the row's shape)
FLASH256_TIMED_S = (128, 256, 512)
# ptxas (registers, spill stores, spill loads) of the bf16 D = 128 kernel,
# and its device ms at phase 3's shape, as they read before the head-dim-256
# kernel was written beside it (NVIDIA H100 80GB HBM3, 700 W, CUDA 12.8):
# the D = 256 kernel must leave both alone
FLASH128_PTXAS = (232, 0, 0)
FLASH128_MS = 0.019594
COMMAND_R_LAYERS = 2
DENSE_FEW = 4
# phase 26: (prompt, new tokens) of the full-width toy runs, their batch
# (each eager step costs 30-90 ms of the call, host-bound), (prompt, new
# tokens) of gemma3-1b's run past its window of 512 at 2 layers f32, and
# the bf16 gate on the stepped decode's last logits against prefill's
# (rel L2):
# bf16 keeps 8 mantissa bits (2^-8 = 3.9e-3 a rounding), rounded at other
# places by the two paths through 26-28 layers
TOY_RUNS = {"gemma3-1b": (16, 8), "qwen3-0.6b": (16, 8)}
TOY_BATCH = 2
TOY_WINDOW_RUN = (516, 4)
TOY_LOGITS_REL = 3e-2
# phase 26's rwkv6-1.6b: the prompt, and its gate on the stepped decode's
# last logits against the kernel prefill's at full width bf16: at most
# this factor times the gap the plain twin's prefill shows against the
# same steps (the bf16 roundings of a [1, S] and a [1, 1] product, not
# the kernel, make that gap, ~3.5e-2 at full width); at 2 layers f32
# (rwkv6, and gemma3 past its window) a fixed rel L2
TOY_RWKV_PROMPT = 64
TOY_RWKV_CONTROL_FACTOR = 1.5
TOY_F32_REL = 1e-4
# phase 27: the first decode step's logits of the TP engine against one
# card's (rel L2): bf16 at full width (the row-parallel partial sums are
# rounded to bf16 before the all-reduce); at 2 layers f32 the fp pool
# differs by summation order alone, while the int8 pool's quantizer turns
# an f32 ulp of K / V at a rounding boundary into one int8 step (1/127 of
# the head's largest value), so its limit is an eighth of a step
TP_LOGITS_REL = 3e-2
TP_SMALL_LOGITS_REL = {"fp": 1e-5, "int8": 1e-3}
# phases 27 and 29: the eager decode steps after a prefill through which
# every MoE layer's input is held bit for bit across the model group
TP_MOE_STEPS = 4
# phase 28: qwen2-moe-a2.7b's parameters (repro.models.registry.param_count
# of the reference), the slots' length and steps of the timed decode, the
# prefill buckets timed, and the training run's depth (of 24 layers: the
# [W, P] f32 stack of the full model alone would take 229 GB) and steps
MOE_PARAMS = 14_315_587_584
MOE_TIMED_LEN = 256
MOE_TIMED_STEPS = 20
MOE_PREFILL_BUCKETS = (64, 128, 256, 512)
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 2
# phase 29: the parameters of deepseek-v2-lite-16b and internvl2-2b
# (repro.models.registry.param_count of the reference), deepseek's at its
# training depth, the training runs' depths (deepseek: 2 of 27 layers, the
# dense one and an MoE one, whose [4, P] f32 stack at 27 layers would take
# 251 GB; internvl2: 12 of 24, whose 24 layers with the [4, P] f32 stack,
# the RMSProp state and the EMA would take ~72 GB, where phase 28's run
# ran out of the card's memory) and steps, internvl2's prefix of
# precomputed embeddings and the timed prefill's text tokens
DEEPSEEK_PARAMS = 15_706_484_224
DEEPSEEK_TRAIN_PARAMS = 1_085_287_424
DEEPSEEK_TRAIN_LAYERS = 2
INTERNVL_PARAMS = 1_889_634_304
INTERNVL_TRAIN_LAYERS = 12
FAMILY_TRAIN_STEPS = 2
FAMILY_TOY_RUN = (16, 8)
# phase 29: the stepped decode's last logits against prefill's of
# deepseek-v2-lite at full depth in bf16, on the prompts of these seeds.
# The two round differently (the decode absorbs wkv_b into the query and
# reads the latent cache, prefill expands the latent per head) and the
# difference grows over 27 layers: on an H100 the gap read 0.045 on seed
# 29, over TOY_LOGITS_REL. The absorbed form itself is held to
# TOY_LOGITS_REL layer by layer (each layer's MLA alone), and exactly at 2
# layers in f32 (TOY_F32_REL).
TOY_MLA_SEEDS = (29, 30, 31)
TOY_MLA_LOGITS_REL = 0.1
VLM_TEXT = 16
# phase 30: the parameters of hymba-1.5b and whisper-tiny
# (repro.models.registry.param_count of the reference); the seeds of
# hymba's prompts whose stepped decode is held to prefill at full depth in
# bf16 (rel L2 of the last logits, at most HYMBA_LOGITS_REL: on an H100 at
# 700 W the gaps read 0.102-0.136, as large as what bf16 rounding alone
# moves prefill, bf16 against an f32 copy of the weights 0.091-0.151, while
# the f32 copy's own gap read 1.4e-5, so the limit holds 1.8x the largest
# reading and the exact gate is the f32 one, TOY_F32_REL); hymba's ring
# run (2 of 32 layers at full width, f32, stepped over 1,040 positions
# past its window of 1,024, the last 16 held to forward); the SSD's
# training shape (a worker's batch); the length of the chunked-core checks
# (past the 8,192-token switch) and their bf16 limit on the rel L2 against
# the dense formula (the dense path rounds the normalised probabilities to
# bf16, the blocked core the unnormalised ones, block by block); whisper's
# async updates
HYMBA_PARAMS = 1_299_664_064
# hymba's training depth (of 32 layers; width unchanged) and its parameters
# there (the reference's count): at 32 layers the eager steps and the
# capture took ~25 s of the default call
HYMBA_TRAIN_LAYERS = 8
HYMBA_TRAIN_PARAMS = 363_470_816
WHISPER_PARAMS = 62_263_296
HYMBA_SEEDS = (30, 31, 32)
HYMBA_LOGITS_REL = 0.25
HYMBA_RING_LAYERS = 2
HYMBA_RING_STEPS = 1040
HYMBA_RING_HELD = 16
SSD_SHAPE = dict(b=2, s=256, h=25, p=64, n=16)
CHUNKED_S = 8448
CHUNKED_REL = 3e-2
WHISPER_UPDATES = 4
# phase 31: the dry run held to the card (resident bytes within 1% of what
# the card holds once the trainer has its state and gradient stack; the
# predicted eager peak within 10% of max_memory_allocated of an eager
# step), the error-feedback steps over qwen3-0.6b's first aggregated
# gradient, and the host figures' derived strings as the CPU gives them
# (numpy draws: bit for bit on any host)
DRYRUN_RESIDENT_REL = 0.01
DRYRUN_PEAK_REL = 0.10
EF_STEPS = 3
STRAGGLER_ROWS = ("mean_k50=1.38s", "0.74", "0.17", "30.1s")
LAYER_STALENESS_ROWS = ("workers=40,layers=19", "39.7", "14.0", "2.84x",
                        "True")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(torch, fns, repeats: int = 7, iters: int = 10) -> float:
    """Device ms of one call: median over repeats of the CUDA-event time of
    ``iters`` calls / ``iters``. ``fns`` is a list of calls cycled through
    (distinct inputs, so repeated calls do not hit in L2). The calls are
    queued behind a GPU sleep, so they run back to back on the device and
    the host's Python/launch time per call is not counted; a repeat in
    which the sleep ran out before the host had queued everything is
    redone with a longer sleep."""
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    times, cycles = [], 1 << 23
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        ran_dry = start.query()
        torch.cuda.synchronize()
        if ran_dry:
            if cycles > 1 << 32:
                raise RuntimeError("timing: the host cannot queue the calls "
                                   "ahead of the device")
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _busy_ms(torch, fns, calls: int = 3) -> float:
    """Device busy ms of one call, from torch.profiler: the union of the
    card's kernel and copy intervals over ``calls`` calls, divided by
    ``calls``. For a function of more kernels than the launch queue holds
    (the wkv's plain twin: hundreds per call), which ``_time_ms`` cannot
    queue behind a sleep; gaps between its kernels are not counted.
    Only the card's activity is traced, and its intervals are read from
    the raw trace: building the profiler's event tree for a training
    step's thousands of kernels and ops took ~40 s of a default call."""
    from repro_torch.launch.profile_serve import _union_us
    for fn in fns[:2]:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == cuda and not e.is_user_annotation()]
    return _union_us(spans) / 1e6 / calls


# ---------------------------------------------------------------------------
# Phase 3: kernels at the serve path's shapes
# ---------------------------------------------------------------------------


def _gather_phase(torch, page_gather, maxp: int, num_pages: int,
                  layers: int):
    """Parity and timings of both gather variants; returns their rows."""
    g = GATHER_SHAPE
    b, ps, kv, hd = g["b"], g["ps"], g["kv"], g["hd"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # the decode path's table: every slot full, distinct live pages
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)[:b * maxp]
    table = (perm + 1).to(torch.int32).reshape(b, maxp).contiguous()
    pool = torch.randn((layers, num_pages, ps, kv, hd), generator=gen,
                       device=dev).to(torch.bfloat16)
    q8 = torch.randint(-127, 128, (layers, num_pages, ps, kv, hd),
                       generator=gen, device=dev, dtype=torch.int8)
    scales = (torch.rand((layers, num_pages, ps, kv), generator=gen,
                         device=dev) * 0.05).to(torch.float16)
    rows = []
    unique = int(torch.unique(table).numel())
    out_elems = b * maxp * ps * kv * hd
    for name, args, in_bytes in (
            ("page_gather", lambda l: (pool[l], table, None),
             unique * ps * kv * hd * 2),
            ("page_gather_dequant", lambda l: (q8[l], table, scales[l]),
             unique * ps * kv * (hd * 1 + 2))):
        got = page_gather.gather_pages(*args(0), out_dtype=torch.bfloat16)
        want = page_gather.gather_pages(*args(0), out_dtype=torch.bfloat16,
                                        use_kernel=False)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err})")
        ms = _time_ms(torch, [
            (lambda l=l: page_gather.gather_pages(
                *args(l), out_dtype=torch.bfloat16)) for l in range(layers)])
        plain_ms = _time_ms(torch, [
            (lambda l=l: page_gather.gather_pages(
                *args(l), out_dtype=torch.bfloat16, use_kernel=False))
            for l in range(layers)])
        library_ms = None
        if name == "page_gather":          # one PyTorch call: pool[table]
            library_ms = _time_ms(torch, [
                (lambda l=l: pool[l][table]) for l in range(layers)])
        nbytes = in_bytes + table.numel() * 4 + out_elems * 2   # bf16 out
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/page_gather.cu",
            replaces="src/repro/kernels/page_gather.py:83",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=library_ms))
        _log(f"[kernels] {name} B={b} maxp={maxp} ps={ps} kv={kv} hd={hd}: "
             f"bit-exact vs plain; kernel {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, library "
             f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
             f"bound {rows[-1]['bound_ms']:.4f} ms ({nbytes} bytes)")
    return rows


def _flash_inputs(torch, s, dtype, copies, gen):
    """Unit-variance q/k/v, the scale qk-norm gives q and k: scores
    q.k/sqrt(D) then have std ~1, so the softmax is far from uniform."""
    f = FLASH_HEADS
    return [tuple(torch.randn((1, s, n, f["d"]), generator=gen,
                              device="cuda").to(dtype)
                  for n in (f["h"], f["kv"], f["kv"]))
            for _ in range(copies)]


def _flash_phase(torch, flash_attention):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(s, dt, 0, 0.0) for s in (16, 64, 512)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(512, dt, 64, 2.0) for dt in (torch.bfloat16, torch.float32)]
    errs = {}
    for s, dt, window, cap in cases:
        q, k, v = _flash_inputs(torch, s, dt, 1, gen)[0]
        got = flash_attention.flash_attention(q, k, v, window=window,
                                              softcap=cap)
        want = flash_attention.flash_attention(q, k, v, window=window,
                                               softcap=cap, use_kernel=False)
        torch.cuda.synchronize()
        # bf16: the kernel and the plain version both compute in f32 and
        # round once to bf16, so they may differ by one bf16 ulp (< 2^-7
        # relative); f32: summation order only
        tol = dict(atol=4e-3, rtol=8e-3) if dt == torch.bfloat16 else \
            dict(atol=1e-4, rtol=0.0)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[(s, dt, window)] = err
        _log(f"[kernels] flash_attention S={s} {str(dt)[6:]} window={window} "
             f"softcap={cap}: max abs err {err:.3g} vs plain "
             f"(atol {tol['atol']}, rtol {tol['rtol']})")
    # timings at the largest prefill bucket, in the serve run's dtype
    s, dt = 512, torch.bfloat16
    ins = _flash_inputs(torch, s, dt, 16, gen)
    ms = _time_ms(torch, [(lambda a=a: flash_attention.flash_attention(*a))
                          for a in ins])
    plain_ms = _time_ms(torch, [
        (lambda a=a: flash_attention.flash_attention(*a, use_kernel=False))
        for a in ins])
    library_ms = _time_ms(torch, [
        (lambda a=a: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a), is_causal=True,
            enable_gqa=True)) for a in ins])
    f = FLASH_HEADS
    pairs = s * (s + 1) // 2                       # causal, window 0
    flops = 4 * pairs * f["d"] * f["h"]
    nbytes = 2 * s * f["d"] * (2 * f["h"] + 2 * f["kv"])   # q, o, k, v
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        max_abs_err=errs[(s, dt, 0)], ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms)
    _log(f"[kernels] flash_attention B=1 S={s} H={f['h']} KV={f['kv']} "
         f"D={f['d']} bf16 causal: kernel {ms:.4f} ms (before the D = 256 "
         f"kernel: {FLASH128_MS} ms), plain {plain_ms:.4f} "
         f"ms, library (sdpa) {library_ms:.4f} ms, bound "
         f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {flops} flop, "
         f"{nbytes} bytes)")
    # a short prompt from the serve trace's range (64-512), printed only
    ins = _flash_inputs(torch, FLASH_SHORT_S, dt, 16, gen)
    ms_short = _time_ms(torch, [
        (lambda a=a: flash_attention.flash_attention(*a)) for a in ins])
    sdpa_short = _time_ms(torch, [
        (lambda a=a: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a), is_causal=True,
            enable_gqa=True)) for a in ins])
    _log(f"[kernels] flash_attention B=1 S={FLASH_SHORT_S} bf16 causal: "
         f"kernel {ms_short:.4f} ms, library (sdpa) {sdpa_short:.4f} ms")
    return row


def _reduce_mask(torch, w, kind):
    vals = {"zeros": [0.0] * w, "ones": [1.0] * w,
            "mixed": [float(i % 4 != 3) for i in range(w)]}[kind]
    return torch.tensor(vals, device="cuda")


def _reduce_phase(torch, backup_reduce, p_full: int):
    """backup_reduce: bit-exact vs plain at the training stack and at the
    edge shapes; device times at the training stack."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_edge = 0
    for w in REDUCE_EDGES["w"]:
        for p in REDUCE_EDGES["p"]:
            g = torch.randn((w, p + 1), generator=gen, device="cuda")
            for kind in REDUCE_EDGES["masks"]:
                m = _reduce_mask(torch, w, kind)
                # the aligned stack, then the same lanes 4 bytes off
                for view in (g[:, :p].contiguous(), g[:, 1:]):
                    got = backup_reduce.backup_reduce(view, m, 6)
                    want = backup_reduce.backup_reduce_plain(view, m, 6)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"backup_reduce W={w} P={p} mask={kind}: kernel "
                            f"differs from plain (max abs err "
                            f"{(got - want).abs().max().item()})")
                    n_edge += 1
    _log(f"[kernels] backup_reduce edge shapes: {n_edge} cases (W "
         f"{REDUCE_EDGES['w']}, P {REDUCE_EDGES['p']}, masks "
         f"{REDUCE_EDGES['masks']}, aligned and 4-byte-offset bases) "
         f"bit-exact vs plain")
    w = REDUCE_WORKERS
    g = torch.randn((w, p_full), generator=gen, device="cuda")
    m = _reduce_mask(torch, w, "mixed")
    n_agg = int(m.sum().item())
    got = backup_reduce.backup_reduce(g, m, n_agg)
    want = backup_reduce.backup_reduce_plain(g, m, n_agg)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"backup_reduce W={w} P={p_full}: kernel "
                             f"differs from plain (max abs err {err})")
    vec4 = backup_reduce.uses_vec4(g, got)
    del got, want
    inv_n = backup_reduce.inv_n_f32(n_agg)
    ms = _time_ms(torch, [lambda: backup_reduce.backup_reduce(g, m, n_agg)])
    plain_ms = _time_ms(torch, [
        lambda: backup_reduce.backup_reduce_plain(g, m, n_agg)], repeats=3,
        iters=3)
    library_ms = _time_ms(torch, [lambda: torch.matmul(m[None], g) * inv_n])
    nbytes = 4 * w * p_full + 4 * p_full + 4 * w
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * w * p_full / PEAK_FLOPS["float32"] * 1e3
    row = dict(
        name="backup_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/backup_reduce.cu",
        replaces="src/repro/kernels/backup_reduce.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms)
    _log(f"[kernels] backup_reduce W={w} P={p_full} f32 ({n_agg} of {w} "
         f"selected, {'float4' if vec4 else 'scalar'} path): bit-exact vs "
         f"plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
         f"(matmul, cuBLAS) {library_ms:.4f} ms, bound {row['bound_ms']:.4f} "
         f"ms ({nbytes} bytes)")
    del g
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phases 4 and 5: serving
# ---------------------------------------------------------------------------


def _serve(torch, engine, trace, counters):
    for c in counters:
        c.launches = 0
    report = engine.run(trace)
    torch.cuda.synchronize()
    return report, [c.launches for c in counters]


def _full_width_model(torch, cfg, seed=0, label=None):
    """``cfg``'s model on the card with seeded random weights, its size
    and init time logged."""
    from repro_torch.models import get_model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"[serve] {label or cfg.name} full width: {cfg.num_layers} layers, "
         f"d_model {cfg.d_model}, {n_params} params in {cfg.dtype}, init "
         f"{time.perf_counter() - t0:.2f} s")
    return model


def _serve_phase(torch, kernels):
    from repro_torch import configs
    cfg = configs.get_config("qwen3-0.6b")
    model = _full_width_model(torch, cfg)
    return _serve_runs(torch, cfg, model, kernels, "serve",
                       _serve_trace(cfg, 16, seed=0),
                       short=_serve_trace(cfg, SHORT_REQUESTS, seed=0,
                                          new=SHORT_NEW), timed_decode=True)


def _serve_runs(torch, cfg, model, kernels, label, trace,
                pools=("fp", "int8"), short=None, short_clock="wall",
                timed_decode=False):
    """Serve ``trace`` through ``ServeEngine`` with graph decode at phase
    4's geometry, one run a pool of ``pools`` (each engine warmed up and
    its graph captured on a 2-request trace first). With ``short`` (a
    trace of a few new tokens a request: eager decode steps cost the call
    40-90 ms each, host-bound), an eager engine serves it too, and so does
    the graph engine, to the same tokens (with ``short_clock`` "virtual"
    both on the virtual clock, in a graph engine of its own: an MoE
    model's tokens depend on which requests share a decode step, and the
    wall clock admits them at times that vary run to run). Counters are
    set to 0 just
    before each run and read just after. Every run must complete, capture
    decode once and launch page gather twice a layer a decode step and
    flash once a layer an admission. Returns {tag: report and counts}
    (tags "fp graph", "int8 graph" for ``trace``, "fp", "int8" for the
    eager run on ``short``). ``timed_decode``: each graph run's report
    also holds ``decode_ms``, one decode step with every slot live at
    ``MOE_TIMED_LEN`` tokens (``_timed_decode_ms``)."""
    from repro_torch.kernels import counters
    from repro_torch.serve import ServeEngine, TraceConfig, make_trace
    page_gather, flash_attention = kernels
    warm = make_trace(TraceConfig(
        num_requests=2, rate=1000.0, prompt_len_min=64, prompt_len_max=512,
        max_new_min=4, max_new_max=4, vocab=cfg.vocab_size, seed=1))
    runs = {}
    for pool in pools:
        engines = [(True, trace), (False, short)] if short else [(True,
                                                                  trace)]
        for graph, tr in engines:
            engine = ServeEngine(cfg, model, cache_int8=pool == "int8",
                                 clock="wall" if graph else short_clock,
                                 decode_graph=graph, **_serve_cfg())
            if graph:
                engine.run(warm)          # warmup and capture
                graph_engine = engine
            torch.cuda.reset_peak_memory_stats()
            report, (n_gather, n_flash) = _serve(
                torch, engine, tr, (page_gather, flash_attention))
            m = report.metrics
            tag = pool + (" graph" if graph else "")
            if m["decode_compiles"] != 1:
                raise AssertionError(f"[{label} {tag}] decode_compiles "
                                     f"{m['decode_compiles']}, expected 1")
            if m["completed"] != len(tr):
                raise AssertionError(f"[{label} {tag}] {m['completed']} of "
                                     f"{len(tr)} requests completed")
            for c in report.completed:
                req = next(r for r in tr if r.rid == c.rid)
                if len(c.tokens) != req.max_new or not all(
                        0 <= t < cfg.vocab_size for t in c.tokens):
                    raise AssertionError(f"[{label} {tag}] rid {c.rid}: bad "
                                         f"tokens")
            want_gather = 2 * cfg.num_layers * m["decode_steps"]
            want_flash = cfg.num_layers * len(tr)
            if n_gather != want_gather or n_flash != want_flash:
                raise AssertionError(
                    f"[{label} {tag}] launches gather={n_gather} (expected "
                    f"{want_gather}) flash={n_flash} (expected {want_flash})")
            runs[tag] = dict(report=report, gather=n_gather, flash=n_flash,
                             peak=torch.cuda.max_memory_allocated())
            if graph and timed_decode:
                before = counters.read()
                runs[tag]["decode_ms"] = _timed_decode_ms(torch, engine)
                counters.write(before)      # not the run's launches
                _log(f"[{label} {tag}] timed decode: {engine.pool_cfg.num_slots}"
                     f" slots live at {MOE_TIMED_LEN} tokens, "
                     f"{runs[tag]['decode_ms']:.4f} ms a step (CUDA events "
                     f"over {MOE_TIMED_STEPS} replays)")
            if graph:
                g = engine._decode_graph
                _log(f"[{label} {tag}] decode graph: {g.captures} capture "
                     f"in {g.capture_s:.3f} s (the capture alone), "
                     f"{g.replays} replays")
            _log(f"[{label} {tag}] {m['completed']} requests, "
                 f"{m['total_tokens']} tokens in {m['duration']:.3f} s -> "
                 f"{m['tokens_per_s']:.1f} tok/s | latency p50 "
                 f"{m['p50_latency']:.4f} s p99 {m['p99_latency']:.4f} s | "
                 f"ttft p50 {m['p50_ttft']:.4f} s | prefill_s "
                 f"{m['prefill_s']:.4f} decode_s {m['decode_s']:.4f} | "
                 f"{m['decode_steps']} decode steps, mean "
                 f"{1e3 * m['decode_s'] / m['decode_steps']:.3f} ms/step | "
                 f"peak pages {m['peak_pages']} of "
                 f"{engine.pool_cfg.num_pages - 1} | pool "
                 f"{engine.pool_bytes} bytes | peak device memory "
                 f"{torch.cuda.max_memory_allocated()} bytes | launches "
                 f"page_gather={n_gather} flash_attention={n_flash}")
        if short:
            eager = runs[pool]["report"].tokens_by_rid()
            if short_clock != "wall":
                graph_engine = ServeEngine(cfg, model,
                                           cache_int8=pool == "int8",
                                           clock=short_clock,
                                           decode_graph=True, **_serve_cfg())
            if graph_engine.run(short).tokens_by_rid() != eager:
                raise AssertionError(f"[{label} {pool}] graph-decode tokens "
                                     f"differ from eager decode")
            _log(f"[{label} {pool}] graph decode == eager decode on the "
                 f"short trace: {sum(len(t) for t in eager.values())} "
                 f"greedy tokens equal")
    if "fp graph" in runs and "int8 graph" in runs:
        fp_t = runs["fp graph"]["report"].tokens_by_rid()
        q8_t = runs["int8 graph"]["report"].tokens_by_rid()
        same = sum(a == b for r in fp_t for a, b in zip(fp_t[r], q8_t[r]))
        total = sum(len(v) for v in fp_t.values())
        _log(f"[{label}] int8 pool vs fp pool: {same}/{total} tokens equal "
             f"(bf16 random weights; reported, not asserted)")
    return runs


def _hold_kernel_to_plain(torch, cfg, label, trace, **engine_kw):
    """``cfg`` (f32 at reduced depth) serves ``trace`` with the kernels and
    with their plain twins, fp and int8 pools: the same greedy tokens."""
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    for int8 in (False, True):
        toks = [ServeEngine(cfg, model, cache_int8=int8,
                            use_kernel=use_kernel, clock="virtual",
                            **engine_kw).run(trace).tokens_by_rid()
                for use_kernel in (True, False)]
        pool = "int8" if int8 else "fp"
        if toks[0] != toks[1]:
            raise AssertionError(f"[e2e] {label} {cfg.num_layers} layers f32 "
                                 f"{pool}: kernel-path tokens differ from "
                                 f"plain")
        longest = max(r.prompt_len + r.max_new for r in trace)
        _log(f"[e2e] {label} {cfg.num_layers}-layer full-width f32 {pool} "
             f"pool: kernel-path tokens == plain-path tokens "
             f"({sum(len(t) for t in toks[0].values())} tokens, sequences to "
             f"{longest} positions; window {cfg.sliding_window})")


def _kernel_vs_plain_phase(torch):
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine, TraceConfig, make_trace
    full = configs.get_config("qwen3-0.6b")
    cfg = dataclasses.replace(full, num_layers=2, dtype="float32")
    trace = make_trace(TraceConfig(
        num_requests=8, rate=1000.0, prompt_len_min=16, prompt_len_max=128,
        max_new_min=8, max_new_max=16, vocab=cfg.vocab_size, seed=2))
    _hold_kernel_to_plain(torch, cfg, "qwen3-0.6b", trace, num_slots=4,
                          page_size=16, max_prompt_len=128, max_new_cap=16)
    # the card against the CPU port (itself held to the JAX reference by
    # tests/test_torch_serve.py) on the smoke config
    smoke = configs.get_smoke_config("qwen3-0.6b")
    cpu_model = get_model(smoke, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    gpu_model = get_model(smoke, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    strace = make_trace(TraceConfig(
        num_requests=6, rate=1000.0, prompt_len_min=2, prompt_len_max=32,
        max_new_min=4, max_new_max=16, vocab=smoke.vocab_size, seed=3))
    kw = dict(num_slots=3, page_size=8, max_prompt_len=32, max_new_cap=16,
              clock="virtual")
    on_cpu = ServeEngine(smoke, cpu_model, device="cpu", **kw).run(
        strace).tokens_by_rid()
    for graph in (False, True):
        on_gpu = ServeEngine(smoke, gpu_model, decode_graph=graph,
                             **kw).run(strace).tokens_by_rid()
        if on_cpu != on_gpu:
            raise AssertionError(f"smoke model: card tokens (decode graph "
                                 f"{graph}) differ from CPU tokens")
        _log(f"[e2e] qwen3 smoke f32: card (kernels, "
             f"{'graph' if graph else 'eager'} decode) tokens == CPU port "
             f"tokens ({sum(len(t) for t in on_cpu.values())} tokens)")


# ---------------------------------------------------------------------------
# The chunked trainer as a CUDA graph (phases 6 and 9)
# ---------------------------------------------------------------------------


def _param_sums(torch, params):
    """Per-tensor f64 sums of the parameters: the checksum a graph run is
    held to."""
    return torch.stack([p.detach().double().sum()
                        for p in params.values()]).cpu()


@contextlib.contextmanager
def _planned_masks():
    """Collects the [W] mask of every step the straggler simulator plans,
    per-step or chunked (``next_events(k)`` stacks k ``next_event()``
    calls); yields that list of masks, in step order."""
    from unittest import mock
    from repro_torch.core.events import StragglerSimulator
    plan, log = StragglerSimulator.next_event, []

    def spy(sim):
        ev = plan(sim)
        log.append(ev.mask.copy())
        return ev

    with mock.patch.object(StragglerSimulator, "next_event", spy):
        yield log


@contextlib.contextmanager
def _first_grad():
    """Yields a list that receives the first aggregated [P] gradient the
    spmd engine reduces under it (a copy in host memory, taken in an eager
    step: a graph run's first step is its eager warmup)."""
    from unittest import mock
    from repro_torch.distributed import spmd_engine
    reduce, kept = spmd_engine.reduce_then_psum, []

    def keep(*args, **kw):
        red, tail = reduce(*args, **kw)
        if not kept:
            kept.append(red.detach().cpu())
        return red, tail

    with mock.patch.object(spmd_engine, "reduce_then_psum", keep):
        yield kept


def _same_masks(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and bool(np.array_equal(np.stack(a),
                                                    np.stack(b)))


def _graph_train_run(torch, cfg, counters, tag):
    """``cfg``'s steps as one chunk (``chunk_size = total_steps``) through
    the trainer's CUDA graph: step 1 runs eagerly and captures the step,
    the rest replay it. The counters are set to 0 just before and read
    just after. Then one more chunk on the same trainer, all replays, is
    timed (host wall per step). Returns the run's metrics, counts,
    parameter checksum, planned masks and graph numbers (``resident``:
    the bytes the card holds after the first chunk beyond what it held
    before the trainer was built: its state, the gradient stack and the
    graph's static buffers)."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    k = cfg.total_steps
    cfg = dataclasses.replace(cfg, chunk_size=k)
    gc.collect()            # earlier phases' garbage, not freed mid-run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
    tr.init_state()
    for m, a in counters:
        setattr(m, a, 0)
    t0 = time.perf_counter()
    with _planned_masks() as masks:
        res = tr.run(k)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = tuple(getattr(m, a) for m, a in counters)
    metrics = list(res.metrics)
    sums = _param_sums(torch, res.params)
    g = tr.chunk_step.graph
    stats = dict(capture_s=g.capture_s, captures=g.captures,
                 resident=torch.cuda.memory_allocated() - base,
                 peak=torch.cuda.max_memory_allocated(),
                 reserved=torch.cuda.max_memory_reserved(),
                 first_chunk_ms=1e3 * first_s)
    t0 = time.perf_counter()
    tr.run(k)
    torch.cuda.synchronize()
    stats["replay_ms"] = 1e3 * (time.perf_counter() - t0) / k
    stats["busy_ms"] = _busy_ms(torch, [lambda: tr.run(k)], calls=1) / k
    stats["replays"] = g.replays
    for m in metrics:
        _log(f"[train {tag} graph] step {m['step']} loss {m['loss']:.6f} "
             f"sim_time {m['sim_time']:.6f} selected {m['selected']} "
             f"lr {m['lr']:.6f}")
    _log(f"[train {tag} graph] chunk of {k} steps: first chunk "
         f"{stats['first_chunk_ms']:.1f} ms (step 1 eager, the capture "
         f"{1e3 * stats['capture_s']:.1f} ms, {k - 1} replays); the next "
         f"chunk, all replays: {stats['replay_ms']:.3f} ms/step host wall, "
         f"device busy {stats['busy_ms']:.3f} ms/step (a third chunk, "
         f"profiled) | captures {stats['captures']}, replays "
         f"{stats['replays']} | peak device memory {stats['peak']} bytes "
         f"allocated, {stats['reserved']} reserved")
    del tr, res, g
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, counts, sums, masks, stats


def _hold_graph_to_eager(tag, eager_run, graph, graph_sums, graph_masks):
    """The graph run against the eager per-step run (``eager_run``: its
    metrics, sums and masks): the same masks, selected counts and
    sim_time, bit-equal losses and parameter checksums."""
    eager, eager_sums = eager_run["metrics"], eager_run["sums"]
    if not _same_masks(eager_run["masks"], graph_masks):
        raise AssertionError(f"[{tag}] graph and eager runs planned "
                             f"different [W] masks")
    for a, b in zip(eager, graph):
        if a["selected"] != b["selected"] or a["sim_time"] != b["sim_time"]:
            raise AssertionError(f"[{tag}] step {a['step']}: graph and eager "
                                 f"runs planned different masks")
    differ = [(a["step"], abs(a["loss"] - b["loss"]) / abs(a["loss"]))
              for a, b in zip(eager, graph) if a["loss"] != b["loss"]]
    if differ or len(eager) != len(graph):
        raise AssertionError(f"[{tag}] graph losses differ from eager: first "
                             f"step {differ[0][0] if differ else None}, max "
                             f"rel {max((d for _, d in differ), default=0)}")
    if not graph_sums.equal(eager_sums):
        rel = ((graph_sums - eager_sums).abs()
               / eager_sums.abs().clamp_min(1e-30)).max().item()
        raise AssertionError(f"[{tag}] graph parameter checksums differ from "
                             f"eager (max rel {rel:.3g})")
    _log(f"[{tag}] graph run == eager per-step run: {len(graph_masks)} "
         f"[W] masks, selected and sim_time equal, {len(eager)} losses and {graph_sums.numel()} parameter "
         f"checksums bit-equal")



# ---------------------------------------------------------------------------
# Phases 6 and 7: training
# ---------------------------------------------------------------------------


def _train_phase(torch, backup_reduce):
    """qwen3-0.6b at full width, 3 spmd steps through the kernel, then the
    first of them through the plain reduce (its loss and its aggregated
    gradient are what is held). Returns the kernel run's row numbers and
    its parameter count P."""
    from unittest import mock
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.distributed import spmd_engine
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import run_experiment
    first_grad, tags = {}, []
    reduce = spmd_engine.reduce_then_psum

    def keep_first(*args, **kw):           # each run's first [P] gradient
        red, tail = reduce(*args, **kw)
        if tags[-1] not in first_grad:
            first_grad[tags[-1]] = red.clone()
        return red, tail

    runs = {}
    with mock.patch.object(spmd_engine, "reduce_then_psum", keep_first):
        for tag, use_kernel in (("kernel", None), ("plain", False)):
            tags.append(tag)
            steps = 3 if use_kernel is None else 1
            cfg = train_config(use_kernel=use_kernel, steps=steps)
            model = cfg.model
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backup_reduce.launches = 0
            with _planned_masks() as masks:
                res = run_experiment(cfg, latency=PaperCalibrated(),
                                     device="cuda")
            torch.cuda.synchronize()
            launches = backup_reduce.launches
            peak = torch.cuda.max_memory_allocated()
            n_params = sum(v.numel() for v in res.params.values())
            for m in res.metrics:
                _log(f"[train {tag}] step {m['step']} loss {m['loss']:.6f} "
                     f"sim_time {m['sim_time']:.6f} selected {m['selected']} "
                     f"lr {m['lr']:.6f}")
            tokens = cfg.shape.global_batch * cfg.shape.seq_len
            ms = [1e3 * t for t in res.step_times_s]
            steady = statistics.mean(ms[1:] or ms)
            rate = (f"steady {steady:.1f} ms, {tokens / steady * 1e3:.0f} "
                    f"tokens/s" if steps > 1 else
                    "one step, its warm-up included")
            _log(f"[train {tag}] {model.name}: {model.num_layers} layers, "
                 f"d_model {model.d_model}, vocab {model.vocab_size}, "
                 f"{n_params} params {model.dtype}, remat {model.remat}; "
                 f"backup 6+2, {cfg.shape.global_batch} x "
                 f"{cfg.shape.seq_len} tokens/step, spmd mesh 1x1: ms/step "
                 f"{', '.join(f'{t:.1f}' for t in ms)} ({rate}) | "
                 f"backup_reduce launches {launches} | peak device memory "
                 f"{peak} bytes")
            if not all(math.isfinite(m["loss"]) for m in res.metrics):
                raise AssertionError(f"[train {tag}] non-finite loss")
            if res.steps != steps or len(res.metrics) != steps:
                raise AssertionError(f"[train {tag}] ran {res.steps} steps")
            want = 3 if use_kernel is None else 0
            if launches != want:
                raise AssertionError(f"[train {tag}] backup_reduce launches "
                                     f"{launches}, expected {want}")
            runs[tag] = dict(metrics=res.metrics, launches=launches,
                             peak=peak, ms=ms, n_params=n_params,
                             sums=_param_sums(torch, res.params), masks=masks)
            del res
            torch.cuda.empty_cache()
    if not _same_masks(runs["kernel"]["masks"][:1], runs["plain"]["masks"]):
        raise AssertionError("kernel and plain runs planned different masks")
    for a, b in zip(runs["kernel"]["metrics"], runs["plain"]["metrics"]):
        if a["selected"] != b["selected"] or a["sim_time"] != b["sim_time"]:
            raise AssertionError(f"step {a['step']}: kernel and plain runs "
                                 f"planned different masks")
        if abs(a["loss"] - b["loss"]) > 1e-3 * abs(b["loss"]):
            raise AssertionError(f"step {a['step']}: loss {a['loss']} vs "
                                 f"plain {b['loss']}")
    gk, gp = first_grad["kernel"], first_grad["plain"]
    if not torch.equal(gk, gp):
        raise AssertionError(
            f"first step's aggregated gradient differs between the kernel "
            f"and the plain run (max abs {(gk - gp).abs().max().item()})")
    _log(f"[train] kernel run == plain run on step 1: mask and sim_time "
         f"equal, loss within rel 1e-3, the aggregated gradient "
         f"({gk.numel()} lanes) bit-equal")
    runs["kernel"]["first_grad"] = gk.cpu()
    del gk, gp
    first_grad.clear()
    torch.cuda.empty_cache()
    # the main path: the same 3 steps as one chunk through the CUDA graph
    metrics, (launches,), sums, masks, stats = _graph_train_run(
        torch, train_config(), ((backup_reduce, "launches"),), "qwen3")
    if launches != 3:
        raise AssertionError(f"[train graph] backup_reduce launches "
                             f"{launches}, expected 3")
    _hold_graph_to_eager("train qwen3", runs["kernel"], metrics, sums, masks)
    return dict(runs["kernel"], launches=launches, graph=stats)


def _parity_cfg(backend, *, directory="", every=0):
    """The full-width run cut to 2 layers in f32, seq 64, momentum (as the
    reference's own sim-vs-spmd test: the first RMSProp step divides by
    sqrt(0.1 g^2 + 1e-8), which turns the two backends' different
    summation orders near g = 0 into visible differences)."""
    from repro_torch.configs import CheckpointConfig, OptimizerConfig
    from repro_torch.launch.profile_train import train_config
    cfg = train_config(backend=backend)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_layers=2,
                                       dtype="float32"),
        shape=dataclasses.replace(cfg.shape, seq_len=64),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.99),
        checkpoint=CheckpointConfig(directory=directory, every_steps=every))


def _parity_phase(torch):
    """2 layers at full width, f32: sim == spmd, and checkpoint save ->
    restore -> continue == straight through."""
    from repro_torch.train.loop import Trainer
    out = {}
    for backend in ("sim", "spmd"):
        tr = Trainer(_parity_cfg(backend), device="cuda")
        tr.init_state()
        out[backend] = tr.run(3)
    worst = 0.0
    for name, v in out["sim"].params.items():
        worst = max(worst, (v - out["spmd"].params[name]).abs().max().item())
    if worst > 1e-5 or out["sim"].sim_time != out["spmd"].sim_time:
        raise AssertionError(f"sim vs spmd: params differ by {worst}")
    _log(f"[parity] 2-layer full-width f32, 3 steps: sim vs spmd params max "
         f"abs diff {worst:.3g} (atol 1e-5), sim_time equal")
    with tempfile.TemporaryDirectory() as d:
        first = Trainer(_parity_cfg("spmd", directory=d, every=1),
                        device="cuda")
        first.init_state()
        first.run(1)
        resumed = Trainer(_parity_cfg("spmd", directory=d), device="cuda")
        resumed.reset_optimizer_state()
        resumed.restore_checkpoint()
        res = resumed.run(2)
    worst = 0.0
    for part in ("params", "ema"):
        a, b = getattr(res, part), getattr(out["spmd"], part)
        for name, v in a.items():
            worst = max(worst, (v - b[name]).abs().max().item())
    if worst > 1e-6 or res.sim_time != out["spmd"].sim_time:
        raise AssertionError(f"checkpoint resume: state differs by {worst}")
    _log(f"[parity] checkpoint at step 1 -> restore -> 2 more steps vs 3 "
         f"straight: params and EMA max abs diff {worst:.3g} (atol 1e-6), "
         f"sim_time equal")


# ---------------------------------------------------------------------------
# Phases 8-10: the wkv kernels and rwkv6-1.6b training
# ---------------------------------------------------------------------------


def _wkv_inputs(torch, b, s, h, d, dtype, gen):
    """r/k/v ~ 0.5 N(0, 1) in ``dtype``; w = exp(-exp(clip(N - 1, -8,
    1.6))), the model's decay range, f32; u ~ 0.5 N(0, 1) f32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (0.5 * randn(b, s, h, d) for _ in range(3))
    w = torch.exp(-torch.exp(torch.clamp(randn(b, s, h, d) - 1.0, -8.0,
                                         1.6)))
    return r.to(dtype), k.to(dtype), v.to(dtype), w, 0.5 * randn(h, d)


def _wkv_check(torch, rwkv6_scan, args, gen, with_dfinal):
    """Kernel forward and backward against the plain twin's forward and
    autograd (on f32 copies of the same values). Returns the errors."""
    out, final, states = rwkv6_scan.wkv6_forward(*args)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    dfinal = (torch.randn(final.shape, generator=gen, device="cuda")
              if with_dfinal else None)
    grads = rwkv6_scan.wkv6_backward(*args, states, dout, dfinal)
    leaves = [a.float().requires_grad_() for a in args]
    pout, pfinal = rwkv6_scan.wkv6_plain(*leaves)
    loss = (pout * dout).sum()
    if with_dfinal:
        loss = loss + (pfinal * dfinal).sum()
    want = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    errs = {"out": (out - pout.detach()).abs().max().item(),
            "out_scale": pout.detach().abs().max().item()}
    if errs["out"] > 1e-4 * errs["out_scale"]:
        raise AssertionError(f"wkv6 forward: max abs err {errs['out']} > "
                             f"1e-4 x {errs['out_scale']}")
    for name, got, ref in zip(WKV_TOL, grads, want):
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        errs[name] = err / max(scale, 1e-30)
        errs["grad_abs"] = max(errs.get("grad_abs", 0.0), err)
        if err > WKV_TOL[name] * scale:
            raise AssertionError(f"wkv6 backward {name}: max abs err {err} "
                                 f"> {WKV_TOL[name]} x {scale}")
    return errs


def _wkv_phase(torch, rwkv6_scan):
    """The wkv kernels: parity at the training shape and the edge shapes,
    then device times at the training shape. Returns their two rows."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_edge = 0
    for d in WKV_EDGES["d"]:
        for s in WKV_EDGES["s"]:
            for dt in (torch.float32, torch.bfloat16):
                args = _wkv_inputs(torch, 2, s, 3, d, dt, gen)
                _wkv_check(torch, rwkv6_scan, args, gen, n_edge % 2 == 1)
                n_edge += 1
    _log(f"[kernels] wkv6 edge shapes: {n_edge} cases (D {WKV_EDGES['d']}, "
         f"S {WKV_EDGES['s']}, f32 and bf16, half with a final-state "
         f"gradient) within atol 1e-4 x max|out| and {WKV_TOL} x max|grad| "
         f"of the plain twin")
    sh = WKV_SHAPE
    b, s, h, d = sh["b"], sh["s"], sh["h"], sh["d"]
    args = _wkv_inputs(torch, b, s, h, d, torch.bfloat16, gen)
    errs = _wkv_check(torch, rwkv6_scan, args, gen, False)
    _log(f"[kernels] wkv6 B={b} S={s} H={h} D={d} bf16 r/k/v: forward max "
         f"abs err {errs['out']:.3g} (max|out| {errs['out_scale']:.3g}); "
         f"backward rel errs " + ", ".join(
             f"{n} {errs[n]:.3g}" for n in WKV_TOL))
    # six input sets (~10 MB each) rotate the timed calls past the L2
    ins = [_wkv_inputs(torch, b, s, h, d, torch.bfloat16, gen)
           for _ in range(6)]
    fwd = [rwkv6_scan.wkv6_forward(*a) for a in ins]
    douts = [torch.randn((b, s, h, d), generator=gen, device="cuda")
             for _ in ins]
    ms_f = _time_ms(torch, [(lambda a=a: rwkv6_scan.wkv6_forward(*a))
                            for a in ins])
    # the forward that saves no chunk states (as under no_grad, and the
    # first pass of a remat block)
    ms_f_bare = _time_ms(torch, [
        (lambda a=a: rwkv6_scan.wkv6_forward(*a, save_states=False))
        for a in ins])
    ms_b = _time_ms(torch, [
        (lambda a=a, f=f, g=g: rwkv6_scan.wkv6_backward(*a, f[2], g))
        for a, f, g in zip(ins, fwd, douts)])
    # the backward's two kernels alone: the dS scan, the chunk-local pass
    passes = [rwkv6_scan.backward_passes(*a, f[2], g)
              for a, f, g in zip(ins, fwd, douts)]
    for scan, _, _ in passes:
        scan()                               # pass 2 reads pass 1's dS
    ms_scan = _time_ms(torch, [p[0] for p in passes])
    ms_chunks = _time_ms(torch, [p[1] for p in passes])
    del fwd, passes
    plain_f = _busy_ms(torch, [
        (lambda a=a: rwkv6_scan.wkv6_plain(*a)) for a in ins])
    graphs = []
    for a in ins:
        leaves = [t.float().requires_grad_() for t in a]
        graphs.append((rwkv6_scan.wkv6_plain(*leaves)[0], leaves))
    plain_b = _busy_ms(torch, [
        (lambda o=o, lv=lv, g=g: torch.autograd.grad(o, lv, g,
                                                     retain_graph=True))
        for (o, lv), g in zip(graphs, douts)])
    del graphs
    # Bounds of the function alone: its inputs read once, its outputs
    # written once, and the f32 products it needs. The chunk states the
    # forward saves for the backward are this port's design, not the
    # function's, and are left out (the backward recomputes them instead:
    # 2CD^2 more per chunk).
    c, nc = rwkv6_scan.CHUNK, -(-s // rwkv6_scan.CHUNK)
    bhd = b * s * h * d
    state_bytes = 4 * b * h * nc * d * d
    in_bytes = 3 * 2 * bhd + 4 * bhd + 4 * h * d   # bf16 r/k/v, f32 w, u
    works = {
        # out f32, the final state
        "fwd": (in_bytes + 4 * bhd + 4 * b * h * d * d,
                (4 * c * c * d + 4 * c * d * d) * nc * b * h),
        # + dout; dr/dk/dv/dw f32, du
        "bwd": (in_bytes + 4 * bhd + 4 * 4 * bhd + 4 * h * d,
                (10 * c * c * d + 10 * c * d * d) * nc * b * h)}
    rows = []
    for name, ms, plain_ms, err in (
            ("fwd", ms_f, plain_f, errs["out"]),
            ("bwd", ms_b, plain_b, errs["grad_abs"])):
        nbytes, flops = works[name]
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        rows.append(dict(
            name=f"rwkv6_wkv_{name}", route="cuda",
            source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:75",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
        _log(f"[kernels] wkv6 {name} B={b} S={s} H={h} D={d} bf16: kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms (device busy), library "
             f"none, bound "
             f"{rows[-1]['bound_ms']:.5f} ms ({rows[-1]['bound_by']}: "
             f"{nbytes} bytes, {flops} f32 flop)")
    _log(f"[kernels] wkv6 bwd by pass: dS scan {ms_scan:.4f} ms, "
         f"chunk-local gradients {ms_chunks:.4f} ms (whole call "
         f"{ms_b:.4f} ms)")
    _log(f"[kernels] wkv6 fwd without saving the chunk states: "
         f"{ms_f_bare:.4f} ms (the states are {state_bytes} bytes, written "
         f"by the forward and read by the backward, outside the bounds)")
    width = min(d, rwkv6_scan.FWD_SLICE)
    _log(f"[kernels] wkv6 fwd column slice: {width} state columns a block, "
         f"{b * h * d // width} blocks")
    del ins
    torch.cuda.empty_cache()
    return rows


def _rwkv_train_phase(torch, rwkv6_scan, backup_reduce):
    """rwkv6-1.6b at full width, 3 spmd steps through the wkv kernels
    (``run_experiment``), then the first of them through the plain twin
    (~10 s a step: its step-1 loss is what is held)."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import Trainer, run_experiment
    counters = ((rwkv6_scan, "launches_fwd"), (rwkv6_scan, "launches_bwd"),
                (backup_reduce, "launches"),
                (rwkv6_scan, "launches_fwd_states"))
    cfg = train_config("rwkv6-1.6b")
    model, agg = cfg.model, cfg.aggregation
    w = agg.total_workers
    steps = cfg.total_steps
    runs = {}
    for tag in ("kernel", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _planned_masks() as masks, _first_grad() as first:
            if tag == "kernel":
                for m, a in counters:
                    setattr(m, a, 0)
                res = run_experiment(cfg, latency=PaperCalibrated(),
                                     device="cuda")
            else:
                tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
                tr.model.use_kernel = False
                tr.init_state()
                for m, a in counters:
                    setattr(m, a, 0)
                res = tr.run(1)
        torch.cuda.synchronize()
        n = steps if tag == "kernel" else 1
        n_fwd, n_bwd, n_red, n_states = (getattr(m, a) for m, a in counters)
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(v.numel() for v in res.params.values())
        for m in res.metrics:
            _log(f"[train rwkv {tag}] step {m['step']} loss {m['loss']:.6f} "
                 f"sim_time {m['sim_time']:.6f} selected {m['selected']} "
                 f"lr {m['lr']:.6f}")
        tokens = cfg.shape.global_batch * cfg.shape.seq_len
        ms = [1e3 * t for t in res.step_times_s]
        steady = statistics.mean(ms[1:] or ms)
        rate = (f"steady {steady:.1f} ms, {tokens / steady * 1e3:.0f} "
                f"tokens/s" if n > 1 else "one step, its warm-up included")
        _log(f"[train rwkv {tag}] {model.name}: {model.num_layers} layers, "
             f"d_model {model.d_model}, {model.d_model // model.rwkv_head_dim}"
             f" wkv heads of {model.rwkv_head_dim}, d_ff {model.d_ff}, vocab "
             f"{model.vocab_size}, {n_params} params {model.dtype}, remat "
             f"{model.remat}; backup {agg.num_workers}+{agg.backup_workers}, "
             f"{cfg.shape.global_batch} x {cfg.shape.seq_len} tokens/step, "
             f"spmd mesh 1x1: ms/step {', '.join(f'{t:.1f}' for t in ms)} "
             f"({rate}) | launches wkv6 fwd {n_fwd} (writing the chunk "
             f"states {n_states}) bwd {n_bwd} backup_reduce {n_red} | peak "
             f"device memory {peak} bytes")
        if n_params != RWKV_PARAMS:
            raise AssertionError(f"{n_params} params, the reference counts "
                                 f"{RWKV_PARAMS}")
        if not all(math.isfinite(m["loss"]) for m in res.metrics):
            raise AssertionError(f"[train rwkv {tag}] non-finite loss")
        if res.steps != n or len(res.metrics) != n:
            raise AssertionError(f"[train rwkv {tag}] ran {res.steps} steps")
        per_step = 2 * model.num_layers * w if tag == "kernel" else 0
        want = (per_step * n, per_step // 2 * n, n, per_step // 2 * n)
        if (n_fwd, n_bwd, n_red, n_states) != want:
            raise AssertionError(
                f"[train rwkv {tag}] launches wkv6 fwd/bwd, backup_reduce, "
                f"state-writing wkv6 fwd {(n_fwd, n_bwd, n_red, n_states)}, "
                f"expected {want}")
        if n_states * 2 != n_fwd:
            raise AssertionError(f"[train rwkv {tag}] {n_states} of {n_fwd} "
                                 f"wkv6 forwards wrote chunk states, not half")
        runs[tag] = dict(metrics=res.metrics, launches=(n_fwd, n_bwd),
                         peak=peak, ms=ms, sums=_param_sums(torch, res.params),
                         masks=masks, first_grad=first[0])
        del res
        if tag == "plain":
            del tr
        gc.collect()
        torch.cuda.empty_cache()
    if not _same_masks(runs["kernel"]["masks"][:1], runs["plain"]["masks"]):
        raise AssertionError("rwkv kernel and plain runs planned different "
                             "masks")
    for a, b in zip(runs["kernel"]["metrics"], runs["plain"]["metrics"]):
        if a["selected"] != b["selected"] or a["sim_time"] != b["sim_time"]:
            raise AssertionError(f"rwkv step {a['step']}: kernel and plain "
                                 f"runs planned different masks")
    la, lb = runs["kernel"]["metrics"][0]["loss"], \
        runs["plain"]["metrics"][0]["loss"]
    if abs(la - lb) > 1e-3 * abs(lb):
        raise AssertionError(f"rwkv step 1: loss {la} vs plain {lb}")
    _log(f"[train rwkv] kernel run vs plain run: masks and sim_time equal, "
         f"step 1 loss {la:.6f} vs {lb:.6f} (rel "
         f"{abs(la - lb) / abs(lb):.3g}, limit 1e-3)")
    # the main path: the same 3 steps as one chunk through the CUDA graph
    metrics, counts, sums, masks, stats = _graph_train_run(
        torch, cfg, counters, "rwkv")
    per_step = 2 * model.num_layers * w
    want = (per_step * steps, per_step // 2 * steps, steps,
            per_step // 2 * steps)
    if counts != want:
        raise AssertionError(
            f"[train rwkv graph] launches wkv6 fwd/bwd, backup_reduce, "
            f"state-writing wkv6 fwd {counts}, expected {want}")
    _log(f"[train rwkv graph] launches wkv6 fwd {counts[0]} (writing the "
         f"chunk states {counts[3]}) bwd {counts[1]} backup_reduce "
         f"{counts[2]}: the eager run's counts")
    _hold_graph_to_eager("train rwkv", runs["kernel"], metrics, sums, masks)
    return dict(runs["kernel"], launches=counts[:2], graph=stats)


def _rwkv_parity_phase(torch):
    """2 layers at full width, f32, one step: the wkv kernels against the
    plain twin, the loss and the first aggregated gradient."""
    from unittest import mock
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.distributed import spmd_engine
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import Trainer
    cfg = train_config("rwkv6-1.6b", steps=1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_layers=2, dtype="float32"))
    reduce = spmd_engine.reduce_then_psum
    out = {}
    for tag, use_kernel in (("kernel", True), ("plain", False)):
        def keep(*args, _tag=tag, **kw):
            red, tail = reduce(*args, **kw)
            out.setdefault(_tag, red.clone())
            return red, tail
        with mock.patch.object(spmd_engine, "reduce_then_psum", keep):
            tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
            tr.model.use_kernel = use_kernel
            tr.init_state()
            out[tag + "_loss"] = tr.run(1).metrics[0]["loss"]
            del tr
    la, lb = out["kernel_loss"], out["plain_loss"]
    gk, gp = out["kernel"], out["plain"]
    rel_l2 = (torch.linalg.vector_norm(gk - gp)
              / torch.linalg.vector_norm(gp)).item()
    if abs(la - lb) > 1e-5 * abs(lb) or not rel_l2 <= 1e-4:
        raise AssertionError(f"rwkv 2-layer f32: loss {la} vs {lb}, first "
                             f"aggregated gradient rel L2 {rel_l2}")
    _log(f"[parity rwkv] 2-layer full-width f32, step 1: loss kernel "
         f"{la:.7f} vs plain {lb:.7f} (rel {abs(la - lb) / abs(lb):.3g}, "
         f"limit 1e-5); first aggregated gradient ({gk.numel()} lanes) rel "
         f"L2 {rel_l2:.3g} (limit 1e-4)")
    del gk, gp
    out.clear()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 11-14: the event regimes (async, softsync, the §2.1 staleness rig)
# ---------------------------------------------------------------------------


def _event_run(torch, cfg, counters, tag, *, model=None, batch_fn=None):
    """``cfg.total_steps`` PS updates on a fresh trainer (the counters set
    to 0 just before, read just after), then as many again on the same
    trainer, timed (at ``chunk_size > 1`` all replays). Returns the first
    run's records, counts and parameter checksum, and the numbers."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    u = cfg.total_steps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda",
                 model=model, batch_fn=batch_fn)
    tr.init_state()
    for m, a in counters:
        setattr(m, a, 0)
    t0 = time.perf_counter()
    res = tr.run(u)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = tuple(getattr(m, a) for m, a in counters)
    metrics = list(res.metrics)
    sums = _param_sums(torch, res.params)
    arrivals = res.arrivals
    t0 = time.perf_counter()
    res = tr.run(u)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    stats = dict(first_ms=1e3 * first_s, arrivals=arrivals,
                 arrival_ms=1e3 * steady_s / res.arrivals,
                 update_ms=1e3 * steady_s / u,
                 peak=torch.cuda.max_memory_allocated(),
                 reserved=torch.cuda.max_memory_reserved())
    for m in metrics:
        _log(f"[{tag}] update {m['step']} loss {m['loss']:.6f} sim_time "
             f"{m['sim_time']:.6f} selected {m['selected']} staleness "
             f"{m['staleness']:.3f}")
    graphs = ""
    if cfg.chunk_size > 1:
        g = tr._event_chunk.graphs
        stats.update(captures=(g[True].captures, g[False].captures),
                     capture_s=g[True].capture_s + g[False].capture_s,
                     replays=(g[True].replays, g[False].replays))
        graphs = (f" | captures apply {g[True].captures} / buffer "
                  f"{g[False].captures} in {stats['capture_s']:.3f} s, "
                  f"replays {g[True].replays} / {g[False].replays}")
    _log(f"[{tag}] {u} updates in {arrivals} arrivals: first run "
         f"{stats['first_ms']:.1f} ms; the next {u} updates "
         f"({res.arrivals} arrivals): {stats['arrival_ms']:.1f} ms/arrival, "
         f"{stats['update_ms']:.1f} ms/update host wall{graphs} | peak device "
         f"memory {stats['peak']} bytes allocated, {stats['reserved']} "
         f"reserved")
    if not all(math.isfinite(m["loss"]) for m in metrics) or \
            len(metrics) != u:
        raise AssertionError(f"[{tag}] {len(metrics)} records, or a "
                             f"non-finite loss")
    del tr, res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(metrics=metrics, counts=counts, sums=sums, stats=stats)


def _hold_events(tag, eager, graph):
    """The chunked (graph) run against the per-arrival run: the same
    arrivals, steps, sim_time, selected and staleness; bit-equal losses
    and parameter checksums."""
    keys = ("step", "sim_time", "selected", "staleness")
    ea, ga = eager["metrics"], graph["metrics"]
    if (len(ea) != len(ga) or eager["stats"]["arrivals"]
            != graph["stats"]["arrivals"]
            or any(a[k] != b[k] for a, b in zip(ea, ga) for k in keys)):
        raise AssertionError(f"[{tag}] the graph run planned other arrivals "
                             f"than the per-arrival run")
    differ = [a["step"] for a, b in zip(ea, ga) if a["loss"] != b["loss"]]
    if differ:
        raise AssertionError(f"[{tag}] graph losses differ from per-arrival "
                             f"from update {differ[0]}")
    if not graph["sums"].equal(eager["sums"]):
        raise AssertionError(f"[{tag}] graph parameter checksums differ "
                             f"from the per-arrival run")
    _log(f"[{tag}] graph run == per-arrival run: {len(ea)} updates, "
         f"{eager['stats']['arrivals']} arrivals, sim_time, selected and "
         f"staleness equal, losses and {graph['sums'].numel()} parameter "
         f"checksums bit-equal")


def _event_phase(torch, rwkv6_scan, backup_reduce):
    """Phases 11 and 12: async and softsync on qwen3-0.6b, async on
    rwkv6-1.6b, at full width cut to ``EVENT_LAYERS`` layers, per arrival
    and then through the event graphs."""
    from repro_torch.launch.profile_train import event_config
    counters = ((rwkv6_scan, "launches_fwd"), (rwkv6_scan, "launches_bwd"),
                (backup_reduce, "launches"),
                (rwkv6_scan, "launches_fwd_states"))
    out = {}
    for arch, strategy, updates in (("qwen3-0.6b", "async", 8),
                                    ("qwen3-0.6b", "softsync", 4),
                                    ("rwkv6-1.6b", "async", 4)):
        tag = f"event {arch} {EVENT_LAYERS} layers {strategy}"
        runs = {}
        for chunk in (1, updates):
            cfg = event_config(arch, strategy, steps=updates, chunk=chunk)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, num_layers=EVENT_LAYERS))
            kind = "graph" if chunk > 1 else "per-arrival"
            runs[kind] = _event_run(torch, cfg, counters, f"{tag} {kind}")
            n = runs[kind]["stats"]["arrivals"]
            layers = cfg.model.num_layers if arch == "rwkv6-1.6b" else 0
            want = (2 * layers * n, layers * n, 0, layers * n)
            if runs[kind]["counts"] != want:
                raise AssertionError(
                    f"[{tag} {kind}] launches wkv6 fwd/bwd, backup_reduce, "
                    f"state-writing wkv6 fwd {runs[kind]['counts']}, "
                    f"expected {want}")
            if layers:
                _log(f"[{tag} {kind}] launches wkv6 fwd {want[0]} (writing "
                     f"the chunk states {want[3]}) bwd {want[1]} "
                     f"backup_reduce 0 over {n} arrivals")
        _hold_events(tag, runs["per-arrival"], runs["graph"])
        out[tag] = runs
    return out


def _mnist_phase(torch):
    """Phase 13: the §2.1 rig, MnistCNN at its published widths on
    mnist_like, staleness tau 2 with a ramp of 5, 10 updates, chunk 1
    against chunk 4 on the card."""
    import numpy as np
    from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                     ModelConfig, OptimizerConfig,
                                     ShapeConfig, TrainConfig)
    from repro_torch.data import mnist_like
    from repro_torch.models import mnist_cnn
    data_cfg = mnist_like.MnistLikeConfig()
    train, _ = mnist_like.make_dataset(data_cfg)

    def batch_fn(worker, draw):
        idx = np.random.RandomState(draw).randint(0, data_cfg.num_train,
                                                  size=64)
        return {"images": train["images"][idx],
                "labels": train["labels"][idx]}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for chunk in (1, 4):
            cfg = TrainConfig(
                model=ModelConfig(name="mnist_cnn"),
                shape=ShapeConfig("mnist", 1, 64, "train"),
                aggregation=AggregationConfig(
                    strategy="staleness", num_workers=1, staleness_tau=2,
                    staleness_ramp_steps=5),
                optimizer=OptimizerConfig(name="sgd", learning_rate=0.05,
                                          scale_lr_with_workers=False,
                                          ema_decay=0.999),
                checkpoint=CheckpointConfig(every_steps=0), seed=0,
                total_steps=10, log_every=1, chunk_size=chunk)
            model = mnist_cnn.make(device="cuda")
            runs[chunk] = _event_run(
                torch, cfg, (), f"mnist staleness chunk {chunk}",
                model=model, batch_fn=batch_fn)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    stal = [m["staleness"] for m in runs[1]["metrics"]]
    if max(stal) != 2.0:
        raise AssertionError(f"[mnist] staleness sequence {stal} never "
                             f"reaches tau = 2")
    _hold_events(f"mnist staleness, widths {model.widths}", runs[1], runs[4])


def _event_parity_phase(torch):
    """Phase 14: 2 layers at full width, f32, async W = 4 and staleness
    tau 2, from the CPU port's draw of the weights: a checkpoint at update
    2, restored and continued for 2 updates, equals 4 straight (graph
    runs, atol 1e-6), and the straight run equals the CPU port's (atol
    1e-5, phase 7's tolerance)."""
    from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                     OptimizerConfig, ShapeConfig)
    from repro_torch.launch.profile_train import event_config
    from repro_torch.train.loop import Trainer

    def cfg(strategy, chunk, directory="", every=0):
        base = event_config("qwen3-0.6b", steps=4, chunk=chunk)
        agg = (AggregationConfig(strategy="async", num_workers=4)
               if strategy == "async" else AggregationConfig(
                   strategy="staleness", num_workers=1, staleness_tau=2,
                   staleness_ramp_steps=3))
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, num_layers=2,
                                            dtype="float32"),
            shape=ShapeConfig("parity", 64, 2 * agg.total_workers, "train"),
            aggregation=agg,
            optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                      scale_lr_with_workers=False,
                                      ema_decay=0.99),
            checkpoint=CheckpointConfig(directory=directory,
                                        every_steps=every))

    def worst(a, b):
        return max((v.detach().cpu() - b[k].detach().cpu()).abs().max().item()
                   for k, v in a.items())

    for strategy in ("async", "staleness"):
        # every run starts from the CPU port's draw of the weights
        cpu = Trainer(cfg(strategy, 1), device="cpu")
        cpu.init_state()

        def on_card(c):
            tr = Trainer(c, device="cuda")
            tr.model.load_state_dict(cpu.model.state_dict())
            tr.reset_optimizer_state()
            tr._init_event_state()
            return tr

        straight = on_card(cfg(strategy, 2))
        full = straight.run(4)
        with tempfile.TemporaryDirectory() as d:
            first = on_card(cfg(strategy, 2, d, every=2))
            first.run(2)
            resumed = Trainer(cfg(strategy, 2, d), device="cuda")
            resumed.reset_optimizer_state()
            resumed.restore_checkpoint()
            res = resumed.run(2)
        diff = max(worst(res.params, full.params), worst(res.ema, full.ema))
        stal = [m["staleness"] for m in full.metrics]
        if (diff > 1e-6 or res.sim_time != full.sim_time
                or [m["staleness"] for m in res.metrics] != stal[2:]):
            raise AssertionError(f"[parity event {strategy}] resume differs "
                                 f"from the straight run by {diff}")
        rc = cpu.run(4)
        cdiff = worst(full.params, rc.params)
        if (cdiff > 1e-5 or stal != [m["staleness"] for m in rc.metrics]
                or full.sim_time != rc.sim_time):
            raise AssertionError(f"[parity event {strategy}] card vs CPU: "
                                 f"params differ by {cdiff}")
        _log(f"[parity event {strategy}] 2-layer full-width f32, 4 updates: "
             f"checkpoint at 2 -> restore -> 2 more vs 4 straight (graph): "
             f"params and EMA max abs diff {diff:.3g} (atol 1e-6), sim_time "
             f"and staleness {stal} equal; card (graph) vs CPU port (per "
             f"arrival): params max abs diff {cdiff:.3g} (atol 1e-5)")
        del straight, first, resumed, cpu
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 15 and 16: the paper's convergence experiments
# ---------------------------------------------------------------------------


def _fig5_fig6_phase(torch):
    """Phase 15: Fig. 5 on the card at the tiny size, held to the CPU port
    over its first steps, then Fig. 6 from its fit."""
    from repro_torch.benchmarks import bench_iterations_vs_n as fig5
    from repro_torch.benchmarks import bench_time_to_converge as fig6
    n, steps, atol = FIG5_HOLD["n"], FIG5_HOLD["steps"], FIG5_HOLD["atol"]
    losses = {}
    for dev in ("cuda", "cpu"):
        losses[dev] = []
        fig5.steps_to_target(n, -math.inf, steps, device=dev,
                             losses=losses[dev])
    worst = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if len(losses["cuda"]) != steps or not worst <= atol:
        raise AssertionError(f"[fig5] card vs CPU port at N = {n}: max abs "
                             f"loss diff {worst} (atol {atol})")
    _log(f"[fig5] N = {n}, {steps} SGD steps: card vs CPU port max abs loss "
         f"diff {worst:.3g} (atol {atol}); card losses "
         f"{' '.join(f'{v:.6f}' for v in losses['cuda'])}")
    t0 = time.perf_counter()
    rows, fit = fig5.run(True, device="cuda")
    for row in rows:
        _log(f"[fig5] {','.join(str(x) for x in row)}")
    _log(f"[fig5] fit iters(N) = {fit[0]:.6f} + {fit[1]:.6f}/N, target "
         f"held-out loss {fig5.TARGET} ({time.perf_counter() - t0:.1f} s)")
    src = fig6.iters_model(fit)[1]
    for row in fig6.run(True, fit=fit):
        _log(f"[fig6] {','.join(str(x) for x in row)} (iters: {src})")


def _full_width_phase(torch, backup_reduce, rwkv6_scan):
    """Phase 16: the four regimes at full width, then rwkv6-1.6b through
    the wkv kernels and through the plain twin on the same stream."""
    import gc
    from repro_torch.benchmarks import bench_sync_vs_async as sva
    from repro_torch.train.loop import Trainer
    from unittest import mock
    t0 = time.perf_counter()
    backup_reduce.launches = 0
    get = sva.configs.get_config
    cut = dataclasses.replace(get(sva.FULL_ARCH), num_layers=FIGS89_LAYERS)
    with mock.patch.object(sva.configs, "get_config",
                           lambda arch: cut if arch == sva.FULL_ARCH
                           else get(arch)):
        out, rows = sva.run_full_width(device="cuda", log=_log)
    launches = backup_reduce.launches
    mask_steps = sum(out[k]["res"].steps for k in ("sync_backup",
                                                   "sync_full"))
    for row in rows:
        _log(f"[full width] {','.join(str(x) for x in row)}")
    for name, o in out.items():
        losses = [m["loss"] for m in o["res"].metrics]
        if not all(math.isfinite(v) for v in losses + [o["final"]]):
            raise AssertionError(f"[full width {name}] non-finite loss")
        if not losses[-1] <= losses[0] - FALL_NATS:
            raise AssertionError(f"[full width {name}] train loss "
                                 f"{losses[0]} -> {losses[-1]}: fell less "
                                 f"than {FALL_NATS} nats")
    if launches != mask_steps:
        raise AssertionError(f"[full width] backup_reduce launches "
                             f"{launches}, expected {mask_steps}")
    b, f, a = (out[k] for k in ("sync_backup", "sync_full", "async"))
    _log(f"[full width] qwen3-0.6b at {FIGS89_LAYERS} of 28 layers: every "
         f"loss finite; every regime's train loss fell "
         f"more than {FALL_NATS} nats; backup_reduce launches {launches} = "
         f"the mask regimes' {mask_steps} steps, replays counted "
         f"({time.perf_counter() - t0:.1f} s). The paper's claims (not "
         f"gated): backup reaches the target in less sim_time than full "
         f"sync: {b['to_target']['sim_time']} vs "
         f"{f['to_target']['sim_time']} (unigram level "
         f"{b['to_unigram']['sim_time']} vs {f['to_unigram']['sim_time']});"
         f" backup's final held-out loss no worse than async's: "
         f"{b['final']:.6f} vs {a['final']:.6f}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    _rwkv_converging(torch, backup_reduce, rwkv6_scan)


def _rwkv_converging(torch, backup_reduce, rwkv6_scan):
    """Phase 16's rwkv6-1.6b runs: the kernels against the plain twin on
    the converging run, with the Queue 3 controls; at 2 layers in f32 the
    same pair, as a control without bf16 rounding."""
    import gc
    from repro_torch.benchmarks import bench_sync_vs_async as sva
    from repro_torch.train.loop import Trainer
    steps = RWKV_CONVERGING_STEPS
    cfg, data_cfg = sva.full_width_cfg(
        "backup", arch="rwkv6-1.6b", workers=3, backups=1, steps=steps,
        lr=sva.FULL_BASE_LR * 3)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_layers=RWKV_CONVERGING_LAYERS))
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_layers=2, dtype="float32"))
    counters = ((rwkv6_scan, "launches_fwd"), (rwkv6_scan, "launches_bwd"),
                (backup_reduce, "launches"),
                (rwkv6_scan, "launches_fwd_states"))
    controls = _wkv_controls(torch, rwkv6_scan)
    for label, run_cfg in (("bf16", cfg), ("f32 2 layers", f32)):
        runs = {}
        tags = ["kernel", "plain"] + (list(controls) if label == "bf16"
                                      else [])
        for tag in tags:
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(run_cfg, device="cuda", data_cfg=data_cfg)
            tr.model.use_kernel = tag == "kernel"
            tr.init_state()
            if tag == "plain nudged":
                # control (i): one leaf one bf16 ulp up, the rest as is
                with torch.no_grad():
                    leaf = dict(tr.model.named_parameters())[NUDGED_LEAF]
                    leaf.copy_(torch.nextafter(leaf, torch.full_like(
                        leaf, math.inf)))
                tr.reset_optimizer_state()
            for m, attr in counters:
                setattr(m, attr, 0)
            with controls.get(tag, contextlib.nullcontext()):
                res = tr.run(steps)
            torch.cuda.synchronize()
            counts = tuple(getattr(m, attr) for m, attr in counters)
            per_step = (2 * run_cfg.model.num_layers
                        * run_cfg.aggregation.total_workers
                        if tag == "kernel" else 0)
            want = (per_step * steps, per_step // 2 * steps, steps,
                    per_step // 2 * steps)
            losses = [m["loss"] for m in res.metrics]
            if (tag in ("kernel", "plain") and counts != want) or \
                    len(losses) != steps or not all(
                        math.isfinite(v) for v in losses):
                raise AssertionError(
                    f"[rwkv converging {label} {tag}] launches wkv6 fwd/bwd,"
                    f" backup_reduce, state-writing fwd {counts} (expected "
                    f"{want}), or {len(losses)} losses, not all finite")
            _log(f"[rwkv converging {label} {tag}] {steps} steps, lr "
                 f"{run_cfg.optimizer.learning_rate:.6g}: launches wkv6 fwd "
                 f"{counts[0]} (writing the chunk states {counts[3]}) bwd "
                 f"{counts[1]} backup_reduce {counts[2]}; peak device memory "
                 f"{torch.cuda.max_memory_allocated()} bytes; train losses "
                 f"{' '.join(f'{v:.6f}' for v in losses)}")
            runs[tag] = losses
            del tr, res
            gc.collect()
            torch.cuda.empty_cache()
        for tag in tags[:1] + tags[2:]:
            gaps = [abs(k - p) / abs(p) for k, p in zip(runs[tag],
                                                         runs["plain"])]
            _log(f"[rwkv converging {label}] {tag} vs plain relative gap "
                 f"per step {' '.join(f'{g:.3g}' for g in gaps)}; largest "
                 f"{max(gaps):.3g} at step {gaps.index(max(gaps)) + 1}")
        if label == "bf16":
            gap = {t: max(abs(a - b) / abs(b) for a, b in zip(
                runs[t], runs["plain"])) for t in tags[:1] + tags[2:]}
            ratio = gap["kernel"] / max(gap["plain nudged"], 1e-30)
            _log(f"[rwkv converging bf16] Queue 3 verdict: the kernel's "
                 f"largest gap {gap['kernel']:.3g} is {ratio:.3g}x control "
                 f"(i)'s {gap['plain nudged']:.3g} (one bf16 ulp on "
                 f"{NUDGED_LEAF}; the factor set beforehand: "
                 f"{CONTROL_FACTOR}); control (ii): kernel forward alone "
                 f"{gap['kernel fwd, plain bwd']:.3g}, kernel backward "
                 f"alone {gap['plain fwd, kernel bwd']:.3g}: "
                 + ("within the factor: the parting is the trajectory's "
                    "sensitivity to rounding" if ratio <= CONTROL_FACTOR
                    else "beyond the factor"))


def _wkv_controls(torch, rwkv6_scan):
    """Queue 3's control (ii): the model's wkv through the kernel forward
    with the plain twin's backward, and through the plain forward with the
    kernel backward, each an ``autograd.Function`` here (not on the main
    path), as contexts that route ``models.rwkv6.wkv_chunked`` through it;
    control (i), the nudged plain run, needs no context."""
    from unittest import mock
    from repro_torch.models import rwkv6

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(r, k, v, w, u):
            out, final, _ = rwkv6_scan.wkv6_forward(r, k, v, w, u,
                                                    save_states=False)
            return out, final

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        @staticmethod
        def backward(ctx, dout, dfinal):
            _, pull = torch.func.vjp(rwkv6_scan.wkv6_plain,
                                     *ctx.saved_tensors)
            return pull((dout, dfinal))

    class PlainFwdKernelBwd(torch.autograd.Function):
        @staticmethod
        def forward(r, k, v, w, u):
            return rwkv6_scan.wkv6_plain(r, k, v, w, u)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        @staticmethod
        def backward(ctx, dout, dfinal):
            ins = ctx.saved_tensors
            states = rwkv6_scan.WKV6.apply(*ins, True)[2]
            return rwkv6_scan.WKV6Backward.apply(*ins, states, dout, dfinal)

    def route(fn):
        return mock.patch.object(
            rwkv6, "wkv_chunked",
            lambda r, k, v, w, u, state=None, *a, **kw: fn.apply(
                r, k, v, w, u))

    return {"plain nudged": contextlib.nullcontext(),
            "kernel fwd, plain bwd": route(KernelFwdPlainBwd),
            "plain fwd, kernel bwd": route(PlainFwdKernelBwd)}


# ---------------------------------------------------------------------------
# Phases 17 and 18: batched worker gradients, the 'data' axis over ranks
# ---------------------------------------------------------------------------


def _small_cfg(arch, grad_batch, *, mesh_data=1, chunk=1):
    """``arch`` cut to 2 layers in f32 at full width (seq 64 for qwen3, as
    phase 7; 256 for rwkv6, as phase 10), momentum (phase 7's reason), 3
    steps, at ``grad_batch`` over ``mesh_data`` ranks in chunks of
    ``chunk``."""
    from repro_torch.configs import OptimizerConfig
    from repro_torch.launch.profile_train import train_config
    cfg = train_config(arch)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_layers=2,
                                       dtype="float32"),
        shape=dataclasses.replace(
            cfg.shape, seq_len=64 if arch == "qwen3-0.6b" else 256),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.99),
        execution=dataclasses.replace(cfg.execution, grad_batch=grad_batch,
                                      mesh_data=mesh_data),
        chunk_size=chunk)


def _run_small(torch, cfg, device="cuda"):
    """``cfg``'s 3 steps on a fresh trainer; its parameters and losses."""
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    tr = Trainer(cfg, latency=PaperCalibrated(), device=device)
    tr.init_state()
    res = tr.run(cfg.total_steps)
    return ({k: v.detach().clone() for k, v in res.params.items()},
            [m["loss"] for m in res.metrics])


def _worst(a, b) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in a)


def _wkv_launches(cfg, grad_batch, steps):
    """(wkv6 forwards, backwards, backup_reduce, state-writing forwards)
    of ``steps`` steps of ``cfg`` at ``grad_batch``: per layer and group of
    workers a first pass and its recompute (half of them writing the chunk
    states) and one backward; one reduce a step."""
    w = cfg.aggregation.total_workers // cfg.execution.mesh_data
    groups = w // (grad_batch or w)
    per = cfg.model.num_layers * groups if cfg.model.family == "ssm" else 0
    return (2 * per * steps, per * steps, steps, per * steps)


def _rel_l2(torch, a, b) -> float:
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def _f32_first_grad(torch, arch):
    """The first aggregated gradient of ``train_config(arch)``'s first
    step computed in f32 (TF32 off) from the same bf16 initial weights:
    the gradient the bf16 runs approximate (in host memory)."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.launch.profile_train import train_config
    from repro_torch.models import get_model
    from repro_torch.train.loop import Trainer
    cfg = train_config(arch, steps=1)
    tr = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32")), latency=PaperCalibrated(),
        device="cuda")
    bf16 = get_model(cfg.model, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(cfg.seed))
    with torch.no_grad():
        for p, q in zip(tr.model.parameters(), bf16.parameters()):
            p.copy_(q)
    del bf16
    tr.reset_optimizer_state()
    with _first_grad() as first:
        tr.run(1)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return first[0]


def _batched_phase(torch, backup_reduce, rwkv6_scan, one_at_a_time):
    """Phase 17: the batched worker gradients at full width through the
    graph, held to the one-worker-at-a-time runs of phases 6 and 9
    (``one_at_a_time``: arch -> that eager run), then at 2 layers in f32
    against grad_batch 1. Returns each run's launches and graph numbers,
    by tag."""
    import gc
    from repro_torch.launch.profile_train import train_config
    counters = ((rwkv6_scan, "launches_fwd"), (rwkv6_scan, "launches_bwd"),
                (backup_reduce, "launches"),
                (rwkv6_scan, "launches_fwd_states"))
    launches, graphs = {}, {}
    for arch, gbs in BATCHED_RUNS:
        ref = one_at_a_time[arch]
        truth = _f32_first_grad(torch, arch)
        err1 = _rel_l2(torch, ref["first_grad"], truth)
        for gb in gbs:
            cfg = train_config(arch, grad_batch=gb)
            tag = f"{arch} grad_batch {gb}"
            with _first_grad() as first:
                metrics, counts, sums, masks, stats = _graph_train_run(
                    torch, cfg, counters, tag)
            rel_l2 = _rel_l2(torch, first[0], ref["first_grad"])
            err = _rel_l2(torch, first[0], truth)
            del first[:]
            want = _wkv_launches(cfg, gb, cfg.total_steps)
            if counts != want:
                raise AssertionError(
                    f"[batched {tag}] launches wkv6 fwd/bwd, backup_reduce,"
                    f" state-writing wkv6 fwd {counts}, expected {want}")
            if not _same_masks(ref["masks"], masks) or any(
                    a["selected"] != b["selected"]
                    or a["sim_time"] != b["sim_time"]
                    for a, b in zip(ref["metrics"], metrics)):
                raise AssertionError(f"[batched {tag}] masks or sim_time "
                                     f"differ from the grad_batch 1 run")
            gaps = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                    for a, b in zip(ref["metrics"], metrics)]
            if len(gaps) != cfg.total_steps or not gaps[0] <= 1e-3 or \
                    not err <= BATCHED_ERR_FACTOR * err1 or \
                    not all(math.isfinite(m["loss"]) for m in metrics):
                raise AssertionError(
                    f"[batched {tag}] vs grad_batch 1: step 1 loss rel gap "
                    f"{gaps[0]} (limit 1e-3); first aggregated gradient's "
                    f"rel L2 from the f32 gradient {err} against grad_batch "
                    f"1's {err1} (limit {BATCHED_ERR_FACTOR}x); or a "
                    f"non-finite loss")
            launches[tag] = dict(zip(("wkv6_fwd", "wkv6_bwd",
                                      "backup_reduce", "wkv6_fwd_states"),
                                     counts))
            graphs[tag] = stats
            _log(f"[batched {tag}] held to the grad_batch 1 run: masks, "
                 f"selected and sim_time equal, step 1 loss rel gap "
                 f"{gaps[0]:.3g} (limit 1e-3); first aggregated gradient: "
                 f"rel L2 from the f32 gradient {err:.3g}, grad_batch 1's "
                 f"{err1:.3g} (limit {BATCHED_ERR_FACTOR}x), from grad_batch "
                 f"1's {rel_l2:.3g}; later steps' loss rel gaps (not gated) "
                 f"{' '.join(f'{v:.3g}' for v in gaps[1:])} | launches "
                 f"wkv6 fwd "
                 f"{counts[0]} (writing the chunk states {counts[3]}) bwd "
                 f"{counts[1]} backup_reduce {counts[2]} | host wall "
                 f"{stats['replay_ms']:.3f} ms/step, device busy "
                 f"{stats['busy_ms']:.3f} ms/step, capture "
                 f"{stats['capture_s']:.3f} s, peak {stats['peak']} bytes "
                 f"allocated, {stats['reserved']} reserved")
            gc.collect()
            torch.cuda.empty_cache()
    return launches, graphs


def _batched_parity_phase(torch):
    """Phase 17 at 2 layers in f32: grad_batch 0 and 2 against 1."""
    import gc
    for arch in ("qwen3-0.6b", "rwkv6-1.6b"):
        params = {gb: _run_small(torch, _small_cfg(arch, gb))[0]
                  for gb in (1, 0, 2)}
        worst = {gb: _worst(params[gb], params[1]) for gb in (0, 2)}
        if not max(worst.values()) <= 1e-5:
            raise AssertionError(f"[batched {arch} 2 layers f32] params vs "
                                 f"grad_batch 1 max abs {worst} (atol 1e-5)")
        _log(f"[batched {arch} 2 layers f32] 3 steps, params vs grad_batch "
             f"1 max abs diff: grad_batch 0 {worst[0]:.3g}, 2 "
             f"{worst[2]:.3g} (atol 1e-5)")
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _mesh_rank(rank, device, out_dir, runs):
    """One rank of phase 18 (``mesh.spawn``): each of ``runs`` ((tag, cfg,
    keep)) on a fresh trainer, the counters set to 0 just before and read
    just after; the losses, per-tensor parameter sums and numbers go to
    ``out_dir/rank<r>.json``. Rank 0 keeps the parameters of the runs
    marked ``keep`` and holds them to the same config on its card alone
    (mesh_data 1)."""
    import torch
    from repro_torch.kernels import backup_reduce, rwkv6_scan
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = ((rwkv6_scan, "launches_fwd"), (rwkv6_scan, "launches_bwd"),
                (backup_reduce, "launches"),
                (rwkv6_scan, "launches_fwd_states"))
    out = {}
    for tag, cfg, keep in runs:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        tr = Trainer(cfg, latency=PaperCalibrated(), device=device)
        tr.init_state()
        for m, a in counters:
            setattr(m, a, 0)
        t0 = time.perf_counter()
        res = tr.run(cfg.total_steps)
        torch.cuda.synchronize(device)
        first_ms = 1e3 * (time.perf_counter() - t0)
        r = dict(losses=[m["loss"] for m in res.metrics],
                 sums=_param_sums(torch, res.params).tolist(),
                 counts=[getattr(m, a) for m, a in counters],
                 first_ms=first_ms)
        if keep:
            kept = {k: v.detach().cpu() for k, v in res.params.items()}
        if cfg.chunk_size > 1:
            k = cfg.chunk_size
            t0 = time.perf_counter()
            tr.run(k)
            torch.cuda.synchronize(device)
            r["replay_ms"] = 1e3 * (time.perf_counter() - t0) / k
            r["capture_s"] = tr.chunk_step.graph.capture_s
        r["peak"] = torch.cuda.max_memory_allocated(device)
        r["reserved"] = torch.cuda.max_memory_reserved(device)
        out[tag] = r
        del tr, res
        torch.cuda.empty_cache()
        if keep and rank == 0:
            one = dataclasses.replace(cfg, execution=dataclasses.replace(
                cfg.execution, mesh_data=1), chunk_size=1)
            params, _ = _run_small(torch, one, device)
            r["vs_one_card"] = max(
                (kept[k] - v.cpu()).abs().max().item()
                for k, v in params.items())
            del params
        if keep:
            del kept
        torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_phase(torch):
    """Phase 18: the 'data' axis over ranks. With at least 2 cards: NCCL
    over 2 ranks (and 4 with 4 cards), each on its own card, the collective
    captured in the step graph; with one card: 2 ranks over gloo on it."""
    from repro_torch.distributed import mesh
    from repro_torch.launch.profile_train import train_config
    cards = torch.cuda.device_count()
    sizes = [k for k in (2, 4) if k <= cards] if cards >= 2 else [2]
    nccl = cards >= 2
    if not nccl:
        _log("[mesh] one card visible: NCCL not run (it needs a card per "
             "rank); 2 ranks over gloo on CUDA tensors on the one card, at "
             "2 layers f32, chunk_size 1 (a gloo all-reduce cannot be "
             "captured in a CUDA graph)")
    launches = {}
    for k in sizes:
        runs = [(f"qwen3-0.6b 2 layers f32 mesh {k}",
                 _small_cfg("qwen3-0.6b", 0, mesh_data=k,
                            chunk=3 if nccl else 1), True)]
        if nccl:
            runs.append((f"qwen3-0.6b mesh {k}", dataclasses.replace(
                train_config("qwen3-0.6b", grad_batch=0, mesh_data=k),
                chunk_size=3), False))
        if nccl and k == 4:
            cfg = train_config("rwkv6-1.6b", grad_batch=0, mesh_data=4)
            runs.append(("rwkv6-1.6b mesh 4", dataclasses.replace(
                cfg, chunk_size=3, shape=dataclasses.replace(
                    cfg.shape, global_batch=2 * 8),
                aggregation=dataclasses.replace(
                    cfg.aggregation, num_workers=6, backup_workers=2)),
                False))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            mesh.spawn(_mesh_rank, k, "cuda", args=(d, runs),
                       start_method="forkserver",
                       timeout_s=MESH_TIMEOUT_S)
            ranks = []
            for r in range(k):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        backend = "nccl" if nccl else "gloo"
        for tag, cfg, keep in runs:
            first = ranks[0][tag]
            for r, other in enumerate(ranks[1:], 1):
                if other[tag]["sums"] != first["sums"] or \
                        other[tag]["losses"] != first["losses"]:
                    raise AssertionError(f"[mesh {tag}] rank {r}'s "
                                         f"parameters or losses differ from "
                                         f"rank 0's")
            steps = cfg.total_steps
            for r, rk in enumerate(ranks):
                want = _wkv_launches(cfg, 0, steps)
                if rk[tag]["counts"] != list(want):
                    raise AssertionError(
                        f"[mesh {tag}] rank {r}: launches wkv6 fwd/bwd, "
                        f"backup_reduce, state-writing fwd "
                        f"{rk[tag]['counts']}, expected {list(want)}")
            if not all(math.isfinite(v) for v in first["losses"]):
                raise AssertionError(f"[mesh {tag}] non-finite loss")
            if keep and not first["vs_one_card"] <= 1e-5:
                raise AssertionError(f"[mesh {tag}] params vs the one-card "
                                     f"run max abs {first['vs_one_card']}")
            launches[tag] = dict(zip(("wkv6_fwd", "wkv6_bwd",
                                      "backup_reduce", "wkv6_fwd_states"),
                                     first["counts"]))
            timing = (f"host wall {first['replay_ms']:.3f} ms/step (a chunk "
                      f"of replays), capture {first['capture_s']:.3f} s"
                      if "replay_ms" in first else
                      f"first run {first['first_ms']:.1f} ms")
            _log(f"[mesh {tag}] {backend}, {k} ranks: losses "
                 f"{' '.join(f'{v:.6f}' for v in first['losses'])}; every "
                 f"rank's {len(first['sums'])} parameter sums and losses "
                 f"bit-identical; launches per rank wkv6 fwd "
                 f"{first['counts'][0]} bwd {first['counts'][1]} "
                 f"backup_reduce {first['counts'][2]} | rank 0: {timing}, "
                 f"peak {first['peak']} bytes allocated, {first['reserved']} "
                 f"reserved"
                 + (f" | params vs one card max abs "
                    f"{first['vs_one_card']:.3g} (atol 1e-5)"
                    if keep else ""))
        _log(f"[mesh] {k} ranks over {backend}: "
             f"{time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the 'model' axis (tensor parallelism) over ranks
# ---------------------------------------------------------------------------


def _tp_full_cfg(shape, grad_batch, chunk, steps=3, layers=None):
    """qwen3-0.6b at full width (``train_config``; ``layers`` cuts its
    depth) over the ``shape`` = (mesh_data, mesh_model) mesh, ``steps``
    steps in chunks of ``chunk``."""
    from repro_torch.launch.profile_train import train_config
    cfg = train_config("qwen3-0.6b", grad_batch=grad_batch, steps=steps,
                       mesh_data=shape[0], mesh_model=shape[1])
    if layers is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_layers=layers))
    return dataclasses.replace(cfg, chunk_size=chunk)


def _tp_small_cfg(shape, chunk):
    """Phase 18's 2-layer f32 qwen3 (``_small_cfg``) over ``shape``."""
    cfg = _small_cfg("qwen3-0.6b", 0, mesh_data=shape[0], chunk=chunk)
    return dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, mesh_model=shape[1]))


def _sha(torch, t) -> str:
    """A hash of a tensor's bytes: equal hashes, bit-identical tensors."""
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()


def _tp_rank(rank, device, out_dir, runs):
    """One rank of phase 19 (``mesh.spawn``): each of ``runs`` ((tag, cfg,
    kind)) on a fresh trainer, the counters (backup_reduce launches, the
    model group's all-reduces) set to 0 just before and read just after.
    Writes ``out_dir/rank<r>.json``: the losses, a hash of each replicated
    leaf, the counts, P_local, peak memory and, for a chunked run, a
    chunk of replays' host wall, a profiled chunk's device busy and the
    capture time. ``kind`` "small":
    the full parameters are gathered and rank 0 holds them to the same
    config on its card alone; "full": rank 0 then holds backup_reduce to
    its plain version at the run's [W_local, P_local] stack, once."""
    import gc
    import torch
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.distributed import mesh, tp
    from repro_torch.kernels import backup_reduce
    from repro_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag, cfg, kind in runs:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        tr = Trainer(cfg, latency=PaperCalibrated(), device=device)
        tr.init_state()
        dims = tr.model.tp_dims
        steps = cfg.total_steps
        backup_reduce.launches = 0
        tp.all_reduces = 0
        t0 = time.perf_counter()
        res = tr.run(steps)
        torch.cuda.synchronize(device)
        r = dict(losses=[m["loss"] for m in res.metrics],
                 first_ms=1e3 * (time.perf_counter() - t0),
                 reduces=backup_reduce.launches,
                 all_reduces=tp.all_reduces / steps,
                 p_local=sum(p.numel() for p in res.params.values()),
                 w_local=cfg.aggregation.total_workers
                 // cfg.execution.mesh_data,
                 replicated={k: _sha(torch, v) for k, v in res.params.items()
                             if dims[k] is None},
                 split=sum(d is not None for d in dims.values()))
        if kind == "small":
            kept = {k: v.detach().to("cpu", copy=True)
                    for k, v in tr._full(res.params).items()}
        k = cfg.chunk_size
        if k > 1:
            t0 = time.perf_counter()
            tr.run(k)
            torch.cuda.synchronize(device)
            r["replay_ms"] = 1e3 * (time.perf_counter() - t0) / k
            r["capture_s"] = tr.chunk_step.graph.capture_s
            r["busy_ms"] = _busy_ms(torch, [lambda: tr.run(k)], calls=1) / k
        r["peak"] = torch.cuda.max_memory_allocated(device)
        r["reserved"] = torch.cuda.max_memory_reserved(device)
        out[tag] = r
        del tr, res
        gc.collect()
        torch.cuda.empty_cache()
        if rank == 0 and kind == "small":
            one = dataclasses.replace(cfg, execution=dataclasses.replace(
                cfg.execution, mesh_data=1, mesh_model=1), chunk_size=1)
            params, _ = _run_small(torch, one, device)
            r["vs_one_card"] = max((kept[n] - v.cpu()).abs().max().item()
                                   for n, v in params.items())
            del params
        if rank == 0 and kind == "full":
            gen = torch.Generator(device=device).manual_seed(19)
            grads = torch.randn((r["w_local"], r["p_local"]), generator=gen,
                                device=device)
            mask = (torch.arange(r["w_local"], device=device) % 4
                    != 3).float()
            n = cfg.aggregation.num_workers
            before = backup_reduce.launches
            got = backup_reduce.backup_reduce(grads, mask, n)
            backup_reduce.launches = before   # a comparison, not the path
            want = backup_reduce.backup_reduce_plain(grads, mask, n)
            r["hold_max_abs_err"] = (got - want).abs().max().item()
            r["hold_equal"] = bool(torch.equal(got, want))
            del grads, got, want
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _tp_ref_loss(torch, layers=None):
    """Step 1's loss of the full-width one-card run at grad_batch 1 (phase
    6's run; ``layers`` cuts its depth), for ``--mesh-only`` and the
    one-card gloo run."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    tr = Trainer(_tp_full_cfg((1, 1), 1, 1, steps=1, layers=layers),
                 latency=PaperCalibrated(), device="cuda")
    tr.init_state()
    loss = tr.run(1).metrics[0]["loss"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def _tp_phase(torch, ref_loss):
    """Phase 19: the 'model' axis over ranks. With one card: 2 gloo ranks
    on it at mesh 1 x 2, chunk 1 (gloo cannot be captured): 2 layers f32
    held to the one-card run, then qwen3-0.6b at full width cut to
    ``TP_GLOO_LAYERS`` layers for 2 steps at grad_batch 1, its step 1 loss
    held to the one-card run's at that depth. With 2 or more cards: NCCL
    at 1 x 2 (and 1 x 4, 2 x 2 with 4), one card per rank, 2 layers f32
    then full width at grad_batch 0, each one chunk of 3 through the graph
    with the model group's all-reduces captured. ``ref_loss``: step 1's
    loss of the one-card full-width run."""
    from repro_torch.distributed import mesh
    cards = torch.cuda.device_count()
    nccl = cards >= 2
    shapes = [s for s in ((1, 2), (1, 4), (2, 2)) if s[0] * s[1] <= cards] \
        if nccl else [(1, 2)]
    if not nccl:
        _log("[tp] one card visible: NCCL not run (it needs a card per "
             "rank); 2 ranks over gloo on CUDA tensors on the one card, "
             "chunk_size 1 (a gloo all-reduce cannot be captured), the "
             f"full-width run cut to {TP_GLOO_LAYERS} of 28 layers")
        ref_loss = _tp_ref_loss(torch, TP_GLOO_LAYERS)
    launches = {}
    for shape in shapes:
        d, m = shape
        name = f"mesh {d} x {m}"
        chunk = 3 if nccl else 1
        runs = [(f"qwen3-0.6b 2 layers f32 {name}",
                 _tp_small_cfg(shape, chunk), "small"),
                (f"qwen3-0.6b {name}" if nccl else
                 f"qwen3-0.6b {TP_GLOO_LAYERS} layers {name}",
                 _tp_full_cfg(shape, 0 if nccl else 1, chunk,
                              steps=3 if nccl else 2,
                              layers=None if nccl else TP_GLOO_LAYERS),
                 "full")]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mesh.spawn(_tp_rank, d, "cuda", args=(tmp, runs), mesh_model=m,
                       start_method="forkserver",
                       timeout_s=MESH_TIMEOUT_S)
            ranks = []
            for r in range(d * m):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        backend = "nccl" if nccl else "gloo"
        for tag, cfg, kind in runs:
            first = ranks[0][tag]
            steps = cfg.total_steps
            for r, other in enumerate(ranks):
                o = other[tag]
                if o["losses"] != first["losses"] or \
                        o["replicated"] != first["replicated"] or \
                        o["all_reduces"] != first["all_reduces"]:
                    raise AssertionError(
                        f"[tp {tag}] rank {r}'s losses, replicated leaves "
                        f"or all-reduce count differ from rank 0's")
                if o["reduces"] != steps:
                    raise AssertionError(
                        f"[tp {tag}] rank {r}: {o['reduces']} backup_reduce "
                        f"launches in {steps} steps, expected {steps}")
            if not first["split"] or not first["all_reduces"] or \
                    not all(math.isfinite(v) for v in first["losses"]):
                raise AssertionError(f"[tp {tag}] no split leaf, no model-"
                                     f"group all-reduce or a non-finite "
                                     f"loss: {first}")
            if kind == "small" and not first["vs_one_card"] <= 1e-5:
                raise AssertionError(f"[tp {tag}] params vs the one-card "
                                     f"run max abs {first['vs_one_card']}")
            if kind == "full":
                gap = abs(first["losses"][0] - ref_loss) / abs(ref_loss)
                if not gap <= 1e-3:
                    raise AssertionError(
                        f"[tp {tag}] step 1 loss {first['losses'][0]} vs "
                        f"the one-card run's {ref_loss}: rel {gap} (limit "
                        f"1e-3)")
                if not first["hold_equal"]:
                    raise AssertionError(
                        f"[tp {tag}] backup_reduce vs plain at [W_local, "
                        f"P_local] = [{first['w_local']}, "
                        f"{first['p_local']}]: max abs "
                        f"{first['hold_max_abs_err']}")
                launches[tag] = dict(backup_reduce=first["reduces"],
                                     wkv6_fwd=0, wkv6_bwd=0,
                                     wkv6_fwd_states=0)
            timing = (f"host wall {first['replay_ms']:.3f} ms/step (a chunk "
                      f"of replays), device busy {first['busy_ms']:.3f} "
                      f"ms/step, capture {first['capture_s']:.3f} s"
                      if "replay_ms" in first else
                      f"first run {first['first_ms']:.1f} ms ({steps} eager "
                      f"steps; a gloo check, not timed further)")
            _log(f"[tp {tag}] {backend}, {d * m} ranks: losses "
                 f"{' '.join(f'{v:.6f}' for v in first['losses'])}; every "
                 f"rank's losses and {len(first['replicated'])} replicated "
                 f"leaves bit-identical; {first['split']} split leaves, "
                 f"P_local {first['p_local']}, W_local {first['w_local']}; "
                 f"per rank backup_reduce {first['reduces']} in {steps} "
                 f"steps, model-group all-reduces "
                 f"{first['all_reduces']:.1f}/step | rank 0: {timing}, peak "
                 f"{first['peak']} bytes allocated, {first['reserved']} "
                 f"reserved"
                 + (f" | params vs one card max abs "
                    f"{first['vs_one_card']:.3g} (atol 1e-5)"
                    if kind == "small" else
                    f" | step 1 loss vs one card rel "
                    f"{abs(first['losses'][0] - ref_loss) / abs(ref_loss):.3g}"
                    f" (limit 1e-3); backup_reduce == plain bit for bit at "
                    f"[{first['w_local']}, {first['p_local']}] (max abs "
                    f"{first['hold_max_abs_err']:.3g})"))
        _log(f"[tp] {name} over {backend}: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 20: the device straggler backend
# ---------------------------------------------------------------------------


def _device_cfg(chunk, backend, *, steps=DEVICE_STEPS, noise=None):
    """Phase 20's cell: qwen3-0.6b at full width cut to ``DEVICE_LAYERS``
    layers on the sim backend (backup
    6 + 2, 2 x 256 tokens a worker, rmsprop_momentum, grad_batch 1), the
    token stream cut to ``DATA_VOCAB`` ids (``device_batch_fn`` computes in
    int32 and refuses vocabularies over 46340, as the reference does)."""
    from repro_torch.data.synthetic_lm import SyntheticLMConfig
    from repro_torch.launch.profile_train import train_config
    cfg = train_config(backend="sim", steps=steps)
    cfg = dataclasses.replace(
        cfg, chunk_size=chunk, straggler_backend=backend,
        model=dataclasses.replace(cfg.model, num_layers=DEVICE_LAYERS),
        optimizer=dataclasses.replace(cfg.optimizer,
                                      learning_rate=FAULT_LR))
    data = SyntheticLMConfig(
        vocab_size=DATA_VOCAB, seq_len=cfg.shape.seq_len,
        global_batch=cfg.shape.global_batch,
        num_workers=cfg.aggregation.total_workers, seed=cfg.seed,
        **({} if noise is None else {"noise": noise}))
    return cfg, data


def _device_run(torch, chunk, backend):
    """8 steps of phase 20's cell at ``chunk``; on the device backend every
    chunk's arrivals, masks and times (``select_device``'s in and out) are
    kept. Returns the metrics, the kept chunks (host copies), the host wall
    per step and the parameter checksums."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    cfg, data = _device_cfg(chunk, backend)
    tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda",
                 data_cfg=data)
    tr.init_state()
    picks = []
    if backend == "device":
        select = tr.strategy.select_device

        def keep(arrivals):
            masks, times = select(arrivals)
            picks.append((arrivals.clone(), masks.clone(), times.clone()))
            return masks, times

        # the strategy is a frozen dataclass: set the spy past it
        object.__setattr__(tr.strategy, "select_device", keep)
    res = tr.run(cfg.total_steps)
    torch.cuda.synchronize()
    out = dict(metrics=list(res.metrics), step_ms=[1e3 * t for t in
                                                   res.step_times_s],
               picks=[tuple(t.cpu() for t in p) for p in picks],
               sums=_param_sums(torch, res.params),
               captures=tr.chunk_step.graph.captures)
    del tr, res, picks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _summary(np, x):
    x = np.asarray(x, np.float64).ravel()
    return np.concatenate([[x.mean(), x.std()],
                           np.quantile(x, SAMPLER_QUANTILES)])


def _device_backend_phase(torch):
    """Phase 20: the samplers and ``device_batch_fn`` on the card, then the
    cell as chunks of 4 + 4 and as one chunk of 8 (bit-equal), each chunk's
    device selection held to the host ``select`` on the same arrivals,
    and the host backend's wall beside it (a record)."""
    import numpy as np
    from repro_torch.core import straggler as st
    from repro_torch.core import straggler_device as sd
    from repro_torch.data.synthetic_lm import _transition, device_batch_fn
    w = 8
    for model in (st.PaperCalibrated(), st.LogNormal(), st.Uniform(),
                  st.DeterministicStragglers(slow_workers=(6, 7))):
        gen = torch.Generator(device="cuda").manual_seed(0)
        got = sd.sampler_for(model)(gen, (SAMPLER_DRAWS // w, w))
        got = got.cpu().numpy()
        want = model.sample(np.random.RandomState(0),
                            (SAMPLER_DRAWS // w, w))
        a, b = _summary(np, got), _summary(np, want)
        rel = np.abs(a / b - 1)
        _log(f"[device backend] {type(model).__name__}: {SAMPLER_DRAWS} "
             f"f32 draws on the card vs {SAMPLER_DRAWS} numpy draws: mean, "
             f"std, quantiles {SAMPLER_QUANTILES} rel err "
             f"{' '.join(f'{v:.2e}' for v in rel)} (limit 0.05)")
        if not (got.dtype == np.float32 and (got > 0).all()
                and rel.max() <= 0.05):
            raise AssertionError(f"[device backend] {type(model).__name__} "
                                 f"does not match the numpy model")
    _, data0 = _device_cfg(4, "device", noise=0.0)
    b = device_batch_fn(data0, "cuda")(3)
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], 1).cpu().numpy()
    a, c = _transition(DATA_VOCAB, data0.seed)
    if not (seq.shape == (data0.global_batch, data0.seq_len + 1)
            and np.array_equal(seq[:, 1:],
                               (a * seq[:, :-1] + c) % DATA_VOCAB)):
        raise AssertionError("[device backend] device_batch_fn at noise 0 "
                             "is not the closed-form chain")
    _log(f"[device backend] device_batch_fn at noise 0: {seq.size} tokens "
         f"on the card follow the chain tok' = ({a} tok + {c}) mod "
         f"{DATA_VOCAB}")
    from repro_torch.core.coordination import BackupWorkers
    runs = {(4, "device"): _device_run(torch, 4, "device"),
            (8, "device"): _device_run(torch, 8, "device"),
            (4, "host"): _device_run(torch, 4, "host")}
    four, eight = runs[4, "device"], runs[8, "device"]
    key = [(m["step"], m["loss"], m["selected"], m["sim_time"])
           for m in four["metrics"]]
    if key != [(m["step"], m["loss"], m["selected"], m["sim_time"])
               for m in eight["metrics"]] or not four["sums"].equal(
                   eight["sums"]):
        raise AssertionError("[device backend] chunks of 4 + 4 and one "
                             "chunk of 8 differ")
    cat = [torch.cat([p[i] for p in four["picks"]]) for i in range(3)]
    if not all(torch.equal(x, y) for x, y in zip(cat, eight["picks"][0])):
        raise AssertionError("[device backend] the partitions drew or "
                             "selected differently")
    strategy = BackupWorkers(6, 2)
    for arrivals, masks, times in four["picks"] + eight["picks"]:
        rows = [strategy.select(a) for a in arrivals.double().numpy()]
        if not (np.array_equal(masks.numpy(), [m for m, _ in rows])
                and times.double().tolist() == [t for _, t in rows]):
            raise AssertionError("[device backend] device masks or times "
                                 "differ from the host select on the same "
                                 "arrivals")
    if not all(math.isfinite(m["loss"]) for m in four["metrics"]):
        raise AssertionError("[device backend] non-finite loss")
    host = runs[4, "host"]
    steady = {k: statistics.mean(r["step_ms"][4:]) for k, r in runs.items()}
    _log(f"[device backend] qwen3-0.6b full width ({DEVICE_LAYERS} of 28 "
         f"layers), sim backend, backup "
         f"6 + 2, data vocab {DATA_VOCAB}: 8 steps as chunks 4 + 4 == one "
         f"chunk of 8 (losses, selected, sim_time, parameter checksums "
         f"bit-equal; {len(four['picks'])} + {len(eight['picks'])} chunks' "
         f"masks and times == BackupWorkers.select on the same arrivals, "
         f"row by row); losses "
         f"{' '.join(f'{m[1]:.6f}' for m in key)}; captures "
         f"{four['captures']} / {eight['captures']}")
    _log(f"[device backend] host wall per step, second chunk of 4: device "
         f"backend {steady[4, 'device']:.3f} ms, host backend "
         f"{steady[4, 'host']:.3f} ms (same cell; a record, not a gate); "
         f"host backend losses "
         f"{' '.join(f'{m['loss']:.6f}' for m in host['metrics'])}")


# ---------------------------------------------------------------------------
# Phase 21: faults on the spmd engine
# ---------------------------------------------------------------------------


def _fault_cfg(directory, spec, steps=FAULT_STEPS, layers=FAULT_LAYERS):
    """Phase 21's cell: qwen3-0.6b at full width (cut to ``layers``) on the
    spmd engine (``train_config``: backup 6 + 2, grad_batch 1; lr
    ``FAULT_LR`` x N), chunks of 4 through the graph, checkpoints every 4
    steps, the chaos plan ``spec`` at seed 0."""
    from repro_torch.configs import CheckpointConfig, FaultConfig
    from repro_torch.launch.profile_train import train_config
    cfg = train_config(steps=steps)
    return dataclasses.replace(
        cfg, chunk_size=4,
        model=dataclasses.replace(cfg.model, num_layers=layers),
        optimizer=dataclasses.replace(cfg.optimizer,
                                      learning_rate=FAULT_LR),
        checkpoint=CheckpointConfig(directory=directory, every_steps=4),
        faults=FaultConfig(spec=spec, seed=0))


@contextlib.contextmanager
def _timed_checkpoints(ckpts):
    """Records (kind, seconds, bytes) of every checkpoint save and
    restore under it."""
    from unittest import mock
    from repro_torch.train import checkpoint as ckpt_lib
    save, restore = ckpt_lib.save, ckpt_lib.restore

    def size(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        path = save(*args, **kw)
        ckpts.append(("save", time.perf_counter() - t0, size(path)))
        return path

    def timed_restore(directory, template, step=None, **kw):
        t0 = time.perf_counter()
        out = restore(directory, template, step, **kw)
        ckpts.append(("restore", time.perf_counter() - t0,
                      size(ckpt_lib.step_dir(directory, out[1]["step"]))))
        return out

    with mock.patch.object(ckpt_lib, "save", timed_save), \
            mock.patch.object(ckpt_lib, "restore", timed_restore):
        yield


def _host_state(res):
    return {k: v.detach().cpu() for k, v in
            {**res.params, **{f"ema.{n}": t for n, t in res.ema.items()}
             }.items()}


def _faults_phase(torch, backup_reduce):
    """Phase 21: the chaos plan ``FAULT_SPEC`` on the spmd engine at full
    width: an unfaulted run, the plan without the preemption (peak memory
    before and after the rescale), the plan under ``run_supervised``
    (backup_reduce counted, held to its plain twin on the first stack
    after the rescale), then ``dynamic_backup`` in sim and measured mode.
    Returns the supervised run's backup_reduce launches."""
    import gc
    from unittest import mock
    from repro_torch.core import faults
    from repro_torch.core.events import StragglerSimulator
    from repro_torch.core import registry
    from repro_torch.core.straggler import (DeterministicStragglers,
                                            PaperCalibrated)
    from repro_torch.distributed import spmd_engine
    from repro_torch.kernels.backup_reduce import backup_reduce_plain
    from repro_torch.configs import AggregationConfig
    from repro_torch.train.loop import Trainer
    from repro_torch.train.supervisor import run_supervised

    def trainer(cfg, **kw):
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda", **kw)
        tr.init_state()
        return tr

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    ckpts = []
    with tempfile.TemporaryDirectory() as d, _timed_checkpoints(ckpts):
        clean = trainer(_fault_cfg(f"{d}/clean", "", steps=2)).run(2)
        clean = [m["loss"] for m in clean.metrics]
        free()
        # the plan without the preemption, paused at the rescale's step:
        # the peak before it, then after it (the rebuild's capture on);
        # no checkpoints on a cadence (the rescale writes its own), as
        # they leave the state alone and each takes seconds at this width
        cfg = _fault_cfg(f"{d}/straight", FAULT_SPEC.replace(",preempt@9",
                                                             ""))
        cfg = dataclasses.replace(cfg, checkpoint=dataclasses.replace(
            cfg.checkpoint, every_steps=0))
        tr = trainer(cfg, injector=faults.build_injector(
            cfg.faults, num_steps=cfg.total_steps,
            num_workers=cfg.aggregation.total_workers))
        n_params = sum(p.numel() for p in tr.params.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.run(6)
        torch.cuda.synchronize()
        mem = dict(peak_before=torch.cuda.max_memory_allocated(),
                   alloc_before=torch.cuda.memory_allocated())
        rescale = tr.rescale

        def measured_rescale(n):
            rescale(n)
            torch.cuda.synchronize()
            mem["alloc_after_rescale"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()

        tr.rescale = measured_rescale
        straight = tr.run(FAULT_STEPS - 6)
        torch.cuda.synchronize()
        mem["peak_after"] = torch.cuda.max_memory_allocated()
        w_new = tr.cfg.aggregation.total_workers
        straight_state = _host_state(straight)
        straight_metrics = list(straight.metrics)
        del tr, straight
        free()
        # the whole plan under the supervisor, backup_reduce counted
        reduce, held = spmd_engine.reduce_then_psum, {}

        def hold(grads, mask, n, **kw):
            if grads.shape[0] == w_new and not held:
                before = backup_reduce.launches
                mf = mask.float()
                k = backup_reduce.backup_reduce(grads, mf, n)
                p = backup_reduce_plain(grads, mf, n)
                held.update(shape=tuple(grads.shape), equal=torch.equal(k, p),
                            err=(k - p).abs().max().item())
                backup_reduce.launches = before     # a comparison launch
                del k, p
            return reduce(grads, mask, n, **kw)

        cfg = _fault_cfg(f"{d}/supervised", FAULT_SPEC)
        backup_reduce.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(spmd_engine, "reduce_then_psum", hold):
            sup = run_supervised(cfg, latency=PaperCalibrated(),
                                 device="cuda")
        torch.cuda.synchronize()
        sup_s = time.perf_counter() - t0
        launches = backup_reduce.launches
        sup_state = _host_state(sup)
        log = sup.recovery_log
        del sup
        free()
    saves = [(s, b) for k, s, b in ckpts if k == "save"]
    restores = [(s, b) for k, s, b in ckpts if k == "restore"]
    _log(f"[faults] checkpoints of the full-width state: "
         f"{saves[0][1]} bytes; {len(saves)} saves "
         f"({' '.join(f'{s:.2f}' for s, _ in saves)} s), {len(restores)} "
         f"restores ({' '.join(f'{s:.2f}' for s, _ in restores)} s)")
    if log != FAULT_LOG:
        raise AssertionError(f"[faults] recovery log {log} != {FAULT_LOG}")
    got = [m["loss"] for m in straight_metrics[:2]]
    if got != clean:
        raise AssertionError(f"[faults] steps 1-2 {got} differ from the "
                             f"unfaulted run's {clean}")
    differ = [k for k, v in sup_state.items()
              if not torch.equal(v, straight_state[k])]
    if differ:
        raise AssertionError(f"[faults] the supervised run's final state "
                             f"differs from the run without the preemption "
                             f"in {len(differ)} tensors, e.g. {differ[0]}")
    if not (held.get("equal") and held["shape"] == (w_new, n_params)):
        raise AssertionError(f"[faults] backup_reduce after the rescale vs "
                             f"its plain twin: {held}")
    if launches != FAULT_STEPS:
        raise AssertionError(f"[faults] backup_reduce launches {launches}, "
                             f"expected {FAULT_STEPS} (one a step)")
    freed = (8 - w_new) * n_params * 4
    predicted = mem["peak_before"] - freed
    gap = mem["peak_after"] - predicted
    _log(f"[faults] qwen3-0.6b full width cut to {FAULT_LAYERS} layers "
         f"({n_params} params), spmd, backup 6 + 2, chunks of 4, "
         f"checkpoints every 4, {FAULT_SPEC!r} seed 0 under run_supervised "
         f"({sup_s:.1f} s): recovery log == the CPU port's literal "
         f"({len(log)} events: "
         f"{', '.join(e['event'] + '@' + str(e['step']) for e in log)}); "
         f"steps 1-2 bit-equal to the unfaulted run ({clean}); final "
         f"parameters and EMA ({len(sup_state)} tensors) bit-equal to the "
         f"run without the preemption; backup_reduce {launches} launches "
         f"(one a step), on the first stack after the rescale "
         f"{list(held['shape'])} bit-equal to its plain twin")
    _log(f"[faults] memory around the rescale 8 -> {w_new} workers: peak "
         f"{mem['peak_before']} bytes before, {mem['peak_after']} after "
         f"(the stack's freed rows: {freed} bytes; predicted {predicted}, "
         f"gap {gap}, limit 1 GiB); allocated {mem['alloc_before']} before, "
         f"{mem['alloc_after_rescale']} right after the rebuild")
    if abs(gap) > 2 ** 30:
        raise AssertionError(f"[faults] peak memory after the rescale "
                             f"{mem['peak_after']} is {gap} bytes from the "
                             f"pre-rescale peak scaled to the new W")
    # dynamic_backup: N = 8, b = 0, workers 6 and 7 slowed 5x
    lat = DeterministicStragglers(slow_workers=(6, 7), slowdown=5.0)
    ns = {}
    for source in ("sim", "measured"):
        cfg = _fault_cfg("", "", steps=DYNAMIC_STEPS)
        cfg = dataclasses.replace(
            cfg, checkpoint=dataclasses.replace(cfg.checkpoint,
                                                every_steps=0),
            aggregation=AggregationConfig(
                strategy="dynamic_backup", num_workers=8, backup_workers=0,
                latency_source=source))
        tr = Trainer(cfg, latency=lat, device="cuda")
        tr.init_state()
        res = tr.run(DYNAMIC_STEPS)
        ns[source] = (tr.strategy.n, [m["selected"] for m in res.metrics],
                      res.metrics[-1]["loss"])
        del tr, res
        free()
        if source == "sim":
            sim = StragglerSimulator(registry.get_strategy(cfg.aggregation),
                                     lat, cfg.seed)
            sim.next_events(DYNAMIC_STEPS)
            cpu_n = sim.strategy.n
    n, selected, loss = ns["sim"]
    _log(f"[faults] dynamic_backup, qwen3-0.6b full width ({FAULT_LAYERS} "
         f"layers), N = "
         f"8, b = 0, workers 6 and 7 slowed 5x, {DYNAMIC_STEPS} steps: "
         f"adapted n {n} (the CPU port's host logic: "
         f"{cpu_n}); selected per step {selected}; last loss {loss:.6f}")
    _log(f"[faults] dynamic_backup latency_source='measured' (a record: on "
         f"a lockstep card every live worker measures the same time): n "
         f"{ns['measured'][0]}; selected per step {ns['measured'][1]}")
    if not (n == cpu_n < 8 and math.isfinite(loss)):
        raise AssertionError(f"[faults] dynamic_backup n {n}, the CPU "
                             f"port's {cpu_n} (must be equal and below 8)")
    return launches


def _eps_record(torch):
    """Phase 17's record of ROADMAP Queue 3's closed control: qwen3-0.6b
    (cut to ``EPS_RECORD_LAYERS`` layers for the call's time)
    grad_batch 0 against 1 at RMSProp eps 1e-3 (the parity setting), one
    chunk of 3 steps through the graph each; the loss rel gaps per step
    are printed beside phase 17's at eps 1e-8 and gate nothing."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import Trainer
    losses = {}
    for gb in (1, 0):
        cfg = train_config(grad_batch=gb)
        cfg = dataclasses.replace(
            cfg, chunk_size=cfg.total_steps, optimizer=dataclasses.replace(
                cfg.optimizer, eps=1e-3),
            model=dataclasses.replace(cfg.model,
                                      num_layers=EPS_RECORD_LAYERS))
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
        tr.init_state()
        losses[gb] = [m["loss"] for m in tr.run(cfg.total_steps).metrics]
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(a) for a, b in zip(losses[1], losses[0])]
    held = max(gaps[1:]) <= 1e-3
    _log(f"[batched qwen3-0.6b grad_batch 0, eps 1e-3, {EPS_RECORD_LAYERS} "
         f"of 28 layers] vs grad_batch 1 at eps 1e-3: loss rel gap per step "
         f"{' '.join(f'{g:.3g}' for g in gaps)} (a record, not a gate): "
         f"steps 2-3 {'stay' if held else 'do not stay'} within rel 1e-3")


# ---------------------------------------------------------------------------
# Phase 18's last part: the rescale that shrinks the 'data' axis
# ---------------------------------------------------------------------------


def _shrink_cfg(cards: int, directory: str):
    """The shrink run's config and kill plan. One card: qwen3-0.6b at 2
    layers f32 (``_small_cfg``), full sync over 4 workers, global batch 12,
    ``mesh_data`` 2 over gloo, chunk 1, one worker killed at step 2 (the
    count becomes 3, ``mesh_data`` 2 -> 1). Four cards: the full-width
    phase-6 cell (backup 6 + 2, grad_batch 0, ``mesh_data`` 4 over NCCL,
    chunks of 2 through the graph), 5 workers killed at step 2 (3 alive,
    rounded to 2 for the 16 sequences, ``mesh_data`` 4 -> 2)."""
    from repro_torch.configs import AggregationConfig, CheckpointConfig
    from repro_torch.launch.profile_train import train_config
    ck = CheckpointConfig(directory=directory, every_steps=0)
    if cards >= 4:
        cfg = dataclasses.replace(
            train_config("qwen3-0.6b", grad_batch=0, mesh_data=4,
                         steps=SHRINK_STEPS), chunk_size=2, checkpoint=ck)
        return cfg, {2: [1, 2, 3, 4, 5]}
    cfg = _small_cfg("qwen3-0.6b", 0, mesh_data=2, chunk=1)
    return dataclasses.replace(
        cfg, aggregation=AggregationConfig(strategy="full_sync",
                                           num_workers=4),
        shape=dataclasses.replace(cfg.shape, global_batch=12),
        total_steps=SHRINK_STEPS, checkpoint=ck), {2: [1]}


def _shrink_rank(rank, device, out_dir, cfg, kills):
    """One rank of the shrink run: ``cfg``'s steps with ``kills``, the
    backup_reduce counter set to 0 just before and read just after; its
    losses, parameter sums, whether it idles, the shrunk mesh and the
    rebuilt graph's numbers go to ``out_dir/shrink<r>.json``."""
    import torch
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.kernels import backup_reduce
    from repro_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(cfg, latency=PaperCalibrated(), device=device)
    tr.init_state()
    backup_reduce.launches = 0
    t0 = time.perf_counter()
    res = tr.run(cfg.total_steps, kill_worker_at=kills)
    torch.cuda.synchronize(device)
    ex, agg = tr.cfg.execution, tr.cfg.aggregation
    g = getattr(tr.chunk_step, "graph", None) if cfg.chunk_size > 1 \
        else None
    out = dict(losses=[m["loss"] for m in res.metrics],
               steps=[m["step"] for m in res.metrics],
               sums=_param_sums(torch, res.params).tolist(),
               idle=tr._idle, mesh_data=ex.mesh_data,
               workers=agg.total_workers,
               w_local=agg.total_workers // ex.mesh_data,
               restarts=res.restarts, launches=backup_reduce.launches,
               captures=g.captures if g else 0,
               replays=g.replays if g else 0,
               wall_s=time.perf_counter() - t0,
               peak=torch.cuda.max_memory_allocated(device))
    with open(os.path.join(out_dir, f"shrink{rank}.json"), "w") as f:
        json.dump(out, f)


def _shrink_phase(torch):
    """The rescale on the spmd engine over ranks that shrinks
    ``mesh_data``: the freed ranks idle (no step, every barrier), the live
    ranks bit-identical; with one card rank 0 is held to a one-card run of
    the same plan (atol 1e-5), with four the shrunk data group's
    all-reduce is captured in the rebuilt graph and ``backup_reduce``
    reduces each live rank's ``[1, P]``."""
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.distributed import mesh
    from repro_torch.train.loop import Trainer
    cards = torch.cuda.device_count()
    ranks = 4 if cards >= 4 else 2
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cfg, kills = _shrink_cfg(cards, os.path.join(d, "ck"))
        mesh.spawn(_shrink_rank, ranks, "cuda", args=(d, cfg, kills),
                   start_method="forkserver",
                   timeout_s=MESH_TIMEOUT_S)
        out = []
        for r in range(ranks):
            with open(os.path.join(d, f"shrink{r}.json")) as f:
                out.append(json.load(f))
        one = None
        if ranks == 2:                 # the same plan on one card alone
            one_cfg = dataclasses.replace(cfg, execution=dataclasses.replace(
                cfg.execution, mesh_data=1), checkpoint=dataclasses.replace(
                cfg.checkpoint, directory=os.path.join(d, "one")))
            tr = Trainer(one_cfg, latency=PaperCalibrated(), device="cuda")
            tr.init_state()
            one = [m["loss"] for m in tr.run(
                one_cfg.total_steps, kill_worker_at=dict(kills)).metrics]
            del tr
    md = cfg.execution.mesh_data
    want_md = md
    while out[0]["workers"] % want_md:    # the reference's rule
        want_md -= 1
    live = [o for o in out if not o["idle"]]
    tag = (f"[mesh shrink] {'nccl' if cards >= ranks else 'gloo'}, {ranks} "
           f"ranks")
    if [o["idle"] for o in out] != [r >= want_md for r in range(ranks)] \
            or {o["mesh_data"] for o in out} != {want_md} \
            or want_md == md or {o["restarts"] for o in out} != {1}:
        raise AssertionError(f"{tag}: idle {[o['idle'] for o in out]}, "
                             f"mesh_data {[o['mesh_data'] for o in out]} "
                             f"(expected {md} -> {want_md})")
    for r, o in enumerate(live[1:], 1):
        if o["sums"] != live[0]["sums"] or o["losses"] != live[0]["losses"]:
            raise AssertionError(f"{tag}: live rank {r}'s parameters or "
                                 f"losses differ from rank 0's")
    steps = cfg.total_steps
    kill_at = min(kills)
    for r, o in enumerate(out):
        want = kill_at if o["idle"] else steps
        if o["launches"] != want or (o["idle"] and max(
                o["steps"], default=0) > kill_at):
            raise AssertionError(f"{tag}: rank {r} launched backup_reduce "
                                 f"{o['launches']} times (expected {want}),"
                                 f" logged steps {o['steps']}")
    if not all(math.isfinite(v) for v in live[0]["losses"]):
        raise AssertionError(f"{tag}: non-finite loss")
    detail = ""
    if one is not None:
        worst = max(abs(a - b) for a, b in zip(live[0]["losses"], one))
        if len(one) != len(live[0]["losses"]) or not worst <= 1e-5:
            raise AssertionError(f"{tag}: rank 0's losses vs the one-card "
                                 f"run max abs {worst}")
        detail = f"; rank 0's losses vs one card max abs {worst:.3g} (atol " \
                 f"1e-5)"
    else:
        if {o["w_local"] for o in live} != {1} or {
                (o["captures"], o["replays"]) for o in live} != {
                (1, steps - kill_at - 1)}:
            raise AssertionError(
                f"{tag}: live ranks' stacks "
                f"{[o['w_local'] for o in live]} workers, rebuilt graph "
                f"captures / replays "
                f"{[(o['captures'], o['replays']) for o in live]}")
        detail = (f"; the rebuilt graph (its NCCL all-reduce over the "
                  f"shrunk data group inside): 1 capture, "
                  f"{live[0]['replays']} replays a live rank; backup_reduce "
                  f"on [1, P] a live rank after the shrink")
    _log(f"{tag}: {cfg.aggregation.total_workers} workers, kill "
         f"{kills[kill_at]} at step {kill_at} -> {out[0]['workers']} "
         f"workers, mesh_data {md} -> {want_md}; ranks "
         f"{[r for r, o in enumerate(out) if o['idle']]} idle (no step "
         f"after {kill_at}, every barrier); live ranks' {len(live[0]['sums'])}"
         f" parameter sums and losses bit-identical; losses "
         f"{' '.join(f'{v:.6f}' for v in live[0]['losses'])}; backup_reduce "
         f"launches per rank {[o['launches'] for o in out]}{detail} | rank "
         f"0 wall {out[0]['wall_s']:.1f} s (the rescale's checkpoint "
         f"included), peak {out[0]['peak']} bytes | "
         f"{time.perf_counter() - t0:.1f} s")
    return {f"shrink mesh {md}->{want_md}": dict(
        backup_reduce=live[0]["launches"], wkv6_fwd=0, wkv6_bwd=0,
        wkv6_fwd_states=0)}


# ---------------------------------------------------------------------------
# Phase 22: telemetry on the spmd step graph
# ---------------------------------------------------------------------------


def _telemetry_phase(torch, backup_reduce):
    """Phase 22: the phase-6 cell, ``TELEMETRY_STEPS`` steps in chunks of
    ``TELEMETRY_CHUNK`` through the step graph, untraced and then with a
    ``Tracer`` and a ``MetricsRegistry``: bit-equal runs, the reference's
    spans and registry, the files read back."""
    import gc
    from repro_torch import obs
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import Trainer
    cfg = train_config(steps=TELEMETRY_STEPS)
    cfg = dataclasses.replace(
        cfg, chunk_size=TELEMETRY_CHUNK, model=dataclasses.replace(
            cfg.model, num_layers=TELEMETRY_LAYERS))
    runs = {}
    # in turns, so the card's state between runs does not pass for the
    # tracer's cost
    for tag in ("untraced", "traced", "untraced again"):
        tracer, reg = ((obs.Tracer(), obs.MetricsRegistry())
                       if tag == "traced" else (None, None))
        torch.cuda.synchronize()
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda",
                     tracer=tracer, metrics=reg)
        tr.init_state()
        backup_reduce.launches = 0
        with _planned_masks() as masks:
            res = tr.run(cfg.total_steps)
        torch.cuda.synchronize()
        runs[tag] = dict(
            metrics=list(res.metrics), sums=_param_sums(torch, res.params),
            masks=masks, launches=backup_reduce.launches,
            # the second chunk is replays only
            replay_ms=1e3 * statistics.mean(
                res.step_times_s[TELEMETRY_CHUNK:]),
            phase=res.phase_times, tracer=tracer, reg=reg)
        del tr, res
        gc.collect()
        torch.cuda.empty_cache()
    plain, traced, again = (runs[t] for t in ("untraced", "traced",
                                              "untraced again"))
    for tag, run in (("traced", traced), ("untraced again", again)):
        if not _same_masks(plain["masks"], run["masks"]) or \
                run["metrics"] != plain["metrics"] or \
                not run["sums"].equal(plain["sums"]):
            raise AssertionError(f"[telemetry] the {tag} run's masks, "
                                 f"metrics or parameter checksums differ "
                                 f"from the untraced run's")
    if not all(math.isfinite(m["loss"]) for m in traced["metrics"]):
        raise AssertionError("[telemetry] non-finite loss")
    if {r["launches"] for r in runs.values()} != {TELEMETRY_STEPS}:
        raise AssertionError(f"[telemetry] backup_reduce launches "
                             f"{[r['launches'] for r in runs.values()]}")
    tracer, reg = traced["tracer"], traced["reg"]
    events = list(tracer.events)
    names = {e["name"] for e in events}
    if not names <= set(obs.SPAN_NAMES):
        raise AssertionError(f"[telemetry] span names outside SPAN_NAMES: "
                             f"{sorted(names - set(obs.SPAN_NAMES))}")
    roots = [r for r in obs.span_tree(events) if r["name"] == "train/chunk"]
    kids = [[c["name"] for c in r["children"]] for r in roots]
    want = ["train/data_wait", "spmd/dispatch", "spmd/collective_wait",
            "train/device_wait"]
    if len(roots) != TELEMETRY_STEPS // TELEMETRY_CHUNK or \
            any(k != want for k in kids):
        raise AssertionError(f"[telemetry] chunk roots {kids}, expected "
                             f"{TELEMETRY_STEPS // TELEMETRY_CHUNK} of "
                             f"{want}")
    if reg.counter("train/steps").value != TELEMETRY_STEPS or \
            reg.histogram("train/chunk_time_s").count != len(roots):
        raise AssertionError("[telemetry] registry train/steps "
                             f"{reg.counter('train/steps').value}, "
                             f"chunk_time_s count "
                             f"{reg.histogram('train/chunk_time_s').count}")
    with tempfile.TemporaryDirectory() as d:
        tpath, mpath = os.path.join(d, "t.json"), os.path.join(d, "m.jsonl")
        tracer.export(tpath)
        reg.dump_jsonl(mpath)
        rows = obs.load_jsonl(mpath)
        back = obs.load_trace(tpath)["traceEvents"]
        if [r["name"] for r in rows] != [n for n, _ in reg] or \
                len(back) != len(events):
            raise AssertionError("[telemetry] the files do not read back")

    def dur_ms(name):
        return [e["dur"] / 1e3 for e in events if e["name"] == name]

    fence = dur_ms("spmd/collective_wait") + dur_ms("train/device_wait")
    _log(f"[telemetry] qwen3-0.6b full width at {TELEMETRY_LAYERS} of 28 "
         f"layers, backup 6+2 spmd, "
         f"{TELEMETRY_STEPS} steps in chunks of {TELEMETRY_CHUNK} through "
         f"the graph: traced run == untraced run ({TELEMETRY_STEPS} losses,"
         f" masks and {traced['sums'].numel()} parameter checksums "
         f"bit-equal); {len(events)} spans, names within SPAN_NAMES; "
         f"{len(roots)} train/chunk roots of {' + '.join(want)}; registry "
         f"train/steps {reg.counter('train/steps').value:.0f}, chunk_time_s "
         f"count {reg.histogram('train/chunk_time_s').count}; JSONL "
         f"({len(rows)} series) and Chrome trace read back")
    _log(f"[telemetry] host wall a step, the replays-only chunk, in turns: "
         f"untraced {plain['replay_ms']:.3f} ms, traced "
         f"{traced['replay_ms']:.3f} ms, untraced {again['replay_ms']:.3f} "
         f"ms"
         f" | the fences (spmd/collective_wait + train/device_wait) per "
         f"chunk: {' '.join(f'{v:.3f}' for v in fence)} ms | chunk spans "
         f"{' '.join(f'{v:.1f}' for v in dur_ms('train/chunk'))} ms | "
         f"phase_times "
         f"{ {k: round(v, 4) for k, v in traced['phase'].items()} }")
    return dict(launches=sum(r["launches"] for r in runs.values()))


# ---------------------------------------------------------------------------
# Phase 23: the restore bridge (train -> checkpoint -> serve)
# ---------------------------------------------------------------------------


def _serve_cfg():
    """Phase 4's serving geometry: 8 slots, pages of 16, prompts to 512,
    up to 128 new tokens."""
    return dict(num_slots=8, page_size=16, max_prompt_len=512,
                max_new_cap=128)


def _serve_trace(cfg, n, seed, rate=1000.0, new=(32, 128)):
    from repro_torch.serve import TraceConfig, make_trace
    return make_trace(TraceConfig(
        num_requests=n, rate=rate, prompt_len_min=64, prompt_len_max=512,
        max_new_min=new[0], max_new_max=new[1], vocab=cfg.vocab_size,
        seed=seed))


def _restore_phase(torch):
    """Phase 23: one step of the phase-6 cell, its checkpoint, then
    ``restore_params`` (params, then EMA): bit-equal tensors, and the
    restored model serves the trainer's in-memory model's greedy tokens."""
    import gc
    from repro_torch.configs import CheckpointConfig
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.launch.profile_train import train_config
    from repro_torch.serve import ServeEngine, restore_params
    from repro_torch.train.loop import Trainer
    with tempfile.TemporaryDirectory() as d:
        cfg = train_config(steps=1)
        cfg = dataclasses.replace(
            cfg, checkpoint=CheckpointConfig(directory=d),
            model=dataclasses.replace(cfg.model, num_layers=RESTORE_LAYERS))
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
        tr.init_state()
        tr.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = tr.save_checkpoint()
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        restored, secs = {}, {}
        for use_ema in (False, True):
            t0 = time.perf_counter()
            model, manifest = restore_params(d, cfg.model, use_ema=use_ema)
            torch.cuda.synchronize()
            secs[use_ema] = time.perf_counter() - t0
            src = tr.ema if use_ema else tr.params
            for k, v in model.named_parameters():
                if not torch.equal(v, src[k].to(v.dtype)):
                    raise AssertionError(
                        f"[restore] {'ema' if use_ema else 'params'} {k}: "
                        f"restored tensor differs from the trainer's")
            if manifest["step"] != 1:
                raise AssertionError(f"[restore] step {manifest['step']}")
            restored[use_ema] = model
        del restored[True]
    # the checkpoint directory is gone: serve the restored and the
    # trainer's in-memory weights on the same trace (the step, its [W, P]
    # stack and the optimizer state dropped first)
    tr.train_step = tr.opt_state = None
    gc.collect()
    torch.cuda.empty_cache()
    trace = _serve_trace(cfg.model, 16, seed=0)
    toks = {}
    for tag, model in (("restored", restored[False]), ("trained", tr.model)):
        eng = ServeEngine(cfg.model, model, clock="wall", **_serve_cfg())
        rep = eng.run(trace)
        if rep.metrics["completed"] != len(trace):
            raise AssertionError(f"[restore] {tag}: {rep.metrics['completed']}"
                                 f" of {len(trace)} completed")
        toks[tag] = rep.tokens_by_rid()
    if toks["restored"] != toks["trained"]:
        raise AssertionError("[restore] the restored weights serve other "
                             "greedy tokens than the trainer's")
    _log(f"[restore] qwen3-0.6b full width at {RESTORE_LAYERS} of 28 "
         f"layers, 1 step of the phase-6 cell: "
         f"checkpoint {nbytes} bytes saved in {save_s:.2f} s; "
         f"restore_params {secs[False]:.2f} s (params), {secs[True]:.2f} s "
         f"(ema); every restored tensor bit-equal to the trainer's (EMA "
         f"cast to bf16, as the reference); {len(trace)} requests served, "
         f"{sum(len(t) for t in toks['trained'].values())} greedy tokens "
         f"equal to the trainer's in-memory weights'; checkpoint deleted")
    del tr, restored
    gc.collect()
    torch.cuda.empty_cache()
    return dict(save_s=save_s, restore_s=secs[False], bytes=nbytes)


# ---------------------------------------------------------------------------
# Phase 24: the replica router over StepSessions
# ---------------------------------------------------------------------------


def _router_phase(torch, kernels):
    """Phase 24: ``ROUTER_REPLICAS`` StepSessions over one fp engine at full
    width, ``ROUTER_REQUESTS`` requests, hedging on, the chaos plan
    ``ROUTER_FAULTS``; a replay of the same seed; then an SLO shed run.
    Gates: nothing lost, every completed request's tokens equal the single
    engine's, the replay bit-identical, the kernels counted, one decode
    graph capture a session."""
    from unittest import mock
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve import (ReplicaRouter, RouterConfig, ServeEngine,
                                   SLOConfig, StepSession)
    from repro_torch.serve import router as router_lib
    page_gather, flash_attention = kernels
    cfg = dataclasses.replace(configs.get_config("qwen3-0.6b"),
                              num_layers=ROUTER_LAYERS)
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    engine = ServeEngine(cfg, model, clock="virtual", **_serve_cfg())
    trace = _serve_trace(cfg, ROUTER_REQUESTS, seed=4, rate=ROUTER_RATE)
    single = engine.run(trace)
    want = single.tokens_by_rid()
    sessions = []

    class Session(StepSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sessions.append(self)

    rcfg = RouterConfig(num_replicas=ROUTER_REPLICAS,
                        hedge_after=ROUTER_HEDGE_AFTER, faults=ROUTER_FAULTS)

    def route(slo=None):
        sessions.clear()
        for c in (page_gather, flash_attention):
            c.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(router_lib, "StepSession", Session):
            rep = ReplicaRouter(engine, rcfg, slo=slo).run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return rep, wall, (page_gather.launches, flash_attention.launches), \
            [s.decode_captures for s in sessions]

    def plain(rep):
        return dict(completed=[dataclasses.asdict(c) for c in rep.completed],
                    rejected=rep.rejected, metrics=rep.metrics,
                    events=rep.events, health=rep.health)

    runs = [route() for _ in range(2)]
    (rep, wall, (n_gather, n_flash), caps), (rep2, *_rest) = runs
    m = rep.metrics
    if m["lost_requests"] != 0 or m["completed"] + m["rejected"] != \
            len(trace):
        raise AssertionError(f"[router] lost {m['lost_requests']}")
    got = rep.tokens_by_rid()
    bad = [rid for rid, t in got.items() if t != want[rid]]
    if bad or not got:
        raise AssertionError(f"[router] rids {bad} served other tokens than "
                             f"the single engine")
    if plain(rep2) != plain(rep):
        raise AssertionError("[router] a second run of the same seed gave "
                             "another report")
    if n_gather == 0 or n_flash == 0 or caps != [1] * ROUTER_REPLICAS:
        raise AssertionError(f"[router] launches page_gather {n_gather} "
                             f"flash_attention {n_flash}, decode captures "
                             f"{caps}")
    if not (m["hedges"] and m["crashes"] and m["restarts"]):
        raise AssertionError(f"[router] the plan did not fire: {m}")
    tokens = sum(len(t) for t in got.values())
    _log(f"[router] qwen3-0.6b full width at {ROUTER_LAYERS} of 28 layers, "
         f"fp, {ROUTER_REPLICAS} StepSessions"
         f" x {engine.pool_cfg.num_slots} slots, {len(trace)} requests, "
         f"hedge floor {ROUTER_HEDGE_AFTER}, faults {ROUTER_FAULTS}: "
         f"{m['completed']} completed, {m['rejected']} rejected, "
         f"{m['lost_requests']} lost | hedges {m['hedges']} (won "
         f"{m['hedge_wins']}), drained {m['drained']}, crashes "
         f"{m['crashes']}, restarts {m['restarts']} | virtual p50 "
         f"{m['p50_latency']:.2f} p99 {m['p99_latency']:.2f} units | "
         f"{tokens} tokens in {wall:.3f} s wall -> {tokens / wall:.1f} "
         f"tokens/s | every completed request's tokens == the single "
         f"engine's; the replay's report bit-identical | launches "
         f"page_gather {n_gather}, flash_attention {n_flash}; decode "
         f"graph captures per session {caps}")
    slo = SLOConfig(target_p99=0.5 * m["p50_latency"], mode="shed",
                    window=16, min_samples=4)
    srep, swall, _, scaps = route(slo)
    sm = srep.metrics
    bad = [c.rid for c in srep.completed if c.tokens != want[c.rid]]
    if sm["lost_requests"] != 0 or not sm["shed"] or bad or \
            scaps != [1] * ROUTER_REPLICAS:
        raise AssertionError(f"[router slo] lost {sm['lost_requests']}, "
                             f"shed {sm['shed']}, other tokens {bad}")
    _log(f"[router slo] shed at windowed p99 > {slo.target_p99:.2f} units: "
         f"{sm['completed']} completed, {sm['shed']} shed, "
         f"{sm['lost_requests']} lost, trips {sm['slo_trips']} | virtual "
         f"p99 {sm['p99_latency']:.2f} units (unshed {m['p99_latency']:.2f})"
         f" | {swall:.3f} s wall")
    del engine, model, sessions
    torch.cuda.empty_cache()
    return dict(gather=n_gather, flash=n_flash, tokens_per_s=tokens / wall,
                p99=m["p99_latency"])


def _slice_phases(torch, backup_reduce, page_gather, flash_attention):
    """Phases 22-24, each timed; returns phase 24's numbers and phase 22's
    backup_reduce launches."""
    t0 = time.perf_counter()
    telemetry = _telemetry_phase(torch, backup_reduce)
    _log(f"[time] phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _restore_phase(torch)
    _log(f"[time] phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        router = _router_phase(torch, (page_gather, flash_attention))
    _log(f"[time] phase 24: {time.perf_counter() - t0:.1f} s")
    return dict(router, telemetry=telemetry["launches"])


# ---------------------------------------------------------------------------
# Phase 25: the dense configs on the paged path, flash attention at D = 256
# ---------------------------------------------------------------------------


def _ptxas_usage(report: str, key: str):
    """(registers, spill store bytes, spill load bytes) of the kernel whose
    mangled name holds ``key``, from ``nvcc -Xptxas -v``'s report."""
    import re
    lines = report.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and key in ln:
            regs = spills = None
            for nxt in lines[i + 1:]:
                if "Compiling entry function" in nxt:
                    break
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", nxt)
                if m and spills is None:
                    spills = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", nxt)
                if m and regs is None:
                    regs = int(m.group(1))
            if regs is not None and spills is not None:
                return regs, spills[0], spills[1]
    raise AssertionError(f"ptxas report has no kernel {key}")


def _flash_bound(torch, s, f, window):
    """(bound ms, "bytes" / "operations", flop, bytes) of one bf16 call at
    B 1 over this run's band: causal pairs within the window."""
    pos = torch.arange(s)
    diff = pos[:, None] - pos[None, :]
    pairs = int(((diff >= 0) & ((diff < window) if window else True)).sum())
    flops = 4 * pairs * f["d"] * f["h"]
    nbytes = 2 * s * f["d"] * (2 * f["h"] + 2 * f["kv"])   # q, o, k, v
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _flash256_phase(torch, flash_attention, ptxas_report, build_s):
    """Flash attention at head_dim 256 (gemma3-1b: 4 heads, 1 kv head):
    the f32 and the bf16 kernel against the plain twin (causal, window
    512, softcap 2, ragged S), then device times at gemma3-1b's prefill
    buckets (B 1, bf16; S 512 the row's shape, against the plain twin,
    SDPA and the bound; the others against SDPA), each with the bf16
    kernel's split; the registers and spills ptxas gave each D = 256
    kernel and the bf16 D = 128 one."""
    import torch.nn.functional as F
    f = FLASH256_HEADS
    gen = torch.Generator(device="cuda").manual_seed(25)

    def inputs(s, dt, copies=1):
        return [tuple(torch.randn((1, s, n, f["d"]), generator=gen,
                                  device="cuda").to(dt)
                      for n in (f["h"], f["kv"], f["kv"]))
                for _ in range(copies)]

    errs = {}
    for s in (77, 512, 1000):
        for dt in (torch.bfloat16, torch.float32):
            for window, cap in ((0, 0.0), (512, 0.0), (512, 2.0)):
                q, k, v = inputs(s, dt)[0]
                got = flash_attention.flash_attention(q, k, v, window=window,
                                                      softcap=cap)
                want = flash_attention.flash_attention(
                    q, k, v, window=window, softcap=cap, use_kernel=False)
                torch.cuda.synchronize()
                tol = dict(atol=4e-3, rtol=8e-3) if dt == torch.bfloat16 \
                    else dict(atol=1e-4, rtol=0.0)
                torch.testing.assert_close(got.float(), want.float(), **tol)
                errs[(s, dt, window, cap)] = \
                    (got.float() - want.float()).abs().max().item()
    _log(f"[kernels] flash_attention D=256 H={f['h']} KV={f['kv']}: "
         f"{len(errs)} cases (S 77 / 512 / 1000, bf16 and f32, causal, "
         f"window 0 / 512, softcap 0 / 2) match the plain twin (bf16 atol "
         f"4e-3 rtol 8e-3, f32 atol 1e-4); max abs err bf16 "
         f"{max(e for k, e in errs.items() if k[1] == torch.bfloat16):.3g}, "
         f"f32 {max(e for k, e in errs.items() if k[1] == torch.float32):.3g}")
    lib = flash_attention._load()
    capacity = flash_attention._capacity(lib, torch.device("cuda"))
    by_s = {}
    for s in FLASH256_TIMED_S:
        ins = inputs(s, torch.bfloat16, 16)
        ms = _time_ms(torch, [
            (lambda a=a: flash_attention.flash_attention(*a, window=512))
            for a in ins])
        library_ms = _time_ms(torch, [
            (lambda a=a: F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in a), is_causal=True,
                enable_gqa=True)) for a in ins])
        plan = flash_attention.split_plan(s, f["h"], 1, True, 512, capacity)
        bound_ms, bound_by, flops, nbytes = _flash_bound(torch, s, f, 512)
        by_s[s] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, blocks=plan.blocks,
                       clusters=plan.clusters, tiles=plan.tiles)
        if s == 512:
            plain_ms = _time_ms(torch, [
                (lambda a=a: flash_attention.flash_attention(
                    *a, window=512, use_kernel=False)) for a in ins])
            # the plan against the other cluster sizes, forced through
            # capacities that stop the cluster's growth at C
            splits = {}
            for c in (1, 2, 4, 8):
                cap = tuple(10 ** 6 if 2 ** i <= c else 0 for i in range(4))
                alt = flash_attention.split_plan(s, f["h"], 1, True, 512, cap)
                splits[f"C{alt.clusters} T{alt.tiles}"] = _time_ms(torch, [
                    (lambda a=a, cap=cap: flash_attention._flash_cuda(
                        *a, True, 512, 0.0, capacity=cap)) for a in ins])
        _log(f"[kernels] flash_attention B=1 S={s} H={f['h']} KV={f['kv']} "
             f"D={f['d']} bf16 causal window 512: kernel {ms:.6f} ms, "
             f"library (sdpa) {library_ms:.6f} ms ({ms / library_ms:.2f}x), "
             f"bound {bound_ms:.6f} ms ({bound_by}: {flops} flop, {nbytes} "
             f"bytes) | plan: {plan.blocks} blocks, clusters of "
             f"{plan.clusters}, <= {plan.tiles} key tiles a block")
    _log(f"[kernels] flash_attention D=256 S=512 split (cluster capacity "
         f"of clusters of 1 / 2 / 4 / 8 blocks: {capacity}): "
         + ", ".join(f"{k} {v:.6f} ms" for k, v in splits.items()))
    usage = {name: _ptxas_usage(ptxas_report, key) for name, key in (
        ("bf16", "flash_d256_wgmma_kernel"),
        ("f32", "flash_fwd_kernelIfLi256E"),
        ("bf16_d128", "flash_fwd_bf16_kernelILi128E"))}
    row = dict(
        name="flash_attention_d256", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        max_abs_err=errs[(512, torch.bfloat16, 512, 0.0)],
        ms=by_s[512]["ms"], plain_ms=plain_ms,
        bound_ms=by_s[512]["bound_ms"], bound_by=by_s[512]["bound_by"],
        library_ms=by_s[512]["library_ms"], by_s=by_s, splits=splits,
        capacity=capacity,
        ptxas={k: dict(registers=r, spill_stores=st, spill_loads=ld)
               for k, (r, st, ld) in usage.items()})
    _log(f"[kernels] flash_attention B=1 S=512 H={f['h']} KV={f['kv']} "
         f"D={f['d']} bf16 causal window 512 (gemma3-1b's prefill): kernel "
         f"{row['ms']:.6f} ms, plain {plain_ms:.6f} ms, library (sdpa) "
         f"{row['library_ms']:.6f} ms, bound {row['bound_ms']:.6f} ms | "
         f"flash_attention.cu built in {build_s:.1f} s | ptxas "
         + ", ".join(f"{k}: {r} registers, {st} / {ld} bytes spill stores / "
                     f"loads" for k, (r, st, ld) in usage.items())
         + f" (bf16_d128 before the D = 256 kernel: {FLASH128_PTXAS})")
    if usage["bf16_d128"] != FLASH128_PTXAS:
        raise AssertionError(f"the bf16 D = 128 kernel's ptxas usage moved: "
                             f"{usage['bf16_d128']} against "
                             f"{FLASH128_PTXAS}")
    return row


def _dense_phase(torch, kernels):
    """Phase 25's configs on the paged path: gemma3-1b at full width on
    phase 4's 16 requests (fp and int8 pools, eager and graph decode:
    flash at D = 256 in every prefill, page gather at hd 256 / kv 1), at 2
    layers f32 kernel == plain past its window of 512; minitron-4b at full
    width and command-r-plus at ``COMMAND_R_LAYERS`` of 64 layers (width
    unchanged) on ``DENSE_FEW`` requests each, graph decode. Returns the
    launch counts per run."""
    import gc
    from repro_torch import configs
    from repro_torch.serve import TraceConfig, make_trace
    counts = {}
    cfg = configs.get_config("gemma3-1b")
    model = _full_width_model(torch, cfg)
    runs = _serve_runs(torch, cfg, model, kernels, "dense gemma3-1b",
                       _serve_trace(cfg, 16, seed=0),
                       short=_serve_trace(cfg, SHORT_REQUESTS, seed=0,
                                          new=SHORT_NEW))
    counts["gemma3-1b"] = {t: (r["gather"], r["flash"])
                           for t, r in runs.items()}
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    _hold_kernel_to_plain(torch, small, "gemma3-1b", make_trace(TraceConfig(
        num_requests=4, rate=1000.0, prompt_len_min=448, prompt_len_max=512,
        max_new_min=64, max_new_max=128, vocab=cfg.vocab_size, seed=2)),
        **_serve_cfg())
    for arch, layers in (("minitron-4b", None),
                         ("command-r-plus-104b", COMMAND_R_LAYERS)):
        cfg = configs.get_config(arch)
        label = arch
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            label = f"{arch} ({layers} of 64 layers)"
        model = _full_width_model(torch, cfg, label=label)
        runs = _serve_runs(torch, cfg, model, kernels, f"dense {arch}",
                           _serve_trace(cfg, DENSE_FEW, seed=0),
                           pools=("fp",))
        counts[arch] = {t: (r["gather"], r["flash"]) for t, r in runs.items()}
        del model, runs
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 26: the toy path (contiguous caches, RWKV's carried state)
# ---------------------------------------------------------------------------


def _rel_l2_logits(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _toy_phase(torch, rwkv6_scan):
    """Phase 26: ``greedy_generate`` over the contiguous caches at full
    width (gemma3-1b, qwen3-0.6b), fp and int8; the stepped decode's last
    logits over the prompt against ``prefill``'s (rel L2
    ``TOY_LOGITS_REL``, bf16); rwkv6-1.6b's ``prefill`` (the wkv6 kernel,
    counted) against stepping ``decode_step`` over the same prompt (its
    carried state), at full width against the plain twin's own gap and at
    2 layers f32 within ``TOY_F32_REL``; gemma3-1b at 2 layers f32 past its
    window of 512 (``TOY_WINDOW_RUN``: the local layers' ring buffers
    wrap): the stepped decode's last logits against ``prefill``'s within
    ``TOY_F32_REL``, and ``greedy_generate`` with the fp and int8 caches;
    at 2 layers f32 the card's greedy tokens equal the CPU port's. Returns
    the wkv6 forward launches of the full-width rwkv6 prefill."""
    import gc
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.train.serve_step import greedy_generate
    gen = torch.Generator(device="cuda").manual_seed(26)
    out = {}
    for arch, (plen, new) in TOY_RUNS.items():
        cfg = configs.get_config(arch)
        t0 = time.perf_counter()
        model = _full_width_model(torch, cfg, label=f"toy {arch}")
        prompt = torch.randint(0, cfg.vocab_size, (TOY_BATCH, plen),
                               generator=gen, device="cuda")
        with torch.inference_mode():
            # the stepped decode's last logits against prefill's
            cache = model.init_cache(1, plen)
            for i in range(plen):
                logits, cache = model.decode_step(prompt[:1, i:i + 1], cache)
            gap = _rel_l2_logits(torch, logits, model.prefill(prompt[:1]))
            if not gap <= TOY_LOGITS_REL:
                raise AssertionError(f"[toy {arch}] stepped decode's last "
                                     f"logits vs prefill's: rel L2 {gap} "
                                     f"(limit {TOY_LOGITS_REL})")
            for tag, dt in (("fp", None), ("int8", torch.int8)):
                marks = []
                toks = greedy_generate(model, prompt, new, plen + new + 1,
                                       cache_dtype=dt, marks=marks)
                if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
                    raise AssertionError(f"[toy {arch} {tag}] token ids out "
                                         f"of range")
                _log(f"[toy {arch} {tag}] greedy_generate batch "
                     f"{TOY_BATCH}, prompt {plen}, {new} tokens "
                     f"({plen + new} eager decode steps): prompt "
                     f"{marks[1] - marks[0]:.2f} s, decode "
                     f"{marks[2] - marks[1]:.2f} s "
                     f"({1e3 * (marks[2] - marks[1]) / new:.2f} ms/step); "
                     f"row 0 {toks[0, :12].tolist()}")
        _log(f"[toy {arch}] stepped decode's last logits vs prefill's: rel "
             f"L2 {gap:.3g} (limit {TOY_LOGITS_REL}, bf16; prompt {plen}); "
             f"{time.perf_counter() - t0:.1f} s")
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()
    # rwkv6-1.6b: prefill (the wkv6 kernel) against the carried state, at
    # full width (bf16) and at 2 layers f32
    for label, cfg in (
            ("rwkv6-1.6b", configs.get_config("rwkv6-1.6b")),
            ("rwkv6-1.6b 2 layers f32", dataclasses.replace(
                configs.get_config("rwkv6-1.6b"), num_layers=2,
                dtype="float32"))):
        t0 = time.perf_counter()
        model = _full_width_model(torch, cfg, label=f"toy {label}")
        prompt = torch.randint(0, cfg.vocab_size, (1, TOY_RWKV_PROMPT),
                               generator=gen, device="cuda")
        with torch.inference_mode():
            rwkv6_scan.launches_fwd = 0
            pre = model.prefill(prompt)
            torch.cuda.synchronize()
            n_fwd = rwkv6_scan.launches_fwd
            model.use_kernel = False
            pre_plain = model.prefill(prompt)
            model.use_kernel = True
            if n_fwd != cfg.num_layers:
                raise AssertionError(f"[toy {label}] prefill launched the "
                                     f"wkv6 forward {n_fwd} times, expected "
                                     f"{cfg.num_layers}")
            cache = model.init_cache(1, TOY_RWKV_PROMPT)
            for i in range(TOY_RWKV_PROMPT):
                logits, cache = model.decode_step(prompt[:, i:i + 1], cache)
            gap = _rel_l2_logits(torch, logits, pre)
            control = _rel_l2_logits(torch, logits, pre_plain)
            f32 = cfg.dtype == "float32"
            limit = TOY_F32_REL if f32 else \
                TOY_RWKV_CONTROL_FACTOR * control
            if not gap <= limit:
                raise AssertionError(
                    f"[toy {label}] stepped decode's last logits vs the "
                    f"kernel prefill's: rel L2 {gap} (limit {limit}; the "
                    f"plain twin's prefill: {control})")
            toks = greedy_generate(model, prompt[:, :16], 16, 33)
        _log(f"[toy {label}] prefill over {TOY_RWKV_PROMPT} tokens (wkv6 "
             f"kernel, {n_fwd} launches) vs {TOY_RWKV_PROMPT} decode steps "
             f"carrying the state (plain scan): last logits rel L2 "
             f"{gap:.3g}; the plain twin's prefill vs the same steps "
             f"{control:.3g} (limit "
             + (f"{TOY_F32_REL}, f32)" if f32 else
                f"{TOY_RWKV_CONTROL_FACTOR} x the plain twin's gap = "
                f"{limit:.3g}, bf16)")
             + f"; greedy tokens {toks[0].tolist()}; "
             f"{time.perf_counter() - t0:.1f} s")
        if not f32:
            out["rwkv6_prefill"] = n_fwd
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()
    # gemma3-1b at 2 layers f32 past its window of 512 (both layers local:
    # their 512-slot rings wrap): the stepped decode's last logits against
    # prefill's (the dense windowed attention), and greedy_generate with
    # the fp and the int8 cache
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config("gemma3-1b"), num_layers=2,
                              dtype="float32")
    model = _full_width_model(torch, cfg, label="toy gemma3-1b 2 layers f32")
    plen, new = TOY_WINDOW_RUN
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(1, plen)
        for i in range(plen):
            logits, cache = model.decode_step(prompt[:, i:i + 1], cache)
        gap = _rel_l2_logits(torch, logits, model.prefill(prompt))
        toks = {tag: greedy_generate(model, prompt, new, plen + new + 1,
                                     cache_dtype=dt).tolist()
                for tag, dt in (("fp", None), ("int8", torch.int8))}
    rings = sorted({c["k"].shape[1] for c in cache["seg_dense"]})
    if not gap <= TOY_F32_REL:
        raise AssertionError(f"[toy gemma3-1b 2 layers f32] stepped decode's "
                             f"last logits past the window vs prefill's: rel "
                             f"L2 {gap} (limit {TOY_F32_REL})")
    _log(f"[toy gemma3-1b 2 layers f32] {plen} steps past the window of "
         f"{cfg.sliding_window} (ring buffers of {rings}): last logits vs "
         f"prefill's rel L2 {gap:.3g} (limit {TOY_F32_REL}); greedy_generate "
         f"fp {toks['fp']}, int8 {toks['int8']}; "
         f"{time.perf_counter() - t0:.1f} s")
    del model, cache
    # 2 layers f32: the card's greedy tokens equal the CPU port's
    for arch in ("gemma3-1b", "qwen3-0.6b", "rwkv6-1.6b"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=2,
                                  dtype="float32")
        cpu = get_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(3))
        card = get_model(cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        prompt = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, 8)))
        with torch.inference_mode():
            want = greedy_generate(cpu, prompt, 8, 17)
            got = greedy_generate(card, prompt, 8, 17).cpu()
        if not torch.equal(got, want):
            raise AssertionError(f"[toy {arch} 2 layers f32] card tokens "
                                 f"{got.tolist()} differ from the CPU "
                                 f"port's {want.tolist()}")
        _log(f"[toy {arch} 2 layers f32] card tokens == CPU port tokens "
             f"({want.numel()} tokens); {time.perf_counter() - t0:.1f} s")
        del cpu, card
    return out


# ---------------------------------------------------------------------------
# Phase 27: tensor-parallel decode over ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _moe_inputs(kept):
    """Keep a copy of the rows handed to ``moe.moe_apply`` while open (every
    MoE layer's input, in call order)."""
    from repro_torch.models import moe
    orig = moe.moe_apply

    def apply(params, cfg, x, capacity_factor=1.25):
        kept.append(x.detach().clone())
        return orig(params, cfg, x, capacity_factor)

    moe.moe_apply = apply
    try:
        yield kept
    finally:
        moe.moe_apply = orig


def _first_decode_logits(torch, engine, req):
    """The first decode step's full logits of ``req`` on ``engine`` and the
    MoE inputs along the way: its prefill into a fresh pool of the
    engine's (slot 0), then ``TP_MOE_STEPS`` eager paged decode steps,
    each feeding its token to the next; the first step's vocab-sharded
    logits are all-gathered (under TP) and kept. Returns (logits, the MoE
    layers' inputs of the prefill and the decode steps, on the CPU)."""
    import numpy as np
    from repro_torch.distributed import tp
    from repro_torch.serve import pages as pages_lib
    from repro_torch.serve.paged_model import build_paged_decode
    pool = pages_lib.PagePool(engine.pool_cfg, dtype=engine.model.dtype,
                              device=engine.device)
    pool.alloc(0, engine.pages_needed(req))
    ctx, kept = engine._tp_ctx, []

    def keep(logits):
        if ctx is not None and ctx.vocab:
            logits = tp.all_gather_last(logits, ctx.group)
        kept.append(logits[0].float().cpu())
        return logits

    c = engine.pool_cfg
    decode = build_paged_decode(engine.model, quantized=c.quantized,
                                gather_logits=keep)
    state = np.zeros((c.num_slots, 2 + c.max_pages_per_slot), np.int32)
    with _moe_inputs([]) as inputs:
        first = engine._prefill_into(req, 0, pool)
        state[0, 0], state[0, 1] = first, req.prompt_len
        state[:, 2:] = pool.page_table
        with tp.tensor_parallel(ctx):
            for _ in range(TP_MOE_STEPS):
                nxt = decode(torch.from_numpy(state).to(engine.device),
                             pool.buffers)
                state[0, 0], state[0, 1] = int(nxt[0]), state[0, 1] + 1
    return kept[0], [x.cpu() for x in inputs]


def _tp_serve(torch, cfg, device, mesh_model, int8, graph, trace, seed):
    """One engine over ``cfg`` (seeded weights) at ``mesh_model``: the
    trace served after a warm-up run (the graph's capture), counters set to
    0 just before and read just after, then the first decode step's
    logits of the trace's first request and the MoE inputs of its prefill
    and first ``TP_MOE_STEPS`` decode steps."""
    from repro_torch.distributed import tp
    from repro_torch.kernels import flash_attention, page_gather
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    model = get_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(seed))
    engine = ServeEngine(cfg, model, mesh_model=mesh_model, cache_int8=int8,
                         device=device, decode_graph=graph,
                         clock="virtual", **_serve_cfg())
    engine.run(trace[:2])
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    page_gather.launches = flash_attention.launches = 0
    tp.all_reduces = tp.all_gathers = 0
    t0 = time.perf_counter()
    rep = engine.run(trace)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    m = rep.metrics
    out = dict(
        tokens={str(k): v for k, v in rep.tokens_by_rid().items()},
        decode_steps=m["decode_steps"], decode_s=m["decode_s"], wall_s=wall,
        gather=page_gather.launches, flash=flash_attention.launches,
        all_reduces=tp.all_reduces, all_gathers=tp.all_gathers,
        captures=engine.decode_compiles,
        peak=torch.cuda.max_memory_allocated(device),
        plan=None if engine.tp_plan is None else dataclasses.asdict(
            engine.tp_plan))
    logits, out["moe_inputs"] = _first_decode_logits(torch, engine,
                                                     trace[0])
    out["logits"] = logits.tolist()
    return out


def _tp_decode_rank(rank, device, out_dir, runs):
    """One rank of phase 27 (``mesh.spawn``): each of ``runs`` ((tag, cfg,
    int8, graph, trace, seed)) through ``_tp_serve`` at the world's size;
    writes ``out_dir/rank<r>.json`` and the runs' MoE inputs to
    ``out_dir/rank<r>_moe.pt``."""
    import gc
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    size = torch.distributed.get_world_size()
    out, inputs = {}, {}
    with torch.inference_mode():
        for tag, cfg, int8, graph, trace, seed in runs:
            out[tag] = _tp_serve(torch, cfg, device, size, int8, graph,
                                 trace, seed)
            inputs[tag] = out[tag].pop("moe_inputs")
            gc.collect()
            torch.cuda.empty_cache()
            torch.distributed.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.save(inputs, os.path.join(out_dir, f"rank{rank}_moe.pt"))


def _first_diff(got, want):
    """The first (rid, decode step) where two token dicts differ, or None."""
    for rid in sorted(want, key=int):
        for i, (a, b) in enumerate(zip(got.get(rid, []), want[rid])):
            if a != b:
                return rid, i
        if len(got.get(rid, [])) != len(want[rid]):
            return rid, min(len(got.get(rid, [])), len(want[rid]))
    return None


def _tp_decode_phase(torch, arch="qwen3-0.6b"):
    """Phase 27 (and 29's MoE part, ``arch`` qwen2-moe-a2.7b):
    ``ServeEngine(mesh_model=M)``. One card: 2 gloo ranks on it, ``arch``
    at 2 layers f32, fp and int8 pools, eager decode (gloo cannot be
    captured). Two or more cards: NCCL, one card a rank, at M = 2 (and 4
    with four cards), the decode graph capturing the all-reduces and the
    vocab all-gather: ``arch`` at full width on phase 4's 16 requests (ms
    a decode step and GB a card; tokens compared with one card's and the
    first differing step printed); a dense ``arch``'s first decode step's
    logits within rel L2 ``TP_LOGITS_REL`` of the one-card engine's (the
    gate); an MoE ``arch``'s gap only printed (bf16 routing turns the
    other order of the model group's sums into another expert now and
    then), and its gate the 2-layer f32 runs over NCCL, fp and int8 pools.
    A 2-layer f32 run's tokens equal the one-card engine's and its first
    decode step's logits lie within ``TP_SMALL_LOGITS_REL``. In every run
    the MoE layers' inputs of a prefill and ``TP_MOE_STEPS`` decode steps
    are the same bits on every rank. Returns rank 0's (page_gather, flash)
    launches per run."""
    import gc
    from repro_torch import configs
    from repro_torch.distributed import mesh
    from repro_torch.serve import TraceConfig, make_trace
    cards = torch.cuda.device_count()
    nccl = cards >= 2
    full = configs.get_config(arch)
    moe = full.moe.enabled
    small = dataclasses.replace(full, num_layers=2, dtype="float32")
    small_trace = make_trace(TraceConfig(
        num_requests=8, rate=1000.0, prompt_len_min=16, prompt_len_max=128,
        max_new_min=8, max_new_max=16, vocab=full.vocab_size, seed=2))
    # (tag, cfg, int8, graph, trace, seed)
    small_runs = [(f"{pool} 2-layer f32", small, pool == "int8", nccl,
                   small_trace, 1) for pool in ("fp", "int8")]
    if nccl:
        sizes = [m for m in (2, 4) if m <= cards]
        runs = [("fp", full, False, True, _serve_trace(full, 16, seed=0),
                 0)] + (small_runs if moe else [])
    else:
        _log("[tp decode] one card visible: NCCL not run (it needs a card "
             "per rank); 2 ranks over gloo on CUDA tensors on the one card, "
             "eager decode (a gloo collective cannot be captured)")
        sizes = [2]
        runs = small_runs
    backend = "nccl" if nccl else "gloo"
    ref = {}
    with torch.inference_mode():
        for tag, cfg, int8, graph, trace, seed in runs:
            ref[tag] = _tp_serve(torch, cfg, "cuda", 1, int8, graph, trace,
                                 seed)
            gc.collect()
            torch.cuda.empty_cache()
    counts = {}
    for size in sizes:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mesh.spawn(_tp_decode_rank, 1, "cuda", args=(tmp, runs),
                       start_method="forkserver",
                       mesh_model=size, timeout_s=MESH_TIMEOUT_S)
            ranks, inputs = [], []
            for r in range(size):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
                inputs.append(torch.load(os.path.join(tmp, f"rank{r}_moe.pt")))
        for tag, cfg, int8, graph, _, _ in runs:
            label = f"[tp decode {tag} M={size}]"
            one = ref[tag]
            first = ranks[0][tag]
            for r, other in enumerate(ranks):
                o = other[tag]
                if o["tokens"] != first["tokens"]:
                    raise AssertionError(f"{label} rank {r}'s tokens differ "
                                         f"from rank 0's")
                if not (o["all_reduces"] and o["gather"] and o["flash"]
                        and o["captures"] == 1):
                    raise AssertionError(f"{label} rank {r}: no all-reduce, "
                                         f"no kernel launch or not one "
                                         f"decode capture: {o}")
                kept = inputs[r][tag]
                if len(kept) != len(inputs[0][tag]) or not all(
                        torch.equal(a, b) for a, b in zip(kept,
                                                          inputs[0][tag])):
                    raise AssertionError(f"{label} rank {r}'s MoE inputs "
                                         f"differ from rank 0's")
            n_in = len(inputs[0][tag])
            if moe and n_in != cfg.num_layers * (1 + TP_MOE_STEPS):
                raise AssertionError(f"{label} {n_in} MoE inputs kept, not "
                                     f"{cfg.num_layers} layers x (a prefill "
                                     f"and {TP_MOE_STEPS} decode steps)")
            gap = _rel_l2_logits(torch, torch.tensor(first["logits"]),
                                 torch.tensor(one["logits"]))
            diff = _first_diff(first["tokens"], one["tokens"])
            f32 = cfg.dtype == "float32"
            limit = (TP_SMALL_LOGITS_REL["int8" if int8 else "fp"] if f32
                     else None if moe else TP_LOGITS_REL)
            if limit is not None and not gap <= limit:
                raise AssertionError(f"{label} first decode step's logits "
                                     f"vs one card: rel L2 {gap} (limit "
                                     f"{limit})")
            if f32 and diff is not None:
                raise AssertionError(f"{label} tokens differ from the "
                                     f"one-card engine's at (rid, step) "
                                     f"{diff}")
            ms = 1e3 * first["decode_s"] / first["decode_steps"]
            same = ("== the one-card engine's" if diff is None else
                    f"first differ from the one-card engine's at (rid, "
                    f"step) {diff}")
            held = (f"limit {limit:.3g}" if limit is not None else
                    "printed, not gated: bf16 routing; the 2-layer f32 "
                    "runs are the gate")
            same_in = (f"; MoE inputs of the prefill and {TP_MOE_STEPS} "
                       f"decode steps ({n_in} tensors) bit-identical on "
                       f"all {size} ranks" if moe else "")
            counts[f"{arch} {tag} M={size}"] = (first["gather"],
                                                first["flash"])
            _log(f"{label} {backend}, {size} ranks, "
                 f"{'2 layers f32' if f32 else 'full width'} {arch}, "
                 f"plan {first['plan']}: tokens {same}; first decode "
                 f"step's logits rel L2 {gap:.3g} ({held}){same_in}; per "
                 f"rank page_gather {first['gather']} flash "
                 f"{first['flash']} all-reduces {first['all_reduces']} "
                 f"all-gathers {first['all_gathers']} decode captures "
                 f"{first['captures']}; {first['decode_steps']} decode steps, "
                 f"{ms:.3f} ms a step (one card "
                 f"{1e3 * one['decode_s'] / one['decode_steps']:.3f}); run "
                 f"wall {first['wall_s']:.2f} s; peak "
                 f"{first['peak'] / 1e9:.3f} GB a card (one card "
                 f"{one['peak'] / 1e9:.3f})")
        _log(f"[tp decode] {arch} M={size} over {backend}: "
             f"{time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 28: the MoE family (qwen2-moe-a2.7b) on the paged path and training
# ---------------------------------------------------------------------------


def _timed_decode_ms(torch, engine, steps=MOE_TIMED_STEPS):
    """Device ms of one decode step of ``engine`` (its captured graph)
    with every slot live at ``MOE_TIMED_LEN`` tokens: CUDA events around
    ``steps`` steps, over the step count (host gaps between replays
    included, a few tens of microseconds against milliseconds)."""
    import numpy as np
    cfg = engine.pool_cfg
    state = np.zeros((cfg.num_slots, 2 + cfg.max_pages_per_slot), np.int32)
    state[:, 1] = MOE_TIMED_LEN
    state[:, 2:] = 1 + np.arange(cfg.num_slots * cfg.max_pages_per_slot
                                 ).reshape(cfg.num_slots, -1)
    for _ in range(2):
        engine._decode_step(state, engine._bufs, engine._decode_graph)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        engine._decode_step(state, engine._bufs, engine._decode_graph)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def _moe_prefill_ms(torch, engine, buckets):
    """Device ms of one paged prefill per bucket (CUDA events, median of
    3 after a warm call), prompts of the bucket's full length into pages
    1.. of the engine's pool."""
    import numpy as np
    out = {}
    ps = engine.page_size
    for bucket in buckets:
        n_pages = bucket // ps
        packed = np.zeros((1 + n_pages + bucket,), np.int32)
        packed[0] = bucket
        packed[1:1 + n_pages] = 1 + np.arange(n_pages)
        packed[1 + n_pages:] = np.arange(bucket) % engine.cfg.vocab_size
        dev = torch.from_numpy(packed).to(engine.device)
        times = []
        for i in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine._prefill(dev, bucket, n_pages, engine._bufs)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        out[bucket] = statistics.median(times)
    return out


def _moe_serve(torch, kernels):
    """qwen2-moe-a2.7b at full width on phase 4's 16 requests (fp and int8
    pools, graph decode; the short trace eager, graph == eager), then the
    decode step's device ms against its bytes bound and the prefill's per
    bucket. Returns the launch counts per run."""
    import gc
    from repro_torch import configs
    from repro_torch.serve import ServeEngine
    cfg = configs.get_config("qwen2-moe-a2.7b")
    model = _full_width_model(torch, cfg)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    routers = {p.dtype for k, p in named.items() if k.endswith("router.w")}
    if n_params != MOE_PARAMS or routers != {torch.float32}:
        raise AssertionError(f"[moe] {n_params} params (expected "
                             f"{MOE_PARAMS}), router dtypes {routers}")
    runs = _serve_runs(torch, cfg, model, kernels, "moe qwen2-moe-a2.7b",
                       _serve_trace(cfg, 16, seed=0),
                       short=_serve_trace(cfg, SHORT_REQUESTS, seed=0,
                                          new=SHORT_NEW),
                       short_clock="virtual")
    peak = max(r["peak"] for r in runs.values())
    # a decode step reads every weight but the embedding's rows: the
    # capacity dispatch runs each expert's bmm however few tokens it holds
    weight_bytes = sum(p.numel() * p.element_size()
                       for k, p in named.items() if not k.startswith("embed"))
    engine = ServeEngine(cfg, model, clock="wall", **_serve_cfg())
    engine.run(_serve_trace(cfg, 2, seed=1, new=(4, 4)))  # pool and graph
    pc = engine.pool_cfg
    kv_bytes = (2 * 2 * cfg.num_layers * pc.num_slots * pc.max_pages_per_slot
                * pc.page_size * pc.kv_heads * pc.head_dim * 2)
    bound = weight_bytes / PEAK_BYTES_PER_S * 1e3
    bound_kv = (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    ms = _timed_decode_ms(torch, engine)
    prefill = _moe_prefill_ms(torch, engine, MOE_PREFILL_BUCKETS)
    tok_ms = {t: 1e3 * r["report"].metrics["decode_s"]
              / r["report"].metrics["decode_steps"] for t, r in runs.items()}
    _log(f"[moe serve] decode step, {pc.num_slots} slots live at "
         f"{MOE_TIMED_LEN} tokens, fp pool, graph: {ms:.3f} ms device "
         f"(event-timed, {MOE_TIMED_STEPS} steps) | bytes bound "
         f"{bound:.3f} ms ({weight_bytes} weight bytes, all 60 experts a "
         f"layer, at {PEAK_BYTES_PER_S / 1e12} TB/s), {bound_kv:.3f} ms with "
         f"the page gathers' {kv_bytes} bytes | {bound / ms:.1%} of the "
         f"weights bound | engine runs' host ms/step: "
         f"{', '.join(f'{t} {v:.3f}' for t, v in tok_ms.items())}")
    _log(f"[moe serve] paged prefill device ms per bucket: "
         f"{', '.join(f'{b}: {v:.3f}' for b, v in prefill.items())} | peak "
         f"device memory {peak / 1e9:.3f} GB allocated (the most of the serve "
         f"runs) "
         f"({n_params} params, router f32)")
    counts = {t: (r["gather"], r["flash"]) for t, r in runs.items()}
    del model, runs, engine, named
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _moe_kernel_vs_plain(torch):
    """At 2 layers f32 (full width, capacity 1.25: 8 slots hold one token
    an expert in decode) the kernel path serves the plain path's tokens,
    fp and int8 pools."""
    from repro_torch import configs
    from repro_torch.serve import TraceConfig, make_trace
    full = configs.get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(full, num_layers=2, dtype="float32")
    trace = make_trace(TraceConfig(
        num_requests=8, rate=1000.0, prompt_len_min=16, prompt_len_max=256,
        max_new_min=8, max_new_max=32, vocab=cfg.vocab_size, seed=2))
    _hold_kernel_to_plain(torch, cfg, "qwen2-moe-a2.7b", trace, num_slots=8,
                          page_size=16, max_prompt_len=256, max_new_cap=32)
    cap = int(max(1, full.moe.capacity_factor * 8 * full.moe.top_k
                  / full.moe.num_experts))
    _log(f"[e2e] qwen2-moe-a2.7b decode capacity at 8 slots: {cap} token "
         f"an expert (capacity_factor {full.moe.capacity_factor})")


def _cut_train(torch, backup_reduce, cfg, tag, full_layers, *, graph=True):
    """``cfg`` (an arch at full width, cut to ``cfg.model.num_layers`` of
    its ``full_layers``) through ``run_experiment`` eagerly, the
    ``backup_reduce`` count from 0: losses (and, with MoE layers, a
    positive aux) finite, one reduce a step; then, with ``graph``, as one
    chunk through the CUDA graph, bit-equal to the eager run. Returns the
    run's parameter count and the reduce launches of the graph run (of the
    eager run without ``graph``)."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import run_experiment
    steps, moe = cfg.total_steps, cfg.model.moe.enabled
    agg, ex, ema = cfg.aggregation, cfg.execution, cfg.optimizer.ema_decay
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    backup_reduce.launches = 0
    t0 = time.perf_counter()
    with _planned_masks() as masks:
        res = run_experiment(cfg, latency=PaperCalibrated(), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eager = dict(metrics=res.metrics, sums=_param_sums(torch, res.params),
                 masks=masks)
    n_params = sum(v.numel() for v in res.params.values())
    launches, peak = backup_reduce.launches, torch.cuda.max_memory_allocated()
    for m in res.metrics:
        _log(f"[{tag} train eager] step {m['step']} loss {m['loss']:.6f} aux "
             f"{m['aux_loss']:.6g} sim_time {m['sim_time']:.6f} selected "
             f"{m['selected']}")
    bad = [m["step"] for m in res.metrics
           if not (math.isfinite(m["loss"]) and math.isfinite(m["aux_loss"])
                   and (m["aux_loss"] > 0 or not moe))]
    if bad or launches != steps:
        raise AssertionError(f"[{tag} train eager] steps with a non-finite "
                             f"loss or aux: {bad}; backup_reduce launches "
                             f"{launches} (expected {steps})")
    _log(f"[{tag} train eager] {cfg.model.num_layers} of {full_layers} "
         f"layers, full width, {n_params} params, backup "
         f"{agg.num_workers}+{agg.backup_workers}, {ex.backend} grad_batch "
         f"{ex.grad_batch}, {f'EMA {ema}' if ema else 'no EMA'}, "
         f"{cfg.shape.global_batch} x {cfg.shape.seq_len} tokens a step: "
         f"ms/step {', '.join(f'{1e3 * t:.1f}' for t in res.step_times_s)}"
         f" ({wall:.1f} s) | backup_reduce launches {launches} | peak "
         f"device memory {peak / 1e9:.3f} GB")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if not graph:
        return n_params, launches
    metrics, (graph_launches,), sums, gmasks, _ = _graph_train_run(
        torch, cfg, ((backup_reduce, "launches"),), tag)
    if graph_launches != steps:
        raise AssertionError(f"[{tag} train graph] backup_reduce launches "
                             f"{graph_launches}, expected {steps}")
    if not all(math.isfinite(m["aux_loss"]) for m in metrics):
        raise AssertionError(f"[{tag} train graph] non-finite aux loss")
    _hold_graph_to_eager(f"{tag} train", eager, metrics, sums, gmasks)
    return n_params, graph_launches


def _moe_train(torch, backup_reduce):
    """qwen2-moe-a2.7b at ``MOE_TRAIN_LAYERS`` of 24 layers (full width),
    backup 3 + 1, spmd at grad_batch 0, no EMA: 2 steps eagerly, then as
    one chunk of 2 through the CUDA graph, bit-equal; losses and aux
    finite, one backup_reduce a step. Returns the graph run's launches.
    The EMA (7 GB of f32 at P = 1,763,436,544) is left out: with it the
    graph run peaked at 71.9 GB allocated, 83.7 GB reserved, and after
    the call's earlier phases ran out of the card's memory."""
    from repro_torch.launch.profile_train import train_config
    base = train_config("qwen2-moe-a2.7b", steps=MOE_TRAIN_STEPS,
                        grad_batch=0)
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model,
                                        num_layers=MOE_TRAIN_LAYERS),
        optimizer=dataclasses.replace(base.optimizer, ema_decay=0.0))
    return _cut_train(torch, backup_reduce, cfg, "moe",
                      base.model.num_layers)[1]


def _held_memory(torch, before: str) -> None:
    """Logs the bytes the card holds (allocated) ahead of ``before`` and,
    past 4 GB, the largest live CUDA tensors and who holds them: the
    training runs that follow peak within a few GB of the card's memory."""
    held = torch.cuda.memory_allocated()
    _log(f"[memory] before {before}: {held} bytes allocated, "
         f"{torch.cuda.memory_reserved()} reserved")
    if held <= 4e9:
        return
    import gc
    big = sorted((t for t in gc.get_objects()
                  if isinstance(t, torch.Tensor) and t.is_cuda
                  and t.numel() * t.element_size() > 1e8),
                 key=lambda t: -t.numel() * t.element_size())
    for t in big[:8]:
        owners = [type(r).__name__ for r in gc.get_referrers(t)][:6]
        _log(f"[memory]   {tuple(t.shape)} {t.dtype} "
             f"{t.numel() * t.element_size()} bytes, held by {owners}")


def _moe_phase(torch, kernels, backup_reduce):
    """Phase 28: serving at full width, kernel == plain at 2 layers f32,
    training at reduced depth. Returns {run: launches} per counter. The
    engines and graphs of a run hold one another in cycles: collected
    before the next run, or the training run (~72 GB at its peak) finds
    their memory still held."""
    import gc
    with torch.inference_mode():
        serve = _moe_serve(torch, kernels)
        _moe_kernel_vs_plain(torch)
    gc.collect()
    torch.cuda.empty_cache()
    _held_memory(torch, "moe train")
    reduce = _moe_train(torch, backup_reduce)
    return dict(serve=serve, backup_reduce=reduce)


# ---------------------------------------------------------------------------
# Phase 29: the remaining transformer families (MLA with deepseek-v2-lite,
# the vlm prefix with internvl2, MoE under tensor parallelism)
# ---------------------------------------------------------------------------


def _cpu_twin(torch, model):
    """A CPU copy of the card's ``model``: built on the meta device, so the
    CPU draws no weights (its truncated-normal draw of 1e9 parameters takes
    minutes), then given the card's."""
    from repro_torch.models import get_model
    cpu = get_model(model.cfg, device="meta", generator=torch.Generator())
    cpu.to_empty(device="cpu")
    cpu.device = torch.device("cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def _card_equals_cpu(torch, cfg, tag, prefix=False):
    """``cfg`` (2 layers f32) on the card: the stepped decode's last logits
    against ``prefill``'s within ``TOY_F32_REL`` (``_stepped_gap``); with
    its CPU copy, the greedy tokens of ``greedy_generate`` equal, and with
    ``prefix`` the last logits of ``prefill`` over a seeded prefix within
    ``TOY_F32_REL``. Returns the card model's int8-cache dtypes."""
    import numpy as np
    from repro_torch.models import get_model
    from repro_torch.train.serve_step import greedy_generate
    t0 = time.perf_counter()
    card = get_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(3))
    cpu = _cpu_twin(torch, card)
    rng = np.random.default_rng(4)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    gap = _stepped_gap(torch, card, prompt[:1].cuda())
    if not gap <= TOY_F32_REL:
        raise AssertionError(f"[{tag} 2 layers f32] stepped decode's last "
                             f"logits vs prefill's: rel L2 {gap} (limit "
                             f"{TOY_F32_REL})")
    note = (f"; stepped decode's last logits vs prefill's rel L2 {gap:.3g} "
            f"(limit {TOY_F32_REL})")
    with torch.inference_mode():
        want = greedy_generate(cpu, prompt, 8, 17)
        got = greedy_generate(card, prompt, 8, 17).cpu()
        if prefix:
            pre = torch.from_numpy(rng.standard_normal(
                (1, cfg.num_prefix_embeds, cfg.d_model), dtype=np.float32))
            gap = _rel_l2_logits(torch, card.prefill(
                prompt[:1].cuda(), pre.cuda()).cpu(), cpu.prefill(
                prompt[:1], pre))
            if not gap <= TOY_F32_REL:
                raise AssertionError(f"[{tag} 2 layers f32] card prefill over "
                                     f"the prefix vs the CPU port's: rel L2 "
                                     f"{gap} (limit {TOY_F32_REL})")
            note += (f"; prefill over {cfg.num_prefix_embeds} prefix + 8 "
                     f"tokens, last logits card vs CPU rel L2 {gap:.3g} "
                     f"(limit {TOY_F32_REL})")
        dtypes = sorted({str(t.dtype) for c in card.init_cache(
            1, 8, torch.int8).values() if isinstance(c, list)
            for layer in c for t in (layer.values()
                                     if isinstance(layer, dict) else [layer])})
    if not torch.equal(got, want):
        raise AssertionError(f"[{tag} 2 layers f32] card tokens "
                             f"{got.tolist()} differ from the CPU port's "
                             f"{want.tolist()}")
    _log(f"[{tag} 2 layers f32] card tokens == CPU port tokens "
         f"({want.numel()} tokens){note}; {time.perf_counter() - t0:.1f} s")
    del card, cpu
    return dtypes


def _stepped_gap(torch, model, prompt) -> float:
    """Rel L2 of the last logits of ``decode_step`` stepped over ``prompt``
    [1, S] against ``prefill``'s. An MoE model runs this drop-free:
    capacity drops hang on the tokens routed together (prefill's 16 take 1
    slot an expert at capacity factor 1.25, a decode step's 1 token none),
    so the two are held to each other at capacity factor E (capacity T *
    k), as the reference's tests hold them."""
    cfg = model.cfg
    if cfg.moe.enabled:
        model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    try:
        with torch.inference_mode():
            cache = model.init_cache(1, prompt.shape[1])
            for i in range(prompt.shape[1]):
                logits, cache = model.decode_step(prompt[:, i:i + 1], cache)
            return _rel_l2_logits(torch, logits, model.prefill(prompt))
    finally:
        model.cfg = cfg


def _toy_runs(torch, model, cfg, tag, gen, limit=TOY_LOGITS_REL):
    """Phase 26's toy checks on ``model`` at full width: the stepped
    decode's last logits against ``prefill``'s (``_stepped_gap`` within
    ``limit``; ``limit=None`` leaves that to the caller), then
    ``greedy_generate`` with the fp and the int8 cache at the config's
    capacity, eager ms a step. Returns {cache: ms a decode step}."""
    from repro_torch.train.serve_step import greedy_generate
    plen, new = FAMILY_TOY_RUN
    prompt = torch.randint(0, cfg.vocab_size, (TOY_BATCH, plen),
                           generator=gen, device="cuda")
    gap = None if limit is None else _stepped_gap(torch, model, prompt[:1])
    if gap is not None and not gap <= limit:
        raise AssertionError(f"[{tag}] stepped decode's last logits vs "
                             f"prefill's: rel L2 {gap} (limit {limit})")
    out = {}
    with torch.inference_mode():
        for cache_tag, dt in (("fp", None), ("int8", torch.int8)):
            marks = []
            toks = greedy_generate(model, prompt, new, plen + new + 1,
                                   cache_dtype=dt, marks=marks)
            if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
                raise AssertionError(f"[{tag} {cache_tag}] token ids out of "
                                     f"range")
            out[cache_tag] = 1e3 * (marks[2] - marks[1]) / new
            _log(f"[{tag} {cache_tag}] greedy_generate batch {TOY_BATCH}, "
                 f"prompt {plen}, {new} tokens ({plen + new} eager decode "
                 f"steps): prompt {marks[1] - marks[0]:.2f} s, decode "
                 f"{marks[2] - marks[1]:.2f} s ({out[cache_tag]:.2f} "
                 f"ms/step); row 0 {toks[0, :12].tolist()}")
    if gap is not None:
        _log(f"[{tag}] stepped decode's last logits vs prefill's: rel L2 "
             f"{gap:.3g} (limit {limit}, bf16; prompt {plen})")
    return out


def _mla_layer_gaps(torch, model, gen):
    """Each layer's MLA alone at ``model``'s width and dtype: the absorbed
    ``mla_decode`` stepped over ``FAMILY_TOY_RUN[0]`` positions of a
    seeded unit-scale input (what the block's norm hands it) against the
    expanded ``mla_attend`` over the same input, rel L2 of the whole output
    sequence. Returns the gaps, one a layer."""
    from repro_torch.models import attention
    cfg = model.cfg
    s = FAMILY_TOY_RUN[0]
    pos = torch.arange(s, device="cuda")[None]
    gaps = []
    with torch.inference_mode():
        for p_l in model.layers:
            x = torch.randn((1, s, cfg.d_model), generator=gen,
                            device="cuda").to(model.dtype)
            want = attention.mla_attend(p_l["attn"], cfg, x, pos)
            cache = attention.mla_init_cache(cfg, 1, s, model.dtype, "cuda")
            got = torch.cat([attention.mla_decode(
                p_l["attn"], cfg, x[:, i:i + 1], cache, i)[0]
                for i in range(s)], dim=1)
            gaps.append(_rel_l2_logits(torch, got, want))
    return gaps


def _deepseek_phase(torch, backup_reduce):
    """deepseek-v2-lite-16b (MLA, a dense first layer, 64 routed experts
    top-6 + 2 shared) at full width on the toy path (MLA is not paged, as
    in the reference): each layer's absorbed MLA decode against its
    expanded attend, the stepped decode against ``prefill`` on
    ``TOY_MLA_SEEDS`` prompts, ``greedy_generate`` fp and int8 (bf16
    latents), eager ms a step and peak memory; at 2 layers f32 the card's
    tokens equal the CPU port's and an int8 cache request gives bf16
    latents; training at
    ``DEEPSEEK_TRAIN_LAYERS`` of 27 layers, backup 3 + 1, spmd at
    grad_batch 0 with the EMA, eagerly and as one chunk through the CUDA
    graph. Returns the graph run's backup_reduce launches."""
    import gc
    from repro_torch import configs
    from repro_torch.launch.profile_train import train_config
    arch = "deepseek-v2-lite-16b"
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _full_width_model(torch, cfg, label=f"family {arch}")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != DEEPSEEK_PARAMS:
        raise AssertionError(f"[{arch}] {n_params} params, expected "
                             f"{DEEPSEEK_PARAMS}")
    layer_gaps = _mla_layer_gaps(torch, model, torch.Generator(
        device="cuda").manual_seed(28))
    worst = max(range(len(layer_gaps)), key=layer_gaps.__getitem__)
    if not layer_gaps[worst] <= TOY_LOGITS_REL:
        raise AssertionError(f"[family {arch}] layer {worst}'s absorbed MLA "
                             f"decode vs its expanded attend: rel L2 "
                             f"{layer_gaps[worst]} (limit {TOY_LOGITS_REL})")
    _log(f"[family {arch}] each layer's MLA alone, bf16, absorbed decode "
         f"stepped over {FAMILY_TOY_RUN[0]} positions vs the expanded "
         f"attend: rel L2 {min(layer_gaps):.3g} to {layer_gaps[worst]:.3g} "
         f"(layer {worst}; limit {TOY_LOGITS_REL})")
    gens = [torch.Generator(device="cuda").manual_seed(seed)
            for seed in TOY_MLA_SEEDS]
    ms = _toy_runs(torch, model, cfg, f"family {arch}", gens[0],
                   limit=TOY_MLA_LOGITS_REL)
    gaps = [_stepped_gap(torch, model, torch.randint(
        0, cfg.vocab_size, (1, FAMILY_TOY_RUN[0]), generator=gen,
        device="cuda")) for gen in gens[1:]]
    if not max(gaps) <= TOY_MLA_LOGITS_REL:
        raise AssertionError(f"[family {arch}] stepped decode's last logits "
                             f"vs prefill's on seeds {TOY_MLA_SEEDS[1:]}: "
                             f"rel L2 {gaps} (limit {TOY_MLA_LOGITS_REL})")
    peak = torch.cuda.max_memory_allocated()
    _log(f"[family {arch}] stepped decode's last logits vs prefill's on "
         f"seeds {TOY_MLA_SEEDS[1:]}: rel L2 "
         f"{', '.join(f'{g:.3g}' for g in gaps)} (limit "
         f"{TOY_MLA_LOGITS_REL}) | toy path at full width ({n_params} "
         f"params, bf16, MLA latent caches): eager decode {ms['fp']:.2f} ms "
         f"a step fp, {ms['int8']:.2f} int8 (bf16 latents) | peak device "
         f"memory {peak / 1e9:.3f} GB; {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    dtypes = _card_equals_cpu(torch, small, f"family {arch}")
    if dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"[family {arch}] an int8 cache request on the "
                             f"f32 model gave {dtypes}, not bf16 latents")
    base = train_config(arch, steps=FAMILY_TRAIN_STEPS, grad_batch=0)
    train = dataclasses.replace(base, model=dataclasses.replace(
        base.model, num_layers=DEEPSEEK_TRAIN_LAYERS))
    n, launches = _cut_train(torch, backup_reduce, train, arch,
                             cfg.num_layers)
    if n != DEEPSEEK_TRAIN_PARAMS:
        raise AssertionError(f"[{arch} train] {n} params, expected "
                             f"{DEEPSEEK_TRAIN_PARAMS}")
    return launches


@contextlib.contextmanager
def _prefix_batches(cfg):
    """The synthetic pipeline's batches, each given ``cfg``'s prefix of
    precomputed embeddings ``prefix_embeds`` [B, P, d] (f32, seeded by the
    step): the vlm trainer's batches. The port, as the reference, has no
    source of them, and its ``batch_fn=`` override serves the event
    strategies only, as there."""
    import numpy as np
    from unittest import mock
    from repro_torch.data import synthetic_lm
    orig = synthetic_lm.global_batch

    def batch(data_cfg, step):
        out = dict(orig(data_cfg, step))
        out["prefix_embeds"] = np.random.default_rng(step).standard_normal(
            (out["tokens"].shape[0], cfg.num_prefix_embeds, cfg.d_model),
            dtype=np.float32)
        return out

    with mock.patch.object(synthetic_lm, "global_batch", batch):
        yield


def _internvl_phase(torch, backup_reduce):
    """internvl2-2b (the vlm prefix) at full width: ``prefill`` over 256
    seeded prefix embeddings and ``VLM_TEXT`` tokens against ``forward``'s
    last row, its device ms; the toy path (text only, as the reference's);
    training through prefix batches at ``INTERNVL_TRAIN_LAYERS`` of 24
    layers, backup 3 + 1, spmd at grad_batch 1, eagerly; at 2 layers f32
    the card's tokens and prefix prefill equal the CPU port's. Returns the
    training run's backup_reduce launches."""
    import gc
    from repro_torch import configs
    from repro_torch.launch.profile_train import train_config
    arch = "internvl2-2b"
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _full_width_model(torch, cfg, label=f"family {arch}")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != INTERNVL_PARAMS:
        raise AssertionError(f"[{arch}] {n_params} params, expected "
                             f"{INTERNVL_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(29)
    prefix = torch.randn((1, cfg.num_prefix_embeds, cfg.d_model),
                         generator=gen, device="cuda")
    text = torch.randint(0, cfg.vocab_size, (1, VLM_TEXT), generator=gen,
                         device="cuda")
    with torch.inference_mode():
        last = model.prefill(text, prefix)
        full = model(text, prefix)
        if full.shape[1] != cfg.num_prefix_embeds + VLM_TEXT:
            raise AssertionError(f"[{arch}] forward over the prefix gave "
                                 f"{tuple(full.shape)}")
        gap = _rel_l2_logits(torch, last, full[:, -1])
        del full
        times = []
        for i in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.prefill(text, prefix)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    if not gap <= TOY_LOGITS_REL:
        raise AssertionError(f"[{arch}] prefill's last logits vs forward's "
                             f"last row: rel L2 {gap} (limit "
                             f"{TOY_LOGITS_REL})")
    ms = _toy_runs(torch, model, cfg, f"family {arch}", gen)
    peak = torch.cuda.max_memory_allocated()
    _log(f"[family {arch}] prefill over {cfg.num_prefix_embeds} prefix "
         f"embeddings + {VLM_TEXT} tokens, batch 1, eager: "
         f"{statistics.median(times):.3f} ms device (CUDA events, median of "
         f"3); its last logits vs forward's last row rel L2 {gap:.3g} (limit "
         f"{TOY_LOGITS_REL}) | toy decode (text only) {ms['fp']:.2f} ms a "
         f"step fp, {ms['int8']:.2f} int8 | peak device memory "
         f"{peak / 1e9:.3f} GB; {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    base = train_config(arch, steps=FAMILY_TRAIN_STEPS, grad_batch=1)
    train = dataclasses.replace(base, model=dataclasses.replace(
        base.model, num_layers=INTERNVL_TRAIN_LAYERS))
    with _prefix_batches(cfg):
        _, launches = _cut_train(torch, backup_reduce, train,
                                 f"{arch} prefix", cfg.num_layers,
                                 graph=False)
    gc.collect()
    torch.cuda.empty_cache()
    _card_equals_cpu(torch, dataclasses.replace(cfg, num_layers=2,
                                                dtype="float32"),
                     f"family {arch}", prefix=True)
    return launches


def _families_phase(torch, backup_reduce):
    """Phase 29: deepseek-v2-lite-16b (MLA), internvl2-2b (the vlm prefix)
    and qwen2-moe-a2.7b under tensor parallelism (phase 27's run on one
    card: 2 gloo ranks at 2 layers f32). Returns the launch counts per
    run."""
    out = {"backup_reduce": {
        f"deepseek-v2-lite-16b train {DEEPSEEK_TRAIN_LAYERS} layers, one "
        f"chunk of {FAMILY_TRAIN_STEPS} (graph)":
            _deepseek_phase(torch, backup_reduce)}}
    torch.cuda.empty_cache()
    out["backup_reduce"][
        f"internvl2-2b train {INTERNVL_TRAIN_LAYERS} layers, prefix batches, "
        f"{FAMILY_TRAIN_STEPS} eager steps"] = _internvl_phase(torch,
                                                               backup_reduce)
    torch.cuda.empty_cache()
    out["tp"] = _tp_decode_phase(torch, "qwen2-moe-a2.7b")
    return out


# ---------------------------------------------------------------------------
# Phase 30: the last model families (hymba-1.5b: mamba's SSD and the hybrid
# block; whisper-tiny: encoder-decoder with cross caches) and the blocked
# attention core above 8,192 tokens
# ---------------------------------------------------------------------------


def _rel_max(torch, got, want):
    """(rel L2, max abs) of ``got`` against ``want``, in f32."""
    got, want = got.float(), want.float()
    return (_rel_l2_logits(torch, got, want),
            float((got - want).abs().max()))


def _chunked_gqa_check(torch, model, cfg):
    """One hymba layer's attention at full width and dtype over
    ``CHUNKED_S`` tokens with the config's window: ``gqa_attend_chunked``
    against the dense ``gqa_attend``, device ms of each."""
    from repro_torch.models import attention
    gen = torch.Generator(device="cuda").manual_seed(33)
    s, w = CHUNKED_S, cfg.sliding_window
    x = torch.randn((1, s, cfg.d_model), generator=gen,
                    device="cuda").to(model.dtype)
    pos = torch.arange(s, device="cuda")[None]
    p = model.blocks[0]["attn"]
    with torch.inference_mode():
        got = attention.gqa_attend_chunked(p, cfg, x, pos, window=w)
        want = attention.gqa_attend(p, cfg, x, pos, window=w)
        gap, err = _rel_max(torch, got, want)
        del got, want
        ms = _busy_ms(torch, [lambda: attention.gqa_attend_chunked(
            p, cfg, x, pos, window=w)])
        dense_ms = _busy_ms(torch, [lambda: attention.gqa_attend(
            p, cfg, x, pos, window=w)])
    if not gap <= CHUNKED_REL:
        raise AssertionError(f"[chunked hymba layer] gqa_attend_chunked vs "
                             f"gqa_attend over {s} tokens: rel L2 {gap} "
                             f"(limit {CHUNKED_REL})")
    _log(f"[chunked hymba layer] {cfg.num_heads} / {cfg.num_kv_heads} heads "
         f"of {cfg.resolved_head_dim}, {model.dtype}, S {s}, window {w}: "
         f"gqa_attend_chunked vs gqa_attend rel L2 {gap:.3g}, max abs "
         f"{err:.3g} (limit rel {CHUNKED_REL}) | device busy {ms:.3f} ms "
         f"chunked, {dense_ms:.3f} ms dense (torch.profiler, 3 calls)")


def _chunked_mla_check(torch):
    """One deepseek-v2-lite-16b MLA layer at full width, bf16, over
    ``CHUNKED_S`` tokens: ``mla_attend``'s long path (the blocked core)
    against its dense formula (the same function with the switch raised
    past S), device ms of each; the dense scores take 4.6 GB at H 16."""
    from repro_torch import configs
    from repro_torch.models import attention
    cfg = configs.get_config("deepseek-v2-lite-16b")
    gen = torch.Generator(device="cuda").manual_seed(34)
    p = attention.mla_init(gen, cfg, torch.bfloat16, "cuda")
    s = CHUNKED_S
    x = torch.randn((1, s, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, device="cuda")[None]
    limit = attention.MLA_DENSE_MAX_LEN

    def dense():
        attention.MLA_DENSE_MAX_LEN = s
        try:
            return attention.mla_attend(p, cfg, x, pos)
        finally:
            attention.MLA_DENSE_MAX_LEN = limit

    def long():
        return attention.mla_attend(p, cfg, x, pos)

    with torch.inference_mode():
        gap, err = _rel_max(torch, long(), dense())
        ms = _busy_ms(torch, [long])
        dense_ms = _busy_ms(torch, [dense])
    if not gap <= CHUNKED_REL:
        raise AssertionError(f"[chunked deepseek MLA layer] long path vs "
                             f"dense over {s} tokens: rel L2 {gap} (limit "
                             f"{CHUNKED_REL})")
    _log(f"[chunked deepseek MLA layer] {cfg.num_heads} heads, nope "
         f"{cfg.mla.qk_nope_dim} + rope {cfg.mla.qk_rope_dim}, v "
         f"{cfg.mla.v_head_dim}, bf16, S {s}: long path (blocked core) vs "
         f"dense rel L2 {gap:.3g}, max abs {err:.3g} (limit rel "
         f"{CHUNKED_REL}) | device busy {ms:.3f} ms long path, "
         f"{dense_ms:.3f} ms dense (torch.profiler, 3 calls)")


def _ssd_check(torch):
    """``ssd_chunked`` against ``ssd_scan`` on the card at hymba-1.5b's
    training shape in f32 (a worker's 2 x 256 tokens, 25 heads of 64, state
    16; seeded inputs as the reference's own test makes them), at the
    reference's tolerance; device ms of each."""
    from repro_torch.models import mamba
    b, s, h, p, n = (SSD_SHAPE[k] for k in "bshpn")
    gen = torch.Generator(device="cuda").manual_seed(35)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xv, bb, cc = 0.5 * rnd(b, s, h, p), 0.5 * rnd(b, s, h, n), \
        0.5 * rnd(b, s, h, n)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    decay = torch.exp(-dt * torch.exp(0.3 * rnd(h)))
    d_skip = torch.ones((h, p), device="cuda")
    args = (xv, bb, cc, dt, decay, d_skip)
    with torch.inference_mode():
        y1, s1 = mamba.ssd_chunked(*args)
        y2, s2 = mamba.ssd_scan(*args)
        worst = max(float(((a - b_).abs() - 1e-4 * b_.abs()).max())
                    for a, b_ in ((y1, y2), (s1, s2)))
        err = max(float((a - b_).abs().max()) for a, b_ in ((y1, y2),
                                                           (s1, s2)))
        ms = _busy_ms(torch, [lambda: mamba.ssd_chunked(*args)])
        scan_ms = _busy_ms(torch, [lambda: mamba.ssd_scan(*args)])
    if not worst <= 1e-4:
        raise AssertionError(f"[ssd] ssd_chunked vs ssd_scan at [{b}, {s}, "
                             f"{h}, {p}] state {n}, f32: max abs {err} "
                             f"(limit 1e-4 + 1e-4 rel)")
    _log(f"[ssd] ssd_chunked (chunk 64) vs ssd_scan at hymba-1.5b's training "
         f"shape [{b}, {s}, {h}, {p}], state {n}, f32: outputs and final "
         f"state max abs {err:.3g} (limit 1e-4 + 1e-4 rel) | device busy "
         f"{ms:.3f} ms chunked, {scan_ms:.3f} ms scan (torch.profiler, 3 "
         f"calls)")


def _hymba_ring(torch, cfg):
    """``HYMBA_RING_LAYERS`` of 32 layers at full width in f32, stepped
    over ``HYMBA_RING_STEPS`` positions past the window of 1,024 (each
    layer's ring buffer wraps): the last ``HYMBA_RING_HELD`` positions'
    logits against ``forward``'s over the same tokens."""
    from repro_torch.models import get_model
    small = dataclasses.replace(cfg, num_layers=HYMBA_RING_LAYERS,
                                dtype="float32")
    t0 = time.perf_counter()
    model = get_model(small, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(36))
    n = HYMBA_RING_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=torch.Generator(
        device="cuda").manual_seed(37), device="cuda")
    held = []
    with torch.inference_mode():
        cache = model.init_cache(1, n)
        size = cache["attn"][0]["k"].shape[1]
        for i in range(n):
            logits, cache = model.decode_step(toks[:, i:i + 1], cache)
            if i >= n - HYMBA_RING_HELD:
                held.append(logits)
        full = model(toks)[0, n - HYMBA_RING_HELD:]
    gap = _rel_l2_logits(torch, torch.cat(held), full)
    if size != cfg.sliding_window or not gap <= TOY_F32_REL:
        raise AssertionError(f"[hymba ring] a ring of {size} positions, "
                             f"stepped over {n}: the last {HYMBA_RING_HELD} "
                             f"positions' logits vs forward's rel L2 {gap} "
                             f"(limit {TOY_F32_REL})")
    _log(f"[hymba ring] {HYMBA_RING_LAYERS} of {cfg.num_layers} layers, "
         f"full width, f32: decode stepped over {n} positions through a "
         f"ring of {size} (wrapped {n - size} times past the window), the "
         f"last {HYMBA_RING_HELD} positions' logits vs forward's rel L2 "
         f"{gap:.3g} (limit {TOY_F32_REL}); {time.perf_counter() - t0:.1f} s")
    del model, cache


def _hymba_gaps(torch, model, cfg):
    """The stepped decode's last logits against ``prefill``'s at full
    depth on ``HYMBA_SEEDS`` prompts in bf16 (within ``HYMBA_LOGITS_REL``),
    and on the first one with an f32 copy of the same weights (within
    ``TOY_F32_REL``: the decode's ring, SSD scan and mix are the
    prefill's arithmetic); beside them, the control: bf16 ``prefill``
    against the f32 copy's, what bf16 rounding alone moves."""
    from repro_torch.models import get_model
    arch = cfg.name
    twin = get_model(dataclasses.replace(cfg, dtype="float32"),
                     device="meta", generator=torch.Generator())
    twin.to_empty(device="cuda")
    twin.device = model.device
    twin.load_state_dict(model.state_dict())
    prompts = [torch.randint(0, cfg.vocab_size, (1, FAMILY_TOY_RUN[0]),
                             generator=torch.Generator(
                                 device="cuda").manual_seed(seed),
                             device="cuda") for seed in HYMBA_SEEDS]
    gaps = [_stepped_gap(torch, model, p) for p in prompts]
    f32_gap = _stepped_gap(torch, twin, prompts[0])
    with torch.inference_mode():
        control = [_rel_l2_logits(torch, model.prefill(p), twin.prefill(p))
                   for p in prompts]
    del twin

    def fmt(xs):
        return ", ".join(f"{x:.3g}" for x in xs)

    _log(f"[family {arch}] stepped decode's last logits vs prefill's at "
         f"full depth on seeds {HYMBA_SEEDS} (prompt {FAMILY_TOY_RUN[0]}): "
         f"rel L2 bf16 {fmt(gaps)} (limit {HYMBA_LOGITS_REL}); f32 copy "
         f"{f32_gap:.3g} on seed {HYMBA_SEEDS[0]} (limit {TOY_F32_REL}); "
         f"control, bf16 prefill vs the f32 copy's {fmt(control)}")
    if not (max(gaps) <= HYMBA_LOGITS_REL and f32_gap <= TOY_F32_REL):
        raise AssertionError(f"[family {arch}] stepped decode vs prefill: "
                             f"rel L2 bf16 {gaps} (limit {HYMBA_LOGITS_REL}), "
                             f"f32 {f32_gap} (limit {TOY_F32_REL})")


def _hymba_phase(torch):
    """hymba-1.5b at full width (32 layers, d_model 1,600, 25 / 5 heads of
    64, SSD state 16, window 1,024, bf16, seeded random weights, nothing
    cut) on the toy path: the stepped decode's last logits against
    ``prefill``'s on ``HYMBA_SEEDS`` prompts, ``greedy_generate`` batch 2,
    16 + 8 tokens, fp and int8, eager ms a step and peak memory; one
    layer's chunked attention; then the ring past the window, card == CPU
    at 2 layers f32 and the SSD's chunked form against its scan."""
    import gc
    from repro_torch import configs
    arch = "hymba-1.5b"
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _full_width_model(torch, cfg, label=f"family {arch}")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != HYMBA_PARAMS:
        raise AssertionError(f"[{arch}] {n_params} params, expected "
                             f"{HYMBA_PARAMS}")
    _hymba_gaps(torch, model, cfg)
    ms = _toy_runs(torch, model, cfg, f"family {arch}", torch.Generator(
        device="cuda").manual_seed(HYMBA_SEEDS[0]), limit=None)
    peak = torch.cuda.max_memory_allocated()
    _log(f"[family {arch}] toy path at full width ({n_params} params, bf16, "
         f"a ring of {cfg.sliding_window} and an f32 SSD state a layer): "
         f"eager decode {ms['fp']:.2f} ms a step fp, {ms['int8']:.2f} int8 "
         f"| peak device memory {peak / 1e9:.3f} GB (an f32 copy of the "
         f"model included); {time.perf_counter() - t0:.1f} s")
    _chunked_gqa_check(torch, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _hymba_ring(torch, cfg)
    _card_equals_cpu(torch, dataclasses.replace(cfg, num_layers=2,
                                                dtype="float32"),
                     f"family {arch}")
    _ssd_check(torch)


def _whisper_frames(torch, cfg, batch, seed):
    """Seeded encoder frames [batch, 1,500, d_model] x 0.1, f32, on the
    card (the toy path's scale)."""
    return 0.1 * torch.randn((batch, cfg.encoder_seq_len, cfg.d_model),
                             generator=torch.Generator(
                                 device="cuda").manual_seed(seed),
                             device="cuda")


def _whisper_batch_fn(cfg, seq):
    """The async run's ``batch_fn(worker, draw)``: 2 sequences of ``seq``
    tokens and 2 x 1,500 frames x 0.1 (numpy, f32), from (worker, draw);
    the synthetic pipeline makes no frames, as the reference's does not."""
    import numpy as np

    def batch_fn(worker, draw):
        rng = np.random.default_rng(1000 * draw + worker)
        toks = rng.integers(0, cfg.vocab_size, (2, seq + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "encoder_frames": 0.1 * rng.standard_normal(
                    (2, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32)}
    return batch_fn


def _whisper_phase(torch):
    """whisper-tiny at full width (4 + 4 layers, d_model 384, 6 heads of
    64, 1,500 frames, vocab 51,865, bf16, nothing cut): ``prime_cross_cache``
    and the stepped decode against ``forward``'s logits over a 16-token
    prompt on seeded frames; ``greedy_generate`` batch 2, 16 + 8 tokens, fp,
    eager ms a step; training through ``run_experiment`` with async over 4
    workers and a ``batch_fn`` that makes frames, per arrival and as event
    graph chunks, bit-equal."""
    import gc
    from repro_torch import configs
    from repro_torch.launch.profile_train import event_config
    from repro_torch.train.serve_step import greedy_generate
    arch = "whisper-tiny"
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = _full_width_model(torch, cfg, label=f"family {arch}")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != WHISPER_PARAMS:
        raise AssertionError(f"[{arch}] {n_params} params, expected "
                             f"{WHISPER_PARAMS}")
    plen, new = FAMILY_TOY_RUN
    gen = torch.Generator(device="cuda").manual_seed(38)
    prompt = torch.randint(0, cfg.vocab_size, (TOY_BATCH, plen),
                           generator=gen, device="cuda")
    frames = _whisper_frames(torch, cfg, TOY_BATCH, 39)
    with torch.inference_mode():
        cache = model.prime_cross_cache(model.init_cache(1, plen),
                                        frames[:1])
        stepped = []
        for i in range(plen):
            logits, cache = model.decode_step(prompt[:1, i:i + 1], cache)
            stepped.append(logits)
        full = model(prompt[:1], encoder_frames=frames[:1])[0]
        gap = _rel_l2_logits(torch, torch.cat(stepped), full)
        del cache, full
        if not gap <= TOY_LOGITS_REL:
            raise AssertionError(f"[family {arch}] primed cross cache + "
                                 f"stepped decode vs forward over {plen} "
                                 f"tokens: rel L2 {gap} (limit "
                                 f"{TOY_LOGITS_REL})")
        marks = []
        toks = greedy_generate(model, prompt, new, plen + new + 1,
                               marks=marks, encoder_frames=frames)
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"[family {arch}] token ids out of range")
    step_ms = 1e3 * (marks[2] - marks[1]) / new
    peak = torch.cuda.max_memory_allocated()
    _log(f"[family {arch}] prime_cross_cache + stepped decode vs forward, "
         f"all {plen} positions' logits: rel L2 {gap:.3g} (limit "
         f"{TOY_LOGITS_REL}, bf16) | greedy_generate batch {TOY_BATCH}, "
         f"{cfg.encoder_seq_len} frames, prompt {plen}, {new} tokens: encode "
         f"+ prompt {marks[1] - marks[0]:.2f} s, decode "
         f"{marks[2] - marks[1]:.2f} s ({step_ms:.2f} ms/step eager); row 0 "
         f"{toks[0, :12].tolist()} | peak device memory {peak / 1e9:.3f} GB; "
         f"{time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    tag = f"event {arch} async"
    runs = {}
    for chunk in (1, WHISPER_UPDATES):
        ecfg = event_config(arch, "async", steps=WHISPER_UPDATES,
                            chunk=chunk)
        kind = "graph" if chunk > 1 else "per-arrival"
        runs[kind] = _event_run(torch, ecfg, (), f"{tag} {kind}",
                                batch_fn=_whisper_batch_fn(
                                    cfg, ecfg.shape.seq_len))
    _hold_events(tag, runs["per-arrival"], runs["graph"])


def _hybrid_audio_phase(torch, backup_reduce):
    """Phase 30: hymba-1.5b and whisper-tiny at full width, the chunked
    core above 8,192 tokens, then hymba's training at
    ``HYMBA_TRAIN_LAYERS`` of its layers. Returns the backup_reduce
    launches of its graph run."""
    import gc
    from repro_torch.launch.profile_train import train_config
    _hymba_phase(torch)
    torch.cuda.empty_cache()
    _chunked_mla_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    _whisper_phase(torch)
    torch.cuda.empty_cache()
    arch = "hymba-1.5b"
    base = train_config(arch, steps=FAMILY_TRAIN_STEPS, grad_batch=1)
    train = dataclasses.replace(base, model=dataclasses.replace(
        base.model, num_layers=HYMBA_TRAIN_LAYERS))
    n, launches = _cut_train(torch, backup_reduce, train, arch,
                             base.model.num_layers)
    if n != HYMBA_TRAIN_PARAMS:
        raise AssertionError(f"[{arch} train] {n} params, expected "
                             f"{HYMBA_TRAIN_PARAMS}")
    return launches



# ---------------------------------------------------------------------------
# Phase 31: the planning tools on the card
# ---------------------------------------------------------------------------


def _gb(n: float) -> str:
    return f"{n / 1e9:.3f} GB"


def _plan(tag, cfg):
    """The dry run's plan of ``cfg``'s eager spmd step (no allocation)."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    plan = dryrun.plan_train(cfg)
    mem = plan["memory"]
    _log(f"[tooling dryrun {tag}] planned in {time.perf_counter() - t0:.1f} "
         f"s: resident {mem['argument_bytes']} bytes "
         f"({', '.join(f'{k} {_gb(v)}' for k, v in mem['resident'].items())}"
         f"), eager peak {mem['peak_bytes']} bytes, fits "
         f"{mem['peak_bytes'] <= dryrun.CARD_MEMORY_BYTES} (card "
         f"{dryrun.CARD_MEMORY_BYTES} bytes); collectives "
         f"{plan['collectives']['num_ops']:.0f}")
    return plan


def _hold_resident(tag, plan, measured: int) -> None:
    want = plan["memory"]["argument_bytes"]
    gap = (want - measured) / measured
    if not abs(gap) <= DRYRUN_RESIDENT_REL:
        raise AssertionError(
            f"[tooling dryrun {tag}] resident {want} bytes predicted, the "
            f"card holds {measured}: gap {gap:+.4%} (limit "
            f"{DRYRUN_RESIDENT_REL:.0%})")
    _log(f"[tooling dryrun {tag}] resident bytes: predicted {want}, the card "
         f"holds {measured} once the trainer has its state and stack: gap "
         f"{gap:+.4%} (limit {DRYRUN_RESIDENT_REL:.0%})")


def _eager_step(torch, cfg, keep_grad: bool):
    """One eager step of a fresh trainer: (bytes held after it beyond the
    start, ``max_memory_allocated`` above the start, device busy ms of a
    second eager step, the first aggregated gradient or None); None when
    the step runs out of the card's memory."""
    import gc
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.train.loop import Trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = None
    try:
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cuda")
        tr.init_state()
        with _first_grad() as first:
            tr.run(1)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() - base
        busy = _busy_ms(torch, [lambda: tr.run(1)], calls=1) \
            if keep_grad else None
        grad = first[0] if keep_grad else None
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    return held, peak, busy, grad


def _step_shares(cfg, busy_ms, label):
    from repro_torch.benchmarks import roofline
    sh = roofline.step_shares(cfg.model, cfg.shape, busy_ms / 1e3)
    if not 0.0 < sh["mfu"] < 1.0:
        raise AssertionError(f"[tooling roofline {label}] mfu {sh['mfu']}")
    _log(f"[tooling roofline {label}] {cfg.shape.global_batch} x "
         f"{cfg.shape.seq_len} tokens: perfmodel {sh['flops']:.4e} flops "
         f"(model {sh['model_flops']:.4e}), {sh['hbm_bytes']:.4e} HBM bytes;"
         f" bound compute {1e3 * sh['compute_s']:.3f} ms, memory "
         f"{1e3 * sh['memory_s']:.3f} ms (989 TFLOP/s bf16, 3.35 TB/s); "
         f"device busy {busy_ms:.3f} ms -> mfu {sh['mfu']:.4f}")
    return sh


def _ef_steps(g, steps):
    """``steps`` error-feedback steps of ``compress_with_error_feedback``
    over the flat gradient ``g`` (each step's input is ``g``, its residual
    carried): [(codes, 0-d f32 scale, residual)] a step."""
    from repro_torch.distributed import compression as comp
    e, out = comp.init_error_feedback({"g": g}), []
    for _ in range(steps):
        c, e = comp.compress_with_error_feedback({"g": g}, e)
        out.append((c["q"]["g"], c["scale"]["g"], e["g"]))
    return out


def _compression_check(torch, grad, cpu_steps):
    """``_ef_steps`` over the f32 gradient ``grad`` (host) on the card,
    held to ``cpu_steps`` (the same on the CPU, a future): codes, scales
    and residuals bit-equal; Σ dequantised = Σ true - the last residual
    within f32 rounding; ``compressed_bytes`` per scheme."""
    from repro_torch.distributed import compression as comp
    t0 = time.perf_counter()
    g = grad.float().cuda()
    steps = _ef_steps(g, EF_STEPS)
    card_s = time.perf_counter() - t0
    want = cpu_steps.result()
    for step, ((q, scale, e), (q_cpu, scale_cpu, e_cpu)) in enumerate(
            zip(steps, want)):
        q = q.cpu()
        same = (torch.equal(q, q_cpu) and scale.item() == scale_cpu.item()
                and torch.equal(e.cpu().view(torch.int32),
                                e_cpu.view(torch.int32)))
        if not same:
            raise AssertionError(
                f"[tooling compression] step {step}: card vs CPU: "
                f"{int((q != q_cpu).sum())} codes differ, scale "
                f"{scale.item()!r} vs {scale_cpu.item()!r}, residual max "
                f"gap {(e.cpu() - e_cpu).abs().max().item()}")
        _log(f"[tooling compression] step {step}: card == CPU (codes, the "
             f"0-d f32 scale {scale.item():.6e}, residual bit for bit); "
             f"residual max |e| {e.abs().max().item():.4e}")
    applied = sum(comp.decompress_int8({"q": q, "scale": s_})
                  for q, s_, _ in steps)
    true = sum(g for _ in steps)
    gap = (applied - (true - steps[-1][2])).abs().max().item()
    limit = 1e-6 * true.abs().max().item()
    if not gap <= limit:
        raise AssertionError(f"[tooling compression] telescoping: max gap "
                             f"{gap} over the f32 limit {limit}")
    sizes = {k: comp.compressed_bytes({"g": g}, k)
             for k in ("none", "bf16", "int8_ef")}
    _log(f"[tooling compression] P {g.numel()}, {EF_STEPS} steps "
         f"({card_s:.2f} s on the card; the CPU's {EF_STEPS} ran beside "
         f"the dry runs): sum of dequantised == sum of true - last "
         f"residual, max gap {gap:.3e} (limit {limit:.3e}); "
         f"compressed_bytes {', '.join(f'{k} {v}' for k, v in sizes.items())}")


def _figures(torch, on_card: bool) -> None:
    """The paper's four remaining figures at the reference's quick sizes:
    Figs. 3-4 and Table 1 on the host (derived strings as the CPU's);
    with ``on_card``, Fig. 2 and Table 2 / Fig. 7 on the card (their
    boolean rows held)."""
    from repro_torch.benchmarks import (bench_layer_staleness,
                                        bench_lr_sweep, bench_staleness,
                                        bench_straggler)
    for name, mod, want in (("straggler", bench_straggler, STRAGGLER_ROWS),
                            ("layer_staleness", bench_layer_staleness,
                             LAYER_STALENESS_ROWS)):
        rows = mod.run(True)
        for row in rows:
            _log(f"[tooling figures] {row[0]},{row[1]:.1f},{row[2]}")
        if tuple(r[2] for r in rows) != want:
            raise AssertionError(f"[tooling figures] {name} rows "
                                 f"{[r[2] for r in rows]} != the CPU's "
                                 f"{list(want)}")
    if not on_card:
        return
    for name, mod, checks in (
            ("staleness", bench_staleness,
             {"staleness.monotone_degradation": "True"}),
            ("lr_sweep", bench_lr_sweep,
             {"lr_sweep.best_gamma": "0.8",
              "lr_sweep.small_lr_worse_optimum": "True"})):
        t0 = time.perf_counter()
        rows = mod.run(True, device="cuda")
        for row in rows:
            _log(f"[tooling figures] {row[0]},{row[1]:.1f},{row[2]}")
        got = {r[0]: r[2] for r in rows}
        if any(got.get(k) != v for k, v in checks.items()):
            raise AssertionError(f"[tooling figures] {name}: {got}")
        _log(f"[tooling figures] {name} on the card: "
             f"{time.perf_counter() - t0:.1f} s")


def _tooling_phase(torch, measured=None):
    """Phase 31: the dry run, the roofline, gradient compression and the
    paper's four remaining figures on the card. ``measured`` (the default
    call): phase 17's qwen3-0.6b grad_batch 0 graph run (resident bytes
    gated, the eager peak printed beside the graph peak, its busy time's
    mfu), phase 4's timed decode (hbm_share) and phase 6's first gradient;
    the figures on the host only. Without it (``--tooling-only``): fresh
    eager steps of qwen3-0.6b at grad_batch 1 and 0 give the resident
    bytes, the eager peaks (gated), the mfu and the gradient; Fig. 2 and
    the lr sweep run on the card too."""
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.profile_train import train_config
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(1) as ex:
        # the compression's CPU reference runs beside the dry runs
        cpu_steps = None
        if measured is not None:
            cpu_steps = ex.submit(_ef_steps, measured["first_grad"].float(),
                                  EF_STEPS)
        rwkv = _plan("rwkv6-1.6b grad_batch 0",
                     train_config("rwkv6-1.6b", grad_batch=0, steps=1))
        if rwkv["memory"]["peak_bytes"] <= dryrun.CARD_MEMORY_BYTES:
            raise AssertionError("[tooling dryrun rwkv6-1.6b grad_batch 0] "
                                 "predicted to fit the card")
        _log(f"[tooling dryrun rwkv6-1.6b grad_batch 0] does not fit: eager "
             f"peak {_gb(rwkv['memory']['peak_bytes'])} predicted against "
             f"{_gb(dryrun.CARD_MEMORY_BYTES)} (not run) | {smi}")
        if measured is not None:
            tag = "qwen3-0.6b grad_batch 0"
            stats = measured["graphs"][tag]
            cfg = train_config("qwen3-0.6b", grad_batch=0)
            plan = _plan(tag, cfg)
            _hold_resident(tag, plan, stats["resident"])
            _log(f"[tooling dryrun {tag}] eager peak predicted "
                 f"{plan['memory']['peak_bytes']} bytes beside the graph "
                 f"run's {stats['peak']} (not gated: a graph's private pool "
                 f"is not an eager step's) | {smi}")
            _step_shares(cfg, stats["busy_ms"], f"{tag} graph step | {smi}")
            decode_ms = measured["decode_ms"]
            slots = _serve_cfg()["num_slots"]
            shape = ShapeConfig("serve_decode", MOE_TIMED_LEN, slots,
                                "decode")
            sh = roofline.step_shares(cfg.model, shape, decode_ms / 1e3)
            _log(f"[tooling roofline qwen3-0.6b decode] {slots} slots at "
                 f"{MOE_TIMED_LEN} tokens, {decode_ms:.4f} ms a graph step: "
                 f"perfmodel {sh['hbm_bytes']:.4e} HBM bytes -> hbm_share "
                 f"{sh['hbm_share']:.4f}, mfu {sh['mfu']:.5f} | {smi}")
            grad = measured["first_grad"]
        else:
            for gb in (1, 0):
                tag = f"qwen3-0.6b grad_batch {gb}"
                cfg = train_config("qwen3-0.6b", grad_batch=gb, steps=1)
                plan = _plan(tag, cfg)
                got = _eager_step(torch, cfg, keep_grad=gb == 1)
                fits = plan["memory"]["peak_bytes"] <= \
                    dryrun.CARD_MEMORY_BYTES
                if got is None:
                    if fits:
                        raise AssertionError(
                            f"[tooling dryrun {tag}] the eager step ran out "
                            f"of memory; the plan said it fits")
                    _log(f"[tooling dryrun {tag}] the eager step ran out of "
                         f"memory, as predicted | {smi}")
                    continue
                held, peak, busy, g = got
                _hold_resident(tag, plan, held)
                want = plan["memory"]["peak_bytes"]
                gap = (want - peak) / peak
                if not abs(gap) <= DRYRUN_PEAK_REL:
                    raise AssertionError(
                        f"[tooling dryrun {tag}] eager peak {want} "
                        f"predicted, max_memory_allocated {peak}: gap "
                        f"{gap:+.4%} (limit {DRYRUN_PEAK_REL:.0%})")
                _log(f"[tooling dryrun {tag}] eager peak: predicted {want} "
                     f"bytes, max_memory_allocated {peak}: gap {gap:+.4%} "
                     f"(limit {DRYRUN_PEAK_REL:.0%}); fits {fits} | {smi}")
                if g is not None:
                    grad = g
                    cpu_steps = ex.submit(_ef_steps, g.float(), EF_STEPS)
                    _step_shares(cfg, busy, f"{tag} eager step | {smi}")
        _compression_check(torch, grad, cpu_steps)
    _figures(torch, on_card=measured is None)

def main(argv) -> int:
    started = time.perf_counter()
    # cuBLAS picks the same algorithms run to run (the kernel and plain
    # training runs must compute the same first-step gradients)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    entries = ("--mesh-only", "--faults-only", "--serve-only",
               "--tp-decode-only", "--flash-only", "--moe-only",
               "--families-only", "--hybrid-audio-only", "--tooling-only")
    if argv and (len(argv) > 1 or argv[0] not in entries):
        print(f"chip_smoke: unknown arguments {argv} (none, or one of "
              f"{', '.join(entries)})", file=sys.stderr)
        return 2
    mesh_only = argv == ["--mesh-only"]
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import (_build, backup_reduce, flash_attention,
                                     page_gather, rwkv6_scan)
    from repro_torch.serve.pages import pages_for
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 is full f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
         f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
         f"x{torch.cuda.device_count()}")
    _log(smi)

    # the ranks of phases 18, 19, 27 and 29 fork from one server that
    # imports torch beside the build (each spawned rank took ~8-15 s to
    # start); the server never touches the card
    import multiprocessing
    from multiprocessing import forkserver
    multiprocessing.set_forkserver_preload(
        ["__main__", "torch", "repro_torch.distributed.mesh"])
    forkserver.ensure_running()

    # 2. build (and, beside it, ptxas's report on the flash kernels, which
    # phase 25 reads)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        ptxas = ex.submit(_build.resource_usage, "flash_attention") \
            if argv in ([], ["--flash-only"]) else None
        secs = _build.build()
        _log(f"[build] "
             f"{', '.join(f'{k}.cu {v:.1f} s' for k, v in secs.items())}"
             f" (wall {time.perf_counter() - t0:.1f} s, parallel nvcc, "
             f"sm_90a)")
        ptxas_report = ptxas.result() if ptxas is not None else None
    if mesh_only:         # phases 18, 19 and 27 (the multi-card check)
        t0 = time.perf_counter()
        _mesh_phase(torch)
        _shrink_phase(torch)
        _log(f"[time] phase 18: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _tp_phase(torch, _tp_ref_loss(torch))
        _log(f"[time] phase 19: {time.perf_counter() - t0:.1f} s")
    if mesh_only or argv == ["--tp-decode-only"]:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        _tp_decode_phase(torch)
        _log(f"[time] phase 27: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        _tp_decode_phase(torch, "qwen2-moe-a2.7b")      # phase 29's TP part
        _log(f"[time] phase 29 (MoE under TP): "
             f"{time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--faults-only"]:       # phases 20 and 21 alone
        t0 = time.perf_counter()
        _device_backend_phase(torch)
        _log(f"[time] phase 20: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        _faults_phase(torch, backup_reduce)
        _log(f"[time] phase 21: {time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--flash-only"]:   # flash attention's kernel checks alone
        _flash_phase(torch, flash_attention)
        _flash256_phase(torch, flash_attention, ptxas_report,
                        secs["flash_attention"])
        return 0
    if argv == ["--serve-only"]:        # phases 22-24 and the shrink alone
        _slice_phases(torch, backup_reduce, page_gather, flash_attention)
        torch.cuda.empty_cache()
        _shrink_phase(torch)
        return 0
    if argv == ["--moe-only"]:          # phase 28 alone
        t0 = time.perf_counter()
        _moe_phase(torch, (page_gather, flash_attention), backup_reduce)
        _log(f"[time] phase 28: {time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--families-only"]:     # phase 29 alone
        t0 = time.perf_counter()
        _families_phase(torch, backup_reduce)
        _log(f"[time] phase 29: {time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--hybrid-audio-only"]:     # phase 30 alone
        t0 = time.perf_counter()
        _hybrid_audio_phase(torch, backup_reduce)
        _log(f"[time] phase 30: {time.perf_counter() - t0:.1f} s")
        return 0
    if argv == ["--tooling-only"]:          # phase 31 alone
        t0 = time.perf_counter()
        _tooling_phase(torch)
        _log(f"[time] phase 31: {time.perf_counter() - t0:.1f} s")
        return 0

    lap = [time.perf_counter()]

    def timed(phases):
        now = time.perf_counter()
        _log(f"[time] phase {phases}: {now - lap[0]:.1f} s")
        lap[0] = now

    # 3. the serve kernels at the serve path's shapes (its maxp and pool)
    maxp = pages_for(512 + 128, GATHER_SHAPE["ps"])
    rows = _gather_phase(torch, page_gather, maxp,
                         num_pages=GATHER_SHAPE["b"] * maxp + 1, layers=28)
    rows.append(_flash_phase(torch, flash_attention))

    # 4. serve at full width (no autograd graph: inference mode)
    with torch.inference_mode():
        runs = _serve_phase(torch, (page_gather, flash_attention))
    # each row's launches come from one serve run: the gather variants from
    # the run whose pool they read, flash from the fp run (the int8 run's
    # count is printed on its [serve int8] line)
    launch_run = {
        "page_gather": ("fp graph", "gather",
                        "serve fp (graph decode), decode replays"),
        "page_gather_dequant": ("int8 graph", "gather",
                                "serve int8 (graph decode), decode replays"),
        "flash_attention": ("fp graph", "flash",
                            "serve fp (graph decode), prefill eager")}
    for row in rows[:3]:
        run, counter, label = launch_run[row["name"]]
        row["launches"] = runs[run][counter]
        row["launches_run"] = label
    timed("3-4")

    # 5. kernel path == plain path, end to end
    with torch.inference_mode():
        _kernel_vs_plain_phase(torch)
    timed(5)

    # 6. train at full width through the backup_reduce kernel, then the
    # kernel against its plain version at the run's [W, P] stack
    train = _train_phase(torch, backup_reduce)
    rows.append(_reduce_phase(torch, backup_reduce, train["n_params"]))
    rows[3]["launches"] = train["launches"]
    rows[3]["launches_run"] = "train spmd, one chunk of 3 steps (graph)"
    timed(6)

    # 7. reduced depth: sim == spmd, checkpoint resume == straight run
    _parity_phase(torch)
    timed(7)

    # 8. the wkv kernels at rwkv6-1.6b's training shape and edge shapes
    wkv_rows = _wkv_phase(torch, rwkv6_scan)
    timed(8)

    # 9. train rwkv6-1.6b at full width through the wkv kernels, then plain
    rwkv = _rwkv_train_phase(torch, rwkv6_scan, backup_reduce)
    for row, n in zip(wkv_rows, rwkv["launches"]):
        row["launches"] = n
        row["launches_run"] = ("train rwkv6-1.6b spmd, one chunk of 3 "
                               "steps (graph)")
    rows += wkv_rows
    timed(9)

    # 10. reduced depth: wkv kernels == plain twin through a training step
    _rwkv_parity_phase(torch)
    timed(10)

    # 11-12. the event regimes at full width, per arrival and as graphs
    _event_phase(torch, rwkv6_scan, backup_reduce)
    timed("11-12")

    # 13. the §2.1 staleness rig on MnistCNN
    _mnist_phase(torch)
    timed(13)

    # 14. reduced depth: event resume == straight run, card == CPU port
    _event_parity_phase(torch)
    timed(14)

    # 15. Figs. 5 and 6 at the tiny size, the card held to the CPU port
    _fig5_fig6_phase(torch)
    timed(15)

    # 16. Figs. 8/9 at full width, then rwkv6 kernels vs plain converging
    # with the Queue 3 controls
    t0 = time.perf_counter()
    _full_width_phase(torch, backup_reduce, rwkv6_scan)
    _log(f"[time] phase 16: {time.perf_counter() - t0:.1f} s")

    # 17. batched worker gradients at full width, held to phases 6 and 9
    t0 = time.perf_counter()
    batched, batched_graphs = _batched_phase(
        torch, backup_reduce, rwkv6_scan,
        {"qwen3-0.6b": train, "rwkv6-1.6b": rwkv})
    first_grad = train.pop("first_grad")        # phase 31's gradient
    del rwkv["first_grad"]
    _batched_parity_phase(torch)
    _eps_record(torch)
    _log(f"[time] phase 17: {time.perf_counter() - t0:.1f} s")

    # 18. the 'data' axis over ranks: NCCL with a card each, else gloo
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    meshed = _mesh_phase(torch)
    torch.cuda.empty_cache()
    meshed.update(_shrink_phase(torch))
    _log(f"[time] phase 18: {time.perf_counter() - t0:.1f} s")

    # 19. the 'model' axis over ranks: NCCL with a card each, else gloo
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    meshed.update(_tp_phase(torch, train["metrics"][0]["loss"]))
    _log(f"[time] phase 19: {time.perf_counter() - t0:.1f} s")

    # 20. the device straggler backend at full width
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _device_backend_phase(torch)
    _log(f"[time] phase 20: {time.perf_counter() - t0:.1f} s")

    # 21. faults, the supervisor, the rescale and dynamic_backup on the
    # spmd engine at full width
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rows[3]["launches_faults"] = _faults_phase(torch, backup_reduce)
    _log(f"[time] phase 21: {time.perf_counter() - t0:.1f} s")

    # 22-24. telemetry, the restore bridge and the replica router
    torch.cuda.empty_cache()
    router = _slice_phases(torch, backup_reduce, page_gather,
                           flash_attention)
    rows[3]["launches_telemetry"] = router["telemetry"]
    for row, key in zip(rows[:3], ("gather", "gather", "flash")):
        if row["name"] != "page_gather_dequant":
            row["launches_router"] = router[key]

    # 25. the dense configs on the paged path, flash at head_dim 256
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    row256 = _flash256_phase(torch, flash_attention, ptxas_report,
                             secs["flash_attention"])
    with torch.inference_mode():
        dense = _dense_phase(torch, (page_gather, flash_attention))
    gemma = dense["gemma3-1b"]
    row256["launches"] = gemma["fp graph"][1]
    row256["launches_run"] = ("serve gemma3-1b fp (graph decode), prefill "
                              "eager")
    row256["launches_dense"] = {f"gemma3-1b {t}": n[1]
                                for t, n in gemma.items()}
    rows.insert(3, row256)
    for row in rows[:3]:
        if row["name"] == "flash_attention":      # D = 128
            row["launches_dense"] = {
                f"{arch} {t}": n[1] for arch, runs in dense.items()
                if arch != "gemma3-1b" for t, n in runs.items()}
        else:                                     # each gather its pool's
            pool = "int8" if row["name"] == "page_gather_dequant" else "fp"
            row["launches_dense"] = {
                f"{arch} {t}": n[0] for arch, runs in dense.items()
                for t, n in runs.items() if t.startswith(pool)}
    _log(f"[time] phase 25: {time.perf_counter() - t0:.1f} s")

    # 26. the toy path: contiguous caches and RWKV's carried state
    t0 = time.perf_counter()
    toy = _toy_phase(torch, rwkv6_scan)
    next(r for r in rows if r["name"] == "rwkv6_wkv_fwd")[
        "launches_toy"] = {"rwkv6-1.6b prefill": toy["rwkv6_prefill"]}
    _log(f"[time] phase 26: {time.perf_counter() - t0:.1f} s")

    # 27. tensor-parallel decode over ranks
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _tp_decode_phase(torch)
    _log(f"[time] phase 27: {time.perf_counter() - t0:.1f} s")
    for row in rows[4:]:
        key = {"backup_reduce": "backup_reduce",
               "rwkv6_wkv_fwd": "wkv6_fwd",
               "rwkv6_wkv_bwd": "wkv6_bwd"}.get(row["name"])
        if key:
            row["launches_batched_and_mesh"] = {
                tag: n[key] for tag, n in {**batched, **meshed}.items()
                if n[key]}

    # 28. the MoE family: qwen2-moe-a2.7b served at full width, trained
    # at reduced depth
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    moe = _moe_phase(torch, (page_gather, flash_attention), backup_reduce)
    for row in rows:
        if row["name"] in ("page_gather", "page_gather_dequant"):
            pool = "int8" if row["name"] == "page_gather_dequant" else "fp"
            row["launches_moe"] = {
                f"qwen2-moe-a2.7b {t}": n[0]
                for t, n in moe["serve"].items() if t.startswith(pool)}
        elif row["name"] == "flash_attention":    # D = 128
            row["launches_moe"] = {f"qwen2-moe-a2.7b {t}": n[1]
                                   for t, n in moe["serve"].items()}
        elif row["name"] == "backup_reduce":
            row["launches_moe"] = {
                "qwen2-moe-a2.7b train 2 layers, one chunk of 2 (graph)":
                    moe["backup_reduce"]}
    _log(f"[time] phase 28: {time.perf_counter() - t0:.1f} s")

    # 29. the remaining transformer families: MLA (deepseek-v2-lite),
    # the vlm prefix (internvl2), MoE under tensor parallelism
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    families = _families_phase(torch, backup_reduce)
    for row in rows:
        if row["name"] in ("page_gather", "page_gather_dequant"):
            pool = "int8" if row["name"] == "page_gather_dequant" else "fp"
            row["launches_families"] = {
                f"{run} (a rank)": n[0] for run, n in families["tp"].items()
                if f" {pool} " in run}
        elif row["name"] == "flash_attention":    # D = 128
            row["launches_families"] = {f"{run} (a rank)": n[1]
                                        for run, n in families["tp"].items()}
        elif row["name"] == "backup_reduce":
            row["launches_families"] = families["backup_reduce"]
    _log(f"[time] phase 29: {time.perf_counter() - t0:.1f} s")

    # 30. the last model families: hymba-1.5b (mamba's SSD, the hybrid
    # block), whisper-tiny (encoder-decoder), the chunked attention core
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    hybrid = _hybrid_audio_phase(torch, backup_reduce)
    next(r for r in rows if r["name"] == "backup_reduce")[
        "launches_hybrid_audio"] = {
            f"hymba-1.5b train {HYMBA_TRAIN_LAYERS} layers, one chunk of "
            f"{FAMILY_TRAIN_STEPS} "
            f"(graph)": hybrid}
    _log(f"[time] phase 30: {time.perf_counter() - t0:.1f} s")

    # 31. the planning tools: the dry run held to phase 17's runs, the
    # roofline's mfu and hbm_share, gradient compression, the figures
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    _tooling_phase(torch, dict(graphs=batched_graphs,
                               decode_ms=runs["fp graph"]["decode_ms"],
                               first_grad=first_grad))
    del first_grad
    _log(f"[time] phase 31: {time.perf_counter() - t0:.1f} s")
    _log(f"[time] phases 1-31: {time.perf_counter() - started:.1f} s")

    # 32. results
    keys = ("name", "route", "source", "replaces", "launches", "launches_run",
            "launches_batched_and_mesh", "launches_faults",
            "launches_telemetry", "launches_router", "launches_dense",
            "launches_toy", "launches_moe", "launches_families",
            "launches_hybrid_audio", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "by_s", "splits",
            "capacity", "ptxas")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
