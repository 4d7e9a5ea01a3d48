#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and prints the build seconds and
   ptxas's registers, spills and shared memory for every kernel.
2. Holds every kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (paper config, bucket 32, 8
   molecules per batch): the quantized matmuls bit for bit through both
   entries (int8 activations, and float32 activations quantized in the
   same launch, the serving path's), the edge softmax to 1e-5 at the
   serving layout, at 63 edges per receiver and at phase 5's refined skin
   list (holes inside receivers' runs, three receivers with every listed
   edge masked, exactly 0) (and its gradients to 1e-4
   rel / 1e-5 abs), the MDDQ
   encode codes exactly (random vectors, and the probe set of near ties,
   poles and vectors under 1e-12 with half the batch zero, through the
   band search and, on a permuted codebook, the full search). Times each
   kernel (CUDA events over back-to-back calls, which at these sizes
   include the host's launch gaps, and its device time and device
   kernels per call from torch.profiler), its plain version and, where
   one PyTorch call computes the same function, that call (a yardstick
   only: the port never calls it), beside the card's least time for the
   same work.
3. Serves 16 molecules of 9-24 atoms through ``QuantizedEngine`` at the
   paper's full width (W4A8, MDDQ through the encode kernel) on the
   sparse path, then the dense path, with every kernel's launch count
   set to 0 just before each run and read just after. Checks finite
   results, sparse against dense, and the card against the CPU plain
   path on the same weights. Splits both w4a8 gaps, sparse vs dense and
   card vs CPU (the same batch with MDDQ off; the MDDQ codes that differ
   per layer).
   Prints per-batch latency, the device idle share and the LEE. The A8
   step of every quantized matmul runs inside its launch: one f32-A
   matmul launch per quantized product, and no act-quant launch. Each
   engine's warmup captures every (bucket, batch class, path) as a CUDA
   graph (``repro_torch.captured``; count, capture seconds and graph-pool
   bytes printed), the counted batches replay them, and steady traffic
   captures nothing (``compiled_shapes`` unchanged). One padded batch per
   path replays against five eager runs of the engine's eager functions
   (``hold_replay``: energies bit for bit, the sparse path's forces,
   whose backward sums with atomics, within twice the eager runs' largest
   gap); ms per batch and the idle share eager against replay,
   alternated; the profiler's kernels over one replayed sparse batch
   equal the launches its capture recorded.
4. Serves the int8-KV decode of qwen2-0.5b at full width (24 layers,
   d_model 896, 14 heads over 2 KV heads, vocab 151,936; W8 weights,
   bf16 activations) through ``repro_torch.launch.serve``: batch 8, a
   1,024-token cache, 64 greedy tokens from random weights (numpy seed 0),
   with the launch counts set to 0 just before and read just after.
   Checks finite logits, one KV-write and one decode-attention launch
   per layer per step (and no (M, K) act-quant launch), the kernels
   against their plain versions over 8
   teacher-forced steps of the same decode (bf16, and again with float32
   activations), and the smoke config on the card against the CPU plain
   path. Prints ms/step, tok/s, the weight and
   cache bytes and the device idle share and device events of one step.
   The greedy decode runs its first step eagerly and replays the step
   captured for (B, S) (``decode_step`` at a position read from a device
   buffer, ``lm_head``, the argmax into the static ids): four more
   decodes from fresh caches (replay, eager, eager, replay) give the
   same tokens and, bit for bit, the same caches, with ms/step and tok/s
   paired; an eager step at a device position and a replayed step run
   under sync-debug "error"; the profiler's kernels over one replayed
   step equal its recorded 24 K5' and 24 K6, and that step's idle share.

5. Runs NVE MD through ``repro_torch.md.MDEngine`` at the paper's full
   width (W4A8, MDDQ through the encode kernel): benchmarks/md_bench.py's
   24-atom molecule (density 0.1, seed 24) tiled into 8 replicas, 300 K,
   dt 0.25 fs, skin 0.45, a record every 50 steps, 1,000 steps with the
   launch counts set to 0 just before and read just after. Checks finite
   records and no overflow, 16 f32-A matmul, 3 K3 and 3 K4 band launches
   per force call (no full search, act-quant, KV write or decode
   attention), one record segment under sync-debug "error" (no host
   sync), 0 missed edges over 100 audited steps, the skin list against a
   fresh list every step over 40 steps (1e-4 of the largest |value| on
   coordinates and total energy) and the card against the CPU plain path
   over 20 steps: in fp32 mode to 1e-4 on both, in w4a8 with MDDQ off to
   1e-4 on coordinates and, on total energy, 1e-2 with every gap above
   1e-4 traced to A8 codes that moved (``md_a8_split``). Prints ms/step,
   steps/s, ns/day, the
   device busy and idle share of a step, the select-rebuild's device
   time, the rebuilds and the drift rate (reported, not gated). The
   record segment is captured per (replica batch, edge slots, length)
   before the counted run, which replays it; a replayed 10-step segment
   is held against three eager ones (coordinates, e_tot, temperature:
   bit for bit where the eager runs agree, else within twice their
   largest relative gap), a replayed segment also runs under
   sync-debug "error", the profiler's kernels over a replayed one-step
   segment equal its recorded 13/3/3/3, and ms/step and ns/day eager
   against replay are paired (eager, replay, replay, eager).
6. Serves online SO3 traffic through ``repro_torch.server`` at the
   paper's width (W4A8, MDDQ through the encode kernel, sparse path,
   buckets 16 and 32, 1,024 edge slots per molecule). Packs the engine
   into an artifact and loads it onto the card: every leaf byte for
   byte, smaller than fp32, one version tag over two saves, the loaded
   engine's results within 1e-6 of the source's (a larger gap is split
   by ``split_gap`` before it fails). Then replays 400 Poisson requests
   at 100 req/s (9-16 and 17-24 atoms, numpy seed 0) through
   ``MicroBatchScheduler`` (8 per flush, 10 ms deadline) over the loaded
   engine, with the guardrails marking and a LEE probe every 8th flush,
   and the launch counts set to 0 just before and read just after.
   Checks: every request resolves (no error, shed or non-finite flag),
   one trace each, no new shape after warmup, the launches the dispatch
   counts predict (16/25 f32-A matmuls, 3 K3 and 3 K4 per sparse/dense
   batch, probes' re-runs included, and no other kernel), the probes =
   flushes // 8, and 32 sampled requests within 1e-5 of direct
   ``infer_batch([g])`` (a larger gap must come with moved A8 or MDDQ
   codes on that request's rows: ``request_split``, also run once on a
   known flush). The largest flush of each bucket runs again with every
   kernel call held against its plain version on the inputs it was given
   (f32-A matmuls and K4 codes bit for bit, K3 to 1e-5). Prints latency
   percentiles, throughput, flush reasons and occupancy, the mean prep,
   dispatch and sync per flush, the device busy and idle share of the
   largest flush, and runs the serve CLI (``--workload so3 --server
   --artifact``) once, counted: the artifact's sparse path and MDDQ
   kernel carry over, so K1'/K2', K3 and K4 must launch.
7. Runs the cluster (``repro_torch.cluster``) and a checkpointed MD
   session (``repro_torch.sessions``) on the card at the paper's width:
   ``ClusterPool.from_tiers`` with two w4a8, one w8a8 and one fp32
   replica on cuda:0 (one stream each, guardrails marking, a 30 s stall
   watchdog), phase 6's serving config and traffic. First a burst of 200
   requests through one engine's scheduler and through the pool (what
   one interpreter sustains). Then, counted: the 400-request replay with
   a rolling ``swap_artifact`` of the w4a8 tier to an artifact of other
   weights (numpy seed 1) fired halfway and ``kill_replica(1,
   "in_flight")`` at three quarters, and beside it one MD session (phase
   5's system, 400 steps in chunks of 100, a record every 50, a
   checkpoint every 2 chunks). Checks: every request resolves (none shed,
   no quarantine or escalation), every result's version names the engine
   that ran it, the launches that each replica worker tallies by role
   (``flush:<tier>``, ``warmup:<tier>``, ``chunk:<tier>``) equal that
   role's prediction from the dispatches per (mode, path), the swapped
   engines' warmup runs and the session's force calls
   (``launches_per_forward``), and together the window's total (nothing
   else runs), the frames arrive once each in index order, the newest
   checkpoint restores with every digest verified, and 32 sampled
   requests equal direct calls on their version's engine (energies
   exactly, forces to 1e-5, a larger gap only with moved codes). Every
   kernel call is then held against its plain version at the path's own
   shapes: each tier's engine (w4a8 after the swap, w8a8, fp32) at a
   singleton flush of each bucket and at the replay's largest flush of
   each bucket, and one session step. Then three drills: resume (a fresh manager
   after the newest checkpoint is corrupted: the tail replays from the
   one before with its frame indices, e_tot within 1e-2 and any gap
   above 1e-4 traced to moved A8 codes), stall (a w4a8 replica stalled
   past the watchdog: quarantined, its requests resolved elsewhere, its
   engine cold-restarted on cuda:0 on probation) and escalation (a
   hair-trigger w4a8 replica's result re-run on w8a8, bit for bit equal
   to a direct w8a8 call under deterministic algorithms); and the serve
   CLI's cluster flags once, counted. Prints latency percentiles and
   req/s beside phase 6's, flushes per replica, warmup, the swap's pause
   and warmup per replica, the cold restart's seconds, the session's
   steps/s and ns/day, checkpoint seconds and the largest flush's device
   share, each beside the card's name and power limit.
8. Trains the SO3 force field on the card through
   ``repro_torch.training`` at the paper's width, as
   ``python -m repro_torch.training.pipeline --fast`` runs it, every
   step, evaluation batch, LEE force call and NVE segment through its
   captured program (``captured.Programs``, the reference's jitted
   programs; their captures and replays tallied by program and key, and
   each program required to replay: the evaluation batch in batches of
   EVAL_HOLD_BATCH, the pipeline's 32 test frames being one batch):
   first, before any capture, the host time of one eager full QAT step
   split by ``host_split`` (Python, the autograd engine, ATen and DTensor
   dispatch, K4's wrapper and checks, the final read); then the
   azobenzene MD set sampled on the card (96 + 32 frames, numpy seed 0;
   each frame a replay of the classical-MD frame program, captured once
   per (atom count, stride, dt), ``data.synthetic_md.FrameSampler``: that
   program replayed from one state against five eager runs of its body
   (``hold_step``), then SAMPLER_FRAMES-frame runs eager and replayed,
   timed paired, each replay's e_shift, e_scale, mean kinetic temperature
   and total-energy drift within SAMPLER_FACTOR times the SAMPLER_EAGER
   eager runs' largest gap of their median), fp32 15 epochs at batch 32, then gaq_w4a8 QAT (12-bit codebook) for 6
   epochs, 2 of them warm-up, with the LEE term over 2 rotations; then
   ``evaluate`` and ``lee_eval`` (4 x 4) of both, ``nve_eval`` (400
   steps) of gaq_w4a8, and the trained weights served through
   ``QuantizedEngine`` (w4a8, sparse, MDDQ kernel, bucket 32). Checks:
   finite losses and a falling fp32 loss; the launches of every counted
   window (K4 only: none in fp32 or a warm-up step, L x (1 + 2 x 2) per
   full QAT step, L per quantized evaluate batch and per force call, and
   13/3/3/3 per sparse dispatch when serving); one fp32 and one full QAT
   step on the card against the CPU, the QAT step with the CPU's codes
   and gates pinned (``qat_sites(pin=...)``): in float32 the loss to 1e-5
   / 1e-4 relative, and every gradient leaf to max(1e-4,
   F32_GRAD_FACTOR x the CPU's float32 spread on that leaf: the largest
   gap of N_JITTERS more runs of its step with the coordinates jittered
   by an ulp) of its largest |g| (float32 rounds
   some first-layer gradients by up to ~2e-3); the QAT step unpinned past
   those bounds only with A8 codes or clip gates or MDDQ codes that moved
   (``moved_qat_sites``); and both steps in float64 on both devices, the
   loss to 1e-5 / 1e-4 and every leaf to 1e-4;
   K4's codes against its plain version at the training batch (12,288
   vectors x 4,096 codewords) and at a LEE force call; the serving
   kernels at the served batch (``check_kernel_calls``); the parameter
   file bit for bit; the phase within 180 s. The captured programs
   against eager: per step kind (fp32, QAT warm-up, QAT full; the first
   training batch) and for a NVE_HOLD_STEPS-step NVE segment of the
   trained model, the program captured and replayed from one state
   against five eager runs of its body from it (``hold_step``: every
   output and state leaf bit for bit where the eager runs agree, else
   within twice their largest gap), its recorded launches (K4 0, 0, L x
   5 and L x (steps + 1)) against the profiler's over one replay, a
   replay under sync-debug "error", ms per step eager against replay
   (paired: eager, replay, replay, eager), the idle share of a replay,
   capture and instantiation seconds and graph-pool bytes; and
   ``evaluate`` (batches of EVAL_HOLD_BATCH) and ``lee_eval`` (4 x 4)
   captured against five eager runs of each. Prints ms per fp32, warm-up
   and full QAT step through ``train`` and paired, a full step's device
   busy and idle share, K4's device time at the training shape, the peak
   device memory, the MAEs in meV, the LEEs, the NVE drift and the
   served-vs-QAT gap (reported).
9. Runs the health plane (``repro_torch.obs``) over the served cluster.
   (a) The serve CLI over phase 6's artifact and traffic (400 Poisson
   requests at 100 req/s, numpy seed 0) with ``--tiers
   w4a8:2,w8a8:1,fp32:1 --guardrails --md-session 200`` and the JAX
   launcher's obs flags (``--metrics-out --trace-out --alerts-out
   --export-interval 1 --health-interval 0.5``), four times: the plane
   on, off, off, on. The first run with it on is counted and gated: its
   launches per replica role equal the prediction (as phase 7's), with
   K1'/K2', K3 and K4 launched and nothing else; the metrics file parses
   line by line as Prometheus text, holds the series the stock SLOs and
   detectors read that this configuration writes (the CLI arms no MD
   drift limit and no LEE probe, and a clean replay has no pool event)
   and counts the requests sent as submitted; the exporter did not miss
   an interval, the monitor did not miss a period (counted from its own
   step times: its first step within one interval of its thread's start,
   no gap from a step's end to the next step's start over the interval
   plus 0.25 s, a final step on stop), both raised nothing and evaluated
   without error; the trace file holds one trace per request and per session
   chunk and ``load_traces`` round-trips it; the Chrome timeline of the
   traces, the flush records and the warmup records passes
   ``validate_chrome_trace``; the alerts file holds exactly the alerts
   the bus published (reported, not gated). (b) The chaos drill, the
   card's twin of ``tests/test_obs_health.py``'s chaos replay at the
   paper's width: a 4-replica pool under ``HealthMonitor``,
   ``SLOEvaluator`` and ``AnomalyMonitor``; the clean arm fires nothing;
   the chaos arm (pinned requests on hair-trigger w4a8 replicas, an
   in-flight kill, a stall past a timeout of ten times phase 7's longest
   flush, an MD session with ``drift_limit=1e-12``) fires the five
   required alerts and nothing outside them and the detectors, the pool
   sees them, and its exposition holds every series the catalogue reads.
   Prints p50/p95/p99 and req/s per run, the threads' CPU seconds, the
   files' bytes and the phase's seconds (within 120 s).
10. Runs the dense LM's prefill (``launch/steps.make_prefill_step`` over
   ``models/lm/transformer.forward``: the q-chunked causal attention in
   plain PyTorch, as the reference's jnp) and decodes from it. (a) Phase
   4's qwen2-0.5b (24 layers, serve_w8a8, bf16) prefills 8 x 1,024 random
   tokens (torch seed 10), counted: no kernel of the port launches; the
   logits with the config's query block (1,024) and with 128 agree bit
   for bit (PREFILL_CHUNK_TOL = 0). Prints the prefill's ms (median of 5, host clock),
   tokens/s, peak device memory, its bound by operations (the products
   of ``prefill_work`` at 989 TFLOP/s bf16) and one profiled prefill's
   device busy, idle share and ten longest kernels. (b) The first 160 of
   those tokens decode teacher-forced: in float32 with no kv_quant (no
   kernel launches) within 5e-3 of the largest |logit| of the float32
   prefill; in bf16 through the int8 cache, counted: K5' and K6 launch
   160 x 24 times each and nothing else, every call held against its
   plain version as it runs (the KV write byte for byte over the layer's
   cache, K6 within 1e-5), and the logits within PREFILL_INT8KV_TOL of the
   bf16 prefill's (the share of equal argmaxes printed). (c) qwen1.5-110b,
   nemotron-4-15b, chameleon-34b and musicgen-large at their published
   widths, one layer deep (serve_w8a8, int8 KV, bf16; weights drawn on the
   card with ``init_lm``'s tree and scales), each freed before the next: a
   2 x 256 prefill from tokens or from patch and frame embeddings, the
   prompt decoded into the cache, then 16 decode steps counted (K5' and K6
   16 times each, every call held against its plain version at the
   config's shapes: G 8 and 6 at hd 128, G 1 over 32 KV heads at hd 64),
   16 more timed. Prints the bytes, the prefill's ms, ms per decode step
   and K6's device us per call. (d) The int4 cache (qwen2's smoke config,
   float32) decodes 8 steps on the card and on the CPU within 1e-4, with
   no kernel launched. The phase within 150 s; every number beside the
   card's name and power limit.
11. Trains the dense LM (``launch/train.py`` -> ``steps.make_train_step``
   -> ``lm_loss`` -> ``ef_compress`` -> ``AdamW``; no kernel of the port is
   on this path, as none of the reference's is). (a0) The launcher's step
   as ``train.main`` builds it (``make_body``; qwen2-0.5b at full width
   and depth, qat_w4a8 with ef8, DTensors on the local (1, 1) NCCL mesh),
   before any capture: the host time of one eager step split by
   ``host_split``; then its program (``captured.Programs``) held against
   five eager runs from one state (the loss and every new parameter, as
   phase 8's steps), no kernel of the port in the profile of one replay,
   a replay under sync-debug "error", ms per step eager against replay
   (paired), the idle share of a replay and of an eager step (the
   replay's device busy, the same kernels, over each one's host time),
   capture and instantiation seconds, graph-pool bytes and peak device
   memory. (a) ``train.main`` in
   this process, as a user calls it: qwen2-0.5b at full width and depth
   (24 layers, d_model 896, vocab 151,936, tied; bf16 activations,
   float32 parameters), ``--steps 20 --batch 8 --seq 256 --quant qat_w4a8
   --grad-compression ef8``, counted: every kernel's launches 0, every
   logged loss finite, the launcher's own last < first, the final
   checkpoint restored with every digest verified and its ``extra["loss"]``
   the last loss, no data thread left, the step captured once and
   replayed at every later step. Prints ms per step from the
   launcher's clock (steps 10 to 19), tokens/s, peak device memory, one
   profiled ``make_train_step`` call (device busy, idle share, the ten
   longest kernel groups) and the step's bound (``train_work``: three
   times the forward's products at 989 TFLOP/s bf16, against the bytes of
   the parameters, the moments and the residual read and written once);
   then 10 plain steps (``--quant none``) for the plain step's ms. (b) One
   launcher step (``tools/lm_train_gap.launcher_step``) at qwen2-0.5b's
   width, two layers deep, float32, B=2, S=64, weights from numpy seed 0,
   the batch from ``synthetic_token_batches(seed=17)``, on the card and on
   the CPU: the loss within 1e-5 relative, every gradient leaf and every
   parameter after the update within max(1e-4, F32_GRAD_FACTOR x the
   CPU's own float32 spread on that leaf) of its largest |value|, the
   spread being the largest gap of N_JITTERS more CPU runs with the
   embedding table jittered by an ulp (phase 8's method), printed beside
   each bound; ``quant none`` (a second card run held to the same bounds:
   the embedding's backward sums repeated tokens with atomics), then
   qat_w4a8 with ef8, held with the CPU's quantization sites pinned on the
   card (the A8 and W4 x / scale and the error-feedback codes: a code
   that moves at a rounding tie moves its entry's first update by the
   whole learning rate; unpinned, a miss must come with moved A8 codes or
   gates, which are printed with the other sites'), and ``ef_compress``
   on the CPU's gradients bit for bit, card against CPU. (c) ``python -m repro_torch.launch.train --arch
   qwen2-0.5b --smoke --steps 200 --batch 4 --seq 64 --quant qat_w4a8
   --grad-compression ef8 --ckpt-every 10 --spmd-timeout 60`` as a
   subprocess, killed with SIGKILL once step 20 is checkpointed; the same
   command then prints ``[resume] restoring step N`` (N the newest valid
   step), finishes, and leaves step 199 valid with every digest verified
   and no ``step_*.tmp.*`` orphan. The phase runs with glibc's malloc
   told to serve every allocation from its heap and keep what is freed
   (``kept_heap``): (b)'s CPU steps at the full vocabulary and (a)'s
   checkpoints allocate and free tensors and buffers of half a gigabyte
   and more, and fresh pages for each cost more than the arithmetic.
   The phase within 180 s; every number beside the card's name and
   power limit.
12. Serves the MoE, Mamba2-hybrid and xLSTM families
   (``models/lm/{moe,ssm,xlstm}.py`` through ``transformer.py``; no
   kernel of the port is in these blocks, as none of the reference's is)
   at their published widths, bf16, weights drawn on the card with
   ``init_lm``'s tree and scales, each model freed before the next. (a)
   qwen3-moe-30b-a3b at full depth (48 layers, 128 experts top-8,
   serve_w8a8, int8 KV), drawn and quantized one layer at a time (its
   float32 experts would not fit): a 2 x 256 prefill (one routing group,
   C = 40) counted with no kernel, the prompt decoded into the cache, 16
   decode steps counted (K5' and K6 768 times each and nothing else,
   every call held against its plain version as in phase 10), 16 more
   timed; prints the bytes, peak memory, the prefill's ms, ms per decode
   step, one profiled prefill and decode step (device busy, idle share,
   the ten longest kernels), K6's device us and bound at its shape, and
   the share of choices the capacity dropped in the prefill and in a
   decode step; then the greedy decode of FAM_GREEDY tokens in the
   288-slot cache, replayed then eager (same tokens and caches, ms/step
   of each, no host sync under sync-debug "error"), as in phase 4, and
   one step replayed at position 287 (K6's multi-split device plan) on
   the decode's cache against the eager step there, counted: K5' and K6
   once per layer and nothing else (for every family below). (b)
   moonshot-v1-16b-a3b as (a), one layer deep (K5' and K6 16 times;
   K6's new shape G 1 at hd 128 held and timed). (c) zamba2-1.2b at full
   depth (19 groups of two Mamba2 blocks and the shared attention): as
   (a) but its 16 counted steps decode the first prompt tokens (the
   float32 check decodes the prompt), K5' and K6 304 times; then in
   float32 with no kv_quant the first
   64 prompt tokens decode teacher-forced within 5e-3 of the largest
   |logit| of the float32 prefill, no kernel launched. (d) xlstm-1.3b at
   full depth (6 groups of 7 mLSTM and 1 sLSTM blocks), quant none (the
   reference cannot serve it quantized): as (c) with no kernel and no
   profiled prefill, the float32 check of (c), and the sLSTM's share of
   the prefill. (e) The
   four smoke configs in float32 on the card and on the CPU: the prefill
   and 8 decode steps within 1e-4 of the largest |logit| (a MoE gap past
   it only with moved routing, printed, then held with the CPU's routing
   pinned: ``tools/moe_routing``). The phase within 180 s; every number
   beside the card's name and power limit.
13. Runs the distribution layer (``launch/{mesh,sharding,dryrun}.py``;
   no kernel of the port, as none of the reference's). (a) Phase 11
   (b)'s case (qwen2-0.5b's width, two layers, float32, B=2, S=64) as
   ``make_train_step(grad_specs=param_specs)`` on DTensor parameters
   placed by ``param_specs`` on the local (1, 1) NCCL mesh
   (``make_local_mesh``), under ``implicit_replication()``, counted,
   against the plain step: 0 launches of every kernel; the loss within
   1e-5 relative and every gradient and updated parameter within phase
   11 (b)'s bounds (the embedding's backward sums with atomics). Prints
   ms per step on the mesh and plain, paired in one call (plain, mesh,
   mesh, plain; DTensor's host cost on one card, ungated) and the first
   mesh step's seconds. (b) The updated parameters saved from the mesh
   and restored with ``restore(shardings=)``: every leaf a DTensor on
   its sharding's placements, equal to the saved one, every digest
   verified. (c) ``python -m repro_torch.launch.dryrun`` in one process
   per cell, all started together, each on a fake process group of 256
   or 512 ranks with meta shards: cells whose step DTensor propagated on
   the card's torch before the dry run resharded, musicgen-large
   train_4k (fsdp), moonshot-v1-16b-a3b prefill_32k (fsdp) and
   zamba2-1.2b long_500k (tp) on the single mesh and musicgen-large
   prefill_32k (zero3) on the multi mesh; and a tp cell for each class
   of DTensor's refusals there (``launch/reshard.py``): qwen2-0.5b
   decode_32k (14 heads split over 16) and musicgen-large decode_32k (a
   flatten of a sharded dim) on the single mesh, llama3.2-3b decode_32k
   (the embedding's ``aten.index`` on the 3-D mesh) on the multi mesh,
   and zamba2-1.2b train_4k under cp on the single mesh (the conv's
   pad, whose rule places its output off the mesh and then fails the
   redistribute planner; its tp cells take over 100 s). Each
   exits 0 and writes its record without ``"error"``, whose keys are the
   JAX dry run's record's (read from its source); each of the last four
   logs at least one reshard, and its reshards' collective bytes and
   counts lie inside its record's. Prints each record's per-device
   argument bytes, counted FLOPs against ``analytic_flops`` per device,
   collective bytes by kind and its reshards. (d) While (c) runs, in
   this process on the card's torch: the dry run's scan charging
   (``models/lm/scan.py``) against the full loop on xlstm's smoke config
   at S = 32 on a 2 x 2 fake mesh under tp, prefill_32k and train_4k
   (``tests/test_torch_scan.py``'s check): the records equal key for key
   on FLOPs, collective bytes and counts, argument and output bytes and
   the reshard totals, temp and peak bytes within one sLSTM step's (32
   B d); prints each pass's steady step k, S and the steps charged. The
   phase within 150 s; every number beside the card's name and power
   limit.
14. Runs the five examples' twins (``examples/*_torch.py``) on the card
   at reduced sizes (EXAMPLE_ARGS), each in a process of its own, all
   started together, each process counting the port's kernel launches
   (``kernel_counters``) around the twin's ``main``. Each must exit 0
   and print its key lines (EXAMPLE_LINES). The two twins that run a
   launcher in a child process (the serve CLI, the LM trainer) launch
   nothing in their own process, so the serve CLI's ``main`` also runs
   here, counted, with the twin's argument lists. Over the phase the
   f32-A W8A8 and W4A8 matmuls, the edge softmax, the KV write and the
   int8-KV decode attention must each have launched. The phase within
   EXAMPLES_PHASE_S.

Phase 2 also holds the act-quant kernel bit for bit (float32 and bf16),
its KV entry (the decode's whole int8 KV write) byte for byte over a
stacked cache at an int position and at a position read from device
memory, and the int8-KV decode attention to 1e-5 against their plain
versions,
the latter timed at 2,048 of 2,048 tokens and at the decode's 64 of
1,024, beside SDPA's event and device times in float32 and bf16, and
with a device position (the grid sized from S) at the decode's shape
(n_valid 1, 64, 1,024 of 1,024) and at hd 128, G 8 (8 and 16 rows, S 288
and 1,024), both entries' device us beside ``k6_bound``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that. Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12

M_ROWS = 256                 # 8 molecules x 32-atom bucket
LM_BATCH, LM_CACHE, LM_TOKENS = 8, 1024, 64
LM_FORCED_STEPS = 8
# device events of one profiled decode step at commit 867c120, before the
# KV write became one launch per layer (this script there, on an NVIDIA
# H100 80GB HBM3 at 700 W)
LM_STEP_EVENTS_BEFORE = 2507
# teacher-forced logits, kernels against plain versions, over the largest
# |logit|: the act-quant kernel is bit for bit, the attention kernel sums
# in another order (~1e-7), and the bf16 cast of its output turns such a
# difference into a one-ulp flip now and then, which 24 layers of random
# weights carry on (1.4e-2 measured on an H100; with float32 activations
# the same comparison is held to 1e-4)
LM_KERNEL_TOL = 5e-2
# phase 5: benchmarks/md_bench.py's system (make_molecule(24, ...,
# density 0.1, seed 24), carbon masses, 300 K, dt 0.25 fs, skin 0.45,
# a record every 50 steps) tiled into 8 replicas, 1,000 steps
MD_ATOMS, MD_DENSITY, MD_SEED, MD_REPLICAS = 24, 0.1, 24, 8
MD_MASS, MD_TEMPERATURE, MD_DT_FS, MD_SKIN = 12.011, 300.0, 0.25, 0.45
MD_RECORD_EVERY, MD_STEPS = 50, 1000
# the capacity MDEngine.init_state sizes for this system (552 listed
# edges x 1.3, clamped to the complete graph's 576, rounded to 128)
MD_EDGE_CAPACITY = 640
MD_PAIRED_STEPS = 100        # per timed run, eager against replay
# the whole run's limit: the caller allows 1,200 s, builds included
WATCHDOG_S = 1100
# phase 6: Poisson traffic over two buckets through the scheduler; 100
# req/s is 30-50% of the full-batch rate that phase 3's 22.6-37.9 ms per
# 8-molecule batch allows
SERVER_BUCKETS, SERVER_RATE, SERVER_REQUESTS = (16, 32), 100.0, 400
# sampled requests held against direct single-molecule calls, to this
# share of the largest |value| (a larger gap must come with moved codes)
SERVER_SAMPLE, SERVER_TOL = 32, 1e-5
# phase 7: the tiered fleet on one card; a replica busy on one unit of
# work past CLUSTER_STALL_S is stalled (above the longest MD chunk: 100
# steps of host-bound work); the session is phase 5's system, 400 steps
CLUSTER_TIERS = {"w4a8": 2, "w8a8": 1, "fp32": 1}
CLUSTER_STALL_S, CLUSTER_PROBATION_S = 30.0, 5.0
SESSION_STEPS, SESSION_CHUNK, SESSION_CKPT_EVERY = 400, 100, 2
# a replayed w4a8 session frame against its first emission, over the
# largest |e_tot|: held to 1e-2, and a gap above REPLAY_TRACE is traced
# to moved A8 codes (md_a8_split)
REPLAY_TRACE = 1e-4
# phase 8: the training pipeline's --fast run (training/pipeline.py): 96
# training and 32 test frames of the azobenzene MD set (numpy seed 0),
# batch 32; fp32 15 epochs, then gaq_w4a8 (12-bit codebook) 6 epochs, 2 of
# them warm-up; NVE 400 steps; the phase's limit in seconds
TRAIN_FRAMES, TEST_FRAMES, TRAIN_BATCH = 96, 32, 32
FP32_EPOCHS, QAT_EPOCHS, QAT_WARMUP, NVE_STEPS = 15, 6, 2, 400
TRAIN_PHASE_S = 180.0
# the captured programs against eager: an NVE segment of NVE_HOLD_STEPS,
# evaluate in batches of EVAL_HOLD_BATCH (a replay after the first)
NVE_HOLD_STEPS, EVAL_HOLD_BATCH = 10, 8
# the classical-MD sampler (data.synthetic_md): its frame program (40
# steps) replayed from one state against five eager runs; then
# SAMPLER_FRAMES-frame runs, eager and replayed (paired: eager, replay,
# replay, eager, then SAMPLER_EAGER - 2 more eager runs), whose
# statistics (e_shift, e_scale, mean kinetic temperature, total-energy
# drift) each replay holds within SAMPLER_FACTOR times the eager runs'
# largest gap of their median: the trajectory is chaotic and the forces'
# backward sums with atomics, so runs part after some frames. With five
# independent eager runs a sixth run misses 4x their range about once in
# 600 per statistic (a normal model)
SAMPLER_FRAMES, SAMPLER_EAGER, SAMPLER_FACTOR = 32, 5, 4.0
# a float32 gradient leaf of the card's step lies within F32_GRAD_FACTOR
# times the CPU's float32 spread on it, or 1e-4 (gaps to the CPU's
# float32 step over the leaf's largest |g|; the spread is the largest gap
# of N_JITTERS more CPU runs with the coordinates jittered by an ulp, the
# QAT step's sites pinned). A further jittered run needed at most 2.46 of
# that spread in 36 probes (fp32 and QAT steps, six data seeds, spreads
# up to 1.82e-3: python -m repro_torch.tools.so3_grad_conditioning 0 1 2
# 3 4 5)
F32_GRAD_FACTOR = 8.0
# phase 9: the serve CLI with the JAX launcher's obs flags over phase 6's
# artifact and traffic (the tiered fleet and an MD session beside it),
# the health plane on and off in turns (the first run with it on is
# counted and gated); then the chaos drill; the phase's limit in seconds
HEALTH_TIERS = "w4a8:2,w8a8:1,fp32:1"
HEALTH_REQUESTS, HEALTH_SESSION_STEPS = 400, 200
HEALTH_EXPORT_S, HEALTH_EVAL_S = 1.0, 0.5
# the monitor's wait may wake this late behind the serving threads (the
# GIL): a gap from one step's end to the next step's start above
# HEALTH_EVAL_S + HEALTH_GAP_SLACK_S is a missed period
HEALTH_GAP_SLACK_S = 0.25
HEALTH_ORDER = ("on", "off", "off", "on")
HEALTH_PHASE_S = 120.0
# phase 10: phase 4's model prefills B x S random tokens (torch seed 10)
# with its own attn_chunk_q (1,024: one query block) and with
# PREFILL_CHUNK; then decodes the first PREFILL_FORCED of them
# teacher-forced (in float32 with no kv_quant, and in bf16 with the int8
# cache through K5' and K6); the four other dense configs at their
# published widths, one layer deep, prefill NEW_BATCH x NEW_SEQ and decode
# NEW_DECODE steps after their prompt; the int4 cache decodes INT4_STEPS
PREFILL_BATCH, PREFILL_SEQ, PREFILL_CHUNK, PREFILL_REPS = 8, 1024, 128, 5
PREFILL_FORCED = 160
NEW_ARCHS = ("qwen1.5-110b", "nemotron-4-15b", "chameleon-34b",
             "musicgen-large")
NEW_BATCH, NEW_SEQ, NEW_DECODE, INT4_STEPS = 2, 256, 16, 8
# over the largest |logit|. Chunk invariance: bit for bit, as on the CPU
# (python -m repro_torch.tools.lm_prefill_gap: qwen2-0.5b's width at 1 to
# 12 layers, B=2, S=160, chunk 160 vs 20: 0 at every depth) and on the
# card at this phase's shapes (0 in each run so far, PERF.md section 6):
# every row meets the same products, and a gap of any size would be a
# blocking or masking fault. The float32 decode against the prefill:
# tests/test_lm_correctness.py::TestDecodeConsistency's 5e-3. The bf16
# int8-KV decode against the bf16 prefill: 6e-2, the bf16 bound of the
# decode tests, 2.4x the CPU plain path's largest gap for the same
# comparison at qwen2-0.5b's width, B=2, S=160 (the same tool: 1.63, 2.11,
# 2.37, 2.29, 2.45% at 1, 2, 4, 8, 12 layers; it levels off)
PREFILL_CHUNK_TOL, PREFILL_F32_TOL, PREFILL_INT8KV_TOL = 0.0, 5e-3, 6e-2
PREFILL_PHASE_S = 150.0
# phase 11: the training launcher at qwen2-0.5b's full width and depth
# with its default batch and sequence, LM_TRAIN_STEPS steps in qat_w4a8
# with ef8 and LM_PLAIN_STEPS plain steps beside them; one launcher step
# on the card against the CPU (repro_torch.tools.lm_train_gap's config:
# 2 layers, B=2, S=64, float32), each leaf within max(1e-4,
# F32_GRAD_FACTOR x the CPU's spread over N_JITTERS runs with the
# embedding table jittered by an ulp, the QAT step's sites pinned:
# phase 8's method and factor; on the LM a further jittered run needed at
# most 2.88 of that spread, gradients and updated parameters, seeds 0-2
# of the same tool); the kill and resume drill; the phase's limit in
# seconds (the qat steps cut from 30 to 20 to keep the phase inside it on
# the slower hosts of the card machines)
LM_TRAIN_STEPS, LM_PLAIN_STEPS = 20, 10
# (c)'s run: a replayed smoke step takes milliseconds, so the kill may land
# a few checkpoints past step 20; the resumed run must still log two
# losses or more for the launcher's own check that its loss fell
LM_RESUME_STEPS = 200
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 256
LM_TRAIN_PHASE_S = 180.0
# phase 12: the MoE, Mamba2-hybrid and xLSTM families at their published
# widths, in bf16 (serve_w8a8 with the int8 KV cache; xlstm with quant
# none, since the reference cannot serve it quantized), each freed
# before the next: FAM_ARCHS at full depth but FAM_DEPTH's; each prefills
# FAM_BATCH x FAM_SEQ random tokens (one MoE routing group), decodes (MoE:
# after its prompt, decoded into the cache) FAM_DECODE steps counted
# (every K5' and K6 call held against its plain version) and FAM_DECODE
# more timed; zamba2 and xlstm then decode their first FAM_FORCED tokens
# teacher-forced in
# float32 (no kv_quant) within FAM_F32_TOL of the largest |logit| of the
# float32 prefill (tests/test_lm_correctness.py::TestDecodeConsistency's
# 5e-3); the four smoke configs prefill FAM_SMOKE_SEQ tokens and decode
# FAM_SMOKE_STEPS teacher-forced on the card and on the CPU in float32,
# within FAM_CARD_TOL of the largest |logit| (phase 10 (d)'s 1e-4; MoE:
# a larger gap only with moved routing, printed, then held with the
# CPU's routing pinned: tools/moe_routing)
FAM_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "zamba2-1.2b",
             "xlstm-1.3b")
FAM_DEPTH = {"moonshot-v1-16b-a3b": 1}
FAM_BATCH, FAM_SEQ, FAM_DECODE, FAM_FORCED = 2, 256, 16, 64
FAM_SMOKE_SEQ, FAM_SMOKE_STEPS = 32, 8
FAM_CARD_TOL, FAM_F32_TOL = 1e-4, 5e-3
FAM_PHASE_S = 180.0
FAM_GREEDY = 6               # tokens per greedy decode, replay against eager
# phase 13: the distribution layer. (a) phase 11 (b)'s case on the local
# (1, 1) NCCL mesh against the plain step, timed DIST_TIMING_REPS times
# each in turns; (c) the dry run (launch/dryrun.py) of DRYRUN_CELLS, one
# process each, under the tag DRYRUN_TAG, within DRYRUN_TIMEOUT_S; the
# phase's limit in seconds
DIST_TIMING_REPS = 5
# (arch, shape, mesh, policy): cells whose step DTensor propagated on the
# card's torch (2.11) before the dry run resharded where it refuses; then
# DRYRUN_RESHARD_CELLS, a cell for each class of DTensor's tp refusals
# there (the class it stands for; zamba2's tp cells of its class take
# 105-377 s at 8 processes, so its cp train cell, which the same rule
# refuses, stands in: 83-92 s), each of which must go through after at
# least one reshard (launch/reshard.py) whose collectives its record
# counts
DRYRUN_CELLS = (("musicgen-large", "train_4k", "single", "fsdp"),
                ("moonshot-v1-16b-a3b", "prefill_32k", "single", "fsdp"),
                ("zamba2-1.2b", "long_500k", "single", "tp"),
                ("musicgen-large", "prefill_32k", "multi", "zero3"))
DRYRUN_RESHARD_CELLS = {
    ("qwen2-0.5b", "decode_32k", "single", "tp"):
        "a view splitting a sharded dim into heads",
    ("musicgen-large", "decode_32k", "single", "tp"):
        "a flatten of a sharded dim",
    ("llama3.2-3b", "decode_32k", "multi", "tp"):
        "aten.index on the 3-D mesh",
    ("zamba2-1.2b", "train_4k", "single", "cp"):
        "the pad's rule off the mesh (the redistribute planner's "
        "IndexError)"}
DRYRUN_ALL = DRYRUN_CELLS + tuple(DRYRUN_RESHARD_CELLS)
DRYRUN_TAG, DRYRUN_TIMEOUT_S = "chip_smoke", 120.0
# (d): the scan's charging against the full loop, in this process: xlstm's
# smoke config at S = SCAN_SEQ (its ssm_chunk) on a SCAN_MESH fake mesh,
# one prefill and one train cell
SCAN_CELLS = (("prefill_32k", "tp"), ("train_4k", "tp"))
SCAN_SEQ, SCAN_MESH = 32, (2, 2)
DIST_PHASE_S = 150.0
# phase 14: the examples' twins, their size flags on the card, the lines
# each must print (regular expressions, each at least the given times),
# the kernels the phase must launch, and the phase's limit in seconds
EXAMPLE_ARGS = {
    "quickstart": [],
    "train_so3krates_qat": ["--epochs", "15", "--qat-epochs", "4"],
    "md_stability": ["--steps", "1000", "--epochs", "15"],
    "serve_quantized_lm": [],
    "train_lm_distributed": ["--steps", "40"],
}
EXAMPLE_LINES = {
    "quickstart": [(r"\(100% within\)", 1), (r"^quickstart OK$", 1)],
    "train_so3krates_qat": [
        (r"^fp32: E-MAE [\d.]+ meV, F-MAE [\d.]+ meV/A$", 1),
        (r"^GAQ W4A8: E-MAE [\d.]+ meV, F-MAE [\d.]+ meV/A, LEE [\d.]+ "
         r"meV/A$", 1),
        (r"^naive INT8: E-MAE [\d.]+ meV, F-MAE [\d.]+ meV/A, LEE [\d.]+ "
         r"meV/A$", 1)],
    "md_stability": [(r"device=cuda:0", 1), (r"blew_up=False", 1),
                     (r"^served vs fp32 forces on 8 test frames: MAE ", 1),
                     (r"^served-model LEE: mean ", 1)],
    "serve_quantized_lm": [(r"device=cuda:0$", 4),
                           (r"^decode: [\d.]+ tok/s", 3),
                           (r"^served-model LEE: mean ", 1)],
    "train_lm_distributed": [(r"^step +\d+ loss [\d.]+", 5),
                             (r"^done: first loss [\d.]+ -> last [\d.]+$",
                              1)],
}
EXAMPLE_KERNELS = ("w8a8_matmul_f32a", "w4a8_matmul_f32a",
                   "edge_softmax_fused", "kv_append_int8",
                   "decode_attention_int8kv")
EXAMPLES_PHASE_S = 150.0
TRUNK_W8 = (64, 192)         # wq | wk | wm
TRUNK_W4 = (64, 32)          # wa | wb
OTHER_W8 = {"w_upd": (64, 64), "w_vnorm": (16, 64), "ro_w1": (80, 64),
            "ro_w2": (64, 1)}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(torch, fn, reps: int = 20, rounds: int = 11) -> float:
    """Median over ``rounds`` of CUDA-event time for ``reps`` calls, per
    call (warmed up first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _device_rows(torch, prof):
    """(ms, count, name) of the device-side events of a profile (kernels,
    copies), longest first: the host ops that launch them carry the same
    device time again, so only these are summed."""
    from torch.autograd import DeviceType
    rows = [(_device_us(e) / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted((r for r in rows if r[0] > 0), reverse=True)


def device_profile(torch, fn, reps: int = 20):
    """(device ms per call, device kernels per call) of what ``fn``
    launches, from torch.profiler. Every call launches the same kernels,
    so a profile whose device events are not a whole number per call lost
    some (seen once on the card: 2 events for 20 calls of one kernel) and
    is taken again, as is one with no device time (also seen once); after
    three such profiles the last one's numbers are returned, or (None, 0)
    when it recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = _device_rows(torch, prof)
        total = sum(r[0] for r in rows)
        events = sum(r[1] for r in rows)
        if total > 0 and events % reps == 0:
            break
    if total == 0:
        return None, 0
    return total / reps, events / reps


def device_ms(torch, fn, reps: int = 20):
    """Device time per call of what ``fn`` launches (torch.profiler);
    None when the profiler records no device time."""
    return device_profile(torch, fn, reps)[0]


def queued_device_ms(torch, fn, reps: int = 50) -> float:
    """Device time per call of what ``fn`` launches: CUDA events around
    ``reps`` calls enqueued behind a sleep kernel, so the device runs
    them back to back whatever the host's launch gaps (warmed up first;
    the ~10 ms sleep covers 50 enqueues of a few tens of us each)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, ops_per_s: float,
          fp32_ops: float = 0.0):
    """The card's least time (ms) for the work: the larger of the bytes
    over the memory rate and the operations over their types' peak rates
    (``fp32_ops`` beside ``n_ops`` at ``ops_per_s``), and which it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / ops_per_s + fp32_ops / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_resources(log: str):
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared bytes) for every kernel in ptxas's report (``-Xptxas -v``)."""
    import re
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = _demangle(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:, (?:used \d+ barriers, )?"
                      r"(\d+) bytes smem)?", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills,
                        int(m.group(2) or 0)))
            name = None
    return out


def _demangle(sym: str) -> str:
    """``decode_kernel<64,8>`` or ``kv_append_kernel<float,64>`` from an
    Itanium-mangled kernel name in an anonymous namespace
    (``_ZN<n>_GLOBAL__N_...<n>name[I...E]...``); the symbol itself when it
    does not parse."""
    import re
    pos, parts = 3, []
    while sym.startswith("_ZN") and len(parts) < 2:
        m = re.match(r"\d+", sym[pos:])
        if not m:
            break
        n = int(m.group(0))
        parts.append(sym[pos + m.end():pos + m.end() + n])
        pos += m.end() + n
    if len(parts) < 2 or "_GLOBAL__N" not in parts[0]:
        return sym
    if not sym.startswith("I", pos):
        return parts[1]
    # template arguments: literals (Li64E, Lb1E), builtin types (f),
    # named types (13__nv_bfloat16)
    args, pos = [], pos + 1
    builtin = {"f": "float", "i": "int", "b": "bool"}
    while pos < len(sym) and sym[pos] != "E":
        lit = re.match(r"L[a-z](-?\d+)E", sym[pos:])
        named = re.match(r"\d+", sym[pos:])
        if lit:
            args.append(lit.group(1))
            pos += lit.end()
        elif named:
            n = int(named.group(0))
            args.append(sym[pos + named.end():pos + named.end() + n])
            pos += named.end() + n
        elif sym[pos] in builtin:
            args.append(builtin[sym[pos]])
            pos += 1
        else:
            return parts[1]
    return f"{parts[1]}<{','.join(args)}>"


def make_molecule(n_atoms, n_species, density, seed):
    """``benchmarks/md_bench.py``'s molecule: n atoms uniform in a cube
    of n / density cubic Angstrom, random species."""
    rng = np.random.default_rng(seed)
    side = (n_atoms / density) ** (1.0 / 3.0)
    return (rng.integers(0, n_species, n_atoms).astype(np.int32),
            rng.uniform(0, side, size=(n_atoms, 3)).astype(np.float32))


# --- phase 2: kernels against their plain versions ---------------------------

def check_quant_matmul(torch, dev, gen):
    """K1/K2 through both entries at every product shape of the serving
    path: the int8-A entries (the TPU kernels' contract) against the plain
    matmul, the f32-A entries (the A8 step in the same launch, the main
    path) against ``act_quant_ref`` followed by it, each bit for bit, with
    an all-zero row (scale 1e-8 / 127). Timed at the trunk shapes, with one
    device kernel per call required, beside ``torch._int_mm`` + scales."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant_matmul import (w4a8_matmul,
                                                  w4a8_matmul_f32a,
                                                  w8a8_matmul,
                                                  w8a8_matmul_f32a)
    rows = {}
    shapes = [("trunk_w8", *TRUNK_W8, False), ("trunk_w4", *TRUNK_W4, True)]
    shapes += [(name, k, n, False) for name, (k, n) in OTHER_W8.items()]
    for name, k, n, w4 in shapes:
        x = torch.randn(M_ROWS, k, generator=gen, device=dev)
        x[0] = 0.0
        w = torch.randn(k, n, generator=gen, device=dev)
        a_q, a_s = ops.quantize_activations(x)
        w_q, w_s = ops.prepare_w4(w) if w4 else ops.prepare_w8(w)
        plain = ref.w4a8_matmul_ref if w4 else ref.w8a8_matmul_ref
        cases = (
            (w4a8_matmul if w4 else w8a8_matmul, (a_q, a_s, w_q, w_s),
             lambda: plain(a_q, a_s, w_q, w_s), M_ROWS * k + 4 * M_ROWS),
            (w4a8_matmul_f32a if w4 else w8a8_matmul_f32a, (x, w_q, w_s),
             lambda: plain(*ref.act_quant_ref(x), w_q, w_s), 4 * M_ROWS * k))
        for kern, args, plain_fn, a_bytes in cases:
            got = kern(*args)
            want = plain_fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            print(f"  {kern.__name__} {name} M={M_ROWS} K={k} N={n}: "
                  f"bit-identical={torch.equal(got, want)} max_abs_err={err}")
            require(torch.equal(got, want),
                    f"{kern.__name__} {name} differs from its plain version")
            row = rows.setdefault(kern.__name__, {
                "name": kern.__name__, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
                "replaces": ("src/repro/kernels/quant_matmul.py:119" if w4
                             else "src/repro/kernels/quant_matmul.py:83"),
                "max_abs_err": 0.0, "library_ms": None})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not name.startswith("trunk"):
                continue
            fn = lambda: kern(*args)                     # noqa: E731
            dev_ms, per_call = device_profile(torch, fn)
            require(dev_ms is None or per_call == 1,
                    f"{kern.__name__} ran {per_call} kernels per call")
            w_bytes = k * n // 2 if w4 else k * n
            n_bytes = a_bytes + w_bytes + 4 * n + 4 * M_ROWS * n
            b_ms, b_by = bound(n_bytes, 2 * M_ROWS * n * k, INT8_OPS_PER_S,
                               fp32_ops=4 * M_ROWS * k
                               if kern.__name__.endswith("f32a") else 0)
            row.update(ms=time_ms(torch, fn), device_ms=dev_ms,
                       device_kernels_per_call=per_call,
                       plain_ms=time_ms(torch, plain_fn), bound_ms=b_ms,
                       bound_by=b_by, shape=f"M={M_ROWS} K={k} N={n}")
            if kern is w8a8_matmul:
                lib = lambda: (torch._int_mm(a_q, w_q)          # noqa: E731
                               .to(torch.float32) * a_s * w_s)
                row.update(library_ms=time_ms(torch, lib),
                           library_device_ms=device_ms(torch, lib),
                           library="torch._int_mm + the two scales")
    return list(rows.values())


def serving_edge_list(graphs, cutoff):
    """The edge list of the first 8-molecule batch the engine serves."""
    from repro_torch.serving import (BucketSpec, build_edge_list,
                                     pad_graphs, plan_batches)
    plan = plan_batches(graphs, [BucketSpec(32, max_batch=8,
                                            edge_capacity=1024)])[0]
    _, coords, mask = pad_graphs(graphs, plan)
    el = build_edge_list(coords, mask, cutoff, 1024)
    require(el is not None, "edge list overflowed its capacity")
    return el, plan.batch_size * 32


def every_pair_edge_list(cutoff):
    """Four 64-atom molecules inside one cutoff: every receiver has 63
    real edges, two of the kernel's 32-edge chunks."""
    from repro_torch.serving import build_edge_list
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, cutoff / 2, size=(4, 64, 3)).astype(np.float32)
    el = build_edge_list(coords, np.ones((4, 64), bool), cutoff, 4096)
    require(el is not None and el.n_real == 4 * 64 * 63,
            "the every-pair layout is not fully connected")
    return el, 4 * 64


def _edge_softmax_case(torch, dev, gen, s, r, m, n, cap, cfg, layout=None,
                       label=""):
    """K3 against its plain version on one edge list, given as device
    tensors (1e-5, empty receivers exactly 0), timed; ``layout`` is the
    list's layout mask when ``m`` is a refined subset of it. Returns
    (inputs, record)."""
    from repro_torch.core.attention_norm import l2_normalize
    from repro_torch.kernels.edge_softmax import edge_softmax_fused
    from repro_torch.kernels.ref import edge_softmax_ref
    F, W = cfg.feat, cfg.feat + 3 * cfg.vec_feat
    E = s.shape[0]
    q = cfg.tau * l2_normalize(torch.randn(n, F, generator=gen, device=dev))
    k = l2_normalize(torch.randn(n, F, generator=gen, device=dev))
    bias = torch.randn(E, generator=gen, device=dev)
    vals = torch.randn(E, W, generator=gen, device=dev)
    got = edge_softmax_fused(q, k, bias, vals, s, r, m, cap, layout)
    want = edge_softmax_ref(q, k, bias, s, r, m, vals, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    has_edge = torch.zeros(n, dtype=torch.bool, device=dev)
    has_edge[r[m].long()] = True
    n_empty = int((~has_edge).sum())
    empty_zero = bool((got[~has_edge] == 0).all())
    e_r = int(m.sum())
    shape = f"N={n} E={E} real={e_r} F={F} W={W}{label}"
    print(f"  edge_softmax {shape}: max_abs_err={err}, {n_empty} empty "
          f"receivers exactly 0: {empty_zero}")
    require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
            f"edge_softmax {shape} differs from its plain version by {err}")
    require(empty_zero, "edge_softmax: an empty receiver is not exactly 0")

    fn = lambda: edge_softmax_fused(q, k, bias, vals, s, r, m, cap,  # noqa
                                    layout)
    dev_ms, per_call = device_profile(torch, fn)
    require(dev_ms is None or per_call == 1,
            f"edge_softmax ran {per_call} kernels per call")
    n_bytes = 2 * n * F * 4 + e_r * (4 + 4 * W + 4 + 4 + 1) + n * W * 4
    b_ms, b_by = bound(n_bytes, e_r * (2 * F + 3 * W + 8), FP32_OPS_PER_S)
    record = {"ms": time_ms(torch, fn), "device_ms": dev_ms,
              "device_kernels_per_call": per_call,
              "plain_ms": time_ms(torch, lambda: edge_softmax_ref(
                  q, k, bias, s, r, m, vals, n)),
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
              "shape": shape}
    return (q, k, bias, vals, s, r, m), record


def _edge_list_tensors(torch, dev, el):
    return [torch.from_numpy(a).to(dev)
            for a in (el.senders, el.receivers, el.edge_mask)]


def md_refined_edge_list(torch, dev, cfg):
    """Phase 5's skin list (8 replicas of md_bench's 24-atom molecule,
    ``device_edge_list`` at cutoff + skin, 640 slots each) at coordinates
    moved by up to skin/2 per atom, refined to the cutoff (the MD step's
    mask, holes inside the receivers' runs) and, as a harder case, to half
    the cutoff; three receivers have every listed edge masked. Returns
    ((senders, receivers, layout), [(refined mask, label)], nodes)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.bucketing import device_edge_list
    _, coords = make_molecule(MD_ATOMS, cfg.n_species, MD_DENSITY, MD_SEED)
    coords = np.tile(coords, (MD_REPLICAS, 1, 1))
    rng = np.random.default_rng(1)
    step = rng.normal(size=coords.shape)
    step *= rng.uniform(0, MD_SKIN / 2, size=coords.shape[:2] + (1,)) \
        / np.linalg.norm(step, axis=-1, keepdims=True)
    mask = torch.ones((MD_REPLICAS, MD_ATOMS), dtype=torch.bool, device=dev)
    s, r, layout, counts = device_edge_list(
        torch.from_numpy(coords).to(dev), mask, cfg.cutoff + MD_SKIN,
        MD_EDGE_CAPACITY)
    require(int(counts.max()) <= MD_EDGE_CAPACITY, "skin list overflowed")
    moved = torch.from_numpy((coords + step).astype(np.float32)).to(dev)
    emptied = torch.tensor([1, MD_ATOMS + 5, MD_REPLICAS * MD_ATOMS - 1],
                           dtype=torch.int32, device=dev)
    cases = []
    # at the cutoff this molecule is nearly a complete graph (its box's
    # diagonal is 10.5 A): the holes are the emptied receivers' and a few
    # pairs; at half the cutoff they are most of the list
    for cut, label, least in ((cfg.cutoff, "", 3 * 23),
                              (cfg.cutoff / 2, " at half the cutoff",
                               MD_REPLICAS * 100)):
        m = ops.refine_edge_mask(moved.reshape(-1, 3), s, r, layout, cut)
        m &= ~torch.isin(r, emptied)
        holes = int((layout & ~m).sum())
        require(holes >= least, f"{holes} holes refined at {cut} A")
        cases.append((m, f", refined skin list{label}, {holes} holes"))
    return (s, r, layout), cases, MD_REPLICAS * MD_ATOMS


def check_edge_softmax(torch, dev, gen, graphs, cfg):
    """K3 at the serving batch's layout (and its backward), at the
    every-pair layout (63 edges per receiver) and at MD's refined skin
    list (holes inside receivers' runs, emptied receivers)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import edge_softmax_ref
    el, n = serving_edge_list(graphs, cfg.cutoff)
    (q, k, bias, vals, s, r, m), serving = _edge_softmax_case(
        torch, dev, gen, *_edge_list_tensors(torch, dev, el), n, 32, cfg)
    W = vals.shape[1]

    # the Function's backward against plain autograd, both fed one output
    # cotangent: a loss such as sum(out**2) would also feed the backward
    # the two forwards' 1e-7 differences, which the tau-scaled logits
    # amplify past 1e-5 on gradients of size ~150 (seen on the card).
    # Both backwards sum with index_add, on atomics; deterministic
    # algorithms give both one summation order.
    g_out = torch.randn(n, W, generator=gen, device=dev)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, bias, vals)]
        return torch.autograd.grad(fn(*ins), ins, g_out)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g_ker = grads(lambda q_, k_, b_, v_: ops.edge_softmax(
            q_, k_, b_, v_, s, r, m, cap=32))
        g_ref = grads(lambda q_, k_, b_, v_: edge_softmax_ref(
            q_, k_, b_, s, r, m, v_, n))
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    for name, a, b in zip(("q", "k", "bias", "values"), g_ker, g_ref):
        require(torch.allclose(a, b, rtol=1e-4, atol=1e-5),
                f"edge_softmax gradient wrt {name} off by "
                f"{float((a - b).abs().max())}")
    print("  edge_softmax gradients (autograd.Function vs plain autograd, "
          "one cotangent): within 1e-4 rel / 1e-5 abs")

    el_all, n_all = every_pair_edge_list(cfg.cutoff)
    _, every_pair = _edge_softmax_case(
        torch, dev, gen, *_edge_list_tensors(torch, dev, el_all), n_all, 64,
        cfg)
    (s_md, r_md, layout), refined, n_md = md_refined_edge_list(torch, dev,
                                                               cfg)
    md = [_edge_softmax_case(torch, dev, gen, s_md, r_md, m_md, n_md, 24,
                             cfg, layout, label)[1]
          for m_md, label in refined]
    others = [every_pair] + md
    return [dict(serving, name="edge_softmax_fused", route="cuda",
                 source="src/repro_torch/kernels/csrc/edge_softmax.cu",
                 replaces="src/repro/kernels/edge_softmax.py:100",
                 max_abs_err=max(t["max_abs_err"]
                                 for t in [serving] + others),
                 library_ms=None, other_shapes=others)]


def _mddq_exact(torch, v, cb, label):
    """The encode kernel's codes against its plain version's: identical."""
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    from repro_torch.kernels.ref import mddq_encode_ref
    idx, mag = mddq_encode_kernel(v, cb)
    idx_p, mag_p = mddq_encode_ref(v, cb)
    torch.cuda.synchronize()
    n_idx = int((idx != idx_p).sum())
    n_mag = int((mag != mag_p).sum())
    err = float(max((idx - idx_p).abs().max(), (mag - mag_p).abs().max()))
    print(f"  mddq_encode {label} N={v.shape[0]} C={cb.shape[0]}: idx "
          f"mismatches {n_idx}, mag mismatches {n_mag}")
    require(n_idx == 0 and n_mag == 0,
            f"mddq_encode {label}: codes differ from its plain version")
    return idx, err


def band_work(torch, v, cb, idx):
    """The codeword-vector pairs and the distinct codewords the band search
    needs on these inputs: for each nonzero vector, the z-band at its best
    score (``kernels.mddq_kernel.z_band``), which any certified search of
    this kind scores."""
    from repro_torch.kernels.mddq_kernel import z_band
    from repro_torch.kernels.ref import _norm3
    u = v / torch.clamp(_norm3(v), min=1e-12)[:, None]
    c = cb[idx.long()]
    best = (u[:, 0] * c[:, 0] + u[:, 1] * c[:, 1]) + u[:, 2] * c[:, 2]
    lo, hi = z_band(u, cb[:, 2], best)
    nz = (u != 0).any(-1)
    lo, hi = lo[nz], hi[nz]
    edges = torch.zeros(cb.shape[0] + 1, dtype=torch.int64, device=v.device)
    edges.index_add_(0, lo, torch.ones_like(lo))
    edges.index_add_(0, hi + 1, -torch.ones_like(hi))
    covered = int((edges.cumsum(0)[:-1] > 0).sum())
    return int((hi - lo + 1).sum()), covered


def check_mddq_encode(torch, dev, gen, cfg):
    """K4's codes identical to its plain version's: on random vectors of
    spread magnitudes (timed), on the probe set of
    ``kernels.mddq_kernel.probe_vectors`` with half the batch zero (the
    band search), and on the same through the full-search kernel with a
    permuted codebook."""
    from repro_torch.core.codebook import make_codebook
    from repro_torch.kernels.mddq_kernel import (mddq_encode_kernel,
                                                 probe_vectors)
    from repro_torch.kernels.ref import mddq_encode_ref
    n = M_ROWS * cfg.vec_feat
    cb = make_codebook(cfg.dir_bits, device=dev)
    require(getattr(cb, "z_sorted", False), "the codebook is not z-sorted")
    C = cb.shape[0]
    v = torch.randn(n, 3, generator=gen, device=dev) \
        * torch.exp(2 * torch.randn(n, 1, generator=gen, device=dev))
    v[:8] = 0.0                                  # zero vectors (padding)
    v[8:16] = cb[:8] * 3.0                       # exact codewords
    idx, err = _mddq_exact(torch, v, cb, "random")
    probes = torch.cat(list(probe_vectors(cb, seed=0, n=n // 16).values()))
    require(probes.shape[0] <= n // 2, "too many probe vectors")
    hard = torch.zeros_like(v)
    hard[:probes.shape[0]] = probes
    hard[probes.shape[0]:n // 2] = v[probes.shape[0]:n // 2]
    _, err_h = _mddq_exact(torch, hard, cb, "probes + half zero")
    perm = torch.randperm(C, generator=gen, device=dev)
    cb_perm = cb[perm]
    _, err_p = _mddq_exact(torch, hard, cb_perm, "probes, permuted codebook")

    def timed(x, book, band):
        fn = lambda: mddq_encode_kernel(x, book)     # noqa: E731
        full0 = mddq_encode_kernel.full_launches
        fn()
        require((mddq_encode_kernel.full_launches == full0) == band,
                "mddq_encode took the wrong search")
        ms = time_ms(torch, fn, reps=10)
        dev_ms, per_call = device_profile(torch, fn, reps=10)
        if band:
            require(dev_ms is None or per_call == 1,
                    f"the band search ran {per_call} kernels per call")
            idx_x, _ = mddq_encode_kernel(x, book)
            pairs, covered = band_work(torch, x, book, idx_x)
        else:
            pairs, covered = x.shape[0] * C, C
        b_ms, b_by = bound(20 * x.shape[0] + 12 * covered, 5 * pairs,
                           FP32_OPS_PER_S)
        return {"ms": ms, "device_ms": dev_ms,
                "device_kernels_per_call": per_call, "bound_ms": b_ms,
                "bound_by": b_by, "scored_pairs_needed": pairs}
    band = timed(v, cb, True)
    band_hard = timed(hard, cb, True)
    full = timed(hard, cb_perm, False)
    full_bound = bound(20 * n + 12 * C, 5 * n * C, FP32_OPS_PER_S)[0]
    plain_ms = time_ms(torch, lambda: mddq_encode_ref(v, cb), reps=3,
                       rounds=5)
    plain_p_ms = time_ms(torch, lambda: mddq_encode_ref(hard, cb_perm),
                         reps=3, rounds=5)
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/mddq_encode.cu",
              "replaces": "src/repro/kernels/mddq_kernel.py:51",
              "library_ms": None}
    return [dict(common, name="mddq_encode_kernel",
                 max_abs_err=max(err, err_h), plain_ms=plain_ms,
                 full_scan_bound_ms=full_bound, shape=f"N={n} C={C}",
                 other_shapes=[dict(band_hard, shape=f"N={n} C={C} probes "
                                    "+ half zero")], **band),
            dict(common, name="mddq_encode_full_search", max_abs_err=err_p,
                 plain_ms=plain_p_ms,
                 shape=f"N={n} C={C} probes + half zero, permuted codebook",
                 **full)]


def check_act_quant(torch, dev, gen):
    """K5 bit for bit against its plain version: the SO3 A8 shapes (every
    K the quantized matmuls take, 16 and 80 with a ragged lane tail) and a
    wide one in float32, the LM KV write's shapes and a wide one in bf16,
    each with an all-zero row (the 1e-8 floor)."""
    from repro_torch.kernels.act_quant import act_quant
    from repro_torch.kernels.ref import act_quant_ref
    so3_ks = sorted({k for k, _ in (TRUNK_W8, TRUNK_W4,
                                    *OTHER_W8.values())})
    cases = [(M_ROWS, k, torch.float32) for k in so3_ks] + [
        (4096, 896, torch.float32), (16, 64, torch.bfloat16),
        (2 * LM_BATCH * 2, 64, torch.bfloat16), (4096, 896, torch.bfloat16)]
    timed = {}
    for m, k, dt in cases:
        x = (torch.randn(m, k, generator=gen, device=dev)
             * torch.exp(torch.randn(m, 1, generator=gen, device=dev))).to(dt)
        x[0] = 0.0
        q, sc = act_quant(x)
        q_p, s_p = act_quant_ref(x)
        torch.cuda.synchronize()
        same = torch.equal(q, q_p) and torch.equal(sc, s_p)
        err = float(max((q.int() - q_p.int()).abs().max(),
                        (sc - s_p).abs().max()))
        name = str(dt).replace("torch.", "")
        print(f"  act_quant {name} M={m} K={k}: bit-identical={same}")
        require(same, f"act_quant {name} M={m} K={k} differs from its "
                      "plain version")
        ms = time_ms(torch, lambda: act_quant(x))
        dev_ms = device_ms(torch, lambda: act_quant(x))
        plain_ms = time_ms(torch, lambda: act_quant_ref(x))
        n_bytes = m * k * x.element_size() + m * k + 4 * m
        b_ms, b_by = bound(n_bytes, 3 * m * k, FP32_OPS_PER_S)
        timed[(m, k, name)] = {"shape": f"M={m} K={k} {name}", "ms": ms,
                               "device_ms": dev_ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": b_by,
                               "max_abs_err": err}
    row = timed[(M_ROWS, 64, "float32")]
    return [{"name": "act_quant", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/act_quant.cu",
             "replaces": "src/repro/kernels/act_quant.py:28",
             "max_abs_err": max(t["max_abs_err"] for t in timed.values()),
             "ms": row["ms"], "device_ms": row["device_ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None,
             "shape": row["shape"],
             "other_shapes": [t for key, t in timed.items()
                              if key != (M_ROWS, 64, "float32")]}]


def _kv_cache(torch, dev, B, H, S, hd):
    """A 3-layer stacked int8 cache of -128 (never a code) with NaN
    scales: a write outside its slot shows in the bytes."""
    q = torch.full((2, 3, B, H, S, hd), -128, dtype=torch.int8, device=dev)
    s = torch.full((2, 3, B, H, S), float("nan"), device=dev)
    return q, s


def check_kv_append(torch, dev, gen):
    """K5's KV entry (the LM decode's whole int8 KV write, one launch per
    layer) byte for byte against its plain version over a stacked cache
    filled with sentinel codes and NaN scales, on layer 1's views: K and V
    strided views of one projection, an all-zero row, slots 0 and S-1, in
    bf16 and float32, at the decode's shape (B=8, 2 kv heads, hd 64, a
    1,024-token cache), llama3.2-3b's 8 heads of 128, the smoke configs'
    hd 8 and replicate=3. Each timed, with one device kernel per call
    required, beside the write it replaced (act-quant of the stacked rows
    and four slice copies)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.act_quant import kv_append_int8
    from repro_torch.kernels.ref import kv_append_int8_ref

    def write(fn, x, q, s, cur, rep):
        fn(x[:, 0], x[:, 1], q[0, 1], s[0, 1], q[1, 1], s[1, 1], cur, rep)

    def stacked(x, q, s, cur):
        kq, ks, vq, vs = ops.prepare_kv_int8(x[:, 0], x[:, 1])
        q[0, 1][:, :, cur] = kq
        q[1, 1][:, :, cur] = vq
        s[0, 1][:, :, cur] = ks
        s[1, 1][:, :, cur] = vs

    shapes = [(LM_BATCH, 2, 64, 1, LM_CACHE), (LM_BATCH, 8, 128, 1, 256),
              (3, 1, 8, 1, 16), (LM_BATCH, 2, 64, 3, 64)]
    timed = {}
    for B, nkv, hd, rep, S in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(B, 2, nkv, hd, generator=gen, device=dev)
                 * torch.exp(torch.randn(B, 2, nkv, 1, generator=gen,
                                         device=dev))).to(dt)
            x[0, 0, 0] = 0.0
            H, name = nkv * rep, str(dt).replace("torch.", "")
            shape = f"B={B} nkv={nkv} hd={hd} replicate={rep} S={S} {name}"
            for cur, where in ((0, "int"), (S - 1, "int"),
                               (0, "device"), (S - 1, "device")):
                # the host int, and the position read from device memory
                pos = cur if where == "int" else torch.tensor(
                    cur, dtype=torch.int32, device=dev)
                got = _kv_cache(torch, dev, B, H, S, hd)
                want = [t.clone() for t in got]
                write(kv_append_int8, x, *got, pos, rep)
                write(kv_append_int8_ref, x, *want, cur, rep)
                torch.cuda.synchronize()
                same = (torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32)))
                written = bool((got[0][:, 1, :, :, cur] != -128).all())
                print(f"  kv_append_int8 {shape} cur={cur} ({where} "
                      f"position): whole cache bit-identical={same}, slot "
                      f"written={written}")
                require(same and written, f"kv_append_int8 {shape} "
                        f"cur={cur} ({where} position) differs from its "
                        "plain version")
            q, s = _kv_cache(torch, dev, B, H, S, hd)
            cur = min(LM_TOKENS, S - 1)
            fn = lambda: write(kv_append_int8, x, q, s, cur, rep)  # noqa
            dev_ms, per_call = device_profile(torch, fn)
            require(dev_ms is None or per_call == 1,
                    f"kv_append_int8 ran {per_call} kernels per call")
            pos = torch.tensor(cur, dtype=torch.int32, device=dev)
            dfn = lambda: write(kv_append_int8, x, q, s, pos, rep)  # noqa
            pos_ms, pos_per = device_profile(torch, dfn)
            require(pos_ms is None or pos_per == 1, f"kv_append_int8 ran "
                    f"{pos_per} kernels per call at a device position")
            n_bytes = 2 * B * nkv * hd * x.element_size() + 2 * B * H * (hd
                                                                        + 4)
            b_ms, b_by = bound(n_bytes, 3 * 2 * B * H * hd, FP32_OPS_PER_S)
            rec = {"shape": shape, "ms": time_ms(torch, fn),
                   "device_ms": dev_ms, "device_kernels_per_call": per_call,
                   "plain_ms": time_ms(torch, lambda: write(
                       kv_append_int8_ref, x, q, s, cur, rep)),
                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
                   "device_position_ms": time_ms(torch, dfn),
                   "device_position_device_ms": pos_ms}
            print(f"  kv_append_int8 {shape}: device {dev_ms} ms (int "
                  f"position), {pos_ms} ms (device position) per call "
                  f"(profiler), bound {b_ms:.6f} ms ({b_by})")
            if rep == 1:
                old = lambda: stacked(x, q, s, cur)             # noqa: E731
                old_dev, old_per = device_profile(torch, old)
                rec.update(stacked_write_ms=time_ms(torch, old),
                           stacked_write_device_ms=old_dev,
                           stacked_write_device_kernels_per_call=old_per)
                print(f"  the write it replaced ({shape}): act-quant of "
                      f"the stacked rows + four slice copies, "
                      f"{rec['stacked_write_ms']:.5f} ms per call (CUDA "
                      f"events), device {old_dev} ms over {old_per} device "
                      f"kernels per call")
            timed[shape] = rec
    main_shape = f"B={LM_BATCH} nkv=2 hd=64 replicate=1 S={LM_CACHE} bfloat16"
    row = timed.pop(main_shape)
    return [dict(row, name="kv_append_int8", route="cuda",
                 source="src/repro_torch/kernels/csrc/act_quant.cu",
                 replaces="src/repro/kernels/act_quant.py:28",
                 fuses="the JAX decode's KV quantization and its four "
                       "dynamic_update_index_in_dim "
                       "(src/repro/models/lm/attention.py:136-156)",
                 library_ms=None, other_shapes=list(timed.values()))]


def check_decode_attention(torch, dev, gen):
    """K6 within 1e-5 of its plain version at the LM decode's grouping
    (batch 8 x 2 kv heads, 7 query heads each, hd 64): over a 2,048-token
    cache for n_valid 1, 37 and 2048, and over phase 4's cache for n_valid
    1 and the last position of its greedy run. Timed at both (2,048 of
    2,048 tokens, 64 of 1,024) against its plain version and, as a
    yardstick that leaves the dequantization out,
    scaled_dot_product_attention on the already dequantized valid tokens,
    in float32 and on their bf16 cast, each by CUDA events and by its
    device time."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
    from repro_torch.kernels.ref import decode_attention_int8kv_ref
    B, nkv, g, hd, S = LM_BATCH, 2, 7, 64, 2048
    rows, scale = B * nkv, hd ** -0.5
    q = torch.randn(rows, g, hd, generator=gen, device=dev)
    errs, caches = [], {}
    for s_len, valid in ((LM_CACHE, (1, LM_TOKENS)), (S, (1, 37, S))):
        k = torch.randn(rows, s_len, hd, generator=gen, device=dev) * 2
        v = torch.randn(rows, s_len, hd, generator=gen, device=dev)
        kv = caches[s_len] = ops.prepare_kv_int8(k, v)
        for n_valid in valid:
            got = decode_attention_int8kv(q, *kv, n_valid, scale)
            want = decode_attention_int8kv_ref(q, *kv, n_valid, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs.append(err)
            print(f"  decode_attention_int8kv BH={rows} G={g} D={hd} "
                  f"S={s_len} n_valid={n_valid}: max_abs_err={err}")
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"decode_attention_int8kv S={s_len} n_valid={n_valid} "
                    f"differs from its plain version by {err}")

    def timed(s_len, n_valid):
        kv = caches[s_len]
        fn = lambda: decode_attention_int8kv(q, *kv, n_valid, scale)  # noqa
        ms = time_ms(torch, fn)
        dev_ms, per_call = device_profile(torch, fn)
        require(dev_ms is None or per_call == 1,
                f"decode_attention_int8kv ran {per_call} kernels per call")
        plain_ms = time_ms(torch, lambda: decode_attention_int8kv_ref(
            q, *kv, n_valid, scale))
        k_deq, v_deq = ((c[:, :n_valid].float() * sc[:, :n_valid, None])
                        .reshape(B, nkv, n_valid, hd)
                        for c, sc in ((kv[0], kv[1]), (kv[2], kv[3])))
        f32_args = (q.reshape(B, nkv * g, 1, hd), k_deq, v_deq)
        lib = {}
        for name, args in (("", f32_args), ("_bf16", tuple(
                t.to(torch.bfloat16) for t in f32_args))):
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *args, scale=scale, enable_gqa=True)
            lib[f"library{name}_ms"] = time_ms(torch, sdpa)
            lib[f"library{name}_device_ms"] = device_ms(torch, sdpa)
        n_bytes = 2 * rows * g * hd * 4 + rows * n_valid * (2 * hd + 8)
        b_ms, b_by = bound(n_bytes, rows * n_valid * (4 * g * hd + 2 * hd),
                           FP32_OPS_PER_S)
        return dict(ms=ms, device_ms=dev_ms, device_kernels_per_call=per_call,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    shape=f"BH={rows} G={g} D={hd} S={s_len} "
                          f"n_valid={n_valid}", **lib)
    dev_pos, dev_errs = check_decode_attention_device(torch, dev, gen)
    return [dict(timed(S, S), name="decode_attention_int8kv", route="cuda",
                 source="src/repro_torch/kernels/csrc/attention_int8kv.cu",
                 replaces="src/repro/kernels/attention_int8kv.py:61",
                 max_abs_err=max(errs + dev_errs),
                 device_position=dev_pos,
                 library="scaled_dot_product_attention(enable_gqa) on the "
                         "dequantized f32 valid tokens (library_bf16_*: on "
                         "their bf16 cast): a yardstick without the "
                         "dequantization",
                 other_shapes=[timed(LM_CACHE, LM_TOKENS)])]


def check_decode_attention_device(torch, dev, gen):
    """K6 with the position read from device memory (the decode's
    ``cur_index`` tensor: tokens [0, p]; the grid sized from S, each
    block the host's plan of the n_valid it reads) within 1e-5 of its
    plain version and bit for bit equal to the int entry: at the
    decode's grouping (16 rows x 7 heads, hd 64, S 1,024, n_valid 1, 64
    and 1,024) and at hd 128, G 8 (8 and 16 rows, S 288 and 1,024,
    n_valid 1, 37, 288 or 1,024). The device us per call of both
    entries (CUDA events behind a sleep kernel) beside ``k6_bound``.
    Returns (records, errors)."""
    from repro_torch.kernels.attention_int8kv import (
        decode_attention_int8kv, device_split_plan, split_plan)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import decode_attention_int8kv_ref
    cases = [(LM_BATCH * 2, 7, 64, LM_CACHE, (1, LM_TOKENS, LM_CACHE)),
             (8, 8, 128, 288, (1, 37, 288)),
             (16, 8, 128, 288, (1, 288)),
             (16, 8, 128, 1024, (1, 288, 1024))]
    recs, errs = [], []
    for rows, g, hd, s_len, valids in cases:
        scale = hd ** -0.5
        q = torch.randn(rows, g, hd, generator=gen, device=dev)
        kv = ops.prepare_kv_int8(
            torch.randn(rows, s_len, hd, generator=gen, device=dev) * 2,
            torch.randn(rows, s_len, hd, generator=gen, device=dev))
        for n_valid in valids:
            pos = torch.tensor(n_valid - 1, dtype=torch.int32, device=dev)
            got = decode_attention_int8kv(q, *kv, pos, scale)
            want = decode_attention_int8kv_ref(q, *kv, n_valid, scale)
            host = decode_attention_int8kv(q, *kv, n_valid, scale)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            errs.append(err)
            shape = f"BH={rows} G={g} D={hd} S={s_len} n_valid={n_valid}"
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"decode_attention_int8kv, device position, {shape}: "
                    f"differs from its plain version by {err}")
            # each block takes the host's plan of the n_valid it reads
            require(torch.equal(got, host), f"decode_attention_int8kv, "
                    f"{shape}: the device position's result differs from "
                    "the int position's")
            int_us = queued_device_ms(torch, lambda: decode_attention_int8kv(
                q, *kv, n_valid, scale)) * 1e3
            dev_us = queued_device_ms(torch, lambda: decode_attention_int8kv(
                q, *kv, pos, scale)) * 1e3
            b_us, b_by = k6_bound((rows, g, hd), n_valid)
            plans = (split_plan(rows, n_valid),
                     device_split_plan(rows, s_len, n_valid))
            print(f"  decode_attention_int8kv {shape}, device position: "
                  f"max_abs_err={err}; device {int_us:.3f} us (int entry, "
                  f"plan {plans[0]}), {dev_us:.3f} us (device entry, plan "
                  f"{plans[1]}) per call (events behind a sleep kernel); "
                  f"bound {b_us:.3f} us ({b_by})")
            recs.append({"shape": shape, "max_abs_err": err,
                         "int_device_us": int_us, "device_device_us": dev_us,
                         "bound_us": b_us, "bound_by": b_by,
                         "int_plan": plans[0], "device_plan": plans[1]})
    return recs, errs


# --- phase 3: the engine -----------------------------------------------------

def kernel_counters():
    from repro_torch.kernels.act_quant import act_quant, kv_append_int8
    from repro_torch.kernels.attention_int8kv import decode_attention_int8kv
    from repro_torch.kernels.edge_softmax import edge_softmax_fused
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    from repro_torch.kernels.quant_matmul import (w4a8_matmul,
                                                  w4a8_matmul_f32a,
                                                  w8a8_matmul,
                                                  w8a8_matmul_f32a)
    return [w8a8_matmul, w4a8_matmul, w8a8_matmul_f32a, w4a8_matmul_f32a,
            edge_softmax_fused, mddq_encode_kernel, act_quant,
            kv_append_int8, decode_attention_int8kv]


# the SO3 path quantizes activations inside the matmul kernel: the int8-A
# entries and the act-quant kernel are not on it; the LM decode writes its
# KV cache through the act-quant kernel's KV entry, not its (M, K) entry
SO3_KERNELS = ("w8a8_matmul_f32a", "w4a8_matmul_f32a", "edge_softmax_fused",
               "mddq_encode_kernel")
LM_KERNELS = ("kv_append_int8", "decode_attention_int8kv")


def join_workers(replicas, timeout_s, what):
    """Wait for the worker thread of every replica given, expropriated
    ones too: a stalled worker sleeps past its pool's close and then runs
    its flush, whose launches must not land in a later phase's counted
    window."""
    for r in replicas:
        r._worker.join(timeout_s)
    alive = [r.replica_id for r in replicas if r._worker.is_alive()]
    require(not alive, f"{what}: the workers of replicas {alive} outlived "
                       "their pool")


def counted_run(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before;
    return (result, {kernel: launches}). The MDDQ encode's calls are split
    by search: ``mddq_encode_kernel`` the band search, and
    ``mddq_encode_full_search`` the full search. ``quantized_products``
    is ``ops.quantized_products``: the calls of ``ops.matmul_w8a8`` and
    ``matmul_w4a8`` on the card, the serving path's quantized matmul
    entries (a captured program's per replay, as its launches). The role
    tallies (``_launch.role_launches``) are reset with the counts."""
    from repro_torch.kernels import _launch, ops
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    counters = kernel_counters()
    for c in counters + [ops.quantized_products]:
        c.launches = 0
    mddq_encode_kernel.full_launches = 0
    _launch.reset_role_launches()
    out = fn()
    counts = {c.__name__: c.launches for c in counters}
    full = mddq_encode_kernel.full_launches
    counts["mddq_encode_kernel"] -= full
    counts["mddq_encode_full_search"] = full
    counts["quantized_products"] = ops.quantized_products.launches
    return out, counts


def max_rel(a_results, b_results):
    """(max |energy diff|, max |force diff|), each over the largest
    |value| on the b side."""
    de = max(abs(a.energy - b.energy) for a, b in zip(a_results, b_results))
    df = max(float(np.abs(a.forces - b.forces).max())
             for a, b in zip(a_results, b_results))
    e_scale = max(abs(b.energy) for b in b_results)
    f_scale = max(float(np.abs(b.forces).max()) for b in b_results)
    return de / e_scale, df / f_scale


def profile_batch(torch, eng, graphs, reps: int = 7):
    """Device busy time of one sparse 8-molecule batch (torch.profiler),
    as a share of the median unprofiled latency of the same batch (host
    clock, ``reps`` runs) and of the profiled batch's own wall time, which
    the profiler inflates; and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.infer_batch(graphs)
        lat.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(lat)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer_batch(graphs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        print("  profiler: no device time recorded (device busy share "
              "not measured)")
        return
    print(f"  profiled sparse batch: device busy {busy_ms:.3f} ms, "
          f"{sum(r[1] for r in rows)} device events; unprofiled latency "
          f"{plain_ms:.3f} ms (median of {reps}) -> idle share "
          f"{1 - busy_ms / plain_ms:.3f}; profiled wall {wall_ms:.3f} ms "
          f"-> idle share {1 - busy_ms / wall_ms:.3f}")
    for t_ms, count, key in rows[:10]:
        print(f"    {t_ms:9.4f} ms  x{count:<4d} {key[:90]}")


def stage_times(torch, eng, graphs, reps: int = 5):
    """Host-clock split of one sparse 8-molecule batch into the engine's
    stages, each ended by a synchronize: host prep (plan, pad, numpy edge
    list), copies to the card, forward, backward (forces), copy back.
    Medians over ``reps``."""
    from repro_torch.core.codebook import make_codebook
    from repro_torch.serving import build_edge_list, pad_graphs, plan_batches
    from repro_torch.serving.forward import sparse_energy
    cfg, dev = eng.model_cfg, eng.device
    codebook = make_codebook(cfg.dir_bits, device=dev)
    stages = {k: [] for k in ("prep", "to_card", "forward", "backward",
                              "to_host")}
    for _ in range(reps):
        t0 = time.perf_counter()
        plan = plan_batches(graphs, eng.serve.buckets())[0]
        species, coords, mask = pad_graphs(graphs, plan)
        el = build_edge_list(coords, mask, cfg.cutoff, plan.bucket.edges)
        t1 = time.perf_counter()
        args = [torch.from_numpy(a).to(dev) for a in (
            species, coords, mask, el.senders, el.receivers, el.edge_mask)]
        args[1].requires_grad_()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e = sparse_energy(eng.qparams, cfg, *args, codebook,
                          mddq_kernel=eng.serve.mddq_kernel)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        (grad,) = torch.autograd.grad(e.sum(), args[1])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        _ = (e.detach().cpu().numpy(), grad.cpu().numpy())
        t5 = time.perf_counter()
        for k, a, b in zip(stages, (t0, t1, t2, t3, t4), (t1, t2, t3, t4, t5)):
            stages[k].append((b - a) * 1e3)
    split = {k: statistics.median(v) for k, v in stages.items()}
    print("  sparse batch stages (host clock, median of "
          f"{reps}, ms): " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in split.items()))


@contextlib.contextmanager
def eager_programs():
    """Inside the block the engines run their eager functions on the
    card, not their captured programs: ``QuantizedEngine`` dispatches
    through ``_eager_run`` and ``MDEngine`` runs ``_segment``. For the
    checks that patch Python entries (recorded A8 and MDDQ codes, kernel
    calls held against their plain versions), which a replay does not
    call, and for the eager side of the paired timings."""
    from repro_torch.md import MDEngine
    from repro_torch.serving import QuantizedEngine
    saved = (QuantizedEngine._run, MDEngine._captured_segment)
    QuantizedEngine._run = QuantizedEngine._eager_run
    MDEngine._captured_segment = MDEngine._segment
    try:
        yield
    finally:
        QuantizedEngine._run, MDEngine._captured_segment = saved


# the port's CUDA kernels, by the wrapper whose count they advance, as the
# profiler names them (qmm_kernel<W4, F32A>; the MDDQ band search)
KERNEL_SYMBOLS = {"w8a8_matmul_f32a": "qmm_kernel<false, true>",
                  "w4a8_matmul_f32a": "qmm_kernel<true, true>",
                  "edge_softmax_fused": "edge_softmax_kernel",
                  "mddq_encode_kernel": "band_kernel",
                  "kv_append_int8": "kv_append_kernel",
                  "decode_attention_int8kv": "decode_kernel<"}


def profiled_kernel_counts(torch, fn):
    """The port's device kernels by wrapper over one ``fn()`` (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k, sym in KERNEL_SYMBOLS.items():
            if sym in e.name:
                counts[k] += 1
    return counts


def check_replay_launches(torch, prog, what):
    """The profiler's count of the port's kernels by name over one replay
    of ``prog`` equals the launches it recorded while capturing (up to
    three profiles: the profiler has lost events of short kernels)."""
    want = {k: prog.launch_counts().get(k, 0) for k in KERNEL_SYMBOLS}
    prog.replay()
    torch.cuda.synchronize()
    tries = []
    for _ in range(3):
        tries.append(profiled_kernel_counts(torch, prog.replay))
        if tries[-1] == want:
            break
    print(f"  {what}: the profiler's kernels over one replay "
          f"{nonzero(tries[-1])} against its recorded launches "
          f"{nonzero(want)} ({len(tries)} profile(s))")
    require(tries[-1] == want, f"{what}: the profiler saw {tries} over "
                               f"one replay, the capture recorded {want}")


def hold_replay(torch, replayed, eager_runs, names, what):
    """A replay against eager runs of the same inputs, per output: bit
    for bit where the eager runs agree bit for bit; where they differ
    (the sparse backward's ``index_add`` sums with atomics, in any
    order), within twice the largest gap between two of them. Returns
    {name: (gap, spread)}."""
    import itertools
    out = {}
    for i, name in enumerate(names):
        e0 = eager_runs[0][i]
        spread = max(float((a[i].double() - b[i].double()).abs().max())
                     for a, b in itertools.combinations(eager_runs, 2))
        gap = float((replayed[i].double() - e0.double()).abs().max())
        ok = torch.equal(replayed[i], e0) if spread == 0 \
            else gap <= 2 * spread
        print(f"  {what}, {name}: replay vs eager max |diff| {gap}; "
              f"{len(eager_runs)} eager runs' largest gap {spread} ("
              + ("bit for bit required" if spread == 0 else
                 "within twice that required") + ")")
        require(ok, f"{what}: the replay's {name} differ from eager by "
                    f"{gap} (eager runs' spread {spread})")
        out[name] = (gap, spread)
    return out


@contextlib.contextmanager
def recorded_codes(rows=None):
    """Inside the block, each quantized product's A8 codes
    (``act_quant_ref`` of its input, which the f32-A kernels quantize bit
    for bit alike) and each MDDQ call's codes are appended to the yielded
    lists ``(a8, mddq)``: ``a8`` one int8 tensor per product, ``mddq`` one
    (direction, magnitude, nonzero) triple per call, flattened. ``rows``
    maps an input (detached) to the part to record, or to None to skip
    the call; None records whole inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import act_quant_ref
    pick = rows or (lambda t: t)
    a8, mddq = [], []
    saved = {k: getattr(ops, k) for k in ("matmul_w8a8", "matmul_w4a8",
                                          "mddq_qdq_kernel")}

    def rec_mm(fn):
        def call(x, *args):
            t = pick(x.detach())
            if t is not None:
                a8.append(act_quant_ref(t)[0].cpu())
            return fn(x, *args)
        return call

    def rec_mddq(fn):
        def call(v, mddq_cfg, codebook):
            u = pick(v.detach())
            if u is not None:
                idx, mag = ops.mddq_encode(u, codebook,
                                           mag_bits=mddq_cfg.magnitude_bits,
                                           m_min=mddq_cfg.m_min,
                                           m_max=mddq_cfg.m_max)
                mddq.append(tuple(t.reshape(-1).cpu() for t in (
                    idx, mag, (u ** 2).sum(-1) > 0)))
            return fn(v, mddq_cfg, codebook)
        return call
    ops.matmul_w8a8 = rec_mm(saved["matmul_w8a8"])
    ops.matmul_w4a8 = rec_mm(saved["matmul_w4a8"])
    ops.mddq_qdq_kernel = rec_mddq(saved["mddq_qdq_kernel"])
    try:
        with eager_programs():
            yield a8, mddq
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def split_gap(serve_a, serve_b, label: str):
    """Where a w4a8 gap between two runs of one 8-molecule batch comes
    from: the gap with MDDQ off (A8 activations and W4/W8 weights still
    rounded), and per layer the MDDQ codes that differ between the runs,
    whose inputs differ only by summation orders. ``serve_a``/``serve_b``
    take ServeConfig overrides and return the batch's results. One run of
    each records its codes (:func:`recorded_codes`). Returns the MDDQ-off
    (rel_e, rel_f) and per layer (moved direction codes, moved magnitude
    codes, nonzero vectors)."""
    rel_e, rel_f = max_rel(serve_a(quant_vectors=False),
                           serve_b(quant_vectors=False))
    print(f"  w4a8 with MDDQ off, {label}: energy {rel_e}, forces {rel_f}")
    codes = []
    for serve in (serve_a, serve_b):
        with recorded_codes() as (_, mddq):
            serve()
        codes.append(mddq)
    per_layer = []
    for (i_a, m_a, nz_a), (i_b, m_b, nz_b) in zip(*codes):
        nz = nz_a | nz_b
        per_layer.append((int((i_a != i_b)[nz].sum()),
                          int((m_a != m_b)[nz].sum()), int(nz.sum())))
    print(f"  MDDQ codes that differ, {label}, per layer "
          "(direction, magnitude, of nonzero vectors): "
          + ", ".join(f"{a}/{b}/{n}" for a, b, n in per_layer))
    return (rel_e, rel_f), per_layer


def replay_against_eager(torch, eng, graphs, path):
    """One padded batch of ``graphs`` through the engine's program
    (replayed) and five times through its eager functions on the card:
    energies and forces held by :func:`hold_replay`."""
    from repro_torch.serving import build_edge_list, pad_graphs, plan_batches
    plan = plan_batches(graphs, eng.serve.buckets())[0]
    species, coords, mask = pad_graphs(graphs, plan,
                                       pad_species=eng.serve.pad_species)
    if path == "sparse":
        el = build_edge_list(coords, mask, eng.model_cfg.cutoff,
                             plan.bucket.edges)
        run = lambda: eng._run_sparse(species, coords, mask, el)  # noqa
        key = ("sparse",) + species.shape + (el.edge_capacity,)
    else:
        run = lambda: eng._run_dense(species, coords, mask)  # noqa
        key = ("dense",) + species.shape
    require(key in eng.compiled_shapes, f"{key} was not captured")
    replayed = [t.cpu() for t in run()]
    eager = []
    for _ in range(5):
        with eager_programs():
            eager.append([t.cpu() for t in run()])
    hold_replay(torch, replayed, eager, ("energies", "forces"),
                f"{path} batch {key}")


def run_engine(torch, dev, cfg, graphs):
    from repro_torch.models.so3krates import init_params
    from repro_torch.serving import QuantizedEngine, ServeConfig
    params = init_params(cfg, seed=0, device=dev)
    common = dict(mode="w4a8", bucket_sizes=(32,), max_batch=8,
                  edge_capacity=1024, mddq_kernel=True)
    engines = {p: QuantizedEngine(cfg, params, ServeConfig(path=p, **common),
                                  device=dev)
               for p in ("sparse", "dense")}
    kinds = {n: engines["sparse"].qparams[f"layer0/{n}"].kind
             for n in ("wq", "wa", "w_upd1")}
    require(kinds == {"wq": "w8", "wa": "w4", "w_upd1": "w8"},
            f"unexpected w4a8 weight kinds {kinds}")
    for p, eng in engines.items():
        print(f"  warmup {p}: {eng.warmup():.3f} s")
        progs = eng._programs
        require(progs and set(progs) == eng.compiled_shapes
                == eng.shapes_seen, f"{p}: warmup captured "
                f"{sorted(progs)}, ran {sorted(eng.shapes_seen)}")
        print(f"  {p}: {len(progs)} programs captured in warmup: "
              f"{capture_seconds(progs.values())}, graph pool "
              f"{pool_bytes_of(eng)} bytes [{gpu_identity()}]")
    captured = {p: set(e.compiled_shapes) for p, e in engines.items()}

    results, launches = {}, {}
    for p, eng in engines.items():
        eng.reset_stats()
        results[p], launches[p] = counted_run(lambda: eng.infer_batch(graphs))
        print(f"  {p}: dispatch {eng.dispatch_stats}, launches {launches[p]}")
    require(engines["sparse"].dispatch_stats["sparse"] == 2,
            "the sparse engine did not run both batches sparse")
    for name in SO3_KERNELS:
        require(launches["sparse"][name] > 0,
                f"{name} was not launched on the sparse path")
    for name in ("w8a8_matmul_f32a", "w4a8_matmul_f32a",
                 "mddq_encode_kernel"):
        require(launches["dense"][name] > 0,
                f"{name} was not launched on the dense path")
    for p, n in launches.items():
        # every codebook the port builds takes the band search
        require(n["mddq_encode_full_search"] == 0,
                f"{p}: the MDDQ encode took the full search")
        # one launch per quantized product, the A8 step inside it: no
        # act-quant or int8-A launch, and nothing of the LM decode
        fused = n["w8a8_matmul_f32a"] + n["w4a8_matmul_f32a"]
        require(fused == n["quantized_products"] > 0,
                f"{p}: {fused} f32-A matmul launches for "
                f"{n['quantized_products']} quantized products")
        for name in ("act_quant", "w8a8_matmul", "w4a8_matmul",
                     "kv_append_int8", "decode_attention_int8kv"):
            require(n[name] == 0, f"{p}: {name} ran on the SO3 path")

    for p, res in results.items():
        for g, r in zip(graphs, res):
            require(r.forces.shape == (g.n_atoms, 3), f"{p}: forces shape")
            require(np.isfinite(r.energy) and np.isfinite(r.forces).all(),
                    f"{p}: non-finite result")
    rel_e, rel_f = max_rel(results["sparse"], results["dense"])
    print(f"  sparse vs dense (rel. to the largest |value|): energy {rel_e}, "
          f"forces {rel_f}")
    # the two paths sum in different orders, and an ulp that crosses an
    # MDDQ direction boundary moves a vector by a whole codebook spacing
    # (~0.014 rad at 16 bits): the split below counts the moved codes
    require(rel_e < 1e-2 and rel_f < 1e-2,
            f"sparse and dense disagree: {rel_e}, {rel_f}")

    def serve_on(device, p, path="sparse"):
        return lambda **kw: QuantizedEngine(cfg, p, ServeConfig(
            path=path, **dict(common, **kw)), device=device).infer_batch(
                graphs[:8])

    # card and CPU sum in other orders (the edge softmax, float32 GEMMs,
    # the MDDQ scores), so, as between the paths, a near-tie MDDQ
    # direction code can move and take a force by ~1e-3: the whole w4a8
    # answer is held to 1e-2, the same batch with MDDQ off to the CPU
    # parity tests' quantized-mode tolerance, the moved codes as below
    cpu_params = {k: v.cpu() for k, v in params.items()}
    rel_e, rel_f = max_rel(results["sparse"][:8],
                           serve_on("cpu", cpu_params)())
    print(f"  card vs CPU plain path, 8 molecules: energy {rel_e}, "
          f"forces {rel_f}")
    require(rel_e < 1e-2 and rel_f < 1e-2,
            f"card and CPU plain path disagree: {rel_e}, {rel_f}")
    (rel_e, rel_f), moved = split_gap(serve_on(dev, params),
                                      serve_on("cpu", cpu_params),
                                      "card vs CPU plain path")
    require(rel_e < 1e-4 and rel_f < 1e-4,
            f"w4a8 with MDDQ off: card and CPU plain path disagree: "
            f"{rel_e}, {rel_f}")
    require(all(d <= 0.005 * n and m <= 0.005 * n for d, m, n in moved),
            f"too many MDDQ codes differ between card and CPU: {moved}")

    # fp32 mode has no rounding to amplify an ulp: the edge-softmax kernel
    # inside the full model is held to the dense oracle tightly
    fp32 = {p: QuantizedEngine(cfg, params, ServeConfig(
        path=p, **dict(common, mode="fp32")), device=dev).infer_batch(graphs)
        for p in ("sparse", "dense")}
    rel_e, rel_f = max_rel(fp32["sparse"], fp32["dense"])
    print(f"  fp32 mode, sparse vs dense: energy {rel_e}, forces {rel_f}")
    require(rel_e < 1e-5 and rel_f < 1e-5,
            f"fp32 sparse and dense disagree: {rel_e}, {rel_f}")

    # with MDDQ off the paths agree as closely as in fp32 (no A8 code
    # moves), so the w4a8 gap above is the moved MDDQ codes: a handful
    # per layer, held under 0.5% of the vectors
    (rel_e, rel_f), moved = split_gap(serve_on(dev, params, "sparse"),
                                      serve_on(dev, params, "dense"),
                                      "sparse vs dense")
    require(rel_e < 1e-5 and rel_f < 1e-5,
            f"w4a8 with MDDQ off: sparse and dense disagree: {rel_e}, "
            f"{rel_f}")
    require(all(d <= 0.005 * n and m <= 0.005 * n for d, m, n in moved),
            f"too many MDDQ codes differ between the paths: {moved}")

    for p, eng in engines.items():
        replay_against_eager(torch, eng, graphs[:8], p)
    for p, eng in engines.items():
        # eager and replay alternated, each round 16 requests (2 batches)
        times = {"eager": [], "replay": []}
        for r in range(7):
            for how in (("eager", "replay") if r % 2 == 0
                        else ("replay", "eager")):
                with (eager_programs() if how == "eager"
                      else contextlib.nullcontext()):
                    t0 = time.perf_counter()
                    eng.infer_batch(graphs)
                    times[how].append((time.perf_counter() - t0) / 2 * 1e3)
        print(f"  {p}: ms per 8-molecule batch (host clock, forces "
              f"included, median of 7 rounds of 16 requests, alternated): "
              f"eager {statistics.median(times['eager']):.3f}, replay "
              f"{statistics.median(times['replay']):.3f} "
              f"[{gpu_identity()}]")
    require({p: e.compiled_shapes for p, e in engines.items()} == captured
            and all(len(e._programs) == len(captured[p])
                    for p, e in engines.items()),
            "a capture came under steady traffic")
    print("  steady traffic captured nothing: compiled_shapes "
          f"{ {p: len(c) for p, c in captured.items()} } as after warmup")
    with eager_programs():
        print("  eager:")
        profile_batch(torch, engines["sparse"], graphs[:8])
    print("  replay:")
    profile_batch(torch, engines["sparse"], graphs[:8])
    sp = engines["sparse"]
    key = next(k for k in sp._programs if k[0] == "sparse" and k[1] == 8)
    check_replay_launches(torch, sp._programs[key],
                          f"one sparse 8-molecule batch {key}")
    stage_times(torch, engines["sparse"], graphs[:8])
    lee = engines["sparse"].lee_diagnostic(graphs, seed=0, n_rotations=4)
    print(f"  LEE over 4 rotations (sparse): {lee}")
    require(np.isfinite(lee["lee_max"]), "LEE is not finite")
    return launches["sparse"]


# --- phase 4: the LM decode -------------------------------------------------

def _plain_kv_ops():
    """The int8-KV decode's two kernels as their plain versions, to run
    the same decode without the kernels on the same card."""
    from repro_torch.kernels.ref import (decode_attention_int8kv_ref,
                                         kv_append_int8_ref)
    return {"append_kv_int8": kv_append_int8_ref,
            "decode_attention_int8kv": decode_attention_int8kv_ref}


def forced_logits(torch, lm, tokens, plain: bool):
    """Logits of ``tokens.shape[1]`` teacher-forced steps from a fresh
    cache, through the kernels or (``plain``) their plain versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.lm.transformer import init_cache
    saved = {k: getattr(ops, k) for k in _plain_kv_ops()}
    if plain:
        for k, fn in _plain_kv_ops().items():
            setattr(ops, k, fn)
    try:
        cache = init_cache(lm.cfg, tokens.shape[0], LM_CACHE, lm.device)
        out = [serve.decode(lm, cache, tokens[:, i:i + 1], i)
               for i in range(tokens.shape[1])]
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)
    return torch.stack(out)


def profile_step(torch, lm, cache, index: int, reps: int = 7):
    """Device busy time of one decode step (torch.profiler) over the median
    unprofiled host-clock step time of the same step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.long, device=lm.device)

    def step():
        serve.decode(lm, cache, tok, index)
        torch.cuda.synchronize()
    step()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        lat.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(lat)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    rows = _device_rows(torch, prof)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        print("  profiler: no device time recorded (idle share not "
              "measured)")
        return
    events = sum(r[1] for r in rows)
    print(f"  profiled decode step at position {index}: device busy "
          f"{busy_ms:.3f} ms over {events} device events (867c120: "
          f"{LM_STEP_EVENTS_BEFORE}); unprofiled step {step_ms:.3f} ms "
          f"(median of {reps}) -> idle share {1 - busy_ms / step_ms:.3f}")
    for t_ms, count, key in rows[:10]:
        print(f"    {t_ms:9.4f} ms  x{count:<4d} {key[:90]}")


def run_lm_decode(torch, dev):
    from repro_torch.launch import serve
    from repro_torch.models.lm.transformer import init_cache, lm_head
    cfg = serve.lm_config("qwen2-0.5b", quant="serve_w8a8", kv_quant=True)
    require(cfg.dtype == torch.bfloat16 and cfg.n_layers == 24
            and cfg.d_model == 896, f"unexpected config {cfg}")
    t0 = time.perf_counter()
    lm = serve.build_lm(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  built {cfg.name} (numpy init, W8 quantization on the card) in "
          f"{time.perf_counter() - t0:.1f} s; weights fp32 "
          f"{lm.fp32_bytes / 1e6:.2f} MB -> served "
          f"{lm.served_bytes / 1e6:.2f} MB")
    cache = init_cache(cfg, LM_BATCH, LM_CACHE, dev)
    run, launches = counted_run(lambda: serve.greedy_decode(
        lm, LM_BATCH, LM_CACHE, LM_TOKENS, cache=cache))
    print(f"  greedy decode B={LM_BATCH} S={LM_CACHE}, {LM_TOKENS} tokens: "
          f"{run.seconds / run.steps_timed * 1e3:.3f} ms/step, "
          f"{run.steps_timed * LM_BATCH / run.seconds:.1f} tok/s (host "
          f"clock over {run.steps_timed} steps); kv-cache "
          f"{run.cache_bytes / 1e6:.2f} MB; launches {launches}")
    per_run = LM_TOKENS * cfg.n_layers
    for name in LM_KERNELS:
        require(launches[name] == per_run,
                f"{name}: {launches[name]} launches, expected {per_run} "
                f"(one per layer per step)")
    for name in set(launches) - set(LM_KERNELS):
        require(launches[name] == 0, f"{name} ran in the LM decode")
    require(run.tokens.shape == (LM_BATCH, LM_TOKENS)
            and bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()),
            "greedy tokens out of range")

    tokens = torch.cat([torch.zeros((LM_BATCH, 1), dtype=torch.long,
                                    device=dev),
                        run.tokens[:, :LM_FORCED_STEPS - 1]], dim=1)
    ker = forced_logits(torch, lm, tokens, plain=False)
    pla = forced_logits(torch, lm, tokens, plain=True)
    require(bool(torch.isfinite(ker).all()) and
            ker.shape == (LM_FORCED_STEPS, LM_BATCH, cfg.vocab),
            "LM logits not finite or of the wrong shape")
    rel = float((ker - pla).abs().max() / pla.abs().max())
    same_argmax = int((ker.argmax(-1) == pla.argmax(-1)).sum())
    print(f"  {LM_FORCED_STEPS} teacher-forced steps, kernels vs plain "
          f"versions: max |logit diff| / max |logit| = {rel}; greedy "
          f"argmax equal in {same_argmax} of {ker.shape[0] * ker.shape[1]}")
    require(rel <= LM_KERNEL_TOL, f"LM decode: kernels and plain versions "
                                  f"disagree by {rel} > {LM_KERNEL_TOL}")
    require(torch.equal(ker[0].argmax(-1), run.tokens[:, 0]),
            "the teacher-forced first step disagrees with the greedy run")
    # the same weights and tokens with float32 activations: no bf16 cast
    # turns the attention kernel's ~1e-7 differences into ulp flips
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    lm32 = dataclasses.replace(lm, cfg=cfg32,
                               head=lm_head(lm.params, cfg32))
    ker32 = forced_logits(torch, lm32, tokens, plain=False)
    pla32 = forced_logits(torch, lm32, tokens, plain=True)
    rel32 = float((ker32 - pla32).abs().max() / pla32.abs().max())
    print(f"  the same with float32 activations: {rel32}; greedy argmax "
          f"equal in {int((ker32.argmax(-1) == pla32.argmax(-1)).sum())} "
          f"of {ker32.shape[0] * ker32.shape[1]}")
    require(rel32 <= 1e-4, f"LM decode in float32: kernels and plain "
                           f"versions disagree by {rel32}")
    del ker32, pla32, lm32

    # the smoke config on the card against the CPU plain path, float32
    small = serve.lm_config("qwen2-0.5b", smoke=True, quant="serve_w8a8",
                            kv_quant=True)
    lms = {d: serve.build_lm(small, seed=0, device=d) for d in (dev, "cpu")}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, small.vocab, size=(3, LM_FORCED_STEPS)))
    card = forced_logits(torch, lms[dev], toks.to(dev), plain=False).cpu()
    cpu = forced_logits(torch, lms["cpu"], toks, plain=False)
    rel_small = float((card - cpu).abs().max() / cpu.abs().max())
    print(f"  smoke config (float32), card vs CPU plain path: {rel_small}")
    require(rel_small <= 1e-4, f"LM smoke decode: card and CPU disagree by "
                               f"{rel_small}")
    profile_step(torch, lm, cache, LM_TOKENS)
    greedy_replay_checks(torch, lm, LM_BATCH, LM_CACHE, LM_TOKENS,
                         profiled=True)
    return launches, lm


def greedy_replay_checks(torch, lm, batch, cache_len, n_tokens,
                         profiled=False,
                         order=("replay", "eager", "eager", "replay")):
    """The captured greedy decode against the eager one
    (``greedy_decode_eager``: the same step, the position in the same
    device buffer), each from a fresh cache, in ``order`` (the LM's step
    is captured already, or in the first run): the same tokens and, bit
    for bit, the same cache; ms/step and tok/s of each over steps
    2..n-1; an eager step at a device position and a replayed step under
    sync-debug "error" (no host sync). With ``profiled``: the profiler's
    kernels over one replayed step against its recorded launches, and
    that step's device busy and idle share. Returns the replay's and the
    eager's ms per step."""
    from repro_torch.launch import serve
    from repro_torch.models.lm.transformer import init_cache
    name = lm.cfg.name
    runs, caches = {"eager": [], "replay": []}, {}
    for how in order:
        cache = init_cache(lm.cfg, batch, cache_len, lm.device)
        fn = serve.greedy_decode_eager if how == "eager" \
            else serve.greedy_decode
        runs[how].append(fn(lm, batch, cache_len, n_tokens, cache=cache))
        caches.setdefault(how, cache)
    prog = lm.programs[(batch, cache_len)]
    first = runs["replay"][0].tokens
    require(all(torch.equal(r.tokens, first)
                for rs in runs.values() for r in rs),
            f"{name}: the captured greedy decode's tokens differ from the "
            "eager one's")
    require(all(torch.equal(a, b) for a, b in zip(
        *(tree_tensors(caches[h]) for h in ("eager", "replay")))),
        f"{name}: the captured decode's cache differs from the eager one's")
    ms = {h: [r.seconds / r.steps_timed * 1e3 for r in rs]
          for h, rs in runs.items()}
    line = "; ".join(
        f"{h} " + ", ".join(f"{m:.3f}" for m in ms[h])
        + f" ({batch * 1e3 / statistics.mean(ms[h]):.1f} tok/s)"
        for h in ("replay", "eager"))
    print(f"  {name} greedy decode B={batch} S={cache_len}, {n_tokens} "
          f"tokens: replay and eager give the same tokens and caches; ms/step"
          f" (host clock over steps 2..{n_tokens - 1}, in the order "
          f"{', '.join(order)}): {line}; {capture_seconds([prog])} (the "
          f"warm-up is step 1), graph pool {pool_bytes_of(lm)} bytes "
          f"[{gpu_identity()}]")
    # no host sync: an eager step at a device position, then a replay
    cache = init_cache(lm.cfg, batch, cache_len, lm.device)
    pos = torch.zeros((), dtype=torch.int32, device=lm.device)
    ids = torch.zeros((batch, 1), dtype=torch.long, device=lm.device)
    x = ids if lm.cfg.frontend == "token" else torch.zeros(
        (batch, 1, lm.cfg.d_model), dtype=lm.cfg.dtype, device=lm.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pos.fill_(0)
        serve.decode(lm, cache, x, pos)
        prog.static["pos"].fill_(1)
        prog.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  {name}: an eager step at a device position and a replayed "
          "step ran under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync")
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        prog.static["pos"].fill_(n_tokens)
        check_replay_launches(torch, prog, f"one {name} decode step")
        lat = []
        for _ in range(7):
            t0 = time.perf_counter()
            prog.replay()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.replay()
            torch.cuda.synchronize()
        rows = _device_rows(torch, prof)
        busy, step_ms = sum(r[0] for r in rows), statistics.median(lat)
        print(f"  one replayed decode step: device busy {busy:.3f} ms over "
              f"{sum(r[1] for r in rows)} device events; host {step_ms:.3f} "
              f"ms (median of 7) -> idle share "
              + (f"{1 - busy / step_ms:.3f}" if busy else "not measured"))
    return statistics.mean(ms["replay"]), statistics.mean(ms["eager"])


# --- phase 5: MD -------------------------------------------------------------

def md_system(cfg):
    """Phase 5's padded replica batch: (species, coords, mask, masses)."""
    from repro_torch.md import pad_replicas
    species, coords = make_molecule(MD_ATOMS, cfg.n_species, MD_DENSITY,
                                    MD_SEED)
    return (*pad_replicas(species, coords, MD_REPLICAS),
            np.full(MD_ATOMS, MD_MASS, np.float32))


def md_trajectory(eng, system, n_steps, record_every=MD_RECORD_EVERY):
    """``n_steps`` from the seed-0 initial state: (final state, records)."""
    species, coords, mask, masses = system
    st = eng.init_state(0, species, coords, mask, masses, MD_TEMPERATURE)
    return eng.run(st, species, mask, masses, n_steps, record_every)


def md_rel(a, b):
    """(max |coords diff|, max |e_tot diff|), each over the largest
    |value| on the b side, of two (state, records) results."""
    (sa, ra), (sb, rb) = a, b
    ca, cb = sa.coords.cpu().numpy(), sb.coords.cpu().numpy()
    return (float(np.abs(ca - cb).max() / np.abs(cb).max()),
            float(np.abs(ra["e_tot"] - rb["e_tot"]).max()
                  / np.abs(rb["e_tot"]).max()))


def capture_seconds(progs):
    """The seconds of captured programs, summed: warm-up runs, captures
    and, of those, the graphs' instantiation; and the largest capture."""
    progs = list(progs)
    return (f"warm-up {sum(g.warmup_seconds for g in progs):.3f} s, "
            f"capture {sum(g.capture_seconds for g in progs):.3f} s "
            f"(instantiation {sum(g.instantiate_seconds for g in progs):.3f}"
            f" s; largest capture "
            f"{max(g.capture_seconds for g in progs):.3f} s)")


def pool_bytes_of(owner):
    """An owner's graph-pool bytes (``captured.pool_bytes``), or None."""
    from repro_torch.captured import pool_bytes
    pool = getattr(owner, "_graph_pool", None)
    if pool is None:
        pool = getattr(owner, "graph_pool", None)
    return None if pool is None else pool_bytes(pool)


def md_replay_checks(torch, eng, st0, species, mask, masses, system):
    """Phase 5's captured segments: a replayed 10-step segment held
    against three eager ones from the same state (coordinates, e_tot,
    temperature: every output moves with the forces' summation order, so
    each is held within twice the eager runs' largest relative gap over
    all three, and bit for bit if they agree); the profiler's kernels
    over one replay of a one-step segment (one force call) against its
    recorded launches; ms/step and ns/day eager against replay over
    MD_PAIRED_STEPS, alternated (eager, replay, replay, eager); the
    device busy and idle share of a replayed 10-step segment."""
    from torch.profiler import ProfilerActivity, profile
    sp_t, mask_t, masses_t = eng.device_inputs(species, mask, masses)
    outs = ("coords", "e_tot", "temperature_K")

    def host(st, rec):
        return [st.coords.cpu(), rec["e_tot"].cpu(),
                rec["temperature_K"].cpu()]
    eng._captured_segment(st0, sp_t, mask_t, masses_t, 10)   # capture
    replayed = host(*eng._captured_segment(st0, sp_t, mask_t, masses_t, 10))
    eager = [host(*eng._segment(st0, sp_t, mask_t, masses_t, 10))
             for _ in range(3)]
    import itertools
    rel = [max(float((a[i] - b[i]).abs().max()) for a, b in
               itertools.combinations(eager, 2))
           / float(eager[0][i].abs().max()) for i in range(3)]
    gaps = [float((replayed[i] - eager[0][i]).abs().max())
            / float(eager[0][i].abs().max()) for i in range(3)]
    spread = max(rel)
    print(f"  a replayed 10-step segment vs eager (rel. to the largest "
          f"|value|): {dict(zip(outs, gaps))}; 3 eager runs' largest gaps "
          f"{dict(zip(outs, rel))} ("
          + ("bit for bit required" if spread == 0 else
             f"each within twice {spread} required") + ")")
    require((all(torch.equal(replayed[i], eager[0][i]) for i in range(3))
             if spread == 0 else max(gaps) <= 2 * spread),
            f"MD: replayed segment differs from eager: {gaps}, eager "
            f"spread {rel}")
    eng._captured_segment(st0, sp_t, mask_t, masses_t, 1)    # capture
    prog = eng._programs[(tuple(mask_t.shape),
                                  st0.nlist.edge_capacity, 1)]
    check_replay_launches(torch, prog, "one MD force call's segment")

    times = {"eager": [], "replay": []}
    for how in ("eager", "replay", "replay", "eager"):
        with (eager_programs() if how == "eager"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run(st0, species, mask, masses, MD_PAIRED_STEPS)
            torch.cuda.synchronize()
            times[how].append((time.perf_counter() - t0) / MD_PAIRED_STEPS
                              * 1e3)
    line = []
    for how, ms in times.items():
        m = statistics.mean(ms)
        line.append(f"{how} {ms[0]:.3f}, {ms[1]:.3f} ms/step "
                    f"({MD_DT_FS * 1e-6 * 86400 / (m * 1e-3):.4f} ns/day)")
    print(f"  {MD_PAIRED_STEPS} steps, eager vs replay (host clock, in the "
          f"order eager, replay, replay, eager): {'; '.join(line)} "
          f"[{gpu_identity()}]")
    prog10 = eng._programs[(tuple(mask_t.shape),
                                    st0.nlist.edge_capacity, 10)]
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        prog10.replay()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3 / 10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog10.replay()
        torch.cuda.synchronize()
    busy = sum(r[0] for r in _device_rows(torch, prof)) / 10
    step_ms = statistics.median(lat)
    print(f"  one replayed step: device busy {busy:.4f} ms; host "
          f"{step_ms:.3f} ms (median of 5 10-step replays) -> idle share "
          + (f"{1 - busy / step_ms:.3f}" if busy else "not measured"))


def run_md(torch, dev, cfg):
    """MD at the paper's width through ``MDEngine``: 1,000 steps of the
    md_bench system, counted; its gates; timings."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.md import MDConfig, MDEngine, energy_drift_rate
    from repro_torch.md.neighbor import maybe_rebuild
    from repro_torch.models.so3krates import init_params
    params = init_params(cfg, seed=0, device=dev)
    md = MDConfig(mode="w4a8", dt_fs=MD_DT_FS, skin=MD_SKIN,
                  record_every=MD_RECORD_EVERY, mddq_kernel=True)
    eng = MDEngine(cfg, params, md=md, device=dev)
    system = md_system(cfg)
    species, coords, mask, masses = system
    st0 = eng.init_state(0, species, coords, mask, masses, MD_TEMPERATURE)
    require(st0.nlist.edge_capacity == MD_EDGE_CAPACITY,
            f"edge capacity {st0.nlist.edge_capacity}")
    sp_t, mask_t, masses_t = eng.device_inputs(species, mask, masses)
    eng._segment(st0, sp_t, mask_t, masses_t, 5)         # warm up
    # the record segment's program, captured before the counted run
    eng.run(st0, species, mask, masses, MD_RECORD_EVERY)
    torch.cuda.synchronize()
    progs = eng._programs
    print(f"  captured {len(progs)} segment program(s) {sorted(progs)}: "
          f"{capture_seconds(progs.values())}, graph pool "
          f"{pool_bytes_of(eng)} bytes [{gpu_identity()}]")

    t0 = time.perf_counter()
    (st, rec), launches = counted_run(lambda: eng.run(
        st0, species, mask, masses, MD_STEPS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ms_step = seconds / MD_STEPS * 1e3
    ns_day = MD_STEPS / seconds * MD_DT_FS * 1e-6 * 86400
    print(f"  {MD_REPLICAS} replicas x {MD_ATOMS} atoms, {MD_STEPS} steps "
          f"at {MD_DT_FS} fs: {ms_step:.3f} ms per step, "
          f"{MD_STEPS / seconds:.1f} steps/s, {ns_day:.4f} ns/day per "
          f"replica (host clock over the run, {MD_STEPS // MD_RECORD_EVERY} "
          f"record checkpoints); {rec['n_rebuilds']} rebuilds; launches "
          f"{launches}")
    require(all(np.isfinite(rec[k]).all() for k in ("e_pot", "e_tot",
                                                     "temperature_K")),
            "MD records not finite")
    require(rec["e_tot"].shape == (MD_STEPS // MD_RECORD_EVERY,
                                   MD_REPLICAS), "MD records' shape")
    require(not bool(st.nlist.overflow), "MD skin list overflowed")
    per_call = {k: v / MD_STEPS for k, v in launches.items()}
    fused = per_call["w8a8_matmul_f32a"] + per_call["w4a8_matmul_f32a"]
    print(f"  per force call: {fused} f32-A matmul, "
          f"{per_call['edge_softmax_fused']} K3, "
          f"{per_call['mddq_encode_kernel']} K4 band, "
          f"{per_call['mddq_encode_full_search']} K4 full search")
    require(fused == 16 == per_call["quantized_products"],
            f"{fused} f32-A matmul launches per force call")
    require(per_call["edge_softmax_fused"] == cfg.n_layers,
            "not one K3 launch per layer and force call")
    require(per_call["mddq_encode_kernel"] == cfg.n_layers,
            "not one K4 band launch per layer and force call")
    for name in ("mddq_encode_full_search", "act_quant", "w8a8_matmul",
                 "w4a8_matmul", "kv_append_int8", "decode_attention_int8kv"):
        require(launches[name] == 0, f"{name} ran in MD")
    drift = [energy_drift_rate(rec["e_tot"][:, b], MD_DT_FS,
                               MD_RECORD_EVERY, MD_ATOMS)
             for b in range(MD_REPLICAS)]
    print(f"  drift rate (eV/atom/ps, per replica, reported, not gated): "
          f"mean {np.mean(drift):.6g}, max |.| {np.abs(drift).max():.6g}; "
          f"e_tot first/last record (replica 0) {rec['e_tot'][0, 0]:.6f} / "
          f"{rec['e_tot'][-1, 0]:.6f}; T {rec['temperature_K'][-1].mean():.1f}"
          f" K")

    # one record segment under sync-debug "error": any host sync raises
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st_seg, rec_seg = eng._segment(st0, sp_t, mask_t, masses_t,
                                       MD_RECORD_EVERY)
        _, rec_rep = eng._captured_segment(st0, sp_t, mask_t, masses_t,
                                           MD_RECORD_EVERY)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(bool(torch.isfinite(rec_seg["e_tot"]).all())
            and bool(torch.isfinite(rec_rep["e_tot"]).all()),
            "the sync-debug segments are not finite")
    print(f"  one {MD_RECORD_EVERY}-step record segment, eager and "
          "replayed, ran under torch.cuda.set_sync_debug_mode('error'): no "
          "host sync")
    md_replay_checks(torch, eng, st0, species, mask, masses, system)

    # device busy of a 10-step segment, per step, over its host time
    seg = lambda: eng._segment(st0, sp_t, mask_t, masses_t, 10)  # noqa
    seg()
    torch.cuda.synchronize()
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        seg()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3 / 10)
    step_ms = statistics.median(lat)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        seg()
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 10
    if busy == 0:
        print("  profiler: no device time recorded (idle share not "
              "measured)")
    else:
        print(f"  one step: device busy {busy:.4f} ms over "
              f"{sum(r[1] for r in rows) / 10:.1f} device events; host "
              f"{step_ms:.3f} ms (median of 5 10-step segments) -> idle "
              f"share {1 - busy / step_ms:.3f}")
        for t_ms, count, key in rows[:10]:
            print(f"    {t_ms / 10:9.4f} ms/step  x{count / 10:<6.1f} "
                  f"{key[:80]}")
    rebuild = lambda: maybe_rebuild(st0.nlist, st0.coords, mask_t,  # noqa
                                    cfg.cutoff, MD_SKIN)
    rb_dev, rb_events = device_profile(torch, rebuild)
    print(f"  select-rebuild (a fresh device_edge_list + the select) per "
          f"step: device {rb_dev} ms over {rb_events} device events, "
          f"{time_ms(torch, rebuild):.5f} ms per call (CUDA events)")

    # 0 missed cutoff edges over 100 audited steps
    audit = MDEngine(cfg, params, md=dataclasses.replace(
        md, track_missed=True), device=dev)
    _, rec_a = md_trajectory(audit, system, 100)
    print(f"  track_missed over 100 steps: {rec_a['missed_edges']} missed "
          f"edges, {rec_a['n_rebuilds']} rebuilds")
    require(rec_a["missed_edges"] == 0, "the skin list missed edges")

    # the skin list against a fresh list every step
    fresh = MDEngine(cfg, params, md=dataclasses.replace(md, skin=0.0),
                     device=dev)
    res_fresh = md_trajectory(fresh, system, 40, 20)
    res_skin = md_trajectory(eng, system, 40, 20)
    rel_c, rel_e = md_rel(res_skin, res_fresh)
    print(f"  skin {MD_SKIN} vs skin 0 over 40 steps (rel. to the largest "
          f"|value|): coords {rel_c}, e_tot {rel_e}; rebuilds "
          f"{res_skin[1]['n_rebuilds']} vs {res_fresh[1]['n_rebuilds']}")
    require(res_fresh[1]["n_rebuilds"] == 40, "skin 0 did not rebuild")
    require(rel_c <= 1e-4 and rel_e <= 1e-4,
            f"skin and fresh lists disagree: {rel_c}, {rel_e}")

    # the card against the CPU plain path: in fp32 mode, and in w4a8 with
    # MDDQ off (no near-tie MDDQ codes), 20 steps from one state
    cpu_params = {k: v.cpu() for k, v in params.items()}
    for label, cfg_md in (("fp32", dataclasses.replace(md, mode="fp32")),
                          ("w4a8, MDDQ off", dataclasses.replace(
                              md, quant_vectors=False))):
        engs = [MDEngine(cfg, p, md=cfg_md, device=d)
                for p, d in ((params, dev), (cpu_params, "cpu"))]
        res = [md_trajectory(e, system, 20, 10) for e in engs]
        rel_c, rel_e = md_rel(*res)
        print(f"  card vs CPU plain path, 20 steps, {label}: coords "
              f"{rel_c}, e_tot {rel_e}")
        require(rel_c <= 1e-4, f"MD ({label}): card and CPU plain path "
                               f"disagree on coordinates: {rel_c}")
        if cfg_md.mode == "fp32":
            require(rel_e <= 1e-4, f"MD (fp32): card and CPU plain path "
                                   f"disagree on e_tot: {rel_e}")
        else:
            md_a8_split(torch, [(e, res[1][0]) for e in engs], system,
                        rel_e)
    return launches


def md_a8_split(torch, runs, system, rel_e, label="card vs CPU"):
    """Where a w4a8 MD energy gap between two runs comes from (card
    against CPU at one state, or one engine at two states that differ
    only by the card's summation orders): the forward of each
    ``(engine, state)`` run at its state's coordinates, each quantized
    product's A8 codes (``act_quant_ref`` of its input, which the f32-A
    kernels quantize bit for bit alike) recorded per replica. An ulp of
    summation order that crosses an A8 rounding boundary moves a code,
    which moves the energy by far more than an ulp (the straight-through
    forces barely). Requires: the trajectory's e_tot within 1e-2 (phase
    3's tolerance of a whole w4a8 answer); at these coordinates every
    replica whose energy differs by more than 1e-4 of the largest |e_pot|
    has a moved A8 code; and the first product with a moved code moves at
    most 0.5% of its codes (the near ties; later products inherit)."""
    from repro_torch.serving.forward import sparse_energy_and_forces
    species, _, mask, masses = system
    n_rep = mask.shape[0]
    out = []
    for eng, state in runs:
        def on(x):
            return torch.as_tensor(x).to(eng.device)
        with recorded_codes() as (codes, _):
            sp_t, mask_t, _ = eng.device_inputs(species, mask, masses)
            nl = [on(t) for t in (state.nlist.senders, state.nlist.receivers,
                                  state.nlist.edge_mask)]
            e, _ = sparse_energy_and_forces(
                eng.qparams, eng.model_cfg, sp_t, on(state.coords),
                mask_t, *nl, quant_vectors=False, refine_cutoff=True)
        out.append((e.detach().cpu().numpy(), codes))
    (e_card, c_card), (e_cpu, c_cpu) = out
    gap = np.abs(e_card - e_cpu) / np.abs(e_cpu).max()
    moved = np.array([(a != b).reshape(n_rep, -1).sum(1)
                      for a, b in zip(c_card, c_cpu)])   # (products, B)
    per_product = moved.sum(1)
    print(f"  {label}, at the states' coordinates: e_pot gap per replica "
          f"(rel.) "
          f"{np.array2string(gap, precision=2)}; A8 codes moved per "
          f"product {per_product.tolist()}, per replica "
          f"{moved.sum(0).tolist()}")
    require(rel_e <= 1e-2, f"MD (w4a8, {label}): e_tot differs by {rel_e}")
    unexplained = (gap > 1e-4) & (moved.sum(0) == 0)
    require(not unexplained.any(), f"MD (w4a8, {label}): e_pot gaps {gap} "
                                   "with no A8 code moved")
    for i in np.flatnonzero(per_product)[:1]:
        require(per_product[i] <= 0.005 * c_cpu[i].numel(),
                f"MD (w4a8, {label}): {per_product[i]} A8 codes of "
                f"{c_cpu[i].numel()} moved in product {i}")


# --- phase 6: the online SO3 server -----------------------------------------

def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves_equal(torch, a, b) -> bool:
    """Two serving-format trees hold the same tensors, byte for byte."""
    from repro_torch.serving.qparams import QTensor
    if set(a) != set(b):
        return False
    for name, v in a.items():
        w = b[name]
        if isinstance(v, QTensor):
            pairs = [(v.data, w.data)] + (
                [(v.scale, w.scale)] if v.scale is not None else [])
        else:
            pairs = [(v, w)]
        if not all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in pairs):
            return False
    return True


def request_split(torch, eng, flush_graphs, i):
    """Where a gap between a request served in its flush and the same
    molecule served alone comes from: both runs with each quantized
    product's A8 codes (``act_quant_ref`` of its input) and each MDDQ
    call's direction and magnitude codes recorded on the request's own
    rows only (:func:`recorded_codes`). Requires both runs to make the
    same products and MDDQ calls. Returns (A8 codes moved per product,
    MDDQ codes moved per call)."""
    from repro_torch.serving import plan_batches
    g = flush_graphs[i]
    plan = plan_batches(flush_graphs, eng.serve.buckets())[0]
    cap, n = plan.bucket.capacity, g.n_atoms
    runs = []
    for graphs, row in ((flush_graphs, plan.graph_indices.index(i)), ([g], 0)):
        def rows(t):
            if t.dim() == 2:      # a product's input: per-atom rows only
                return (None if t.shape[0] % cap
                        else t.reshape(-1, cap, t.shape[-1])[row, :n])
            return t.reshape(-1, cap, *t.shape[-2:])[row, :n]
        with recorded_codes(rows) as run:
            eng._infer_raw(graphs)
        runs.append(run)
    (a8_f, md_f), (a8_s, md_s) = runs
    require(len(a8_f) == len(a8_s) and len(md_f) == len(md_s),
            f"request {i}: the flush made {len(a8_f)} products and "
            f"{len(md_f)} MDDQ calls, the single molecule {len(a8_s)} and "
            f"{len(md_s)}")
    moved_a8 = [int((x != y).sum()) for x, y in zip(a8_f, a8_s)]
    moved_mddq = [int(((x[0] != y[0]) | (x[1] != y[1])).sum())
                  for x, y in zip(md_f, md_s)]
    return moved_a8, moved_mddq


def check_kernel_calls(torch, run, label):
    """Every kernel call of ``run()`` (a flush run again, one MD step)
    held against its plain version on the inputs it was given, as phase 2
    holds them: the f32-A matmuls bit for bit against
    ``act_quant_ref`` and the plain matmul, K3 to 1e-5 with empty
    receivers exactly 0, K4's codes identical. Returns {kernel: (max
    error, shapes seen)}."""
    from repro_torch.kernels import ops, ref
    names = ("w8a8_matmul_f32a", "w4a8_matmul_f32a", "edge_softmax_fused",
             "mddq_encode_kernel")
    saved = {k: getattr(ops, k) for k in names}
    calls = []

    def recording(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, [a.detach().clone() if torch.is_tensor(a)
                                 else a for a in args], kw,
                          tuple(t.detach().clone() for t in out)
                          if isinstance(out, tuple) else out.detach().clone()))
            return out
        return call
    for k, fn in saved.items():
        setattr(ops, k, recording(k, fn))
    try:
        with eager_programs():
            run()
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)
    seen = {}
    for name, args, kw, got in calls:
        if name.endswith("f32a"):
            x, w, w_s = args
            plain = ref.w4a8_matmul_ref if name.startswith("w4") \
                else ref.w8a8_matmul_ref
            want = plain(*ref.act_quant_ref(x), w, w_s)
            err = float((got - want).abs().max())
            ok = torch.equal(got, want)
            shape = f"M={x.shape[0]} K={x.shape[1]} N={want.shape[1]}"
        elif name == "edge_softmax_fused":
            q, k, bias, vals, s, r, m = args[:7]
            want = ref.edge_softmax_ref(q, k, bias, s, r, m, vals, q.shape[0])
            err = float((got - want).abs().max())
            has_edge = torch.zeros(q.shape[0], dtype=torch.bool,
                                   device=q.device)
            has_edge[r[m].long()] = True
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5) \
                and bool((got[~has_edge] == 0).all())
            shape = f"N={q.shape[0]} E={s.shape[0]} real={int(m.sum())}"
        else:
            v, cb = args
            want = ref.mddq_encode_ref(v, cb, **kw)
            err = float(max((a - b).abs().max() for a, b in zip(got, want)))
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            shape = f"N={v.shape[0]} C={cb.shape[0]}"
        require(ok, f"{label}: {name} at {shape} differs from its plain "
                    f"version by {err}")
        e0, shapes = seen.get(name, (0.0, []))
        seen[name] = (max(e0, err), shapes + [shape] * (shape not in shapes))
    print(f"  {label}: {len(calls)} kernel calls held against their plain "
          "versions: " + "; ".join(
              f"{k} max_abs_err {e} at {', '.join(sh)}"
              for k, (e, sh) in seen.items()))
    return seen


def run_server(torch, dev, cfg, graphs):
    """The online SO3 server: a packed artifact's round trip onto the
    card, then Poisson traffic through ``MicroBatchScheduler`` over the
    loaded engine, counted; its gates; the CLI once."""
    import tempfile
    from repro_torch.guardrails import GuardrailConfig
    from repro_torch.launch import serve as cli
    from repro_torch.obs import REGISTRY, TRACER, configure_tracing
    from repro_torch.server import (MicroBatchScheduler, SchedulerConfig,
                                    SizeClass, TrafficConfig, load_artifact,
                                    load_engine, make_traffic, run_open_loop,
                                    save_artifact)
    from repro_torch.serving import QuantizedEngine, ServeConfig
    serve = ServeConfig(mode="w4a8", bucket_sizes=SERVER_BUCKETS,
                        max_batch=8, edge_capacity=1024, path="sparse",
                        mddq_kernel=True)
    t0 = time.perf_counter()
    src = QuantizedEngine.from_config(cfg, serve=serve, seed=0, device=dev)
    _sync(torch, dev)
    from_config_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "so3_w4a8.npz")
        file_bytes = save_artifact(path, src)
        t0 = time.perf_counter()
        eng = load_engine(path, device=dev)
        _sync(torch, dev)
        load_s = time.perf_counter() - t0
        tag = load_artifact(path).version_tag
        save_artifact(str(Path(tmp) / "again.npz"), eng)
        again = load_artifact(str(Path(tmp) / "again.npz")).version_tag
        fp32 = src.memory_report()["fp32_bytes"]
        print(f"  artifact: {file_bytes} B on disk against {fp32} B of "
              f"fp32 weights ({fp32 / file_bytes:.2f}x), tag {tag}; "
              f"load_engine {load_s:.3f} s against from_config (numpy init "
              f"and quantization) {from_config_s:.3f} s")
        require(_leaves_equal(torch, src.qparams, eng.qparams),
                "the loaded artifact's leaves differ from the source's")
        require(all((v.data if hasattr(v, "kind") else v).device == dev
                    for v in eng.qparams.values()),
                "a loaded leaf is not on the engine's device")
        require(file_bytes < fp32, f"artifact {file_bytes} B >= fp32 {fp32}")
        require(again == tag == eng.artifact_version,
                f"version tags {tag}, {again}, {eng.artifact_version}")
        rel_e, rel_f = max_rel(eng.infer_batch(graphs),
                               src.infer_batch(graphs))
        print(f"  loaded vs source engine, {len(graphs)} molecules (rel. to "
              f"the largest |value|): energy {rel_e}, forces {rel_f}")
        if max(rel_e, rel_f) > 1e-6:
            def serve_with(qp):
                return lambda **kw: QuantizedEngine.from_quantized(
                    cfg, qp, dataclasses.replace(serve, **kw),
                    device=dev).infer_batch(graphs[:8])
            split_gap(serve_with(eng.qparams), serve_with(src.qparams),
                      "loaded vs source")
        require(rel_e <= 1e-6 and rel_f <= 1e-6,
                f"the loaded engine differs from the source: {rel_e}, "
                f"{rel_f}")

        eng.guardrails = GuardrailConfig(check_finite=True,
                                         lee_probe_every=8, on_flag="mark")
        traffic = make_traffic(TrafficConfig(
            rate_rps=SERVER_RATE, n_requests=SERVER_REQUESTS, seed=0,
            size_mix=(SizeClass(9, 16, 0.5), SizeClass(17, 24, 0.5))))
        sched = MicroBatchScheduler(eng, SchedulerConfig(max_batch=8,
                                                         deadline_ms=10.0))
        print(f"  scheduler warmup {sched.warmup_s:.3f} s over "
              f"{len(eng.warmup_report)} (bucket, batch, path) shapes, "
              f"{len(eng.compiled_shapes)} captured, graph pool "
              f"{pool_bytes_of(eng)} bytes")
        shapes = set(eng.shapes_seen)
        compiled = set(eng.compiled_shapes)
        require(compiled == shapes, f"warmup ran {sorted(shapes)} and "
                                    f"captured {sorted(compiled)}")
        eng.reset_stats()
        n0 = eng._n_infer_calls
        handles = []

        class Recording:
            """The scheduler, keeping every handle it gives out."""
            stats = sched.stats

            def submit(self, g):
                handles.append(sched.submit(g))
                return handles[-1]
        configure_tracing(enabled=True)
        TRACER.reset()
        try:
            res, launches = counted_run(lambda: run_open_loop(
                Recording(), traffic, rate_rps=SERVER_RATE,
                result_timeout=60))
        finally:
            sched.close()
            configure_tracing(enabled=False)
        stats = sched.stats()
        flushes = list(sched._flushes)
        traces = TRACER.drain()
        dispatch, guard = eng.stats_snapshot(), eng.guard_snapshot()
        n_calls = eng._n_infer_calls - n0
        s = res.summary()
        print(f"  replay: {s['n_requests']} requests at {SERVER_RATE:.0f} "
              f"req/s offered: p50 {s['p50_ms']:.3f} ms, p95 "
              f"{s['p95_ms']:.3f}, p99 {s['p99_ms']:.3f}, max "
              f"{s['max_ms']:.3f}; {s['throughput_rps']:.2f} req/s over "
              f"{s['span_s']:.3f} s; shed {res.n_shed}")
        print(f"  flushes {stats['n_flushes']}: reasons "
              f"{stats['flush_reasons']}, mean batch {stats['mean_batch']:.3f} "
              f"(per bucket {stats['mean_batch_per_bucket']}), max queue "
              f"depth {stats['max_queue_depth']}; per flush (mean, ms): "
              f"service {statistics.mean(f.service_s for f in flushes) * 1e3:.3f}, "
              f"prep {statistics.mean(f.prep_s for f in flushes) * 1e3:.3f}, "
              f"dispatch {statistics.mean(f.dispatch_s for f in flushes) * 1e3:.3f}, "
              f"sync {statistics.mean(f.sync_s for f in flushes) * 1e3:.3f}, "
              f"queue wait {statistics.mean(f.wait_s for f in flushes) * 1e3:.3f}")
        print(f"  dispatch {dispatch}; guard {guard}; launches {launches}")
        print(f"  LEE probes {guard['lee_probes']} over {n_calls} flushes; "
              f"engine_lee_probe_level "
              f"{REGISTRY.gauge('engine_lee_probe_level', mode='w4a8').value}")
        require(s["n_requests"] == SERVER_REQUESTS and res.n_shed == 0,
                f"{s['n_requests']} of {SERVER_REQUESTS} resolved, "
                f"{res.n_shed} shed")
        require(stats["n_completed"] == SERVER_REQUESTS
                and guard["flagged_nonfinite"] == 0,
                f"completed {stats['n_completed']}, guard {guard}")
        require(len(traces) == SERVER_REQUESTS
                and all(t["status"] == "ok" for t in traces),
                f"{len(traces)} traces for {SERVER_REQUESTS} requests")
        require(eng.shapes_seen == shapes
                and eng.compiled_shapes == compiled,
                f"new shapes under traffic: {eng.shapes_seen - shapes}, "
                f"captured {eng.compiled_shapes - compiled}")
        require(n_calls == stats["n_flushes"],
                f"{n_calls} guarded calls for {stats['n_flushes']} flushes")
        require(guard["lee_probes"] == (n0 + n_calls) // 8 - n0 // 8,
                f"{guard['lee_probes']} LEE probes over calls {n0}.."
                f"{n0 + n_calls}")
        # per layer 5 quantized products sparse and 8 dense, the readout's
        # one, a K3 per sparse layer and a K4 per layer: 16/25, 3, 3 at
        # 3 layers; the LEE probes' re-runs are dispatches too
        sparse, dense, n_layers = (dispatch["sparse"], dispatch["dense"],
                                   cfg.n_layers)
        predicted = {"f32a_matmuls": (5 * n_layers + 1) * sparse
                     + (8 * n_layers + 1) * dense,
                     "edge_softmax_fused": n_layers * sparse,
                     "mddq_encode_kernel": n_layers * (sparse + dense)}
        fused = launches["w8a8_matmul_f32a"] + launches["w4a8_matmul_f32a"]
        require(fused == predicted["f32a_matmuls"]
                == launches["quantized_products"],
                f"{fused} f32-A matmul launches for "
                f"{launches['quantized_products']} quantized products, "
                f"predicted {predicted}")
        for name in ("edge_softmax_fused", "mddq_encode_kernel"):
            require(launches[name] == predicted[name],
                    f"{name}: {launches[name]} launches, predicted "
                    f"{predicted[name]}")
        for name in ("mddq_encode_full_search", "act_quant", "w8a8_matmul",
                     "w4a8_matmul", "kv_append_int8",
                     "decode_attention_int8kv"):
            require(launches[name] == 0, f"{name} ran in the server replay")

        # a sample of the replay against direct single-molecule calls
        eng.guardrails = GuardrailConfig()
        by_trace = {h.trace.trace_id: h for h in handles}
        flush_of = {tid: [by_trace[t] for t in f.trace_ids]
                    for f in flushes for tid in f.trace_ids}
        pick = np.random.default_rng(0).choice(len(handles), SERVER_SAMPLE,
                                               replace=False)
        served = [handles[i].result(timeout=0) for i in pick]
        direct = [eng.infer_batch([handles[i].graph])[0] for i in pick]
        rel_e, rel_f = max_rel(served, direct)
        print(f"  {SERVER_SAMPLE} sampled requests vs direct infer_batch([g]) "
              f"(rel. to the largest |value|): energy {rel_e}, forces {rel_f}")
        e_scale = max(abs(d.energy) for d in direct)
        f_scale = max(float(np.abs(d.forces).max()) for d in direct)
        for i, a, b in zip(pick, served, direct):
            gap = max(abs(a.energy - b.energy) / e_scale,
                      float(np.abs(a.forces - b.forces).max()) / f_scale)
            if gap <= SERVER_TOL:
                continue
            peers = flush_of[handles[i].trace.trace_id]
            moved_a8, moved_mddq = request_split(
                torch, eng, [h.graph for h in peers], peers.index(handles[i]))
            print(f"  request {i} ({handles[i].graph.n_atoms} atoms, flush "
                  f"of {len(peers)}): gap {gap}; A8 codes moved per product "
                  f"{moved_a8}, MDDQ codes per call {moved_mddq}")
            require(sum(moved_a8) + sum(moved_mddq) > 0,
                    f"request {i}: gap {gap} with no A8 or MDDQ code moved")

        # the kernels at this path's own shapes: the largest flush of each
        # bucket again, every kernel call held against its plain version
        largest = {}
        for f in flushes:
            if len(f.trace_ids) > len(largest.get(f.capacity, ())):
                largest[f.capacity] = f.trace_ids
        require(sorted(largest) == sorted(SERVER_BUCKETS),
                f"flushes in buckets {sorted(largest)} only")
        held = {}
        for cap_b, tids in sorted(largest.items()):
            flush = [by_trace[t].graph for t in tids]
            seen = check_kernel_calls(
                torch, lambda: eng.infer_batch(flush),
                f"largest flush of bucket {cap_b} ({len(tids)} molecules)")
            for name, (err, shapes) in seen.items():
                e0, sh0 = held.get(name, (0.0, []))
                held[name] = (max(e0, err), sh0 + shapes)
        require(set(held) == set(SO3_KERNELS),
                f"the largest flushes ran {sorted(held)}")

        # the sampled gate's explanation path, run once on a known flush
        peers = [by_trace[t] for t in largest[max(largest)]]
        moved_a8, moved_mddq = request_split(
            torch, eng, [h.graph for h in peers], 0)
        print(f"  request split of the first request of that flush: A8 codes "
              f"moved per product {moved_a8}, MDDQ codes per call "
              f"{moved_mddq}")
        # 5 quantized products per layer sparse, 8 dense, and the readout's
        require(len(moved_a8) in (5 * cfg.n_layers + 1, 8 * cfg.n_layers + 1)
                and len(moved_mddq) == cfg.n_layers,
                f"request split recorded {len(moved_a8)} products and "
                f"{len(moved_mddq)} MDDQ calls")

        # the device's share of one flush: the largest of the replay
        flush_graphs = [h.graph for h in max(flush_of.values(), key=len)]
        if dev.type == "cuda":
            print(f"  one flush of {len(flush_graphs)} molecules of "
                  f"{min(g.n_atoms for g in flush_graphs)}-"
                  f"{max(g.n_atoms for g in flush_graphs)} atoms:")
            profile_batch(torch, eng, flush_graphs)

        # phase 9 serves this artifact again
        kept = str(Path(tempfile.mkdtemp(prefix="chip_smoke_artifact_"))
                   / "so3_w4a8.npz")
        shutil.copyfile(path, kept)
        argv = ["--workload", "so3", "--server", "--artifact", path,
                "--requests", "64", "--rate", "50", "--buckets", "16", "32",
                "--max-batch", "8"]
        if dev.type != "cuda":
            argv += ["--device", str(dev)]
        try:
            _, cli_launches = counted_run(lambda: cli.main(argv))
        except SystemExit as exc:
            raise SmokeFailure(f"the serve CLI exited with {exc.code}")
        # the artifact's serving knobs (sparse path, MDDQ kernel, edge
        # capacity) carry over to the CLI's engine
        print(f"  CLI launches {cli_launches}")
        fused = (cli_launches["w8a8_matmul_f32a"]
                 + cli_launches["w4a8_matmul_f32a"])
        require(fused == cli_launches["quantized_products"] > 0
                and cli_launches["edge_softmax_fused"] > 0
                and cli_launches["mddq_encode_kernel"] > 0,
                f"the CLI's replay did not run the sparse path's kernels: "
                f"{cli_launches}")
    return launches, held, s, kept


# --- phase 7: the cluster and a checkpointed MD session ----------------------

def launches_per_forward(mode, path, n_layers):
    """Kernel launches of one forward and backward (a serving dispatch, a
    warmup run or an MD force call) with the MDDQ kernel on, read off
    ``serving/forward.py`` and ``serving/qparams.py``: per layer on the
    sparse path the trunk (``_trunk_matmul``: one product per weight kind,
    so two in w4a8, a W8 and a W4 group, and one in w8a8), the update
    MLP's two and ``w_vnorm``; on the dense path 8 per layer; plus the
    readout's one. All are f32-A W8 launches except the W4 ones of w4a8
    (``wa|wb``: 1 per layer sparse, 2 dense); fp32 quantizes nothing; a K3
    per layer on the sparse path; a K4 per layer where vectors are
    quantized (not fp32)."""
    L = n_layers
    trunk = 2 if mode == "w4a8" else 1
    products = 0 if mode == "fp32" else ((3 + trunk) * L + 1
                                         if path == "sparse" else 8 * L + 1)
    w4 = L * (1 if path == "sparse" else 2) if mode == "w4a8" else 0
    return {"w8a8_matmul_f32a": products - w4, "w4a8_matmul_f32a": w4,
            "edge_softmax_fused": L if path == "sparse" else 0,
            "mddq_encode_kernel": 0 if mode == "fp32" else L}


def predict_launches(runs, n_layers):
    """Summed :func:`launches_per_forward` over ``{(mode, path): count}``."""
    out = dict.fromkeys(SO3_KERNELS, 0)
    for (mode, path), n in runs.items():
        for k, v in launches_per_forward(mode, path, n_layers).items():
            out[k] += v * n
    return out


@contextlib.contextmanager
def counted_force_calls():
    """MD force calls on the card (``md.engine.FORCE_CALLS``: eager calls,
    the initial state's included, and a captured segment's per replay)
    per mode inside the block, from any thread; the yielded dict is
    filled when the block ends."""
    from repro_torch.md.engine import FORCE_CALLS
    before = {m: c.launches for m, c in FORCE_CALLS.items()}
    counts = {}
    try:
        yield counts
    finally:
        for m, c in FORCE_CALLS.items():
            if c.launches > before[m]:
                counts[m] = c.launches - before[m]


def dispatch_counts(modes=("w4a8", "w8a8", "fp32")):
    """The process-wide ``engine_dispatch_total`` counters per (mode,
    path): they accumulate across engines, swapped-out ones included."""
    from repro_torch.obs import REGISTRY
    return {(m, p): REGISTRY.counter("engine_dispatch_total", mode=m,
                                     path=p).value
            for m in modes for p in ("dense", "sparse")}


def role_predictions(runs, warm, force_calls, n_layers):
    """{role: {kernel: launches}} for each replica role: a tier's flushes
    (``runs``: dispatches per (mode, path)), its warmup runs (``warm``:
    per (mode, path)) and its session chunks (``force_calls``: MD force
    calls per mode, on the sparse path), each times
    :func:`launches_per_forward`."""
    predicted = {}
    for kind, per in (("flush", runs), ("warmup", warm), ("chunk", {
            (m, "sparse"): n for m, n in force_calls.items()})):
        for (mode, path), n in per.items():
            if n:
                role = predicted.setdefault(f"{kind}:{mode}",
                                            dict.fromkeys(SO3_KERNELS, 0))
                for k, v in predict_launches({(mode, path): n},
                                             n_layers).items():
                    role[k] += v
    return predicted


def check_roles(predicted, by_role, launches, where):
    """Every role's measured launches (``_launch.role_launches``) equal
    its prediction, every launch of the window (``launches``, from
    :func:`counted_run`) was made by a replica's flush, warmup or chunk,
    and no kernel off the SO3 path ran. Returns the measured launches
    split into {"cluster": flushes and warmups, "md_session": chunks}."""
    others = ("mddq_encode_full_search", "act_quant", "w8a8_matmul",
              "w4a8_matmul", "kv_append_int8", "decode_attention_int8kv")
    for role in sorted(set(predicted) | set(by_role)):
        got = {k: v for k, v in by_role.get(role, {}).items()
               if k != "quantized_products"
               and not k.startswith("md_force_calls_")}
        want = predicted.get(role, {})
        print(f"  {role}: launches {got}, predicted {want}")
        require(got == {k: v for k, v in want.items() if v},
                f"{role}: launches {got}, predicted {want}")
        require(by_role.get(role, {}).get("quantized_products", 0)
                == want.get("w8a8_matmul_f32a", 0)
                + want.get("w4a8_matmul_f32a", 0),
                f"{role}: quantized products {by_role.get(role)}")
    for name in SO3_KERNELS + ("quantized_products",):
        require(sum(t.get(name, 0) for t in by_role.values())
                == launches[name],
                f"{name}: {launches[name]} launches, "
                f"{sum(t.get(name, 0) for t in by_role.values())} of them "
                "by a replica's flush, warmup or chunk")
    for name in others:
        require(launches[name] == 0, f"{name} ran in {where}")
    measured = {"cluster": dict.fromkeys(SO3_KERNELS, 0),
                "md_session": dict.fromkeys(SO3_KERNELS, 0)}
    for role, t in by_role.items():
        part = measured["md_session" if role.startswith("chunk:")
                        else "cluster"]
        for k in SO3_KERNELS:
            part[k] += t.get(k, 0)
    return measured


def burst_rate(submit, graphs, timeout=120):
    """Requests per second completed when ``graphs`` arrive at once:
    first submit to last completion."""
    t0 = time.monotonic()
    handles = [submit(g) for g in graphs]
    for h in handles:
        h.result(timeout=timeout)
    return len(graphs) / (max(h.t_done for h in handles) - t0)


def run_cluster(torch, dev, cfg, single):
    """The cluster and a checkpointed MD session at the paper's width:
    Poisson traffic through ``ClusterPool.from_tiers`` with a rolling
    swap and an in-flight kill, one MD session beside it, counted; its
    gates; the resume, stall and escalation drills; the CLI once.
    ``single`` is phase 6's replay summary, printed beside the cluster's.
    Returns {"cluster": launches, "md_session": launches, "held":
    {kernel: (max error, shapes)}}: the launches measured in the replay's
    window, by the replicas' flushes and warmup runs and by the session's
    chunks; the errors of the kernel calls held at this path's shapes."""
    import tempfile
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.cluster import ClusterConfig, ClusterPool
    from repro_torch.guardrails import ForceEnvelope, GuardrailConfig
    from repro_torch.kernels import _launch
    from repro_torch.launch import serve as cli
    from repro_torch.md import MDConfig
    from repro_torch.models.so3krates import init_params
    from repro_torch.obs import TRACER, configure_tracing
    from repro_torch.server import (MicroBatchScheduler, RequestHandle,
                                    SchedulerConfig, SizeClass,
                                    TrafficConfig, load_engine, make_traffic,
                                    run_open_loop, save_artifact)
    from repro_torch.serving import QuantizedEngine, ServeConfig
    from repro_torch.sessions import (SessionConfig, SessionManager,
                                      corrupt_checkpoint)
    serve = ServeConfig(mode="w4a8", bucket_sizes=SERVER_BUCKETS,
                        max_batch=8, edge_capacity=1024, path="sparse",
                        mddq_kernel=True)
    guard = GuardrailConfig(check_finite=True, on_flag="mark")
    ident = gpu_identity()
    L = cfg.n_layers
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")

    t0 = time.perf_counter()
    pool = ClusterPool.from_tiers(
        cfg, params=init_params(cfg, 0, dev), serve=serve,
        tier_plan=CLUSTER_TIERS, guardrails=guard, device=dev,
        cluster=ClusterConfig(max_batch=8, deadline_ms=10.0,
                              stall_timeout_s=CLUSTER_STALL_S,
                              probation_s=CLUSTER_PROBATION_S))
    build_s = time.perf_counter() - t0
    reps = pool._replicas
    st0 = pool.stats()
    print(f"  pool: {[(r.replica_id, r.tier, str(r.device)) for r in reps]}"
          f", built and warmed in {build_s:.3f} s; warmup per replica "
          f"{[round(r['warmup_s'], 3) for r in st0['replicas']]} s "
          f"(parallel, one thread each) [{ident}]")
    if dev.type == "cuda":
        print(f"  captured programs per replica "
              f"{[len(r.engine.compiled_shapes) for r in reps]}; graph pool "
              f"bytes per replica {[pool_bytes_of(r.engine) for r in reps]}"
              f", {torch.cuda.memory_reserved(dev)} bytes reserved on the "
              f"card [{ident}]")
    require(all(r.device == dev for r in reps) and (
        dev.type != "cuda"
        or len({r.stream.cuda_stream for r in reps}) == len(reps)),
        "replicas are not on the card with one stream each")
    old_w4 = reps[0].engine                 # the pre-swap w4a8 weights
    src1 = QuantizedEngine.from_config(cfg, serve=serve, seed=1, device=dev)
    swap_path = str(Path(tmp) / "w4a8_seed1.npz")
    save_artifact(swap_path, src1)
    new_w4 = load_engine(swap_path, device=dev)
    refs = {old_w4.artifact_version: old_w4,
            new_w4.artifact_version: new_w4}

    traffic = make_traffic(TrafficConfig(
        rate_rps=SERVER_RATE, n_requests=SERVER_REQUESTS, seed=0,
        size_mix=(SizeClass(9, 16, 0.5), SizeClass(17, 24, 0.5))))
    graphs = [g for _, g in traffic]

    # what the host sustains: a burst of 200 through one engine's
    # scheduler, then through the two w4a8 replicas (one interpreter)
    burst = graphs[:200]
    one = QuantizedEngine.from_quantized(cfg, old_w4.qparams, serve,
                                         device=dev)
    with MicroBatchScheduler(one, SchedulerConfig(
            max_batch=8, deadline_ms=10.0)) as sched:
        rate_one = burst_rate(sched.submit, burst)
    rate_two = burst_rate(pool.submit, burst)
    print(f"  burst of {len(burst)} requests: one engine's scheduler "
          f"{rate_one:.2f} req/s, the pool's two w4a8 replicas "
          f"{rate_two:.2f} req/s ({rate_two / rate_one:.3f}x) [{ident}]")

    # the main run: the replay with a rolling swap at half and an
    # in-flight kill of replica 1 at three quarters, and one MD session
    species, coords, _, _ = md_system(cfg)
    scfg = SessionConfig(
        n_steps=SESSION_STEPS, chunk_steps=SESSION_CHUNK,
        record_every=MD_RECORD_EVERY, checkpoint_every=SESSION_CKPT_EVERY,
        temperature_K=MD_TEMPERATURE, n_replicas=MD_REPLICAS,
        md=MDConfig(mode="w4a8", dt_fs=MD_DT_FS, skin=MD_SKIN,
                    record_every=MD_RECORD_EVERY, mddq_kernel=True))
    root = str(Path(tmp) / "sessions")
    mgr = SessionManager(pool, root)
    ckpt_s = []
    plain_ckpt = mgr._checkpoint

    def timed_checkpoint(session):
        t = time.perf_counter()
        plain_ckpt(session)
        ckpt_s.append(time.perf_counter() - t)
    mgr._checkpoint = timed_checkpoint
    handles, swap_report, events = [], {}, {}

    class Recording:
        """The pool, keeping every handle it gives out."""
        stats = pool.stats

        def submit(self, g):
            handles.append(pool.submit(g))
            return handles[-1]

    def swap():
        t = time.perf_counter()
        try:
            swap_report.update(pool.swap_artifact(swap_path))
        except BaseException as exc:       # raised after the replay
            swap_report["error"] = exc
        events["swap_s"] = time.perf_counter() - t

    def kill():
        events["kill_at"] = time.monotonic()
        pool.kill_replica(1, mode="in_flight")

    def main_run():
        timers = [threading.Timer(traffic[len(traffic) // 2][0], swap),
                  threading.Timer(traffic[3 * len(traffic) // 4][0], kill)]
        t = time.perf_counter()
        session = mgr.start(species[0, :MD_ATOMS], coords[0, :MD_ATOMS],
                            np.full(MD_ATOMS, MD_MASS, np.float32),
                            config=scfg, seed=0, session_id="md")
        for tm in timers:
            tm.start()
        res = run_open_loop(Recording(), traffic, rate_rps=SERVER_RATE,
                            result_timeout=300)
        for tm in timers:
            tm.join()
        session.wait(600)
        events["session_s"] = time.perf_counter() - t
        return res, session

    pool.reset_stats()
    d0 = dispatch_counts()
    configure_tracing(enabled=True)
    TRACER.reset()
    try:
        with counted_force_calls() as force_calls:
            (res, session), launches = counted_run(main_run)
        by_role = _launch.role_launches()
    finally:
        configure_tracing(enabled=False)
    TRACER.drain()
    d1 = dispatch_counts()
    stats = pool.stats()
    flush_s = [f.service_s for f in pool.flush_records()]
    require("error" not in swap_report,
            f"the rolling swap failed: {swap_report.get('error')}")

    s = res.summary()
    print(f"  replay: {s['n_requests']} requests at {SERVER_RATE:.0f} req/s"
          f" offered: p50 {s['p50_ms']:.3f} ms, p95 {s['p95_ms']:.3f}, p99 "
          f"{s['p99_ms']:.3f}, max {s['max_ms']:.3f}; "
          f"{s['throughput_rps']:.2f} req/s over {s['span_s']:.3f} s "
          f"[{ident}]")
    print(f"  phase 6's single engine, same traffic: p50 "
          f"{single['p50_ms']:.3f} ms, p95 {single['p95_ms']:.3f}, p99 "
          f"{single['p99_ms']:.3f}; {single['throughput_rps']:.2f} req/s")
    print(f"  flushes {stats['n_flushes']}, reasons {stats['flush_reasons']}"
          f"; per replica {stats['per_replica']}; routed "
          f"{stats['router']['routed_per_replica']}, requeued "
          f"{stats['router']['n_requeued']}, failures "
          f"{stats['router']['n_failures']} [{ident}]")
    for r in swap_report.get("replicas", []):
        print(f"  swap -> {swap_report['version_tag']}, replica "
              f"{r['replica_id']}: warmup {r['warmup_s']:.3f} s, pause "
              f"{r['pause_s'] * 1e3:.3f} ms, total {r['total_s']:.3f} s")
    steps_s = SESSION_STEPS / events["session_s"]
    print(f"  MD session beside the traffic: {SESSION_STEPS} steps of "
          f"{MD_REPLICAS} x {MD_ATOMS} atoms in {events['session_s']:.3f} s"
          f" -> {steps_s:.2f} steps/s, "
          f"{steps_s * MD_DT_FS * 1e-6 * 86400:.4f} ns/day per replica; "
          f"{session.n_retries} chunk retries; checkpoints "
          f"{[round(t, 4) for t in ckpt_s]} s; versions "
          f"{session.artifact_versions} [{ident}]")

    # gates: nothing lost or shed, every error a failover's
    require(s["n_requests"] == SERVER_REQUESTS and res.n_shed == 0,
            f"{s['n_requests']} of {SERVER_REQUESTS} resolved, "
            f"{res.n_shed} shed")
    results = [h.result(timeout=0) for h in handles]
    require(all(np.isfinite(r.energy) and not r.flags for r in results),
            "a replay result is not finite or flagged")
    g = stats["guardrails"]
    require(g["n_quarantined"] == 0 and g["n_escalated"] == 0,
            f"the replay quarantined or escalated: {g}")
    require(stats["n_live"] == len(reps) - 1
            and stats["router"]["n_failures"] == 1,
            f"{stats['n_live']} live replicas, "
            f"{stats['router']['n_failures']} failures after one kill")
    # every result names the engine that ran it: the old or the new tag,
    # the new one only from swapped replicas, never old after new
    swapped = {r["replica_id"] for r in swap_report["replicas"]}
    tags = {r.artifact_version for r in results}
    require(swapped and tags <= set(refs) and len(tags) == 2,
            f"result versions {tags}, swapped replicas {swapped}")
    for rid in {r.replica_id for r in results}:
        seq = [r.artifact_version for h, r in sorted(
            zip(handles, results), key=lambda p: p[0].t_done)
            if r.replica_id == rid]
        new = [v == swap_report["version_tag"] for v in seq]
        require(new == sorted(new) and (rid in swapped or not any(new)),
                f"replica {rid} served versions out of order")
    # the launches, measured per role (a replica's flushes, warmup runs
    # and session chunks at each tier), each against its own prediction:
    # the dispatches per (mode, path), the swapped engines' warmup runs
    # and the session's force calls, times launches_per_forward
    runs = {k: int(d1[k] - d0[k]) for k in d0}
    warm = {}
    for rid in swapped:
        for w in reps[rid].engine.warmup_report:
            warm[(w["mode"], w["path"])] = warm.get((w["mode"], w["path"]),
                                                    0) + 1
    print(f"  dispatches {runs}; swapped engines' warmup runs {warm}; MD "
          f"force calls {force_calls}; launches {launches}")
    measured = check_roles(role_predictions(runs, warm, force_calls, L),
                           by_role, launches, "the cluster")
    # session frames: once each, in index order, finite
    n_frames = SESSION_STEPS // MD_RECORD_EVERY
    first = {f.index: f for f in session.collected}
    require([f.index for f in session.collected] == list(range(n_frames))
            and session.status == "done"
            and all(np.isfinite(f.e_tot).all() for f in first.values()),
            f"session frames {[f.index for f in session.collected]}, "
            f"status {session.status}")
    # the newest checkpoint restores with every digest verified
    cm = CheckpointManager(session.checkpoint_dir)
    last = SESSION_STEPS // SESSION_CHUNK
    require(cm.all_steps() == list(range(SESSION_CKPT_EVERY, last + 1,
                                         SESSION_CKPT_EVERY))
            and all(cm.is_valid(k) for k in cm.all_steps())
            and cm.latest_step() == last, f"checkpoints {cm.all_steps()}")
    arrays = cm.restore_arrays(last)
    back = cm.restore(last, like=arrays, device=dev)
    require(np.array_equal(arrays["coords"], session.state.coords)
            and all(back[k].device == dev for k in back),
            "the newest checkpoint does not restore the session's state")

    # 32 sampled requests against direct calls on their version's engine
    by_trace = {h.trace.trace_id: h for h in handles}
    flush_of = {tid: [by_trace[t] for t in f.trace_ids]
                for f in pool.flush_records() for tid in f.trace_ids}
    pick = np.random.default_rng(0).choice(len(handles), SERVER_SAMPLE,
                                           replace=False)
    worst_e = worst_f = 0.0
    for i in pick:
        h, r = handles[i], results[i]
        ref = refs[r.artifact_version]
        d = ref.infer_batch([h.graph])[0]
        de = abs(r.energy - d.energy) / max(abs(d.energy), 1e-12)
        df = float(np.abs(r.forces - d.forces).max()
                   / max(float(np.abs(d.forces).max()), 1e-12))
        worst_e, worst_f = max(worst_e, de), max(worst_f, df)
        if de == 0.0 and df <= SERVER_TOL:
            continue
        peers = flush_of[h.trace.trace_id]
        moved_a8, moved_mddq = request_split(
            torch, ref, [p.graph for p in peers], peers.index(h))
        print(f"  request {i} (replica {r.replica_id}): energy gap {de}, "
              f"forces {df}; A8 codes moved per product {moved_a8}, MDDQ "
              f"codes per call {moved_mddq}")
        require(sum(moved_a8) + sum(moved_mddq) > 0,
                f"request {i}: a gap with no A8 or MDDQ code moved")
    print(f"  {SERVER_SAMPLE} sampled requests vs direct infer_batch([g]) "
          f"on their version's engine (rel. to the request's largest "
          f"|value|): energy {worst_e}, forces {worst_f}")

    # the kernels at this path's own shapes, each call held against its
    # plain version on its replica's stream: every tier's engine at a
    # singleton flush of each bucket (an escalation tier's flush) and at
    # the replay's largest flush of each bucket, and one session step
    largest = {}
    for f in pool.flush_records():
        if len(f.trace_ids) > len(largest.get(f.capacity, ())):
            largest[f.capacity] = f.trace_ids
    single_of = {cap: next(gr for gr in graphs if (gr.n_atoms <= 16)
                           == (cap == 16)) for cap in SERVER_BUCKETS}
    held = {}

    def hold(seen):
        for name, (err, shapes) in seen.items():
            e0, sh0 = held.get(name, (0.0, []))
            held[name] = (max(e0, err), sh0 + [x for x in shapes
                                               if x not in sh0])
    for rep in (reps[0], reps[2], reps[3]):   # w4a8 (swapped), w8a8, fp32
        cases = [(f"singleton flush of bucket {cap}", [gr])
                 for cap, gr in sorted(single_of.items())]
        cases += [(f"the replay's largest flush of bucket {cap} "
                   f"({len(tids)} molecules)",
                   [by_trace[t].graph for t in tids])
                  for cap, tids in sorted(largest.items())]
        with rep._engine_lock, rep.on_stream():
            for what, batch in cases:
                hold(check_kernel_calls(
                    torch, lambda: rep.engine.infer_batch(batch),
                    f"{rep.tier} replica {rep.replica_id}, {what}"))
    step = mgr._make_chunk_fn(session, 1)
    with reps[0]._engine_lock, reps[0].on_stream():
        hold(check_kernel_calls(
            torch, lambda: step(reps[0].engine),
            f"one session step on replica 0 ({MD_REPLICAS} x {MD_ATOMS} "
            "atoms, refined skin list)"))
    require(set(held) == set(SO3_KERNELS),
            f"phase 7's kernel checks ran {sorted(held)}")

    # the device's share of the largest flush, on its version's engine
    peers = max(flush_of.values(), key=len)
    if dev.type == "cuda":
        print(f"  the largest flush, {len(peers)} molecules [{ident}]:")
        profile_batch(torch, refs[peers[0].result(timeout=0)
                                  .artifact_version],
                      [p.graph for p in peers])

    # drill 1: resume from the checkpoint before a corrupted newest one
    mgr.close()
    require(corrupt_checkpoint(session.checkpoint_dir, "bitflip", seed=0)
            is not None and cm.latest_step() == last - SESSION_CKPT_EVERY,
            f"the corrupted checkpoint did not fall back: "
            f"{cm.latest_step()}")
    mgr2 = SessionManager(pool, root)
    t0 = time.perf_counter()
    (resumed,) = mgr2.resume_all()
    require(resumed.wait(600) == "done" and resumed.n_restores == 1,
            f"the resumed session ended {resumed.status}")
    resume_s = time.perf_counter() - t0
    mgr2.close()
    tail = [f.index for f in resumed.collected]
    replay_from = (last - SESSION_CKPT_EVERY) * (SESSION_CHUNK
                                                 // MD_RECORD_EVERY)
    require(tail == list(range(replay_from, n_frames)),
            f"the resumed tail re-emitted frames {tail}")
    same = [(first[f.index], f) for f in resumed.collected
            if f.artifact_version == first[f.index].artifact_version]
    require(same, "no replayed frame ran on its first emission's weights")
    scale = max(float(np.abs(a.e_tot).max()) for a, _ in same)
    gaps = [float(np.abs(a.e_tot - b.e_tot).max()) / scale for a, b in same]
    print(f"  resume after corrupting step {last}: restored step "
          f"{last - SESSION_CKPT_EVERY}, frames {tail} re-emitted in "
          f"{resume_s:.3f} s [{ident}]; e_tot gap against the first emission "
          f"(rel. to the largest |e_tot|), {len(same)} frames on the same "
          f"weights: {gaps}")
    if max(gaps) > REPLAY_TRACE:
        system = (resumed.species, None, resumed.mask, resumed.masses)
        eng = refs[same[0][1].artifact_version].md_engine(scfg.md)
        md_a8_split(torch, [(eng, session.state), (eng, resumed.state)],
                    system, max(gaps), "replay vs first emission")

    # drill 2: a stall past the watchdog's timeout on a w4a8 replica
    live = [r for r in reps if r.accepting and r.tier == "w4a8"]
    require(len(live) == 1, f"{len(live)} live w4a8 replicas")
    stalled = live[0]
    quarantine_s = []
    plain_quarantine = pool._quarantine

    def timed_quarantine(idx, error):
        t = time.perf_counter()
        plain_quarantine(idx, error)
        quarantine_s.append(time.perf_counter() - t)
    pool._quarantine = timed_quarantine
    stalled.inject_stall(CLUSTER_STALL_S + 5)
    pinned = RequestHandle(graphs[0], time.monotonic(),
                           bucket_capacity=SERVER_BUCKETS[0])
    require(stalled.try_submit(pinned), "the stalling replica refused")
    others = [pool.submit(gr) for gr in graphs[1:4]]
    t0 = time.monotonic()
    stall_results = [h.result(timeout=CLUSTER_STALL_S + 60)
                     for h in [pinned] + others]
    t_resolved = time.monotonic() - t0
    while (pool.stats()["guardrails"]["n_respawned"] < 1
           and time.monotonic() - t0 < CLUSTER_STALL_S + 60):
        time.sleep(0.05)
    fresh = pool._replicas[stalled.replica_id]
    snap = fresh.snapshot()
    require(fresh is not stalled and snap["on_probation"]
            and fresh.device == dev and fresh.engine is not stalled.engine,
            f"no cold restart on probation: {snap}")
    require(fresh.ready.wait(120), "the restarted replica never warmed up")
    g = pool.stats()["guardrails"]
    require(g["n_stalls_detected"] == 1 and g["n_quarantined"] == 1
            and g["n_respawned"] == 1 and len(quarantine_s) == 1
            and pinned.n_requeues >= 1
            and all(np.isfinite(r.energy) for r in stall_results),
            f"stall drill: {g}, pinned requeues {pinned.n_requeues}")
    print(f"  stall drill: {CLUSTER_STALL_S + 5:.0f} s stall on replica "
          f"{stalled.replica_id}, stall_timeout_s {CLUSTER_STALL_S}: its 4 "
          f"requests resolved after {t_resolved:.3f} s on replicas "
          f"{sorted({r.replica_id for r in stall_results})}; quarantine "
          f"(expropriate, requeue, build the engine on {fresh.device}, "
          f"start the replica) {quarantine_s[0]:.3f} s, then its warmup "
          f"{fresh.warmup_s:.3f} s, on probation {CLUSTER_PROBATION_S} s "
          f"[{ident}]")

    # drill 3: a hair-trigger w4a8 replica escalates to w8a8
    hair = GuardrailConfig(envelope=ForceEnvelope(
        limits=tuple((c, 1e-9) for c in SERVER_BUCKETS)))
    w8 = reps[2].engine
    drill = ClusterPool([
        QuantizedEngine.from_quantized(cfg, fresh.engine.qparams, serve,
                                       device=dev, guardrails=hair),
        QuantizedEngine.from_quantized(cfg, w8.qparams, w8.serve,
                                       device=dev)],
        ClusterConfig(max_batch=8, deadline_ms=10.0, warmup=False,
                      max_escalations=1))
    direct8 = QuantizedEngine.from_quantized(cfg, w8.qparams, w8.serve,
                                             device=dev)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    # one summation order for the backward's index_add on both sides
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with drill:
            esc = drill.submit(graphs[0]).result(timeout=120)
        d = direct8.infer_batch([graphs[0]])[0]
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    hops = [(e.from_tier, e.to_tier, e.reason) for e in esc.escalations]
    print(f"  escalation drill: {hops}, served by replica {esc.replica_id};"
          f" against a direct w8a8 call: energy {esc.energy - d.energy}, "
          f"forces max |diff| {float(np.abs(esc.forces - d.forces).max())}"
          f" [{ident}]")
    require(hops == [("w4a8", "w8a8", "force_outlier")]
            and esc.replica_id == 1 and esc.energy == d.energy
            and np.array_equal(esc.forces, d.forces),
            "the escalated result differs from a direct w8a8 call")
    pool.close()
    join_workers([stalled] + pool._replicas, CLUSTER_STALL_S + 60, "phase 7")

    # the serve CLI's cluster flags once, counted
    art = str(Path(tmp) / "w4a8_seed0.npz")
    save_artifact(art, old_w4)
    argv = ["--workload", "so3", "--server", "--artifact", art,
            "--requests", "64", "--rate", "50", "--buckets", "16", "32",
            "--max-batch", "8", "--replicas", "2", "--tiers",
            "w4a8:2,w8a8:1", "--guardrails", "--stall-timeout",
            str(CLUSTER_STALL_S), "--swap-artifact", swap_path,
            "--md-session", "100"]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    try:
        _, cli_launches = counted_run(lambda: cli.main(argv))
    except SystemExit as exc:
        raise SmokeFailure(f"the serve CLI exited with {exc.code}")
    print(f"  CLI (--replicas --tiers --swap-artifact --md-session "
          f"--stall-timeout) launches {cli_launches}")
    require(all(cli_launches[k] > 0 for k in SO3_KERNELS),
            f"the CLI's cluster replay did not run every kernel: "
            f"{cli_launches}")
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s [{ident}]")
    return {**measured, "held": held, "flush_s": flush_s}


# --- phase 8: training on the card -------------------------------------------

@contextlib.contextmanager
def program_calls():
    """Inside the block each ``captured.Programs.run`` is tallied by the
    program's name and key: {(name, key): [captures, replays]} (on the
    card a key's first call captures it, every later one replays)."""
    from repro_torch.captured import Programs
    run, calls = Programs.run, {}

    def counting(self, key, fn, **inputs):
        calls.setdefault((self.name, key), [0, 0])[key in self.programs] += 1
        return run(self, key, fn, **inputs)
    Programs.run = counting
    try:
        yield calls
    finally:
        Programs.run = run


@contextlib.contextmanager
def eager_training_programs():
    """Inside the block ``captured.Programs.run`` calls its function
    eagerly on the card (with the state it carries): the eager side of
    the training programs' checks."""
    from repro_torch.captured import Programs
    run = Programs.run

    def eager(self, key, fn, **inputs):
        if self.state is not None:
            inputs = dict(state=self.state, **inputs)
        return fn(**inputs)
    Programs.run = eager
    try:
        yield
    finally:
        Programs.run = run


HOST_PARTS = ("Python", "autograd engine", "ATen dispatch and launches",
              "DTensor dispatch", "K4 wrapper and checks",
              "waiting for the card", "other")


def host_split(torch, fn):
    """One eager ``fn()`` under torch.profiler (CPU activity), its host
    time split by where the host was: the self time of the autograd
    engine's events (its node bookkeeping and the Python backwards of the
    straight-through estimators it runs), of the ``aten::`` ops (the
    dispatcher and the launches), of DTensor's dispatch (the profiler's
    ``PythonSubclass`` events: sharding propagation and redistribution
    around each DTensor op; and its to/from-local autograd functions), of
    K4's Python wrapper and its argument checks
    (``core.codebook.mddq_encode_kernel``, in a range), of the final host
    read of the loss (``fn`` returns the tensor read), of other named
    events; and Python, the rest of the profiled wall time (the
    interpreter between ops). The engine's thread runs the backward while
    the caller's waits for it, so the threads' times add up to the wall
    time. Returns (wall ms, {part: ms})."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import codebook
    plain = codebook.mddq_encode_kernel

    def k4(*args, **kw):
        with record_function("K4 wrapper and checks"):
            return plain(*args, **kw)
    torch.cuda.synchronize()
    codebook.mddq_encode_kernel = k4
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            out = fn()
            with record_function("waiting for the card"):
                float(out)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        codebook.mddq_encode_kernel = plain
    parts = dict.fromkeys(HOST_PARTS, 0.0)
    for e in prof.events():
        ms = e.self_cpu_time_total / 1e3
        if e.name in parts:
            parts[e.name] += ms
        elif e.name.startswith("autograd::engine") or "Backward" in e.name:
            parts["autograd engine"] += ms
        elif e.name.startswith(("aten::", "cuda")):
            parts["ATen dispatch and launches"] += ms
        elif e.name in ("PythonSubclass", "_ToTorchTensor",
                        "_FromTorchTensor"):
            parts["DTensor dispatch"] += ms
        else:
            parts["other"] += ms
    parts["Python"] = wall - sum(parts.values())
    return wall, parts


def print_host_split(what, wall, parts, ident):
    print(f"  host split of {what} (torch.profiler, CPU time, profiled "
          f"{wall:.1f} ms): " + ", ".join(
              f"{k} {v:.1f} ms ({v / wall:.0%})" for k, v in parts.items())
          + f" [{ident}]")


def _plain(torch, t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def hold_step(torch, progs, key, body, state0, inputs, what,
              kept=lambda state: state, joint=False):
    """A program of ``progs`` replayed from ``state0`` against five eager
    runs of ``body`` from it (the state reset before each): every output
    and every leaf of ``kept(new state)``, bit for bit where the eager
    runs agree bit for bit, else within twice their largest gap (the
    backward's scatters and index-adds sum with atomics). ``joint``: the
    leaves are one trajectory's state, so each gap and spread is taken
    over the leaf's largest |value| and every leaf is held within twice
    the largest spread of any leaf (a position can round alike in five
    eager runs whose forces differ). Prints the worst leaf; returns
    (worst gap, its eager spread)."""
    from repro_torch.captured import copy_into, tree_tensors

    def run(fn):
        copy_into(progs.state, state0)
        out = fn(**inputs)
        return [_plain(torch, t).clone() for t in
                tree_tensors(out) + tree_tensors(kept(progs.state))]
    replayed = run(lambda **kw: progs.run(key, body, **kw))
    eager = [run(lambda **kw: body(state=progs.state, **kw))
             for _ in range(5)]

    def diff(a, b, i):
        d = float((a.double() - b.double()).abs().max())
        return d / max(float(eager[0][i].abs().max()), 1e-30) if joint \
            else d
    spreads = [max(diff(a[i], b[i], i) for a in eager for b in eager)
               for i in range(len(replayed))]
    worst, n_spread = (0.0, 0.0, -1), 0
    for i, r in enumerate(replayed):
        spread = max(spreads) if joint else spreads[i]
        n_spread += spreads[i] > 0
        gap = diff(r, eager[0][i], i)
        ok = torch.equal(r, eager[0][i]) if spread == 0 \
            else gap <= 2 * spread
        require(ok, f"{what}: output {i} of the replay differs from eager "
                    f"by {gap} (five eager runs' largest gap {spread})")
        if gap > worst[0]:
            worst = (gap, spread, i)
    scale = (", both over the leaf's largest |value|, the spread the "
             "largest of any leaf" if joint else "")
    print(f"  {what}: a replay against five eager runs from the same state,"
          f" {len(replayed)} outputs and leaves: "
          f"{len(replayed) - n_spread} bit for bit in every eager run"
          f"{'' if joint else ' and so in the replay'}; the "
          f"largest gap {worst[0]:.3g} (output {worst[2]}, eager spread "
          f"{worst[1]:.3g}{scale}, twice that allowed)")
    copy_into(progs.state, state0)
    return worst[:2]


def paired_ms(torch, fns, n, read):
    """ms per call of each of ``fns`` ({"eager": f, "replay": g}), host
    clock, each call ended by ``read(out)`` (the host read the caller
    makes), in the order eager, replay, replay, eager, ``n`` calls each
    time after one untimed; {name: [ms]}."""
    times = {k: [] for k in fns}
    for how in ("eager", "replay", "replay", "eager"):
        read(fns[how]())
        for _ in range(n):
            t0 = time.perf_counter()
            read(fns[how]())
            times[how].append((time.perf_counter() - t0) * 1e3)
    return times


def replay_idle(torch, prog, reps=5):
    """(host ms median of ``reps`` bare replays, device busy ms of one,
    idle share) of a captured program."""
    from torch.profiler import ProfilerActivity, profile
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prog.replay()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.replay()
        torch.cuda.synchronize()
    busy = sum(r[0] for r in _device_rows(torch, prof))
    host = statistics.median(lat)
    return host, busy, (1 - busy / host) if busy else None, prof


def no_sync_replay(torch, prog, what):
    """One bare replay of ``prog`` under sync-debug "error": any host
    sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"  {what}: a replay ran under torch.cuda.set_sync_debug_mode("
          "'error'): no host sync")


def moved_qat_sites(a_sites, b_sites, qmax=127):
    """Per site, the entries whose A8 code or clip gate (1 inside, 0.5
    exactly on +-qmax, 0 beyond: the straight-through gradient) or MDDQ
    code differ between two runs of the same step."""
    moved = []
    for (kind, a), (_, b) in zip(a_sites, b_sites):
        if kind == "a8":
            def sig(y):
                g = y.abs()
                return (y.clamp(-qmax, qmax).round(),
                        (g < qmax).float() + 0.5 * (g == qmax).float())
            (ca, ga), (cb, gb) = sig(a), sig(b)
            moved.append(int(((ca != cb) | (ga != gb)).sum()))
        else:
            moved.append(int((a != b).sum()))
    return moved


@contextlib.contextmanager
def k4_inputs():
    """The MDDQ encode calls of the QAT model inside the block (through
    ``core.codebook.nearest_code``): [(v, codebook)], cloned."""
    from repro_torch.core import codebook
    plain, calls = codebook.mddq_encode_kernel, []

    def recording(v, cb, **kw):
        calls.append((v.detach().clone(), cb))
        return plain(v, cb, **kw)
    codebook.mddq_encode_kernel = recording
    try:
        yield calls
    finally:
        codebook.mddq_encode_kernel = plain


def only_k4(counts, n, what):
    """``counts`` has n band-search MDDQ launches and nothing else."""
    others = {k: v for k, v in counts.items()
              if k != "mddq_encode_kernel" and v}
    require(counts["mddq_encode_kernel"] == n and not others,
            f"{what}: {counts['mddq_encode_kernel']} K4 launches (expected "
            f"{n}) and {others}")


def step_gap(torch, a, b):
    """(loss gap / |loss|, {leaf: gap / the leaf's largest |g|}) between
    two (loss, aux, grads) of one step, b the reference."""
    (la, _, ga), (lb, _, gb) = a, b
    rel = abs(float(la) - float(lb)) / abs(float(lb))
    return rel, {k: float((ga[k].cpu() - gb[k].cpu()).abs().max()
                          / max(float(gb[k].abs().max()), 1e-30))
                 for k in gb}


def so3_step_replays(torch, dev, ident, cases, data, rots):
    """Phase 8's captured steps against eager: per (label, loss_fn,
    params, K4 launches per step) in ``cases``, the step's program
    (``so3_trainer.step_body`` through ``captured.Programs``, as
    ``train`` runs it) on the first training batch: captured, held
    against five eager runs, its K4 launches (recorded, and the
    profiler's over one replay), a replay under sync-debug "error", ms
    per step eager against replay (paired), a replayed step's idle
    share, capture seconds and graph-pool bytes. Returns {label: (eager
    ms, replay ms)}."""
    import functools
    from repro_torch.captured import Programs, clone_tree, pool_bytes
    from repro_torch.training import so3_trainer as tr
    idx = torch.arange(TRAIN_BATCH, device=dev)
    out = {}
    for label, loss_fn, params, k4, opt in cases:
        body = functools.partial(tr.step_body, loss_fn, opt, data)
        inputs = dict(idx=idx, rotations=rots if loss_fn.use_lee else None)
        state0 = clone_tree((params, opt.init(params)))
        progs = Programs(device=dev, name=f"the {label} step",
                         state=clone_tree(state0))
        progs.run(label, body, **inputs)                   # captures
        prog = progs.programs[label]
        require(prog.launch_counts().get("mddq_encode_kernel", 0) == k4
                and not nonzero({k: v for k, v in prog.launch_counts().items()
                                 if k != "mddq_encode_kernel"}),
                f"{label}: the capture recorded {prog.launch_counts()}, "
                f"expected {k4} K4 launches and nothing else")
        hold_step(torch, progs, label, body, state0, inputs,
                  f"{label} step")
        check_replay_launches(torch, prog, f"one replayed {label} step")
        no_sync_replay(torch, prog, f"{label} step")
        ms = paired_ms(torch, {
            "eager": lambda: body(state=progs.state, **inputs),
            "replay": lambda: progs.run(label, body, **inputs)},
            3, lambda r: float(r[0]))
        host, busy, idle, _ = replay_idle(torch, prog)
        out[label] = (statistics.mean(ms["eager"]),
                      statistics.mean(ms["replay"]))
        print(f"  {label} step, ms per step (host clock, each ended by "
              f"reading its loss, in the order eager, replay, replay, "
              f"eager): eager " + ", ".join(f"{m:.2f}" for m in ms["eager"])
              + "; replay " + ", ".join(f"{m:.2f}" for m in ms["replay"])
              + f"; a bare replay {host:.3f} ms, device busy {busy:.3f} ms, "
              f"idle share " + (f"{idle:.3f}" if idle is not None
                                else "not measured")
              + f"; {capture_seconds([prog])}; graph pool "
              f"{pool_bytes(progs.pool)} bytes [{ident}]")
        del progs, prog, state0
    return out


def nve_segment_replays(torch, dev, ident, cfg, params, test_data):
    """Phase 8's captured NVE segment (``md.nve.nve_segment`` through
    ``captured.Programs``, as ``nve_trajectory`` runs it) of the trained
    gaq_w4a8 model, NVE_HOLD_STEPS steps from ``pipeline.nve_eval``'s
    initial state: held against five eager runs, the profiler's kernels
    over one replay against the recorded launches, a replay under
    sync-debug "error", ms per step eager against replay (paired), idle
    share, capture seconds and graph-pool bytes. Returns (eager ms, replay
    ms) per step."""
    from repro_torch.captured import Programs, clone_tree, pool_bytes
    from repro_torch.core.codebook import make_codebook
    from repro_torch.data.synthetic_md import MASSES, make_ff
    from repro_torch.md.nve import init_state, nve_segment
    from repro_torch.models import so3krates as so3
    cb = make_codebook(cfg.dir_bits, device=dev)
    species, e_scale = test_data["species"], float(test_data["e_scale"])
    masses = torch.tensor(MASSES, dtype=torch.float32, device=dev)

    def force_fn(c):
        return so3.forces(params, cfg, species, c, cb) * e_scale

    def energy_fn(c):
        with torch.no_grad():
            return so3.energy(params, cfg, species, c, cb) * e_scale
    state0 = init_state(7, make_ff(dev)[0], masses, force_fn, 300.0)

    def body(state):
        return nve_segment(state, masses, force_fn, energy_fn, 0.5,
                           NVE_HOLD_STEPS)
    progs = Programs(device=dev, name="the NVE segment",
                     state=clone_tree(state0))
    progs.run(NVE_HOLD_STEPS, body)                         # captures
    prog = progs.programs[NVE_HOLD_STEPS]
    hold_step(torch, progs, NVE_HOLD_STEPS, body, state0, {},
              f"a {NVE_HOLD_STEPS}-step NVE segment")
    check_replay_launches(torch, prog, f"one replayed {NVE_HOLD_STEPS}-step"
                                       " NVE segment")
    no_sync_replay(torch, prog, "the NVE segment")
    ms = paired_ms(torch, {"eager": lambda: body(state=progs.state),
                           "replay": lambda: progs.run(NVE_HOLD_STEPS,
                                                       body)},
                   2, lambda r: float(r))
    ms = {k: [m / NVE_HOLD_STEPS for m in v] for k, v in ms.items()}
    host, busy, idle, _ = replay_idle(torch, prog)
    print(f"  NVE step, ms per step over {NVE_HOLD_STEPS}-step segments "
          f"(host clock, each ended by reading its record, in the order "
          f"eager, replay, replay, eager): eager "
          + ", ".join(f"{m:.3f}" for m in ms["eager"]) + "; replay "
          + ", ".join(f"{m:.3f}" for m in ms["replay"])
          + f"; a bare replay {host / NVE_HOLD_STEPS:.3f} ms per step, "
          f"device busy {busy / NVE_HOLD_STEPS:.3f}, idle share "
          + (f"{idle:.3f}" if idle is not None else "not measured")
          + f"; {capture_seconds([prog])}; graph pool "
          f"{pool_bytes(progs.pool)} bytes [{ident}]")
    return statistics.mean(ms["eager"]), statistics.mean(ms["replay"])


def eval_replays(torch, dev, cfg, params, test_data):
    """``evaluate`` in batches of EVAL_HOLD_BATCH (one program, replayed
    after its first batch) and ``lee_eval`` (4 x 4: one force program,
    replayed 31 times), captured against five eager runs of each (the
    programs called eagerly on the card): equal where the eager runs
    agree, else within twice their largest gap."""
    from repro_torch.training import pipeline
    from repro_torch.training import so3_trainer as tr

    def run():
        ev = tr.evaluate(cfg, params, test_data, batch=EVAL_HOLD_BATCH,
                         device=dev)
        return [ev["e_mae"], ev["f_mae"], pipeline.lee_eval(
            cfg, params, test_data, n_rot=4, n_cfg=4, device=dev)]
    replayed = run()
    with eager_training_programs():
        eager = [run() for _ in range(5)]
    for i, name in enumerate(("E MAE", "F MAE", "LEE")):
        spread = max(abs(a[i] - b[i]) for a in eager for b in eager)
        gap = abs(replayed[i] - eager[0][i])
        print(f"  captured {name} {replayed[i]!r} against eager "
              f"{eager[0][i]!r}: gap {gap:.3g}, five eager runs' largest "
              f"gap {spread:.3g}")
        require(gap == 0 if spread == 0 else gap <= 2 * spread,
                f"the captured {name} differs from eager by {gap} (eager "
                f"spread {spread})")


def sampler_statistics(torch, sampler, coords, veloc, dt_fs, stride):
    """A classical-MD run's statistics: the dataset's e_shift and e_scale
    (eV, as ``_labelled`` takes them), the mean kinetic temperature (K,
    3N degrees of freedom) and the total energy's drift (eV/atom/ps)."""
    from repro_torch.md.nve import _KB, energy_drift_rate
    n = coords.shape[1]
    with torch.no_grad():
        e_pot = sampler.ff.energy(coords).double()
        ke = 0.5 * (sampler.masses[:, None] * veloc ** 2).sum((-1, -2))
    t_kin = (2 * ke.double() / (3 * n * _KB)).mean()
    e_tot = (e_pot + ke.double()).cpu().numpy()
    return {"e_shift": float(e_pot.mean()),
            "e_scale": float(e_pot.std(correction=0)),
            "mean_T": float(t_kin),
            "drift": energy_drift_rate(e_tot, dt_fs, stride, n)}


def md_sampler_replays(torch, dev, ident):
    """Phase 8's classical-MD sampler (``data.synthetic_md``): the frame
    program, captured by the phase's first sample, replayed from one
    state against five eager runs of its body (``hold_step``); then
    SAMPLER_FRAMES-frame runs from seed 1, eager and replayed, timed
    paired, each replay's statistics within SAMPLER_FACTOR times the
    eager runs' largest gap of their median (bit for bit where the eager
    runs agree). Returns {"eager_s": [...], "replay_s": [...],
    "capture": (warm-up s, capture s)}."""
    from repro_torch.data.synthetic_md import frame_sampler, sample_frames_md
    from repro_torch.md.nve import init_state
    stride, dt_fs = 40, 0.5
    sampler = frame_sampler(dev)
    key = (sampler.eq.shape[0], stride, dt_fs)
    prog = sampler.programs.programs.get(key)
    require(prog is not None, f"the sampler captured no frame program "
                              f"{key}: {list(sampler.programs.programs)}")
    state0 = tuple(init_state(0, sampler.eq, sampler.masses,
                              sampler.ff.forces, 300.0))
    with sampler.lock:
        hold_step(torch, sampler.programs, key, sampler.body(stride, dt_fs),
                  state0, {}, f"the classical-MD frame ({stride} steps)",
                  joint=True)

    def run(eager):
        ctx = eager_training_programs() if eager else contextlib.nullcontext()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with ctx:
            coords, veloc = sample_frames_md(1, SAMPLER_FRAMES, dt_fs=dt_fs,
                                             stride=stride, device=dev)
        torch.cuda.synchronize(dev)
        took = time.perf_counter() - t0
        require(bool(torch.isfinite(coords).all()),
                "the sampler: non-finite coordinates")
        return took, sampler_statistics(torch, sampler, coords, veloc,
                                        dt_fs, stride)
    order = ["eager", "replay", "replay", "eager"] \
        + ["eager"] * (SAMPLER_EAGER - 2)
    runs = [(how, *run(how == "eager")) for how in order]
    require(len(sampler.programs.programs) == 1
            and sampler.programs.programs[key] is prog,
            f"the sampler captured again: {list(sampler.programs.programs)}")
    eager = [st for how, _, st in runs if how == "eager"]
    for name in eager[0]:
        vals = [st[name] for st in eager]
        spread = max(vals) - min(vals)
        mid = statistics.median(vals)
        for how, _, st in runs:
            if how != "replay":
                continue
            gap = abs(st[name] - mid)
            ok = gap == 0 if spread == 0 else gap <= SAMPLER_FACTOR * spread
            require(ok, f"the sampler's replayed {name} {st[name]!r} is "
                        f"{gap:.3g} from the eager median {mid!r} "
                        f"({SAMPLER_EAGER} eager runs' largest gap "
                        f"{spread:.3g})")
        print(f"  sampler {name}: eager {vals}, replayed "
              f"{[st[name] for how, _, st in runs if how == 'replay']} "
              f"(each replay within {SAMPLER_FACTOR:g}x the eager runs' "
              f"largest gap {spread:.6g} of their median)")
    secs = {how: [t for h, t, _ in runs if h == how][:2]
            for how in ("eager", "replay")}
    print(f"  the sampler, {SAMPLER_FRAMES} frames x {stride} steps: eager "
          f"{secs['eager']} s against replayed {secs['replay']} s (paired: "
          f"eager, replay, replay, eager); its frame program's warm-up "
          f"{prog.warmup_seconds:.3f} s and capture "
          f"{prog.capture_seconds:.3f} s (instantiation "
          f"{prog.instantiate_seconds:.3f}) [{ident}]")
    return {"eager_s": secs["eager"], "replay_s": secs["replay"],
            "capture": (prog.warmup_seconds, prog.capture_seconds)}


def run_training(torch, dev):
    """Phase 8: sample the azobenzene set on the card, train fp32 at the
    paper's width, QAT-finetune gaq_w4a8 with warm-up and the LEE term,
    evaluate, run NVE on the trained model and serve its weights, with
    the launch gates per step kind; the card against the CPU on one fp32
    and one full QAT step; K4 and the serving kernels at this path's
    shapes; the parameter file bit for bit."""
    import tempfile
    from repro_torch.captured import clone_tree
    from repro_torch.core.codebook import make_codebook
    from repro_torch.core.lee import random_rotations
    from repro_torch.data.synthetic_md import sample_dataset_md
    from repro_torch.kernels.mddq_kernel import mddq_encode_kernel
    from repro_torch.kernels.ref import mddq_encode_ref
    from repro_torch.models import so3krates as so3
    from repro_torch.serving import Graph, QuantizedEngine, ServeConfig
    from repro_torch.tools.so3_grad_conditioning import (
        N_JITTERS, jittered, qat_sites)
    from repro_torch.training import pipeline
    from repro_torch.training import so3_trainer as tr
    t_phase = time.perf_counter()
    ident = gpu_identity()
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys([c.__name__ for c in kernel_counters()], 0)

    def counted(fn):
        out, n = counted_run(fn)
        for k in total:
            total[k] += n[k]
        require(n["mddq_encode_full_search"] == 0,
                "the MDDQ encode took the full search")
        return out, n

    # 1. the data: the pipeline's --fast frames, sampled on the card
    t0 = time.perf_counter()
    data = sample_dataset_md(0, TRAIN_FRAMES + TEST_FRAMES, device=dev)
    train_data, test_data = pipeline._split_data(data, TRAIN_FRAMES)
    e_mev = float(data["e_scale"]) * 1e3
    print(f"  {TRAIN_FRAMES} + {TEST_FRAMES} MD frames sampled on the card "
          f"in {time.perf_counter() - t0:.1f} s (the frame program's "
          f"capture included), e_scale {float(data['e_scale']):.4f} eV")
    md_sampler_replays(torch, dev, ident)
    cfg32 = so3.So3kratesConfig(**pipeline.BASE, **pipeline.METHODS["fp32"])
    cfgq = so3.So3kratesConfig(**pipeline.BASE,
                               **pipeline.METHODS["gaq_w4a8"])
    require(cfgq.dir_bits == 12 and cfg32.n_rbf == 16
            and cfg32.cutoff == 10.0, "not the pipeline's configuration")
    n_steps = TRAIN_FRAMES // TRAIN_BATCH
    qcfg = tr.TrainConfig(epochs=QAT_EPOCHS, warmup_epochs=QAT_WARMUP,
                          batch_size=TRAIN_BATCH, lr=1e-3, lee_weight=1.0,
                          lee_rotations=2)
    species = train_data["species"]
    cb = make_codebook(cfgq.dir_bits, device=dev)
    rots = random_rotations(1, qcfg.lee_rotations)

    # the host time of one eager full QAT step, split, before any capture
    p0 = so3.init_params(cfgq, 0, dev)
    opt0 = tr.make_optimizer(qcfg, QAT_EPOCHS * n_steps)
    state = clone_tree((p0, opt0.init(p0)))
    loss0 = tr.make_loss_fn(cfgq, species, cb, qcfg)
    idx0 = torch.arange(TRAIN_BATCH, device=dev)
    rots0 = torch.as_tensor(rots, device=dev)

    def eager_step():
        return tr.step_body(loss0, opt0, train_data, state, idx0, rots0)[0]
    float(eager_step())
    print_host_split("one eager full QAT step (gaq_w4a8, batch 32, the "
                     "LEE term over 2 rotations)", *host_split(
                         torch, eager_step), ident)
    del p0, state
    with program_calls() as calls:
        # 2. fp32 at the paper's width: no kernel launches
        t0 = time.perf_counter()
        (p32, h32), n32 = counted(lambda: tr.train(
            cfg32, train_data, tr.TrainConfig(
                epochs=FP32_EPOCHS, warmup_epochs=0, batch_size=TRAIN_BATCH,
                lr=5e-3), device=dev))
        t32 = time.perf_counter() - t0
        require(np.isfinite(h32["loss"]).all(), "fp32: non-finite loss")
        require(h32["loss"][-1] < h32["loss"][0],
                f"fp32: the loss did not fall ({h32['loss'][0]} -> "
                f"{h32['loss'][-1]})")
        only_k4(n32, 0, "fp32 training")

        # 3. QAT: warm-up epochs launch nothing, a full step L x (1 + 2 x
        # rotations) K4 band searches (one batched forward, two per rotation)
        per_full = cfgq.n_layers * (1 + 2 * qcfg.lee_rotations)
        t0 = time.perf_counter()
        (pq, hq), nq = counted(lambda: tr.train(cfgq, train_data, qcfg,
                                                init=p32, device=dev))
        tq = time.perf_counter() - t0
        require(np.isfinite(hq["loss"]).all(), "gaq_w4a8: non-finite loss")
        only_k4(nq, (QAT_EPOCHS - QAT_WARMUP) * n_steps * per_full,
                "QAT training")
        warm_n = QAT_WARMUP * n_steps

        def med(xs):
            return statistics.median(xs[1:] if len(xs) > 1 else xs)
        step_ms = {"fp32": med(h32["step_ms"]),
                   "QAT warm-up": med(hq["step_ms"][:warm_n]),
                   "QAT full": med(hq["step_ms"][warm_n:])}
        print(f"  fp32: {FP32_EPOCHS} epochs x {n_steps} steps in "
              f"{t32:.1f} s, "
              f"loss {h32['loss'][0]:.4f} -> {h32['loss'][-1]:.4f}; QAT "
              f"gaq_w4a8: {QAT_EPOCHS} epochs ({QAT_WARMUP} warm-up) in "
              f"{tq:.1f} s, loss {hq['loss'][0]:.4f} -> {hq['loss'][-1]:.4f}")
        print("  ms per training step in train (replayed; host clock, "
              "median, the first step of each kind, its capture, left out): "
              + ", ".join(f"{k} {v:.2f}" for k, v in step_ms.items())
              + f" [{ident}]")

        # one step of each kind in its own window, and the profile of a full
        # step; the same batch and rotations as the card-vs-CPU steps below
        batch = [train_data[k][:TRAIN_BATCH] for k in ("coords", "energy",
                                                       "forces")]
        opt = tr.make_optimizer(qcfg, QAT_EPOCHS * n_steps)
        loss_warm = tr.make_loss_fn(dataclasses.replace(
            cfgq, freeze_vec_quant=True), species, cb, qcfg)
        loss_full = tr.make_loss_fn(cfgq, species, cb, qcfg)
        loss_32 = tr.make_loss_fn(cfg32, species, None, qcfg)

        def step(loss_fn):
            out = tr.train_step(loss_fn, opt, pq, opt.init(pq), *batch, rots)
            float(out[2])
            return out
        _, n_warm = counted(lambda: step(loss_warm))
        only_k4(n_warm, 0, "a QAT warm-up step")
        with k4_inputs() as k4_calls:
            _, n_full = counted(lambda: step(loss_full))
        only_k4(n_full, per_full, "a full QAT step")
        print(f"  launches per step: fp32 0, warm-up 0, full QAT K4 "
              f"{n_full['mddq_encode_kernel']} (L={cfgq.n_layers} x (1 + 2 x "
              f"{qcfg.lee_rotations} rotations)), nothing else")
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            step(loss_full)
            host.append((time.perf_counter() - t0) * 1e3)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(loss_full)
            torch.cuda.synchronize(dev)
        rows = _device_rows(torch, prof)
        busy = sum(r[0] for r in rows)
        if busy:
            print(f"  profiled full QAT step: device busy {busy:.3f} ms, "
                  f"{sum(r[1] for r in rows)} device events; unprofiled "
                  f"{statistics.median(host):.2f} ms (median of 5) -> idle "
                  f"share "
                  f"{1 - busy / statistics.median(host):.3f} [{ident}]")
            for t_ms, count, key in rows[:6]:
                print(f"    {t_ms:9.4f} ms  x{count:<5d} {key[:80]}")
        else:
            print("  profiler: no device time recorded (idle share not "
                  "measured)")

        # K4 at this path's shapes: the batch's vectors and one LEE force call
        require(len(k4_calls) == per_full,
                f"{len(k4_calls)} K4 calls recorded")
        v_batch, cb_k4 = k4_calls[0]
        require(tuple(v_batch.shape) == (TRAIN_BATCH * 24 * cfgq.vec_feat, 3)
                and cb_k4.shape[0] == 2 ** cfgq.dir_bits,
                f"K4 took {tuple(v_batch.shape)} x {cb_k4.shape[0]}")
        _, err_b = _mddq_exact(torch, v_batch, cb_k4, "training batch")
        _, err_l = _mddq_exact(torch, k4_calls[cfgq.n_layers][0], cb_k4,
                               "LEE force call")
        k4 = lambda: mddq_encode_kernel(v_batch, cb_k4)      # noqa: E731
        k4_ms = queued_device_ms(torch, k4)
        k4_event = time_ms(torch, k4, reps=10)
        k4_plain = time_ms(torch, lambda: mddq_encode_ref(v_batch, cb_k4),
                           reps=2, rounds=3)
        pairs, covered = band_work(torch, v_batch, cb_k4, k4()[0])
        k4_bound, k4_by = bound(20 * v_batch.shape[0] + 12 * covered,
                                5 * pairs, FP32_OPS_PER_S)
        print(f"  K4 at the training shape N={v_batch.shape[0]} "
              f"C={cb_k4.shape[0]}: device {k4_ms * 1e3:.3f} us (CUDA events "
              f"behind a sleep kernel), event {k4_event * 1e3:.2f} us (back "
              f"to "
              f"back), plain {k4_plain:.3f} ms, bound {k4_bound * 1e3:.4f} us "
              f"({k4_by}, {pairs} scored pairs) [{ident}]")

        # the card against the CPU: one fp32 and one full QAT step (loss and
        # every gradient leaf), same weights, batch and rotations; the QAT
        # step with the CPU's codes and gates pinned, so that what is left is
        # arithmetic. Float32 rounds some first-layer gradients (layer0/wq,
        # wk, rbf_a) by up to ~2e-3 of their largest |g|, by the data and
        # weights, so each float32 leaf is held within F32_GRAD_FACTOR of the
        # CPU's own float32 spread on it; and both steps run in float64 on
        # both devices, held to 1e-4
        cpu = torch.device("cpu")
        p_cpu = {k: v.cpu() for k, v in pq.items()}
        batch_cpu = [t.cpu() for t in batch]

        def f64(tree):
            if isinstance(tree, dict):
                return {k: v.double() for k, v in tree.items()}
            return [torch.as_tensor(t).double() for t in tree]
        for name, cfg, fn in (("fp32", cfg32, loss_32),
                              ("gaq_w4a8", cfgq, loss_full)):
            fn_cpu = tr.make_loss_fn(
                cfg, species.cpu(), make_codebook(cfg.dir_bits, device=cpu)
                if cfg.quant != "none" else None, qcfg)
            tol = 1e-5 if cfg.quant == "none" else 1e-4
            with qat_sites() as s_card:
                card = tr.loss_and_grads(fn, pq, *batch, rots)
            with qat_sites() as s_cpu:
                host_ = tr.loss_and_grads(fn_cpu, p_cpu, *batch_cpu, rots)
            # the CPU's float32 spread on each leaf: N_JITTERS more runs of
            # its step with the coordinates jittered by an ulp
            spread = dict.fromkeys(host_[2], 0.0)
            for j in range(N_JITTERS):
                with qat_sites(pin=s_cpu):
                    run_j = tr.loss_and_grads(fn_cpu, p_cpu, jittered(
                        batch_cpu[0], j), *batch_cpu[1:], rots)
                gaps_j = step_gap(torch, run_j, host_)[1]
                spread = {k: max(e, gaps_j[k]) for k, e in spread.items()}
            bound32 = {k: max(1e-4, F32_GRAD_FACTOR * e)
                       for k, e in spread.items()}

            def held(step, what):
                rel, leaves = step_gap(torch, step, host_)
                worst = max(leaves, key=lambda k: leaves[k] / bound32[k])
                print(f"  {name} step{what}, card vs CPU in float32: loss "
                      f"{rel:.3g}, worst gradient leaf {worst} "
                      f"{leaves[worst]:.3g} (of the leaf's largest |g|; the "
                      f"CPU's float32 spread {spread[worst]:.3g}, bound "
                      f"{bound32[worst]:.3g})")
                return rel <= tol and leaves[worst] <= bound32[worst], (
                    f"{name}{what}: loss {rel}, {worst} {leaves[worst]} > "
                    f"{bound32[worst]}")
            ok, what = held(card, "")
            pin = None
            if cfg.quant == "none":
                require(ok, what)
            else:
                if not ok:
                    moved = moved_qat_sites(s_card, s_cpu)
                    print(f"  {name}: A8 codes or gates and MDDQ codes that "
                          f"moved, per site: {moved}")
                    require(sum(moved) > 0, f"{what} with no moved code")
                pin = s_cpu
                with qat_sites(pin=pin):
                    pinned = tr.loss_and_grads(fn, pq, *batch, rots)
                require(*held(pinned,
                              " with the CPU's codes and gates pinned"))
            with qat_sites(pin=pin):
                card64 = tr.loss_and_grads(fn, f64(pq), *f64(batch),
                                           f64([rots])[0])
            with qat_sites(pin=pin):
                host64 = tr.loss_and_grads(fn_cpu, f64(p_cpu), *f64(batch_cpu),
                                           f64([rots])[0])
            rel64, leaves64 = step_gap(torch, card64, host64)
            worst64 = max(leaves64, key=leaves64.get)
            print(f"  {name} step in float64"
                  + (" with the CPU's codes and gates pinned" if pin else "")
                  + f", card vs CPU: loss {rel64:.3g}, worst gradient leaf "
                  f"{worst64} {leaves64[worst64]:.3g}")
            require(rel64 <= tol and leaves64[worst64] <= 1e-4,
                    f"{name}: in float64 card and CPU differ by {rel64}, "
                    f"{worst64} {leaves64[worst64]}")

        # 4. evaluation: E/F MAE in meV and LEE (4 rotations x 4 frames)
        ev = {}
        for name, cfg, p in (("fp32", cfg32, p32), ("gaq_w4a8", cfgq, pq)):
            ev[name], n_ev = counted(lambda: tr.evaluate(cfg, p, test_data,
                                                         device=dev))
            only_k4(n_ev, 0 if cfg.quant == "none" else cfg.n_layers
                    * -(-TEST_FRAMES // 32), f"evaluate {name}")
            lee_v, n_lee = counted(lambda: pipeline.lee_eval(
                cfg, p, test_data, n_rot=4, n_cfg=4, device=dev))
            only_k4(n_lee, 0 if cfg.quant == "none" else 32 * cfg.n_layers,
                    f"lee_eval {name}")
            ev[name]["lee"] = lee_v
            print(f"  {name}: E MAE {ev[name]['e_mae'] * e_mev:.3f} meV, "
                  f"F MAE "
                  f"{ev[name]['f_mae'] * e_mev:.3f} meV/A, LEE {lee_v:.6f}")

        # 5. NVE on the trained gaq_w4a8 model
        t0 = time.perf_counter()
        nve, n_nve = counted(lambda: pipeline.nve_eval(cfgq, pq, test_data,
                                                       NVE_STEPS, device=dev))
        only_k4(n_nve, cfgq.n_layers * (1 + NVE_STEPS + NVE_STEPS // 50),
                "nve_eval")
        require(np.isfinite(nve["energies"]).all(), "NVE: non-finite energy")
        print(f"  NVE {NVE_STEPS} steps (gaq_w4a8, dt 0.5 fs): drift "
              f"{nve['drift_ev_per_atom_ps']:.3e} eV/atom/ps, blew_up "
              f"{nve['blew_up']}, {time.perf_counter() - t0:.1f} s")

        # 6. the captured programs against eager, paired in this call
        t0 = time.perf_counter()
        paired = so3_step_replays(torch, dev, ident, (
            ("fp32", loss_32, p32, 0, tr.make_optimizer(
                qcfg, FP32_EPOCHS * n_steps)),
            ("QAT warm-up", loss_warm, pq, 0, opt),
            ("QAT full", loss_full, pq, per_full, opt)), train_data,
            torch.as_tensor(rots, device=dev))
        paired["NVE"] = nve_segment_replays(torch, dev, ident, cfgq, pq,
                                            test_data)
        eval_replays(torch, dev, cfgq, pq, test_data)
    print("  the training programs, captures and replays, over the "
          "phase's pipeline runs and checks: " + "; ".join(
              f"{n} [{k}] {c} + {r}" for (n, k), (c, r) in calls.items()))
    for name, key in (("the SO3 training step", "warm-up"),
                      ("the SO3 training step", "full"),
                      ("the SO3 evaluation batch", EVAL_HOLD_BATCH),
                      ("the LEE force call", 24),
                      ("the NVE segment", 50)):
        require(calls.get((name, key), [0, 0])[1] > 0,
                f"{name} [{key}] was never replayed: {calls}")
    print("  ms per step, eager against replayed (paired, means): "
          + ", ".join(f"{k} {e:.2f} against {r:.3f}"
                      for k, (e, r) in paired.items())
          + f"; the checks took {time.perf_counter() - t0:.1f} s "
          f"[{ident}]")

    # 7. the trained weights served: w4a8, sparse, MDDQ kernel, bucket 32
    sp_np = species.cpu().numpy().astype(np.int32)
    graphs = [Graph(sp_np, c) for c in test_data["coords"].cpu().numpy()]
    eng = QuantizedEngine.from_config(cfgq, params=pq, serve=ServeConfig(
        mode="w4a8", path="sparse", mddq_kernel=True, bucket_sizes=(32,),
        max_batch=8, edge_capacity=1024), device=dev)
    eng.reset_stats()
    served, n_serve = counted(lambda: eng.infer_batch(graphs))
    n_disp = eng.dispatch_stats["sparse"]
    want = predict_launches({("w4a8", "sparse"): n_disp}, cfgq.n_layers)
    got = {k: n_serve[k] for k in want}
    require(n_disp == -(-len(graphs) // 8) and got == want,
            f"serving: {n_disp} dispatches, launches {got}, expected {want}")
    e_q, f_q = so3.energy_and_forces(pq, cfgq, species, test_data["coords"])
    e_s = np.array([r.energy for r in served])
    f_s = np.stack([r.forces for r in served])
    require(np.isfinite(e_s).all() and np.isfinite(f_s).all(),
            "serving: non-finite result")
    gap_e = float(np.abs(e_s - e_q.cpu().numpy()).max()
                  / np.abs(e_q.cpu().numpy()).max())
    gap_f = float(np.abs(f_s - f_q.cpu().numpy()).max()
                  / np.abs(f_q.cpu().numpy()).max())
    print(f"  served (w4a8 sparse, {n_disp} dispatches, launches {got}) vs "
          f"the QAT model: energy {gap_e:.4g}, forces {gap_f:.4g} of the "
          "largest |value| (reported, not gated)")
    held = check_kernel_calls(torch, lambda: eng.infer_batch(graphs[:8]),
                              "phase 8 serve")

    # the parameter file, bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "gaq_w4a8.npz")
        pipeline.save_params(path, pq)
        back = pipeline.load_params(path, dev)
    require(set(back) == set(pq) and all(torch.equal(back[k], pq[k])
                                         for k in pq),
            "load_params(save_params(p)) changed the weights")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    took = time.perf_counter() - t_phase
    print(f"  max_memory_allocated over the phase {peak:.1f} MiB; phase 8 "
          f"took {took:.1f} s [{ident}]")
    require(took <= TRAIN_PHASE_S, f"phase 8 took {took:.1f} s")
    held["mddq_encode_kernel"] = (max(held.get("mddq_encode_kernel",
                                               (0.0, []))[0], err_b, err_l),
                                  held.get("mddq_encode_kernel", (0, []))[1]
                                  + [f"N={v_batch.shape[0]} "
                                     f"C={cb_k4.shape[0]} (training batch)"])
    return {"launches": total, "held": held,
            "k4_training": {"shape": f"N={v_batch.shape[0]} "
                            f"C={cb_k4.shape[0]}", "device_ms": k4_ms,
                            "ms": k4_event, "plain_ms": k4_plain,
                            "bound_ms": k4_bound, "bound_by": k4_by}}


# --- phase 9: the health plane over the served cluster ------------------------

def health_series():
    """Every series the stock SLO catalogue and anomaly detectors read."""
    from repro_torch.obs import default_detectors, default_slos
    names = set()
    for slo in default_slos():
        names |= {slo.metric, slo.bad, slo.total} - {""}
    for det in default_detectors():
        names |= {getattr(det, a) for a in ("gauge", "hist", "counter")
                  if hasattr(det, a)}
    return names


_PROM_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r' (\S+)$')


def parse_prometheus(text, what):
    """{(name, sorted label pairs): value} of a text exposition. Every line
    must be a ``# TYPE`` line of a known kind, another comment, or one
    sample with a float value."""
    samples = {}
    for n, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            parts = line.split()
            require(len(parts) == 4 and parts[3] in ("counter", "gauge",
                                                     "summary"),
                    f"{what}:{n}: bad TYPE line {line!r}")
            continue
        if line.startswith("# "):
            continue
        m = _PROM_SAMPLE.match(line)
        require(m is not None, f"{what}:{n}: not a sample: {line!r}")
        try:
            value = float(m.group(4))
        except ValueError:
            raise SmokeFailure(f"{what}:{n}: value {m.group(4)!r}")
        labels = tuple(sorted(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"',
                                         m.group(2) or "")))
        samples[(m.group(1), labels)] = value
    return samples


def series_in(samples):
    """The series names of parsed samples (a summary's ``_count`` and
    ``_sum`` lines belong to its name)."""
    names = set()
    for name, _ in samples:
        names.add(name)
        for sfx in ("_count", "_sum"):
            if name.endswith(sfx):
                names.add(name[:-len(sfx)])
    return names


@contextlib.contextmanager
def health_threads():
    """Records, in each health-plane thread itself (the monitor's and the
    exporter's loops), its CPU seconds, its loop's start and end
    (``time.monotonic``) and wall seconds when the loop ends and the
    exception that ended it, if one did; and on each monitor, in
    ``_step_times``, the start and end of every ``step_all`` and whether
    its thread made it (the final step on stop is the caller's)."""
    from repro_torch.obs import HealthMonitor, PeriodicExporter
    seen = []
    plain = {cls: cls._run for cls in (HealthMonitor, PeriodicExporter)}
    plain_step = HealthMonitor.step_all

    def wrap(cls, fn):
        def run(self):
            rec = {"thread": cls.__name__, "error": None}
            seen.append(rec)
            t0 = rec["t_start"] = time.monotonic()
            try:
                fn(self)
            except BaseException as exc:
                rec["error"] = repr(exc)
                raise
            finally:
                rec["cpu_s"] = time.thread_time()
                rec["t_end"] = time.monotonic()
                rec["wall_s"] = rec["t_end"] - t0
        return run

    def step_all(self, now=None):
        t0 = time.monotonic()
        try:
            return plain_step(self, now)
        finally:
            self.__dict__.setdefault("_step_times", []).append(
                (t0, time.monotonic(),
                 threading.current_thread() is self._thread))
    for cls, fn in plain.items():
        cls._run = wrap(cls, fn)
    HealthMonitor.step_all = step_all
    try:
        yield seen
    finally:
        for cls, fn in plain.items():
            cls._run = fn
        HealthMonitor.step_all = plain_step


def check_monitor_periods(monitor, thread):
    """Phase 9's monitor gate, from the monitor's own step times: its
    loop waits its interval after each step, so a period is the interval
    plus the step. The first step within one interval (plus the slack) of
    the thread's start, no gap from a step's end to the next step's start
    longer than the interval plus HEALTH_GAP_SLACK_S (the last periodic
    step's end to the loop's end likewise: the stop may cut a wait
    short), and a final step on stop, after the loop ended. Returns
    (periodic steps, the longest gap in seconds)."""
    times = getattr(monitor, "_step_times", [])
    periodic = [(a, b) for a, b, own in times if own]
    final = [(a, b) for a, b, own in times if not own]
    limit = HEALTH_EVAL_S + HEALTH_GAP_SLACK_S
    require(periodic, f"the health monitor made no periodic step over "
                      f"{thread['wall_s']:.3f} s")
    starts = [thread["t_start"]] + [b for _, b in periodic]
    ends = [a for a, _ in periodic] + [thread["t_end"]]
    gaps = [e - s for s, e in zip(starts, ends)]
    worst = max(gaps)
    require(worst <= limit,
            f"the health monitor missed a period: a gap of {worst:.3f} s "
            f"(> {HEALTH_EVAL_S} s + {HEALTH_GAP_SLACK_S} s slack) among "
            f"its {len(periodic)} steps over {thread['wall_s']:.3f} s")
    require(final and final[-1][0] >= thread["t_end"],
            "the health monitor made no final step on stop")
    return len(periodic), worst


def check_health_files(args, files, threads):
    """Phase 9 (a)'s gates on one CLI run with the health plane on: the
    metrics file, the trace file, the timeline, the alerts file, the
    health-plane threads (``threads``: :func:`health_threads`' records).
    Returns the file sizes and the alerts fired."""
    from repro_torch.obs import (Alert, load_traces, validate_chrome_trace,
                                 write_chrome_trace)
    for k, path in files.items():
        require(Path(path).is_file() and (k == "a.jsonl"
                                          or Path(path).stat().st_size > 0),
                f"the CLI wrote no {k}")
    # the metrics file: Prometheus text holding the catalogue's series
    samples = parse_prometheus(Path(files["m.prom"]).read_text(), "m.prom")
    written = series_in(samples)
    # the CLI arms no MD drift limit and no LEE probe, and a clean replay
    # has no pool event unless an alert lands: the chaos drill writes these
    unarmed = {"md_energy_drift_ratio", "engine_lee_probe_level",
               "pool_events_total"}
    missing = health_series() - unarmed - written
    require(not missing, f"m.prom lacks the series {sorted(missing)}")
    submitted = sum(v for (name, lb), v in samples.items()
                    if name == "serve_requests_total"
                    and ("event", "submitted") in lb)
    require(submitted == HEALTH_REQUESTS,
            f"m.prom counts {submitted} submitted of {HEALTH_REQUESTS}")
    errors = [k for k, v in samples.items()
              if k[0] == "repro_obs_health_eval_errors_total" and v > 0]
    require(not errors, f"health-plane evaluation errors {errors}")
    # the loops swallow a failed export or step: each interval of the
    # exporter's life must show one (the last may race the stop), plus the
    # final export on stop; the monitor's periods are counted from its own
    # step times (its loop waits the interval after each step)
    life = {t["thread"]: t["wall_s"] for t in threads}
    exports = int(life["PeriodicExporter"] / HEALTH_EXPORT_S)
    require(args._exporter.n_exports >= max(3, exports),
            f"{args._exporter.n_exports} exports over "
            f"{life['PeriodicExporter']:.3f} s: fewer than two periodic ones "
            "before the final, or a failed export")
    n_periodic, worst_gap = check_monitor_periods(
        args._health, next(t for t in threads
                           if t["thread"] == "HealthMonitor"))
    print(f"  health monitor: {n_periodic} periodic steps over "
          f"{life['HealthMonitor']:.3f} s, longest gap between steps "
          f"{worst_gap:.3f} s (interval {HEALTH_EVAL_S} s + slack "
          f"{HEALTH_GAP_SLACK_S} s), a final step on stop")
    # the trace file: one trace per request and per session chunk
    text = Path(files["t.jsonl"]).read_text()
    docs = load_traces(files["t.jsonl"])
    require(text.splitlines() == [json.dumps(d, separators=(",", ":"),
                                             sort_keys=True) for d in docs],
            "load_traces does not round-trip t.jsonl")
    kinds = [d["kind"] for d in docs]
    session = args._session
    require(kinds.count("request") == HEALTH_REQUESTS
            and kinds.count("chunk") == session.config.n_chunks
            and session.n_retries == 0 and len(docs) == len(kinds)
            == len({d["trace_id"] for d in docs})
            and all(d["status"] == "ok" for d in docs),
            f"t.jsonl: {kinds.count('request')} request and "
            f"{kinds.count('chunk')} chunk traces for {HEALTH_REQUESTS} "
            f"requests and {session.config.n_chunks} chunks")
    pool = args._pool
    flushes, warm = pool.flush_records(), pool.warmup_records()
    flushed = {t for f in flushes for t in f.trace_ids}
    require(flushed == {d["trace_id"] for d in docs
                        if d["kind"] == "request"},
            "the flush records and the request traces name other requests")
    # the timeline: traces, flushes and warmups, validated
    files["timeline.json"] = str(Path(files["m.prom"]).with_name(
        Path(files["m.prom"]).name.replace("m.prom", "timeline.json")))
    doc = write_chrome_trace(files["timeline.json"], docs, flushes, warm)
    verdict = validate_chrome_trace(doc)
    other = doc["otherData"]
    require(verdict["ok"] and verdict["n_async_trees"] == len(docs)
            and other["n_flushes"] == len(flushes) > 0
            and other["n_flushes_skipped"] == 0
            and other["n_warmup"] == len(warm) > 0,
            f"the timeline: {verdict}, {other}")
    # the alerts file: exactly the alerts the bus published
    lines = Path(files["a.jsonl"]).read_text().splitlines()
    alerts = [json.loads(ln) for ln in lines]
    keys = set(Alert(name="", severity="", source="", message="").to_json())
    require(len(alerts) == args._alert_bus.n_published
            and all(set(a) == keys for a in alerts),
            f"a.jsonl holds {len(alerts)} lines, the bus published "
            f"{args._alert_bus.n_published}")
    sizes = {k: Path(p).stat().st_size for k, p in files.items()}
    print(f"  files (bytes): {sizes}; {len(samples)} samples of "
          f"{len(written)} series; {len(docs)} traces; timeline "
          f"{verdict['n_events']} events, {other['n_flushes']} flushes, "
          f"{other['n_warmup']} warmup runs, max span-sum error "
          f"{verdict['max_sum_err_us']} us")
    return sizes, [(a["name"], a["severity"], a["value"]) for a in alerts]


def chaos_arm(dev, cfg, qp, serve, chaos, stall_s, root):
    """One arm of the chaos drill (the card's twin of the JAX package's
    ``tests/test_obs_health.py::TestChaosReplay``): a 4-replica pool under
    ``HealthMonitor`` driving ``SLOEvaluator`` and ``AnomalyMonitor``,
    background traffic, and in the chaos arm pinned requests on
    hair-trigger w4a8 replicas, an in-flight kill and a stall past
    ``stall_s``; then an MD session (``drift_limit=1e-12`` in the chaos
    arm) on a watchdog-free pool. Every replica runs the sampled LEE
    probe every second call. Returns (alerts fired, the pool's alert
    stats, the arm's registry exposition parsed)."""
    from repro_torch.cluster import ClusterConfig, ClusterPool
    from repro_torch.guardrails import ForceEnvelope, GuardrailConfig
    from repro_torch.md import MDConfig
    from repro_torch.obs import (REGISTRY, AlertBus, AnomalyMonitor,
                                 HealthMonitor, SLOEvaluator,
                                 default_detectors, default_slos,
                                 prometheus_text)
    from repro_torch.server import RequestHandle
    from repro_torch.serving import Graph, QuantizedEngine
    from repro_torch.sessions import SessionConfig, SessionManager
    REGISTRY.reset()
    probe = GuardrailConfig(lee_probe_every=2)
    hair = dataclasses.replace(probe, envelope=ForceEnvelope(
        limits=tuple((c, 1e-9) for c in SERVER_BUCKETS)))

    def engine(tier, guard=probe):
        return QuantizedEngine.from_quantized(
            cfg, qp[tier], dataclasses.replace(serve, mode=tier),
            device=dev, guardrails=guard)
    tiers = ["w4a8", "w4a8", "w8a8", "w8a8"] if chaos else ["w8a8"] * 4
    engines = [engine(t, hair if t == "w4a8" else probe) for t in tiers]
    pool = ClusterPool(engines, ClusterConfig(
        n_replicas=4, max_batch=8, deadline_ms=2.0, warmup=True,
        max_escalations=1, max_queue=64, stall_timeout_s=stall_s,
        watchdog_interval_s=0.1, probation_s=0.1))
    started = list(pool._replicas)
    bus = AlertBus(registry=REGISTRY)
    fired = []
    bus.subscribe(fired.append)
    slos = default_slos(fast_window_s=0.6, slow_window_s=1.8,
                        latency_p99_s=30.0, allow_partial=True)
    monitor = HealthMonitor(
        [SLOEvaluator(slos, registry=REGISTRY, bus=bus),
         AnomalyMonitor(default_detectors(), registry=REGISTRY, bus=bus)],
        interval_s=0.1).start()
    pool.watch_alerts(bus)
    rng = np.random.default_rng(0)

    def graph(seed):
        """The JAX test's 10-atom molecule of ``seed``."""
        return Graph(*make_molecule(10, cfg.n_species, 0.1, seed))
    try:
        handles = []
        for i in range(12):                   # paced background traffic
            handles.append(pool.submit(graph(100 + i)))
            time.sleep(0.04)
        if chaos:
            # fault 1: requests pinned to a hair-trigger w4a8 replica
            # re-run a tier up
            for k in range(3):
                h = RequestHandle(graph(500 + k), time.monotonic(),
                                  bucket_capacity=SERVER_BUCKETS[0])
                require(pool._replicas[0].try_submit(h),
                        "the hair-trigger replica refused")
                handles.append(h)
            # fault 2: an in-flight replica kill -> failover requeue
            rep3 = pool._replicas[3]
            pool.kill_replica(3, mode="in_flight")
            h = RequestHandle(graph(600), time.monotonic(),
                              bucket_capacity=SERVER_BUCKETS[0])
            require(rep3.try_submit(h), "the killed replica refused")
            handles.append(h)
            # fault 3: an engine-lock stall past the watchdog's timeout
            rep1 = pool._replicas[1]
            rep1.inject_stall(stall_s + 1.5)
            h = RequestHandle(graph(700), time.monotonic(),
                              bucket_capacity=SERVER_BUCKETS[0])
            require(rep1.try_submit(h), "the stalling replica refused")
            handles.append(h)
        for h in handles:
            h.result(timeout=stall_s + 120)
        pool_alerts = pool.stats()["alerts"]
    finally:
        pool.close()
    join_workers(started + pool._replicas, stall_s + 60, "the chaos drill")
    # fault 4: an MD session, drifting (chaos) or not, on a pool with no
    # watchdog (a chunk is one long unit of worker time)
    md_pool = ClusterPool([engine("w8a8", None) for _ in range(2)],
                          ClusterConfig(n_replicas=2, max_batch=8,
                                        warmup=False, max_queue=64))
    try:
        md = MDConfig(mode="w8a8", dt_fs=0.25, record_every=10,
                      mddq_kernel=True, drift_limit=1e-12 if chaos else None)
        scfg = SessionConfig(n_steps=40, chunk_steps=20, record_every=10,
                             checkpoint_every=1, md=md)
        n = 10
        side = (n / 0.1) ** (1.0 / 3.0)
        mgr = SessionManager(md_pool, str(Path(root) / ("chaos" if chaos
                                                       else "clean")))
        s = mgr.start(rng.integers(0, cfg.n_species, n).astype(np.int32),
                      rng.uniform(0, side, size=(n, 3)).astype(np.float32),
                      np.full(n, 12.0, np.float32), seed=5, config=scfg)
        try:
            status = s.wait(120)
        except Exception as exc:               # the session's fatal error
            status = f"failed ({type(exc).__name__})"
        require(status.startswith("failed") if chaos else status == "done",
                f"the {'drifting' if chaos else 'clean'} session ended "
                f"{status}")
        mgr.close()
        time.sleep(0.5)                        # let the windows catch up
    finally:
        monitor.stop(final_step=True)
        md_pool.close()
    samples = parse_prometheus(prometheus_text(registry=REGISTRY),
                               "the drill's exposition")
    errors = [k for k, v in samples.items()
              if k[0] == "repro_obs_health_eval_errors_total" and v > 0]
    require(not errors, f"health-plane evaluation errors {errors}")
    return fired, pool_alerts, samples


def run_health(torch, dev, cfg, artifact, flush_s):
    """Phase 9: the serve CLI with the health plane (``--metrics-out
    --trace-out --alerts-out``) over phase 6's artifact and traffic, with
    a tiered fleet and an MD session, counted and gated, paired with the
    same run with the plane off; then the chaos drill's clean and chaos
    arms. ``flush_s`` are phase 7's flush times, which set the drill's
    stall timeout. Returns {"launches": the counted run's launches}."""
    import tempfile
    from repro_torch.kernels import _launch
    from repro_torch.launch import serve as cli
    from repro_torch.models.so3krates import init_params
    from repro_torch.obs import REGISTRY, default_detectors
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.qparams import quantize_so3_params
    ident = gpu_identity()
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_health_"))
    base = ["--workload", "so3", "--server", "--artifact", artifact,
            "--tiers", HEALTH_TIERS, "--guardrails", "--md-session",
            str(HEALTH_SESSION_STEPS), "--requests", str(HEALTH_REQUESTS),
            "--rate", str(SERVER_RATE), "--min-atoms", "9", "--max-atoms",
            "24", "--density", "0.1", "--deadline-ms", "10", "--seed", "0"]
    if dev.type != "cuda":
        base += ["--device", str(dev)]
    L = cfg.n_layers
    runs, gated = [], None
    for i, arm in enumerate(HEALTH_ORDER):
        files = {k: str(tmp / f"run{i}_{k}") for k in ("m.prom", "t.jsonl",
                                                       "a.jsonl")}
        argv = base + (["--metrics-out", files["m.prom"], "--trace-out",
                        files["t.jsonl"], "--alerts-out", files["a.jsonl"],
                        "--export-interval", str(HEALTH_EXPORT_S),
                        "--health-interval", str(HEALTH_EVAL_S)]
                       if arm == "on" else [])
        REGISTRY.reset()          # the files count this run alone
        count = gated is None and arm == "on"
        t0 = time.perf_counter()
        try:
            with health_threads() as threads:
                if count:
                    d0 = dispatch_counts()
                    with counted_force_calls() as force_calls:
                        args, launches = counted_run(lambda: cli.main(argv))
                    by_role = _launch.role_launches()
                    d1 = dispatch_counts()
                else:
                    args = cli.main(argv)
        except SystemExit as exc:
            raise SmokeFailure(f"the serve CLI exited with {exc.code}")
        wall = time.perf_counter() - t0
        res = args._result
        s = res.summary()
        require(s["n_requests"] == HEALTH_REQUESTS and res.n_shed == 0,
                f"run {i}: {s['n_requests']} of {HEALTH_REQUESTS} resolved,"
                f" {res.n_shed} shed")
        require(all(t["error"] is None for t in threads)
                and sorted(t["thread"] for t in threads)
                == (["HealthMonitor", "PeriodicExporter"] if arm == "on"
                    else []),
                f"run {i}: health-plane threads {threads}")
        cpu = {t["thread"]: t["cpu_s"] for t in threads}
        runs.append((arm, s, wall, cpu))
        print(f"  run {i}, health plane {arm}: p50 {s['p50_ms']:.3f} ms, "
              f"p95 {s['p95_ms']:.3f}, p99 {s['p99_ms']:.3f}; "
              f"{s['throughput_rps']:.2f} req/s; {wall:.3f} s; thread CPU "
              f"s {cpu} [{ident}]")
        if count:
            gated = launches
            flush_runs = {k: int(d1[k] - d0[k]) for k in d0}
            warm = {}
            for w in args._pool.warmup_records():
                key = (w["mode"], w["path"])
                warm[key] = warm.get(key, 0) + 1
            print(f"  dispatches {flush_runs}; warmup runs {warm}; MD force "
                  f"calls {force_calls}; launches {launches}")
            check_roles(role_predictions(flush_runs, warm, force_calls, L),
                        by_role, launches, "the health plane's run")
            require(all(launches[k] > 0 for k in SO3_KERNELS),
                    f"the health plane's run did not run every kernel: "
                    f"{launches}")
            _, alerts = check_health_files(args, files, threads)
            print(f"  alerts on the replay (reported, not gated): "
                  f"{alerts or 'none'} [{ident}]")
    on = [r for r in runs if r[0] == "on"]
    off = [r for r in runs if r[0] == "off"]
    for key in ("p50_ms", "p95_ms", "p99_ms", "throughput_rps"):
        print(f"  {key}: plane on {[round(r[1][key], 3) for r in on]}, off "
              f"{[round(r[1][key], 3) for r in off]} [{ident}]")

    # (b) the chaos drill at the paper's width
    serve = ServeConfig(mode="w4a8", bucket_sizes=SERVER_BUCKETS,
                        max_batch=8, edge_capacity=1024, path="sparse",
                        mddq_kernel=True)
    params = init_params(cfg, 0, dev)
    qp = {t: quantize_so3_params(params, t) for t in ("w4a8", "w8a8")}
    # a stall must outlast any flush by far: ten times the longest of
    # phase 7's flushes on this card, and at least 1 s
    stall_s = max(1.0, 10.0 * max(flush_s))
    print(f"  chaos drill: stall timeout {stall_s:.3f} s (10x phase 7's "
          f"longest flush, {max(flush_s) * 1e3:.3f} ms, of {len(flush_s)}; "
          "at least 1 s)")
    required = {"escalation_rate", "replica_failure", "replica_stall",
                "md_energy_drift", "session_frame_loss"}
    allowed = required | {d.name for d in default_detectors()}
    for chaos in (False, True):
        t0 = time.perf_counter()
        fired, pool_alerts, samples = chaos_arm(
            dev, cfg, qp, serve, chaos, stall_s, tmp / "sessions")
        names = {a.name for a in fired}
        print(f"  {'chaos' if chaos else 'clean'} arm, "
              f"{time.perf_counter() - t0:.3f} s: alerts "
              f"{[(a.name, a.severity, round(a.value, 6)) for a in fired]}"
              f"; the pool saw {pool_alerts['n_seen']} [{ident}]")
        if not chaos:
            require(not fired, f"the clean arm fired {sorted(names)}")
            continue
        require(required <= names <= allowed,
                f"the chaos arm fired {sorted(names)}: missing "
                f"{sorted(required - names)}, unattributed "
                f"{sorted(names - allowed)}")
        by_name = {a.name: a for a in fired}
        require(by_name["md_energy_drift"].value > 1.0
                and by_name["replica_stall"].evidence["delta"] >= 1.0
                and by_name["escalation_rate"].evidence["fast_burn"] >= 1.0,
                "the chaos arm's alerts carry the wrong evidence")
        require(pool_alerts["n_seen"] >= 1
                and {a["name"] for a in pool_alerts["recent"]} & names,
                f"the pool saw no alert: {pool_alerts}")
        missing = health_series() - series_in(samples)
        require(not missing,
                f"the chaos arm's exposition lacks {sorted(missing)}")
    took = time.perf_counter() - t_phase
    print(f"  phase 9 took {took:.1f} s [{ident}]")
    require(took <= HEALTH_PHASE_S,
            f"phase 9 took {took:.1f} s, over {HEALTH_PHASE_S:.0f}")
    return {"launches": gated}


# --- phase 10: the dense LM's prefill, and decode from it --------------------

def prefill_work(cfg, served_bytes, B, S):
    """(bytes, operations) of one prefill as ``models/lm/transformer
    .forward`` computes it: every product of the layers (the q, k, v, o
    projections and the MLP), the head, and the attention over full rows
    (``causal_attention`` multiplies the masked half too), at 2
    operations a multiply-add; the bytes read once (the served weights
    and the token ids) and the float32 logits written once."""
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mlp = {"swiglu": 3, "squared_relu": 2, "none": 0}[cfg.mlp_kind]
    per_token = (2 * d * hd * (2 * nh + 2 * nkv) + 2 * mlp * d * cfg.d_ff
                 + 4 * S * hd * nh)
    n_ops = B * S * (cfg.n_layers * per_token + 2 * d * cfg.vocab)
    return served_bytes + B * S * 8 + B * S * cfg.vocab * 4, n_ops


@contextlib.contextmanager
def checked_lm_kernels(torch, seen):
    """Within the block, every call of the decode's two kernel entries
    (``ops.append_kv_int8``, ``ops.decode_attention_int8kv``) is held
    against its plain version on the inputs it was given, right after it
    runs: the KV write byte for byte over the layer's whole cache (its
    plain version on a copy of the cache as the call found it), the
    attention within 1e-5. ``seen`` gathers {kernel: (max error, shapes)}.
    The plain versions launch no kernel of the port, so the counts of a
    ``counted_run`` around the block are the decode's own."""
    from repro_torch.kernels import ops, ref
    saved = {k: getattr(ops, k) for k in ("append_kv_int8",
                                          "decode_attention_int8kv")}

    def note(name, err, shape):
        e0, shapes = seen.get(name, (0.0, []))
        seen[name] = (max(e0, err), shapes + [shape] * (shape not in shapes))

    def append(k_new, v_new, k_q, k_s, v_q, v_s, cur, rep=1):
        want = [t.clone() for t in (k_q, k_s, v_q, v_s)]
        saved["append_kv_int8"](k_new, v_new, k_q, k_s, v_q, v_s, cur, rep)
        ref.kv_append_int8_ref(k_new, v_new, *want, cur, rep)
        same = (torch.equal(k_q, want[0]) and torch.equal(v_q, want[2])
                and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in ((k_s, want[1]), (v_s, want[3]))))
        B, nkv, hd = k_new.shape
        shape = (f"B={B} nkv={nkv} hd={hd} replicate={rep} "
                 f"S={k_q.shape[2]} {str(k_new.dtype)[6:]}")
        require(same, f"kv_append_int8 at {shape} cur={cur} differs from "
                      "its plain version")
        note("kv_append_int8", 0.0, shape)

    def attend(q, k_q, k_s, v_q, v_s, n_valid, scale):
        out = saved["decode_attention_int8kv"](q, k_q, k_s, v_q, v_s,
                                               n_valid, scale)
        want = ref.decode_attention_int8kv_ref(q, k_q, k_s, v_q, v_s,
                                               n_valid, scale)
        err = float((out - want).abs().max())
        shape = (f"BH={q.shape[0]} G={q.shape[1]} D={q.shape[2]} "
                 f"S={k_q.shape[1]}")
        require(torch.allclose(out, want, rtol=1e-5, atol=1e-5),
                f"decode_attention_int8kv at {shape} n_valid={n_valid} "
                f"differs from its plain version by {err}")
        note("decode_attention_int8kv", err, shape)
        return out
    ops.append_kv_int8, ops.decode_attention_int8kv = append, attend
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def tree_tensors(tree):
    from repro_torch.captured import tree_tensors as leaves
    return leaves(tree)


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def only_lm_kernels(launches, n, what):
    """K5' and K6 launched ``n`` times each and no other kernel."""
    for name, count in launches.items():
        want = n if name in LM_KERNELS else 0
        require(count == want, f"{what}: {name} launched {count} times, "
                               f"expected {want}")


def host_ms(torch, fn, reps):
    """Median host-clock ms of ``reps`` calls of ``fn``, each ended by a
    synchronize (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat)


def profile_prefill(torch, fn, wall_ms, what="prefill"):
    """Device busy, idle share and the ten longest kernels of one profiled
    call of ``fn`` (a prefill, or ``what``), beside the median unprofiled
    host time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _device_rows(torch, prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("  profiler: no device time recorded (idle share not "
              "measured)")
        return
    print(f"  profiled {what}: device busy {busy:.3f} ms over "
          f"{sum(r[1] for r in rows)} device events; unprofiled "
          f"{wall_ms:.3f} ms -> idle share {1 - busy / wall_ms:.3f}")
    for t_ms, count, key in rows[:10]:
        print(f"    {t_ms:9.4f} ms  x{count:<4d} {key[:90]}")


def card_top(torch, cfg, gen, dev):
    """``init_lm``'s leaves outside the blocks (embeddings N(0, 0.02^2),
    the untied head N(0, 1) / sqrt(d), the final norm 1), drawn on the
    card from ``gen``."""
    d = cfg.d_model
    p = {"embed": torch.randn((cfg.vocab, d), generator=gen,
                              device=dev).mul_(0.02),
         "final_norm": torch.full((d,), 1.0, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn((d, cfg.vocab), generator=gen,
                                   device=dev).mul_(d ** -0.5)
    return p


def card_blocks(torch, cfg, gen, dev):
    """``init_lm``'s ``blocks`` (and zamba2's ``shared``) for any block
    pattern, with its scales (projections N(0, 1) / sqrt(fan_in), norms
    1, biases 0, tau = attn_tau; MoE experts / sqrt(d) and / sqrt(ff);
    Mamba2 conv taps N(0, 0.01), A_log 0, D 1, dt_bias 0; the sLSTM's
    recurrence / sqrt(dh)), drawn on the card from ``gen``."""
    from repro_torch.models.lm.transformer import n_groups
    d, G, hd = cfg.d_model, n_groups(cfg), cfg.hd
    nh, nkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def dense(lead, fan_in, fan_out):
        return normal(*lead, fan_in, fan_out, scale=fan_in ** -0.5)

    def full(shape, value):
        return torch.full(shape, value, device=dev)

    def attn(lead):
        a = {"wq": dense(lead, d, nh * hd), "wk": dense(lead, d, nkv * hd),
             "wv": dense(lead, d, nkv * hd), "wo": dense(lead, nh * hd, d)}
        if cfg.qkv_bias:
            a.update(bq=full(lead + (nh * hd,), 0.0),
                     bk=full(lead + (nkv * hd,), 0.0),
                     bv=full(lead + (nkv * hd,), 0.0))
        if cfg.qk_norm:
            a["tau"] = full(lead, cfg.attn_tau)
        return a

    def mlp(lead):
        if cfg.mlp_kind == "swiglu":
            return {"wg": dense(lead, d, ff), "wu": dense(lead, d, ff),
                    "wd": dense(lead, ff, d)}
        return {"wi": dense(lead, d, ff), "wd": dense(lead, ff, d)}

    if cfg.block_pattern == "transformer":
        lead = (G,)
        b = {"ln1": full((G, d), 1.0), "ln2": full((G, d), 1.0),
             "attn": attn(lead)}
        if cfg.moe:
            E = cfg.n_experts
            b["moe"] = {"router": dense(lead, d, E),
                        "wg": normal(G, E, d, ff, scale=d ** -0.5),
                        "wu": normal(G, E, d, ff, scale=d ** -0.5),
                        "wd": normal(G, E, ff, d, scale=ff ** -0.5)}
        elif cfg.mlp_kind != "none":
            b["mlp"] = mlp(lead)
        return {"blocks": b}
    if cfg.block_pattern == "zamba2":
        lead = (G, cfg.zamba_mamba_per_attn)
        di, H = cfg.d_inner, cfg.n_ssm_heads
        GN = cfg.ssm_groups * cfg.ssm_state
        m = {"w_z": dense(lead, d, di), "w_x": dense(lead, d, di),
             "w_B": dense(lead, d, GN), "w_C": dense(lead, d, GN),
             "w_dt": dense(lead, d, H),
             "conv_w": normal(*lead, 4, di, scale=0.1),
             "conv_b": full(lead + (di,), 0.0),
             "A_log": full(lead + (H,), 0.0), "D": full(lead + (H,), 1.0),
             "dt_bias": full(lead + (H,), 0.0),
             "norm_w": full(lead + (di,), 1.0),
             "out_proj": dense(lead, di, d)}
        return {"blocks": {"mamba": {"ln": full(lead + (d,), 1.0), "m": m}},
                "shared": {"ln1": full((d,), 1.0), "ln2": full((d,), 1.0),
                           "attn": attn(()), "mlp": mlp(())}}
    lead = (G, cfg.xlstm_mlstm_per_slstm)
    di, H = d * cfg.xlstm_proj_factor, cfg.n_heads
    dk, dv, dh = di // H // 2, di // H, d // H
    mb = {"w_gate": dense(lead, d, di), "w_up": dense(lead, d, di),
          "wq": dense(lead, di, H * dk), "wk": dense(lead, di, H * dk),
          "wv": dense(lead, di, H * dv), "wif": dense(lead, di, 2 * H),
          "norm_w": full(lead + (di,), 1.0), "down": dense(lead, di, d)}
    sb = {"w_in": dense((G,), d, 4 * d),
          "r": normal(G, H, dh, 4 * dh, scale=dh ** -0.5),
          "b": full((G, 4 * d), 0.0), "norm_w": full((G, d), 1.0),
          "down": dense((G,), d, d)}
    return {"blocks": {"mlstm": {"ln": full(lead + (d,), 1.0), "b": mb},
                       "slstm": {"ln": full((G, d), 1.0), "b": sb}}}


def card_init_lm(torch, cfg, gen, dev):
    """``init_lm``'s tree with its scales (:func:`card_top`,
    :func:`card_blocks`), any block pattern, drawn on the card from
    ``gen``: the published widths' billions of draws would take minutes
    through numpy."""
    return dict(card_top(torch, cfg, gen, dev),
                **card_blocks(torch, cfg, gen, dev))


def _tree_spec(tree):
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


def k6_bound(q_shape, n_valid):
    """(us, what bounds it) of one K6 call: q and the output (BH, G, D)
    float32 once, the n_valid int8 K and V rows and their float32 scales
    once; QK and PV at 2 operations a multiply-add, float32."""
    rows, g, hd = q_shape
    n_bytes = 2 * rows * g * hd * 4 + rows * n_valid * (2 * hd + 8)
    ms, by = bound(n_bytes, rows * n_valid * (4 * g * hd + 2 * hd),
                   FP32_OPS_PER_S)
    return ms * 1e3, by


def record_k6_call(torch, run):
    """K6's device us per call on the inputs of its last call in
    ``run()`` (CUDA events around calls queued behind a sleep kernel:
    the profiler has lost events of so short a kernel), that call's
    shape and its bound (:func:`k6_bound`: us, what bounds it)."""
    from repro_torch.kernels import ops
    saved, calls = ops.decode_attention_int8kv, []

    def recording(*args):
        calls.append(args)
        return saved(*args)
    ops.decode_attention_int8kv = recording
    try:
        run()
    finally:
        ops.decode_attention_int8kv = saved
    q, k_q, k_s, v_q, v_s, valid, scale = calls[-1]
    # a count, or the decode position on the device: tokens [0, p]
    n_valid = int(valid) + 1 if isinstance(valid, torch.Tensor) else valid
    ms = queued_device_ms(
        torch, lambda: saved(q, k_q, k_s, v_q, v_s, valid, scale))
    return (ms * 1e3, f"BH={q.shape[0]} G={q.shape[1]} D={q.shape[2]} "
                      f"n_valid={n_valid}", k6_bound(tuple(q.shape), n_valid))


def run_prefill_and_decode(torch, dev, lm):
    """Phase 10 (the module docstring): (a) the prefill of phase 4's
    model, (b) the decode from its tokens, (c) the four other dense
    configs at their published widths, one layer deep, (d) the int4 KV
    cache on the card against the CPU."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm.transformer import (init_cache, init_lm,
                                                   lm_head)
    from repro_torch.quant.apply import quantize_params_tree, quantized_bytes
    t_phase, ident = time.perf_counter(), gpu_identity()
    cfg = lm.cfg
    gen = torch.Generator(device=dev).manual_seed(10)
    launches, held = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the prefill at full width, its chunk invariance and its bound
    B, S = PREFILL_BATCH, PREFILL_SEQ
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    logits, counts = counted_run(lambda: prefill(lm.params,
                                                 {"tokens": tokens}))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    only_lm_kernels(counts, 0, "prefill")
    require(logits.shape == (B, S, cfg.vocab) and logits.dtype ==
            torch.float32 and bool(torch.isfinite(logits).all()),
            "prefill logits not finite or of the wrong shape")
    wall = host_ms(torch, lambda: prefill(lm.params, {"tokens": tokens}),
                   PREFILL_REPS)
    n_bytes, n_ops = prefill_work(cfg, lm.served_bytes, B, S)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
    print(f"  prefill {cfg.name} B={B} S={S} (attn_chunk_q "
          f"{cfg.attn_chunk_q}): {wall:.3f} ms (median of {PREFILL_REPS}, "
          f"host clock), {B * S / wall * 1e3:.0f} tokens/s; peak device "
          f"memory {peak:.2f} GiB; bound {b_ms:.3f} ms ({b_by}: "
          f"{n_ops / 1e12:.3f} TFLOP at {BF16_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s bf16, {n_bytes / 1e9:.3f} GB) [{ident}]")
    profile_prefill(torch, lambda: prefill(lm.params, {"tokens": tokens}),
                    wall)
    chunked = steps.make_prefill_step(dataclasses.replace(
        cfg, attn_chunk_q=PREFILL_CHUNK))(lm.params, {"tokens": tokens})
    rel = float((chunked - logits).abs().max() / logits.abs().max())
    same = int((chunked.argmax(-1) == logits.argmax(-1)).sum())
    print(f"  chunk invariance, attn_chunk_q {cfg.attn_chunk_q} vs "
          f"{PREFILL_CHUNK}: bit-identical={torch.equal(chunked, logits)}, "
          f"max |diff| / max |logit| = {rel}, argmax equal in {same} of "
          f"{B * S}")
    require(rel <= PREFILL_CHUNK_TOL, f"prefill chunk invariance: {rel} > "
                                      f"{PREFILL_CHUNK_TOL}")
    n = PREFILL_FORCED
    want = logits[:, :n].transpose(0, 1).contiguous()     # (n, B, V)
    del chunked, logits

    # (b) the decode from the same tokens, teacher-forced over n positions
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, kv_quant=False)
    lm32 = dataclasses.replace(lm, cfg=cfg32, head=lm_head(lm.params, cfg32))
    want32 = steps.make_prefill_step(cfg32)(
        lm.params, {"tokens": tokens})[:, :n].transpose(0, 1).contiguous()
    got32, counts = counted_run(lambda: forced_logits(torch, lm32,
                                                      tokens[:, :n], False))
    only_lm_kernels(counts, 0, "float32 decode without kv_quant")
    rel32 = float((got32 - want32).abs().max() / want32.abs().max())
    print(f"  float32, no kv_quant: {n} teacher-forced decode steps vs the "
          f"float32 prefill: max |diff| / max |logit| = {rel32}")
    require(rel32 <= PREFILL_F32_TOL, f"float32 decode vs prefill: {rel32} "
                                      f"> {PREFILL_F32_TOL}")
    del lm32, want32, got32
    with checked_lm_kernels(torch, held):
        got, counts = counted_run(lambda: forced_logits(torch, lm,
                                                        tokens[:, :n],
                                                        False))
    only_lm_kernels(counts, n * cfg.n_layers, "int8-KV decode")
    add(counts)
    rel8 = float((got - want).abs().max() / want.abs().max())
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"  bf16, int8 KV through K5' and K6: {n} teacher-forced steps vs "
          f"the bf16 prefill: max |diff| / max |logit| = {rel8} (bound "
          f"{PREFILL_INT8KV_TOL}), argmax equal in {same} of {n * B}; "
          f"launches {nonzero(counts)}; every call held against its plain "
          "version")
    require(rel8 <= PREFILL_INT8KV_TOL, f"int8-KV decode vs prefill: {rel8} "
                                        f"> {PREFILL_INT8KV_TOL}")
    del got, want

    # (c) the four other dense configs at their published widths, depth 1
    B, S, n = NEW_BATCH, NEW_SEQ, NEW_DECODE
    k6_us = {}
    for arch in NEW_ARCHS:
        t0 = time.perf_counter()
        small = dataclasses.replace(configs.get_smoke_config(arch),
                                    n_layers=1)
        require(_tree_spec(card_init_lm(torch, small, gen, dev)) ==
                _tree_spec(init_lm(small, device=dev)),
                f"{arch}: the card's init differs from init_lm's tree")
        ncfg = dataclasses.replace(
            serve.lm_config(arch, quant="serve_w8a8", kv_quant=True),
            n_layers=1)
        float_tree = card_init_lm(torch, ncfg, gen, dev)
        f32_bytes = quantized_bytes(float_tree)
        params = quantize_params_tree(float_tree, ncfg)
        del float_tree
        nlm = serve.ServedLM(ncfg, params, lm_head(params, ncfg), dev,
                             f32_bytes, quantized_bytes(params))
        if ncfg.frontend == "token":
            x = torch.randint(0, ncfg.vocab, (B, S + 2 * n), generator=gen,
                              device=dev)
            batch = {"tokens": x[:, :S]}
        else:
            x = torch.randn((B, S + 2 * n, ncfg.d_model), generator=gen,
                            device=dev).to(ncfg.dtype)
            batch = {"embeds": x[:, :S]}
        step = steps.make_prefill_step(ncfg)
        out = step(params, batch)
        require(out.shape == (B, S, ncfg.vocab) and bool(
            torch.isfinite(out).all()), f"{arch}: prefill logits")
        p_ms = host_ms(torch, lambda: step(params, batch), 3)
        cache = init_cache(ncfg, B, S + 2 * n, dev)
        prompt = torch.stack([serve.decode(nlm, cache, x[:, i:i + 1], i)
                              for i in range(S)], dim=1)
        gap = float((prompt - out).abs().max() / out.abs().max())
        with checked_lm_kernels(torch, held):
            dec, counts = counted_run(lambda: torch.stack(
                [serve.decode(nlm, cache, x[:, i:i + 1], i)
                 for i in range(S, S + n)]))
        only_lm_kernels(counts, n, f"{arch} decode")
        add(counts)
        require(dec.shape == (n, B, ncfg.vocab) and bool(
            torch.isfinite(dec).all()), f"{arch}: decode logits")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(S + n, S + 2 * n):
            serve.decode(nlm, cache, x[:, i:i + 1], i)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t1) / n * 1e3
        k6_us[arch], k6_shape, (k6_bound_us, k6_by) = record_k6_call(
            torch, lambda: serve.decode(nlm, cache, x[:, -1:],
                                        S + 2 * n - 1))
        print(f"  {arch} (1 of {configs.get_config(arch).n_layers} layers, "
              f"d_model {ncfg.d_model}, {ncfg.n_heads} heads over "
              f"{ncfg.n_kv_heads}, hd {ncfg.hd}, vocab {ncfg.vocab}, "
              f"{ncfg.frontend}): weights fp32 {f32_bytes / 1e9:.3f} GB -> "
              f"served {nlm.served_bytes / 1e9:.3f} GB; prefill B={B} S={S} "
              f"{p_ms:.3f} ms (median of 3); decode {d_ms:.3f} ms/step "
              f"(host clock, {n} steps at positions {S + n}.."
              f"{S + 2 * n - 1}); K6 at {k6_shape}: device {k6_us[arch]:.3f} "
              f"us per call (queued), bound {k6_bound_us:.3f} us ({k6_by}); "
              f"teacher-forced prompt vs prefill {gap} "
              f"(reported); launches {nonzero(counts)}; "
              f"{time.perf_counter() - t0:.1f} s [{ident}]")
        del nlm, params, cache, out, prompt, dec, x, batch
        torch.cuda.empty_cache()

    # (d) the int4 KV cache, card against CPU, float32
    small = dataclasses.replace(serve.lm_config(
        "qwen2-0.5b", smoke=True, quant="serve_w8a8", kv_quant=True),
        kv_bits=4)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, small.vocab, size=(3, INT4_STEPS)))
    lms = {d: serve.build_lm(small, seed=0, device=d) for d in (dev, "cpu")}
    card, counts = counted_run(lambda: forced_logits(
        torch, lms[dev], toks.to(dev), False))
    only_lm_kernels(counts, 0, "int4-KV decode")
    cpu = forced_logits(torch, lms["cpu"], toks, False)
    rel4 = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    print(f"  int4 KV cache, qwen2 smoke config in float32, {INT4_STEPS} "
          f"steps: card vs CPU {rel4}; no kernel launched")
    require(rel4 <= 1e-4, f"int4-KV decode: card and CPU disagree by {rel4}")

    took = time.perf_counter() - t_phase
    print(f"  phase 10 took {took:.1f} s [{ident}]")
    require(took <= PREFILL_PHASE_S, f"phase 10 took {took:.1f} s, over "
                                     f"{PREFILL_PHASE_S:.0f}")
    return {"launches": launches, "held": held, "k6_us": k6_us}


# --- phase 11: the dense LM trains ------------------------------------------

def train_work(torch, cfg, B, S, use_ef):
    """(bytes, operations) of one launcher step at ``cfg``, counted from
    the code: the forward's products as ``prefill_work`` counts them,
    three times (the backward takes two products per forward product,
    the attention's two included), at 2 operations a multiply-add; the
    bytes of the state the step reads once and writes once: the float32
    parameters and AdamW's two moments (and the error-feedback residual
    under ef8), and the token ids and labels."""
    from repro_torch import tree
    from repro_torch.launch.steps import abstract_params
    n_params = sum(t.numel() for t in tree.leaves(abstract_params(cfg)))
    fwd_ops = prefill_work(cfg, 0, B, S)[1]
    states = 3 + int(use_ef)
    return 2 * states * 4 * n_params + B * S * 8, 3 * fwd_ops, n_params


def producer_threads():
    import threading
    from repro_torch.data.tokens import PRODUCER_THREAD
    return [t for t in threading.enumerate() if t.name == PRODUCER_THREAD]


def launcher_run(torch, argv, what):
    """``launch.train.main(argv)`` in this process, counted: (its returned
    flags, {kernel: launches}); every kernel's count must read 0, every
    logged loss be finite, the launcher's own closing check (last logged
    loss below the first) hold, and no producer thread be left."""
    from repro_torch.launch import train
    try:
        args, counts = counted_run(lambda: train.main(argv))
    except AssertionError as exc:
        raise SmokeFailure(f"{what}: the launcher's check failed: {exc}")
    require(not nonzero(counts), f"{what}: kernels launched: "
                                 f"{nonzero(counts)}")
    losses = [f for _, f, _ in args._log]
    require(all(np.isfinite(losses)), f"{what}: a logged loss is not "
                                      f"finite: {losses}")
    require(not producer_threads(), f"{what}: a data thread outlived the "
                                    "run")
    return args, counts


def run_lm_train_captured(torch, dev, ident):
    """Phase 11 (a0): the launcher's step as ``launch/train.py`` builds it
    (``make_body`` on the state ``main`` makes: qwen2-0.5b at full width
    and depth, qat_w4a8 with ef8, DTensors on the local (1, 1) NCCL mesh,
    the batch placed by ``batch_specs``) before any capture: the host
    time of one eager step split; then its program (``captured
    .Programs``, as ``main`` runs it) held against five eager runs from
    one state, the profiler's kernels over one replay (none of the
    port's), a replay under sync-debug "error", ms per step eager against
    replay (paired), the idle share of a replay and of an eager step
    (the replay's device busy: the same kernels), capture seconds,
    graph-pool bytes and peak memory. Returns (eager ms, replay ms)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.captured import Programs, clone_tree, pool_bytes
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm.config import ShapeCell
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.optim.compression import ef_init
    from repro_torch.tools.lm_train_gap import launcher_optimizer
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b"),
                              quant_mode="qat_w4a8",
                              attn_chunk_q=min(1024, S))
    opened = not dist.is_initialized()
    torch.cuda.reset_peak_memory_stats(dev)
    t_setup = time.perf_counter()
    mesh = make_local_mesh(dev)
    try:
        params = init_lm(cfg, seed=0, device=dev)
        params = shd.place(params, shd.to_shardings(
            shd.param_specs(params, cfg, mesh), mesh))
        opt = launcher_optimizer(LM_TRAIN_STEPS)
        b_sh = shd.to_shardings(shd.batch_specs(
            cfg, ShapeCell("custom", S, B, "train"), mesh), mesh)
        it = synthetic_token_batches(cfg, B, S, seed=17)
        batch = {k: distribute_tensor(torch.from_numpy(v).to(dev), mesh,
                                      b_sh[k].placements)
                 for k, v in next(it).items()}
        it.close()
        state0 = (params, opt.init(params), ef_init(params))
        del params
        body = train.make_body(cfg, opt, True)
        progs = Programs(device=dev, name="the launcher's step",
                         state=clone_tree(state0))
        with implicit_replication():
            def eager():
                return body(state=progs.state, batch=batch)
            float(_plain(torch, eager()))
            print_host_split(
                "one eager launcher step (qwen2-0.5b, qat_w4a8 + ef8, "
                f"B={B} S={S}, on the (1, 1) mesh)",
                *host_split(torch, lambda: _plain(torch, eager())), ident)
            t = [time.perf_counter()]
            progs.run("step", body, batch=batch)            # captures
            prog = progs.programs["step"]
            require(not nonzero(prog.launch_counts()),
                    f"the launcher's step recorded launches "
                    f"{prog.launch_counts()}")
            t.append(time.perf_counter())
            hold_step(torch, progs, "step", body, state0, dict(batch=batch),
                      "the launcher's step (its loss and new parameters)",
                      kept=lambda state: state[0])
            t.append(time.perf_counter())
            no_sync_replay(torch, prog, "the launcher's step")
            ms = paired_ms(torch, {
                "eager": eager,
                "replay": lambda: progs.run("step", body, batch=batch)},
                2, lambda r: float(_plain(torch, r)))
            t.append(time.perf_counter())
            # one profile: the device busy of a replay, and the port's
            # kernels in it against the capture's record (none)
            host, busy, idle, prof = replay_idle(torch, prog)
            counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
            for e in prof.events():
                for k, sym in KERNEL_SYMBOLS.items():
                    counts[k] += e.device_type == DeviceType.CUDA \
                        and sym in e.name
            require(not nonzero(counts), f"the profile of one replayed "
                                         f"launcher step holds {counts}")
            t.append(time.perf_counter())
        e_host = statistics.mean(ms["eager"])
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print(f"  the launcher's step, ms per step (host clock, each ended "
              f"by reading its loss, in the order eager, replay, replay, "
              f"eager): eager " + ", ".join(f"{m:.2f}" for m in ms["eager"])
              + "; replay " + ", ".join(f"{m:.2f}" for m in ms["replay"])
              + f"; a bare replay {host:.3f} ms, device busy {busy:.3f} ms "
              f"(profiler, one replay), idle share "
              + (f"{idle:.3f}; eager, the same kernels, "
                 f"{1 - busy / e_host:.3f}" if idle is not None
                 else "not measured")
              + f"; no kernel of the port in the profile of one replay; "
              f"{capture_seconds([prog])}; graph pool "
              f"{pool_bytes(progs.pool)} bytes; peak device memory "
              f"{peak:.2f} GiB (the state, its copy for the checks, the "
              f"pool) [{ident}]")
        print(f"  (a0) seconds: set-up and the host split "
              f"{t[0] - t_setup:.1f}, capture {t[1] - t[0]:.1f}, hold "
              f"{t[2] - t[1]:.1f}, paired timing {t[3] - t[2]:.1f}, "
              f"profile {t[4] - t[3]:.1f}")
        out = statistics.mean(ms["eager"]), statistics.mean(ms["replay"])
        del progs, prog, state0, batch
    finally:
        if opened:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def run_lm_train_full(torch, dev, ident):
    """Phase 11 (a): the launcher at qwen2-0.5b's full width and depth,
    qat_w4a8 with ef8, then the plain step beside it; the step profiled
    and bounded. Returns the launches."""
    import tempfile
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch import steps
    from repro_torch.tools.lm_train_gap import launcher_optimizer
    B, S, n = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS
    launches = {}
    with tempfile.TemporaryDirectory(prefix="lm_train_") as root:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with program_calls() as calls:
            args, counts = launcher_run(torch, [
                "--arch", "qwen2-0.5b", "--steps", str(n), "--batch",
                str(B), "--seq", str(S), "--quant", "qat_w4a8",
                "--grad-compression", "ef8", "--ckpt-dir", f"{root}/qat"],
                "qat_w4a8 + ef8")
        took = time.perf_counter() - t0
        require(calls == {("the launcher's step", "step"): [1, n - 1]},
                f"the launcher's programs: {calls}, expected one capture "
                f"and {n - 1} replays")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches.update(counts)
        cfg, log = args._cfg, {s: (f, t) for s, f, t in args._log}
        require(sorted(log) == sorted({*range(0, n, 10), n - 1}),
                f"logged steps {sorted(log)}")
        ms = (log[n - 1][1] - log[10][1]) / (n - 11) * 1e3
        mgr = CheckpointManager(f"{root}/qat")
        require(mgr.all_steps() == [n - 1], f"checkpoints {mgr.all_steps()}")
        restored = mgr.restore(n - 1, args._params, device=dev)
        require(all(torch.equal(a, b) for a, b in zip(
            tree.leaves(restored), tree.leaves(args._params))),
            "the final checkpoint does not restore the final parameters")
        require(mgr.extra(n - 1) == {"loss": log[n - 1][0]},
                f"the checkpoint's extra {mgr.extra(n - 1)} is not the last "
                "loss")
        del restored
        n_bytes, n_ops, n_params = train_work(torch, cfg, B, S, True)
        b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        print(f"  qwen2-0.5b full width ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}, {n_params / 1e6:.1f}M "
              f"parameters, {str(cfg.dtype)[6:]} activations), B={B} S={S}, "
              f"qat_w4a8 + ef8, "
              f"{n} steps: losses " + ", ".join(
                  f"{s}: {f:.4f}" for s, (f, _) in sorted(log.items()))
              + f"; {ms:.3f} ms per step (the launcher's clock, steps 10 to "
              f"{n - 1}), {B * S / ms * 1e3:.0f} tokens/s; peak device "
              f"memory {peak:.2f} GiB; the run {took:.1f} s with its init "
              f"and checkpoint; bound {b_ms:.3f} ms ({b_by}: "
              f"{n_ops / 1e12:.3f} TFLOP at {BF16_OPS_PER_S / 1e12:.0f} "
              f"TFLOP/s bf16, {n_bytes / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); launches 0; the step "
              f"captured on step 0 and replayed {n - 1} times; the final "
              f"checkpoint restored with every digest verified [{ident}]")
        # one make_train_step call profiled, beside its unprofiled time
        opt = launcher_optimizer(n)
        state = opt.init(args._params)
        it = synthetic_token_batches(cfg, B, S, seed=17)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        it.close()
        step = steps.make_train_step(cfg, opt)
        t_step = time.perf_counter()
        wall = host_ms(torch, lambda: step(args._params, state, batch), 3)
        s_bytes, s_ops, _ = train_work(torch, cfg, B, S, False)
        s_ms, s_by = bound(s_bytes, s_ops, BF16_OPS_PER_S)
        print(f"  make_train_step (qat_w4a8, no ef8): {wall:.3f} ms (median "
              f"of 3, host clock), bound {s_ms:.3f} ms ({s_by})")
        profile_prefill(torch, lambda: step(args._params, state, batch),
                        wall, "make_train_step call")
        print(f"  the step timed and profiled in "
              f"{time.perf_counter() - t_step:.1f} s")
        del args, state, batch, step
        torch.cuda.empty_cache()
        # beside it, the plain step
        m = LM_PLAIN_STEPS
        t_plain = time.perf_counter()
        args, counts = launcher_run(torch, [
            "--arch", "qwen2-0.5b", "--steps", str(m), "--batch", str(B),
            "--seq", str(S), "--ckpt-dir", f"{root}/plain"], "plain")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        log = {s: (f, t) for s, f, t in args._log}
        p_ms = (log[m - 1][1] - log[0][1]) / (m - 1) * 1e3
        print(f"  the plain step (--quant none --grad-compression none), "
              f"{m} steps: losses " + ", ".join(
                  f"{s}: {f:.4f}" for s, (f, _) in sorted(log.items()))
              + f"; {p_ms:.3f} ms per step (steps 1 to {m - 1}), "
              f"{B * S / p_ms * 1e3:.0f} tokens/s; the run "
              f"{time.perf_counter() - t_plain:.1f} s with its init and "
              f"checkpoint; launches 0 [{ident}]")
        del args
        torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def kept_heap():
    """Inside the block, glibc's malloc serves every allocation from its
    heap (``M_MMAP_MAX`` 0) and keeps what is freed there
    (``M_TRIM_THRESHOLD`` at its largest), so a freed tensor's pages serve
    the next one instead of being unmapped and faulted in afresh; after
    it, glibc's defaults again and the free pages returned
    (``malloc_trim``). Results are the same bit for bit; elsewhere than
    glibc it does nothing."""
    import ctypes
    try:
        libc = ctypes.CDLL("libc.so.6")
        mallopt, trim = libc.mallopt, libc.malloc_trim
    except (OSError, AttributeError):
        yield
        return
    m_trim_threshold, m_mmap_max = -1, -4
    mallopt(m_mmap_max, 0)
    mallopt(m_trim_threshold, 2 ** 31 - 1)
    try:
        yield
    finally:
        mallopt(m_mmap_max, 65536)               # glibc's DEFAULT_MMAP_MAX
        mallopt(m_trim_threshold, 128 * 1024)    # DEFAULT_TRIM_THRESHOLD
        trim(0)


def run_lm_train_gap(torch, dev, ident):
    """Phase 11 (b): one launcher step on the card against the CPU at
    qwen2-0.5b's width, two layers deep, float32; ``quant none``, then
    qat_w4a8 with ef8; ef_compress alone bit for bit. Returns the
    ``quant none`` step's bounds per leaf, (gradients, parameters after
    the update), which phase 13 (a) holds the mesh step to."""
    from repro_torch import tree
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.optim.compression import ef_compress, ef_init
    from repro_torch.tools.lm_train_gap import (
        GAP_BATCH, GAP_SEQ, gap_config, launcher_optimizer, launcher_step,
        moved_sites, qat_sites, spread, tree_gaps)
    from repro_torch.tools.so3_grad_conditioning import N_JITTERS
    opt = launcher_optimizer()
    p_cpu = init_lm(gap_config(), seed=0, device="cpu")
    p_card = tree.tree_map(lambda t: t.to(dev), p_cpu)
    it = synthetic_token_batches(gap_config(), GAP_BATCH, GAP_SEQ, seed=17)
    b_cpu = {k: torch.from_numpy(v) for k, v in next(it).items()}
    it.close()
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}
    for mode, use_ef in (("none", False), ("qat_w4a8", True)):
        cfg, name = gap_config(mode), mode + " + ef8" * use_ef
        t0 = time.perf_counter()
        with qat_sites() as s_cpu:
            host = launcher_step(cfg, opt, p_cpu, b_cpu, use_ef)
        g_sp, p_sp, _ = spread(cfg, opt, p_cpu, b_cpu, use_ef, host, s_cpu,
                               range(N_JITTERS))
        g_bd = {k: max(1e-4, F32_GRAD_FACTOR * v) for k, v in g_sp.items()}
        p_bd = {k: max(1e-4, F32_GRAD_FACTOR * v) for k, v in p_sp.items()}
        if mode == "none":
            bounds = (g_bd, p_bd)
        cpu_s = time.perf_counter() - t0

        def held(run, what):
            rel = abs(float(run[0]) - float(host[0])) / abs(float(host[0]))
            out = []
            for kind, gaps, bd, sp in (
                    ("gradient", tree_gaps(run[1], host[1]), g_bd, g_sp),
                    ("parameter after the update",
                     tree_gaps(run[3], host[3]), p_bd, p_sp)):
                worst = max(gaps, key=lambda k: gaps[k] / bd[k])
                print(f"  {name}{what}: worst {kind} leaf {worst} "
                      f"{gaps[worst]:.3g} of its largest |value| (the CPU's "
                      f"float32 spread {sp[worst]:.3g}, bound "
                      f"{bd[worst]:.3g})")
                out.append((gaps[worst] <= bd[worst], f"{name}{what}: "
                            f"{kind} {worst} {gaps[worst]} > {bd[worst]}"))
            print(f"  {name}{what}: loss {float(run[0]):.6f} against the "
                  f"CPU's {float(host[0]):.6f}, {rel:.3g} relative (bound "
                  "1e-05)")
            out.append((rel <= 1e-5, f"{name}{what}: loss {rel} > 1e-5"))
            bad = [w for ok, w in out if not ok]
            return not bad, "; ".join(bad)
        with qat_sites() as s_card:
            card = launcher_step(cfg, opt, p_card, b_card, use_ef)
        ok, what = held(card, ", card vs CPU")
        if mode == "none":
            require(ok, what)
            # the card's own spread: the embedding's backward sums
            # repeated tokens with atomics
            again = launcher_step(cfg, opt, p_card, b_card, use_ef)
            g2 = tree_gaps(again[1], card[1])
            worst = max(g2, key=g2.get)
            print(f"  {name}: a second card run against the first: worst "
                  f"gradient leaf {worst} {g2[worst]:.3g} (embed "
                  f"{g2['embed']:.3g}); held to the bound "
                  f"{g_bd[worst]:.3g}")
            require(all(g2[k] <= g_bd[k] for k in g2),
                    f"{name}: two card runs differ past the bound: {g2}")
            del again
        else:
            if not ok:
                moved = moved_sites(s_card, s_cpu)
                a8 = sum(m for (kind, _), m in zip(s_cpu, moved)
                         if kind == "a127")
                print(f"  {name}: codes or gates moved per site {moved} "
                      f"(A8 {a8})")
                require(a8 > 0, f"{what}, with no moved A8 code or gate")
            with qat_sites(pin=s_cpu):
                pinned = launcher_step(cfg, opt, p_card, b_card, use_ef)
            require(*held(pinned, ", card with the CPU's quantization "
                                  "sites (A8, W4, EF codes) pinned, vs CPU"))
            # ef_compress alone, card against CPU on the CPU's gradients
            g_card = tree.tree_map(lambda t: t.to(dev), host[1])
            d_card, e_card = ef_compress(g_card, ef_init(g_card))
            d_cpu, e_cpu = ef_compress(host[1], ef_init(host[1]))
            same = all(torch.equal(a.cpu(), b) for a, b in zip(
                tree.leaves((d_card, e_card.residual)),
                tree.leaves((d_cpu, e_cpu.residual))))
            print(f"  ef_compress on the CPU's gradients, card vs CPU: "
                  f"dequantized gradients and residual bit for bit: {same}")
            require(same, "ef_compress: card and CPU differ")
            del pinned, g_card, d_card, e_card
        print(f"  {name}: the CPU's step and {N_JITTERS} jittered runs took "
              f"{cpu_s:.1f} s [{ident}]")
        del card, host
    return bounds


def run_lm_train_resume(torch, dev, ident):
    """Phase 11 (c): the launcher as a user runs it, killed with SIGKILL
    once step 20 is checkpointed, then the same command again. Returns
    the lines to print (it runs beside (b), in a thread)."""
    import os
    import signal
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    with tempfile.TemporaryDirectory(prefix="lm_resume_") as ck:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen2-0.5b", "--smoke", "--steps", str(LM_RESUME_STEPS),
               "--batch", "4",
               "--seq", "64", "--quant", "qat_w4a8", "--grad-compression",
               "ef8", "--ckpt-every", "10", "--spmd-timeout", "60",
               "--ckpt-dir", ck]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            mgr = CheckpointManager(ck)
            deadline = time.monotonic() + 120
            while (proc.poll() is None and time.monotonic() < deadline
                   and (mgr.latest_step() or 0) < 20):
                time.sleep(0.02)
            require(proc.poll() is None, "the run ended (or timed out) "
                                         "before it was killed")
            proc.send_signal(signal.SIGKILL)
            require(proc.wait(timeout=30) == -signal.SIGKILL,
                    "SIGKILL did not end the run")
        finally:
            proc.kill()
            proc.stdout.close()
        killed = time.perf_counter() - t0
        newest = mgr.latest_step()
        leftover = sorted(os.listdir(ck))
        out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=120)
        lines = ["  " + line for line in out.stdout.strip().splitlines()]
        require(out.returncode == 0, f"the run resumed from step {newest} "
                                     f"failed: {out.stderr[-2000:]}")
        require(f"[resume] restoring step {newest} from" in out.stdout,
                f"the resumed run did not restore step {newest}")
        last = LM_RESUME_STEPS - 1
        require(mgr.latest_step() == last,
                f"newest step {mgr.latest_step()}")
        arrays = mgr.restore_arrays(last)        # every digest verified
        orphans = [p for p in os.listdir(ck) if ".tmp." in p]
        require(not orphans, f"orphaned saves {orphans}")
        lines.append(
            f"  kill and resume: killed after {killed:.1f} s with "
            f"{leftover} on disk, newest valid step {newest}; the same "
            f"command resumed from it and finished: step {last} valid "
            f"({len(arrays)} arrays, every digest verified), no orphan, "
            f"{time.perf_counter() - t0:.1f} s in all [{ident}]")
    return lines


def run_lm_train(torch, dev):
    """Phase 11 (the module docstring). Returns {"launches": ...,
    "bounds": (b)'s ``quant none`` bounds}."""
    import threading
    t_phase, ident = time.perf_counter(), gpu_identity()
    eager_ms, replay_ms = run_lm_train_captured(torch, dev, ident)
    t_a = time.perf_counter()
    print(f"  (a0) took {t_a - t_phase:.1f} s")
    launches = run_lm_train_full(torch, dev, ident)
    t_b = time.perf_counter()
    print(f"  (a) took {t_b - t_a:.1f} s")
    print("  (b) one launcher step, card against CPU: qwen2-0.5b's width, "
          "2 layers deep, B=2, S=64, float32; (c), the kill and resume "
          "drill, runs beside it in a thread (its subprocesses are host "
          "bound; (b) is the CPU's arithmetic, and neither is timed)")
    drill = {}

    def resume():
        try:
            drill["lines"] = run_lm_train_resume(torch, dev, ident)
        except BaseException as exc:         # re-raised below
            drill["error"] = exc
    worker = threading.Thread(target=resume, name="lm-resume-drill")
    worker.start()
    try:
        bounds = run_lm_train_gap(torch, dev, ident)
    finally:
        worker.join(300)
    require(not worker.is_alive(), "the kill and resume drill did not end")
    print(f"  (b) took {time.perf_counter() - t_b:.1f} s with (c) beside it")
    print("  (c) kill and resume")
    if "error" in drill:
        raise drill["error"]
    print("\n".join(drill["lines"]))
    took = time.perf_counter() - t_phase
    print(f"  the launcher's step, eager against replayed (paired in (a0), "
          f"means): {eager_ms:.2f} against {replay_ms:.2f} ms; phase 11 "
          f"took {took:.1f} s [{ident}]")
    require(took <= LM_TRAIN_PHASE_S, f"phase 11 took {took:.1f} s, over "
                                      f"{LM_TRAIN_PHASE_S:.0f}")
    return {"launches": launches, "bounds": bounds}


# --- phase 12: the MoE, Mamba2-hybrid and xLSTM families -------------------

def served_moe_lm(torch, cfg, gen, dev):
    """A transformer-pattern (MoE) model in ``cfg.quant_mode``, its
    blocks drawn on the card and quantized one layer at a time (the
    scales are per matrix over axis -2, so a layer quantized alone gets
    the codes of the stack): qwen3-moe's float32 experts would take ~116
    GB at once. Returns (params, the float32 tree's bytes)."""
    from repro_torch import tree
    from repro_torch.quant.apply import quantize_params_tree, quantized_bytes
    one = dataclasses.replace(cfg, n_layers=1)
    params = card_top(torch, cfg, gen, dev)
    f32_bytes = quantized_bytes(params)
    stacks, like = {}, None
    for i in range(cfg.n_layers):
        layer = card_blocks(torch, one, gen, dev)
        f32_bytes += quantized_bytes(layer)
        layer = quantize_params_tree(layer, cfg)
        for k, v in tree.items(layer):
            if k not in stacks:
                stacks[k] = torch.empty((cfg.n_layers,) + tuple(v.shape[1:]),
                                        dtype=v.dtype, device=dev)
            stacks[k][i] = v[0]
        like = layer
        del layer
    params.update(tree.unflatten(like, stacks))
    return params, f32_bytes


def dropped_share(cfg, routing):
    """The share of routing choices the capacity dropped."""
    from repro_torch.tools.moe_routing import keep_of
    kept = [keep_of(r, cfg) for r in routing]
    return 1.0 - sum(int(k.sum()) for k in kept) / sum(k.numel()
                                                       for k in kept)


def serve_family(torch, dev, arch, cfg, params, f32_bytes, gen, held,
                 ident):
    """One family at its published width: the prefill (counted: no
    kernel), for MoE the prompt decoded into the cache, FAM_DECODE steps
    counted with every K5'/K6 call held (after the prompt; for zamba2 and
    xlstm from the first token, whose float32 check decodes the prompt),
    FAM_DECODE more timed; one profiled prefill (but xlstm's, ~48,000
    events: its sLSTM share is taken by :func:`slstm_share`) and decode
    step. Returns (the counted steps' launches, K6's device us or None,
    the ServedLM, the tokens)."""
    from repro_torch import configs
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm.moe import MOE_GROUP, capacity
    from repro_torch.models.lm.transformer import init_cache, lm_head, n_groups
    from repro_torch.quant.apply import quantized_bytes
    from repro_torch.tools.moe_routing import routing_sites
    B, S, n = FAM_BATCH, FAM_SEQ, FAM_DECODE
    t0 = time.perf_counter()
    lm = serve.ServedLM(cfg, params, lm_head(params, cfg), dev, f32_bytes,
                        quantized_bytes(params))
    x = torch.randint(0, cfg.vocab, (B, S + 2 * n), generator=gen,
                      device=dev)
    batch = {"tokens": x[:, :S]}
    step = steps.make_prefill_step(cfg)
    with routing_sites() as pre_routing:
        out, counts = counted_run(lambda: step(params, batch))
    only_lm_kernels(counts, 0, f"{cfg.name} prefill")
    require(out.shape == (B, S, cfg.vocab) and bool(torch.isfinite(out).all()),
            f"{cfg.name}: prefill logits not finite or of the wrong shape")
    p_ms = host_ms(torch, lambda: step(params, batch), 3)
    cache = init_cache(cfg, B, S + 2 * n, dev)
    first = S if cfg.moe else 0
    for i in range(first):
        serve.decode(lm, cache, x[:, i:i + 1], i)
    with checked_lm_kernels(torch, held), routing_sites() as dec_routing:
        dec, counts = counted_run(lambda: torch.stack(
            [serve.decode(lm, cache, x[:, i:i + 1], i)
             for i in range(first, first + n)]))
    kv_layers = 0 if cfg.block_pattern == "xlstm" else n_groups(cfg)
    only_lm_kernels(counts, kv_layers * n if cfg.kv_quant else 0,
                    f"{cfg.name} decode")
    require(dec.shape == (n, B, cfg.vocab) and bool(torch.isfinite(dec).all()),
            f"{cfg.name}: decode logits not finite")
    last = first + 2 * n - 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(first + n, last + 1):
        serve.decode(lm, cache, x[:, i:i + 1], i)
    torch.cuda.synchronize()
    d_ms = (time.perf_counter() - t1) / n * 1e3
    if cfg.block_pattern != "xlstm":
        profile_prefill(torch, lambda: step(params, batch), p_ms,
                        f"{cfg.name} prefill")
    profile_prefill(torch, lambda: serve.decode(lm, cache, x[:, last:last + 1],
                                                last), d_ms,
                    f"{cfg.name} decode step")
    k6 = None
    line = ""
    if cfg.kv_quant:
        us, shape, (b_us, b_by) = record_k6_call(torch, lambda: serve.decode(
            lm, cache, x[:, last:last + 1], last))
        k6 = us
        line = (f"; K6 at {shape}: device {us:.3f} us per call (queued), "
                f"bound {b_us:.3f} us ({b_by})")
    c_len = S + 2 * n
    rep_ms, eag_ms = greedy_replay_checks(torch, lm, B, c_len, FAM_GREEDY,
                                          order=("replay", "eager"))
    line += (f"; greedy decode ms/step replay {rep_ms:.3f} against eager "
             f"{eag_ms:.3f}")
    line += replayed_last_step(torch, lm, cache, x[:, c_len - 1:c_len],
                               c_len, kv_layers if cfg.kv_quant else 0)
    if cfg.moe:
        one_step = dec_routing[:n_groups(cfg)]
        line += (f"; choices dropped by capacity: prefill "
                 f"{dropped_share(cfg, pre_routing):.4f} (C = "
                 f"{capacity(cfg, min(MOE_GROUP, B * S))}), one decode step "
                 f"{dropped_share(cfg, one_step):.4f} (C = "
                 f"{capacity(cfg, B)})")
    full = configs.get_config(arch)
    print(f"  {cfg.name} ({cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.quant_mode}, kv_quant={cfg.kv_quant}, bf16): "
          f"weights fp32 {f32_bytes / 1e9:.3f} GB -> served "
          f"{lm.served_bytes / 1e9:.3f} GB; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB; prefill "
          f"B={B} S={S} {p_ms:.3f} ms (median of 3, host clock); decode "
          f"{d_ms:.3f} ms/step (host clock, {n} steps at positions "
          f"{first + n}..{last}); launches over {n} counted steps "
          f"{nonzero(counts)}{line}; {time.perf_counter() - t0:.1f} s "
          f"[{ident}]")
    return counts, k6, lm, x


def replayed_last_step(torch, lm, cache, ids, c_len, n_kernel):
    """The captured step of (batch, cache length) replayed once at the
    cache's last position (K6's device plan at its most splits) on a copy
    of ``cache`` (``c_len`` slots), against the eager step at that device position on
    another copy: the same ids and, bit for bit, the same cache; the
    replay counted, K5' and K6 ``n_kernel`` times each and nothing else.
    Returns a line for the family's report."""
    from repro_torch.captured import copy_into, map_tensors
    from repro_torch.kernels.attention_int8kv import device_split_plan
    from repro_torch.launch import serve
    batch, name = ids.shape[0], lm.cfg.name
    prog = lm.programs[(batch, c_len)]
    eager = map_tensors(lambda t: t.clone(), cache)
    pos = torch.tensor(c_len - 1, dtype=torch.int32, device=lm.device)
    want = serve.decode(lm, eager, ids, pos).argmax(-1, keepdim=True)
    copy_into(prog.static["cache"], cache)
    prog.static["ids"].copy_(ids)
    prog.static["pos"].fill_(c_len - 1)
    got, counts = counted_run(lambda: prog.replay().clone())
    only_lm_kernels(counts, n_kernel, f"{name} replayed decode step at "
                                      f"position {c_len - 1}")
    require(torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(
        tree_tensors(prog.static["cache"]), tree_tensors(eager))),
        f"{name}: the decode step replayed at position {c_len - 1} differs "
        "from the eager step")
    rows = batch * lm.cfg.n_kv_heads * lm.cfg.kv_replicate
    return (f"; one step replayed at position {c_len - 1} equals the eager "
            f"step (ids and cache, bit for bit), launches {nonzero(counts)}"
            + (f", K6's device plan {device_split_plan(rows, c_len, c_len)}"
               if n_kernel else ""))


def forced_f32(torch, lm, x):
    """The float32 teacher-forced decode (no kv_quant, counted: no
    kernel) of the first FAM_FORCED tokens against the float32 prefill:
    the largest gap over the largest |logit|."""
    from repro_torch.launch import steps
    from repro_torch.models.lm.transformer import lm_head
    cfg32 = dataclasses.replace(lm.cfg, dtype=torch.float32, kv_quant=False)
    lm32 = dataclasses.replace(lm, cfg=cfg32, head=lm_head(lm.params, cfg32))
    n = FAM_FORCED
    want = steps.make_prefill_step(cfg32)(lm.params, {
        "tokens": x[:, :FAM_SEQ]})[:, :n].transpose(0, 1)
    got, counts = counted_run(lambda: forced_logits(torch, lm32, x[:, :n],
                                                    False))
    only_lm_kernels(counts, 0, f"{lm.cfg.name} float32 decode")
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"  {lm.cfg.name} float32, no kv_quant: {n} teacher-forced decode "
          f"steps vs the float32 prefill: max |diff| / max |logit| = {rel} "
          f"(bound {FAM_F32_TOL})")
    require(rel <= FAM_F32_TOL, f"{lm.cfg.name} float32 decode vs prefill: "
                                f"{rel} > {FAM_F32_TOL}")


def slstm_share(torch, lm, x):
    """The prefill's host ms and the share of it the sLSTM blocks take
    (each call ended by a synchronize)."""
    from repro_torch.launch import steps
    from repro_torch.models.lm import xlstm
    plain, spent = xlstm.slstm_forward, []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out
    step = steps.make_prefill_step(lm.cfg)
    batch = {"tokens": x[:, :FAM_SEQ]}
    step(lm.params, batch)
    xlstm.slstm_forward = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(lm.params, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        xlstm.slstm_forward = plain
    return total * 1e3, sum(spent) / total


def smoke_card_vs_cpu(torch, dev, arch):
    """The arch's smoke config in float32 (serve_w8a8, float cache; xlstm
    quant none) on the card and on the CPU: the prefill's logits and
    FAM_SMOKE_STEPS teacher-forced decode steps, counted on the card (no
    kernel), within FAM_CARD_TOL of the largest |logit|. A MoE gap past
    it must come with moved routing, and then holds with the CPU's
    routing pinned on the card."""
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm.transformer import init_cache
    from repro_torch.tools.moe_routing import moved_routing, routing_sites
    cfg = serve.lm_config(arch, smoke=True, quant="none" if "xlstm" in arch
                          else "serve_w8a8")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, FAM_SMOKE_SEQ)))
    lms = {d: serve.build_lm(cfg, seed=0, device=d) for d in (dev, "cpu")}

    def run(d, pin=None):
        lm, t = lms[d], toks.to(d)
        with routing_sites(pin) as routing:
            pre = steps.make_prefill_step(cfg)(lm.params, {"tokens": t})
            cache = init_cache(cfg, 2, FAM_SMOKE_STEPS, d)
            dec = torch.stack([serve.decode(lm, cache, t[:, i:i + 1], i)
                               for i in range(FAM_SMOKE_STEPS)])
        return pre.cpu(), dec.cpu(), routing

    def gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))
    cpu = run("cpu")
    card, counts = counted_run(lambda: run(dev))
    only_lm_kernels(counts, 0, f"{arch} smoke, card")
    g = gap(card[:2], cpu[:2])
    line = f"  {cfg.name}, float32: card vs CPU {g}"
    if g > FAM_CARD_TOL and cfg.moe:
        moved = moved_routing(cpu[2], card[2], cfg)
        line += f"; routing moved (choices, kept) per routing {moved}"
        require(sum(a + b for a, b in moved) > 0,
                f"{arch}: card vs CPU {g} with no moved routing")
        card = run(dev, pin=cpu[2])
        g = gap(card[:2], cpu[:2])
        line += f"; with the CPU's routing pinned {g}"
    print(line + f" (bound {FAM_CARD_TOL}); no kernel launched")
    require(g <= FAM_CARD_TOL, f"{arch} smoke: card and CPU disagree by {g}")


def run_lm_families(torch, dev):
    """Phase 12 (the module docstring): (a)-(d) the four family configs
    at their published widths, (e) the smoke configs card against CPU."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.quant.apply import quantize_params_tree, quantized_bytes
    t_phase, ident = time.perf_counter(), gpu_identity()
    gen = torch.Generator(device=dev).manual_seed(12)
    launches, held, k6_us = {}, {}, {}
    for arch in FAM_ARCHS:
        small = configs.get_smoke_config(arch)
        require(_tree_spec(card_init_lm(torch, small, gen, dev)) ==
                _tree_spec(init_lm(small, device=dev)),
                f"{arch}: the card's init differs from init_lm's tree")
    for part, arch in zip("abcd", FAM_ARCHS):
        xl = arch.startswith("xlstm")
        cfg = serve.lm_config(arch, quant="none" if xl else "serve_w8a8",
                              kv_quant=not xl)
        if arch in FAM_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=FAM_DEPTH[arch])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        print(f"  ({part}) {arch}")
        if cfg.moe:
            params, f32_bytes = served_moe_lm(torch, cfg, gen, dev)
        else:
            params = card_init_lm(torch, cfg, gen, dev)
            f32_bytes = quantized_bytes(params)
            if cfg.quant_mode != "none":
                params = quantize_params_tree(params, cfg)
        counts, k6, lm, x = serve_family(torch, dev, arch, cfg, params,
                                         f32_bytes, gen, held, ident)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if k6 is not None:
            k6_us[arch] = k6
        if not cfg.moe:
            forced_f32(torch, lm, x)
        if xl:
            ms, share = slstm_share(torch, lm, x)
            print(f"  {arch} bf16 prefill B={FAM_BATCH} S={FAM_SEQ}: "
                  f"{ms:.3f} ms (host clock, each sLSTM block synchronized), "
                  f"the sLSTM blocks {share:.3f} of it [{ident}]")
        del lm, params, x
        torch.cuda.empty_cache()
    print("  (e) the smoke configs, card against CPU, float32")
    for arch in FAM_ARCHS:
        smoke_card_vs_cpu(torch, dev, arch)
    took = time.perf_counter() - t_phase
    print(f"  phase 12 took {took:.1f} s [{ident}]")
    require(took <= FAM_PHASE_S, f"phase 12 took {took:.1f} s, over "
                                 f"{FAM_PHASE_S:.0f}")
    return {"launches": launches, "held": held, "k6_us": k6_us}


# --- phase 13: the distribution layer ---------------------------------------

def jax_record_keys():
    """(top-level keys, memory keys) of the record the JAX dry run writes:
    the dict literal ``rec`` in its ``run_cell``, read from the source
    (nothing of it is imported)."""
    import ast
    src = (Path(__file__).resolve().parent
           / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    keys = [k.value for k in rec.keys]
    return set(keys), {k.value for k in rec.values[keys.index("memory")]
                       .keys}


def start_dryruns():
    """One ``python -m repro_torch.launch.dryrun`` process per cell of
    DRYRUN_CELLS, all started together (each is one host thread of
    sharding propagation; the card is not used)."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = []
    for arch, shape, mesh, policy in DRYRUN_ALL:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--policy", policy,
               "--tag", DRYRUN_TAG]
        procs.append(((arch, shape, mesh, policy), subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs, ident):
    """Phase 13 (c): wait for every dry-run process (killing any past
    DRYRUN_TIMEOUT_S), then gate and print each cell's record and its
    reshards."""
    from repro_torch.launch.dryrun import cell_path, reshards_path
    from repro_torch.launch.reshard import reshard_totals
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    outs = []
    try:
        for cell, proc in procs:
            try:
                out, _ = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                out += f"\n(killed after {DRYRUN_TIMEOUT_S:.0f} s)"
            outs.append((cell, proc.returncode, out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    keys, mem_keys = jax_record_keys()
    for (arch, shape, mesh, policy), rc, out in outs:
        path = Path(cell_path(arch, shape, mesh, DRYRUN_TAG))
        require(rc == 0 and path.exists(),
                f"dry run {arch} x {shape} x {mesh} ({policy}): exit {rc}, "
                f"record "
                f"{'written' if path.exists() else 'missing'}: "
                f"{out.strip()[-1500:]}")
        rec = json.loads(path.read_text())
        require("error" not in rec, f"dry run {arch} x {shape} x {mesh}: "
                                    f"{rec.get('error')}")
        require(set(rec) == keys and set(rec["memory"]) == mem_keys,
                f"dry run {arch} x {shape} x {mesh}: keys "
                f"{sorted(set(rec) ^ keys)} / "
                f"{sorted(set(rec['memory']) ^ mem_keys)} differ from the "
                "JAX record's")
        n_rs, rs_bytes, rs_counts = reshard_totals(json.loads(Path(
            reshards_path(arch, shape, mesh, DRYRUN_TAG)).read_text()))
        refusal = DRYRUN_RESHARD_CELLS.get((arch, shape, mesh, policy))
        if refusal is not None:
            require(n_rs >= 1, f"dry run {arch} x {shape} x {mesh} "
                               f"({refusal}): no reshard")
            require(all(rs_bytes[k] <= rec["collective_bytes"][k]
                        and rs_counts[k] <= rec["collective_counts"][k]
                        for k in rs_bytes),
                    f"dry run {arch} x {shape} x {mesh}: reshards "
                    f"{rs_bytes} x{rs_counts} not inside its collectives "
                    f"{rec['collective_bytes']}")
        n = rec["n_devices"]
        coll = ", ".join(f"{k} {v:.4g} B x{rec['collective_counts'][k]}"
                         for k, v in rec["collective_bytes"].items() if v)
        resh = ", ".join(f"{k} {v:.4g} B x{rs_counts[k]}"
                         for k, v in rs_bytes.items())
        print(f"  {arch} x {shape} x {mesh}, {policy} ({n} ranks, "
              f"{rec['kind']}, "
              f"B={rec['global_batch']}, S={rec['seq_len']}): per device "
              f"argument bytes {rec['memory']['argument_bytes']:.4g}, "
              f"output {rec['memory']['output_bytes']:.4g}, peak "
              f"{rec['memory']['peak_bytes']:.4g} (meta shards); counted "
              f"FLOPs {rec['flops']:.4g} against analytic_flops / {n} = "
              f"{rec['analytic_flops'] / n:.4g} (ratio "
              f"{rec['flops'] * n / rec['analytic_flops']:.3f}); "
              f"collectives per device: {coll or 'none'}; "
              f"{n_rs} reshards"
              + (f" (class: {refusal})" if refusal else "")
              + f": {resh or 'none'}; placement "
              f"{rec['lower_s']} s, step {rec['compile_s']} s; keys = the "
              f"JAX record's [host of {ident}]")


def check_scan_charging(ident):
    """Phase 13 (d): each SCAN_CELLS cell's dry-run record with the scan
    charging equals the full loop's (the module docstring)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.reshard import reshard_totals
    cfg = configs.get_smoke_config("xlstm-1.3b")
    for shape, policy in SCAN_CELLS:
        got = {}
        for full in (False, True):
            notes, t0 = [], time.perf_counter()
            rec, log = dryrun.run_cell_and_reshards(
                "xlstm-1.3b", shape, "single", mesh_shape=SCAN_MESH,
                smoke=True, policy=policy, seq_len=SCAN_SEQ,
                full_loop=full, scan_log=notes)
            require("error" not in rec, f"scan check {shape} {policy} "
                                        f"(full loop {full}): "
                                        f"{rec.get('error')}")
            got[full] = (rec, reshard_totals(log), notes,
                         time.perf_counter() - t0)
        (rec, rs, notes, took), (ref, ref_rs, _, ref_took) = (got[False],
                                                              got[True])
        tol = 32 * rec["global_batch"] * cfg.d_model
        bad = [k for k in ("flops", "collective_bytes", "collective_counts")
               if rec[k] != ref[k]]
        bad += [k for k in ("argument_bytes", "output_bytes")
                if rec["memory"][k] != ref["memory"][k]]
        bad += [k for k in ("temp_bytes", "peak_bytes")
                if abs(rec["memory"][k] - ref["memory"][k]) > tol]
        bad += ["reshards"] if rs != ref_rs else []
        require(not bad and all(n["charged"] > 0 for n in notes),
                f"scan check {shape} {policy}: {bad} differ from the full "
                f"loop's ({ {k: (rec.get(k), ref.get(k)) for k in bad} }), "
                f"passes {notes}")
        passes = "; ".join(f"{n['pass']} k {n['steady_at']}, ran "
                           f"{n['ran']}, charged {n['charged']} of S "
                           f"{n['length']}" for n in notes)
        print(f"  (d) xlstm smoke {shape} {policy} on {SCAN_MESH}, S "
              f"{SCAN_SEQ}: {passes}; FLOPs {rec['flops']:.6g}, collectives "
              f"{sum(rec['collective_counts'].values())}, temp "
              f"{rec['memory']['temp_bytes']} B (full loop "
              f"{ref['memory']['temp_bytes']}, bound {tol}): equal to the "
              f"full loop's; {took:.1f} s charged, {ref_took:.1f} s full "
              f"[host of {ident}]")


def run_distribution(torch, dev, bounds):
    """Phase 13 (the module docstring). ``bounds``: phase 11 (b)'s
    ``quant none`` bounds per leaf, (gradients, parameters after the
    update). Returns {"launches": ...}."""
    import tempfile
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.lm.config import ShapeCell
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.tools.lm_train_gap import (
        GAP_BATCH, GAP_SEQ, gap_config, launcher_optimizer, tree_gaps)
    t_phase, ident = time.perf_counter(), gpu_identity()
    g_bd, p_bd = bounds
    cfg, opt = gap_config(), launcher_optimizer()
    params = tree.tree_map(lambda t: t.to(dev),
                           init_lm(cfg, seed=0, device="cpu"))
    it = synthetic_token_batches(cfg, GAP_BATCH, GAP_SEQ, seed=17)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
    it.close()
    mesh = make_local_mesh(dev)
    specs = shd.param_specs(params, cfg, mesh)
    sh = shd.to_shardings(specs, mesh)
    placed = shd.place(params, sh)
    b_sh = shd.to_shardings(shd.batch_specs(
        cfg, ShapeCell("custom", GAP_SEQ, GAP_BATCH, "train"), mesh), mesh)
    on_mesh = {k: distribute_tensor(v, mesh, b_sh[k].placements)
               for k, v in batch.items()}
    plain_step = steps.make_train_step(cfg, opt)
    mesh_step = steps.make_train_step(cfg, opt, grad_specs=specs)

    def on_the_mesh():
        with implicit_replication():
            return mesh_step(placed, opt.init(placed), on_mesh)

    def mesh_grads():
        with implicit_replication():
            return steps.lm_value_and_grad(placed, cfg, on_mesh)[1]

    def plain():
        return plain_step(params, opt.init(params), batch)
    print(f"  (a) make_train_step(grad_specs=param_specs) on DTensor "
          f"parameters over the (1, 1) NCCL mesh against the plain step: "
          f"qwen2-0.5b's width, {cfg.n_layers} layers, float32, "
          f"B={GAP_BATCH}, S={GAP_SEQ}")
    t0 = time.perf_counter()
    (got, g_mesh), counts = counted_run(lambda: (on_the_mesh(),
                                                 mesh_grads()))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    require(not nonzero(counts), f"the mesh step launched kernels: "
                                 f"{nonzero(counts)}")
    want, g_plain = plain(), steps.lm_value_and_grad(params, cfg, batch)[1]

    def full(t):
        return tree.tree_map(lambda x: x.full_tensor()
                             if isinstance(x, DTensor) else x, t)
    require(all(isinstance(x, DTensor) for x in tree.leaves(got[0])),
            "the mesh step's parameters are not DTensors")
    loss_rel = abs(float(full(got[2])) - float(want[2])) / abs(float(
        want[2]))
    print(f"  loss {float(full(got[2])):.6f} on the mesh against "
          f"{float(want[2]):.6f} plain, {loss_rel:.3g} relative (bound "
          "1e-05)")
    require(loss_rel <= 1e-5, f"mesh loss {loss_rel} > 1e-5")
    for kind, gaps, bd in (("gradient", tree_gaps(full(g_mesh), g_plain),
                            g_bd),
                           ("parameter after the update",
                            tree_gaps(full(got[0]), want[0]), p_bd)):
        worst = max(gaps, key=lambda k: gaps[k] / bd[k])
        print(f"  worst {kind} leaf {worst}: {gaps[worst]:.3g} of its "
              f"largest |value| (phase 11 (b)'s bound {bd[worst]:.3g}); "
              f"{sum(v == 0 for v in gaps.values())} of {len(gaps)} leaves "
              "bit for bit")
        require(all(gaps[k] <= bd[k] for k in gaps),
                f"mesh {kind}s past phase 11 (b)'s bounds: "
                f"{ {k: v for k, v in gaps.items() if v > bd[k]} }")
    # DTensor's host cost on one card, paired: plain, mesh, mesh, plain
    times = {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):
        times[which].append(host_ms(torch, on_the_mesh if which == "mesh"
                                    else plain, DIST_TIMING_REPS))
    print(f"  ms per step (median of {DIST_TIMING_REPS}, host clock, in "
          f"the order plain, mesh, mesh, plain): mesh "
          f"{times['mesh'][0]:.3f}, {times['mesh'][1]:.3f}; plain "
          f"{times['plain'][0]:.3f}, {times['plain'][1]:.3f}; the mesh's "
          f"first step with its sharding propagation {first_s:.1f} s; "
          f"launches 0 [{ident}]")
    procs = start_dryruns()
    try:
        print("  (b) a checkpoint saved from the mesh, restored onto it")
        with tempfile.TemporaryDirectory(prefix="mesh_ckpt_") as d:
            mgr = CheckpointManager(d)
            mgr.save(1, got[0])
            back = mgr.restore(1, got[0], device=dev, shardings=sh)
            flat_sh, saved = dict(tree.items(sh)), dict(tree.items(got[0]))
            for k, v in tree.items(back):
                require(isinstance(v, DTensor) and v.placements
                        == flat_sh[k].placements == saved[k].placements,
                        f"restored {k}: placements "
                        f"{getattr(v, 'placements', None)}")
                require(torch.equal(v.full_tensor(),
                                    saved[k].full_tensor()),
                        f"restored {k} differs from the saved leaf")
            n = len(mgr.restore_arrays(1))      # every digest verified
        print(f"  {n} leaves restored onto their placements, every digest "
              "verified, equal to the saved parameters")
        print(f"  (c) the dry run at full width, one process per cell "
              f"({len(DRYRUN_ALL)} together), and beside it (d)")
        if torch.distributed.is_initialized():  # (d) opens a fake one
            torch.distributed.destroy_process_group()
        check_scan_charging(ident)
    finally:
        finish_dryruns(procs, ident)
    took = time.perf_counter() - t_phase
    print(f"  phase 13 took {took:.1f} s [{ident}]")
    require(took <= DIST_PHASE_S, f"phase 13 took {took:.1f} s, over "
                                  f"{DIST_PHASE_S:.0f}")
    return {"launches": counts}


# --- phase 14: the examples' twins -------------------------------------------

# run in each twin's process: the twin's main, then its process's launch
# counts as the last line
EXAMPLE_RUNNER = """
import importlib.util, json, sys
root, name, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path[:0] = [root + "/src", root]
import chip_smoke
counters = chip_smoke.kernel_counters()
spec = importlib.util.spec_from_file_location(
    name, f"{root}/examples/{name}_torch.py")
twin = importlib.util.module_from_spec(spec)
spec.loader.exec_module(twin)
twin.main(argv)
print(json.dumps({"launches": {c.__name__: c.launches for c in counters}}))
"""


def example_twin(name):
    """The twin of ``examples/<name>.py``, imported from its file."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def key_lines(name, out):
    """The lines of EXAMPLE_LINES[name] that ``out`` holds, each pattern
    at least its count of times."""
    lines = out.splitlines()
    found = []
    for pattern, times in EXAMPLE_LINES[name]:
        hits = [ln for ln in lines if re.search(pattern, ln)]
        require(len(hits) >= times,
                f"{name}: {len(hits)} lines match {pattern!r}, expected "
                f"{times}; its output ends {out[-2000:]!r}")
        found += hits[:times]
    return found


def run_examples(torch, dev):
    """Phase 14: the five twins on the card, in processes of their own
    started together (each counting its kernel launches around the twin's
    main); meanwhile the serve CLI's main here, counted, with the serve
    twin's argument lists. Returns {"launches": {kernel: n}}."""
    import io
    import os
    import tempfile
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    ident = gpu_identity()
    root = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="2")
    procs = {}
    try:
        for name, argv in EXAMPLE_ARGS.items():
            if name == "train_lm_distributed":
                argv = argv + ["--ckpt-dir", str(tmp / "ckpt")]
            log = open(tmp / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_RUNNER, str(root), name]
                + argv, stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=root), log, time.perf_counter())
        # the serve twin's launchers, here and counted
        twin = example_twin("serve_quantized_lm")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, here = counted_run(lambda: [
                serve.main(args + ["--device", str(dev)])
                for _, args in twin.runs()])
        key_lines("serve_quantized_lm", buf.getvalue())
        print(f"  the serve twin's launchers in this process, counted: "
              f"{nonzero(here)}")
        total = {c.__name__: here.get(c.__name__, 0)
                 for c in kernel_counters()}
        ends = {}
        while (len(ends) < len(procs)
               and time.perf_counter() - t_phase < EXAMPLES_PHASE_S):
            for name, (proc, _, _) in procs.items():
                if name not in ends and proc.poll() is not None:
                    ends[name] = time.perf_counter()
            time.sleep(0.1)
        for name, (proc, log, t0) in procs.items():
            rc = proc.poll()
            took = ends.get(name, time.perf_counter()) - t0
            log.close()
            out = (tmp / f"{name}.log").read_text()
            require(rc == 0, f"the {name} twin "
                             + ("ran past the phase's limit" if rc is None
                                else f"exited {rc}")
                             + f"; its output ends {out[-3000:]!r}")
            lines = key_lines(name, out)
            counts = json.loads(out.strip().splitlines()[-1])["launches"]
            for k in total:
                total[k] += counts.get(k, 0)
            print(f"  {name}_torch.py "
                  f"{' '.join(EXAMPLE_ARGS[name]) or '(its defaults)'}: "
                  f"exit 0 in {took:.1f} s (five twins at once on one card), "
                  f"launches in its process {nonzero(counts)}; "
                  + " | ".join(ln.strip() for ln in lines))
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k in EXAMPLE_KERNELS if not total[k]]
    require(not missing, f"the examples launched none of {missing}: {total}")
    took = time.perf_counter() - t_phase
    print(f"  launches over the phase: {nonzero(total)}; phase 14 took "
          f"{took:.1f} s [{ident}]")
    require(took <= EXAMPLES_PHASE_S, f"phase 14 took {took:.1f} s, over "
                                      f"{EXAMPLES_PHASE_S:.0f}")
    return {"launches": total}


def main() -> int:
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no {src / 'repro_torch'}: run it from the root "
              "of a checkout of the repo", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    # a hang anywhere (a lost worker thread, a stuck launch) ends the run
    # with every thread's stack, inside the caller's time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build
    from repro_torch.models.so3krates import So3kratesConfig
    from repro_torch.serving import random_graphs

    dev = torch.device("cuda", 0)
    print(gpu_identity())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    _build.library()
    print(f"phase 1: kernels built and loaded in "
          f"{_build.build_seconds():.1f} s; ptxas per kernel:")
    resources = kernel_resources(_build.build_log())
    require(resources, "no ptxas report in the build log")
    for name, regs, st, ld, smem in resources:
        print(f"  {name}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B, static shared {smem} B")

    cfg = So3kratesConfig(feat=64, vec_feat=16, n_layers=3, n_rbf=16,
                          cutoff=10.0, dir_bits=16)
    graphs = random_graphs(16, 9, 24, cfg.n_species, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    print("phase 2: kernels against their plain versions")
    t0 = time.perf_counter()
    rows = check_quant_matmul(torch, dev, gen)
    rows += check_edge_softmax(torch, dev, gen, graphs, cfg)
    rows += check_mddq_encode(torch, dev, gen, cfg)
    rows += check_act_quant(torch, dev, gen)
    rows += check_kv_append(torch, dev, gen)
    rows += check_decode_attention(torch, dev, gen)
    for r in rows:
        for t in [r] + r.get("other_shapes", []):
            lib = ", ".join(f"{k} {t[k]}" for k in sorted(t)
                            if k.startswith("library") and k != "library")
            print(f"  {r['name']} ({t['shape']}): {t['ms']:.5f} ms per "
                  f"call (CUDA events, back to back), device "
                  f"{t['device_ms']} ms (profiler"
                  + (f", {t['device_kernels_per_call']} kernels per call"
                     if "device_kernels_per_call" in t else "")
                  + f"), plain {t.get('plain_ms', r['plain_ms']):.5f} ms, "
                  f"{lib or 'library None'}, bound {t['bound_ms']:.6f} ms "
                  f"({t['bound_by']})")

    print(f"  phase 2 took {time.perf_counter() - t0:.1f} s")
    print("phase 3: QuantizedEngine, paper config, w4a8, MDDQ kernel")
    t0 = time.perf_counter()
    so3 = run_engine(torch, dev, cfg, graphs)
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s")
    print("phase 4: LM decode, qwen2-0.5b, serve_w8a8, int8 KV, bf16")
    t0 = time.perf_counter()
    lm, lm_model = run_lm_decode(torch, dev)
    print(f"  phase 4 took {time.perf_counter() - t0:.1f} s")
    print("phase 5: MDEngine, paper config, w4a8, MDDQ kernel, "
          f"{MD_REPLICAS} replicas x {MD_ATOMS} atoms")
    t0 = time.perf_counter()
    md = run_md(torch, dev, cfg)
    print(f"  phase 5 took {time.perf_counter() - t0:.1f} s")
    print("phase 6: the online SO3 server, paper config, w4a8, MDDQ kernel, "
          f"buckets {SERVER_BUCKETS}, {SERVER_REQUESTS} requests at "
          f"{SERVER_RATE:.0f} req/s")
    t0 = time.perf_counter()
    server, held, single, artifact = run_server(torch, dev, cfg, graphs)
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s")
    print("phase 7: the cluster (w4a8 x2, w8a8, fp32 on one card) and a "
          f"checkpointed MD session, {SERVER_REQUESTS} requests at "
          f"{SERVER_RATE:.0f} req/s, {SESSION_STEPS} MD steps")
    cluster = run_cluster(torch, dev, cfg, single)
    print("phase 8: training, paper width: fp32 then gaq_w4a8 QAT "
          f"(12-bit codebook, warm-up, LEE), {TRAIN_FRAMES} + {TEST_FRAMES} "
          "frames; evaluate, NVE and serve the trained weights")
    training = run_training(torch, dev)
    print("phase 9: the health plane over the served cluster: the serve CLI "
          f"with --metrics-out --trace-out --alerts-out ({HEALTH_TIERS}, "
          f"{HEALTH_REQUESTS} requests at {SERVER_RATE:.0f} req/s, "
          f"{HEALTH_SESSION_STEPS} MD steps), on and off in turns; the "
          "chaos drill")
    health = run_health(torch, dev, cfg, artifact, cluster["flush_s"])
    print("phase 10: the dense LM's prefill and the decode from it: "
          f"qwen2-0.5b at full width (B={PREFILL_BATCH}, S={PREFILL_SEQ}, "
          f"bf16, serve_w8a8), then {', '.join(NEW_ARCHS)} at their "
          "published widths, one layer deep; the int4 KV cache")
    prefill = run_prefill_and_decode(torch, dev, lm_model)
    del lm_model
    torch.cuda.empty_cache()
    print("phase 11: the dense LM trains: the launcher at qwen2-0.5b's full "
          f"width and depth (B={LM_TRAIN_BATCH}, S={LM_TRAIN_SEQ}, bf16, "
          f"{LM_TRAIN_STEPS} steps qat_w4a8 + ef8, {LM_PLAIN_STEPS} plain); "
          "one step card against CPU; kill and resume")
    with kept_heap():
        lm_train = run_lm_train(torch, dev)
    torch.cuda.empty_cache()
    print("phase 12: the MoE, Mamba2-hybrid and xLSTM families at their "
          f"published widths ({', '.join(FAM_ARCHS)}; moonshot one layer "
          f"deep; B={FAM_BATCH}, S={FAM_SEQ}, bf16); the smoke configs card "
          "against CPU")
    families = run_lm_families(torch, dev)
    print("phase 13: the distribution layer: the train step on the local "
          "(1, 1) NCCL mesh against the plain step, a checkpoint restored "
          "onto the mesh, the dry run at full width "
          f"({', '.join(' x '.join(c) for c in DRYRUN_ALL)})")
    distribution = run_distribution(torch, dev, lm_train["bounds"])
    print("phase 14: the five examples' twins (examples/*_torch.py) at "
          "reduced sizes, in processes of their own, started together")
    examples = run_examples(torch, dev)
    for row in rows:
        if row["name"] == "mddq_encode_kernel":
            row["training_shape"] = training["k4_training"]
        if row["name"] == "decode_attention_int8kv":
            row["lm_prefill_device_us"] = prefill["k6_us"]
            row["lm_families_device_us"] = families["k6_us"]
        for key, h in (("so3_server_shapes", held),
                       ("cluster_shapes", cluster["held"]),
                       ("training_shapes", training["held"]),
                       ("lm_prefill_shapes", prefill["held"]),
                       ("lm_families_shapes", families["held"])):
            if row["name"] in h:
                err, shapes = h[row["name"]]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row[key] = shapes
        by_path = {"so3_sparse": so3[row["name"]],
                   "lm_decode": lm[row["name"]], "md": md[row["name"]],
                   "so3_server": server[row["name"]],
                   "cluster": cluster["cluster"].get(row["name"], 0),
                   "md_session": cluster["md_session"].get(row["name"], 0),
                   "training": training["launches"].get(row["name"], 0),
                   "health_plane": health["launches"].get(row["name"], 0),
                   "lm_prefill": prefill["launches"].get(row["name"], 0),
                   "lm_train": lm_train["launches"].get(row["name"], 0),
                   "lm_families": families["launches"].get(row["name"], 0),
                   "distribution": distribution["launches"].get(
                       row["name"], 0),
                   "examples": examples["launches"].get(row["name"], 0)}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the smoke run imported JAX or the JAX package")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
