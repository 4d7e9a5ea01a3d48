"""Quantized serving launcher: counterpart of ``repro/launch/serve.py``.

LM decode (``--workload lm``):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch qwen2-0.5b --quant serve_w8a8 --kv-quant --tokens 64 \\
        --batch 8 --cache-len 1024                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch qwen2-0.5b --smoke --quant serve_w8a8 --kv-quant \\
        --tokens 8 --batch 2 --cache-len 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --workload lm \\
        --arch musicgen-large --smoke --quant serve_w8a8 --kv-quant \\
        --tokens 8 --batch 2 --cache-len 64 --device cpu  # audio frames

It builds the model from random weights (numpy seed), quantizes them,
allocates the KV cache and runs a greedy decode loop from token 0 at
position 0, then prints the weight bytes (float32 -> served), the
KV-cache bytes and the decode rate, as the JAX launcher does. As the
JAX launcher jits one step for every position (``cur_index`` traced),
the card runs the first step eagerly and then one captured step per
(batch, cache length) (``repro_torch.captured``): ``decode_step`` with
the position read from a device buffer, ``lm_head`` and the argmax
written into the static token buffer, replayed once per token after
the host sets the position buffer. The CPU runs the same loop eagerly
(:func:`greedy_decode_eager`). The
``--smoke`` configs run in float32, the full ones in ``cfg.dtype``
(bf16). ``--arch`` takes every id of ``configs.ARCH_IDS``, the MoE,
Mamba2-hybrid and xLSTM families included (the latter only with
``--quant none``: its gate projection ``b/wif`` stays float under the
quantization policy, and a serve mode raises ``ValueError``, as the
reference cannot serve it either); the non-token frontends
(``musicgen-large``'s audio frames, ``chameleon-34b``'s image patches)
decode from zero embeddings.

SO(3) force-field inference through ``serving.QuantizedEngine``
(``--workload so3``): one shot, a stream of molecules through
``infer_batch``, or with ``--server`` Poisson traffic through the
micro-batching scheduler (``server.MicroBatchScheduler``), with latency
percentiles, flush reasons and dispatch counts:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload so3 \\
        --server --rate 50 --requests 200 --buckets 16 32 --max-batch 8 \\
        [--artifact model.npz]       # cold start from a packed artifact

``--save-artifact path.npz`` packs the engine's quantized weights (the
JAX package's format: either package loads the other's files);
``--guardrails`` withholds non-finite results with a typed error. With
``--replicas N`` (or ``--tiers``, ``--swap-artifact``, ``--md-session``)
the replay goes through the multi-replica pool (``repro_torch.cluster``;
on one card every replica is on ``cuda:0`` with its own stream):

    PYTHONPATH=src python -m repro_torch.launch.serve --workload so3 \\
        --server --replicas 2 --tiers w4a8:2,w8a8:1,fp32:1 --guardrails \\
        --stall-timeout 30 --md-session 400 [--swap-artifact new.npz]

``--tiers`` builds a mixed-precision fleet whose flagged results re-run
one tier up, ``--swap-artifact`` fires a rolling weight swap halfway
through the replay, ``--md-session N`` streams a checkpointed N-step MD
trajectory through the same replicas (``repro_torch.sessions``) and
``--stall-timeout`` arms the pool's stall watchdog.

The obs flags arm the health plane on either workload (``repro_torch.obs``,
as the JAX launcher's): ``--metrics-out`` rewrites the metrics registry
as Prometheus text every ``--export-interval`` seconds,
``--trace-out`` appends one JSON trace per request and session chunk,
and ``--alerts-out`` evaluates the stock SLO catalogue and anomaly
detectors every ``--health-interval`` seconds and appends one JSON alert
per line; on the cluster path the pool subscribes to the alerts:

    PYTHONPATH=src python -m repro_torch.launch.serve --workload so3 \\
        --server --tiers w4a8:2,w8a8:1,fp32:1 --guardrails \\
        --md-session 200 --metrics-out m.prom --trace-out t.jsonl \\
        --alerts-out a.jsonl --export-interval 1 --health-interval 0.5

``scripts/obs_top.py`` and ``scripts/trace_report.py --chrome-trace``
read these files unchanged.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.captured import CapturedProgram, copy_into, new_pool
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.guardrails import GuardrailConfig
from repro_torch.models.lm import transformer as tfm
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.quant.apply import quantize_params_tree, quantized_bytes
from repro_torch.server import (MicroBatchScheduler, SchedulerConfig,
                                SizeClass, TrafficConfig, load_artifact,
                                load_engine, make_traffic, run_open_loop,
                                save_artifact)
from repro_torch.serving import QuantizedEngine, ServeConfig, random_graphs

__all__ = ["ServedLM", "DecodeRun", "lm_config", "build_lm", "decode",
           "greedy_decode", "greedy_decode_eager", "run_lm", "run_so3",
           "run_so3_server", "main"]

@dataclasses.dataclass
class ServedLM:
    """A model ready to decode: config, served parameters, the output
    projection made once (``transformer.lm_head``) and the byte counts.
    ``programs`` holds its captured decode steps by (batch, cache
    length), all in one graph pool (a copy made with
    ``dataclasses.replace`` starts with none)."""
    cfg: LMConfig
    params: tfm.Params
    head: torch.Tensor
    device: torch.device
    fp32_bytes: int
    served_bytes: int
    programs: Dict[Tuple[int, int], CapturedProgram] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    graph_pool: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)


@dataclasses.dataclass
class DecodeRun:
    tokens: torch.Tensor        # (B, n_tokens) generated ids
    seconds: float              # host clock over steps 2..n_tokens-1
    cache_bytes: int
    steps_timed: int


def lm_config(arch: str, *, smoke: bool = False, quant: str = "none",
              kv_quant: bool = False) -> LMConfig:
    """The launcher's config: the arch's full or smoke config in the given
    serving mode; smoke configs run in float32, as in the JAX launcher."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    return dataclasses.replace(cfg, quant_mode=quant, kv_quant=kv_quant,
                               dtype=torch.float32 if smoke else cfg.dtype)


def build_lm(cfg: LMConfig, seed: int = 0,
             device: DeviceLike = None) -> ServedLM:
    """Random float weights from ``seed``, quantized for ``cfg.quant_mode``
    (unless it is ``none``)."""
    dev = resolve_device(device)
    params = tfm.init_lm(dataclasses.replace(cfg, quant_mode="none"), seed,
                         dev)
    fp32_bytes = quantized_bytes(params)
    if cfg.quant_mode != "none":
        params = quantize_params_tree(params, cfg)
    return ServedLM(cfg, params, tfm.lm_head(params, cfg), dev, fp32_bytes,
                    quantized_bytes(params))


def decode(lm: ServedLM, cache: tfm.Params, tokens: torch.Tensor,
           cur_index: int) -> torch.Tensor:
    """One decode step of ``lm`` on (B, 1) token ids or (B, 1, d)
    embeddings: logits (B, V) f32; ``cache`` is updated in place."""
    logits, _ = tfm.decode_step(lm.params, lm.cfg, cache, tokens, cur_index,
                                head=lm.head)
    return logits


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy_step(lm: ServedLM) -> Callable:
    """The decode step as captured: ``decode_step`` at the device
    position ``pos`` on ``ids`` (or on ``embeds`` for a non-token
    frontend), then ``lm_head`` and the argmax written into ``ids``."""
    def step(cache, ids, pos, embeds=None):
        x = ids if embeds is None else embeds
        ids.copy_(decode(lm, cache, x, pos).argmax(-1, keepdim=True))
        return ids
    return step


def _greedy_loop(lm: ServedLM, batch: int, cache_len: int, n_tokens: int,
                 cache: Optional[tfm.Params], captured: bool) -> DecodeRun:
    if not 1 <= n_tokens <= cache_len:
        raise ValueError(f"n_tokens={n_tokens} must be in [1, cache_len="
                         f"{cache_len}]")
    if cache is None:
        cache = tfm.init_cache(lm.cfg, batch, cache_len, lm.device)
    cache_bytes = quantized_bytes(cache)
    inputs = {"cache": cache,
              "ids": torch.zeros((batch, 1), dtype=torch.long,
                                 device=lm.device),
              # the position buffer: set from the host's counter, read by
              # the step on the device (n_tokens <= cache_len bounds it)
              "pos": torch.zeros((), dtype=torch.int32, device=lm.device)}
    if lm.cfg.frontend != "token":
        inputs["embeds"] = torch.zeros((batch, 1, lm.cfg.d_model),
                                       dtype=lm.cfg.dtype, device=lm.device)
    step = _greedy_step(lm)
    # the first step eagerly, at an int position
    x = inputs.get("embeds", inputs["ids"])
    inputs["ids"].copy_(decode(lm, cache, x, 0).argmax(-1, keepdim=True))
    out = [inputs["ids"].clone()]
    prog = None

    def run(i: int) -> torch.Tensor:
        """Step i's ids: eager, or the (batch, cache_len) program's."""
        nonlocal prog
        if not captured:
            inputs["pos"].fill_(i)
            return step(**inputs)
        if prog is None:
            prog = lm.programs.get((batch, cache_len))
            if prog is None:
                # captured on its first use: its eager warm-up is step i
                if lm.graph_pool is None:
                    lm.graph_pool = new_pool()
                inputs["pos"].fill_(i)
                prog = lm.programs[(batch, cache_len)] = CapturedProgram(
                    step, inputs, device=lm.device, pool=lm.graph_pool,
                    name=f"the {lm.cfg.name} decode step (B={batch}, "
                         f"S={cache_len})")
                return prog.first_result
            # this run's cache and first token into the static buffers
            copy_into(prog.static["cache"], cache)
            prog.static["ids"].copy_(inputs["ids"])
        prog.static["pos"].fill_(i)
        return prog.replay()
    for i in range(1, min(2, n_tokens)):
        out.append(run(i).clone())
    _sync(lm.device)
    t0 = time.perf_counter()
    for i in range(2, n_tokens):
        out.append(run(i).clone())
    _sync(lm.device)
    seconds = time.perf_counter() - t0
    if prog is not None:
        copy_into(cache, prog.static["cache"])  # the caller's cache, too
    return DecodeRun(torch.cat(out, dim=1), seconds, cache_bytes,
                     max(n_tokens - 2, 0))


def greedy_decode(lm: ServedLM, batch: int, cache_len: int, n_tokens: int,
                  cache: Optional[tfm.Params] = None) -> DecodeRun:
    """Greedy decode of ``n_tokens`` tokens from token 0 at position 0.
    A non-token frontend (audio frames, image patches) is fed zero
    embeddings (B, 1, d_model) at every step, as the JAX launcher feeds
    its frontend stub; the argmax ids are still returned. ``cache`` (one
    of ``init_cache``'s, made here when omitted) ends holding the run's
    keys and values. On the card the first step runs eagerly and every
    later one replays the captured step of (batch, cache_len), captured
    in its first run (whose step 1 is the capture's warm-up); on the CPU
    it is :func:`greedy_decode_eager`. The first two steps warm up; the
    host clock runs over the other ``n_tokens - 2`` steps and ends in a
    synchronize."""
    return _greedy_loop(lm, batch, cache_len, n_tokens, cache,
                        captured=lm.device.type == "cuda")


def greedy_decode_eager(lm: ServedLM, batch: int, cache_len: int,
                        n_tokens: int,
                        cache: Optional[tfm.Params] = None) -> DecodeRun:
    """:func:`greedy_decode` with every step run eagerly, the position
    (after the first step's) read from the same device buffer: the CPU's
    path, and on the card the body the captured step replays."""
    return _greedy_loop(lm, batch, cache_len, n_tokens, cache,
                        captured=False)


def run_lm(args) -> DecodeRun:
    cfg = lm_config(args.arch, smoke=args.smoke, quant=args.quant,
                    kv_quant=args.kv_quant)
    lm = build_lm(cfg, seed=args.seed, device=args.device)
    run = greedy_decode(lm, args.batch, args.cache_len, args.tokens)
    print(f"arch={cfg.name} quant={args.quant} kv_quant={args.kv_quant} "
          f"device={lm.device}")
    print(f"weights: fp32 {lm.fp32_bytes / 1e6:.2f} MB -> served "
          f"{lm.served_bytes / 1e6:.2f} MB "
          f"({lm.fp32_bytes / max(lm.served_bytes, 1):.2f}x)")
    print(f"kv-cache: {run.cache_bytes / 1e6:.2f} MB for B={args.batch} "
          f"S={args.cache_len}")
    steps = max(run.steps_timed, 1)
    print(f"decode: {run.steps_timed * args.batch / max(run.seconds, 1e-9):.1f}"
          f" tok/s ({run.seconds / steps * 1e3:.1f} ms/step)")
    return run


# the serving knobs the so3 flags set when not given (an artifact keeps
# its own instead)
SO3_SERVE_DEFAULTS = {"bucket_sizes": (16, 32, 64), "max_batch": 32,
                      "path": "auto"}


def _serve_overrides(args) -> dict:
    given = {"bucket_sizes": tuple(args.buckets) if args.buckets else None,
             "max_batch": args.max_batch, "path": args.path}
    return {k: v for k, v in given.items() if v is not None}


def run_so3(args):
    """The SO3 workload: build (or cold-start) the engine, then one shot
    through ``infer_batch`` or, with ``--server``, the online replay
    (returns its ``TrafficResult``)."""
    if args.artifact:
        # the mode is baked into the packed weights: it comes from the
        # artifact unless asked for, and a mismatch is an error
        # (so do its path, MDDQ kernel and edge capacity; the bucket
        # ladder, max_batch and path flags override only when given)
        t0 = time.monotonic()
        serve = dataclasses.replace(load_artifact(args.artifact).serve,
                                    **_serve_overrides(args))
        if args.mode:
            serve = dataclasses.replace(serve, mode=args.mode)
        engine = load_engine(args.artifact, serve=serve, device=args.device)
        print(f"cold start from {args.artifact} in "
              f"{time.monotonic() - t0:.2f}s "
              "(packed weights, no quantization pass)")
    else:
        serve = ServeConfig(mode=args.mode or "w8a8",
                            **dict(SO3_SERVE_DEFAULTS,
                                   **_serve_overrides(args)))
        model_cfg = So3kratesConfig(feat=args.feat, vec_feat=args.vec_feat,
                                    n_layers=args.layers, n_rbf=8,
                                    dir_bits=args.dir_bits)
        engine = QuantizedEngine.from_config(model_cfg, serve=serve,
                                             seed=args.seed,
                                             device=args.device)
    if args.guardrails:
        engine.guardrails = GuardrailConfig(check_finite=True)
        print("guardrails: non-finite results are withheld with a typed "
              "GuardrailViolation")
    if args.save_artifact:
        nbytes = save_artifact(args.save_artifact, engine)
        print(f"packed artifact -> {args.save_artifact} "
              f"({nbytes / 1e3:.1f} KB)")

    mem = engine.memory_report()
    print(f"workload=so3 mode={engine.serve.mode} device={engine.device}")
    print(f"weights: fp32 {mem['fp32_bytes'] / 1e3:.1f} KB -> served "
          f"{mem['served_bytes'] / 1e3:.1f} KB ({mem['compression_x']}x)")
    if args.server:
        return run_so3_server(engine, args)

    graphs = random_graphs(args.graphs, args.min_atoms, args.max_atoms,
                           engine.model_cfg.n_species, seed=args.seed,
                           density=args.density)
    # run the traffic's shape classes once, so the timed pass below
    # measures steady state, not the kernels' build
    t0 = time.monotonic()
    engine.infer_batch(graphs)
    print(f"warmup: ran {len(engine.shapes_seen)} shape class(es) in "
          f"{time.monotonic() - t0:.2f}s ({len(engine.compiled_shapes)} "
          "captured)")
    t0 = time.monotonic()
    results = engine.infer_batch(graphs)
    dt = time.monotonic() - t0
    print(f"infer_batch: {len(graphs)} molecules "
          f"({args.min_atoms}-{args.max_atoms} atoms) in {dt:.2f}s "
          f"-> {len(graphs) / dt:.1f} mol/s, buckets used "
          f"{sorted({r.bucket_capacity for r in results})}, paths "
          f"{sorted({r.path for r in results})} "
          f"(dispatch {engine.dispatch_stats})")
    if args.lee:
        diag = engine.lee_diagnostic(graphs[:4], seed=1, n_rotations=2)
        print(f"served-model LEE: mean {diag['lee_mean']:.2e} "
              f"max {diag['lee_max']:.2e} (padding masked)")


def run_so3_server(engine: QuantizedEngine, args):
    """Poisson traffic through the micro-batching scheduler — or, with
    ``--replicas``/``--tiers``/``--swap-artifact``/``--md-session``,
    through the cluster pool: latency percentiles, flush reasons and
    dispatch counts. Returns the replay's ``TrafficResult``."""
    mid = (args.min_atoms + args.max_atoms) // 2
    if mid + 1 > args.max_atoms:      # degenerate range: one size class
        size_mix = (SizeClass(args.min_atoms, args.max_atoms, 1.0),)
    else:
        size_mix = (SizeClass(args.min_atoms, mid, 0.5),
                    SizeClass(mid + 1, args.max_atoms, 0.5))
    traffic = make_traffic(TrafficConfig(
        rate_rps=args.rate, n_requests=args.requests, size_mix=size_mix,
        n_species=engine.model_cfg.n_species, density=args.density,
        seed=args.seed))
    max_batch = min(args.sched_batch, engine.serve.max_batch)
    if (args.replicas > 1 or args.swap_artifact or args.md_session
            or args.tiers):
        return _run_cluster(engine, args, traffic, max_batch)
    sched_cfg = SchedulerConfig(max_batch=max_batch,
                                deadline_ms=args.deadline_ms,
                                max_queue=args.max_queue)
    with MicroBatchScheduler(engine, sched_cfg) as sched:
        print(f"warmup: {sched.warmup_s:.2f}s "
              f"({len(engine.shapes_seen)} shape classes, "
              f"{len(engine.compiled_shapes)} captured)")
        engine.reset_stats()    # keep the streaming phase unpolluted
        res = run_open_loop(sched, traffic, rate_rps=args.rate)
        stats = sched.stats()
    _print_server_summary(res, stats, args, max_batch)
    return res


def _run_cluster(engine: QuantizedEngine, args, traffic, max_batch: int):
    """The replay through ``ClusterPool`` (one engine per replica; on the
    CPU with ``--device cpu``), with the rolling swap fired halfway and
    the MD session beside it, as the JAX launcher does."""
    from repro_torch.cluster import ClusterConfig, ClusterPool
    cluster = ClusterConfig(n_replicas=args.replicas, max_batch=max_batch,
                            deadline_ms=args.deadline_ms,
                            max_queue=args.max_queue,
                            stall_timeout_s=args.stall_timeout)
    device = "cpu" if engine.device.type == "cpu" else None
    guardrails = engine.guardrails if args.guardrails else None
    if args.tiers:
        # mixed-precision fleet: flagged w4a8 results re-run one tier up
        # (fresh random weights shared across the tiers — a demo fleet,
        # like the non-artifact engine)
        plan = {}
        for part in args.tiers.split(","):
            t, _, k = part.partition(":")
            plan[t.strip()] = int(k or 1)
        pool = ClusterPool.from_tiers(
            engine.model_cfg, serve=engine.serve, tier_plan=plan,
            cluster=cluster, seed=args.seed, guardrails=guardrails,
            device=device)
    else:
        pool = ClusterPool.from_quantized(
            engine.model_cfg, engine.qparams, engine.serve, cluster,
            fp32_nbytes=engine.memory_report()["fp32_bytes"],
            artifact_version=engine.artifact_version, guardrails=guardrails,
            device=device)
    if getattr(args, "_alert_bus", None) is not None:
        # fleet surfacing: alerts land in pool.stats()["alerts"] and bump
        # pool_events_total{event="alert"}
        pool.watch_alerts(args._alert_bus)
    # the caller reads the closed pool's flush and warmup records (the
    # timeline's flush and warmup slices)
    args._pool = pool
    swap_report = {}
    swap_thread = session = session_mgr = None
    with pool:
        s0 = pool.stats()
        print(f"cluster: {pool.n_replicas} replicas on "
              f"{[r['device'] for r in s0['replicas']]}, parallel "
              f"warmup {s0['warmup_s']:.2f}s")
        pool.reset_stats()
        if args.md_session:
            session, session_mgr = _start_md_session(pool, engine, args)
            args._session = session
        if args.swap_artifact:
            # fire the rolling swap halfway through the replay; a failure
            # surfaces after the replay, not in the timer thread
            half = traffic[len(traffic) // 2][0]

            def do_swap():
                try:
                    swap_report.update(pool.swap_artifact(args.swap_artifact))
                except BaseException as e:
                    swap_report["error"] = e
            swap_thread = threading.Timer(half, do_swap)
            swap_thread.start()
        res = run_open_loop(pool, traffic, rate_rps=args.rate)
        if swap_thread is not None:
            # the swap warms each replacement before the exchange, which
            # can outlast a short replay: wait, so the report is real
            swap_thread.join()
        if session is not None:
            session.wait()
            session_mgr.close()
        stats = pool.stats()
    _print_server_summary(res, stats, args, max_batch)
    if session is not None:
        print(f"md session: {session.steps_done} steps in "
              f"{len(session.collected)} frames beside the replay, "
              f"{session.n_checkpoints} checkpoints "
              f"({session.checkpoint_dir}), artifact versions "
              f"{sorted({f.artifact_version for f in session.collected})}")
    print(f"routing: {stats['router']['routed_per_replica']} "
          f"(shed {stats['n_shed']}, requeued "
          f"{stats['router']['n_requeued']})")
    if args.tiers or args.guardrails or args.stall_timeout:
        g = stats["guardrails"]
        print(f"tiers: {stats['tiers']}  guardrails: flagged "
              f"{g['n_flagged']}, escalated {g['n_escalated']}, "
              f"quarantined {g['n_quarantined']}, stalls detected "
              f"{g['n_stalls_detected']}")
    if swap_report.get("error") is not None:
        raise SystemExit(
            f"hot swap FAILED: {swap_report['error']} (traffic was "
            "unaffected — surviving weights kept serving)")
    if swap_report:
        pauses = [f"{r['pause_s'] * 1e3:.2f}ms"
                  for r in swap_report["replicas"]]
        print(f"hot swap -> {swap_report['version_tag']}: per-replica "
              f"serve pauses {pauses} (warmed before swap; zero requests "
              "dropped)")
    return res


def _start_md_session(pool, engine: QuantizedEngine, args):
    """``--md-session N``: stream a checkpointed MD trajectory through the
    pool while the one-shot replay runs. Returns (session, manager); the
    caller waits and closes after the replay so both tenants share the
    replicas."""
    import tempfile

    import numpy as np

    from repro_torch.md.engine import MDConfig
    from repro_torch.sessions import SessionConfig, SessionManager

    n = max(args.min_atoms, (args.min_atoms + args.max_atoms) // 2)
    rng = np.random.default_rng(args.seed + 1)
    side = (n / (args.density or 0.1)) ** (1.0 / 3.0)
    species = rng.integers(0, engine.model_cfg.n_species,
                           n).astype(np.int32)
    coords = rng.uniform(0, side, size=(n, 3)).astype(np.float32)
    masses = np.full(n, 12.0, np.float32)
    record = min(50, args.md_session)
    chunk = 2 * record if 2 * record <= args.md_session else record
    # the engine's MDDQ kernel carries over, so a chunk runs the kernels
    # a flush runs
    scfg = SessionConfig(
        n_steps=args.md_session, chunk_steps=chunk, record_every=record,
        checkpoint_every=3,
        md=MDConfig(mode=engine.serve.mode, record_every=record,
                    mddq_kernel=engine.serve.mddq_kernel))
    root = tempfile.mkdtemp(prefix="serve_md_session_")
    mgr = SessionManager(pool, root)
    session = mgr.start(species, coords, masses, config=scfg,
                        seed=args.seed)
    print(f"md session: {args.md_session} NVE steps ({n} atoms, "
          f"{scfg.n_chunks} chunks of {chunk}) streaming beside the "
          f"replay; checkpoints -> {session.checkpoint_dir}")
    return session, mgr


def _print_server_summary(res, stats, args, max_batch) -> None:
    s = res.summary()
    print(f"open loop: {args.requests} requests at {args.rate:.1f} req/s "
          f"offered ({args.min_atoms}-{args.max_atoms} atoms, "
          f"deadline {args.deadline_ms:.0f} ms, "
          f"micro-batch <= {max_batch})")
    print(f"latency: p50 {s['p50_ms']:.1f} ms  p95 {s['p95_ms']:.1f} ms  "
          f"p99 {s['p99_ms']:.1f} ms  max {s['max_ms']:.1f} ms")
    print(f"throughput: {s['throughput_rps']:.1f} req/s over "
          f"{s['span_s']:.1f}s span")
    print(f"batching: {stats['n_flushes']} flushes, mean batch "
          f"{stats['mean_batch']:.2f}, reasons {stats['flush_reasons']}, "
          f"max queue depth {stats['max_queue_depth']}")
    print(f"dispatch: {stats['engine_dispatch']}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="lm", choices=["lm", "so3"])
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "serve_w8a8", "serve_w4a8"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    # so3 options (the JAX launcher's)
    ap.add_argument("--mode", default=None, choices=["fp32", "w8a8", "w4a8"],
                    help="serving mode (default: w8a8, or the artifact's "
                         "own mode when --artifact is given)")
    ap.add_argument("--graphs", type=int, default=16)
    ap.add_argument("--min-atoms", type=int, default=6)
    ap.add_argument("--max-atoms", type=int, default=32)
    ap.add_argument("--buckets", type=int, nargs="+", default=None,
                    help="bucket ladder (default: 16 32 64, or the "
                         "artifact's own with --artifact)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="molecules per batch (default: 32, or the "
                         "artifact's own with --artifact)")
    ap.add_argument("--feat", type=int, default=32)
    ap.add_argument("--vec-feat", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--dir-bits", type=int, default=8)
    ap.add_argument("--path", default=None,
                    choices=["dense", "sparse", "auto"],
                    help="so3 execution path: dense O(n^2), or the sparse "
                         "O(E) edge list (sparse/auto; a batch that "
                         "overflows its edge capacity runs dense; default: "
                         "auto, or the artifact's own with --artifact)")
    ap.add_argument("--density", type=float, default=None,
                    help="atoms per cubic Angstrom for the random graphs "
                         "(None = dense cloud)")
    ap.add_argument("--lee", action="store_true",
                    help="also report the served model's LEE diagnostic")
    ap.add_argument("--server", action="store_true",
                    help="stream Poisson traffic through the micro-batching "
                         "scheduler and report latency percentiles")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered load in requests/s (--server)")
    ap.add_argument("--requests", type=int, default=200,
                    help="number of requests to stream (--server)")
    ap.add_argument("--deadline-ms", type=float, default=25.0,
                    help="micro-batching deadline (--server)")
    ap.add_argument("--sched-batch", type=int, default=8,
                    help="scheduler micro-batch flush size (--server)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: shed requests beyond this "
                         "many queued (--server)")
    ap.add_argument("--guardrails", action="store_true",
                    help="withhold non-finite energies/forces with a typed "
                         "error instead of delivering them")
    ap.add_argument("--artifact",
                    help="cold-start the engine from a packed quantized "
                         "artifact (.npz) instead of quantizing fp32")
    ap.add_argument("--save-artifact",
                    help="pack the engine's quantized weights to this .npz "
                         "and continue")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve --server traffic through a pool of this "
                         "many replicas (one card: all on cuda:0, one "
                         "stream each)")
    ap.add_argument("--tiers",
                    help="mixed-precision fleet, e.g. "
                         "w4a8:2,w8a8:1,fp32:1: flagged results re-run "
                         "one tier up (with --guardrails)")
    ap.add_argument("--swap-artifact",
                    help="rolling zero-downtime weight swap to this packed "
                         "artifact, fired halfway through the replay")
    ap.add_argument("--md-session", type=int, default=0,
                    help="stream a checkpointed MD session of this many "
                         "NVE steps through the pool beside the replay")
    ap.add_argument("--stall-timeout", type=float,
                    help="pool watchdog: quarantine a replica busy on one "
                         "unit of work longer than this (seconds)")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="export the metrics registry as Prometheus text "
                         "to this file, rewritten atomically every "
                         "--export-interval seconds")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="trace every request and session chunk and append "
                         "one JSON trace per line to this file (render "
                         "with scripts/trace_report.py)")
    ap.add_argument("--export-interval", type=float, default=5.0,
                    metavar="S",
                    help="metrics export period in seconds (--metrics-out)")
    ap.add_argument("--alerts-out", metavar="PATH",
                    help="arm the health plane: evaluate the stock SLO "
                         "catalogue (burn-rate windows) and the anomaly "
                         "detectors against the live registry and append "
                         "one JSON alert per line to this file (watch with "
                         "scripts/obs_top.py)")
    ap.add_argument("--health-interval", type=float, default=1.0,
                    metavar="S",
                    help="health-plane evaluation period in seconds "
                         "(--alerts-out)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs every kernel's "
                         "plain PyTorch version")
    return ap


def _setup_obs(args):
    """``--metrics-out`` / ``--trace-out`` / ``--alerts-out``: arm the
    metrics plane, the request tracer and the health plane (SLO burn-rate
    evaluation and anomaly detectors), as the JAX launcher does. Returns a
    cleanup callable that stops the health monitor (one final step),
    writes the final export and closes the sinks. Every health-plane
    thread is stdlib only: none touches the card."""
    if not (args.metrics_out or args.trace_out or args.alerts_out):
        return lambda: None
    from repro_torch.obs import (REGISTRY, TRACER, AlertBus, AnomalyMonitor,
                                 HealthMonitor, JsonlTraceSink,
                                 PeriodicExporter, SLOEvaluator,
                                 configure_tracing, default_detectors,
                                 default_slos)
    sink = exporter = monitor = alerts_file = None
    if args.trace_out:
        sink = JsonlTraceSink(args.trace_out)
        configure_tracing(enabled=True, sink=sink)
        print(f"tracing: per-request spans -> {args.trace_out} "
              "(render with scripts/trace_report.py)")
    if args.metrics_out:
        exporter = PeriodicExporter(
            args.metrics_out, interval_s=args.export_interval,
            tracer=TRACER if sink is not None else None,
            trace_sink=None).start()
        print(f"metrics: Prometheus text exposition -> "
              f"{args.metrics_out} every {args.export_interval:.0f}s")
    if args.alerts_out:
        REGISTRY.set_enabled(True)     # the evaluators read the registry
        bus = AlertBus(registry=REGISTRY)
        alerts_file = open(args.alerts_out, "a", encoding="utf-8")

        def on_alert(alert):
            alerts_file.write(json.dumps(alert.to_json()) + "\n")
            alerts_file.flush()
            print(f"ALERT[{alert.severity}] {alert.name}: "
                  f"{alert.message}")
        bus.subscribe(on_alert)
        evaluator = SLOEvaluator(default_slos(), registry=REGISTRY,
                                 bus=bus)
        anomaly = AnomalyMonitor(default_detectors(), registry=REGISTRY,
                                 bus=bus)
        monitor = HealthMonitor([evaluator, anomaly],
                                interval_s=args.health_interval).start()
        args._alert_bus = bus      # cluster path: pool.watch_alerts
        args._health = monitor
        print(f"health plane: {len(evaluator.slos)} SLOs + "
              f"{len(anomaly.detectors)} anomaly detectors every "
              f"{args.health_interval:.1f}s, alerts -> {args.alerts_out}")
    args._exporter = exporter

    def cleanup():
        if monitor is not None:
            monitor.stop()         # one final evaluation step
        if exporter is not None:
            exporter.stop()        # joins + writes one final export
        if alerts_file is not None:
            alerts_file.close()
        if sink is not None:
            configure_tracing(enabled=False)
            sink.close()
            print(f"tracing: {sink.n_written} trace(s) written to "
                  f"{args.trace_out}")
    return cleanup


def main(argv=None) -> argparse.Namespace:
    """Run the launcher. Returns the parsed flags with what the run left:
    ``_result`` (the ``--server`` replay's ``TrafficResult``, or the LM's
    ``DecodeRun``), on the cluster path ``_pool`` (the closed pool: its
    flush and warmup records) and ``_session`` (``--md-session``), and
    with the obs flags ``_exporter``, ``_health`` and ``_alert_bus`` (the
    stopped exporter and health monitor, the alert bus)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.workload == "lm" and not args.arch:
        ap.error("--workload lm requires --arch")
    cleanup_obs = _setup_obs(args)
    try:
        args._result = (run_so3(args) if args.workload == "so3"
                        else run_lm(args))
    finally:
        cleanup_obs()
    return args


if __name__ == "__main__":
    main()
