"""Open/closed-loop traffic generation and replay for the online server:
counterpart of ``repro/server/traffic.py`` (numpy and threads only).

Traffic model: **Poisson arrivals** (exponential inter-arrival gaps at a
configured rate) over a **mixed molecule-size distribution** — weighted
size classes, each a uniform ``[min_atoms, max_atoms]`` range — so a run
exercises several buckets of the ladder at once, exactly the regime
dynamic micro-batching exists for. Generation is pure and seeded: the
same ``TrafficConfig`` yields the identical request sequence for every
serving strategy under comparison, and the same arrivals and molecules
as the JAX package (the port's ``random_graph`` is that package's
recipe).

Two arrival shapes:

* :func:`make_traffic` — constant-rate Poisson (the classic load point);
* :func:`make_step_traffic` — a **step ramp**: a piecewise-constant rate
  schedule (:class:`RateStage` list), still Poisson within each stage
  (exponential memorylessness makes restarting the clock at each stage
  boundary exact). This is how overload/recovery scenarios are scripted
  reproducibly — e.g. cruise below capacity, burst far above it, then
  recover.

Two drivers:

* :func:`run_open_loop` — arrivals fire on the wall clock regardless of
  completions (load *offered*, not admitted). Latency is measured from
  each request's **scheduled** arrival, so a driver lagging under
  overload cannot hide queueing delay (no coordinated omission). A
  target shedding load (``SchedulerOverloaded`` from bounded admission)
  is recorded per request, not treated as a failure.
* :func:`run_closed_loop` — ``concurrency`` clients each keep exactly
  one request in flight (submit, wait, repeat): the sustainable-
  throughput probe, load adapts to the server.

Both return a :class:`TrafficResult` carrying per-request latencies and
the scheduler's flush/queue telemetry, summarized via
``server.stats.latency_summary``; :func:`stage_summaries` splits
an open-loop result back into its ramp stages.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.bucketing import Graph, random_graph
from repro_torch.server.scheduler import SchedulerOverloaded
from repro_torch.server.stats import latency_summary

__all__ = ["SizeClass", "TrafficConfig", "TrafficResult", "RateStage",
           "make_traffic", "make_step_traffic", "stage_summaries",
           "run_open_loop", "run_closed_loop", "calibrate_service_time",
           "draw_graphs"]


@dataclasses.dataclass(frozen=True)
class SizeClass:
    """One component of the molecule-size mixture."""
    min_atoms: int
    max_atoms: int
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """A reproducible request stream."""
    rate_rps: float                     # offered load (open loop)
    n_requests: int
    size_mix: Tuple[SizeClass, ...] = (SizeClass(6, 16, 0.5),
                                       SizeClass(17, 32, 0.5))
    n_species: int = 20
    density: Optional[float] = 0.1      # atoms/A^3 (None = dense cloud)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RateStage:
    """One step of a piecewise-constant offered-load schedule."""
    rate_rps: float
    duration_s: float


def draw_graphs(rng: np.random.Generator, n: int,
                size_mix: Sequence[SizeClass], n_species: int,
                density: Optional[float]) -> List[Graph]:
    """n molecules from the weighted size mixture — the single recipe
    behind both arrival generators, so a constant-rate stream and a step
    ramp with the same seed draw from the same molecule distribution."""
    weights = np.asarray([c.weight for c in size_mix], np.float64)
    classes = rng.choice(len(size_mix), size=n, p=weights / weights.sum())
    out = []
    for ci in classes:
        c = size_mix[ci]
        n_atoms = int(rng.integers(c.min_atoms, c.max_atoms + 1))
        out.append(random_graph(rng, n_atoms, n_species, density))
    return out


def make_traffic(cfg: TrafficConfig) -> List[Tuple[float, Graph]]:
    """Seeded (arrival_time_s, Graph) list: Poisson arrivals at
    ``rate_rps`` starting at t=0, sizes drawn from the weighted mixture,
    molecules from the same ``random_graph`` recipe the serving benches
    use."""
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.rate_rps, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    graphs = draw_graphs(rng, cfg.n_requests, cfg.size_mix, cfg.n_species,
                         cfg.density)
    return [(float(t), g) for t, g in zip(arrivals, graphs)]


def make_step_traffic(stages: Sequence[RateStage],
                      size_mix: Tuple[SizeClass, ...] = TrafficConfig.size_mix,
                      n_species: int = 20,
                      density: Optional[float] = 0.1,
                      seed: int = 0) -> List[Tuple[float, Graph]]:
    """Seeded step-ramp arrivals: Poisson within each stage at that
    stage's rate. The request count is whatever the schedule produces
    (stochastic but fully determined by the seed), so identical replays
    across serving strategies — the way overload and recovery scenarios
    stay reproducible. Restarting the exponential clock at each stage
    boundary is exact (memorylessness), not an approximation."""
    if not stages:
        raise ValueError("need at least one RateStage")
    rng = np.random.default_rng(seed)
    arrivals: List[float] = []
    t_start = 0.0
    for st in stages:
        if st.rate_rps <= 0 or st.duration_s <= 0:
            raise ValueError("RateStage rate and duration must be > 0")
        t = t_start
        t_end = t_start + st.duration_s
        while True:
            t += rng.exponential(1.0 / st.rate_rps)
            if t >= t_end:
                break
            arrivals.append(t)
        t_start = t_end
    graphs = draw_graphs(rng, len(arrivals), size_mix, n_species, density)
    return list(zip(arrivals, graphs))


@dataclasses.dataclass(frozen=True)
class TrafficResult:
    """One driver run: per-request timings + scheduler telemetry."""
    latencies_s: np.ndarray       # per completed request, submission order
    span_s: float                 # first arrival -> last completion
    offered_rps: Optional[float]  # open loop: the configured rate
    submit_lag_p99_ms: float      # driver lateness (diagnostic, open loop)
    scheduler_stats: Dict[str, object]
    # scheduled arrival times of the completed requests (aligned with
    # latencies_s) and of the shed ones — lets stage_summaries() split a
    # ramp run back into its stages
    arrivals_s: Optional[np.ndarray] = None
    shed_arrivals_s: Optional[np.ndarray] = None

    @property
    def n_shed(self) -> int:
        return 0 if self.shed_arrivals_s is None else len(self.shed_arrivals_s)

    def summary(self) -> Dict[str, float]:
        out = latency_summary(self.latencies_s, self.span_s)
        out["n_shed"] = self.n_shed
        return out


def stage_summaries(result: TrafficResult,
                    stages: Sequence[RateStage]) -> List[Dict[str, float]]:
    """Per-stage latency/throughput summaries of an open-loop step-ramp
    replay: each completed request is attributed to the stage its
    *scheduled arrival* fell in (so queue carry-over into a recovery
    stage shows up as that stage's tail latency — exactly the overload
    signature the ramp exists to expose)."""
    if result.arrivals_s is None:
        raise ValueError("result carries no arrival times "
                         "(closed-loop results cannot be staged)")
    arr = np.asarray(result.arrivals_s)
    shed = (np.asarray(result.shed_arrivals_s)
            if result.shed_arrivals_s is not None else np.empty(0))
    out = []
    lo = 0.0
    for st in stages:
        hi = lo + st.duration_s
        sel = (arr >= lo) & (arr < hi)
        row: Dict[str, float] = {
            "rate_rps": st.rate_rps, "duration_s": st.duration_s,
            "n_offered": int(sel.sum()
                             + ((shed >= lo) & (shed < hi)).sum()),
            "n_shed": int(((shed >= lo) & (shed < hi)).sum()),
        }
        if sel.any():
            row.update(latency_summary(result.latencies_s[sel],
                                       span_s=st.duration_s))
        out.append(row)
        lo = hi
    return out


def calibrate_service_time(engine, buckets: Optional[Sequence[int]] = None,
                           repeats: int = 7, seed: int = 17) -> float:
    """Expected seconds for one single-molecule request under a mixed
    size distribution (the per-request server's unit of work): the mean
    over one representative molecule per bucket of the engine's ladder
    — calibrating on the small bucket alone would overstate sequential
    capacity and make every offered-load multiple secretly an overload."""
    import statistics
    rng = np.random.default_rng(seed)
    if buckets is None:
        buckets = engine.serve.bucket_sizes
    per_bucket = []
    for cap in buckets:
        n = max(6, (3 * cap) // 4)
        g = random_graph(rng, n, engine.model_cfg.n_species, density=0.1)
        engine.infer_batch([g])     # ensure warm
        times = []
        for _ in range(repeats):
            t0 = time.monotonic()
            engine.infer_batch([g])
            times.append(time.monotonic() - t0)
        per_bucket.append(statistics.median(times))
    return statistics.mean(per_bucket)


def run_open_loop(scheduler, traffic: Sequence[Tuple[float, Graph]],
                  rate_rps: Optional[float] = None,
                  result_timeout: Optional[float] = None) -> TrafficResult:
    """Replay ``traffic`` against the wall clock: each request is
    submitted at its scheduled arrival time (sleeping in between),
    completions are awaited afterwards. Latency for request i is
    ``t_complete_i - t_scheduled_arrival_i``. ``scheduler`` is anything
    with ``submit(graph) -> RequestHandle`` and ``stats()`` — the
    single-engine ``MicroBatchScheduler`` (or, in the JAX package, a
    cluster pool).
    Requests shed by bounded admission (``SchedulerOverloaded``) are
    counted, not raised: under deliberate overload shedding is the
    correct server behavior and the replay must keep offering load.
    ``result_timeout`` bounds each completion wait — pass one in
    harnesses whose whole point is proving no request is ever lost, so
    a leaked handle fails loudly (TimeoutError) instead of hanging the
    run."""
    handles: List[Tuple[float, object]] = []
    shed: List[float] = []
    lags = []
    t0 = time.monotonic()
    for t_arr, g in traffic:
        delay = t0 + t_arr - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        lags.append(time.monotonic() - (t0 + t_arr))
        try:
            handles.append((t_arr, scheduler.submit(g)))
        except SchedulerOverloaded:
            shed.append(t_arr)
    for _, h in handles:
        h.result(timeout=result_timeout)
    t_end = max((h.t_done for _, h in handles), default=t0)
    lat = np.asarray([h.t_done - (t0 + t_arr) for t_arr, h in handles])
    return TrafficResult(
        latencies_s=lat,
        span_s=t_end - (t0 + traffic[0][0]),
        offered_rps=rate_rps,
        submit_lag_p99_ms=float(np.percentile(lags, 99) * 1e3),
        scheduler_stats=scheduler.stats(),
        arrivals_s=np.asarray([t_arr for t_arr, _ in handles]),
        shed_arrivals_s=np.asarray(shed))


def run_closed_loop(scheduler, graphs: Sequence[Graph],
                    concurrency: int = 4) -> TrafficResult:
    """``concurrency`` synchronous clients round-robin the request list,
    each keeping one request in flight. Latency is submit -> completion.
    A client exception (shed from bounded admission, a failover error)
    is re-raised here after all clients stop — never swallowed into a
    dead thread that silently under-reports samples."""
    chunks = [list(graphs[i::concurrency]) for i in range(concurrency)]
    lat_chunks: List[List[float]] = [[] for _ in range(concurrency)]
    done_t = [0.0] * concurrency
    errors: List[BaseException] = []

    def client(ci: int):
        try:
            for g in chunks[ci]:
                h = scheduler.submit(g)
                h.result()
                lat_chunks[ci].append(h.latency_s)
        except BaseException as e:
            errors.append(e)
        finally:
            done_t[ci] = time.monotonic()

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    lat = np.asarray([x for c in lat_chunks for x in c])
    return TrafficResult(
        latencies_s=lat, span_s=max(done_t) - t0, offered_rps=None,
        submit_lag_p99_ms=0.0, scheduler_stats=scheduler.stats())
