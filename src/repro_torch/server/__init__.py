"""The online serving layer over ``repro_torch.serving``: counterpart of
``repro.server``.

Requests arriving one at a time over the wall clock, latency deadlines,
batch formation under load, and a packed on-disk artifact so a cold
start never touches fp32 weights:

* :class:`MicroBatchScheduler` / :class:`SchedulerConfig` — dynamic
  micro-batching over the engine's bucket ladder: per-shape-class
  admission queues flushed on ``max_batch`` or a ``deadline_ms``
  deadline, request->result identity under out-of-order flushes
  (``scheduler.py``); one worker thread issues every kernel launch;
* :func:`save_artifact` / :func:`load_artifact` / :func:`load_engine` —
  the JAX package's versioned single-``.npz`` packed-weight artifacts
  (a file written by either package loads in the other), with
  checksum/version validation and a bit-exact reload (``artifact.py``);
* :func:`make_traffic` / :func:`run_open_loop` / :func:`run_closed_loop`
  — seeded Poisson traffic over mixed molecule sizes and the drivers
  that replay it (``traffic.py``);
* :func:`latency_summary` / :func:`flush_summary` — p50/p95/p99,
  throughput, queue-depth/occupancy accounting (``stats.py``).
"""
from repro_torch.server.artifact import (ARTIFACT_MAGIC, ARTIFACT_VERSION,
                                         ArtifactError, LoadedArtifact,
                                         ensure_mode_matches, load_artifact,
                                         load_engine, save_artifact)
from repro_torch.server.scheduler import (BatchQueue, MicroBatchScheduler,
                                          RequestHandle, RequestTimeout,
                                          SchedulerClosed, SchedulerConfig,
                                          SchedulerOverloaded)
from repro_torch.server.stats import (FlushRecord, flush_summary,
                                      latency_summary)
from repro_torch.server.traffic import (RateStage, SizeClass, TrafficConfig,
                                        TrafficResult, calibrate_service_time,
                                        draw_graphs, make_step_traffic,
                                        make_traffic, run_closed_loop,
                                        run_open_loop, stage_summaries)

__all__ = [
    "ARTIFACT_MAGIC", "ARTIFACT_VERSION", "ArtifactError", "LoadedArtifact",
    "ensure_mode_matches", "load_artifact", "load_engine", "save_artifact",
    "BatchQueue", "MicroBatchScheduler", "RequestHandle", "RequestTimeout",
    "SchedulerClosed", "SchedulerConfig", "SchedulerOverloaded",
    "FlushRecord", "flush_summary", "latency_summary",
    "RateStage", "SizeClass", "TrafficConfig", "TrafficResult",
    "calibrate_service_time", "draw_graphs", "make_step_traffic",
    "make_traffic", "run_closed_loop", "run_open_loop", "stage_summaries",
]
