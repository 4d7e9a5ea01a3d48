"""Streaming MD sessions over the cluster: counterpart of
``repro/sessions/manager.py``. Chunked trajectories that survive replica
deaths, rolling weight swaps, and process restarts.

``repro_torch.md`` runs closed trajectories; ``repro_torch.cluster``
serves one-shot inference. This module bridges them into the
multi-tenant service the paper's "nanosecond-timescale MD" claim
needs: a :class:`SessionManager` slices a long NVE trajectory into
**chunks** — each one ``MDEngine.run`` call of ``chunk_steps`` steps —
and submits them through :meth:`ClusterPool.submit_chunk` as
:class:`~repro_torch.cluster.replica.ChunkHandle`\\ s, interleaved with
one-shot traffic under the existing admission/affinity policy. Completed
frames stream back through an iterator/callback API as each chunk
lands.

Why this survives faults:

* **state lives on the host between chunks.** Each chunk is a pure
  function of the session's host-side numpy state: copied onto the
  device of whichever replica runs it (on that replica's worker and
  stream), integrated, copied back. A chunk that dies with its replica
  (or is requeued by the pool's failover) is simply re-submitted from
  the same state — NVE integration has no per-step RNG (initial
  velocities are drawn with numpy from the seed at ``init_state``), so
  a retry repeats the same frame indices and never double-integrates.
  On the CPU (the plain path) the replay is bit for bit. On the card it
  is not: the force backward's ``index_add_`` sums with atomics in any
  order, two runs of one state differ by ~1e-7 of the largest |force|,
  and a chunk carries that on, so a replayed frame matches its first
  emission to a tolerance, not bit for bit.
* **checkpoints every K chunks.** Session state (``ReplicaState``
  including the skin neighbour list, species/mask/masses, the JAX
  package's init key leaf, step counter, artifact version) persists
  through :class:`~repro_torch.checkpoint.manager.CheckpointManager`, in
  the JAX package's tree and format (a checkpoint of either package
  resumes in the other) — atomic step
  dirs, per-array SHA-256. ``resume_all()`` scans the checkpoint root
  after a full process restart, takes each session's ``latest_step()``
  (digest verification makes a corrupted newest step fall back to the
  previous valid one), and replays the un-checkpointed tail.
* **typed retry-with-backoff.** A shed submission
  (:class:`SchedulerOverloaded`) backs off by the scheduler's
  ``retry_after_s`` hint; a failed chunk (:class:`ReplicaFailed`, a
  typed :class:`~repro_torch.server.scheduler.RequestTimeout` from the chunk
  deadline, or an engine error) retries on the survivors with
  exponential backoff under **full jitter** — waits are drawn uniformly
  from ``[0, backoff]`` per session, so many sessions shed by the same
  overload burst don't retry in lockstep and re-shed together. Budget
  exhausted or pool closed → the session fails loudly with its error,
  never silently stalls.
* **guardrail tier escalation.** A chunk the MD guardrails reject
  (:class:`~repro_torch.guardrails.GuardrailViolation`: non-finite energies,
  energy drift past ``MDConfig.drift_limit``) is re-submitted with
  ``min_tier`` one precision step above the mode that failed — the
  tiered pool routes it to a w8a8/fp32 escalation replica, and
  ``_md_engine_for`` integrates at *that* replica's precision. Bounded
  by ``SessionConfig.max_escalations``; past the ladder top the session
  fails with the violation (fp32 exploding is real physics, not
  quantization).

Delivery semantics: frames are **exactly-once within a process** (chunk
completion is monotonic on the session thread) and **at-least-once
across restarts** — frames after the last checkpoint are re-emitted on
resume with identical indices (and, on the CPU, identical payloads), so
consumers dedupe by ``Frame.index``. ``chunk_steps`` is the
latency/throughput knob: long chunks amortize dispatch + host
round-trips, short chunks bound how long a one-shot flush waits behind
MD work and how much is replayed after a fault.
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import re
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.cluster.pool import ClusterPool
from repro_torch.guardrails import GuardrailViolation, next_tier
from repro_torch.md.engine import (MDConfig, MDEngine, ReplicaState,
                                   pad_replicas)
from repro_torch.md.neighbor import NeighborList
from repro_torch.obs.metrics import REGISTRY
from repro_torch.server.scheduler import (RequestTimeout, SchedulerClosed,
                                          SchedulerOverloaded)
from repro_torch.serving.bucketing import assign_bucket

__all__ = ["Frame", "SessionConfig", "MDSession", "SessionManager"]

_ID_RE = re.compile(r"[^A-Za-z0-9_.-]")


def prng_key(seed: int) -> np.ndarray:
    """The value of ``jax.random.PRNGKey(seed)`` as uint32[2] (the
    default threefry key: the seed's high and low 32 bits), the
    ``rng_key`` leaf the JAX package writes into a session checkpoint.
    The port draws its velocities with numpy and only records the key."""
    return np.array([(seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0,
                     seed & 0xFFFFFFFF], np.uint32)


def _state_map(fn, state: ReplicaState) -> ReplicaState:
    """``fn`` applied to every array of a ReplicaState, its neighbour
    list's included."""
    return ReplicaState(*(NeighborList(*map(fn, x))
                          if isinstance(x, NeighborList) else fn(x)
                          for x in state))


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class Frame:
    """One streamed trajectory record (one ``record_every`` boundary).
    ``index`` is the global record index — the dedupe key across
    restarts; ``step`` the MD step it samples. Per-replica arrays are
    shape ``(B,)`` for the session's replica batch."""
    session_id: str
    index: int
    step: int
    e_pot: np.ndarray
    e_tot: np.ndarray
    temperature_K: np.ndarray
    replica_id: int            # pool replica that integrated the chunk
    artifact_version: str      # weights the chunk ran under


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Session knobs. ``chunk_steps`` must be a multiple of
    ``record_every`` so global frame indices stay chunk-aligned (the
    last chunk may be shorter; its tail record covers the remainder)."""
    n_steps: int = 1000
    chunk_steps: int = 100          # MD steps per cluster chunk
    record_every: int = 50          # steps between streamed frames
    checkpoint_every: int = 4       # chunks between checkpoints (K)
    temperature_K: float = 300.0
    md: MDConfig = MDConfig()
    n_replicas: int = 1             # MD replica batch B (not pool replicas)
    max_retries: int = 12           # per-chunk retry budget (faults+sheds)
    backoff_s: float = 0.05         # initial retry backoff
    backoff_max_s: float = 2.0
    # per-chunk wall deadline: handle.result raises a typed
    # RequestTimeout past this, counting against the retry budget
    result_timeout_s: float = 600.0
    # precision-tier re-runs a guardrail-rejected chunk may receive
    # (GuardrailViolation from the MD engine -> re-submit with min_tier
    # one step up the ladder) before the session fails with it
    max_escalations: int = 1



    def __post_init__(self):
        if self.n_steps < 1 or self.chunk_steps < 1:
            raise ValueError("n_steps and chunk_steps must be >= 1")
        if self.record_every < 1:
            raise ValueError("record_every must be >= 1")
        if self.chunk_steps % self.record_every != 0:
            raise ValueError(
                f"chunk_steps {self.chunk_steps} must be a multiple of "
                f"record_every {self.record_every} (frame indices are "
                "chunk-aligned)")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")

    @property
    def n_chunks(self) -> int:
        return math.ceil(self.n_steps / self.chunk_steps)

    @property
    def frames_per_chunk(self) -> int:
        return self.chunk_steps // self.record_every

    def chunk_len(self, chunk_idx: int) -> int:
        done = chunk_idx * self.chunk_steps
        return min(self.chunk_steps, self.n_steps - done)


_SENTINEL = object()


class MDSession:
    """One long-running trajectory: host-side state + frame stream +
    telemetry. Created by :meth:`SessionManager.start` /
    :meth:`SessionManager.resume_all`; driven by a manager thread."""

    def __init__(self, session_id: str, config: SessionConfig,
                 species: np.ndarray, mask: np.ndarray,
                 masses: np.ndarray, init_coords: np.ndarray,
                 bucket_capacity: int, seed: int, checkpoint_dir: str,
                 on_frame: Optional[Callable[[Frame], None]] = None,
                 retain_frames: bool = True,
                 state=None, chunks_done: int = 0, steps_done: int = 0):
        self.session_id = session_id
        self.config = config
        self.species = np.asarray(species, np.int32)
        self.mask = np.asarray(mask, bool)
        self.masses = np.asarray(masses, np.float32)
        self.init_coords = np.asarray(init_coords, np.float32)
        self.bucket_capacity = bucket_capacity
        self.seed = seed
        self.checkpoint_dir = checkpoint_dir
        self.on_frame = on_frame
        self.retain_frames = retain_frames
        self.state = state                  # ReplicaState of numpy arrays
        self.chunks_done = chunks_done
        self.steps_done = steps_done
        self.status = "pending"             # running | done | failed | cancelled
        self.error: Optional[BaseException] = None
        self.preferred_replica: Optional[int] = None
        self.last_artifact_version = ""
        self.artifact_versions: List[str] = []   # distinct versions seen
        self.collected: List[Frame] = []    # retained frames (tests/bench)
        self.n_retries = 0
        self.n_escalations = 0              # guardrail tier escalations
        self.n_checkpoints = 0
        self.n_restores = 0
        self.frames_emitted = 0
        # full-jitter retry RNG: deterministic per session, distinct
        # across sessions so a shared overload burst doesn't make every
        # session retry (and re-shed) in lockstep
        self._rng = np.random.default_rng(
            [seed & 0x7FFFFFFF] + [ord(c) for c in session_id[:24]])
        self._frame_q: "queue.Queue" = queue.Queue()
        self._cancel = threading.Event()
        self._done = threading.Event()
        self._lock = threading.Lock()

    # -- client side --------------------------------------------------------

    def frames(self) -> Iterator[Frame]:
        """Stream frames as chunks complete; ends when the session does
        (single consumer — use ``on_frame`` to fan out)."""
        while True:
            f = self._frame_q.get()
            if f is _SENTINEL:
                return
            yield f

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the session finishes; returns the final status.
        Raises the session's error if it failed."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"session {self.session_id} not finished in {timeout}s")
        if self.status == "failed" and self.error is not None:
            raise self.error
        return self.status

    def cancel(self) -> None:
        """Stop at the next chunk boundary (state already checkpointed
        chunks stay on disk — a later ``resume_all`` picks it back up)."""
        self._cancel.set()

    def done(self) -> bool:
        return self._done.is_set()

    # -- session side --------------------------------------------------------

    def _deliver(self, frame: Frame) -> None:
        with self._lock:
            self.frames_emitted += 1
            if self.retain_frames:
                self.collected.append(frame)
        REGISTRY.counter("session_frames_total", event="emitted").inc()
        if self.on_frame is not None:
            self.on_frame(frame)
        self._frame_q.put(frame)

    def _finish(self, status: str, error: Optional[BaseException] = None):
        with self._lock:
            self.status = status
            self.error = error
        self._frame_q.put(_SENTINEL)
        self._done.set()

    def telemetry(self) -> Dict[str, object]:
        with self._lock:
            return {
                "session_id": self.session_id, "status": self.status,
                "chunks_done": self.chunks_done,
                "n_chunks": self.config.n_chunks,
                "steps_done": self.steps_done,
                "frames_emitted": self.frames_emitted,
                "n_retries": self.n_retries,
                "n_escalations": self.n_escalations,
                "n_checkpoints": self.n_checkpoints,
                "n_restores": self.n_restores,
                "artifact_versions": list(self.artifact_versions),
            }


class SessionManager:
    """Runs streaming MD sessions through a :class:`ClusterPool`.

    One thread per session submits chunks (sticky to the replica
    that ran the last one, falling back to JSQ), streams frames,
    checkpoints every ``checkpoint_every`` chunks, and retries through
    sheds and replica deaths. Attach a
    :class:`~repro_torch.sessions.faults.FaultInjector` to fire a seeded
    chaos schedule at chunk boundaries. The manager registers its
    telemetry as the ``sessions`` section of ``pool.stats()``.
    """

    def __init__(self, pool: ClusterPool, checkpoint_root: str,
                 faults=None, keep: int = 3):
        self.pool = pool
        self.root = checkpoint_root
        self.faults = faults
        self.keep = keep
        os.makedirs(checkpoint_root, exist_ok=True)
        self._sessions: Dict[str, MDSession] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._md_cache = weakref.WeakKeyDictionary()  # engine -> {md: MDEngine}
        self._md_lock = threading.Lock()
        self._n_seq = 0
        self._chunks_completed = 0
        self._chunks_retried = 0
        self._shed_retries = 0
        self._chunk_timeouts = 0        # typed RequestTimeout on result()
        self._chunk_escalations = 0     # guardrail tier re-runs
        self._checkpoints_written = 0
        self._checkpoints_restored = 0
        pool.attach_stats_source("sessions", self.stats)

    # -- lifecycle ----------------------------------------------------------

    def start(self, species: np.ndarray, coords: np.ndarray,
              masses: np.ndarray, config: SessionConfig = SessionConfig(),
              session_id: Optional[str] = None, seed: int = 0,
              on_frame: Optional[Callable[[Frame], None]] = None,
              retain_frames: bool = True) -> MDSession:
        """Open a session for one molecule: ``species (n,)``,
        ``coords (n, 3)``, ``masses (n,)``. The molecule is padded to
        its serving bucket (chunks share the shape class — and so the
        batch-affinity routing state — with same-size one-shot traffic)
        and tiled to ``config.n_replicas`` MD replicas with
        Maxwell-Boltzmann velocities drawn from ``seed`` on the first
        chunk."""
        n = int(np.asarray(species).shape[0])
        bucket = assign_bucket(n, self.pool.serve.buckets())
        sp, co, mask = pad_replicas(np.asarray(species), np.asarray(coords),
                                    config.n_replicas,
                                    capacity=bucket.capacity)
        m = np.ones((bucket.capacity,), np.float32)
        m[:n] = np.asarray(masses, np.float32)
        m = np.broadcast_to(m, mask.shape).copy()
        with self._lock:
            self._n_seq += 1
            if session_id is None:
                session_id = f"sess{self._n_seq:04d}-n{n}-s{seed}"
        session_id = _ID_RE.sub("_", session_id)
        session = MDSession(
            session_id, config, sp, mask, m, co, bucket.capacity, seed,
            os.path.join(self.root, session_id), on_frame=on_frame,
            retain_frames=retain_frames)
        self._launch(session)
        return session

    def resume_all(self, on_frame: Optional[Callable[[Frame], None]] = None,
                   retain_frames: bool = True) -> List[MDSession]:
        """Scan the checkpoint root and resume every session that has a
        valid checkpoint (``latest_step()`` skips corrupted steps via
        digest verification) and is not already live in this manager.
        The un-checkpointed tail replays deterministically; frames from
        replayed chunks are re-emitted with their original indices
        (at-least-once delivery across restarts). Sessions whose
        checkpoints say they finished are returned as ``done`` without
        a session thread."""
        out = []
        for name in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, name)
            with self._lock:
                live = name in self._sessions
            if not os.path.isdir(d) or live:
                continue
            cm = CheckpointManager(d, keep=self.keep)
            step = cm.latest_step()
            if step is None:
                continue        # nothing restorable (no valid step yet)
            session = self._rebuild(name, cm, step, on_frame, retain_frames)
            with self._lock:
                self._checkpoints_restored += 1
            REGISTRY.counter("session_events_total",
                             event="checkpoint_restored").inc()
            session.n_restores += 1
            if session.chunks_done >= session.config.n_chunks:
                with self._lock:
                    self._sessions[session.session_id] = session
                session._finish("done")
            else:
                self._launch(session)
            out.append(session)
        return out

    def _rebuild(self, name: str, cm: CheckpointManager, step: int,
                 on_frame, retain_frames) -> MDSession:
        arrays = cm.restore_arrays(step)
        extra = cm.extra(step)
        cfg_d = dict(extra["config"])
        cfg_d["md"] = MDConfig(**cfg_d["md"])
        config = SessionConfig(**cfg_d)
        nlist = NeighborList(
            senders=arrays["nl/senders"], receivers=arrays["nl/receivers"],
            edge_mask=arrays["nl/edge_mask"],
            ref_coords=arrays["nl/ref_coords"],
            overflow=arrays["nl/overflow"],
            n_rebuilds=arrays["nl/n_rebuilds"])
        state = ReplicaState(
            coords=arrays["coords"], veloc=arrays["veloc"],
            forces=arrays["forces"], e_pot=arrays["e_pot"],
            nlist=nlist, missed=arrays["missed"])
        session = MDSession(
            name, config, arrays["species"], arrays["mask"],
            arrays["masses"], arrays["init_coords"],
            int(extra["bucket_capacity"]), int(extra["seed"]),
            os.path.join(self.root, name), on_frame=on_frame,
            retain_frames=retain_frames, state=state,
            chunks_done=int(extra["chunks_done"]),
            steps_done=int(extra["steps_done"]))
        session.last_artifact_version = extra.get("artifact_version", "")
        return session

    def _launch(self, session: MDSession) -> None:
        with self._lock:
            self._sessions[session.session_id] = session
            t = threading.Thread(target=self._drive, args=(session,),
                                 name=f"md-session-{session.session_id}",
                                 daemon=True)
            self._threads[session.session_id] = t
        session.status = "running"
        t.start()

    def close(self, cancel: bool = False,
              timeout: Optional[float] = None) -> None:
        """Join every session thread; with ``cancel`` sessions stop at
        their next chunk boundary first (checkpointed progress survives
        for a later ``resume_all``)."""
        with self._lock:
            sessions = list(self._sessions.values())
            threads = list(self._threads.values())
        if cancel:
            for s in sessions:
                s.cancel()
        for t in threads:
            t.join(timeout)

    # -- driving ------------------------------------------------------------

    def _drive(self, session: MDSession) -> None:
        cfg = session.config
        try:
            while (session.chunks_done < cfg.n_chunks
                   and not session._cancel.is_set()):
                if self.faults is not None:
                    self.faults.fire(session, session.chunks_done)
                if session._cancel.is_set():
                    break
                self._run_chunk(session)
            if session._cancel.is_set() \
                    and session.chunks_done < cfg.n_chunks:
                session._finish("cancelled")
            else:
                session._finish("done")
        except BaseException as e:
            # frame-loss SLO feed: frames the trajectory promised but
            # will never stream (ceil covers a ragged final chunk)
            expected = math.ceil(cfg.n_steps / cfg.record_every)
            lost = max(0, expected - session.frames_emitted)
            if lost:
                REGISTRY.counter("session_frames_total",
                                 event="lost").inc(lost)
            session._finish("failed", e)

    def _run_chunk(self, session: MDSession) -> None:
        cfg = session.config
        ci = session.chunks_done
        length = cfg.chunk_len(ci)
        fn = self._make_chunk_fn(session, length)
        backoff = cfg.backoff_s
        attempt = 0
        min_tier: Optional[str] = None   # guardrail escalation target
        esc_used = 0
        while True:
            if session._cancel.is_set():
                return
            try:
                handle = self.pool.submit_chunk(
                    fn, session.bucket_capacity,
                    preferred_replica=session.preferred_replica,
                    session_id=session.session_id, chunk_idx=ci,
                    min_tier=min_tier)
            except SchedulerOverloaded as e:
                # typed retry-with-backoff on shed: the scheduler tells
                # us roughly when one batch will have drained; full
                # jitter (uniform over [0, wait]) decorrelates sessions
                # shed by the same burst
                attempt += 1
                with self._lock:
                    self._shed_retries += 1
                REGISTRY.counter("session_events_total",
                                 event="shed_retry").inc()
                if attempt > cfg.max_retries:
                    raise
                session._cancel.wait(session._rng.uniform(0.0, min(
                    max(e.retry_after_s, backoff), cfg.backoff_max_s)))
                backoff = min(backoff * 2, cfg.backoff_max_s)
                continue
            try:
                new_state, records, art = handle.result(
                    timeout_s=cfg.result_timeout_s)
            except GuardrailViolation as e:
                # the chunk's physics failed its guardrails (non-finite
                # energies, drift past the limit): state is untouched —
                # re-submit the same pure chunk one precision tier above
                # the mode that produced the violation
                try:
                    target = next_tier(e.detail.get("mode", cfg.md.mode))
                except ValueError:
                    target = None
                if target is None or esc_used >= cfg.max_escalations:
                    raise      # top of the ladder / budget spent: real
                esc_used += 1  # physics or broken weights, fail loudly
                session.n_escalations += 1
                with self._lock:
                    self._chunk_escalations += 1
                REGISTRY.counter("session_events_total",
                                 event="chunk_escalated").inc()
                min_tier = target
                session.preferred_replica = None
                continue
            except BaseException as e:
                # replica died mid-chunk, the per-chunk deadline fired
                # (typed RequestTimeout), or the requeue budget ran out:
                # state is untouched on the host — re-submit the same
                # pure chunk, dropping stickiness so JSQ picks a survivor
                attempt += 1
                session.n_retries += 1
                with self._lock:
                    self._chunks_retried += 1
                    if isinstance(e, RequestTimeout):
                        self._chunk_timeouts += 1
                REGISTRY.counter("session_events_total",
                                 event="chunk_retried").inc()
                if attempt > cfg.max_retries:
                    raise
                session.preferred_replica = None
                session._cancel.wait(session._rng.uniform(0.0, backoff))
                backoff = min(backoff * 2, cfg.backoff_max_s)
                continue
            break
        session.state = new_state
        session.steps_done += length
        session.chunks_done = ci + 1
        session.preferred_replica = handle.replica_id
        session.last_artifact_version = art
        if art not in session.artifact_versions:
            session.artifact_versions.append(art)
        with self._lock:
            self._chunks_completed += 1
        REGISTRY.counter("session_events_total",
                         event="chunk_completed").inc()
        self._emit(session, ci, length, records,
                   handle.replica_id if handle.replica_id is not None else -1,
                   art)
        if (session.chunks_done % cfg.checkpoint_every == 0
                or session.chunks_done >= cfg.n_chunks):
            self._checkpoint(session)

    def _make_chunk_fn(self, session: MDSession, length: int):
        """One chunk as a pure closure over the session's current host
        state: the replica's worker runs it on its own stream; everything
        is copied onto the *executing* replica's device (its engine's
        weights live there), integrated, copied back to the host."""
        cfg = session.config
        state = session.state
        species, mask = session.species, session.mask
        masses, init_coords = session.masses, session.init_coords
        seed, temperature = session.seed, cfg.temperature_K

        def fn(engine):
            md_eng = self._md_engine_for(engine, cfg.md)
            sp, mk, ms = md_eng.device_inputs(species, mask, masses)
            if state is None:
                # Maxwell-Boltzmann velocities drawn with numpy from the
                # seed (the JAX package draws from PRNGKey(seed))
                st = md_eng.init_state(seed, sp, init_coords, mk, ms,
                                       temperature_K=temperature)
            else:
                dev = engine.device
                st = _state_map(
                    lambda a: torch.from_numpy(np.array(a)).to(dev), state)
            new_state, records = md_eng.run(
                st, sp, mk, ms, n_steps=length,
                record_every=cfg.record_every)
            return (_state_map(_to_host, new_state), records,
                    engine.artifact_version)

        return fn

    def _md_engine_for(self, engine, md: MDConfig) -> MDEngine:
        """Per-(serving engine, MDConfig) cache of the ``MDEngine`` that
        shares the serving engine's weights and codebook, so a chunk
        builds none. Weak keys let swapped-out engines go."""
        # integrate at the precision of whichever replica executes the
        # chunk: on a tiered pool an escalated chunk lands on a w8a8 or
        # fp32 replica and must run *that* engine's mode, not the
        # session's nominal one (the GuardrailViolation it raises then
        # carries the actual mode for the next escalation decision)
        md = dataclasses.replace(md, mode=engine.serve.mode)
        with self._md_lock:
            per = self._md_cache.get(engine)
            if per is None:
                per = {}
                self._md_cache[engine] = per
            md_eng = per.get(md)
            if md_eng is None:
                md_eng = engine.md_engine(md=md)
                per[md] = md_eng
            return md_eng

    # -- frames + checkpoints ------------------------------------------------

    def _emit(self, session: MDSession, chunk_idx: int, length: int,
              records: Dict[str, np.ndarray], replica_id: int,
              artifact_version: str) -> None:
        cfg = session.config
        n_rec = records["e_pot"].shape[0] if "e_pot" in records else 0
        base = chunk_idx * cfg.frames_per_chunk
        s0 = chunk_idx * cfg.chunk_steps
        for i in range(n_rec):
            session._deliver(Frame(
                session_id=session.session_id, index=base + i,
                step=s0 + min((i + 1) * cfg.record_every, length),
                e_pot=np.asarray(records["e_pot"][i]),
                e_tot=np.asarray(records["e_tot"][i]),
                temperature_K=np.asarray(records["temperature_K"][i]),
                replica_id=replica_id, artifact_version=artifact_version))

    def _checkpoint(self, session: MDSession) -> None:
        st = session.state
        cfg = session.config
        tree = {
            "coords": st.coords, "veloc": st.veloc, "forces": st.forces,
            "e_pot": st.e_pot, "missed": st.missed,
            "nl": {"senders": st.nlist.senders,
                   "receivers": st.nlist.receivers,
                   "edge_mask": st.nlist.edge_mask,
                   "ref_coords": st.nlist.ref_coords,
                   "overflow": st.nlist.overflow,
                   "n_rebuilds": st.nlist.n_rebuilds},
            "species": session.species, "mask": session.mask,
            "masses": session.masses, "init_coords": session.init_coords,
            "rng_key": prng_key(session.seed),
        }
        extra = {
            "session_id": session.session_id,
            "chunks_done": session.chunks_done,
            "steps_done": session.steps_done,
            "bucket_capacity": session.bucket_capacity,
            "seed": session.seed,
            "artifact_version": session.last_artifact_version,
            "config": dataclasses.asdict(cfg),
        }
        cm = CheckpointManager(session.checkpoint_dir, keep=self.keep)
        t0 = time.monotonic()
        cm.save(session.chunks_done, tree, extra=extra)
        session.n_checkpoints += 1
        with self._lock:
            self._checkpoints_written += 1
        REGISTRY.counter("session_events_total",
                         event="checkpoint_written").inc()
        REGISTRY.histogram("session_checkpoint_seconds").observe(
            time.monotonic() - t0)

    # -- telemetry ----------------------------------------------------------

    def sessions(self) -> List[MDSession]:
        with self._lock:
            return list(self._sessions.values())

    def stats(self) -> Dict[str, object]:
        """The ``sessions`` section of ``pool.stats()``: per-status
        counts, chunk/checkpoint/retry counters, per-session telemetry,
        and the fault injector's counts when one is attached."""
        with self._lock:
            sessions = list(self._sessions.values())
            out: Dict[str, object] = {
                "active": sum(1 for s in sessions if s.status == "running"),
                "done": sum(1 for s in sessions if s.status == "done"),
                "failed": sum(1 for s in sessions if s.status == "failed"),
                "cancelled": sum(1 for s in sessions
                                 if s.status == "cancelled"),
                "chunks_completed": self._chunks_completed,
                "chunks_retried": self._chunks_retried,
                "shed_retries": self._shed_retries,
                "chunk_timeouts": self._chunk_timeouts,
                "chunk_escalations": self._chunk_escalations,
                "checkpoints_written": self._checkpoints_written,
                "checkpoints_restored": self._checkpoints_restored,
            }
        out["frames_emitted"] = sum(s.frames_emitted for s in sessions)
        out["per_session"] = [s.telemetry() for s in sessions]
        if self.faults is not None:
            out["faults_injected"] = self.faults.counts()
        return out
