"""Seeded fault-injection harness for streaming MD sessions: a copy of
``repro/sessions/faults.py`` (numpy only), so a seed draws the same
schedule in both packages.

Chaos testing only proves something when the faults are (a) the real
failure modes and (b) reproducible. This module schedules four of them,
from one seed, against a live
:class:`~repro_torch.cluster.pool.ClusterPool`
and a session's on-disk checkpoints:

* ``kill_replica`` — ``ClusterPool.kill_replica(mode="drain"|"in_flight")``:
  the replica dies with queued (and, in-flight mode, already-picked)
  work, exercising orphan requeue + the session's chunk retry;
* ``swap_artifact`` — a mid-trajectory rolling weight swap: the session
  must keep integrating across the artifact-version boundary (frames
  carry the version so the splice point is auditable);
* ``corrupt_checkpoint`` — flip one byte (``bitflip``) or cut the file
  in half (``truncate``) in the *newest* checkpoint step on disk: a
  later restore must detect it (per-array SHA-256 →
  :class:`~repro_torch.checkpoint.manager.CheckpointError`) and fall
  back to
  the previous valid step;
* ``stall`` — ``Replica.inject_stall``: the next flush/chunk holds the
  engine lock ``stall_s`` seconds — the slow-straggler mode that delays
  without killing.

Faults fire at **chunk boundaries** of the session that owns the
injector (the session thread calls :meth:`FaultInjector.fire` before
submitting each chunk), which makes a schedule a plain list of
``(kind, at_chunk)`` pairs — deterministic given the seed, independent
of wall clock. ``seeded_schedule`` draws one from ``numpy.random``.
"""
from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "seeded_schedule",
           "corrupt_checkpoint"]

KINDS = ("kill_replica", "swap_artifact", "corrupt_checkpoint", "stall")

_STEP_RE = re.compile(r"^step_(\d+)$")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``at_chunk`` is the session chunk index
    *before* which it fires (fault at the boundary, then the chunk runs
    into it)."""
    kind: str
    at_chunk: int
    # target pool replica; -1 = the replica that ran the session's last
    # chunk (the sticky one — guarantees the fault lands on the
    # session's own path rather than an idle bystander)
    replica_id: int = -1
    mode: str = "drain"             # kill_replica: "drain" | "in_flight"
    artifact_path: str = ""         # swap_artifact: packed artifact
    swap_warmup: bool = True        # swap_artifact: warm before exchange
    corruption: str = "bitflip"     # corrupt_checkpoint: | "truncate"
    stall_s: float = 0.2            # stall duration

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


def corrupt_checkpoint(checkpoint_dir: str, corruption: str = "bitflip",
                       seed: int = 0) -> Optional[str]:
    """Damage the newest ``step_N`` directory under ``checkpoint_dir``:
    flip one byte of one array file, or truncate it to half. Returns the
    damaged file's path (None when there is no checkpoint yet — a
    schedule may fire before the first save; the injector counts it as
    a no-op). The point is what happens *later*: ``latest_step()`` must
    skip the damaged step and restore must fall back."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = sorted(int(m.group(1)) for m in
                   (_STEP_RE.match(n) for n in os.listdir(checkpoint_dir))
                   if m)
    if not steps:
        return None
    d = os.path.join(checkpoint_dir, f"step_{steps[-1]}")
    npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not npys:
        return None
    rng = np.random.default_rng(seed)
    target = os.path.join(d, npys[int(rng.integers(len(npys)))])
    size = os.path.getsize(target)
    if corruption == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif corruption == "bitflip":
        off = int(rng.integers(size))
        with open(target, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x40]))
    else:
        raise ValueError(f"unknown corruption {corruption!r}")
    return target


def seeded_schedule(seed: int, n_chunks: int, n_replicas: int,
                    kinds: Sequence[str] = KINDS,
                    n_faults: int = 4) -> List[FaultSpec]:
    """Draw a reproducible fault schedule: ``n_faults`` faults at
    distinct chunk boundaries in ``[1, n_chunks)`` (never before chunk 0
    — a session must exist to be hurt), one of each requested kind
    first, then repeats. The same ``(seed, n_chunks, n_replicas)``
    always yields the same schedule — the property the chaos bench's
    regression gate rests on."""
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f"unknown fault kind {k!r}")
    rng = np.random.default_rng(seed)
    hi = max(n_chunks, 2)
    boundaries = rng.choice(np.arange(1, hi), size=min(n_faults, hi - 1),
                            replace=False)
    specs = []
    for i, at in enumerate(sorted(int(b) for b in boundaries)):
        kind = kinds[i % len(kinds)]
        specs.append(FaultSpec(
            kind=kind, at_chunk=at,
            replica_id=int(rng.integers(n_replicas)),
            mode=("in_flight" if rng.integers(2) else "drain"),
            corruption=("truncate" if rng.integers(2) else "bitflip"),
            stall_s=float(0.05 + 0.2 * rng.random())))
    return specs


class FaultInjector:
    """Applies a :class:`FaultSpec` schedule to a live pool + session.

    The owning session's thread calls :meth:`fire` at every chunk
    boundary; each spec fires exactly once (the first boundary at or
    past its ``at_chunk`` — a resume that skips boundaries replays from
    an earlier chunk, so late firing keeps the schedule meaningful
    rather than silently dropping faults). ``counts()`` reports
    injected faults by kind for ``ClusterPool.stats()`` and the bench.
    """

    def __init__(self, schedule: Sequence[FaultSpec], pool,
                 seed: int = 0):
        self.schedule = list(schedule)
        self.pool = pool
        self.seed = seed
        self._fired = [False] * len(self.schedule)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in KINDS}
        self._noop = 0

    def fire(self, session, chunk_idx: int) -> List[FaultSpec]:
        """Apply every not-yet-fired spec with ``at_chunk <= chunk_idx``.
        Returns the specs applied (tests assert on this)."""
        todo = []
        with self._lock:
            for i, spec in enumerate(self.schedule):
                if not self._fired[i] and spec.at_chunk <= chunk_idx:
                    self._fired[i] = True
                    todo.append(spec)
        applied = []
        for spec in todo:
            if self._apply(spec, session):
                with self._lock:
                    self._counts[spec.kind] += 1
                applied.append(spec)
            else:
                with self._lock:
                    self._noop += 1
        return applied

    def _target(self, spec: FaultSpec, session, live):
        rid = spec.replica_id
        if rid < 0:
            rid = getattr(session, "preferred_replica", None)
            if rid is None:
                rid = live[0].replica_id
        return next((r for r in live if r.replica_id == rid), live[0])

    def _apply(self, spec: FaultSpec, session) -> bool:
        if spec.kind == "kill_replica":
            live = [r for r in self.pool._replicas if r.accepting]
            if len(live) <= 1:
                return False     # never kill the last replica: that is
            #                      an outage, not a fault drill
            target = self._target(spec, session, live)
            self.pool.kill_replica(target.replica_id, mode=spec.mode)
            return True
        if spec.kind == "swap_artifact":
            self.pool.swap_artifact(spec.artifact_path,
                                    warmup=spec.swap_warmup)
            return True
        if spec.kind == "corrupt_checkpoint":
            return corrupt_checkpoint(
                session.checkpoint_dir, spec.corruption,
                seed=self.seed) is not None
        if spec.kind == "stall":
            live = [r for r in self.pool._replicas if r.accepting]
            if not live:
                return False
            self._target(spec, session, live).inject_stall(spec.stall_s)
            return True
        raise AssertionError(spec.kind)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._counts)
            out["noop"] = self._noop
            out["total"] = sum(self._counts.values())
        return out
