"""Runtime result detectors: counterpart of ``repro/guardrails/detectors.py``.

A copy of the JAX package's numpy detectors (the port imports nothing of
that package): ``check_result`` flags non-finite energies or forces
(fatal) and force norms above a calibrated per-bucket envelope (suspect).
``QuantizedEngine.infer_batch`` runs the non-finite check by default;
``md.MDEngine`` runs ``check_finite_tree`` at its record checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Flag", "ForceEnvelope", "GuardrailConfig", "GuardrailViolation",
           "check_result", "check_finite_tree"]

FATAL = "fatal"
SUSPECT = "suspect"


class GuardrailViolation(RuntimeError):
    """A guardrail refused to deliver a result. Typed so callers (and
    the session manager's tier-escalation retry) can tell physics
    failures from infrastructure failures.

    ``reason`` is the detector that fired (``"nonfinite"``,
    ``"force_outlier"``, ``"lee"``, ``"energy_drift"``), ``severity``
    is ``"fatal"`` or ``"suspect"``, and ``detail`` carries
    detector-specific context (measured value, limit, serving mode).
    """

    def __init__(self, msg: str, reason: str = "", severity: str = FATAL,
                 detail: Optional[Dict] = None):
        super().__init__(msg)
        self.reason = reason
        self.severity = severity
        self.detail = dict(detail or {})


@dataclasses.dataclass(frozen=True)
class Flag:
    """One detector firing on one molecule. ``value``/``limit`` are the
    measured quantity and the threshold it crossed (0 for nonfinite —
    there is no meaningful magnitude)."""
    reason: str                 # "nonfinite" | "force_outlier" | "lee"
    severity: str               # "fatal" | "suspect"
    value: float = 0.0
    limit: float = 0.0

    @property
    def fatal(self) -> bool:
        return self.severity == FATAL


@dataclasses.dataclass(frozen=True)
class ForceEnvelope:
    """Calibrated per-bucket force-norm ceiling.

    ``limits`` maps bucket capacity -> max admissible per-atom force
    norm (eV/A), stored as a sorted tuple of pairs so the config stays
    hashable (engines are compared by their configs in the cluster).
    Calibrate on clean traffic through the *same* quantized engine that
    will serve — the envelope captures what "ordinary" looks like for
    this model at this precision, so an excursion means the input is
    outside the calibration set's trust region.
    """
    limits: Tuple[Tuple[int, float], ...] = ()

    @classmethod
    def calibrate(cls, results: Sequence, factor: float = 4.0,
                  floor: float = 1.0) -> "ForceEnvelope":
        """Build from clean ``MoleculeResult``s: per bucket capacity,
        ``factor`` x the max observed per-atom force norm (floored so a
        near-zero calibration set cannot produce a hair-trigger
        envelope)."""
        peak: Dict[int, float] = {}
        for r in results:
            norms = np.linalg.norm(np.asarray(r.forces), axis=-1)
            m = float(norms.max()) if norms.size else 0.0
            cap = int(r.bucket_capacity)
            peak[cap] = max(peak.get(cap, 0.0), m)
        return cls(limits=tuple(sorted(
            (cap, max(m * factor, floor)) for cap, m in peak.items())))

    def limit_for(self, capacity: int) -> Optional[float]:
        for cap, lim in self.limits:
            if cap == capacity:
                return lim
        return None


@dataclasses.dataclass(frozen=True)
class GuardrailConfig:
    """Per-engine detector configuration (hashable, like ServeConfig).

    ``on_flag`` is the engine-level default for what ``infer_batch``
    does when a detector fires: ``"raise"`` (the direct-call surface —
    a typed :class:`GuardrailViolation` instead of a bad result) or
    ``"mark"`` (the scheduler/cluster surface — results come back with
    ``flags`` set and the caller decides: resolve a typed error,
    deliver annotated, or escalate a precision tier).
    """
    check_finite: bool = True
    envelope: Optional[ForceEnvelope] = None
    # sampled LEE probe: every Nth infer_batch call re-runs the batch
    # under one seeded rotation (0 = off; cost ~ 1/N extra forwards)
    lee_probe_every: int = 0
    lee_limit: float = 1.0
    lee_seed: int = 0
    on_flag: str = "raise"      # "raise" | "mark"

    def __post_init__(self):
        if self.on_flag not in ("raise", "mark"):
            raise ValueError(f"unknown on_flag {self.on_flag!r}")
        if self.lee_probe_every < 0:
            raise ValueError("lee_probe_every must be >= 0")

    @property
    def active(self) -> bool:
        """Whether any detector can fire (an all-off config lets the
        result path skip guardrail work entirely)."""
        return (self.check_finite or self.envelope is not None
                or self.lee_probe_every > 0)


def check_result(energy: float, forces: np.ndarray, capacity: int,
                 config: GuardrailConfig) -> Tuple[Flag, ...]:
    """Run the per-molecule detectors (non-finite + envelope) on one
    result's arrays. Returns the flags that fired, fatal first."""
    flags = []
    if config.check_finite:
        if not (np.isfinite(energy) and bool(np.isfinite(forces).all())):
            flags.append(Flag("nonfinite", FATAL))
    env = config.envelope
    if env is not None and not flags:     # garbage norms are meaningless
        lim = env.limit_for(capacity)
        if lim is not None:
            m = float(np.linalg.norm(forces, axis=-1).max()) \
                if forces.size else 0.0
            if m > lim:
                flags.append(Flag("force_outlier", SUSPECT, value=m,
                                  limit=lim))
    return tuple(flags)


def check_finite_tree(arrays: Dict[str, np.ndarray]) -> Optional[str]:
    """Name of the first non-finite array in a dict of host arrays
    (None when all finite) — the MD per-checkpoint finite check."""
    for name, a in arrays.items():
        if not bool(np.isfinite(np.asarray(a)).all()):
            return name
    return None
