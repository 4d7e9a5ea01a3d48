"""repro_torch.cluster — the multi-replica serving runtime over
``repro_torch.server``: counterpart of ``repro.cluster``.

* :class:`ClusterPool` / :class:`ClusterConfig` — a replica pool (one
  ``QuantizedEngine`` + worker thread + CUDA stream + the *same*
  ``BatchQueue`` flush policy as the single-engine scheduler, per
  replica) behind a shape-class-aware join-shortest-queue router with
  bounded admission (shed + ``retry_after_s``), rolling zero-downtime
  artifact hot swap (``swap_artifact``), failover (``kill_replica`` →
  queued/in-flight requests requeue to survivors), mixed-precision
  fleets (``from_tiers``) whose flagged results re-run one tier up, and
  a watchdog (stall timeout, flagged-rate circuit breaker) that
  quarantines and cold-restarts sick replicas;
* :class:`Replica` / :class:`ReplicaFailed` — the per-replica worker
  and its failure error; :func:`pick_devices` — ``cuda:0..k-1`` round
  robin (one card: every replica on ``cuda:0``), or every replica on an
  explicit device such as ``"cpu"``.
"""
from repro_torch.cluster.pool import ClusterConfig, ClusterPool, pick_devices
from repro_torch.cluster.replica import Replica, ReplicaFailed

__all__ = ["ClusterConfig", "ClusterPool", "Replica", "ReplicaFailed",
           "pick_devices"]
