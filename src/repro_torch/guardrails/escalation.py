"""The precision ladder and the escalation audit record: a copy of
``repro/guardrails/escalation.py`` (stdlib only).

The JAX package's tiered serving shape: w4a8 replicas carry the traffic,
w8a8/fp32 replicas stand behind them as escalation targets. A request
flagged by a detector is transparently re-run one tier up; the result
the caller finally receives carries the full audit trail as
:class:`EscalationRecord`\\ s in ``MoleculeResult.escalations``.

"One tier up" means the next tier *present in the fleet* above the
flagging replica's — a w4a8 -> fp32 pool escalates straight to fp32.
The port's pool (``cluster/pool.py``) appends these records and its
replicas stamp them into the results (``cluster/replica.py``), as the
reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["TIER_ORDER", "tier_rank", "next_tier", "EscalationRecord"]

# precision tiers, cheapest first — the escalation ladder climbs right
TIER_ORDER = ("w4a8", "w8a8", "fp32")


def tier_rank(mode: str) -> int:
    """Position of a serving mode on the ladder (higher = more
    precise). Raises for modes that are not tiers."""
    try:
        return TIER_ORDER.index(mode)
    except ValueError:
        raise ValueError(f"{mode!r} is not a precision tier "
                         f"(ladder: {TIER_ORDER})") from None


def next_tier(mode: str) -> Optional[str]:
    """The tier directly above ``mode`` (None at the top — fp32 is
    ground truth, there is nowhere left to escalate)."""
    r = tier_rank(mode)
    return TIER_ORDER[r + 1] if r + 1 < len(TIER_ORDER) else None


@dataclasses.dataclass(frozen=True)
class EscalationRecord:
    """One hop up the ladder, stamped into the delivered result.

    ``reason`` is the detector that triggered it (``Flag.reason``),
    ``from_replica`` the replica whose result was flagged. The tier
    that finally answered is the result's own ``replica_id`` /
    ``path`` — a result with N records was re-run N times.
    """
    from_tier: str
    to_tier: str
    reason: str
    from_replica: int = -1
