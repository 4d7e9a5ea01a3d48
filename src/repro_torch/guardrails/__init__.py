"""Runtime result guardrails of the port (numpy detectors) and the
precision ladder's escalation record."""
from repro_torch.guardrails.detectors import (Flag, ForceEnvelope,
                                              GuardrailConfig,
                                              GuardrailViolation,
                                              check_finite_tree,
                                              check_result)
from repro_torch.guardrails.escalation import (TIER_ORDER, EscalationRecord,
                                               next_tier, tier_rank)

__all__ = ["Flag", "ForceEnvelope", "GuardrailConfig", "GuardrailViolation",
           "check_finite_tree", "check_result", "TIER_ORDER",
           "EscalationRecord", "next_tier", "tier_rank"]
