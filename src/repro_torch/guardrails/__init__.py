"""Runtime result guardrails of the port (numpy detectors)."""
from repro_torch.guardrails.detectors import (Flag, ForceEnvelope,
                                              GuardrailConfig,
                                              GuardrailViolation,
                                              check_finite_tree,
                                              check_result)

__all__ = ["Flag", "ForceEnvelope", "GuardrailConfig", "GuardrailViolation",
           "check_finite_tree", "check_result"]
