"""Streaming MD sessions through the cluster, checkpointed and resumable:
counterpart of ``repro.sessions``."""
from repro_torch.sessions.faults import (FaultInjector, FaultSpec,
                                         corrupt_checkpoint, seeded_schedule)
from repro_torch.sessions.manager import (Frame, MDSession, SessionConfig,
                                          SessionManager, prng_key)

__all__ = ["Frame", "MDSession", "SessionConfig", "SessionManager",
           "FaultInjector", "FaultSpec", "corrupt_checkpoint",
           "seeded_schedule", "prng_key"]
