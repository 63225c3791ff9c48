"""Execution sessions (``repro/exec``): host, outlined and dist regimes."""
from repro_torch.exec.spec import ExecutionSpec, spec_for
from repro_torch.exec.session import (CacheStats, Session, default_session,
                                      reset_default_session)

__all__ = ["ExecutionSpec", "spec_for", "CacheStats", "Session",
           "default_session", "reset_default_session"]
