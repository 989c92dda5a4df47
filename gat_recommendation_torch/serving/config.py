"""Static serving limits (parity with reference etpgt/serving/config.py:10-29)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class ServingLimits:
    """Bounds applied to every incoming request.

    max_session_length matches training truncation (last 50 events).
    """

    min_session_length: int = 1
    max_session_length: int = 50
    default_k: int = 10
    max_k: int = 100


DEFAULT_LIMITS = ServingLimits()
