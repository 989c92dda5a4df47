"""Request sanitization for the serving layer.

Behavioral parity with the reference's validation contract
(etpgt/serving/validation.py:38-96): the same checks run in the same order
and produce the same accept/reject decisions, but this module is an
independent implementation — the serving tests pin the behavior, not the
prose of the error messages.

The gate runs before any model code. It is dependency-free on purpose (no
jax, no pydantic, no HTTP types beyond duck-typed ``.session_items`` /
``.k``), so its logic is trivially unit-testable. Check order:

1. reject an empty session
2. reject non-integer entries (including bools, which subclass int)
3. split ids into catalog hits and misses; reject if nothing survives
4. trim an over-long session to its most recent events
5. resolve k (default when absent, reject < 1, cap at the limits)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gat_recommendation_torch.serving.config import DEFAULT_LIMITS, ServingLimits


class InputValidationError(ValueError):
    """Raised when a request cannot be repaired. Message is caller-safe."""


@dataclass
class ValidatedRequest:
    """The sanitized form a request takes after passing the gate."""

    session_items: list[int]
    k: int
    dropped_items: list[int] = field(default_factory=list)
    truncated: bool = False


def _resolve_k(raw_k: int | None, num_items: int, limits: ServingLimits) -> int:
    """Fill in the default k, reject nonsense, and cap at the hard limits."""
    k = limits.default_k if raw_k is None else raw_k
    if k < 1:
        raise InputValidationError(f"requested k={k}, but k has a floor of 1.")
    return min(k, limits.max_k, num_items - 1)


def validate_request(
    request,
    num_items: int,
    limits: ServingLimits = DEFAULT_LIMITS,
) -> ValidatedRequest:
    """Turn a raw request into a ValidatedRequest, or raise.

    ``request`` only needs ``.session_items`` (list) and ``.k`` (int | None);
    the web layer's pydantic schema satisfies this, and so does any plain
    object in tests.
    """
    raw = request.session_items
    if not raw:
        raise InputValidationError("a session needs at least one item id.")

    for entry in raw:
        # bool passes isinstance(..., int); screen it out explicitly so
        # True/False never sneak in as item ids 1/0.
        if isinstance(entry, bool) or not isinstance(entry, int):
            raise InputValidationError(
                f"item ids must be plain ints, but the session contains "
                f"{type(entry).__name__} value {entry!r}."
            )

    kept: list[int] = []
    dropped: list[int] = []
    for item_id in raw:
        (kept if 0 <= item_id < num_items else dropped).append(item_id)
    if not kept:
        raise InputValidationError(
            f"every id in the {len(raw)}-item session falls outside the "
            f"known catalog (valid range is 0..{num_items - 1})."
        )

    over_limit = len(kept) > limits.max_session_length
    if over_limit:
        # Keep the tail: the most recent events carry the intent signal,
        # matching how training truncates long sessions.
        kept = kept[-limits.max_session_length :]

    return ValidatedRequest(
        session_items=kept,
        k=_resolve_k(request.k, num_items, limits),
        dropped_items=dropped,
        truncated=over_limit,
    )
