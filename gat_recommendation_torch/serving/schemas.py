"""Request and response shapes of the serving API.

Pydantic models where pydantic is installed; dataclasses with the same
fields and defaults where it is not (the card's host), so the serving stack
imports everywhere. ``PYDANTIC`` says which branch was taken. The JAX
package's ``serving/schemas.py``.
"""

from __future__ import annotations

try:
    from pydantic import BaseModel, Field

    class RecommendRequest(BaseModel):
        session_items: list[int] = Field(..., description="Item IDs viewed this session, in order.")
        k: int | None = Field(default=None, description="How many items to recommend.")

    class RecommendResponse(BaseModel):
        recommendations: list[int]
        scores: list[float]
        latency_ms: float
        dropped_items: list[int] = Field(default_factory=list)
        truncated: bool = False

    class HealthResponse(BaseModel):
        status: str
        model_loaded: bool
        num_items: int
        embedding_dim: int

    PYDANTIC = True

except ImportError:  # minimal environments: the card's host
    from dataclasses import dataclass, field

    @dataclass
    class RecommendRequest:  # type: ignore[no-redef]
        session_items: list[int]
        k: int | None = None

    @dataclass
    class RecommendResponse:  # type: ignore[no-redef]
        recommendations: list[int]
        scores: list[float]
        latency_ms: float
        dropped_items: list[int] = field(default_factory=list)
        truncated: bool = False

    @dataclass
    class HealthResponse:  # type: ignore[no-redef]
        status: str
        model_loaded: bool
        num_items: int
        embedding_dim: int

    PYDANTIC = False
