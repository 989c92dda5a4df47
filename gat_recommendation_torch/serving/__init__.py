"""Serving: the frozen limits, the request validation gate, the Recommender
and the HTTP app. The JAX package's ``serving.__all__``."""

from gat_recommendation_torch.serving.config import DEFAULT_LIMITS, ServingLimits
from gat_recommendation_torch.serving.validation import (
    InputValidationError,
    ValidatedRequest,
    validate_request,
)

__all__ = [
    "ServingLimits",
    "DEFAULT_LIMITS",
    "validate_request",
    "ValidatedRequest",
    "InputValidationError",
]
