"""Serving: the continuous-batching engine on dense KV slots."""

from .engine import (
    FinishReason,
    Request,
    Scheduler,
    ServeConfig,
    ServeEngine,
    ServeResult,
)
