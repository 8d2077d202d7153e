"""Serving: the continuous-batching engine on dense KV slots or a paged
block pool, its live event stream and the stream's worker thread."""

from .emit import stream_async
from .engine import (
    FinishEvent,
    FinishReason,
    Request,
    Scheduler,
    ServeConfig,
    ServeEngine,
    ServeResult,
    TokenEvent,
)
