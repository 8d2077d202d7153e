"""A worker thread that drives a serve stream behind a bounded queue.

``stream_async`` runs an engine's ``serve_stream()`` generator on a worker
thread and hands its events to the caller through a bounded FIFO, so a
consumer that spends milliseconds a token on detokenizing, formatting or
I/O does not stretch the interval between decode steps: the worker steps
ahead until ``backlog`` events wait, then blocks.  The worker launches on
the same (default) CUDA stream as any other caller of the engine; it uses
no stream of its own.

Contract:

* every event of the stream is delivered once, in stream order;
* an exception raised inside the stream (a strict-mode shed, a kernel's
  failure) is raised again in the consumer's thread, at its place in the
  event order;
* the engine's session is mutated from the worker thread, so while the
  iterator is live do not ``submit``, ``snapshot`` or stream the same
  engine from another thread: submit everything first, then drain;
* abandoning the iterator stops the worker at its next event.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

_DONE = object()     # the stream is exhausted
_ERROR = object()    # the stream raised; the exception follows


def stream_async(source, backlog: int = 64, strict: Optional[bool] = None) -> Iterator:
    """Yield ``source.serve_stream(strict=strict)``'s events, driven by a
    worker thread; ``backlog`` bounds the events waiting to be consumed."""
    if backlog < 1:
        raise ValueError(f"backlog must be >= 1, got {backlog}")
    q: queue.Queue = queue.Queue(maxsize=backlog)
    stop = threading.Event()

    def worker():
        try:
            for ev in source.serve_stream(strict=strict):
                while not stop.is_set():
                    try:
                        q.put((None, ev), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put((_DONE, None))
        except BaseException as e:  # raised again on the consumer's side
            q.put((_ERROR, e))

    t = threading.Thread(target=worker, name="serve-emit", daemon=True)
    t.start()
    try:
        while True:
            tag, val = q.get()
            if tag is _DONE:
                break
            if tag is _ERROR:
                raise val
            yield val
    finally:
        stop.set()
        t.join(timeout=5.0)
