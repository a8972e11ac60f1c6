"""Launch counts of the kernel wrappers.

Every wrapper of a hand-written kernel carries an integer `.launches`, and
adds one to it where it launches its kernel (`count`).  The counts are
process-wide while several threads launch at once (the schedulers of dp
replicas), so `count` adds under a lock, and a thread that captures a CUDA
graph (core/graphs.py) records its own launches apart (`recording`): the
capture takes back exactly those and adds them again at each replay,
whatever other threads launch meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

_LOCK = threading.Lock()
_LOCAL = threading.local()


def count(fn: Callable, n: int = 1) -> None:
    """Add `n` to `fn.launches`; inside `recording` on this thread, to its
    record too."""
    with _LOCK:
        fn.launches += n
    record = getattr(_LOCAL, "record", None)
    if record is not None:
        record[fn] = record.get(fn, 0) + n


@contextlib.contextmanager
def recording(record: dict) -> Iterator[dict]:
    """Record into `record` (wrapper → launches) what this thread counts
    inside the block."""
    _LOCAL.record = record
    try:
        yield record
    finally:
        _LOCAL.record = None
