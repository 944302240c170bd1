"""Named spans of host time inside the port, for a profiler to lay over the
device's trace.

``span(name)`` marks a region of the program::

    with span("pips.encode"):
        ...

While no recording is open it returns one shared object that does nothing:
it reads no clock and allocates nothing, so a span costs a function call.
``recording()`` opens a recording and yields its list; until it closes,
each span appends ``(name, depth, begin_ns, end_ns)`` to that list when it
closes, so inner spans come before the spans around them. ``depth`` counts
the spans open around it on its own thread. The times are
``time.time_ns()``, the Unix clock in which ``torch.profiler`` stamps its
host and device events, so the spans share the trace's clock.

The depth is kept per thread: a recompute under ``torch.utils.checkpoint``
enters the model's spans again from the autograd engine's thread while the
caller's thread waits inside its own. One recording is open at a time, and
every thread appends to it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, Optional, Tuple

Span = Tuple[str, int, int, int]  # (name, depth, begin_ns, end_ns)

_record: Optional[List[Span]] = None
_depth = threading.local()


class _Off:
    """The span returned while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "out", "depth", "begin")

    def __init__(self, name: str, out: List[Span]):
        self.name, self.out = name, out

    def __enter__(self) -> None:
        self.depth = getattr(_depth, "n", 0)
        _depth.n = self.depth + 1
        self.begin = time.time_ns()

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _depth.n = self.depth
        self.out.append((self.name, self.depth, self.begin, end))
        return False


def span(name: str):
    """A context manager that records ``name`` while a recording is open."""
    out = _record
    return _OFF if out is None else _On(name, out)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span closed until this block ends, in the list it yields."""
    global _record
    if _record is not None:
        raise RuntimeError("a span recording is already open")
    out: List[Span] = []
    _record = out
    try:
        yield out
    finally:
        _record = None
