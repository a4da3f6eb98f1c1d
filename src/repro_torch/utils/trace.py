"""Host spans of the serving path, kept in memory: the port's one span
recorder.

A span is a named interval on ``time.perf_counter_ns``, the clock a device
trace of the same process is mapped to, with its parent (the span open on
the same thread when it opened), its thread and, where the work belongs to
one micro-batch, the batch's id; a span opened inside another inherits its
batch.  The torch calls a span wraps are asynchronous on the card, so a
span's length is the host's time to enqueue its phase plus any wait for the
device inside it (a readback).

The recorder is off until :func:`enable`.  Off, a span site is one branch
on the module flag ``ON`` and hands back one shared no-op context: no clock
is read and nothing is allocated.  :func:`timed` is for a site whose own
counter needs the interval anyway: it always reads the clock, and records a
span only while the recorder is on, so the counter and the span share their
two clock reads.

    trace.enable()
    ...                      # serve
    spans = trace.take()     # every span closed since, oldest first
    trace.disable()
"""
from __future__ import annotations

import itertools
import threading
import time

ON = False

_spans: list["Span"] = []
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One interval: ``name``, ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns``, ``id``, ``parent`` (the id of the span open
    around it on its thread, or None), ``thread`` (``threading.get_ident``),
    ``batch`` (the micro-batch id, or None) and ``tag`` (a kind within the
    name, or None).  As a context manager it times its block; ``keep``
    records it once closed."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "thread", "batch", "tag",
                 "keep")

    def __init__(self, name: str, *, batch: int | None = None, tag: str | None = None,
                 keep: bool = True):
        self.name = name
        self.batch = batch
        self.tag = tag
        self.keep = keep
        self.start_ns = self.end_ns = 0
        self.id = self.parent = None
        self.thread = None

    def __enter__(self) -> "Span":
        if self.keep:
            stack = _stack()
            if stack:
                top = stack[-1]
                self.parent = top.id
                if self.batch is None:
                    self.batch = top.batch
            self.id = next(_ids)
            self.thread = threading.get_ident()
            stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.keep:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}..{self.end_ns}, id={self.id}, "
                f"parent={self.parent}, batch={self.batch}, tag={self.tag!r})")


class _Off:
    """The shared context of a span site while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, *, batch: int | None = None, tag: str | None = None):
    """A span around a block (``with trace.span("search.scan"):``); the
    shared no-op context while the recorder is off."""
    if not ON:
        return _OFF
    return Span(name, batch=batch, tag=tag)


def timed(name: str, *, batch: int | None = None, tag: str | None = None) -> Span:
    """A span whose length (``.seconds``) its caller reads whether or not
    the recorder is on; recorded only while it is."""
    return Span(name, batch=batch, tag=tag, keep=ON)


def record(name: str, start_ns: int, end_ns: int, *, batch: int | None = None,
           tag: str | None = None) -> None:
    """Record an interval that no block on this thread spans (a request's
    wait in the queue); it has no parent.  Callers check ``ON`` first."""
    s = Span(name, batch=batch, tag=tag)
    s.start_ns, s.end_ns = int(start_ns), int(end_ns)
    s.id, s.thread = next(_ids), threading.get_ident()
    _spans.append(s)


def set_batch(batch: int) -> None:
    """Give the innermost span open on this thread the batch id (a batch
    formed inside it); a no-op while the recorder is off."""
    if ON:
        stack = _stack()
        if stack:
            stack[-1].batch = batch


def enable() -> None:
    """Start recording (spans recorded before are kept until :func:`take`)."""
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def take() -> list[Span]:
    """Every span closed since the last call, oldest closed first."""
    n = len(_spans)
    out = _spans[:n]
    del _spans[:n]      # a span closed meanwhile stays for the next call
    return out


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time by id: its length less the part of it that its
    children (the given spans whose ``parent`` is its id) cover."""
    kids: dict[int, list[tuple[int, int]]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
