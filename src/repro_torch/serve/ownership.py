"""Explicit ownership annotations for the serve engine's shared state,
plus the debug-flag runtime checker (a copy of the JAX package's
``serve/ownership.py``).

The engine's threading discipline used to live in docstrings ("caller
holds ``_work``", "all mutated under ``_work`` on the pump").  This
module makes it machine-readable in both directions:

* **statically** — a lexical lock pass (the reference's spflint SPF20x)
  reads the ``FIELD_OWNERSHIP`` / ``PUMP_METHODS`` /
  ``LIFECYCLE_METHODS`` class attributes and the ``@holds_work``
  decorators and verifies every ``self.<field>`` access site;
* **at runtime** — ``install_lock_check(engine)``
  (``EngineConfig.lock_check``) swaps in an owner-tracking lock and a
  checking ``__setattr__`` so the async stress tests catch what a
  lexical pass can't (calls that arrive on the wrong thread).

Ownership categories:

* ``GUARDED``   — read/written only while holding ``_work``;
* ``PUMP``      — written only by the pump thread (or by lifecycle
                  methods, which run strictly before the pump thread
                  starts / after it joins); reads are unrestricted;
* ``INIT``      — bound once in ``__init__``, immutable after;
* ``LIFECYCLE`` — written only by the declared lifecycle methods.
"""
from __future__ import annotations

import threading
from typing import Callable, TypeVar

GUARDED = "guarded"
PUMP = "pump"
INIT = "init"
LIFECYCLE = "lifecycle"

F = TypeVar("F", bound=Callable)


def holds_work(fn: F) -> F:
    """Declare that every caller of ``fn`` holds the engine's ``_work``
    lock.  The static lock pass (a) treats the body as locked and
    (b) verifies every internal call site actually holds the lock
    (SPF207); the runtime checker relies on ``_work`` being re-entrant,
    so the annotation adds no runtime cost."""
    fn.__holds_work__ = True
    return fn


class CheckedRLock:
    """An RLock that knows which thread owns it — the instrumented lock
    the runtime checker consults.  Drop-in for ``threading.RLock()``."""

    __slots__ = ("_lock", "_owner", "_count")

    def __init__(self):
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
        return got

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    @property
    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()


class LockDisciplineError(AssertionError):
    """A shared-field write violated the declared ownership map."""


def _checking_setattr(self, name: str, value) -> None:
    cat = type(self).FIELD_OWNERSHIP.get(name)
    if cat == GUARDED:
        work = object.__getattribute__(self, "_work")
        if isinstance(work, CheckedRLock) and not work.held_by_me:
            raise LockDisciplineError(
                f"write to guarded field {name!r} without holding _work "
                f"(thread {threading.current_thread().name})"
            )
    elif cat == PUMP:
        pump = object.__getattribute__(self, "_pump_thread")
        if (
            pump is not None and pump.is_alive()
            and threading.current_thread() is not pump
        ):
            raise LockDisciplineError(
                f"write to pump-thread-only field {name!r} from "
                f"non-pump thread {threading.current_thread().name}"
            )
    elif cat == INIT:
        raise LockDisciplineError(
            f"write to init-only field {name!r} after construction"
        )
    elif cat == LIFECYCLE:
        pump = object.__getattribute__(self, "_pump_thread")
        if pump is not None and threading.current_thread() is pump:
            raise LockDisciplineError(
                f"write to lifecycle field {name!r} from the pump thread"
            )
    object.__setattr__(self, name, value)


def install_lock_check(engine) -> None:
    """Instrument ``engine`` (in place) to enforce its FIELD_OWNERSHIP
    map on every subsequent attribute write.  Must run after ``__init__``
    has bound all fields and BEFORE the pump thread starts.  Idempotent.

    Tests that intentionally poke internals (e.g. clearing a simulated
    pump error) bypass the check with ``object.__setattr__``.
    """
    if getattr(type(engine), "__lock_checked__", False):
        return
    if not isinstance(engine._work, CheckedRLock):
        object.__setattr__(engine, "_work", CheckedRLock())
    cls = type(engine)
    checked = type(
        cls.__name__ + "LockChecked", (cls,),
        {"__setattr__": _checking_setattr, "__lock_checked__": True},
    )
    object.__setattr__(engine, "__class__", checked)
