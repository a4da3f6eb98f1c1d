"""Fixture engine class: one seeded violation per lock-discipline rule.
Its categories are names bound in ``ownership.py`` (one a literal)."""
import threading

from badpkg.ownership import GUARDED, INIT, LIFECYCLE, PUMP


def holds_work(fn):
    return fn


class BadEngine:                           # expect: SPF206
    LOCK_FIELD = "_work"
    PUMP_METHODS = ("_pump",)
    LIFECYCLE_METHODS = ("start", "stop")
    FIELD_OWNERSHIP = {
        "_work": INIT,
        "cfg": "init",
        "_inflight": GUARDED,
        "_busy": PUMP,
        "_thread": LIFECYCLE,
        "_ghost": GUARDED,
    }

    def __init__(self):
        self._work = threading.RLock()
        self.cfg = None
        self._inflight = 0
        self._busy = False
        self._thread = None

    # ------------------------- clean accesses -------------------------
    def ok_locked_read(self):
        with self._work:
            return self._inflight

    @holds_work
    def _locked_helper(self):
        self._inflight += 1

    def ok_locked_call(self):
        with self._work:
            self._locked_helper()

    def _pump(self):
        self._busy = True

    def start(self):
        self._thread = object()

    def stop(self):
        self._busy = False
        self._thread = None

    # ----------------------- seeded violations ------------------------
    def bad_read(self):
        return self._inflight              # expect: SPF201

    def bad_write(self):
        self._inflight = 0                 # expect: SPF202

    def bad_pump_write(self):
        self._busy = True                  # expect: SPF203

    def bad_init_write(self):
        self.cfg = 1                       # expect: SPF204

    def bad_lifecycle_write(self):
        self._thread = None                # expect: SPF204

    def bad_undeclared_write(self):
        self._stray = 1                    # expect: SPF205

    def bad_unlocked_call(self):
        self._locked_helper()              # expect: SPF207
