"""Maintenance scheduling policies for the serving pipeline.

SPFresh overlaps the foreground Updater with the background Local
Rebuilder; *when* the rebuilder gets a slot is the pipeline-balance knob
the paper tunes in Fig. 12 (2 foreground threads : 1 background thread
is their optimum).  Here there are no rebuilder threads — the engine
interleaves maintenance *slots* between foreground update batches — so
the knob becomes a scheduling policy object.  A slot is ONE fused
``maintenance_round`` dispatch: ``budget`` is the round's
jobs-per-round count (top-``budget`` splits + bottom-``budget`` merges
+ one fused reassign pass), not a sequential step count.

Two concrete policies ship:

* :class:`RatioPolicy` — the paper's feed-forward pipeline: one
  maintenance slot every ``ratio`` foreground update batches,
  unconditionally.  ``ratio <= 0`` disables background maintenance
  entirely (the SPANN+ ablation).
* :class:`BacklogPolicy` — reactive scheduling in the spirit of
  incremental-IVF merge policies (arXiv 2411.00970): a slot fires only
  when the measured rebuild backlog (number of oversized postings
  waiting for a split) reaches a threshold.  Idle workloads pay zero
  maintenance cost; bursty ones get slots exactly when the backlog
  appears.

The engine calls ``note_foreground`` after every update batch, then
``want_maintenance(backlog_fn)``; ``backlog_fn`` is a callable so that
policies that don't need the backlog (ratio) never pay the device
read-back that computing it costs.
"""
from __future__ import annotations


class MaintenancePolicy:
    """Decides when the engine gives the Local Rebuilder a slot.

    Subclasses override :meth:`want_maintenance`; ``budget`` is the
    jobs-per-round of the fused maintenance round each slot dispatches.
    """

    def __init__(self, budget: int = 8):
        self.budget = budget
        self.fg_batches = 0
        self.slots_fired = 0

    def note_foreground(self) -> None:
        """Called once per processed foreground *update* batch."""
        self.fg_batches += 1

    def want_maintenance(self, backlog_fn) -> bool:
        raise NotImplementedError

    def note_maintenance(self, jobs: int) -> None:
        self.slots_fired += 1

    def describe(self) -> str:
        return type(self).__name__


class RatioPolicy(MaintenancePolicy):
    """Fixed fg:bg interleave — the paper's 2:1 pipeline (Fig. 12)."""

    def __init__(self, ratio: int = 2, budget: int = 8):
        super().__init__(budget)
        self.ratio = ratio
        self._since_slot = 0

    def note_foreground(self) -> None:
        super().note_foreground()
        self._since_slot += 1

    def want_maintenance(self, backlog_fn) -> bool:
        if self.ratio <= 0:
            return False
        if self._since_slot >= self.ratio:
            self._since_slot = 0
            return True
        return False

    def describe(self) -> str:
        if self.ratio <= 0:
            return "ratio:off"
        return f"ratio:{self.ratio}to1/b{self.budget}"


class BacklogPolicy(MaintenancePolicy):
    """Fire a slot when the rebuild backlog reaches ``threshold``.

    ``check_every`` rate-limits how often the (host-synchronising)
    backlog probe runs: the backlog is only measured every that many
    foreground batches.
    """

    def __init__(self, threshold: int = 1, budget: int = 16,
                 check_every: int = 1):
        super().__init__(budget)
        assert threshold >= 1 and check_every >= 1
        self.threshold = threshold
        self.check_every = check_every
        self._since_check = 0
        self.probes = 0

    def note_foreground(self) -> None:
        super().note_foreground()
        self._since_check += 1

    def want_maintenance(self, backlog_fn) -> bool:
        if self._since_check < self.check_every:
            return False
        self._since_check = 0
        self.probes += 1
        return backlog_fn() >= self.threshold

    def describe(self) -> str:
        return f"backlog:t{self.threshold}/b{self.budget}"
