"""Fixture stamp tuples: one unclassified field, one stale name."""

REPLAY_CRITICAL_FIELDS = ("dim", "ghost")  # expect: SPF105 SPF106
REPLAY_EXEMPT_FIELDS = ("nprobe",)
