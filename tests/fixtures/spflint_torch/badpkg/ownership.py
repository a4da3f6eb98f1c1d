"""Fixture ownership categories, bound to names as the engine binds them."""

GUARDED = "guarded"
PUMP = "pump"
INIT = "init"
LIFECYCLE = "lifecycle"
