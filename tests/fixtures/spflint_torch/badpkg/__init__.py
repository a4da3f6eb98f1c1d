"""Seeded-violation fixture package for the port's spflint passes.

Every deliberate violation line carries a trailing ``# expect: SPF...``
marker (``// expect:`` in the ``.cu`` source);
``tests/test_torch_spflint.py`` parses the markers and asserts the passes
report EXACTLY that (file, line, rule) multiset — nothing missing,
nothing extra.  These modules are parsed, never imported.
"""
