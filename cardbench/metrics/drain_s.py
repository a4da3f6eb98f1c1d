"""Seconds of the set-up drain of the build's backlog (``Service.drain``),
host clock."""


def read(ctx):
    return ctx["setup"].get("drain")
