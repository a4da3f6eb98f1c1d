"""Seconds of the index build inside set-up (``api.open``), host clock."""


def read(ctx):
    return ctx["setup"].get("build")
