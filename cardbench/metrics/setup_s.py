"""Set-up seconds: from the process's start to the first timed request
(import, kernel load or build, data, the index build, the drain, the
warm-up)."""


def read(ctx):
    return ctx["window"][0] - ctx["t_start"]
