"""Fixture kernel wrappers: one seeded fallback per form of SPF302.

Parsed, never imported.
"""
import torch


def _on_cpu(x):
    return x.device.type == "cpu"


def _launch(name, *args):
    return torch.ops.demo.launch(name, *args)


def ok_plain(x):
    return x * 2


def ok(x):
    # the plain version on the CPU branch only: clean
    if _on_cpu(x):
        return ok_plain(x)
    return _launch("ok", x)


def fallback_plain(x):
    return x


def fallback(x):
    if x.device.type == "cpu":
        return fallback_plain(x)
    if x.numel() == 0:
        return fallback_plain(x)            # expect: SPF302
    return _launch("fallback", x)


def caught_plain(x):
    return x


def caught(x):
    if _on_cpu(x):
        return caught_plain(x)
    try:                                    # expect: SPF302
        return _launch("caught", x)
    except RuntimeError:
        return None


def helper_plain(x):
    return x


def _via_helper(x):
    return helper_plain(x)


def helper(x):
    if _on_cpu(x):
        return helper_plain(x)
    return _via_helper(x)                   # expect: SPF302
