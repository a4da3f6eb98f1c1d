"""Fixture replay surface: nondeterminism + an unstamped config read,
all reachable from the declared root ``build_step``."""
import random
import time

import numpy as np
import torch
from numpy.random import default_rng


def _noise(n):
    t = time.time()                       # expect: SPF101
    j = random.random()                   # expect: SPF102
    r = np.random.rand(n)                 # expect: SPF102
    g = default_rng()                     # expect: SPF102
    return t, j, r, g


def _torch_noise(n, x):
    a = torch.rand(n)                     # expect: SPF102
    b = torch.randperm(n)                 # expect: SPF102
    c = torch.randn_like(x)               # expect: SPF102
    x.uniform_()                          # expect: SPF102
    torch.manual_seed(0)                  # expect: SPF102
    return a, b, c


def _torch_seeded(n, x, gen):
    # an explicit generator: must NOT fire SPF102
    a = torch.rand(n, generator=gen)
    x.normal_(generator=gen)
    return torch.multinomial(x, 1, generator=gen), a


def _accumulate(acc, idx, src, x, w):
    acc.index_add_(0, idx, src)                          # expect: SPF107
    acc.scatter_add_(0, idx, src)                        # expect: SPF107
    torch.index_add(acc, 0, idx, src)                    # expect: SPF107
    acc.scatter_reduce(0, idx, src, reduce="sum")        # expect: SPF107
    acc.index_put_((idx,), src, accumulate=True)         # expect: SPF107
    acc.put_(idx, src, True)                             # expect: SPF107
    torch.bincount(idx, weights=w)                       # expect: SPF107
    torch.histc(x)                                       # expect: SPF107
    x.median(dim=0)                                      # expect: SPF107
    torch.kthvalue(x, 2)                                 # expect: SPF107
    run = torch.cumsum(x, 0)                             # expect: SPF107
    return run, x.cumsum(dim=0)                          # expect: SPF107


def _accumulate_exact(acc, idx, src, x, mask):
    # an integer operand visible at the call, an order-free reduction, no
    # accumulation, or host numpy: must NOT fire SPF107
    acc.index_add_(0, idx, src.to(torch.int32))
    acc.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    acc.scatter_add_(0, idx, mask.long())
    acc.scatter_reduce(0, idx, src, reduce="amin")
    acc.index_put_((idx,), src)
    torch.bincount(idx)
    x.median()
    np.cumsum(src)
    a = torch.cumsum(mask.int(), 0)
    b = torch.cumsum(x, 0, dtype=torch.int64)
    return a, b, mask.bool().cumsum(0)


def _seeded_ok(n):
    # seeded Generator + list iteration: must NOT fire SPF102/SPF103
    g = default_rng(1234)
    for _ in [1, 2, 3]:
        pass
    return g.integers(0, n)


def build_step(cfg):
    for vid in {1, 2, 3}:                 # expect: SPF103
        _ = vid
    _noise(4)
    _torch_noise(4, None)
    _torch_seeded(4, None, None)
    _accumulate(None, None, None, None, None)
    _accumulate_exact(None, None, None, None, None)
    _seeded_ok(4)
    w = cfg.doubled
    return cfg.dim + cfg.extra + w        # expect: SPF104
