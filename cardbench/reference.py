"""The plain reference: exact nearest neighbours over the live set a search
saw, in plain PyTorch and NumPy.  It imports nothing of the program and
takes nothing the program made: it is given the generated vectors and the
harness's log of acknowledged updates with their ``seqno``s, and works the
live sets out itself.

A vid is live at seqno ``s`` when its insert landed at a seqno ``<= s``
(base vids: before any) and no delete of it ran at a seqno ``<= s``.  A row
whose insert ran but did not land (its nearest posting stayed full through
every retry) may still have landed as a closure replica: a search may
return it from then on, and the exact top-10 leaves it out.
"""
from __future__ import annotations

import numpy as np
import torch

NEVER = np.iinfo(np.int64).max
BLOCK_ROWS = 1024          # query rows a block of the brute force
BLOCK_COLS = 262_144       # vectors a block of the brute force


class LiveSets:
    """Every vector the run ever held (base, then the pool in vid order) and
    the seqnos at which each vid came and went."""

    def __init__(self, base: np.ndarray, pool: np.ndarray, n_inserted: int):
        self.n_base = len(base)
        self.vectors = np.concatenate([base, pool[:n_inserted]]).astype(np.float32)
        n = len(self.vectors)
        self.born = np.full(n, NEVER, np.int64)
        self.born[:self.n_base] = np.iinfo(np.int64).min
        self.sent = self.born.copy()          # the insert ran, landed or not
        self.died = np.full(n, NEVER, np.int64)

    def insert(self, vids: np.ndarray, landed: np.ndarray, seqno: int) -> None:
        self.sent[vids] = np.minimum(self.sent[vids], seqno)
        vids = vids[landed]
        self.born[vids] = np.minimum(self.born[vids], seqno)

    def delete(self, vids: np.ndarray, seqno: int) -> None:
        self.died[vids] = np.minimum(self.died[vids], seqno)

    def may_return(self, vids: np.ndarray, seqno) -> np.ndarray:
        """Whether a search at ``seqno`` may return each vid: its insert ran
        by then and no delete of it did."""
        ok = (vids >= 0) & (vids < len(self.vectors))
        v = np.where(ok, vids, 0)
        return ok & (self.sent[v] <= seqno) & (self.died[v] > seqno)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def exact_topk(live: LiveSets, queries: np.ndarray, seqnos: np.ndarray, k: int, *,
               device: str, tf32: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The exact ``k`` nearest live vids of each query at its seqno:
    ``(dists (Q, k) f32, vids (Q, k))``, by ``|q|^2 - 2 q.x + |x|^2`` in
    float32 with TF32 off, in blocks.  With ``tf32`` (the control) the
    product's inputs are first rounded to TF32, as the tensor cores do."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.as_tensor(live.vectors, device=device)
        xsq = (x.double() ** 2).sum(1).float()
        xm = to_tf32(x) if tf32 else x
        born = torch.as_tensor(live.born, device=device)
        died = torch.as_tensor(live.died, device=device)
        out_d, out_v = [], []
        for r in range(0, len(queries), BLOCK_ROWS):
            q = torch.as_tensor(queries[r:r + BLOCK_ROWS], device=device)
            s = torch.as_tensor(seqnos[r:r + BLOCK_ROWS], device=device)[:, None]
            qsq = (q * q).sum(1, keepdim=True)
            qm = to_tf32(q) if tf32 else q
            best_d = best_v = None
            for c in range(0, x.shape[0], BLOCK_COLS):
                d = qsq - 2.0 * (qm @ xm[c:c + BLOCK_COLS].T) + xsq[None, c:c + BLOCK_COLS]
                ok = (born[None, c:c + BLOCK_COLS] <= s) & (died[None, c:c + BLOCK_COLS] > s)
                d = torch.where(ok, d, torch.inf)
                vd, vi = torch.topk(d, min(k, d.shape[1]), largest=False)
                vi = vi + c
                if best_d is not None:
                    vd, sel = torch.topk(torch.cat([best_d, vd], 1), k, largest=False)
                    vi = torch.gather(torch.cat([best_v, vi], 1), 1, sel)
                best_d, best_v = vd, vi
            out_d.append(best_d.cpu().numpy())
            out_v.append(best_v.cpu().numpy())
        return np.concatenate(out_d), np.concatenate(out_v)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def exact_dists(live: LiveSets, queries: np.ndarray, vids: np.ndarray) -> tuple[np.ndarray,
                                                                               np.ndarray]:
    """``(d, scale)``: the float64 squared distance of each query row to each
    of its vids' vectors, from the difference, and ``|q|^2 + |x|^2``, the
    size of the terms an expanded distance cancels (vids out of range read
    nan)."""
    ok = (vids >= 0) & (vids < len(live.vectors))
    x = live.vectors[np.where(ok, vids, 0)].astype(np.float64)        # (Q, k, d)
    q = queries.astype(np.float64)[:, None, :]
    d = ((x - q) ** 2).sum(-1)
    scale = (x ** 2).sum(-1) + (q ** 2).sum(-1)
    return np.where(ok, d, np.nan), scale
