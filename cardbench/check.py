"""How ``correct`` is decided: the program's answers from the window against
the plain reference (``reference.py``), each number beside its limit.

The numbers, each with a limit in the configuration's ``limits``:

* ``unanswered``: requests that never resolved (a minute past the close);
* ``bad_rows``: sampled result rows with a missing vid (-1), a vid twice,
  or distances out of order;
* ``stale``: returned vids that no search at that seqno may return
  (deleted by then, or not yet inserted), and deleted vids that a search
  after the window returns for their own vectors;
* ``dist_err``: the largest gap between a returned distance and the exact
  squared distance of the query to that vid's vector, as a share of
  ``|q|^2 + |x|^2`` (the size of the terms an expanded distance cancels);
* ``recall``: mean recall@10 of the sampled rows against the exact top-10
  of the live set at each row's seqno (a floor);
* ``unfound`` (cells with inserts): the share of a seeded sample of
  acknowledged inserts that a search after the window, for their own
  vectors, does not return.

The sample is drawn from the seed once the window has closed: window
searches, in an order drawn from the seed, until ``SAMPLE_ROWS`` rows.
"""
from __future__ import annotations

import math
import sys

import numpy as np

from cardbench import reference as ref

SAMPLE_ROWS = 8192
PROBES = 1024               # acknowledged inserts and deletes searched after the window
FLOORS = ("recall",)        # limits that are floors; the others are ceilings


def live_sets(log, data) -> ref.LiveSets:
    """The live sets from the acknowledged updates of the log."""
    n_base = len(data["base"])
    ins = [r for r in log if r.kind == "insert" and r.seqno is not None]
    top = max((int(r.arg.max()) - n_base + 1 for r in ins), default=0)
    live = ref.LiveSets(data["base"], data["pool"], top)
    for r in ins:
        live.insert(r.arg, np.asarray(r.out[1], bool), r.seqno)
    for r in log:
        if r.kind == "delete" and r.seqno is not None:
            live.delete(r.arg, r.seqno)
    return live


def sample(log, window, seed: int, rows: int = SAMPLE_ROWS):
    """Resolved window searches in an order drawn from the seed, until
    ``rows`` rows."""
    w0, w1 = window
    cand = [r for r in log if r.kind == "search" and w0 <= r.due < w1 and r.out is not None]
    order = np.random.default_rng([seed, 6]).permutation(len(cand))
    out, n = [], 0
    for i in order:
        if n >= rows:
            break
        out.append(cand[i])
        n += cand[i].rows
    return out


def judge(live: ref.LiveSets, queries, seqnos, dists, ids, *, device: str, k: int) -> dict:
    """The numbers of one set of answers: ``bad_rows``, ``stale``,
    ``dist_err`` and ``recall``."""
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    bad = (ids < 0).any(1)
    srt = np.sort(ids, 1)
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= (dists[:, 1:] < dists[:, :-1]).any(1)
    seq = np.asarray(seqnos, np.int64)[:, None]
    bad_vid = (ids >= 0) & ~live.may_return(ids, seq)
    stale = int(bad_vid.sum())
    for i, j in list(zip(*np.nonzero(bad_vid)))[:5]:
        v = int(ids[i, j])
        ok = 0 <= v < len(live.vectors)
        print(f"[check] stale vid {v} at seqno {int(seq[i, 0])}: inserted "
              f"{int(live.sent[v]) if ok else None}, landed {int(live.born[v]) if ok else None}, "
              f"deleted {int(live.died[v]) if ok else None}", file=sys.stderr)
    d_exact, scale = ref.exact_dists(live, queries, ids)
    gap = np.abs(dists - d_exact) / scale
    gap = gap[ids >= 0]
    dist_err = float(np.nanmax(gap)) if gap.size and not np.isnan(gap).all() else 0.0
    _, want = ref.exact_topk(live, queries, seqnos, k, device=device)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(ids, want))
    return {"bad_rows": int(bad.sum()), "stale": stale, "dist_err": dist_err,
            "recall": hits / (k * len(ids))}


def probes(engine, log, live: ref.LiveSets, seed: int, k: int) -> dict:
    """After the window: search a seeded sample of the acknowledged inserts
    and of the acknowledged deletes for their own vectors.  Returns
    ``{"unfound", "resurrected"}``, or ``{}`` where the run made no update."""
    ins = np.concatenate([r.arg[np.asarray(r.out[1], bool)] for r in log
                          if r.kind == "insert" and r.seqno is not None] or [np.zeros(0, int)])
    dels = np.concatenate([r.arg for r in log if r.kind == "delete" and r.seqno is not None]
                          or [np.zeros(0, int)])
    if ins.size == 0 and dels.size == 0:
        return {}
    rng = np.random.default_rng([seed, 7])
    ins = ins[rng.permutation(ins.size)[:PROBES]]
    dels = dels[rng.permutation(dels.size)[:PROBES]]
    vids = np.concatenate([ins, dels]).astype(np.int64)
    _, got = search_all(engine, live.vectors[vids])
    found = (got == vids[:, None]).any(1)
    for v in vids[ins.size:][found[ins.size:]][:5]:
        print(f"[check] deleted vid {int(v)} (deleted at seqno {int(live.died[v])}) found "
              "after the window", file=sys.stderr)
    return {"unfound": float(1.0 - found[:ins.size].mean()) if ins.size else 0.0,
            "resurrected": int(found[ins.size:].sum())}


def search_all(engine, queries, chunk: int = 1024):
    outs = [engine.submit_search(queries[s:s + chunk]).result(timeout=60.0)
            for s in range(0, len(queries), chunk)]
    return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])


def numbers(log, data, window, seed: int, *, device: str, k: int, probed: dict,
            answers=None) -> dict:
    """Every number compared.  ``answers(live, queries, seqnos) -> (dists,
    ids)`` puts another answerer in the program's place (the control)."""
    live = live_sets(log, data)
    picked = sample(log, window, seed)
    q_rows = np.concatenate([r.arg for r in picked]) if picked else np.zeros(0, int)
    queries = data["queries"][q_rows]
    seqnos = np.concatenate([np.full(r.rows, r.seqno, np.int64) for r in picked]) \
        if picked else np.zeros(0, np.int64)
    if answers is None:
        dists = np.concatenate([r.out[0] for r in picked])
        ids = np.concatenate([r.out[1] for r in picked])
    else:
        dists, ids = answers(live, queries, seqnos)
    out = {"unanswered": sum(1 for r in log if math.isnan(r.done)), "sampled_rows": len(queries)}
    if len(queries):
        out.update(judge(live, queries, seqnos, dists, ids, device=device, k=k))
    if probed:
        out["stale"] = out.get("stale", 0) + probed["resurrected"]
        out["unfound"] = probed["unfound"]
    return out


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that have
    a limit; a missing number (nothing sampled) is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name == "unfound" and name not in nums:
            continue
        v = nums.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None:
            ok = False
        elif name in FLOORS:
            ok &= v >= limit
        else:
            ok &= v <= limit
    return bool(ok), checks
