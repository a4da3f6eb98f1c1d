"""Faults planted under the timed path, for the test that sees ``correct``
come out false (``tests/test_cardbench_faults.py``) and for reading a
fault's numbers on the card.  The benchmark's own runs plant none.

* ``unchanged``: every insert and delete dispatch leaves the state as it
  was and reports its rows landed;
* ``half_batch``: a search dispatch answers the first half of its rows and
  leaves the rest out (no vid, no distance);
* ``altered``: a search dispatch's nearest answer of every row is replaced
  by the next vid.
"""
from __future__ import annotations

import numpy as np

BIG = np.float32(3.0e38)


def plant(name: str, svc) -> None:
    be = svc.backend
    if name == "unchanged":
        be.insert = lambda vecs, vids, valid: (np.asarray(vids), np.asarray(valid, bool))
        be.delete = lambda vids, valid: None
        return
    begin = be.search_begin

    def search_begin(queries, k, nprobe, valid=None):
        fin = begin(queries, k, nprobe, valid)

        def finalize():
            d, v = fin()
            d, v = d.copy(), v.copy()
            if name == "half_batch":
                n = int(np.asarray(valid).sum()) if valid is not None else len(v)
                d[n // 2:], v[n // 2:] = BIG, -1
            elif name == "altered":
                v[:, 0] = v[:, 0] + 1
            else:
                raise ValueError(f"unknown fault {name!r}")
            return d, v
        return finalize

    be.search_begin = search_begin
