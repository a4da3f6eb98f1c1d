"""Why the reference's async stress test fails now and then: ordering fault
or ANN miss?

Runs the workload of ``tests/test_serve_async.py::test_async_multithreaded_stress``
(4 submitter threads x 60 operations on the JAX reference's async engine,
the test's own engine and data) with two probes the test lacks, without
editing the test or the reference:

* every ticket is stamped with a dispatch counter (the engine's
  ``_process`` wrapped): a search before an awaited insert's dispatch
  would be an ordering violation;
* on a miss (the own vector's vid not in its top-5 at nprobe 32), the same
  vector is searched again at once at nprobe 256, and after the run each
  missed vid its thread did not delete later is looked up in the final
  state and searched again.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/serve_stress_diagnosis.py [runs]
"""
from __future__ import annotations

import sys
import threading
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from repro.serve import engine as E  # noqa: E402
from repro.storage import versionmap as vm  # noqa: E402
from tests.conftest import make_clustered  # noqa: E402
from tests.test_serve_async import _async_engine  # noqa: E402

DIM = 16
_counter = [0]
_process = E.ServeEngine._process


def _stamped(self, batch):
    """A search ticket keeps the count of update batches dispatched before
    it; an update ticket the count including its own batch."""
    if batch.op == "search":
        for p in batch.parts:
            if not hasattr(p.ticket, "stamp"):
                p.ticket.stamp = _counter[0]
        return _process(self, batch)
    out = _process(self, batch)
    _counter[0] += 1
    for p in batch.parts:
        p.ticket.stamp = _counter[0]
    return out


E.ServeEngine._process = _stamped


def run() -> dict:
    eng, _ = _async_engine(np.random.default_rng(0), n_base=800, max_wait_ms=1.0)
    res = {"checks": 0, "violations": 0, "misses": [], "found_wide": [], "deleted": set()}
    lock = threading.Lock()

    def worker(tid):
        trng = np.random.default_rng(100 + tid)
        vid = 2000 + 1000 * tid
        live = {}
        for _ in range(60):
            op = trng.integers(0, 10)
            if op < 5 or not live:
                v = make_clustered(trng, 1, DIM)
                tk = eng.submit_insert(v, np.asarray([vid], np.int32))
                tk.result(timeout=120)
                live[vid] = (v, tk.stamp)
                vid += 1
            elif op < 8:
                pick = int(trng.choice(sorted(live)))
                tk = eng.submit_search(live[pick][0], k=5, nprobe=32)
                _, hit = tk.result(timeout=120)
                if pick in hit[0].tolist():
                    with lock:
                        res["checks"] += 1
                    continue
                wide = eng.submit_search(live[pick][0], k=5, nprobe=256).result(timeout=120)[1]
                with lock:
                    res["checks"] += 1
                    if tk.stamp < live[pick][1]:
                        res["violations"] += 1
                    else:
                        res["misses"].append((pick, live[pick][0]))
                        res["found_wide"].append(pick in wide[0].tolist())
            else:
                pick = int(trng.choice(sorted(live)))
                eng.submit_delete(np.asarray([pick], np.int32)).result(timeout=120)
                live.pop(pick)
                with lock:
                    res["deleted"].add(pick)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    eng.pump()
    st = eng.index.state
    vids = st.pool.block_vid.reshape(-1)
    stale = np.asarray(vm.is_stale(st.versions, vids, st.pool.block_ver.reshape(-1)))
    vids = np.asarray(vids)
    alive = set(vids[(vids >= 0) & ~stale].tolist())
    kept = [(p, v) for p, v in res["misses"] if p not in res["deleted"]]
    out = {
        "checks": res["checks"], "ordering_violations": res["violations"],
        "misses": len(res["misses"]),
        "missed_found_at_once_at_nprobe_256": res["found_wide"],
        "missed_deleted_later": len(res["misses"]) - len(kept),
        "missed_kept_live_in_the_final_state": [p in alive for p, _ in kept],
        "missed_kept_found_at_the_end": [p in eng.search(v, k=5, nprobe=32)[1][0].tolist()
                                         for p, v in kept],
        "n_reassign_overflow": eng.stats()["n_reassign_overflow"],
        "n_append_drops": eng.stats()["n_append_drops"],
        "n_postings": eng.stats()["n_postings"],
    }
    eng.shutdown()
    return out


if __name__ == "__main__":
    for _ in range(int(sys.argv[1]) if len(sys.argv) > 1 else 6):
        print(run(), flush=True)
