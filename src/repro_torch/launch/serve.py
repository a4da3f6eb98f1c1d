"""Serving launcher: stand up a SPFresh *service* and run a mixed
search/update stream through it (the paper's §5.2 loop).

Everything is driven through the service API: the flags compile into ONE
:class:`~repro_torch.api.ServiceSpec` and ``repro_torch.api.open(spec)``
serves a single index or an N-shard index, with read replicas, behind the
same handle, on one device — with the durable lifecycle attached when
``--durable`` is set:

    PYTHONPATH=src python -m repro_torch.launch.serve --n 8000 --epochs 10 \
        --dataset spacev --rate 0.01 --policy ratio --ratio 2
    PYTHONPATH=src python -m repro_torch.launch.serve --n 4000 --shards 4 --replicas 2
    # durable service: WAL every update, checkpoint every 2000 rows,
    # then kill it and recover:
    PYTHONPATH=src python -m repro_torch.launch.serve --durable DIR \
        --checkpoint-every 2000
    PYTHONPATH=src python -m repro_torch.launch.serve --durable DIR --recover

It runs on the card; ``--device cpu`` runs the plain PyTorch path on the
CPU.
"""
from __future__ import annotations

import argparse

import numpy as np


def _print_report(service) -> None:
    rep = service.report()
    q, m, d = rep["queue"], rep["maintenance"], rep["durability"]
    print(f"policy={m['policy']} maint_slots={m['slots']} "
          f"maint_rounds={m['rounds']} maint_jobs={m['steps']} "
          f"maint_jps={m['steps_per_s']:.1f} "
          f"insert_stall={rep['insert_stall_s'] * 1e3:.0f}ms")
    if rep.get("async"):
        print(f"async: overlap_frac={m.get('overlap_frac', 0.0):.2f} "
              f"idle_slots={m.get('idle_slots', 0)} "
              f"forced={m.get('forced', 0)} "
              f"window_waits={q.get('window_waits', 0)}")
    print(f"queue: batches={q['batches']} rows={q['rows']} "
          f"pad_waste={q['padding_waste_frac']:.3f} "
          f"depth_avg={q['depth_rows_avg']:.0f} depth_max={q['depth_rows_max']}")
    r = rep.get("replicas")
    if r:
        lags = [x["lag"] for x in r["per_replica"]]
        print(f"replicas: n={r['n_replicas']} "
              f"routed={r['routed_batches']} "
              f"fallback={r['fallback_primary']} "
              f"published={r['published']} "
              f"max_lag_seen={max(lags) if lags else 0} "
              f"catchups={sum(x['catchups'] for x in r['per_replica'])}")
    if d["durable"]:
        wal = d.get("wal", {})
        print(f"durability: recovered={d['recovered']} "
              f"wal_seqnos={d['wal_seqnos']} "
              f"since_ckpt={d['updates_since_checkpoint']} "
              f"chain_len={d.get('snapshot_chain_len', 0)} "
              f"fsyncs/dispatch={wal.get('fsyncs_per_append', 1):.2f}")
    for op in ("search", "insert", "delete"):
        p = rep[op]
        if p:
            print(f"{op}: p50={p['p50_ms']:.1f}ms p99={p['p99_ms']:.1f}ms "
                  f"n={p['n']}")


def build_spec(args):
    """Compile the CLI flags into the ONE ServiceSpec: every knob has
    exactly one home."""
    from repro_torch import api
    from repro_torch.core.types import LireConfig

    jobs = args.maintain_jobs or args.budget
    cfg = LireConfig(
        dim=args.dim, block_size=8, max_blocks_per_posting=8,
        num_blocks=max(8192, args.n // 2),
        num_postings_cap=max(1024, args.n // 20),
        num_vectors_cap=4 * args.n, split_limit=48, merge_limit=6,
        reassign_range=8, replica_count=2, nprobe=args.nprobe,
    )
    return api.ServiceSpec(
        index=api.IndexSpec(config=cfg),
        serve=api.ServeSpec(
            search_k=10, nprobe=args.nprobe, policy=args.policy,
            fg_bg_ratio=args.ratio, backlog_threshold=args.threshold,
            async_serve=args.async_serve, max_wait_ms=args.max_wait_ms,
            max_lag=args.max_lag,
        ),
        scan=api.ScanSpec(
            probe_chunk=args.probe_chunk,
            use_pallas_scan=None if args.scan == "oracle" else True,
            scan_schedule=None if args.scan == "oracle" else args.scan,
            codec=args.codec,
            rerank_factor=args.rerank_factor,
        ),
        maintenance=api.MaintenanceSpec(
            jobs_per_round=jobs, policy=args.maintain_policy,
        ),
        durability=api.DurabilitySpec(
            root=args.durable, checkpoint_every=args.checkpoint_every,
            delta_every=args.delta_every, compact_every=args.compact_every,
            group_commit=args.group_commit,
            group_commit_ms=args.group_commit_ms,
            compact_wal=args.compact_wal,
        ),
        shards=api.ShardSpec(n_shards=args.shards,
                                 n_replicas=args.replicas),
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--rate", type=float, default=0.01)
    ap.add_argument("--dataset", choices=["spacev", "sift"], default="spacev")
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--durable", default=None, metavar="DIR",
                    help="service root: per-shard WAL + snapshot "
                         "checkpoints live under DIR (DurabilitySpec)")
    ap.add_argument("--snapshot", default=None,
                    help="legacy alias of --durable")
    ap.add_argument("--recover", action="store_true",
                    help="open-time recovery: restore the latest snapshot "
                         "under --durable and replay the per-shard WALs "
                         "instead of rebuilding")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="auto-checkpoint (FULL snapshot + WAL truncate) "
                         "every N update rows (0 = only at exit)")
    ap.add_argument("--delta-every", type=int, default=0, metavar="N",
                    help="auto-checkpoint a DELTA snapshot (only blocks "
                         "dirtied since the last unit, per shard) every "
                         "N update rows (0 = full snapshots only)")
    ap.add_argument("--compact-every", type=int, default=16, metavar="M",
                    help="fold the delta chain into a fresh base once M "
                         "deltas stack on it (0 = never auto-compact)")
    ap.add_argument("--group-commit", type=int, default=0, metavar="N",
                    help="batch up to N update dispatches per WAL fsync "
                         "(ack still waits for the fsync; 0 = fsync "
                         "every dispatch)")
    ap.add_argument("--group-commit-ms", type=float, default=0.0,
                    help="group-commit window age-out in ms (0 = close "
                         "on count/ack only)")
    ap.add_argument("--compact-wal", action="store_true",
                    help="on --recover, drop insert rows whose vids were "
                         "later deleted before replaying (faster replay; "
                         "local backend)")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="async serving: a dedicated background pump "
                         "thread owns all dispatches; callers enqueue "
                         "and block on per-ticket events, maintenance "
                         "runs in queue-idle gaps, durable updates ack "
                         "after the WAL fsync")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="batch-formation window: hold an unfenced head "
                         "run up to this long so micro-batches fill "
                         "toward the top bucket (async mode only; "
                         "0 = dispatch immediately)")
    ap.add_argument("--policy", choices=["ratio", "backlog"], default="ratio")
    ap.add_argument("--ratio", type=int, default=2,
                    help="fg update batches per bg slot (0 disables)")
    ap.add_argument("--budget", type=int, default=8,
                    help="rebuild jobs per bg slot (legacy alias of "
                         "--maintain-jobs)")
    ap.add_argument("--maintain-jobs", type=int, default=None,
                    help="jobs per fused maintenance round (top-K splits "
                         "+ bottom-K merges per slot, one dispatch); "
                         "overrides --budget")
    ap.add_argument("--maintain-policy", choices=["size", "drift"],
                    default=None,
                    help="maintenance job selection: 'size' ranks by "
                         "posting length alone; 'drift' ranks by the "
                         "Ada-IVF-style cost model over per-posting "
                         "access/update/drift telemetry (default: the "
                         "LireConfig default, 'size')")
    ap.add_argument("--threshold", type=int, default=1,
                    help="BacklogPolicy firing threshold")
    ap.add_argument("--shards", type=int, default=1,
                    help=">1: serve an N-shard index (every shard on the "
                         "one device)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="total index copies including the primary (>1: "
                         "read replicas fed by the async WAL replication "
                         "stream serve searches)")
    ap.add_argument("--device", default="cuda",
                    help="the device every shard and replica lives on "
                         "(default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--max-lag", type=int, default=64,
                    help="replica freshness bound in WAL seqnos: a search "
                         "falls back to the primary rather than land on a "
                         "replica lagging more than this")
    ap.add_argument("--probe-chunk", type=int, default=0,
                    help="oracle scan path: stream probes in chunks")
    ap.add_argument("--scan", choices=["oracle", "per_query", "batched"],
                    default="oracle",
                    help="posting-scan data path (per_query/batched = "
                         "the paged scan kernels; their plain versions on "
                         "the CPU)")
    ap.add_argument("--codec", choices=["fp32", "bf16", "int8"],
                    default=None,
                    help="hot-tier posting payload codec: int8 stores "
                         "per-posting scale/zero-point and dequantizes "
                         "inside the page scan (~4x fewer scan bytes); "
                         "bf16 halves them; lossy codecs keep a cold "
                         "exact fp32 tier for maintenance + rerank "
                         "(default: the LireConfig default, fp32)")
    ap.add_argument("--rerank-factor", type=int, default=None,
                    help="with a lossy codec: over-fetch N*k candidates "
                         "from the quantized scan and rerank them against "
                         "the exact fp32 tier before the final top-k "
                         "(1 = no rerank; default: LireConfig default)")
    args = ap.parse_args(argv)
    args.durable = args.durable or args.snapshot
    if args.recover and not args.durable:
        raise SystemExit("--recover needs --durable DIR")

    from repro_torch import api
    from repro_torch.data import UpdateWorkload

    spec = build_spec(args)
    maker = (UpdateWorkload.spacev if args.dataset == "spacev"
             else UpdateWorkload.sift)
    wl = maker(n=args.n, dim=args.dim, rate=args.rate, seed=0)

    if args.recover:
        service = api.open(spec, device=args.device)
        print(f"recovered service from {args.durable} "
              f"(wal_seqnos={service.backend.wal_seqnos()})")
    else:
        # fresh=True: without --recover the launcher always builds from
        # the workload — an existing durable root is superseded, never
        # silently recovered with the freshly built vectors discarded.
        vecs, _ = wl.live_vectors()
        service = api.open(spec, vectors=vecs, fresh=True, device=args.device)
        if service.durable:
            print(f"durable service at {args.durable} "
                  f"(checkpoint_every={args.checkpoint_every or 'exit-only'})")

    if args.shards > 1:
        # workload vid -> global (shard, slot) handle, kept current so
        # epoch deletes translate into sharded deletes.  After --recover
        # the pre-crash handle map is gone: epoch deletes are skipped and
        # the stream degrades to insert+search traffic.
        vid2h = {}
        if service.initial_handles is not None:
            _, base_ids = wl.live_vectors()
            vid2h = dict(zip(base_ids.tolist(),
                             service.initial_handles.tolist()))
        print(f"serving {args.n} vectors over {args.shards} shards on {args.device}")
        print("epoch  p99_ms postings splits deletes")
        for epoch in range(args.epochs):
            dv, iv, ii = wl.epoch()
            dh = [vid2h.pop(int(v)) for v in dv if int(v) in vid2h]
            service.delete(np.asarray(dh, np.int32))
            # sharded service assigns its own handles
            new_h, landed = service.insert(iv)
            vid2h.update(
                (int(v), int(h))
                for v, h, ok in zip(ii, new_h, landed) if ok
            )
            q, _gt = wl.queries(64)
            service.search(q)
            lat = service.engine.latency_percentiles("search")
            st = service.stats()
            print(f"{epoch:5d} {lat.get('p99_ms', 0):7.1f} "
                  f"{st['n_postings']:8d} {st['n_splits']:6d} "
                  f"{len(dh):7d}")
        service.drain()
        _print_report(service)
        service.close()
        return

    print("epoch recall@10 p99_ms postings splits reassigned")
    for epoch in range(args.epochs):
        dv, iv, ii = wl.epoch()
        service.delete(dv.astype(np.int32))
        service.insert(iv, ii.astype(np.int32))
        q, gt = wl.queries(64)
        _, got = service.search(q)
        hits = sum(len(set(g.tolist()) & set(o.tolist()))
                   for g, o in zip(gt, got))
        lat = service.engine.latency_percentiles("search")
        st = service.stats()
        print(f"{epoch:5d} {hits / (len(q) * 10):9.3f} "
              f"{lat.get('p99_ms', 0):6.1f} {st['n_postings']:8d} "
              f"{st['n_splits']:6d} {st['n_reassigned']:10d}")
    service.drain()
    _print_report(service)
    service.close()
    if service.durable:
        print(f"service checkpointed under {args.durable}")


if __name__ == "__main__":
    main()
