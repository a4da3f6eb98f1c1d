"""The system under test: ``repro_torch.api.open`` on a configuration file,
and the harness's spans around the engine's calls into the protocol layer.

Nothing here changes what the program computes.  ``open_service`` turns
every section of a configuration file that the program's ``ServiceSpec``
has (``lire``, ``serve``, ``scan``, ``maintenance``, ``durability``,
``shards``) into that spec field by field, and refuses a key that neither
the spec nor the harness reads, so that no guarantee a file states goes
unserved.  It attaches a dispatch sink that only counts: without a
durable log or replicas the engine stamps a ticket's ``seqno`` from it,
which orders every search against every update that ran before it.

A durable configuration's relative ``root``, ``wal_dir`` and
``snapshot_dir`` lie under ``build/durable/<config name>/`` in the
checkout, emptied before each build: every run starts a fresh log.
"""
from __future__ import annotations

import shutil
import time
from pathlib import Path

# what the harness reads of a configuration file besides the spec's sections
HARNESS_KEYS = {"name", "source", "deployment", "reduced", "assumed", "precision",
                "guarantees", "data", "limits", "limit_notes"}
SPEC_KEYS = {"lire", "serve", "scan", "maintenance", "durability", "shards"}
DURABLE_PATHS = ("root", "wal_dir", "snapshot_dir")


class SeqnoSink:
    """A replication sink that keeps nothing: with it attached the backend
    numbers its update dispatches, and each ticket carries the number of
    the last one applied when it ran."""

    def publish(self, seqno, op, payload) -> None:
        pass


def durable_dir(cfg: dict, workdir: Path | None = None) -> Path:
    """Where a durable configuration's relative paths lie."""
    return Path(workdir or Path.cwd() / "build" / "durable") / cfg["name"]


def service_spec(cfg: dict, workdir: Path | None = None):
    """The program's ``ServiceSpec`` of a configuration file; a key that
    neither the spec nor the harness reads is refused."""
    from repro_torch import api
    from repro_torch.core.types import LireConfig

    unknown = set(cfg) - HARNESS_KEYS - SPEC_KEYS
    if unknown:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys {sorted(unknown)} "
                         "are neither the service spec's nor the harness's")
    dur = dict(cfg.get("durability") or {})
    for key in DURABLE_PATHS:
        if dur.get(key) and not Path(dur[key]).is_absolute():
            dur[key] = str(durable_dir(cfg, workdir) / dur[key])
    return api.ServiceSpec(
        index=api.IndexSpec(config=LireConfig(**cfg["lire"])),
        serve=api.ServeSpec(**cfg.get("serve", {})),
        scan=api.ScanSpec(**cfg.get("scan", {})),
        maintenance=api.MaintenanceSpec(**cfg.get("maintenance", {})),
        durability=api.DurabilitySpec(**dur),
        shards=api.ShardSpec(**cfg.get("shards", {})),
    )


def open_service(cfg: dict, base, seed: int, device: str, workdir: Path | None = None):
    """Build the configuration's service on ``base`` (the offline build)."""
    import dataclasses

    from repro_torch import api

    spec = service_spec(cfg, workdir)
    if spec.sharded:
        # the sharded backend hands out its own (shard, slot) handles, and
        # the generator and the check key every insert by the caller's vid
        raise NotImplementedError("a sharded configuration needs handles mapped to vids "
                                  "in the generator and the check")
    if spec.durability.enabled:
        shutil.rmtree(durable_dir(cfg, workdir), ignore_errors=True)
    spec = dataclasses.replace(spec, index=dataclasses.replace(spec.index, seed=seed))
    svc = api.open(spec, vectors=base, device=device, fresh=True)
    if svc.backend._repl_sink is None:
        svc.backend.attach_replication(SeqnoSink())
    return svc


def counters(svc) -> dict:
    """The engine's report and the index's stats, as plain numbers."""
    rep = svc.engine.report()
    return {"queue": dict(rep["queue"]), "maintenance": dict(rep["maintenance"]),
            "insert_retries": rep["insert_retries"], "insert_dropped": rep["insert_dropped"],
            "stats": svc.stats()}


class Spans:
    """Host-clock spans ``(name, start, end)`` on ``time.perf_counter``,
    kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end))

    def around(self, name: str, fn):
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.add(name, t0, time.perf_counter())


def record_dispatches(svc, spans: Spans, batches: list | None) -> None:
    """Span every call the engine makes into the backend (search dispatch,
    its readback wait, insert, delete, maintenance round); with
    ``batches`` also keep each dispatched search batch's time and a copy of
    its queries (the engine reuses its staging buffers)."""
    be = svc.backend

    def wrap(name, fn):
        def call(*a, **kw):
            return spans.around(name, lambda: fn(*a, **kw))
        return call

    begin = be.search_begin

    def search_begin(queries, k, nprobe, valid=None):
        if batches is not None:
            batches.append((time.perf_counter(), queries.copy(), nprobe))
        fin = spans.around("search_dispatch", lambda: begin(queries, k, nprobe, valid))
        return wrap("readback_wait", fin)

    be.search_begin = search_begin
    be.insert = wrap("insert_dispatch", be.insert)
    be.delete = wrap("delete_dispatch", be.delete)
    be.maintain = wrap("maintenance_round", be.maintain)
