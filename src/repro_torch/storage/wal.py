"""Write-ahead log — paper §4.4 crash recovery (WAL half).

All update dispatches between two snapshots are appended to the WAL;
recovery replays the WAL on top of the latest snapshot.  Records are
length-prefixed msgpack maps with ``np.save`` payloads, fsync'd on every
``append`` (the paper's durability point is the SSD write; ours is the
fsync — a record is acknowledged only after ``os.fsync`` returns).

The record body is encoded here, without the ``msgpack`` package, for the
subset a record uses: a map with string keys, a non-negative integer
``seqno``, a string ``op`` and binary ``np.save`` bytes per array.  The
bytes equal ``msgpack.packb(obj, use_bin_type=True)`` (keys in insertion
order, every integer and length in its shortest form), so a log written by
either package reads in the other.

Group commit relaxes the per-append fsync without moving the ack point:
with a ``(group_commit_n, group_commit_ms)`` window set, ``append`` only
buffers (write + flush) and the fsync fires when the window fills, ages
out, or a caller forces ``sync()``.  Because the log is append-only, one
fsync covers every buffered record before it — a crash can only lose a
contiguous UNSYNCED tail, so the service acks a dispatch after the next
``sync()`` and replay determinism is preserved (the durable stream is
always a prefix of the dispatched stream).

``compact_wal_records`` is the replay-side compaction: insert rows whose
vids are deleted later in the same stream are masked out (and fully-dead
dispatch records dropped) before replay — the deletes themselves are kept
because they must still kill snapshot-resident versions.

Corruption policy: a *torn tail* (crash mid-append: short header, short
body, or garbage bytes where the final record should be — a multi-page
append may persist later pages without the first) is tolerated and treated
as "the last op was never acknowledged".  A bad-magic header FOLLOWED by a
complete decodable record is mid-file corruption of acknowledged data and
raises :class:`WalCorruptionError` instead of silently truncating the log
there.

``WalSet`` is the per-shard form: one log file per index shard.  Updates
are replicated to every shard, so the per-shard logs are replicas of one
global dispatch stream; recovery takes the longest cleanly-readable log as
authoritative and re-syncs the laggards.  The port's local backend uses
one log.
"""
from __future__ import annotations

import io
import os
import struct
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

_MAGIC = b"SPFW"
_HEADER = struct.Struct("<4sI")  # magic, payload length


class WalCorruptionError(RuntimeError):
    """Mid-file WAL corruption (bad magic on a fully-written header)."""


@dataclass
class WalRecord:
    op: str                      # "insert" | "delete" | "maintain" | "drain"
    payload: dict[str, np.ndarray]
    seqno: int


# ---------------------------------------------------------------------------
# The msgpack subset a record uses
# ---------------------------------------------------------------------------

def _pack_head(out: list[bytes], n: int, fix: tuple[int, int] | None,
               forms: tuple[tuple[int, int, str], ...]) -> None:
    """Append the head of a value: the length ``n`` of a map, string or
    binary, or an unsigned integer ``n`` itself — the fix form ``(tag,
    limit)`` when ``n`` fits it, else the first of ``forms`` (``(tag,
    limit, struct code)``) that holds ``n``."""
    if fix is not None and n < fix[1]:
        out.append(bytes([fix[0] | n]))
        return
    for tag, limit, code in forms:
        if n < limit:
            out.append(bytes([tag]) + struct.pack(">" + code, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(out: list[bytes], obj) -> None:
    if isinstance(obj, dict):
        _pack_head(out, len(obj), (0x80, 16),
                   ((0xDE, 1 << 16, "H"), (0xDF, 1 << 32, "I")))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"record map keys are strings, got {key!r}")
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_head(out, len(raw), (0xA0, 32),
                   ((0xD9, 1 << 8, "B"), (0xDA, 1 << 16, "H"), (0xDB, 1 << 32, "I")))
        out.append(raw)
    elif isinstance(obj, bytes):
        _pack_head(out, len(obj), None,
                   ((0xC4, 1 << 8, "B"), (0xC5, 1 << 16, "H"), (0xC6, 1 << 32, "I")))
        out.append(obj)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if obj < 0:
            raise ValueError(f"record integers are non-negative, got {obj}")
        _pack_head(out, obj, (0x00, 128),
                   ((0xCC, 1 << 8, "B"), (0xCD, 1 << 16, "H"), (0xCE, 1 << 32, "I"),
                    (0xCF, 1 << 64, "Q")))
    else:
        raise TypeError(f"no record encoding for {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the record subset."""
    out: list[bytes] = []
    _pack(out, obj)
    return b"".join(out)


# tag -> (kind, struct code of the length or integer that follows the tag)
_FIXED = {
    0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
    0xCC: ("int", "B"), 0xCD: ("int", "H"), 0xCE: ("int", "I"), 0xCF: ("int", "Q"),
    0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
    0xDE: ("map", "H"), 0xDF: ("map", "I"),
}


def _unpack(buf: bytes, pos: int):
    """``(object, next position)`` of the value at ``pos``."""
    tag = buf[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _FIXED:
        kind, code = _FIXED[tag]
        (n,) = struct.unpack_from(">" + code, buf, pos)
        pos += struct.calcsize(code)
        if kind == "int":
            return n, pos
    else:
        raise ValueError(f"msgpack tag 0x{tag:02x} is outside the record subset")
    if kind == "map":
        obj = {}
        for _ in range(n):
            key, pos = _unpack(buf, pos)
            if not isinstance(key, str):
                raise ValueError("record map key is not a string")
            obj[key], pos = _unpack(buf, pos)
        return obj, pos
    if pos + n > len(buf):
        raise ValueError("truncated msgpack value")
    raw = bytes(buf[pos:pos + n])
    return (raw.decode("utf-8") if kind == "str" else raw), pos + n


def unpackb(buf: bytes):
    """``msgpack.unpackb(buf, raw=False)`` for the record subset."""
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes after the msgpack value")
    return obj


def _encode(rec: WalRecord) -> bytes:
    arrays = {}
    for k, v in rec.payload.items():
        buf = io.BytesIO()
        np.save(buf, np.asarray(v), allow_pickle=False)
        arrays[k] = buf.getvalue()
    body = packb({"op": rec.op, "seqno": rec.seqno, "arrays": arrays})
    return _HEADER.pack(_MAGIC, len(body)) + body


def _decode(body: bytes) -> WalRecord:
    obj = unpackb(body)
    payload = {
        k: np.load(io.BytesIO(v), allow_pickle=False)
        for k, v in obj["arrays"].items()
    }
    return WalRecord(op=obj["op"], payload=payload, seqno=obj["seqno"])


class WriteAheadLog:
    """Append-only log; one per index shard."""

    def __init__(self, path: str, tail: tuple[int, int] | None = None):
        """``tail`` = precomputed ``(last seqno, clean end offset)`` from
        a caller that already scanned the file (WalSet's salvage pass) —
        skips the open-time rescan."""
        self.path = path
        self.n_fsyncs = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._seqno, clean_end = tail if tail is not None else self._scan_tail()
        if os.path.exists(path) and os.path.getsize(path) > clean_end:
            # Trim a torn tail so new appends don't land after garbage
            # (the reader stops at the tear and would lose them).
            with open(path, "r+b") as fh:
                fh.truncate(clean_end)
                fh.flush()
                os.fsync(fh.fileno())
        self._fh = open(path, "ab")

    def _scan_tail(self) -> tuple[int, int]:
        """(last seqno, byte offset of the end of the last clean record)."""
        last, end = -1, 0
        for rec, rec_end in _scan_records(self.path):
            last, end = rec.seqno, rec_end
        return last, end

    @property
    def next_seqno(self) -> int:
        return self._seqno + 1

    def append(self, op: str, payload: dict[str, np.ndarray]) -> int:
        self._seqno += 1
        rec = WalRecord(op=op, payload=payload, seqno=self._seqno)
        self.append_encoded(_encode(rec))
        return self._seqno

    def append_encoded(self, blob: bytes, *, sync: bool = True) -> None:
        """Durability point: the append is acknowledged only post-fsync.
        ``sync=False`` (group commit) defers the fsync to a later
        ``sync()`` — the record is written + flushed but NOT durable yet."""
        self._fh.write(blob)
        self._fh.flush()
        if sync:
            self.sync()

    def sync(self) -> None:
        """fsync the log file (the group-commit window boundary)."""
        os.fsync(self._fh.fileno())
        self.n_fsyncs += 1

    def truncate(self) -> None:
        """Called after a successful snapshot: the log restarts empty.
        Seqnos keep counting (they are global, not per-file offsets)."""
        self._fh.close()
        self._fh = open(self.path, "wb")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def rewrite(self, records: list[WalRecord]) -> None:
        """Replace the file contents with ``records`` (recovery re-sync of
        a lagging shard log to the authoritative stream)."""
        self._fh.close()
        _rewrite_log_file(self.path, records)
        self._seqno = records[-1].seqno if records else -1
        self._fh = open(self.path, "ab")

    def close(self) -> None:
        self._fh.close()


def _rest_holds_complete_record(blob: bytes) -> bool:
    """True if ``blob`` (bytes from a bad header onward) contains at
    least one complete, decodable record — i.e. the damage sits in FRONT
    of acknowledged data (corruption), not at the tail (a torn append)."""
    idx = blob.find(_MAGIC, 1)
    while idx != -1:
        if idx + _HEADER.size <= len(blob):
            _, length = _HEADER.unpack_from(blob, idx)
            if idx + _HEADER.size + length <= len(blob):
                try:
                    _decode(blob[idx + _HEADER.size:
                                 idx + _HEADER.size + length])
                    return True
                except Exception:  # noqa: BLE001 — any undecodable bytes
                    pass
        idx = blob.find(_MAGIC, idx + 1)
    return False


def _scan_records(path: str) -> Iterator[tuple[WalRecord, int]]:
    """Yield ``(record, end_offset)`` up to the first tear.  Raises
    :class:`WalCorruptionError` only when damage precedes a complete
    record (see module docstring for the torn-tail/corruption policy)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as fh:
        while True:
            head = fh.read(_HEADER.size)
            if len(head) < _HEADER.size:
                return  # EOF or torn header
            magic, length = _HEADER.unpack(head)
            if magic != _MAGIC:
                pos = fh.tell() - _HEADER.size
                if _rest_holds_complete_record(head + fh.read()):
                    raise WalCorruptionError(
                        f"{path}: bad record magic {magic!r} at offset "
                        f"{pos} with intact records after it"
                    )
                return  # garbage at the tail: a torn multi-page append
            body = fh.read(length)
            if len(body) < length:
                return  # torn write
            yield _decode(body), fh.tell()


def iter_wal(path: str, after_seqno: int = -1) -> Iterator[WalRecord]:
    """Replay iterator.  Tolerates a torn tail record (crash mid-append);
    raises :class:`WalCorruptionError` on mid-file damage."""
    for rec, _end in _scan_records(path):
        if rec.seqno > after_seqno:
            yield rec


def _salvage_scan(path: str) -> tuple[list[WalRecord], int, bool]:
    """``(records, clean end offset, corrupt)`` up to the first tear OR
    corruption; the flag is True only for mid-file corruption (a torn
    tail is normal crash debris)."""
    recs: list[WalRecord] = []
    end = 0
    try:
        for rec, rec_end in _scan_records(path):
            recs.append(rec)
            end = rec_end
        return recs, end, False
    except WalCorruptionError:
        return recs, end, True


def _rewrite_log_file(path: str, records: list[WalRecord]) -> None:
    with open(path, "wb") as fh:
        for rec in records:
            fh.write(_encode(rec))
        fh.flush()
        os.fsync(fh.fileno())


class WalSet:
    """Per-shard WALs behind one append/replay surface.

    ``append`` encodes the record once and fsyncs it into every shard's
    log.  ``recover_records`` scans all logs, takes the one with the
    longest cleanly-readable prefix as authoritative (a crash can tear
    different logs at different records), re-syncs the laggards, and
    returns the authoritative record list.

    ``set_group_commit(n, ms)`` arms the group-commit window: appends
    buffer (write + flush, no fsync) until ``n`` records are pending or
    the oldest pending record is ``ms`` old, then one ``sync()`` round
    fsyncs every shard log.  ``pending`` counts buffered-but-not-durable
    records; the service forces ``sync()`` before acknowledging updates.
    """

    def __init__(self, wal_dir: str, n_shards: int):
        self.wal_dir = wal_dir
        self.n_shards = n_shards
        self.n_appends = 0
        self.group_n = 0            # 0/1 = fsync every append
        self.group_ms = 0.0         # 0 = no age-out, count/force only
        self._pending = 0
        self._pending_since = 0.0
        os.makedirs(wal_dir, exist_ok=True)
        # Salvage pass: a mid-file-corrupt shard log is repaired from the
        # longest readable stream (the logs are replicas) instead of
        # bricking recovery.  Only if EVERY log is corrupt do we raise —
        # and then before rewriting anything, so the evidence survives.
        streams: list[list[WalRecord]] = []
        ends: list[int] = []
        corrupt: list[int] = []
        for i in range(n_shards):
            recs, end, bad = _salvage_scan(self.shard_path(i))
            streams.append(recs)
            ends.append(end)
            if bad:
                corrupt.append(i)
        if corrupt and len(corrupt) == n_shards:
            raise WalCorruptionError(
                f"{wal_dir}: all {n_shards} shard logs are corrupt "
                "(no clean replica to resync from)"
            )
        if corrupt:
            best = max(streams,
                       key=lambda recs: recs[-1].seqno if recs else -1)
            for i in corrupt:
                _rewrite_log_file(self.shard_path(i), best)
                streams[i] = list(best)
                ends[i] = os.path.getsize(self.shard_path(i))
        self.logs = [
            # the salvage pass already found each tail: no rescan
            WriteAheadLog(
                self.shard_path(i),
                tail=(streams[i][-1].seqno if streams[i] else -1, ends[i]),
            )
            for i in range(n_shards)
        ]
        # recover_records reuses this boot-time scan (one decode pass
        # over the recovery-critical path); invalidated by any append.
        self._boot_streams: list[list[WalRecord]] | None = streams

    def shard_path(self, shard: int) -> str:
        return os.path.join(self.wal_dir, f"shard_{shard:03d}.wal")

    @property
    def next_seqno(self) -> int:
        return max(log.next_seqno for log in self.logs)

    def last_seqnos(self) -> list[int]:
        """Last durable seqno per shard log (the snapshot manifest entry)."""
        return [log.next_seqno - 1 for log in self.logs]

    def set_group_commit(self, n: int, ms: float = 0.0) -> None:
        """Arm (n>1) or disarm (n<=1) the group-commit window."""
        self.group_n = int(n)
        self.group_ms = float(ms)

    @property
    def grouped(self) -> bool:
        return self.group_n > 1

    @property
    def pending(self) -> int:
        """Records written but not yet covered by an fsync."""
        return self._pending

    @property
    def n_fsyncs(self) -> int:
        """Total os.fsync calls across the shard logs' append/sync path."""
        return sum(log.n_fsyncs for log in self.logs)

    def append(self, op: str, payload: dict[str, np.ndarray]) -> int:
        seqno = self.next_seqno
        blob = _encode(WalRecord(op=op, payload=payload, seqno=seqno))
        self._boot_streams = None
        self.n_appends += 1
        for log in self.logs:
            log._seqno = seqno
            log.append_encoded(blob, sync=not self.grouped)
        if self.grouped:
            if self._pending == 0:
                self._pending_since = time.monotonic()
            self._pending += 1
            aged = (
                self.group_ms > 0
                and (time.monotonic() - self._pending_since) * 1e3
                >= self.group_ms
            )
            if self._pending >= self.group_n or aged:
                self.sync()
        return seqno

    def sync(self) -> None:
        """Force the group-commit window closed: one fsync round over all
        shard logs; every previously buffered record becomes durable (the
        ack point for the dispatches it covers).  No-op when clean."""
        if self._pending == 0:
            return
        for log in self.logs:
            log.sync()
        self._pending = 0

    def recover_records(self) -> list[WalRecord]:
        """Authoritative post-crash record stream (see class docstring)."""
        if self._boot_streams is not None:
            per_shard = self._boot_streams
        else:
            per_shard = [
                list(iter_wal(self.shard_path(i)))
                for i in range(self.n_shards)
            ]
        best = max(per_shard, key=lambda recs: recs[-1].seqno if recs else -1)
        for i, recs in enumerate(per_shard):
            have = recs[-1].seqno if recs else -1
            want = best[-1].seqno if best else -1
            if have != want:
                self.logs[i].rewrite(best)
        for log in self.logs:
            log._seqno = best[-1].seqno if best else -1
        return best

    def stats(self) -> dict:
        return {
            "appends": self.n_appends,
            "fsyncs": self.n_fsyncs,
            "pending": self._pending,
            "fsyncs_per_append": (
                self.n_fsyncs / self.n_appends if self.n_appends else 0.0
            ),
        }

    def ensure_seqno_floor(self, seqno: int) -> None:
        """Never hand out a seqno ≤ ``seqno`` again.  Recovery calls this
        with the snapshot's stamped seqno: the checkpoint truncated the
        logs, so a post-crash scan alone would restart numbering below
        the manifest and the NEXT recovery would skip those acknowledged
        records as already-applied."""
        for log in self.logs:
            log._seqno = max(log._seqno, seqno)

    def truncate(self) -> None:
        self._boot_streams = None
        self._pending = 0          # truncation supersedes buffered records
        for log in self.logs:
            log.truncate()

    def close(self) -> None:
        self.sync()                # buffered records stay durable
        for log in self.logs:
            log.close()


# ---------------------------------------------------------------------------
# Replay-side compaction
# ---------------------------------------------------------------------------

def compact_wal_records(
    records: list[WalRecord],
) -> tuple[list[WalRecord], int]:
    """Mask insert rows whose vid is deleted later in ``records`` (and
    drop dispatch records with no surviving rows); returns the compacted
    stream and the number of rows dropped.

    Only dispatch-level records participate (insert payloads with caller
    ``vids`` + ``valid`` masks); delete records are always kept — they
    must still kill versions resident in the snapshot the stream replays
    over.  Streams without ``vids`` (handle-assigning inserts) pass
    through untouched.

    Compaction preserves the recovered LIVE SET and the version map of
    every surviving vid exactly; it does NOT preserve the physical block
    layout bit-for-bit (a netted insert+delete pair's stale rows never
    land), so it is an opt-in recovery-speed knob
    (``DurabilitySpec.compact_wal``) rather than the default path.
    """
    last_del: dict[int, int] = {}
    for t, rec in enumerate(records):
        if rec.op == "delete" and "vids" in rec.payload:
            vids = np.asarray(rec.payload["vids"]).reshape(-1)
            valid = rec.payload.get("valid")
            mask = (np.ones(vids.shape[0], bool) if valid is None
                    else np.asarray(valid, bool).reshape(-1))
            for v in vids[mask & (vids >= 0)].tolist():
                last_del[int(v)] = t
    if not last_del:
        return list(records), 0
    out: list[WalRecord] = []
    dropped = 0
    for t, rec in enumerate(records):
        if (rec.op == "insert" and "vids" in rec.payload
                and "valid" in rec.payload):
            vids = np.asarray(rec.payload["vids"]).reshape(-1)
            mask = np.asarray(rec.payload["valid"], bool).reshape(-1)
            dead = mask & np.asarray(
                [last_del.get(int(v), -1) > t for v in vids]
            )
            if dead.any():
                dropped += int(dead.sum())
                mask = mask & ~dead
                if not mask.any():
                    continue           # the whole dispatch is dead rows
                payload = dict(rec.payload)
                payload["valid"] = mask
                rec = WalRecord(op=rec.op, payload=payload, seqno=rec.seqno)
        out.append(rec)
    return out, dropped
