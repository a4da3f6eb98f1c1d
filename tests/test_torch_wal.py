"""The port's write-ahead log against the reference's.

* A record's bytes: the port encodes the msgpack subset a record uses
  itself (no ``msgpack`` package); ``_encode`` must give the reference's
  bytes for every op the serving backend logs (``insert``, ``delete``,
  ``maintain`` with its ``access`` histogram, ``drain``), at seqnos on
  both sides of every msgpack integer width and payloads on both sides of
  the ``bin8`` / ``bin16`` / ``bin32`` limits.
* Each package reads the other's log, record for record.
* The reference's WAL cases (torn tail at every byte offset, mid-file
  corruption, garbage at the tail, reopen-trim, group commit, ``WalSet``
  resync and salvage, ``compact_wal_records``) run against both modules,
  as cases of one parametrised test each.
"""
import os
import struct

import numpy as np
import pytest

from repro.storage import wal as rwal
from repro_torch.storage import wal as twal

MODULES = pytest.mark.parametrize("wal", [twal, rwal], ids=["port", "reference"])

# seqnos on both sides of each msgpack integer width: fixint, uint8,
# uint16, uint32, uint64
SEQNOS = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63]


def _records(seqno: int):
    """One record per op the local backend logs, as (op, payload)."""
    rng = np.random.default_rng(seqno % 1000)
    return [
        ("insert", {"vecs": rng.normal(size=(8, 16)).astype(np.float32),
                    "vids": np.arange(8, dtype=np.int32),
                    "valid": np.arange(8) < 5}),
        ("delete", {"vids": np.asarray([3, -1], np.int32),
                    "valid": np.asarray([True, False])}),
        ("maintain", {"jobs": np.asarray(4, np.int32),
                      "access": rng.integers(0, 9, 128).astype(np.int32)}),
        ("drain", {"jobs": np.asarray(8, np.int32),
                   "access": np.zeros(128, np.int32)}),
    ]


@pytest.mark.parametrize("seqno", SEQNOS)
def test_encode_is_byte_identical_to_the_reference(seqno):
    for op, payload in _records(seqno):
        got = twal._encode(twal.WalRecord(op, payload, seqno))
        want = rwal._encode(rwal.WalRecord(op, payload, seqno))
        assert got == want, (op, seqno)
        back = twal._decode(got[8:])
        assert back.op == op and back.seqno == seqno
        for k, v in payload.items():
            np.testing.assert_array_equal(back.payload[k], v)
            assert back.payload[k].dtype == v.dtype


# np.save bytes of 0, 1,000 and 20,000 floats: bin8, bin16, bin32
@pytest.mark.parametrize("n,tag", [(0, 0xC4), (1000, 0xC5), (20_000, 0xC6)])
def test_encode_crosses_the_bin_widths(n, tag):
    payload = {"vecs": np.arange(n, dtype=np.float32)}
    got = twal._encode(twal.WalRecord("insert", payload, 300))
    assert got == rwal._encode(rwal.WalRecord("insert", payload, 300))
    # header, fixmap(3), "op", "insert", "seqno", uint16 300, "arrays",
    # fixmap(1), "vecs", then the bin tag
    assert got[8 + 1 + 3 + 7 + 6 + 3 + 7 + 1 + 5] == tag


@pytest.mark.parametrize("writer,reader", [(twal, rwal), (rwal, twal)],
                         ids=["port-writes", "reference-writes"])
def test_each_package_reads_the_others_log(tmp_path, writer, reader):
    path = str(tmp_path / "wal.log")
    log = writer.WriteAheadLog(path)
    sent = [r for s in (0, 1, 2) for r in _records(s)]
    for op, payload in sent:
        log.append(op, payload)
    log.close()
    got = list(reader.iter_wal(path))
    assert [r.seqno for r in got] == list(range(len(sent)))
    for rec, (op, payload) in zip(got, sent):
        assert rec.op == op
        assert list(rec.payload) == list(payload)
        for k, v in payload.items():
            np.testing.assert_array_equal(rec.payload[k], v)
    # and the reader appends to it where the writer stopped
    log = reader.WriteAheadLog(path)
    assert log.append("delete", {"vids": np.asarray([1], np.int32)}) == len(sent)
    log.close()
    assert [r.seqno for r in writer.iter_wal(path)] == list(range(len(sent) + 1))


def test_decoder_refuses_what_a_record_never_holds():
    with pytest.raises(ValueError):
        twal.unpackb(b"\xc0")                        # nil
    with pytest.raises(ValueError):
        twal.unpackb(twal.packb({"a": 1}) + b"\x00")  # trailing bytes
    with pytest.raises(ValueError):
        twal.unpackb(b"\xc4\x05abc")                  # truncated bin
    with pytest.raises(ValueError):
        twal.packb({"seqno": -1})


# ---------------------------------------------------------------------------
# the reference's WAL cases, against both modules
# ---------------------------------------------------------------------------

def _record_offsets(blob: bytes) -> list[int]:
    offsets, pos = [], 0
    while pos < len(blob):
        _, length = struct.unpack_from("<4sI", blob, pos)
        offsets.append(pos)
        pos += 8 + length
    return offsets


@MODULES
def test_wal_roundtrip_and_immediate_durability(tmp_path, wal):
    path = str(tmp_path / "wal.log")
    log = wal.WriteAheadLog(path)
    log.append("insert", {"vecs": np.ones((2, 4), np.float32), "vids": np.asarray([1, 2])})
    assert [r.seqno for r in wal.iter_wal(path)] == [0]   # a fresh fd sees it
    log.append("delete", {"vids": np.asarray([7])})
    log.close()
    recs = list(wal.iter_wal(path))
    assert [r.op for r in recs] == ["insert", "delete"]
    np.testing.assert_array_equal(recs[0].payload["vids"], [1, 2])
    assert [r.seqno for r in recs] == [0, 1]


@MODULES
def test_wal_torn_tail_at_every_byte_offset(tmp_path, wal):
    path = str(tmp_path / "wal.log")
    log = wal.WriteAheadLog(path)
    for i in range(3):
        log.append("insert", {"vecs": np.full((4, 8), i, np.float32),
                              "vids": np.arange(4, dtype=np.int32) + 10 * i})
    log.close()
    with open(path, "rb") as fh:
        blob = fh.read()
    last_start = _record_offsets(blob)[-1]
    trunc = str(tmp_path / "trunc.log")
    for cut in range(last_start, len(blob)):
        with open(trunc, "wb") as fh:
            fh.write(blob[:cut])
        assert [r.seqno for r in wal.iter_wal(trunc)] == [0, 1], f"cut at byte {cut}"
    assert [r.seqno for r in wal.iter_wal(path)] == [0, 1, 2]


@MODULES
def test_wal_midfile_magic_mismatch_raises(tmp_path, wal):
    path = str(tmp_path / "wal.log")
    log = wal.WriteAheadLog(path)
    for i in range(3):
        log.append("delete", {"vids": np.asarray([i])})
    log.close()
    with open(path, "rb") as fh:
        blob = bytearray(fh.read())
    mid = _record_offsets(bytes(blob))[1]
    blob[mid:mid + 4] = b"XXXX"
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(wal.WalCorruptionError):
        list(wal.iter_wal(path))
    with pytest.raises(wal.WalCorruptionError):
        wal.WriteAheadLog(path)


@MODULES
@pytest.mark.parametrize("tail", [b"\x00GARBAGE\x00" * 40, b"SPFW\x99\x00\x00\x00partial"],
                         ids=["garbage", "torn-record"])
def test_wal_reopen_trims_a_torn_tail_then_appends(tmp_path, wal, tail):
    path = str(tmp_path / "wal.log")
    log = wal.WriteAheadLog(path)
    log.append("delete", {"vids": np.asarray([1])})
    log.append("delete", {"vids": np.asarray([2])})
    log.close()
    size = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(tail)
    assert [r.seqno for r in wal.iter_wal(path)] == [0, 1]
    log = wal.WriteAheadLog(path)
    assert os.path.getsize(path) == size
    log.append("delete", {"vids": np.asarray([3])})
    log.close()
    assert [r.seqno for r in wal.iter_wal(path)] == [0, 1, 2]


@MODULES
def test_walset_resyncs_lagging_shard_logs(tmp_path, wal):
    ws = wal.WalSet(str(tmp_path / "wal"), 3)
    for i in range(4):
        ws.append("delete", {"vids": np.asarray([i])})
    ws.close()
    for shard, keep in ((1, 3), (2, 2)):
        path = ws.shard_path(shard)
        with open(path, "rb") as fh:
            blob = fh.read()
        with open(path, "wb") as fh:
            fh.write(blob[:_record_offsets(blob)[keep]])
    ws2 = wal.WalSet(str(tmp_path / "wal"), 3)
    assert [r.seqno for r in ws2.recover_records()] == [0, 1, 2, 3]
    assert ws2.last_seqnos() == [3, 3, 3]
    for shard in range(3):
        assert [r.seqno for r in wal.iter_wal(ws2.shard_path(shard))] == [0, 1, 2, 3]
    assert ws2.append("delete", {"vids": np.asarray([9])}) == 4
    ws2.close()


@MODULES
def test_walset_salvages_one_corrupt_log_and_refuses_all_corrupt(tmp_path, wal):
    ws = wal.WalSet(str(tmp_path / "wal"), 3)
    for i in range(4):
        ws.append("delete", {"vids": np.asarray([i])})
    ws.close()
    path1 = ws.shard_path(1)
    with open(path1, "rb") as fh:
        blob = bytearray(fh.read())
    mid = _record_offsets(bytes(blob))[1]
    blob[mid:mid + 4] = b"XXXX"
    with open(path1, "wb") as fh:
        fh.write(bytes(blob))
    ws2 = wal.WalSet(str(tmp_path / "wal"), 3)
    assert [r.seqno for r in ws2.recover_records()] == [0, 1, 2, 3]
    assert [r.seqno for r in wal.iter_wal(path1)] == [0, 1, 2, 3]
    ws2.close()
    ws3 = wal.WalSet(str(tmp_path / "wal1"), 1)
    ws3.append("delete", {"vids": np.asarray([0])})
    ws3.append("delete", {"vids": np.asarray([1])})
    ws3.close()
    p = ws3.shard_path(0)
    with open(p, "rb") as fh:
        blob = bytearray(fh.read())
    blob[0:4] = b"XXXX"
    with open(p, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(wal.WalCorruptionError):
        wal.WalSet(str(tmp_path / "wal1"), 1)


@MODULES
def test_wal_group_commit_batches_fsyncs(tmp_path, wal):
    ws = wal.WalSet(str(tmp_path / "wal"), 2)
    ws.set_group_commit(4)
    for i in range(10):
        ws.append("delete", {"vids": np.asarray([i])})
    assert ws.pending == 2 and ws.n_fsyncs == 2 * 2
    ws.sync()
    assert ws.pending == 0 and ws.n_fsyncs == 3 * 2
    ws.sync()
    assert ws.n_fsyncs == 3 * 2
    st = ws.stats()
    assert st["appends"] == 10 and st["fsyncs_per_append"] < 1.0
    assert [r.seqno for r in wal.iter_wal(ws.shard_path(0))] == list(range(10))
    ws.close()
    ws = wal.WalSet(str(tmp_path / "wal_off"), 1)
    for i in range(5):
        ws.append("delete", {"vids": np.asarray([i])})
    assert ws.pending == 0 and ws.n_fsyncs == 5
    ws.ensure_seqno_floor(20)
    assert ws.append("delete", {"vids": np.asarray([9])}) == 21
    ws.close()


@MODULES
def test_compact_wal_records(wal):
    def ins(seq, vids):
        vids = np.asarray(vids, np.int32)
        return wal.WalRecord("insert", {
            "vecs": np.zeros((len(vids), 4), np.float32), "vids": vids,
            "valid": np.ones(len(vids), bool)}, seq)

    def dele(seq, vids):
        vids = np.asarray(vids, np.int32)
        return wal.WalRecord("delete", {"vids": vids, "valid": np.ones(len(vids), bool)}, seq)

    recs = [ins(0, [1, 2, 3]), dele(1, [2]), ins(2, [4, 5]), dele(3, [4, 5]), ins(4, [2]),
            wal.WalRecord("maintain", {"jobs": np.asarray(4)}, 5)]
    out, dropped = wal.compact_wal_records(recs)
    assert dropped == 3
    assert [r.seqno for r in out] == [0, 1, 3, 4, 5]
    np.testing.assert_array_equal(out[0].payload["valid"], [True, False, True])
    np.testing.assert_array_equal(out[3].payload["valid"], [True])
    assert [r.op for r in out] == ["insert", "delete", "delete", "insert", "maintain"]
    handles = [wal.WalRecord("insert", {"vecs": np.zeros((2, 4), np.float32),
                                        "valid": np.ones(2, bool)}, 0),
               wal.WalRecord("delete", {"handles": np.asarray([3, 9])}, 1)]
    out, dropped = wal.compact_wal_records(handles)
    assert dropped == 0 and [r.seqno for r in out] == [0, 1]
