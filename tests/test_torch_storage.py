"""Port vs reference: state container, codec, version map, distance,
block-pool APPEND, pid alloc/free, and the state converter.

Inputs are made with numpy from a seed and go through both packages; the
port runs on the CPU (its plain PyTorch path).  Integer leaves must be
equal; every comparison here is exact unless a line says otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as rtypes
from repro.core.distance import masked_topk as r_masked_topk
from repro.core.distance import pairwise_sql2 as r_pairwise
from repro.storage import blockpool as rbp
from repro.storage import codec as rcodec
from repro.storage import versionmap as rvm
from repro_torch import convert
from repro_torch.core import types as ttypes
from repro_torch.core.distance import masked_topk, pairwise_sql2, stable_topk
from repro_torch.storage import blockpool as tbp
from repro_torch.storage import codec as tcodec
from repro_torch.storage import versionmap as tvm
from repro_torch.utils.tree import clone_state, tensor_leaves


# ---------------------------------------------------------------------------
# helpers shared by the test_torch_* files
# ---------------------------------------------------------------------------

def ref_leaves(obj) -> dict:
    """Reference pytree → ``{"pool.blocks": ndarray, ...}``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def to_np(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 as its uint16 bit pattern."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def port_leaves(obj) -> dict:
    return {name: to_np(x) for name, x in tensor_leaves(obj).items()}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_leaves_equal(port, ref, *, close=(), rtol=1e-5, atol=1e-5):
    """Every leaf equal (bf16 by bit pattern); leaves named in ``close``
    allclose instead, with the tolerance the caller states."""
    p, r = port_leaves(port), ref_leaves(ref)
    assert set(p) == set(r), (set(p) ^ set(r))
    for name in r:
        want = _bits(r[name])
        got = p[name]
        assert got.shape == want.shape, name
        if name in close:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8, 16), (1, 3, 4), (7, 1, 12)])
def test_codec_train_encode_decode_match(rng, shape):
    vecs = rng.normal(size=shape).astype(np.float32) * 3
    valid = rng.random(size=shape[:2]) < 0.7
    valid[0] = False                       # an empty posting
    rs, rz = rcodec.train_scale_zero(jnp.asarray(vecs), jnp.asarray(valid))
    ts, tz = tcodec.train_scale_zero(t(vecs), t(valid))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(rz))
    sc, zc = np.asarray(rs)[:, None, None], np.asarray(rz)[:, None, None]
    rcodes = rcodec.encode(jnp.asarray(vecs), sc, zc)
    tcodes = tcodec.encode(t(vecs), t(sc), t(zc))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(rcodes))
    np.testing.assert_array_equal(
        tcodec.decode(tcodes, t(sc), t(zc)).numpy(),
        np.asarray(rcodec.decode(rcodes, sc, zc)),
    )


@pytest.mark.parametrize("codec,vdtype", [
    ("fp32", "float32"), ("fp32", "int8"), ("bf16", "float32"), ("int8", "float32"),
])
def test_codec_payload_roundtrip_matches(rng, codec, vdtype):
    vecs = np.round(rng.normal(size=(6, 8)) * 20).astype(np.float32)
    scale, zero = np.float32(0.3), np.float32(-1.5)
    assert str(rcodec.payload_dtype(codec, vdtype)) == \
        str(tcodec.payload_dtype(codec, vdtype)).replace("torch.", "")
    rp = rcodec.encode_payload(codec, jnp.asarray(vecs), scale, zero,
                               rcodec.payload_dtype(codec, vdtype))
    tp = tcodec.encode_payload(codec, t(vecs), scale, zero,
                               tcodec.payload_dtype(codec, vdtype))
    np.testing.assert_array_equal(_bits(np.asarray(rp)), to_np(tp))
    np.testing.assert_array_equal(
        tcodec.decode_payload(codec, tp, scale, zero).numpy(),
        np.asarray(rcodec.decode_payload(codec, rp, scale, zero)),
    )
    assert tcodec.has_exact_tier(codec) == rcodec.has_exact_tier(codec)
    assert tcodec.is_quantized(codec) == rcodec.is_quantized(codec)


def test_codec_numpy_helpers_match(rng):
    rows = rng.normal(size=(9, 8)).astype(np.float32)
    assert tcodec.np_train_scale_zero(rows) == rcodec.np_train_scale_zero(rows)
    assert tcodec.np_train_scale_zero(rows[:0]) == rcodec.np_train_scale_zero(rows[:0])
    s, z = rcodec.np_train_scale_zero(rows)
    np.testing.assert_array_equal(tcodec.np_encode(rows, s, z), rcodec.np_encode(rows, s, z))


# ---------------------------------------------------------------------------
# version map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["bump_version", "mark_deleted", "clear"])
def test_versionmap_updates_match(rng, op):
    versions = rng.integers(0, 256, size=33).astype(np.uint8)
    vids = np.array([0, 3, 3, 7, -1, 31, 12, 0], np.int32)
    enable = np.array([False, True, True, True, True, True, False, True])
    want = getattr(rvm, op)(jnp.asarray(versions), jnp.asarray(vids), jnp.asarray(enable))
    got = getattr(tvm, op)(t(versions), t(vids), t(enable))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the scratch slot absorbs the disabled rows; vid 0 only sees row 7
    want2 = getattr(rvm, op)(jnp.asarray(versions), jnp.asarray(vids), None)
    got2 = getattr(tvm, op)(t(versions), t(vids), None)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def test_versionmap_queries_match(rng):
    versions = rng.integers(0, 256, size=33).astype(np.uint8)
    vids = rng.integers(-1, 32, size=40).astype(np.int32)
    stored = rng.integers(0, 256, size=40).astype(np.uint8)
    np.testing.assert_array_equal(
        tvm.is_stale(t(versions), t(vids), t(stored)).numpy(),
        np.asarray(rvm.is_stale(jnp.asarray(versions), jnp.asarray(vids), jnp.asarray(stored))),
    )
    np.testing.assert_array_equal(
        tvm.current_version(t(versions), t(vids)).numpy(),
        np.asarray(rvm.current_version(jnp.asarray(versions), jnp.asarray(vids))),
    )
    ok = np.clip(vids, 0, None)
    np.testing.assert_array_equal(
        tvm.is_deleted(t(versions), t(ok)).numpy(),
        np.asarray(rvm.is_deleted(jnp.asarray(versions), jnp.asarray(ok))),
    )


# ---------------------------------------------------------------------------
# distance
# ---------------------------------------------------------------------------

def test_pairwise_sql2_matches(rng):
    q = rng.normal(size=(7, 16)).astype(np.float32)
    x = rng.normal(size=(11, 16)).astype(np.float32)
    # f32 expansion: both sides sum 16 products in a different order
    np.testing.assert_allclose(
        pairwise_sql2(t(q), t(x)).numpy(), np.asarray(r_pairwise(q, x)),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("k", [1, 4, 9])
def test_masked_topk_lowest_index_first_on_ties(rng, k):
    # integer-valued distances: many exact ties, the tie-break decides
    d = rng.integers(0, 4, size=(6, 20)).astype(np.float32)
    valid = rng.random(size=(6, 20)) < 0.8
    rd, ri = r_masked_topk(jnp.asarray(d), jnp.asarray(valid), k)
    td, ti = masked_topk(t(d), t(valid), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    vals, idx = stable_topk(t(d), k, largest=True)
    rv, rix = jax.lax.top_k(jnp.asarray(d), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(rix))


# ---------------------------------------------------------------------------
# block pool APPEND
# ---------------------------------------------------------------------------

def _pools(codec="fp32", dtype="float32", **kw):
    args = dict(num_blocks=12, block_size=4, dim=8, num_postings_cap=6,
                max_blocks_per_posting=3)
    args.update(kw)
    ref = rbp.make_block_pool(**args, dtype=jnp.dtype(dtype), codec=codec)
    port = tbp.make_block_pool(**args, dtype=dtype, codec=codec, device="cpu")
    return ref, port


def _append_case(rng, case, n=40):
    pids = rng.integers(0, 6, size=n).astype(np.int32)
    enable = rng.random(size=n) < 0.85
    if case == "collide":
        pids[:] = rng.integers(0, 2, size=n)           # two hot postings
    elif case == "full":
        pids[:20] = 3                                  # > capacity 12
    elif case == "oom":
        pids[:] = np.arange(n) % 6                     # 6 postings x 3 blocks > 12
    vecs = np.round(rng.normal(size=(n, 8)) * 30).astype(np.float32)
    vids = rng.integers(0, 1000, size=n).astype(np.int32)
    vers = rng.integers(0, 128, size=n).astype(np.uint8)
    return pids, vecs, vids, vers, enable


@pytest.mark.parametrize("case", ["collide", "full", "disabled", "oom"])
@pytest.mark.parametrize("codec,dtype", [("fp32", "float32"), ("fp32", "int8"),
                                         ("bf16", "float32"), ("int8", "float32")])
def test_append_batch_bit_equal(rng, case, codec, dtype):
    ref, port = _pools(codec, dtype)
    for step in range(2):                  # second batch appends to tails
        args = _append_case(rng, case)
        ref, rok = rbp.append_batch(ref, *(jnp.asarray(a) for a in args))
        port, tok = tbp.append_batch(port, *(t(a) for a in args))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
        assert_leaves_equal(port, ref)
    if case == "oom":
        assert int(port.free_top) == 0 and not tok.numpy().all()


def test_parallel_get_hot_matches(rng):
    ref, port = _pools("int8")
    args = _append_case(rng, "collide")
    ref, _ = rbp.append_batch(ref, *(jnp.asarray(a) for a in args))
    port, _ = tbp.append_batch(port, *(t(a) for a in args))
    pids = np.array([0, 1, 2, 5], np.int32)
    want = rbp.parallel_get_hot(ref, jnp.asarray(pids))
    got = tbp.parallel_get_hot(port, t(pids))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = tbp.gather_posting_hot(port, t(np.int32(1)))
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(want[0][1]))


def test_clear_dirty_and_used_blocks(rng):
    _, port = _pools()
    port, _ = tbp.append_batch(port, *(t(a) for a in _append_case(rng, "collide")))
    assert bool(port.dirty.any())
    assert not bool(tbp.clear_dirty(port).dirty.any())
    assert int(tbp.used_blocks(port)) == port.num_blocks_cap - int(port.free_top)


# ---------------------------------------------------------------------------
# index state, pid alloc/free, converter
# ---------------------------------------------------------------------------

def _small_cfg(**kw):
    args = dict(dim=8, block_size=4, max_blocks_per_posting=3, num_blocks=24,
                num_postings_cap=10, num_vectors_cap=64, split_limit=10,
                merge_limit=3, replica_count=2, nprobe=3)
    args.update(kw)
    return args


@pytest.mark.parametrize("codec", ["fp32", "bf16"])
def test_empty_state_and_converter_roundtrip(codec):
    kw = _small_cfg(codec=codec)
    ref = rtypes.make_empty_state(rtypes.LireConfig(**kw), seed=7)
    port = ttypes.make_empty_state(ttypes.LireConfig(**kw), seed=7, device="cpu")
    assert_leaves_equal(port, ref)
    back = convert.state_from_numpy(ttypes.LireConfig(**kw), ref_leaves(ref), device="cpu")
    assert_leaves_equal(back, ref)
    again = convert.state_to_numpy(back)
    for name, arr in ref_leaves(ref).items():
        np.testing.assert_array_equal(again[name], _bits(arr))
    assert int(back.n_postings) == int(ref.n_postings)


def test_config_fields_and_validation_match():
    rf = {f.name: f.default for f in dataclasses.fields(rtypes.LireConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttypes.LireConfig)}
    assert rf == tf
    with pytest.raises(ValueError):
        ttypes.LireConfig(split_limit=500).validate()


def test_pid_alloc_free_and_centroids_match(rng):
    kw = _small_cfg()
    ref = rtypes.make_empty_state(rtypes.LireConfig(**kw))
    port = ttypes.make_empty_state(ttypes.LireConfig(**kw), device="cpu")
    en = np.array([True, False, True, True])
    ref, rp = rtypes.alloc_pids(ref, jnp.asarray(en))
    port, tp = ttypes.alloc_pids(port, t(en))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
    cen = rng.normal(size=(4, 8)).astype(np.float32)
    ref = rtypes.set_centroids(ref, rp, jnp.asarray(cen), jnp.asarray(en))
    port = ttypes.set_centroids(port, tp, t(cen), t(en))
    fen = np.array([True, True, False, True])
    ref = rtypes.free_pids(ref, rp, jnp.asarray(fen))
    port = ttypes.free_pids(port, tp, t(fen))
    ref = ref.replace(stats=rtypes.bump_stat(ref.stats, "n_splits", 3))
    port = port.replace(stats=ttypes.bump_stat(port.stats, "n_splits", 3))
    # centroid_sqn: a 8-term f32 sum in two summation orders
    assert_leaves_equal(port, ref, close=("centroid_sqn",), rtol=1e-6, atol=1e-6)


def test_clone_state_is_independent():
    port = ttypes.make_empty_state(ttypes.LireConfig(**_small_cfg()), device="cpu")
    twin = clone_state(port)
    twin.pool.posting_len[0] = 5
    assert int(port.pool.posting_len[0]) == 0


# ---------------------------------------------------------------------------
# block pool: the maintenance round's write and read paths
# ---------------------------------------------------------------------------

def _filled_pools(rng, codec="fp32", dtype="float32", **kw):
    """A reference pool and its port twin after the same two appends."""
    ref, port = _pools(codec, dtype, **kw)
    for _ in range(2):
        args = _append_case(rng, "collide", n=16)
        args[0][:] = rng.integers(0, 4, size=16)       # postings 4, 5 stay empty
        ref, _ = rbp.append_batch(ref, *(jnp.asarray(a) for a in args))
        port, _ = tbp.append_batch(port, *(t(a) for a in args))
    return ref, port


def _put_args(rng, k, cap, d, ns):
    vecs = np.round(rng.normal(size=(k, cap, d)) * 30).astype(np.float32)
    vids = rng.integers(0, 1000, size=(k, cap)).astype(np.int32)
    vers = rng.integers(0, 128, size=(k, cap)).astype(np.uint8)
    return vecs, vids, vers, np.asarray(ns, np.int32)


def _port_op(op, port, *args, inplace=False):
    out = getattr(tbp, op)(port, *(t(a) for a in args), inplace=inplace)
    return out if isinstance(out, tuple) else (out, None)


def _check_op(op, ref, port, *args):
    """The port's ``op`` against the reference's on the same inputs, and
    its in-place form against its functional form."""
    want = getattr(rbp, op)(ref, *(jnp.asarray(a) for a in args))
    want, want_ok = want if isinstance(want, tuple) else (want, None)
    before = port_leaves(port)
    got, ok = _port_op(op, port, *args)
    for name, arr in port_leaves(port).items():          # input untouched
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    assert_leaves_equal(got, want)
    if want_ok is not None:
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    owned = clone_state(port)
    got2, ok2 = _port_op(op, owned, *args, inplace=True)
    assert got2.block_vid is owned.block_vid                 # written in place
    assert_leaves_equal(got2, want)
    if want_ok is not None:
        np.testing.assert_array_equal(ok2.numpy(), ok.numpy())
    return got, want


CODEC_CASES = [("fp32", "float32"), ("fp32", "int8"), ("bf16", "float32"), ("int8", "float32")]


@pytest.mark.parametrize("case", ["collide", "full", "oom"])
@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_append_scatter_bit_equal(rng, case, codec, dtype):
    ref, port = _filled_pools(rng, codec, dtype)
    args = _append_case(rng, case, n=24)
    got, _ = _check_op("append_scatter", ref, port, *args)
    if case != "oom":
        # without pool OOM the scatter lands what the sequential APPEND lands
        seq, ok = tbp.append_batch(port, *(t(a) for a in args))
        assert_leaves_equal(got, rbp.append_batch(ref, *(jnp.asarray(a) for a in args))[0])
        assert_leaves_equal(seq, rbp.append_scatter(ref, *(jnp.asarray(a) for a in args))[0])


def test_append_scatter_under_oom_fails_fresh_blocks_as_a_group(rng):
    ref, port = _pools(num_blocks=3)
    n = 14                                               # 3 blocks of 4 for 5 postings
    pids = np.arange(n) % 5
    args = (pids.astype(np.int32), np.ones((n, 8), np.float32),
            np.arange(n, dtype=np.int32), np.zeros(n, np.uint8), np.ones(n, bool))
    got, _ = _check_op("append_scatter", ref, port, *args)
    assert int(got.free_top) == 3 and int(got.posting_len.sum()) == 0


@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_append_one_bit_equal(rng, codec, dtype):
    ref, port = _filled_pools(rng, codec, dtype)
    for pid, en in [(4, True), (4, True), (1, False), (0, True)]:
        vec = np.round(rng.normal(size=8) * 30).astype(np.float32)
        args = (np.int32(pid), vec, np.int32(rng.integers(1000)), np.uint8(3), en)
        ref, rok = rbp.append_one(ref, *(jnp.asarray(a) for a in args))
        port, tok = tbp.append_one(port, *(t(a) for a in args))
        assert bool(tok) == bool(rok)
        assert_leaves_equal(port, ref)


@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_free_postings_and_free_posting_bit_equal(rng, codec, dtype):
    ref, port = _filled_pools(rng, codec, dtype)
    pids = np.array([2, -1, 0, 4], np.int32)
    enable = np.array([True, True, False, True])
    port2, ref2 = _check_op("free_postings", ref, port, pids, enable)
    _check_op("free_posting", ref2, port2, np.int32(1), np.bool_(True))
    _check_op("free_posting", ref2, port2, np.int32(3), np.bool_(False))


@pytest.mark.parametrize("codec,dtype", CODEC_CASES)
def test_put_postings_and_put_posting_bit_equal(rng, codec, dtype):
    ref, port = _filled_pools(rng, codec, dtype)
    cap = port.posting_capacity
    vecs, vids, vers, ns = _put_args(rng, 3, cap, 8, [7, 0, 12])
    pids = np.array([0, 2, 5], np.int32)
    port2, ref2 = _check_op("put_postings", ref, port, pids, vecs, vids, vers, ns,
                            np.array([True, True, True]))
    vecs1, vids1, vers1, _ = _put_args(rng, 1, cap, 8, [5])
    for pid, n, en in [(1, 5, True), (3, 9, False), (4, 12, True)]:
        port2, ref2 = _check_op("put_posting", ref2, port2, np.int32(pid), vecs1[0],
                                vids1[0], vers1[0], np.int32(n), np.bool_(en))


def test_put_postings_pool_oom_fails_cleanly(rng):
    ref, port = _pools(num_blocks=4)
    vecs, vids, vers, ns = _put_args(rng, 3, port.posting_capacity, 8, [8, 8, 4])
    got, _ = _check_op("put_postings", ref, port, np.array([0, 1, 2], np.int32),
                       vecs, vids, vers, ns, np.ones(3, bool))
    # 2 + 2 blocks land, the third row finds the pool dry and stays empty
    assert got.posting_len.tolist()[:3] == [8, 8, 0] and int(got.free_top) == 0
    got, _ = _check_op("put_posting", ref, port, np.int32(1), vecs[0], vids[0],
                       vers[0], np.int32(12), np.bool_(True))
    assert int(got.posting_len[1]) == 12
    port2, ref2 = _check_op("put_postings", ref, port, np.array([0], np.int32), vecs[:1],
                            vids[:1], vers[:1], np.array([12], np.int32), np.ones(1, bool))
    full, _ = _check_op("put_posting", ref2, port2, np.int32(1), vecs[1], vids[1],
                        vers[1], np.int32(8), np.bool_(True))
    assert int(full.posting_len[1]) == 0                 # OOM: left empty


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_gather_paths_match(rng, codec):
    ref, port = _filled_pools(rng, codec)
    pids = np.array([0, 3, 4, -1], np.int32)
    for fn, arg in [("gather_postings", pids), ("parallel_get", np.maximum(pids, 0)),
                    ("gather_posting", np.int32(3)), ("gather_posting_ids", np.int32(1))]:
        want = getattr(rbp, fn)(ref, jnp.asarray(arg))
        got = getattr(tbp, fn)(port, t(arg))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(to_np(g), np.asarray(w), err_msg=fn)
    ids = tbp.gather_posting_ids(port, t(np.array([1, 2], np.int32)))
    one = tbp.gather_posting_ids(port, t(np.int32(2)))
    for a, b in zip(ids, one):
        np.testing.assert_array_equal(a[1].numpy(), b.numpy())


def test_single_pid_forms_match_reference_and_batched(rng):
    kw = _small_cfg()
    ref = rtypes.make_empty_state(rtypes.LireConfig(**kw))
    port = ttypes.make_empty_state(ttypes.LireConfig(**kw), device="cpu")
    batched = port
    cen = rng.normal(size=(3, 8)).astype(np.float32)
    for j, en in enumerate([True, False, True]):
        ref, rp = rtypes.alloc_pid(ref, jnp.asarray(en))
        port, tp = ttypes.alloc_pid(port, en)
        assert int(tp) == int(rp)
        ref = rtypes.set_centroid(ref, rp, jnp.asarray(cen[j]), jnp.asarray(en))
        port = ttypes.set_centroid(port, tp, t(cen[j]), en)
    ref = rtypes.free_pid(ref, jnp.asarray(9), jnp.asarray(True))
    port = ttypes.free_pid(port, 9, True)
    ref = rtypes.free_pid(ref, jnp.asarray(8), jnp.asarray(False))
    port = ttypes.free_pid(port, 8, False)
    # centroid_sqn: an 8-term f32 sum in two summation orders
    assert_leaves_equal(port, ref, close=("centroid_sqn",), rtol=1e-6, atol=1e-6)
    en = t(np.array([True, False, True]))
    batched, bp_ = ttypes.alloc_pids(batched, en)
    batched = ttypes.set_centroids(batched, bp_, t(cen), en)
    batched = ttypes.free_pids(batched, t(np.array([9, 8], np.int32)), t(np.array([True, False])))
    for name, arr in port_leaves(batched).items():
        np.testing.assert_array_equal(arr, port_leaves(port)[name], err_msg=name)


def test_masked_set_gives_one_value_per_location():
    from repro_torch.utils.scatter import masked_set_

    x = torch.arange(6, dtype=torch.float32)
    masked_set_(x, t(np.array([1, 1, 4, 0])), t(np.array([10., 20., 40., 50.])),
                t(np.array([False, True, True, False])))
    assert x.tolist() == [0, 20, 2, 3, 40, 5]
    masked_set_(x, t(np.array([2, 3])), 7.0, t(np.array([False, False])))
    assert x.tolist() == [0, 20, 2, 3, 40, 5]            # none enabled: unchanged
    y = torch.zeros((3, 2, 2), dtype=torch.int32)
    masked_set_(y, (t(np.array([0, 2])), t(np.array([1, 0]))), t(np.array([[1, 2], [3, 4]])),
                t(np.array([True, True])))
    assert y[0, 1].tolist() == [1, 2] and y[2, 0].tolist() == [3, 4] and int(y.sum()) == 10
