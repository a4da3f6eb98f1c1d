"""The port's dry run against the reference's, on the CPU.

* Spec parity: every ported cell's ``in_shardings`` (and the LM serving
  cells' ``out_shardings``), single- and multi-pod, entry for entry against
  the reference's ``PartitionSpec``s; a parameter spec is held through the
  ``convert.param_leaves`` paths, a transposed leaf's entries swapped back.
* Input parity: ``input_specs()`` shapes and dtypes against the
  reference's, leaf for leaf.
* Counts: ``model_flops`` of the 20 LM cells; the ``meta`` parameter (and
  index state) bytes of every arch against ``jax.eval_shape`` of the
  reference's init; ``FlopCounterMode`` on a 2-layer LM against a hand
  count of its products; each kernel's ``meta`` count against its formula.
* A twin of ``tests/test_dryrun_mini.py``, in process: deepfm
  ``serve_p99`` through ``run_cell``, a ``long_500k`` skip, ``--list``
  against the reference's registry rows (46; the reference's ``dryrun``
  module sets ``XLA_FLAGS`` when imported, so its ``list_cells`` body is
  read from ``repro.configs``), the driver's resumption, the report.
* Index-cell parity at ``SMOKE``: each of the six index cells' steps
  against the reference's steps on a 1 × 1 mesh (``make_search_step``,
  ``make_insert_step``, ``make_maintenance_round``; for
  ``retrieval_cand_ann`` the body of the reference's step, its user tower
  then its search step at nprobe 16, at the smoke widths).  States cross
  through ``convert.sharded_state_from_numpy``.  Ids and handles must be
  equal; distances within ``atol 1e-4 + rtol 1e-5``; after the round the
  reference's split draw is injected through ``draw=`` and the leaves are
  held as in ``test_torch_sharded.py`` (integers exact; the 2-means
  centroids and what is summed from them ``rtol = atol = 1e-5``).
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import all_cells as ref_all_cells
from repro.configs import get_cell as ref_cell
from repro_torch import configs as C
from repro_torch import convert
from repro_torch.convert import param_leaves
from repro_torch.distributed import sharding as S
from repro_torch.kernels import work
from repro_torch.launch import dryrun, mesh as M, roofline
from repro_torch.models import transformer as tf
from tests.test_torch_sharded import FLOAT_CLOSE, ROUND_CLOSE, make_clustered, ref_draw

ATOL, RTOL = 1e-4, 1e-5
SPEC_CELLS = [c for c in C.all_cells() if c.make_mesh_step is None]
LM_CELLS = [c for c in C.all_cells() if c.family == "lm"]


_INPUTS: dict = {}


def inputs_of(cell):
    """``cell.input_specs()``, made once a cell for the tests that read it."""
    if cell.name not in _INPUTS:
        _INPUTS[cell.name] = cell.input_specs()
    return _INPUTS[cell.name]


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one thread is faster than a pool's hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# flattening both packages' trees to {path: leaf}
# ---------------------------------------------------------------------------

def _key(k):
    if isinstance(k, jax.tree_util.DictKey):
        return k.key
    if isinstance(k, jax.tree_util.SequenceKey):
        return k.idx
    return k.name


def ref_flat(tree) -> dict:
    """A reference tree of specs or abstract arrays as ``{path: leaf}``,
    specs as tuples (``None`` kept as a leaf)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)
    return {tuple(_key(k) for k in path): (tuple(v) if isinstance(v, P) else v)
            for path, v in flat}


def port_flat(arg, spec=None, prefix=()) -> dict:
    """The port's argument (``spec is None``: its tensors, in the
    reference's orientation) or specs (in the argument's structure) as
    ``{path: leaf}``, a model's leaves and an AdamW moment list under their
    parameter paths, a transposed leaf's shape or spec flipped back."""
    out = {}
    if isinstance(arg, torch.nn.Module):
        for path, t, tr in param_leaves(arg):
            leaf = t if spec is None else spec[path]
            if tr:
                leaf = t.T if spec is None else tuple(reversed(leaf))
            out[prefix + path] = leaf
    elif isinstance(arg, dict):
        for k, v in arg.items():
            out.update(port_flat(v, None if spec is None else spec[k], prefix + (k,)))
    elif isinstance(arg, torch.Tensor):
        out[prefix] = arg if spec is None else spec
    else:
        raise TypeError(type(arg))
    return out


def port_args_flat(args, specs=None) -> dict:
    """The step's arguments (and, given, their specs) as ``{(position, *path):
    leaf}``; an AdamW state's moments sit under the parameters' paths."""
    out = {}
    params = args[0]
    for i, a in enumerate(args):
        s = None if specs is None else specs[i]
        if isinstance(a, dict) and isinstance(a.get("m"), list):
            leaves = param_leaves(params)
            for name in ("m", "v"):
                for j, (path, _, tr) in enumerate(leaves):
                    if specs is None:
                        leaf = a[name][j].T if tr else a[name][j]
                    else:
                        leaf = tuple(reversed(s[name][j])) if tr else s[name][j]
                    out[(i, name) + path] = leaf
            out[(i, "count")] = a["count"] if specs is None else s["count"]
        else:
            out.update({(i, *p): v for p, v in port_flat(a, s).items()})
    return out


def ref_args_flat(tree) -> dict:
    return {(i, *p): v for i, t in enumerate(tree) for p, v in ref_flat(t).items()}


def spec_flat(tree, prefix=()) -> dict:
    """A port spec tree of dicts as ``{path: spec}``."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in spec_flat(v, prefix + (k,)).items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# spec parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("cell", SPEC_CELLS, ids=lambda c: c.name)
def test_in_shardings_equal_the_reference(cell, multi_pod):
    ref = ref_cell(cell.arch, cell.shape)
    args = inputs_of(cell)
    got = port_args_flat(args, cell.in_shardings(multi_pod))
    want = ref_args_flat(ref.in_shardings(multi_pod))
    assert got == want
    if cell.out_shardings is not None:
        got = {(i, *p): s for i, t in enumerate(cell.out_shardings(multi_pod))
               for p, s in spec_flat(t).items()}
        assert got == ref_args_flat(ref.out_shardings(multi_pod))
    else:
        assert ref.out_shardings is None


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_and_opt_state_specs_equal_the_reference(multi_pod):
    from repro.distributed import sharding as RS

    assert spec_flat(S.lm_cache_specs(multi_pod)) == ref_flat(RS.lm_cache_specs(multi_pod))
    assert S.data_axes(multi_pod) == RS.data_axes(multi_pod)
    for kind in ("train", "prefill", "decode"):
        assert spec_flat(S.lm_batch_specs(kind, multi_pod=multi_pod)) == ref_flat(
            RS.lm_batch_specs(kind, multi_pod=multi_pod))
    cell = C.get_cell("granite-moe-1b-a400m", "train_4k")
    ps = S.lm_param_specs(cell.model_cfg, multi_pod=multi_pod)
    opt = S.opt_state_specs(ps)
    want = ref_flat(RS.opt_state_specs(RS.lm_param_specs(cell.model_cfg, multi_pod=multi_pod)))
    got = {("count",): opt["count"]}
    for name in ("m", "v"):
        got.update({(name, *p): s for p, s in zip(sorted(ps), opt[name])})
    assert got == want


# ---------------------------------------------------------------------------
# input parity
# ---------------------------------------------------------------------------

def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.dtype(x.dtype).name


@pytest.mark.parametrize("cell", SPEC_CELLS, ids=lambda c: c.name)
def test_input_specs_equal_the_reference(cell):
    args = inputs_of(cell)
    assert all(t.device.type == "meta" for t in port_args_flat(args).values())
    got = {p: (tuple(t.shape), _dtype_name(t)) for p, t in port_args_flat(args).items()}
    want = {p: (tuple(s.shape), _dtype_name(s))
            for p, s in ref_args_flat(ref_cell(cell.arch, cell.shape).input_specs()).items()}
    assert got == want


# ---------------------------------------------------------------------------
# counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", LM_CELLS, ids=lambda c: c.name)
def test_model_flops_equal_the_reference(cell):
    from repro.launch.roofline import model_flops as ref_model_flops

    assert roofline.model_flops(cell) == ref_model_flops(ref_cell(cell.arch, cell.shape)) > 0


def _arch_cells():
    out = {}
    for c in C.all_cells():
        out.setdefault(c.arch, c)
    return list(out.values())


def _nbytes(leaves) -> int:
    return sum(math.prod(x.shape) * (x.element_size() if isinstance(x, torch.Tensor)
                                     else np.dtype(x.dtype).itemsize) for x in leaves)


@pytest.mark.parametrize("cell", _arch_cells(), ids=lambda c: c.arch)
def test_meta_param_bytes_equal_the_reference(cell):
    """The parameters (the index: one shard's state) on ``meta`` against
    ``jax.eval_shape`` of the reference's init, in bytes and leaf count."""
    if cell.family == "index":
        from repro.core.types import make_empty_state as ref_empty
        from repro_torch.utils.tree import tensor_leaves

        _, args, _ = cell.make_mesh_step(M.mesh_for("card"), False)
        got = list(tensor_leaves(args[0][0]).values())
        want = jax.tree_util.tree_leaves(jax.eval_shape(lambda: ref_empty(cell.model_cfg)))
    elif cell.make_mesh_step is not None:         # retrieval_cand_ann: the serving params
        from repro.configs.two_tower_retrieval import CONFIG as RCFG
        from repro.models import recsys as RR

        _, args, _ = cell.make_mesh_step(M.mesh_for("card"), False)
        got = [t for _, t, _ in param_leaves(args[0])]
        rcfg = dataclasses.replace(RCFG, dtype="bfloat16")
        want = jax.tree_util.tree_leaves(
            jax.eval_shape(lambda k: RR.twotower_init(k, rcfg), jax.random.PRNGKey(0)))
    else:
        got = [t for _, t, _ in param_leaves(inputs_of(cell)[0])]
        want = jax.tree_util.tree_leaves(ref_cell(cell.arch, cell.shape).input_specs()[0])
    assert all(t.device.type == "meta" for t in got)
    assert len(got) == len(want)
    assert _nbytes(got) == _nbytes(want) > 0


DENSE = tf.LMConfig(name="dense-2l", vocab=256, n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=32, dtype="float32", kv_chunk=16, remat=False)


def _hand_flops(cfg, b, s, *, kind, s_max=None):
    """The products of ``cfg``'s step: q, k, v, o, the SwiGLU MLP, the
    attention's two products over every KV chunk (causal chunks are not
    skipped) and the f32 logits.  A train step's backward takes two
    products a forward product and recomputes each KV chunk's score product
    (the non-reentrant checkpoint stops once the tensors the backward needs
    are made, so the chunk's P·V product is not redone)."""
    d, hd, h, kh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    lin = 2 * b * s * (d * h * hd * 2 + 2 * d * kh * hd + 3 * d * cfg.d_ff)
    att = 4 * b * h * s * (s_max or s) * hd
    logits = 2 * b * (s if kind == "train" else 1) * d * cfg.vocab_padded
    fwd_lin = cfg.n_layers * lin + logits
    if kind == "train":
        return 3 * fwd_lin + 3 * cfg.n_layers * att + cfg.n_layers * att // 2
    return fwd_lin + cfg.n_layers * att


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flop_counter_on_a_two_layer_lm_equals_a_hand_count(kind):
    from repro_torch.configs.common import lm_step
    from repro_torch.train.optimizer import adamw_init

    b, s = 2, 32
    params = tf.param_specs(DENSE)
    step = lm_step(kind, DENSE)
    toks = torch.empty((b, s), dtype=torch.int32, device="meta")
    if kind == "train":
        args = (params, adamw_init(params), {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        args = (params, toks)
    else:
        args = (params, tf.init_cache(DENSE, b, s, device="meta"),
                torch.empty((b,), dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"))
    with FlopCounterMode(display=False) as fc:
        step(*args)
    if kind == "decode":
        want = _hand_flops(DENSE, b, 1, kind=kind, s_max=s)
    else:
        want = _hand_flops(DENSE, b, s, kind=kind)
    assert fc.get_total_flops() == want


def test_kernel_meta_counts_equal_their_formulas():
    from repro_torch.kernels.l2_topk import kernel as LK
    from repro_torch.kernels.posting_scan import kernel as SK

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q_n, p_n, d, k, bp = 64, 1024, 100, 16, 512
    nb, bs, kk, pages = 24, 32, 10, 1000
    before = {**LK.LAUNCHES, **SK.LAUNCHES}
    with work.counting() as w:
        od, oi = LK.l2_topk_tiles(meta((q_n, d)), meta((p_n, d)), meta((1, p_n)), k=k, block_p=bp)
        assert (od.shape, oi.dtype) == ((q_n, 2 * k), torch.int32) and od.device.type == "meta"
        table, blocks = meta((q_n, nb), torch.int32), meta((pages, bs, d), torch.int8)
        pd, pi = SK.scan_per_query_topk(table, meta((q_n, d)), blocks, meta((q_n, nb, bs)), k=kk)
        assert pd.shape == pi.shape == (q_n, nb, kk)
        ids = meta((nb,), torch.int32)
        bd, _ = SK.scan_batched_topk_q8(ids, meta((q_n, d)), blocks, meta((nb, bs)),
                                        meta((nb, 2)), k=kk)
        assert bd.shape == (nb, q_n, kk)
        assert SK.scan_batched(ids, meta((q_n, d)), blocks.float()).shape == (nb, q_n, bs)
    assert {**LK.LAUNCHES, **SK.LAUNCHES} == before          # meta launches nothing
    t = p_n // bp
    want = {
        "l2_topk_tiles": (2.0 * q_n * p_n * d, 4.0 * (q_n * d + p_n * d + p_n) + 8 * q_n * t * k),
        "scan_per_query_topk": (2.0 * q_n * nb * bs * d,
                                q_n * nb * bs * d + 4.0 * (q_n * nb + q_n * d + q_n * nb * bs)
                                + 8 * q_n * nb * kk),
        "scan_batched_topk_q8": (2.0 * nb * q_n * bs * d + 2.0 * nb * bs * d,
                                 nb * bs * d + 4.0 * (nb + q_n * d + nb * bs + 2 * nb)
                                 + 8 * nb * q_n * kk),
        "scan_batched": (2.0 * nb * q_n * bs * d,
                         4 * nb * bs * d + 4.0 * (nb + q_n * d) + 4 * nb * q_n * bs),
    }
    assert {n: (v["flops"], v["bytes"]) for n, v in w.by_kernel.items()} == want
    assert all(v["launches"] == 1 for v in w.by_kernel.values())
    assert w.flops == sum(f for f, _ in want.values())


def test_pairs_meta_counts_equal_their_formulas():
    """The pairs form of #6 and #7 on ``meta``: the same products as the
    full form, the int16 ``(NB, Q)`` probe rows read, and ``Q x nbq`` rows
    of ``k`` candidates written, not ``NB x Q``."""
    from repro_torch.kernels.posting_scan import kernel as SK

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q_n, d, nb, bs, kk, nbq, pages = 64, 100, 24, 32, 10, 16, 1000
    ids, blocks = meta((nb,), torch.int32), meta((pages, bs, d), torch.int8)
    pos = meta((nb, q_n), torch.int16)
    before = dict(SK.LAUNCHES)
    with work.counting() as w:
        bd, bi = SK.scan_batched_topk_pairs(ids, meta((q_n, d)), blocks, meta((nb, bs)), pos,
                                            nbq=nbq, k=kk)
        assert bd.shape == bi.shape == (q_n, nbq, kk) and bi.dtype == torch.int32
        SK.scan_batched_topk_q8_pairs(ids, meta((q_n, d)), blocks, meta((nb, bs)),
                                      meta((nb, 2)), pos, nbq=nbq, k=kk)
    assert SK.LAUNCHES == before
    read = nb * bs * d + 4.0 * (nb + q_n * d + nb * bs) + 2.0 * nb * q_n
    want = {
        "scan_batched_topk_pairs": (2.0 * nb * q_n * bs * d, read + 8 * q_n * nbq * kk),
        "scan_batched_topk_q8_pairs": (2.0 * nb * q_n * bs * d + 2.0 * nb * bs * d,
                                       read + 8.0 * nb + 8 * q_n * nbq * kk),
    }
    assert {n: (v["flops"], v["bytes"]) for n, v in w.by_kernel.items()} == want
    with pytest.raises(ValueError, match="unsupported device"):
        SK._on_cpu(_Elsewhere())


class _Elsewhere:
    """A tensor's stand-in on a device the wrappers do not serve."""
    device = torch.device("xpu")


# ---------------------------------------------------------------------------
# the dry run: the mini twin, the skip, the list, the driver
# ---------------------------------------------------------------------------

def test_dryrun_mechanism_on_one_card():
    rec = dryrun.run_cell("deepfm", "serve_p99", "card")
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes_accessed"] > 0
    t = rec["roofline"]
    assert t["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert t["collective_s"] == 0.0 and rec["collective_bytes"]["reason"] == "one card: no collective"
    assert t["peak_flops"] == 67e12 and t["hbm_bw"] == 3.35e12
    params = ref_cell("deepfm", "serve_p99").input_specs()[0]
    ma = rec["memory_analysis"]
    assert ma["argument_bytes_each"][0] == _nbytes(jax.tree_util.tree_leaves(params))
    assert ma["temp_bytes"] is None and rec["fits_80gb"] is True
    assert rec["card_run"] == "none"
    json.dumps(rec)
    multi = dryrun.run_cell("deepfm", "serve_p99", "multi")
    assert multi["n_devices"] == 512 and multi["roofline"]["collective_s"] is None
    assert multi["cost_analysis"]["flops"] * 512 == pytest.approx(rec["cost_analysis"]["flops"])
    # the item table row-sharded over model: 16x fewer of its bytes a device
    assert multi["memory_analysis"]["argument_bytes"] < ma["argument_bytes"] / 8


def test_dryrun_skips_long_500k_with_the_reference_reason():
    rec = dryrun.run_cell("granite-20b", "long_500k", "single")
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == ref_cell("granite-20b", "long_500k").skip_reason


def test_dryrun_list_equals_the_reference_registry(capsys):
    want = [(c.arch, c.shape, c.family, c.kind, c.skip_reason) for c in ref_all_cells()]
    assert dryrun.list_cells() == want and len(want) == 46
    dryrun.main(["--list"])
    assert len(capsys.readouterr().out.splitlines()) == 46


def test_dryrun_index_and_lm_records(tmp_path):
    """An index cell's per-device program and an LM cell's record on the
    card; ``--arch/--shape --mesh all`` writes one JSON a mesh."""
    dryrun.main(["--arch", "spfresh-1b", "--shape", "serve_search_paged", "--mesh", "all",
                 "--out", str(tmp_path)])
    recs = {mk: json.loads((tmp_path / f"spfresh-1b__serve_search_paged__{mk}.json").read_text())
            for mk in ("single", "multi", "card")}
    assert all(r["status"] == "ok" for r in recs.values())
    kw = recs["card"]["cost_analysis"]["kernel_work"]
    assert set(kw) == {"scan_batched_topk_pairs"} and kw["scan_batched_topk_pairs"]["launches"] == 1
    # one shard a device on every mesh: the same per-device count
    assert recs["single"]["cost_analysis"]["flops"] == recs["card"]["cost_analysis"]["flops"]
    assert recs["card"]["card_run"].startswith("cut: one shard")
    rec = dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", "card")
    assert rec["model_flops_global"] == roofline.model_flops(
        C.get_cell("granite-moe-1b-a400m", "decode_32k"))
    assert 0 < rec["model_to_hlo_flops"] < 1 and rec["roofline"]["peak_dtype"] == "bfloat16"
    assert rec["fits_80gb"] is False and rec["card_peak_measured"].startswith("67.2 GB")
    assert "no layer scan" in rec["analysis_correction"]


def test_dryrun_driver_makes_only_the_missing_records(tmp_path, monkeypatch, capsys):
    """The driver is resumable: with every other record present it starts
    one child, for the one cell that lacks its ``card`` record (the child
    runs in this process here: a new interpreter would take seconds)."""
    import subprocess

    for arch, shape, *_ in dryrun.list_cells():
        if (arch, shape) != ("deepfm", "serve_p99"):
            (tmp_path / f"{dryrun._cell_key(arch, shape, 'card')}.json").write_text("{}")
    children = []

    def child(cmd, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"] and kw["timeout"] == 900
        children.append(cmd[3:])
        dryrun.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(dryrun.subprocess, "run", child)
    dryrun.main(["--driver", "--mesh", "card", "--out", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[0] == "driver: 1 records of 1 cells to make"
    assert children == [["--arch", "deepfm", "--shape", "serve_p99", "--mesh", "card", "--out",
                         str(tmp_path), "--force"]]
    rec = json.loads((tmp_path / "deepfm__serve_p99__card.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "card"
    dryrun.main(["--driver", "--mesh", "card", "--out", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[0] == "driver: 0 records of 0 cells to make"


def test_roofline_report_reads_the_records(tmp_path, capsys):
    from repro_torch.launch import roofline_report

    dryrun.main(["--arch", "deepfm", "--shape", "serve_p99", "--mesh", "card",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "granite-20b", "--shape", "long_500k", "--mesh", "card",
                 "--out", str(tmp_path)])
    capsys.readouterr()
    roofline_report.main(["--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "## card ({'ok': 1, 'skipped': 1})"
    rows = {ln.split(" | ")[1]: ln for ln in lines if ln.startswith("| deepfm")
            or ln.startswith("| granite-20b")}
    assert "| memory | " in rows["serve_p99"] and "skipped: pure full-attention" in rows["long_500k"]


def test_roofline_terms_and_meshes():
    t = roofline.roofline_terms(flops_per_device=67e12, bytes_per_device=3.35e12 / 2,
                                collective_bytes_per_device=None)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5 and t["dominant"] == "compute_s"
    with pytest.raises(ValueError, match="link bandwidth"):
        roofline.roofline_terms(flops_per_device=1, bytes_per_device=1,
                                collective_bytes_per_device=5)
    from repro.launch import mesh as RM

    for multi_pod in (False, True):
        m = M.make_production_mesh(multi_pod=multi_pod)
        assert m.size == (512 if multi_pod else 256)
        assert m.axis_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
        assert "make_production_mesh" in dir(RM)
    assert M.mesh_for("card").size == 1 and M.mesh_for("card").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        M.mesh_for("pods")


# ---------------------------------------------------------------------------
# index cells at SMOKE against the reference's steps on a 1 x 1 mesh
# ---------------------------------------------------------------------------

AXES = ("data", "model")


def ref_stacked(states, rcfg):
    """The port's per-shard states as the reference's stacked state."""
    from repro.core.types import make_empty_state as ref_empty

    leaves = convert.sharded_state_to_numpy(states)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax.eval_shape(lambda: ref_empty(rcfg)))
    out = []
    for path, sds in flat:
        a = leaves[".".join(k.name for k in path)]
        out.append(jnp.asarray(a).view(sds.dtype) if sds.dtype == jnp.bfloat16
                   else jnp.asarray(a.astype(sds.dtype)))
    return treedef.unflatten(out)


@pytest.fixture(scope="module")
def index_ref():
    """States built by the port (its build is not under test here; the
    reference's takes seconds to compile) and carried to the reference."""
    from repro.configs.spfresh import SMOKE as RSMOKE
    from repro.core.grouping import GroupIndex
    from repro.distributed import sharded_index as RD

    from repro_torch.configs.spfresh import SMOKE
    from repro_torch.core.grouping import build_group_index
    from repro_torch.core.index import build_state
    from repro_torch.distributed.sharded_index import sharded_insert

    rng = np.random.default_rng(0)
    base = make_clustered(rng, 1500, 16, n_clusters=10)
    queries = (base[rng.integers(0, len(base), 24)]
               + 0.01 * rng.normal(size=(24, 16))).astype(np.float32)
    hot = np.concatenate([base[i] + 0.02 * rng.normal(size=(96, 16))
                          for i in (3, 700)]).astype(np.float32)
    states = [build_state(SMOKE, base, seed=0, device="cpu")]
    gidx = convert.group_index_to_numpy(build_group_index(states[0], n_groups=64, capacity=8))
    # the hot rows overflow two postings: the round has splits to run
    churned, _ = sharded_insert(states, torch.as_tensor(hot), torch.ones(len(hot), dtype=torch.bool))
    return dict(mesh=jax.make_mesh((1, 1), AXES), cfg=RSMOKE, state=ref_stacked(states, RSMOKE),
                gidx=GroupIndex(**{k: jnp.asarray(v)[None] for k, v in gidx.items()}),
                churned=ref_stacked(churned, RSMOKE), queries=queries, RD=RD)


def _port_states(ref_state):
    from repro_torch.configs.spfresh import SMOKE

    return convert.sharded_state_from_numpy(SMOKE, {k: v for k, v in _ref_leaves(ref_state)},
                                            1, device="cpu")


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(".".join(k.name for k in path), np.asarray(v)) for path, v in flat]


def _assert_search(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL, rtol=RTOL)


def _assert_states(states, ref_state, close=()):
    got = convert.sharded_state_to_numpy(states)
    want = dict(_ref_leaves(ref_state))
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        if name in close:
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("shape", ["serve_search", "serve_search_paged", "serve_search_grouped"])
def test_search_cells_equal_the_reference_steps(index_ref, shape):
    from repro_torch.configs import spfresh

    x, RD = index_ref, index_ref["RD"]
    cfg, kw = x["cfg"], {}
    if shape == "serve_search_paged":
        cfg = dataclasses.replace(cfg, use_pallas_scan=True, scan_schedule="batched",
                                  scan_page_budget=512)
        kw = dict(use_pallas_scan=True, scan_schedule="batched")
    if shape == "serve_search_grouped":
        kw = dict(gprobe=spfresh.GPROBE)
    ref_step = RD.make_search_step(x["mesh"], cfg, k=10, shard_axes=AXES,
                                   probe_chunk=spfresh.PROBE_CHUNK, **kw)
    ref_state = x["state"]
    if cfg is not x["cfg"]:
        ref_state = ref_state.replace(cfg=cfg)
    alive = np.ones(1, bool)
    ref_args = [ref_state, jnp.asarray(x["queries"]), jnp.asarray(alive)]
    states = _port_states(x["state"])
    if cfg is not x["cfg"]:
        from repro_torch.core.types import LireConfig

        states = [s.replace(cfg=LireConfig(**dataclasses.asdict(cfg))) for s in states]
    args = [states, torch.as_tensor(x["queries"]), torch.as_tensor(alive)]
    if shape == "serve_search_grouped":
        ref_args.append(x["gidx"])
        args.append([convert.group_index_from_numpy(
            {k: np.asarray(v)[0] for k, v in _ref_leaves(x["gidx"])}, device="cpu")])
    got = C.get_cell("spfresh-1b", shape).step_fn(*args)
    _assert_search(got, ref_step(*ref_args))
    assert (got[1].numpy() >= 0).all()         # one shard: a handle is the vid itself


def test_update_cell_equals_the_reference_step(index_ref):
    x, RD = index_ref, index_ref["RD"]
    rng = np.random.default_rng(5)
    vecs = make_clustered(rng, 40, 16, n_clusters=3)
    valid = np.ones(40, bool)
    valid[[4, 9]] = False                               # padding rows
    ref_state, ref_h = RD.make_insert_step(x["mesh"], x["cfg"], shard_axes=AXES)(
        jax.tree_util.tree_map(jnp.copy, x["state"]), jnp.asarray(vecs), jnp.asarray(valid))
    before = _port_states(x["state"])
    states, h = C.get_cell("spfresh-1b", "serve_update").step_fn(
        before, torch.as_tensor(vecs), torch.as_tensor(valid))
    np.testing.assert_array_equal(h.numpy(), np.asarray(ref_h))
    assert (h.numpy()[~valid] == -1).all()
    _assert_states(states, ref_state, close=FLOAT_CLOSE)
    _assert_states(before, x["state"])                  # the step changes no input


def test_maintain_cell_equals_the_reference_round(index_ref):
    x, RD = index_ref, index_ref["RD"]
    ref_state, ref_did = RD.make_maintenance_round(
        x["mesh"], x["cfg"], shard_axes=AXES, jobs_per_round=x["cfg"].jobs_per_round)(
        jax.tree_util.tree_map(jnp.copy, x["churned"]))
    states, did = C.get_cell("spfresh-1b", "maintain").step_fn(_port_states(x["churned"]),
                                                               draw=ref_draw)
    assert int(did) == int(ref_did) > 0
    _assert_states(states, ref_state, close=ROUND_CLOSE)


def test_retrieval_cand_ann_equals_the_reference_step(index_ref):
    """At the smoke widths (f32): the reference's tower then its search
    step at nprobe 16, on the port's params (carried across) and an index
    of the item tower's embeddings, against the cell's step."""
    from repro.configs.two_tower_retrieval import SMOKE as RTT
    from repro.models import recsys as RR

    from repro_torch.configs import two_tower_retrieval as TT
    from repro_torch.core.index import build_state
    from repro_torch.core.types import LireConfig
    from repro_torch.models.recsys import twotower_init

    x, RD = index_ref, index_ref["RD"]
    icfg = dataclasses.replace(x["cfg"], dim=RTT.tower_dims[-1])
    params = twotower_init(torch.Generator().manual_seed(0), TT.SMOKE, device="cpu")
    with torch.no_grad():
        items = params.item_tower(torch.arange(TT.SMOKE.n_items)).float().numpy()
    states = [build_state(LireConfig(**dataclasses.asdict(icfg)), items, seed=0, device="cpu")]
    users = np.random.default_rng(2).integers(0, RTT.user_vocab_per_field,
                                              size=(1, RTT.n_user_fields)).astype(np.int32)
    search = RD.make_search_step(x["mesh"], icfg, k=10, shard_axes=AXES, nprobe=TT.ANN_NPROBE)
    u = RR.user_tower(convert.params_to_numpy(params), jnp.asarray(users), RTT)
    want = search(ref_stacked(states, icfg), u.astype(jnp.float32), jnp.ones(1, bool))
    cell = C.get_cell("two-tower-retrieval", "retrieval_cand_ann")
    got = cell.step_fn(params, torch.as_tensor(users), states, torch.ones(1, dtype=torch.bool))
    _assert_search(got, want)
