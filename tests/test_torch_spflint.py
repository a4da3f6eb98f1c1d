"""spflint for the port (``repro_torch.analysis``): the passes themselves.

1. **Seeded violations** — `tests/fixtures/spflint_torch/badpkg/` plants
   violations of every rule of the port's registry, each marked in-line
   with ``# expect: SPF...`` (``// expect:`` in its ``.cu`` source); the
   passes must report EXACTLY that (file, line, rule) multiset.
2. **Parity** — on the reference's own fixture tree and spec, the port's
   replay and lock passes report what ``repro.analysis`` reports.
3. **Clean tree** — ``python -m repro_torch.analysis src`` has zero
   findings, the baseline stays empty, every replay root resolves and the
   replay surface keeps the telemetry, pool and pid-allocation writes.
4. **The resource table** — exactly the seven launch entries, at the
   geometries the port's configs give, with the bytes the launchers'
   code gives (the card holds the C queries to the same mirror:
   ``tests/test_torch_cuda.py``, ``chip_smoke.py`` ``phase_resources``).

Plus the import boundary (the package loads no ``torch``, ``jax`` or
``repro``) and the repair the replay pass called for in
``lire._bump_append_telemetry``.
"""
import ast
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import locks, replay, run_all, smem
from repro_torch.analysis.__main__ import main as spflint_main
from repro_torch.analysis.common import (
    RULES,
    load_baseline,
    parse_tree,
    split_by_baseline,
    write_baseline,
)
from repro_torch.analysis.config import (
    DEFAULT_SPEC,
    AnalysisSpec,
    LockSpec,
    ReplaySpec,
    SmemSpec,
)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "spflint_torch"
REF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "spflint"
BASELINE = REPO / "tools" / "spflint_torch_baseline.json"

# The fixture twin of config.DEFAULT_SPEC: same passes, aimed at badpkg.
# Geometry "big" makes big_scan (the batched k-min at d=512, f32) refuse;
# "nok" lacks the k both entries' mirrors need.
FIXTURE_SPEC = AnalysisSpec(
    replay=ReplaySpec(
        roots=("badpkg.steps:build_step",),
        config_class="badpkg.types:Cfg",
        critical_stamp="badpkg.stamps:REPLAY_CRITICAL_FIELDS",
        exempt_stamp="badpkg.stamps:REPLAY_EXEMPT_FIELDS",
    ),
    locks=LockSpec(module_prefixes=("badpkg.serve",)),
    smem=SmemSpec(
        csrc="badpkg/kernels/csrc",
        kernel_prefixes=("badpkg.kernels",),
        limit_bytes=232448,
        sm_bytes=233472,
        reserved_bytes=1024,
        entries={"ok_scan": ("per_query_topk", ("float32",)),
                 "big_scan": ("batched_topk", ("float32",))},
        bindings=(
            {"name": "big", "dim": 512, "bs": 32, "k": 10, "payloads": ("float32",)},
            {"name": "nok", "dim": 64, "bs": 32, "payloads": ("float32",)},
        ),
    ),
)

_MARKER = re.compile(r"(?:#|//)\s*expect:\s*([A-Z0-9 ]+)$")


def _expected_markers() -> list[tuple[str, int, str]]:
    """(rel-file, line, rule) for every ``expect:`` marker token."""
    out = []
    for path in sorted(FIXTURES.rglob("*")):
        if path.suffix not in (".py", ".cu"):
            continue
        rel = path.relative_to(FIXTURES.parent).as_posix()
        for lineno, text in enumerate(path.read_text().splitlines(), 1):
            m = _MARKER.search(text)
            if m:
                out.extend((rel, lineno, r) for r in m.group(1).split())
    return out


# ---------------------------------------------------------------------------
# 1. Seeded violations: exact (file, line, rule) agreement
# ---------------------------------------------------------------------------

def test_seeded_fixtures_report_exact_findings():
    result = run_all(FIXTURES, spec=FIXTURE_SPEC)
    got = sorted((f.file, f.line, f.rule) for f in result["findings"])
    want = sorted(_expected_markers())
    assert got == want, (
        "spflint findings diverge from the seeded expect markers:\n"
        f"  missing: {sorted(set(want) - set(got))}\n"
        f"  extra:   {sorted(set(got) - set(want))}"
    )
    # every rule in the registry is exercised by at least one seed
    assert {r for _, _, r in want} == set(RULES)


def test_fixture_baseline_roundtrip(tmp_path):
    findings = run_all(FIXTURES, spec=FIXTURE_SPEC)["findings"]
    assert findings
    path = tmp_path / "baseline.json"
    write_baseline(path, findings)
    new, suppressed = split_by_baseline(findings, load_baseline(path))
    assert new == [] and len(suppressed) == len(findings)
    # keys are (rule, file, symbol) — line-stable on edits above the site
    entry = json.loads(path.read_text())["suppressions"][0]
    assert set(entry) == {"rule", "file", "symbol", "reason"}


def test_fixture_tree_holds_no_test_module():
    """pytest.ini's norecursedirs covers only the reference's fixture
    tree, so this one must give pytest nothing to import."""
    for path in FIXTURES.rglob("*.py"):
        assert not path.name.startswith("test_") and not path.name.endswith("_test.py")
        assert path.name != "conftest.py"


def test_pytest_never_collects_the_port_fixture_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "tests/fixtures/spflint_torch"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    # exit code 5 = "no tests collected"
    assert proc.returncode == 5, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# 2. Parity with the reference's passes on the reference's fixtures
# ---------------------------------------------------------------------------

def test_replay_and_lock_passes_equal_the_reference_on_its_fixtures():
    from repro.analysis import common as ref_common
    from repro.analysis import config as ref_config
    from repro.analysis import locks as ref_locks
    from repro.analysis import replay as ref_replay

    ref_spec = ref_config.ReplaySpec(
        roots=("badpkg.steps:build_step",),
        config_class="badpkg.types:Cfg",
        critical_stamp="badpkg.stamps:REPLAY_CRITICAL_FIELDS",
        exempt_stamp="badpkg.stamps:REPLAY_EXEMPT_FIELDS",
    )
    ref_mods = ref_common.parse_tree(REF_FIXTURES)
    want = ref_replay.run(ref_mods, ref_spec) + ref_locks.run(
        ref_mods, ref_config.LockSpec(module_prefixes=("badpkg.serve",)))
    mods = parse_tree(REF_FIXTURES)
    got = replay.run(mods, FIXTURE_SPEC.replay) + locks.run(mods, FIXTURE_SPEC.locks)

    def key(fs):
        return sorted((f.rule, f.file, f.line, f.symbol, f.message) for f in fs)

    assert key(want)
    assert {f.rule for f in want} == {f"SPF{n}" for n in (*range(101, 107), *range(201, 208))}
    assert key(got) == key(want)


# ---------------------------------------------------------------------------
# 3. Clean tree
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _modules():
    return parse_tree(SRC)


@functools.lru_cache(maxsize=1)
def _result():
    return run_all(SRC)


def test_shipped_tree_is_clean():
    result = _result()
    assert [f.render() for f in result["findings"]] == []


def test_shipped_baseline_is_empty():
    assert load_baseline(BASELINE) == set()


def test_cli_over_src_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "spflint: clean (0 baselined, 7 launch entries analyzed)" in proc.stdout


def test_cli_exit_codes(tmp_path, capsys):
    report = tmp_path / "report.json"
    rc = spflint_main([str(SRC), "--baseline", str(BASELINE), "--json", str(report)])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["summary"] == {"new": 0, "suppressed": 0, "entries_analyzed": 7}
    assert data["rules"] == RULES

    assert spflint_main([str(tmp_path / "no_such_tree")]) == 2

    # the fixtures under the default spec: a spec the tree lacks fails loudly
    with pytest.raises(ValueError, match="not in tree"):
        spflint_main([str(FIXTURES)])

    assert spflint_main(["--rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out

    assert spflint_main([str(SRC), "--baseline", str(BASELINE), "--table"]) == 0
    table = capsys.readouterr().out
    assert "scan_batched_topk" in table and "165472 B" in table and "wide" in table


def test_write_baseline_suppresses_then_ratchets(tmp_path, monkeypatch):
    """``--write-baseline`` accepts the current findings; a run against it
    is clean, and against an empty baseline it fails."""
    import repro_torch.analysis.__main__ as cli

    monkeypatch.setattr(cli, "run_all", lambda root: run_all(root, FIXTURE_SPEC))
    path = tmp_path / "b.json"
    assert cli.main([str(FIXTURES), "--baseline", str(path), "--write-baseline"]) == 0
    assert len(load_baseline(path)) > 0
    assert cli.main([str(FIXTURES), "--baseline", str(path)]) == 0
    assert cli.main([str(FIXTURES), "--baseline", str(tmp_path / "none.json")]) == 1


@pytest.mark.parametrize("root", DEFAULT_SPEC.replay.roots)
def test_every_replay_root_resolves(root):
    mods = _modules()
    assert tuple(root.split(":")) in replay.reachable_functions(mods, (root,))
    with pytest.raises(ValueError, match="replay root not found"):
        replay.reachable_functions(mods, (root + "_gone",))


def test_replay_surface_covers_the_state_writes():
    reach = replay.reachable_functions(_modules(), DEFAULT_SPEC.replay.roots)
    for key in (("repro_torch.core.lire", "_bump_append_telemetry"),
                ("repro_torch.storage.blockpool", "append_batch"),
                ("repro_torch.core.types", "alloc_pids"),
                ("repro_torch.core.lire", "maintenance_round"),
                ("repro_torch.distributed.sharded_index", "sharded_insert")):
        assert key in reach, key
    assert len(reach) >= 79


def test_lock_pass_checks_the_engine():
    """The engine's map names its categories (``GUARDED``, ...): the pass
    resolves them through ``serve/ownership.py`` and checks the class."""
    checked = {(m.name, d.node.name): d for m, d in
               locks.checked_classes(_modules(), DEFAULT_SPEC.locks)}
    decl = checked[("repro_torch.serve.engine", "ServeEngine")]
    assert decl.ownership["_inflight"] == "guarded"
    assert decl.ownership["_busy"] == "pump"
    assert decl.pump_methods == {"_pump_loop"}


# ---------------------------------------------------------------------------
# 4. The resource table
# ---------------------------------------------------------------------------



def _table():
    return _result()["smem_table"]


def test_table_has_exactly_the_seven_launch_entries():
    from repro_torch.kernels.build import SIGNATURES

    entries = {e for e, _, _ in smem.launch_entries(SRC, DEFAULT_SPEC.smem)}
    assert entries == set(DEFAULT_SPEC.smem.entries)
    assert len(entries) == 7
    assert {r["entry"] for r in _table()} == entries
    # every launch entry is bound with its query twin, and nothing else
    bound = {fn for fns in SIGNATURES.values() for fn in fns}
    assert bound == entries | {f"{e}_smem_bytes" for e in entries}
    n = sum(len(p) for _, p in DEFAULT_SPEC.smem.entries.values())
    assert len(_table()) == n * len(DEFAULT_SPEC.smem.bindings)


def _round_up(x, m):
    return (x + m - 1) // m * m


def test_geometries_equal_the_configs():
    """Each geometry is what its configuration gives: the serving k (10,
    times the rerank factor) capped at BS, navigation at min(nprobe,
    block_p) over the tiles kernels/l2_topk/ops.py makes, the pool's
    payload dtype."""
    import dataclasses

    from repro.analysis.config import VMEM_BINDINGS

    from repro_torch.configs import spfresh, two_tower_retrieval
    from repro_torch.core.types import LireConfig
    from repro_torch.storage.codec import payload_dtype

    search_k = spfresh.service_spec(smoke=True).serve.search_k
    int8_cell = dataclasses.replace(spfresh.CONFIG_PAGED, codec="int8", rerank_factor=4)
    cfgs = {
        "spfresh-paged": spfresh.CONFIG_PAGED, "spfresh-int8": int8_cell,
        "smoke": spfresh.SMOKE, "two-tower": two_tower_retrieval.ann_index_cfg(),
    }
    geos = {g["name"]: g for g in DEFAULT_SPEC.smem.bindings}
    assert set(geos) == set(cfgs) | {"reference-vmem"}
    for name, cfg in cfgs.items():
        block_p = min(512, _round_up(cfg.num_postings_cap, 128))
        want = {
            "dim": cfg.dim, "bs": cfg.block_size,
            "k": min(search_k * cfg.rerank_factor, cfg.block_size),
            "nav_k": min(cfg.nprobe, block_p), "block_p": block_p,
            "payloads": (str(payload_dtype(cfg.codec, cfg.vector_dtype)).split(".")[-1],),
        }
        assert {s: geos[name][s] for s in want} == want, name
    ref = geos["reference-vmem"]
    b = VMEM_BINDINGS
    assert (ref["dim"], ref["bs"], ref["k"], ref["nav_k"], ref["block_p"]) == (
        b["dim"], b["bs"], b["k"], b["k"], b["block_p"])
    assert ref["payloads"] == (LireConfig().vector_dtype,)


def _row(entry, payload, geometry):
    (r,) = [r for r in _table() if (r["entry"], r["payload"], r["geometry"])
            == (entry, payload, geometry)]
    return r


@pytest.mark.parametrize("entry,payload,geometry,nbytes,shape", [
    # #6 and #7, default layout at d=100
    ("scan_batched_topk", "float32", "spfresh-paged", 165472, "default"),
    ("scan_batched_topk", "bfloat16", "spfresh-paged", 114272, "default"),
    ("scan_batched_topk", "int8", "spfresh-paged", 88672, "default"),
    ("scan_batched_topk_q8", "int8", "spfresh-int8", 88672, "default"),
    # at d=256 int8 pages keep the default layout; #3 too
    ("scan_batched_topk", "int8", "two-tower", 169568, "default"),
    ("scan_batched", "int8", "two-tower", 206432, "default"),
    # #1
    ("l2_topk_tiles_f32", "float32", "spfresh-paged", 108160, "default"),
    ("l2_topk_tiles_f32", "float32", "two-tower", 166528, "default"),
])
def test_pinned_bytes_match_the_launchers(entry, payload, geometry, nbytes, shape):
    r = _row(entry, payload, geometry)
    assert (r["bytes"], r["shape"]) == (nbytes, shape)


@pytest.mark.parametrize("all_slots,payload,default_bytes", [
    (False, "float32", 366176), (False, "bfloat16", 235104),
    (True, "float32", 403040), (True, "bfloat16", 271968),
])
def test_f32_and_bf16_pages_at_d256_take_the_wide_shape(all_slots, payload, default_bytes):
    """#6 and #3's default layouts at d=256 pass the 232,448 bytes a block
    may take, so the launcher takes the wide shape, which fits."""
    elem = smem.ELEM_BYTES[payload]
    assert smem.batched_layout(all_slots, 8, 2, 32, 256, elem, 272) == default_bytes
    assert default_bytes > DEFAULT_SPEC.smem.limit_bytes
    r = _row("scan_batched" if all_slots else "scan_batched_topk", payload, "two-tower")
    assert r["shape"] == "wide" and r["bytes"] <= DEFAULT_SPEC.smem.limit_bytes
    assert (r["warps"], r["stages"]) == ((4, 1) if payload == "float32" else (8, 1))


def test_per_query_shape_search():
    """Two blocks an SM where the layout fits half the SM, else one: the
    f32 page at d=100 drops to 4 warps; a page past half the SM (f32 at
    d=1024) takes the one-block cap; past the limit it is refused."""
    spec = DEFAULT_SPEC.smem
    g = {"dim": 100, "bs": 32, "k": 10}
    assert smem.shape_of("per_query_topk", "float32", g, spec) == smem.Shape(104816, 0, 4, 2)
    big = smem.shape_of("per_query_topk", "float32", dict(g, dim=1024), spec)
    assert big.variant == 1 and big.bytes > spec.sm_bytes // 2 - spec.reserved_bytes
    assert smem.shape_of("per_query_topk", "float32", dict(g, dim=2048), spec).variant == -1


# ---------------------------------------------------------------------------
# Import boundary
# ---------------------------------------------------------------------------

def test_import_loads_no_torch_jax_or_repro():
    code = ("import sys; import repro_torch.analysis, repro_torch.analysis.__main__; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro', 'numpy')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_analysis_package_imports_only_the_stdlib():
    for path in (SRC / "repro_torch" / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in sys.stdlib_module_names or name.startswith(
                    "repro_torch.analysis"), (path.name, name)


# ---------------------------------------------------------------------------
# The repair SPF107 called for: the drift segment sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_segment_sums_equal_the_sequential_sums_of_each_segment(n):
    """The drift segment sum: each segment's rows added in row order (the
    float64 sum of a loop), the same bits on every run."""
    import torch

    from repro_torch.core.lire import _segment_sums

    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(1, n // 5), n))
    vals = rng.standard_normal((n, 3))
    first = np.r_[True, keys[1:] != keys[:-1]]
    last = np.r_[keys[1:] != keys[:-1], True]
    want = {}
    for k, v in zip(keys, vals):
        want[k] = want.get(k, 0.0) + v
    seg, sums = _segment_sums(torch.as_tensor(vals), torch.as_tensor(first),
                              torch.as_tensor(last))
    got = sums[seg].numpy()
    assert (got == np.stack([want[k] for k in keys])).all()
    assert (sums[len(want):] == 0).all()
    assert torch.equal(sums, _segment_sums(torch.as_tensor(vals), torch.as_tensor(first),
                                           torch.as_tensor(last))[1])
