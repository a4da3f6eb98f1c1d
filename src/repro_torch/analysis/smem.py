"""CUDA launcher resource pass (SPF30x).

The port's kernels take their shared memory dynamically, and each
launcher reckons the bytes from the shape it is given and picks the
kernel's shape from them: ``l2_topk.cu`` (``l2_layout``), the per-query
scan's warps and ring depth (``posting_scan.cu``, ``pq_layout`` and the
search in ``pq_choose``: two blocks an SM where the layout fits half of
the SM, else one) and the batched scan's default or wide shape
(``scan_batched_topk.cu``, ``Layout`` and ``shape_of``).  A shape past the
232,448 bytes a block may take is refused at launch.  This pass holds a
stdlib mirror of that arithmetic and evaluates every launch entry, for
every payload it takes, at every geometry of the spec, the way the
reference evaluates each ``pl.pallas_call`` at its VMEM bindings.  Each
``.cu`` source has the launcher's own answer as an ``extern "C"``
``<entry>_smem_bytes`` query, and the card holds the two equal
(chip_smoke.py ``phase_resources``).

* SPF301 — at a geometry a configuration uses, for a payload its pool
  stores, every shape of a launcher passes the limit: it would refuse.
* SPF302 — a wrapper in a ``*.kernel`` module whose CUDA branch reaches
  its ``_plain`` twin (directly or through a helper of the module), or
  catches an error there: the fallback the port forbids.  The CPU branch
  is the body of an ``if`` on ``_on_cpu(...)`` or ``x.device.type ==
  "cpu"``.
* SPF303 — an ``extern "C"`` launch entry of a source with no row in the
  spec's table (``SmemSpec.entries``).
* SPF304 — a geometry that lacks a symbol an entry's mirror needs.

SPF301 and SPF304 are reported at the entry's line in its ``.cu`` source.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

from repro_torch.analysis.common import Finding, Module, rel_path
from repro_torch.analysis.config import SmemSpec

ELEM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
DTYPE_CODE = {"float32": 0, "bfloat16": 1, "int8": 2}   # the C entries' dtype
VARIANTS = {0: "default", 1: "wide", -1: "refused"}
# symbols each mirror form reads from a geometry
NEEDS = {
    "l2": ("dim", "nav_k"),
    "per_query": ("dim", "bs"),
    "per_query_topk": ("dim", "bs", "k"),
    "batched": ("dim", "bs"),
    "batched_topk": ("dim", "bs", "k"),
}

_ENTRY = re.compile(r'^extern\s+"C"\s+int\s+(\w+)\s*\(', re.M)
_QUERY_SUFFIX = "_smem_bytes"


# ---------------------------------------------------------------------------
# The launchers' arithmetic (mirrored; the card holds it to the C queries)
# ---------------------------------------------------------------------------

def l2_layout(d: int, k: int) -> int:
    """l2_topk.cu ``l2_layout``: the 32 x 512 distance tile (rows of 520
    floats), the query tile and its norms, then the 64-centroid buffer or
    the sort lists, whichever is larger."""
    kpad = (d + 7) // 8 * 8
    stride = kpad + 4
    sort_n = 1
    while sort_n < k:
        sort_n <<= 1
    return 4 * (32 * 520 + 32 * stride + 32) + max(4 * 64 * stride, 8 * 32 * sort_n)


def pq_layout(bs: int, d: int, elem: int, warps: int, stages: int) -> int:
    """posting_scan.cu ``pq_layout``: the query row and its digit planes,
    then per warp its ring of pages, the bias, (scale, zero) and the
    select's row."""
    du = d // 4
    ustride = du if du % 2 else du + 1
    page_stride = (bs * ustride * 4 * elem + 15) & ~15
    bias_off = stages * page_stride
    sz_off = bias_off + stages * 32 * 4
    sel_off = sz_off + ((stages * 2 * 4 + 15) & ~15)
    warp_bytes = sel_off + 32 * 4
    q_bytes = 2 * ((d * 4 + 15) & ~15) + 16
    return q_bytes + warps * warp_bytes


PQ_SHAPES = ((8, 2), (4, 2), (2, 2), (1, 2), (1, 1))   # (warps, stages)


def batched_layout(all_slots: bool, warps: int, ring: int, bs: int, d: int,
                   elem: int, stride: int) -> int:
    """scan_batched_topk.cu ``Layout``: the staging tiles (not for #3),
    the query norms and sums, per ring step the pages' bias, (scale,
    zero) and liveness, the pages, then the query tile (twice for #3)."""
    step = warps // 2
    qsq = 0 if all_slots else 4 * warps * 32 * 32
    bias = qsq + 4 * 64 + 4 * 64
    sz = bias + 4 * ring * step * 32
    live = sz + 4 * ring * step * 2
    pages = (live + 4 * ring * step + 15) & ~15
    page_stride = (bs * d * elem + 15) & ~15
    qs = pages + ring * step * page_stride
    return qs + 4 * 64 * stride * (2 if all_slots else 1)


@dataclasses.dataclass(frozen=True)
class Shape:
    bytes: int        # dynamic shared memory the launcher asks for
    variant: int      # 0 default, 1 wide, -1 refused (bytes: the last tried)
    warps: int
    stages: int       # the ring of pages in flight (1 for l2_topk)

    @property
    def threads(self) -> int:
        return 32 * self.warps


def shape_of(form: str, payload: str, g: dict, spec: SmemSpec) -> Shape:
    """The shape a launcher takes at geometry ``g`` (its symbols present)."""
    limit = spec.limit_bytes
    elem = ELEM_BYTES[payload]
    d = g["dim"]
    if form == "l2":
        b = l2_layout(d, g["nav_k"])
        return Shape(b, 0 if b <= limit else -1, 8, 1)
    if form in ("per_query", "per_query_topk"):
        two = spec.sm_bytes // 2 - spec.reserved_bytes
        for variant, cap in enumerate((two, limit)):
            for warps, stages in PQ_SHAPES:
                b = pq_layout(g["bs"], d, elem, warps, stages)
                if b <= cap:
                    return Shape(b, variant, warps, stages)
        return Shape(b, -1, warps, stages)
    all_slots = form == "batched"
    kpad = (d + 15) // 16 * 16
    stride = kpad if kpad % 32 == 16 else kpad + 16
    b = batched_layout(all_slots, 8, 2, g["bs"], d, elem, stride)
    if b <= limit:
        return Shape(b, 0, 8, 2)
    if elem == 1:                              # int8 pages take no wide shape
        return Shape(b, -1, 8, 2)
    warps = 4 if elem == 4 else 8
    b = batched_layout(all_slots, warps, 1, g["bs"], d, elem, stride)
    return Shape(b, 1 if b <= limit else -1, warps, 1)


def blocks_per_sm(shape: Shape, spec: SmemSpec) -> int:
    """Blocks an SM can hold by shared memory and threads (registers are
    the card's to count: ``phase_resources`` prints its occupancy)."""
    if shape.variant < 0:
        return 0
    return min(spec.sm_bytes // (shape.bytes + spec.reserved_bytes),
               2048 // shape.threads, 32)


@dataclasses.dataclass
class Row:
    entry: str
    form: str
    payload: str
    geometry: str
    file: str
    line: int
    shape: Shape
    blocks_per_sm: int
    used: bool        # the geometry's pool stores this payload

    def as_dict(self) -> dict:
        return {
            "entry": self.entry, "form": self.form, "payload": self.payload,
            "geometry": self.geometry, "file": self.file, "line": self.line,
            "bytes": self.shape.bytes, "shape": VARIANTS[self.shape.variant],
            "variant": self.shape.variant, "warps": self.shape.warps,
            "stages": self.shape.stages, "threads": self.shape.threads,
            "blocks_per_sm": self.blocks_per_sm, "used": self.used,
        }


def query_args(entry: str, form: str, payload: str, g: dict) -> list[int]:
    """Arguments of ``<entry>_smem_bytes`` before its shape pointer: the
    launch entry's own shape arguments (the dtype code where it takes
    one)."""
    if form == "l2":
        return [g["dim"], g["nav_k"]]
    args = [] if entry.endswith("_q8") else [DTYPE_CODE[payload]]
    args += [g["bs"], g["dim"]]
    if form.endswith("_topk"):
        args.append(g["k"])
    return args


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def launch_entries(root: Path, spec: SmemSpec) -> list[tuple[str, Path, int]]:
    """``(entry, source, line)`` of every ``extern "C"`` launch entry (the
    ``*_smem_bytes`` queries are not launches)."""
    out = []
    for path in sorted((Path(root) / spec.csrc).glob("*.cu")):
        text = path.read_text()
        for m in _ENTRY.finditer(text):
            name = m.group(1)
            if not name.endswith(_QUERY_SUFFIX):
                out.append((name, path, text.count("\n", 0, m.start()) + 1))
    return out


def _is_cpu_test(node: ast.AST) -> bool:
    """``_on_cpu(x)`` or ``x.device.type == "cpu"``."""
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
        return name == "_on_cpu"
    if isinstance(node, ast.Compare) and len(node.ops) == 1 and \
            isinstance(node.ops[0], ast.Eq):
        sides = [node.left, *node.comparators]
        return any(isinstance(s, ast.Constant) and s.value == "cpu" for s in sides) \
            and any(isinstance(s, ast.Attribute) and s.attr == "type" for s in sides)
    return False


def _callee(call: ast.Call) -> str | None:
    f = call.func
    return f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)


def _cuda_branch(stmts: list[ast.stmt]):
    """The statements and expression nodes of ``stmts`` outside a CPU
    branch (the body of an ``if`` on a CPU test)."""
    for st in stmts:
        if isinstance(st, ast.If) and _is_cpu_test(st.test):
            yield from _cuda_branch(st.orelse)
            continue
        yield st
        for child in ast.iter_child_nodes(st):
            if not isinstance(child, (ast.stmt, ast.excepthandler)):
                yield from ast.walk(child)
        for field in ("body", "orelse", "finalbody"):
            yield from _cuda_branch(getattr(st, field, None) or [])
        for handler in getattr(st, "handlers", None) or []:
            yield from _cuda_branch(handler.body)


def _fallbacks(mod: Module) -> list[Finding]:
    fns = {
        n.name: n for n in mod.tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    cuda = {name: list(_cuda_branch(fn.body)) for name, fn in fns.items()}
    # names that are, or reach through the module's functions outside
    # their CPU branches, a plain version
    plain = {n for n in fns if n.endswith("_plain")}

    def plain_calls(name: str):
        for c in cuda[name]:
            callee = _callee(c) if isinstance(c, ast.Call) else None
            if callee and (callee.endswith("_plain") or callee in plain):
                yield c, callee

    grew = True
    while grew:
        grew = False
        for name in fns:
            if name not in plain and any(plain_calls(name)):
                plain.add(name)
                grew = True

    out: list[Finding] = []
    for name in fns:
        if name.endswith("_plain") or f"{name}_plain" not in fns:
            continue
        qual = f"{mod.name}.{name}"
        for node in cuda[name]:
            if isinstance(node, ast.Try) and node.handlers:
                out.append(Finding(
                    "SPF302", mod.rel, node.lineno, qual,
                    f"{name}() catches an error on its CUDA branch: a "
                    "launch must raise, not fall back",
                ))
        for call, callee in plain_calls(name):
            out.append(Finding(
                "SPF302", mod.rel, call.lineno, qual,
                f"{name}() reaches the plain version {callee}() on its "
                "CUDA branch (a fallback)",
            ))
    return out


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def run(
    modules: dict[str, Module], spec: SmemSpec, root: Path
) -> tuple[list[Finding], list[Row]]:
    root = Path(root).resolve()
    findings: list[Finding] = []
    rows: list[Row] = []
    entries = launch_entries(root, spec)
    found = {e for e, _, _ in entries}
    missing = sorted(set(spec.entries) - found)
    if missing:
        raise ValueError(f"smem table names entries no source defines: {missing}")
    for entry, path, line in entries:
        rel = rel_path(path, root.parent)
        if entry not in spec.entries:
            findings.append(Finding(
                "SPF303", rel, line, entry,
                f"launch entry {entry}() has no row in the shared-memory "
                "table (SmemSpec.entries): its launcher is not evaluated",
            ))
            continue
        form, payloads = spec.entries[entry]
        for g in spec.bindings:
            lacking = [s for s in NEEDS[form] if s not in g]
            if lacking:
                findings.append(Finding(
                    "SPF304", rel, line, entry,
                    f"geometry {g.get('name')!r} has no {lacking} for the "
                    f"{form} mirror of {entry}()",
                ))
                continue
            for payload in payloads:
                shape = shape_of(form, payload, g, spec)
                used = payload in g.get("payloads", ())
                rows.append(Row(entry, form, payload, g["name"], rel, line, shape,
                                blocks_per_sm(shape, spec), used))
                if shape.variant < 0 and used:
                    findings.append(Finding(
                        "SPF301", rel, line, entry,
                        f"{entry}() refuses {payload} pages at geometry "
                        f"{g['name']!r}: every shape passes the "
                        f"{spec.limit_bytes} bytes a block may take "
                        f"({shape.bytes} at the smallest)",
                    ))
    for mod in sorted(modules.values(), key=lambda m: m.name):
        if mod.name.startswith(spec.kernel_prefixes) and \
                mod.name.rsplit(".", 1)[-1] == "kernel":
            findings.extend(_fallbacks(mod))
    return findings, rows
