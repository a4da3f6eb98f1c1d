"""spflint infrastructure: findings, rule registry, baseline, AST walking.

A *finding* is one rule violation at one source location.  Findings are
keyed for suppression purposes by ``(rule, file, symbol)`` — the enclosing
function/class qualname (a CUDA launch entry's name in a ``.cu`` source),
NOT the line number — so a checked-in baseline survives unrelated edits
above the finding.  The shipped baseline
(`tools/spflint_torch_baseline.json`) is the CI ratchet: a finding not
listed there fails the run, so the tree can only get cleaner.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path


# --------------------------------------------------------------------------
# Rule registry (one line per rule; --rules prints this, docs copy it)
# --------------------------------------------------------------------------

RULES: dict[str, str] = {
    # Pass 1 — replay determinism (replay.py)
    "SPF101": "wall-clock read (time.*) reachable from a replay-critical "
              "dispatch path",
    "SPF102": "unseeded RNG (random.* / np.random module state / "
              "default_rng() / the global torch RNG: a sampler without "
              "generator=, torch.manual_seed, torch.seed) reachable from a "
              "replay-critical dispatch path",
    "SPF103": "set/dict iteration-order dependence in replay-critical "
              "dispatch construction",
    "SPF104": "config field read on a replay-critical path but stamped in "
              "neither REPLAY_CRITICAL_FIELDS nor REPLAY_EXEMPT_FIELDS",
    "SPF105": "config field classified in neither REPLAY_CRITICAL_FIELDS "
              "nor REPLAY_EXEMPT_FIELDS",
    "SPF106": "stamp names a field the config class does not define "
              "(stale stamp)",
    "SPF107": "accumulation PyTorch documents as nondeterministic on a "
              "CUDA tensor (index_add, scatter_add, scatter_reduce sum/"
              "mean/prod, put_/index_put_ accumulate, bincount weights, "
              "histc, median/kthvalue indices, float cumsum) on a "
              "replay-critical path, its integer operand not visible at "
              "the call",
    # Pass 2 — lock discipline (locks.py)
    "SPF201": "read of a guarded field outside the declared lock",
    "SPF202": "write to a guarded field outside the declared lock",
    "SPF203": "write to a pump-thread-only field from a non-pump method",
    "SPF204": "write to an init-only/lifecycle field outside its owner "
              "methods",
    "SPF205": "shared field assigned but missing from FIELD_OWNERSHIP",
    "SPF206": "FIELD_OWNERSHIP declares a field the class never assigns "
              "(stale declaration)",
    "SPF207": "call to a @holds_work method from a site that does not hold "
              "the lock",
    # Pass 3 — CUDA launcher resources (smem.py)
    "SPF301": "CUDA launcher whose every shape passes the dynamic shared "
              "memory a block may take, at a geometry a configuration uses",
    "SPF302": "kernel wrapper whose CUDA branch reaches its plain version "
              "or catches a launch's error (a fallback)",
    "SPF303": "extern \"C\" launch entry with no row in the shared-memory "
              "table",
    "SPF304": "geometry lacking a symbol the shared-memory mirror needs",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    file: str      # repo-relative posix path
    line: int
    symbol: str    # enclosing def/class qualname ("mod.Class.meth")
    message: str

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.file, self.symbol)

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.symbol}] " \
               f"{self.message}"


# --------------------------------------------------------------------------
# Baseline / suppression file
# --------------------------------------------------------------------------

def load_baseline(path: Path | None) -> set[tuple[str, str, str]]:
    if path is None or not Path(path).exists():
        return set()
    data = json.loads(Path(path).read_text())
    return {
        (s["rule"], s["file"], s["symbol"])
        for s in data.get("suppressions", [])
    }


def write_baseline(path: Path, findings: list[Finding]) -> None:
    data = {
        "version": 1,
        "comment": "spflint suppressions: each entry hides ONE existing "
                   "finding (rule, file, enclosing symbol).  CI fails on "
                   "any finding not listed here — remove entries as "
                   "violations are fixed; never add one without a reason.",
        "suppressions": [
            {"rule": f.rule, "file": f.file, "symbol": f.symbol,
             "reason": "baselined"}
            for f in sorted(findings, key=lambda f: f.key)
        ],
    }
    Path(path).write_text(json.dumps(data, indent=2) + "\n")


def split_by_baseline(
    findings: list[Finding], baseline: set[tuple[str, str, str]]
) -> tuple[list[Finding], list[Finding]]:
    """-> (unsuppressed, suppressed)."""
    new, old = [], []
    for f in findings:
        (old if f.key in baseline else new).append(f)
    return new, old


# --------------------------------------------------------------------------
# Source tree walking
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Module:
    name: str          # dotted module name relative to the tree root
    path: Path
    rel: str           # path to render in findings (posix, repo-relative)
    tree: ast.Module


def rel_path(path: Path, rel_to: Path) -> str:
    try:
        return path.relative_to(rel_to).as_posix()
    except ValueError:
        return path.as_posix()


def parse_tree(
    root: Path, *, rel_to: Path | None = None, skip_dirs: tuple[str, ...] = (
        "__pycache__",
    ),
) -> dict[str, Module]:
    """Parse every ``*.py`` under ``root`` into a {dotted-name: Module} map.

    ``root`` is the directory CONTAINING the top-level package(s) (e.g.
    ``src/`` → modules named ``repro_torch.core.lire``).  ``rel_to``
    controls the path rendered in findings (defaults to ``root``'s parent
    so findings read ``src/repro_torch/...`` from the repo root).
    """
    root = Path(root).resolve()
    rel_to = Path(rel_to).resolve() if rel_to else root.parent
    out: dict[str, Module] = {}
    for path in sorted(root.rglob("*.py")):
        if any(part in skip_dirs for part in path.parts):
            continue
        parts = path.relative_to(root).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts) if parts else root.name
        out[name] = Module(
            name=name, path=path, rel=rel_path(path, rel_to),
            tree=ast.parse(path.read_text(), filename=str(path)),
        )
    return out


def qualname_index(mod: Module) -> dict[str, ast.AST]:
    """{qualname: def node} for functions/classes/methods of a module
    (one level of class nesting — the repo's actual shape)."""
    out: dict[str, ast.AST] = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[node.name] = node
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def enclosing_symbol(mod: Module, lineno: int) -> str:
    """Qualname of the innermost def/class containing ``lineno`` (module
    name when at top level) — the line-stable suppression key."""
    best, best_span = mod.name, None
    for qual, node in qualname_index(mod).items():
        end = getattr(node, "end_lineno", node.lineno)
        if node.lineno <= lineno <= end:
            span = end - node.lineno
            if best_span is None or span <= best_span:
                best, best_span = f"{mod.name}.{qual}", span
    return best


def literal_str_tuple(node: ast.AST) -> tuple[str, ...] | None:
    """Evaluate a tuple/list of string constants; None if not one."""
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                vals.append(elt.value)
            else:
                return None
        return tuple(vals)
    return None


def module_assign(mod: Module, name: str) -> ast.AST | None:
    """RHS of the (last) top-level assignment to ``name`` in a module."""
    found = None
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and node.target.id == name:
                found = node.value
    return found


def import_map(mod: Module) -> dict[str, tuple[str, str]]:
    """{local name: ("mod", dotted) | ("sym", "dotted:attr")}."""
    out: dict[str, tuple[str, str]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    "mod", a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = ("sym", f"{node.module}:{a.name}")
    return out
