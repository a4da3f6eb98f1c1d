"""Replay-determinism pass (SPF10x).

WAL recovery replays the logged dispatch stream through the step
builders; the result is bit-identical to the live run ONLY if (a) every
config field those dispatches read is pinned by the snapshot stamp (or
provably serving-side and declared exempt), and (b) nothing on the
dispatch path consults wall clocks, unseeded RNG (numpy's, Python's or
torch's global generator), set iteration order, or an accumulation whose
order the card does not fix.  This pass walks the conservative call graph
from the declared roots and checks both.

The call graph is reference-based: any Name/Attribute inside a function
that resolves to a known function counts as an edge — which naturally
covers ``functools.partial(lire.search, ...)``, a step builder returning
``lire.insert_batch`` and decorator wrapping, at the cost of a few false
edges (conservative = more code scanned, never less).

SPF107 is the CUDA form of the bit-exact replay invariant: PyTorch
documents some ops as nondeterministic on a CUDA tensor
(``torch.use_deterministic_algorithms``) because they accumulate with
atomics in whatever order the threads arrive.  Integer and bool sums are
exact in any order, and ``amin`` / ``amax`` do not depend on it, so a
call passes where its accumulated operand visibly is one
(``.to(torch.int32)``, ``.long()``, ``dtype=torch.int64``, ...) or its
reduction is order-free; anything else on the surface is a finding.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.common import (
    Finding, Module, enclosing_symbol, import_map, literal_str_tuple,
    module_assign,
)
from repro_torch.analysis.config import ReplaySpec

# numpy.random callables that read/seed MODULE-GLOBAL state; an explicit
# Generator from a seeded default_rng(seed) is fine.
_NP_RANDOM_GLOBAL = {
    "random", "rand", "randn", "randint", "integers", "choice", "shuffle",
    "permutation", "normal", "uniform", "seed", "standard_normal",
}

# torch samplers that draw from the global generator unless given
# ``generator=``: module functions, and the in-place tensor methods.
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
}
_TORCH_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
}
# torch calls that seed or read the global generator's state
_TORCH_GLOBAL_SEED = {"manual_seed", "seed"}

# Integer (and bool) dtypes: a sum over them is exact in any order.
_INT_DTYPES = {
    "int8", "int16", "int32", "int64", "uint8", "int", "long", "short",
    "bool",
}
_INT_CASTS = {"int", "long", "short", "bool", "byte", "char"}


# ---------------------------------------------------------------------------
# Import + symbol resolution
# ---------------------------------------------------------------------------

def _function_table(
    modules: dict[str, Module]
) -> dict[tuple[str, str], ast.AST]:
    table: dict[tuple[str, str], ast.AST] = {}
    for mod in modules.values():
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table[(mod.name, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        table[(mod.name, f"{node.name}.{sub.name}")] = sub
    return table


def _callees(
    mod: Module, fn: ast.AST, cls_name: str | None,
    table: dict[tuple[str, str], ast.AST],
) -> set[tuple[str, str]]:
    imap = import_map(mod)
    edges: set[tuple[str, str]] = set()

    def resolve(name_mod: str, name_fn: str) -> None:
        if (name_mod, name_fn) in table:
            edges.add((name_mod, name_fn))

    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            # same-module function, or a from-imported symbol
            resolve(mod.name, node.id)
            tgt = imap.get(node.id)
            if tgt and tgt[0] == "sym":
                m, s = tgt[1].split(":")
                resolve(m, s)
        elif isinstance(node, ast.Attribute):
            v = node.value
            if isinstance(v, ast.Name):
                if v.id == "self" and cls_name is not None:
                    resolve(mod.name, f"{cls_name}.{node.attr}")
                tgt = imap.get(v.id)
                if tgt is None:
                    continue
                if tgt[0] == "mod":
                    resolve(tgt[1], node.attr)
                else:  # `from pkg import mod` — the name may BE a module
                    resolve(tgt[1].replace(":", "."), node.attr)
    return edges


def reachable_functions(
    modules: dict[str, Module], roots: tuple[str, ...]
) -> dict[tuple[str, str], ast.AST]:
    """BFS over the reference graph; raises on a root the tree lacks
    (spec drift must fail loudly, not silently shrink coverage)."""
    table = _function_table(modules)
    queue: list[tuple[str, str]] = []
    for r in roots:
        m, q = r.split(":")
        if (m, q) not in table:
            raise ValueError(f"replay root not found in tree: {r}")
        queue.append((m, q))
    seen: dict[tuple[str, str], ast.AST] = {}
    while queue:
        key = queue.pop()
        if key in seen:
            continue
        fn = table[key]
        seen[key] = fn
        mod = modules[key[0]]
        cls = key[1].split(".")[0] if "." in key[1] else None
        queue.extend(_callees(mod, fn, cls, table))
    return seen


# ---------------------------------------------------------------------------
# Config class introspection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ConfigShape:
    fields: set[str]
    properties: dict[str, set[str]]   # property -> underlying field reads
    class_line: int
    module: Module


def _config_shape(modules: dict[str, Module], ref: str) -> ConfigShape:
    mod_name, cls_name = ref.split(":")
    mod = modules.get(mod_name)
    if mod is None:
        raise ValueError(f"config module not in tree: {mod_name}")
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            fields: set[str] = set()
            props: dict[str, set[str]] = {}
            for sub in node.body:
                if isinstance(sub, ast.AnnAssign) and isinstance(
                    sub.target, ast.Name
                ):
                    fields.add(sub.target.id)
                elif isinstance(sub, ast.FunctionDef) and any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in sub.decorator_list
                ):
                    reads = {
                        n.attr for n in ast.walk(sub)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"
                    }
                    props[sub.name] = reads
            # properties may read other properties — expand one level
            for name, reads in props.items():
                expanded = set()
                for r in reads:
                    expanded |= props.get(r, {r} if r in fields else set())
                props[name] = expanded & fields | (reads & fields)
            return ConfigShape(fields, props, node.lineno, mod)
    raise ValueError(f"config class not found: {ref}")


def _stamp_tuple(
    modules: dict[str, Module], ref: str
) -> tuple[tuple[str, ...], Module, int]:
    mod_name, name = ref.split(":")
    mod = modules.get(mod_name)
    if mod is None:
        raise ValueError(f"stamp module not in tree: {mod_name}")
    node = module_assign(mod, name)
    if node is None:
        raise ValueError(f"stamp tuple not found: {ref}")
    vals = literal_str_tuple(node)
    if vals is None:
        raise ValueError(f"stamp tuple is not a string-literal tuple: {ref}")
    return vals, mod, node.lineno


# ---------------------------------------------------------------------------
# Per-function scans
# ---------------------------------------------------------------------------

def _cfg_aliases(fn: ast.AST) -> set[str]:
    """Local names bound from ``<expr>.cfg`` (e.g. ``cfg = state.cfg``)."""
    out = {"cfg"}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Attribute
        ) and node.value.attr == "cfg":
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _cfg_reads(fn: ast.AST, shape: ConfigShape) -> list[tuple[str, int]]:
    """(field-or-property, line) reads of the config inside ``fn``."""
    aliases = _cfg_aliases(fn)
    reads = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Attribute):
            continue
        v = node.value
        via_alias = isinstance(v, ast.Name) and v.id in aliases
        via_chain = isinstance(v, ast.Attribute) and v.attr == "cfg"
        if (via_alias or via_chain) and (
            node.attr in shape.fields or node.attr in shape.properties
        ):
            reads.append((node.attr, node.lineno))
    return reads


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _arg(call: ast.Call, i: int, name: str) -> ast.AST | None:
    """Argument ``name``, passed at position ``i`` or by keyword."""
    if i < len(call.args):
        return call.args[i]
    return _kw(call, name)


def _is_int_dtype(node: ast.AST | None) -> bool:
    """``torch.int32`` and the other integer / bool dtypes."""
    return isinstance(node, ast.Attribute) and node.attr in _INT_DTYPES


def _shows_integer(node: ast.AST | None) -> bool:
    """The expression visibly has an integer or bool dtype:
    ``x.to(torch.int32)``, ``x.long()``, ``f(..., dtype=torch.int64)``."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _INT_CASTS and not node.args:
            return True
        if f.attr == "to" and (
            any(_is_int_dtype(a) for a in node.args)
            or _is_int_dtype(_kw(node, "dtype"))
        ):
            return True
    return _is_int_dtype(_kw(node, "dtype"))


def _truthy(node: ast.AST | None) -> bool:
    """A flag argument that may be true (absent or a literal False is not)."""
    if node is None:
        return False
    return not (isinstance(node, ast.Constant) and not node.value)


def _cuda_nondeterministic(op: str, call: ast.Call, module_form: bool) -> str | None:
    """Why ``call`` (the op ``op``, as ``torch.op(x, ...)`` when
    ``module_form`` else ``x.op(...)``) accumulates in an order the card
    does not fix; None where it does not or its operand is an integer."""
    o = 1 if module_form else 0          # the module form takes x first
    base = op.rstrip("_")
    if base in ("index_add", "scatter_add", "scatter_reduce"):
        src = _arg(call, o + 2, "source" if base == "index_add" else "src")
        if base == "scatter_reduce":
            red = _arg(call, o + 3, "reduce")
            if isinstance(red, ast.Constant) and red.value in ("amin", "amax"):
                return None
        if _shows_integer(src):
            return None
        return f"{op}() whose accumulated operand is not visibly an integer"
    if base in ("put", "index_put"):
        if not _truthy(_arg(call, o + 2, "accumulate")):
            return None
        if _shows_integer(_arg(call, o + 1, "source" if base == "put" else "values")):
            return None
        return f"{op}(accumulate=True) whose operand is not visibly an integer"
    if base == "bincount":
        w = _arg(call, o, "weights")
        if w is None or (isinstance(w, ast.Constant) and w.value is None):
            return None
        if _shows_integer(w):
            return None
        return "bincount() with weights that are not visibly an integer"
    if base == "histc":
        return "histc()"
    if base in ("median", "nanmedian"):
        if _arg(call, o, "dim") is None:
            return None
        return f"{op}() along a dim (its indices output)"
    if base == "kthvalue":
        return "kthvalue()"
    if base == "cumsum":
        if _is_int_dtype(_kw(call, "dtype")):
            return None
        if module_form:
            x = call.args[0] if call.args else _kw(call, "input")
        else:
            x = call.func.value
        if _shows_integer(x):
            return None
        return "cumsum() of an operand that is not visibly an integer"
    return None


_CUDA_ND_OPS = {
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "put", "put_", "index_put",
    "index_put_", "bincount", "histc", "median", "nanmedian", "kthvalue",
    "cumsum", "cumsum_",
}


def _nondeterminism(
    mod: Module, fn: ast.AST, qual: str
) -> list[Finding]:
    imap = import_map(mod)

    def module_of(name: str) -> str | None:
        tgt = imap.get(name)
        if tgt is None:
            return None
        return tgt[1] if tgt[0] == "mod" else tgt[1].replace(":", ".")

    out: list[Finding] = []

    def emit(rule: str, line: int, msg: str) -> None:
        out.append(Finding(rule, mod.rel, line, f"{mod.name}.{qual}", msg))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            recv = None          # the module a called attribute hangs off
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                recv = module_of(f.value.id)
                if recv == "time":
                    emit("SPF101", node.lineno,
                         f"wall-clock call time.{f.attr}() on a "
                         "replay-critical path")
                elif recv == "random":
                    emit("SPF102", node.lineno,
                         f"process-global RNG random.{f.attr}() on a "
                         "replay-critical path")
            # np.random.<fn> — module-global numpy RNG state
            if isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Attribute
            ) and f.value.attr == "random" and isinstance(
                f.value.value, ast.Name
            ) and module_of(f.value.value.id) == "numpy":
                if f.attr == "default_rng":
                    if not node.args and not node.keywords:
                        emit("SPF102", node.lineno,
                             "np.random.default_rng() without a seed on a "
                             "replay-critical path")
                elif f.attr in _NP_RANDOM_GLOBAL:
                    emit("SPF102", node.lineno,
                         f"module-global np.random.{f.attr}() on a "
                         "replay-critical path")
            # bare default_rng() imported from numpy.random
            if isinstance(f, ast.Name):
                tgt = imap.get(f.id)
                if (
                    tgt == ("sym", "numpy.random:default_rng")
                    and not node.args and not node.keywords
                ):
                    emit("SPF102", node.lineno,
                         "default_rng() without a seed on a "
                         "replay-critical path")
            # the global torch generator
            if isinstance(f, ast.Attribute):
                on_torch = recv == "torch"
                if on_torch and f.attr in _TORCH_GLOBAL_SEED:
                    emit("SPF102", node.lineno,
                         f"torch.{f.attr}() sets or reads the global torch "
                         "generator on a replay-critical path")
                elif _kw(node, "generator") is None and (
                    (on_torch and f.attr in _TORCH_SAMPLERS)
                    or (recv is None and f.attr in _TORCH_INPLACE_SAMPLERS)
                ):
                    emit("SPF102", node.lineno,
                         f"{f.attr}() without generator= draws from the "
                         "global torch generator on a replay-critical path")
                # accumulation the card orders by thread arrival
                if f.attr in _CUDA_ND_OPS and recv in (None, "torch"):
                    why = _cuda_nondeterministic(f.attr, node, recv == "torch")
                    if why is not None:
                        emit("SPF107", node.lineno,
                             f"{why}: nondeterministic on a CUDA tensor, on "
                             "a replay-critical path")
        # iteration over a set: order varies across processes (hash
        # randomization), so any dispatch built from it diverges on replay
        iters = []
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                               ast.DictComp)):
            iters.extend(g.iter for g in node.generators)
        for it in iters:
            is_set = isinstance(it, (ast.Set, ast.SetComp)) or (
                isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("set", "frozenset")
            )
            if is_set:
                emit("SPF103", it.lineno,
                     "iteration over a set in replay-critical dispatch "
                     "construction (hash order is per-process)")
    return out


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def run(modules: dict[str, Module], spec: ReplaySpec) -> list[Finding]:
    findings: list[Finding] = []
    shape = _config_shape(modules, spec.config_class)
    critical, crit_mod, crit_line = _stamp_tuple(modules, spec.critical_stamp)
    exempt, ex_mod, ex_line = _stamp_tuple(modules, spec.exempt_stamp)
    classified = set(critical) | set(exempt)

    # SPF105/106 — the classification itself must partition the config
    for f in sorted(shape.fields - classified):
        findings.append(Finding(
            "SPF105", crit_mod.rel, crit_line,
            enclosing_symbol(crit_mod, crit_line),
            f"config field {f!r} is in neither "
            "REPLAY_CRITICAL_FIELDS nor REPLAY_EXEMPT_FIELDS",
        ))
    for name, where_mod, where_line in (
        [(n, crit_mod, crit_line) for n in critical]
        + [(n, ex_mod, ex_line) for n in exempt]
    ):
        if name not in shape.fields:
            findings.append(Finding(
                "SPF106", where_mod.rel, where_line,
                enclosing_symbol(where_mod, where_line),
                f"stamped name {name!r} is not a config field (stale stamp)",
            ))

    # SPF101–104, 107 over the reachable dispatch surface
    for (mod_name, qual), fn in sorted(
        reachable_functions(modules, spec.roots).items()
    ):
        mod = modules[mod_name]
        findings.extend(_nondeterminism(mod, fn, qual))
        for field, line in _cfg_reads(fn, shape):
            under = shape.properties.get(field, {field})
            missing = sorted(set(under) - classified)
            if missing:
                findings.append(Finding(
                    "SPF104", mod.rel, line, f"{mod.name}.{qual}",
                    f"config read .{field} on the replay path but "
                    f"{missing} stamped in neither REPLAY_CRITICAL_FIELDS "
                    "nor REPLAY_EXEMPT_FIELDS",
                ))
    return findings
