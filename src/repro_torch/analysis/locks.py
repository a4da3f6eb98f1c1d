"""Lock-discipline pass (SPF20x).

Opt-in per class: a class that declares a ``FIELD_OWNERSHIP`` map (see
`repro_torch.serve.ownership`) gets every ``self.<field>`` access in its
methods checked against the declared category:

* ``guarded``   — reads AND writes only inside a lexical
                  ``with self._work:`` block or a ``@holds_work`` method
                  (whose callers are in turn checked, SPF207);
* ``pump``      — written only by the pump thread's methods
                  (``PUMP_METHODS``) or lifecycle methods (which run
                  strictly before/after the pump thread); reads are
                  unrestricted (racy-but-benign pointer/flag reads);
* ``init``      — written only in ``__init__``;
* ``lifecycle`` — written only in ``LIFECYCLE_METHODS`` (+ ``__init__``).

``__init__`` is exempt from the guarded check: construction precedes
sharing.  The map must also be exact: every assigned field appears in it
(SPF205) and every declared field is assigned somewhere (SPF206).

A category may be written as a string or as a name bound to one (the
engine writes ``GUARDED``, imported from ``serve/ownership.py``); a map
the pass cannot evaluate raises, so a class is never skipped silently.
"""
from __future__ import annotations

import ast
import dataclasses

from repro_torch.analysis.common import (
    Finding, Module, import_map, literal_str_tuple, module_assign,
)
from repro_torch.analysis.config import LockSpec

CATEGORIES = ("guarded", "pump", "init", "lifecycle")


@dataclasses.dataclass
class ClassDecl:
    node: ast.ClassDef
    ownership: dict[str, str]
    lock_field: str
    pump_methods: set[str]
    lifecycle_methods: set[str]
    holds_methods: set[str]


def _str_constants(mod: Module, modules: dict[str, Module]) -> dict[str, str]:
    """Names a module can use for a string: its own top-level string
    assignments and those it imports by name from a module in the tree."""
    out: dict[str, str] = {}
    for name, (kind, ref) in import_map(mod).items():
        if kind != "sym":
            continue
        src, attr = ref.split(":")
        node = module_assign(modules[src], attr) if src in modules else None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out[name] = node.value
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out[tgt.id] = node.value.value
    return out


def _str_dict(node: ast.AST, consts: dict[str, str]) -> dict[str, str] | None:
    if not isinstance(node, ast.Dict):
        return None
    out = {}
    for k, v in zip(node.keys, node.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            out[k.value] = v.value
        elif isinstance(v, ast.Name) and v.id in consts:
            out[k.value] = consts[v.id]
        else:
            return None
    return out


def _class_decl(
    mod: Module, cls: ast.ClassDef, consts: dict[str, str]
) -> ClassDecl | None:
    ownership = None
    lock_field = "_work"
    pump: set[str] = set()
    life: set[str] = set()
    for sub in cls.body:
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                isinstance(sub.targets[0], ast.Name):
            name = sub.targets[0].id
            if name == "FIELD_OWNERSHIP":
                ownership = _str_dict(sub.value, consts)
                if ownership is None:
                    raise ValueError(
                        f"{mod.rel}:{sub.lineno}: {cls.name}.FIELD_OWNERSHIP "
                        "is not a dict of field names to categories the "
                        "lock pass can evaluate"
                    )
            elif name == "LOCK_FIELD":
                if isinstance(sub.value, ast.Constant):
                    lock_field = sub.value.value
            elif name == "PUMP_METHODS":
                pump = set(literal_str_tuple(sub.value) or ())
            elif name == "LIFECYCLE_METHODS":
                life = set(literal_str_tuple(sub.value) or ())
    if ownership is None:
        return None
    holds = set()
    for sub in cls.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in sub.decorator_list:
                name = d.id if isinstance(d, ast.Name) else (
                    d.attr if isinstance(d, ast.Attribute) else None
                )
                if name == "holds_work":
                    holds.add(sub.name)
    return ClassDecl(cls, ownership, lock_field, pump, life, holds)


def _locked_spans(
    meth: ast.AST, lock_field: str
) -> list[tuple[int, int]]:
    spans = []
    for node in ast.walk(meth):
        if isinstance(node, ast.With):
            for item in node.items:
                e = item.context_expr
                # `with self._work:` or `with self.exclusive():`
                if isinstance(e, ast.Attribute) and isinstance(
                    e.value, ast.Name
                ) and e.value.id == "self" and e.attr == lock_field:
                    spans.append((node.lineno, node.end_lineno))
                elif isinstance(e, ast.Call) and isinstance(
                    e.func, ast.Attribute
                ) and isinstance(e.func.value, ast.Name) and \
                        e.func.value.id == "self" and \
                        e.func.attr == "exclusive":
                    spans.append((node.lineno, node.end_lineno))
    return spans


def _check_class(mod: Module, decl: ClassDecl) -> list[Finding]:
    cls = decl.node
    findings: list[Finding] = []
    assigned: set[str] = set()

    for f, cat in decl.ownership.items():
        if cat not in CATEGORIES:
            raise ValueError(f"{mod.rel}: {cls.name}.FIELD_OWNERSHIP[{f!r}] "
                             f"is {cat!r}, not one of {CATEGORIES}")

    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        qual = f"{mod.name}.{cls.name}.{meth.name}"
        is_init = meth.name == "__init__"
        holds = meth.name in decl.holds_methods
        is_pump = meth.name in decl.pump_methods
        is_life = meth.name in decl.lifecycle_methods
        spans = _locked_spans(meth, decl.lock_field)

        def locked(line: int) -> bool:
            return holds or any(a <= line <= b for a, b in spans)

        for node in ast.walk(meth):
            # --- self.<field> accesses against the ownership map ---
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ) and node.value.id == "self":
                f = node.attr
                is_store = isinstance(node.ctx, (ast.Store, ast.Del))
                if is_store:
                    assigned.add(f)
                cat = decl.ownership.get(f)
                if cat is None:
                    if is_store and not f.startswith("__"):
                        findings.append(Finding(
                            "SPF205", mod.rel, node.lineno, qual,
                            f"self.{f} assigned but missing from "
                            f"{cls.name}.FIELD_OWNERSHIP",
                        ))
                    continue
                line = node.lineno
                if cat == "guarded" and not is_init and not locked(line):
                    findings.append(Finding(
                        "SPF202" if is_store else "SPF201",
                        mod.rel, line, qual,
                        f"{'write to' if is_store else 'read of'} "
                        f"guarded field self.{f} outside "
                        f"`with self.{decl.lock_field}`",
                    ))
                elif cat == "pump" and is_store and not (
                    is_pump or is_life or is_init
                ):
                    findings.append(Finding(
                        "SPF203", mod.rel, line, qual,
                        f"write to pump-thread-only field self.{f} from "
                        "a non-pump, non-lifecycle method",
                    ))
                elif cat == "init" and is_store and not is_init:
                    findings.append(Finding(
                        "SPF204", mod.rel, line, qual,
                        f"write to init-only field self.{f} outside "
                        "__init__",
                    ))
                elif cat == "lifecycle" and is_store and not (
                    is_life or is_init
                ):
                    findings.append(Finding(
                        "SPF204", mod.rel, line, qual,
                        f"write to lifecycle field self.{f} outside "
                        f"{sorted(decl.lifecycle_methods)}",
                    ))
            # --- calls into @holds_work methods need the lock ---
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self" and \
                    node.func.attr in decl.holds_methods:
                if not (is_init or locked(node.lineno)):
                    findings.append(Finding(
                        "SPF207", mod.rel, node.lineno, qual,
                        f"call to @holds_work method self."
                        f"{node.func.attr}() without holding "
                        f"self.{decl.lock_field}",
                    ))

    for f in sorted(set(decl.ownership) - assigned):
        findings.append(Finding(
            "SPF206", mod.rel, cls.lineno, f"{mod.name}.{cls.name}",
            f"FIELD_OWNERSHIP declares {f!r} but the class never "
            "assigns it (stale declaration)",
        ))
    return findings


def checked_classes(
    modules: dict[str, Module], spec: LockSpec
) -> list[tuple[Module, ClassDecl]]:
    """Every class under the spec's prefixes that declares an ownership map."""
    out = []
    for mod in modules.values():
        if not mod.name.startswith(spec.module_prefixes):
            continue
        consts = _str_constants(mod, modules)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                decl = _class_decl(mod, node, consts)
                if decl is not None:
                    out.append((mod, decl))
    return out


def run(modules: dict[str, Module], spec: LockSpec) -> list[Finding]:
    findings: list[Finding] = []
    for mod, decl in checked_classes(modules, spec):
        findings.extend(_check_class(mod, decl))
    return findings
