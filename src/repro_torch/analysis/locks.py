"""Interprocedural lock-order analysis against the documented hierarchy.

The port's twin of ``repro.analysis.locks``, over ``src/repro_torch`` and
the lock table of the port's tables file (``TABLES.md`` beside this
module).

Three layers:

  1. **Inventory** — every ``threading.Lock/RLock/Condition`` the tree
     creates, with a stable id and its creation site.  Attribute locks
     are ``Class._name``; module globals ``modstem.NAME``; function
     locals ``qual.var``.  The runtime witness
     (:mod:`repro_torch.analysis.witness`) keys observed locks back to these
     ids by creation site, so both sides speak one vocabulary.
  2. **Acquisition graph** — per function/method, an ordered event list
     (``with lock:`` push/pop, explicit ``.acquire()``/``.release()``,
     resolved call sites).  A fixpoint over method summaries propagates
     transitive acquisitions, locks still held at return (the store's
     two-phase ``prepare_segment`` → ``commit_segment`` protocol), and
     entry releases, then a replay per method yields the global
     ``(held, acquired)`` edge set.
  3. **Hierarchy check** — ranks parsed from the tables file's
     "Lock hierarchy" table (lower rank = outer).  An edge whose outer
     rank is not strictly lower is an inversion; locks that participate
     in nesting but have no table row are findings too, so the table
     stays the single complete source of truth.

Resolution is best-effort and silent on what it cannot see (dynamic
dispatch, locks passed as bare arguments): missing edges weaken the
check, they never fabricate findings.
"""
from __future__ import annotations

import ast
import dataclasses
import re

from repro_torch.analysis.core import TABLES, Finding, Tree, checker

__all__ = ["LockDef", "collect_inventory", "build_edges",
           "parse_hierarchy", "check_lock_order"]

_FACTORIES = {"Lock", "RLock", "Condition"}


@dataclasses.dataclass(frozen=True)
class LockDef:
    id: str
    relpath: str
    line: int
    kind: str                  # Lock | RLock | Condition


def _is_lock_factory(call: ast.expr) -> str | None:
    """'threading.Lock'-style constructor -> kind name, else None."""
    if (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id == "threading"
            and call.func.attr in _FACTORIES):
        return call.func.attr
    return None


def _modstem(relpath: str) -> str:
    return relpath.rsplit("/", 1)[-1][:-3]


# ---------------------------------------------------------------- inventory
def collect_inventory(tree: Tree) -> dict[str, LockDef]:
    """Every lock the tree creates, keyed by id.  Duplicate ids (same
    class+attr defined twice) keep the first definition; the witness
    tolerates multiple creation sites per id."""
    defs: dict[str, LockDef] = {}

    def add(lid: str, mod, node, kind: str) -> None:
        defs.setdefault(lid, LockDef(lid, mod.relpath, node.lineno, kind))

    for mod in tree.iter():
        for node in mod.tree.body:          # module-level globals
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                kind = _is_lock_factory(node.value)
                if kind:
                    add(f"{_modstem(mod.relpath)}.{node.targets[0].id}",
                        mod, node.value, kind)
        for cls, fn, qual in _iter_functions(mod.tree):
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign) or \
                        len(stmt.targets) != 1:
                    continue
                kind = _is_lock_factory(stmt.value)
                if not kind:
                    continue
                tgt = stmt.targets[0]
                if (cls is not None and isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    add(f"{cls.name}.{tgt.attr}", mod, stmt.value, kind)
                elif isinstance(tgt, ast.Name):
                    add(f"{qual}.{tgt.id}", mod, stmt.value, kind)
    return defs


def _iter_functions(module: ast.Module):
    """Yield (classdef_or_None, functiondef, qualname) for every
    function/method, including nested defs (qualified by their parent)."""
    def rec(node, cls, prefix):
        for child in node.body if hasattr(node, "body") else []:
            if isinstance(child, ast.ClassDef):
                yield from rec(child, child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                yield cls, child, qual
                yield from rec(child, cls, qual)
    yield from rec(module, None, "")


# -------------------------------------------------------- attr-type inference
def _ann_name(t, class_names) -> str | None:
    """A Name / string-constant annotation naming a known class."""
    if isinstance(t, ast.Name) and t.id in class_names:
        return t.id
    if isinstance(t, ast.Constant) and str(t.value) in class_names:
        return str(t.value)
    return None


def _collect_attr_types(tree: Tree) -> dict[str, dict[str, str]]:
    """{ClassName: {attr: ClassName}} — from ctor calls
    (``self.x = Foo(...)``), annotated-parameter aliasing
    (``def __init__(self, svc: "BitmapService"): self.x = svc``),
    annotated ``@property`` returns, and a fixpoint over attribute
    chains (``self.store = indexer.store``)."""
    class_names = {n.name for m in tree.iter()
                   for n in ast.walk(m.tree) if isinstance(n, ast.ClassDef)}
    out: dict[str, dict[str, str]] = {}
    # (cls, attr, value_expr, ann_map) deferred until the fixpoint
    pending: list[tuple[str, str, ast.expr, dict[str, str]]] = []
    for mod in tree.iter():
        for cls, fn, _ in _iter_functions(mod.tree):
            if cls is None:
                continue
            is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                          for d in fn.decorator_list)
            if is_prop:
                name = _ann_name(fn.returns, class_names)
                if name:
                    out.setdefault(cls.name, {})[fn.name] = name
            ann: dict[str, str] = {}
            for a in fn.args.args + fn.args.kwonlyargs:
                name = _ann_name(a.annotation, class_names)
                if name:
                    ann[a.arg] = name
            for stmt in ast.walk(fn):
                tgt = value = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt, value = stmt.targets[0], stmt.value
                elif isinstance(stmt, ast.AnnAssign):
                    tgt, value = stmt.target, stmt.value
                    name = _ann_name(stmt.annotation, class_names)
                    if name and isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        out.setdefault(cls.name, {})[tgt.attr] = name
                        continue
                if tgt is None or value is None:
                    continue
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if isinstance(value, ast.Call):
                    f = value.func
                    name = None
                    if isinstance(f, ast.Name) and f.id in class_names:
                        name = f.id
                    elif isinstance(f, ast.Attribute) and \
                            f.attr in class_names:
                        name = f.attr
                    if name:
                        out.setdefault(cls.name, {})[tgt.attr] = name
                else:
                    pending.append((cls.name, tgt.attr, value, ann))

    def resolve(expr, cls_name, ann):
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return cls_name
            return ann.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = resolve(expr.value, cls_name, ann)
            if base is not None:
                return out.get(base, {}).get(expr.attr)
        return None

    for _ in range(10):
        changed = False
        for cls_name, attr, value, ann in pending:
            if attr in out.get(cls_name, {}):
                continue
            name = resolve(value, cls_name, ann)
            if name:
                out.setdefault(cls_name, {})[attr] = name
                changed = True
        if not changed:
            break
    return out


# ------------------------------------------------------------ event extraction
@dataclasses.dataclass
class _Summary:
    qual: str                  # "Class.meth" or "modstem.fn"
    relpath: str
    events: list               # ("push"/"pop"/"acquire"/"release", id, line)
                               # | ("call", calleekey, line)
    acquires: set = dataclasses.field(default_factory=set)
    held_at_return: set = dataclasses.field(default_factory=set)
    releases_entry: set = dataclasses.field(default_factory=set)


class _FnWalker(ast.NodeVisitor):
    """Linearize one function into lock events + resolved call sites."""

    def __init__(self, mod, cls, qual, lock_ids, attr_types, imports,
                 class_of_module, local_types):
        self.mod = mod
        self.cls = cls
        self.qual = qual
        self.lock_ids = lock_ids
        self.attr_types = attr_types
        self.imports = imports          # alias -> module stem
        self.class_of_module = class_of_module  # ClassName -> exists
        self.local_types = local_types  # var -> ClassName (per function)
        self.events: list = []

    # -- resolution helpers
    def _lock_of(self, expr) -> str | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and self.cls is not None:
            lid = f"{self.cls.name}.{expr.attr}"
            return lid if lid in self.lock_ids else None
        if isinstance(expr, ast.Name):
            lid = f"{self.qual}.{expr.id}"
            if lid in self.lock_ids:
                return lid
            lid = f"{_modstem(self.mod.relpath)}.{expr.id}"
            return lid if lid in self.lock_ids else None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id in self.imports:
            lid = f"{self.imports[expr.value.id]}.{expr.attr}"
            return lid if lid in self.lock_ids else None
        if isinstance(expr, ast.Attribute):
            # cross-object direct acquisition: `self.store._flush_lock`,
            # `indexer._mu` — resolve the receiver chain to a class
            base = self._type_of(expr.value)
            if base is not None:
                lid = f"{base}.{expr.attr}"
                return lid if lid in self.lock_ids else None
        return None

    def _type_of(self, expr) -> str | None:
        """Best-effort class of an expression (self / self.attr chains /
        typed locals)."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and self.cls is not None:
                return self.cls.name
            return self.local_types.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value)
            if base is not None:
                return self.attr_types.get(base, {}).get(expr.attr)
        return None

    def _callee_of(self, call: ast.Call) -> str | None:
        f = call.func
        if isinstance(f, ast.Attribute):
            base = self._type_of(f.value)
            if base is not None:
                return f"{base}.{f.attr}"
            if isinstance(f.value, ast.Name) and \
                    f.value.id in self.imports:
                return f"{self.imports[f.value.id]}.{f.attr}"
            return None
        if isinstance(f, ast.Name):
            if f.id in self.class_of_module:       # ctor call
                return f"{f.id}.__init__"
            return f"{_modstem(self.mod.relpath)}.{f.id}"
        return None

    # -- traversal
    def visit_With(self, node: ast.With) -> None:
        pushed = []
        for item in node.items:
            lid = self._lock_of(item.context_expr)
            if lid is None and isinstance(item.context_expr, ast.Call):
                # `with cv:` only; `with maybe_span(...)` etc: still
                # visit the call for nested resolution
                self.visit(item.context_expr)
            if lid is not None:
                self.events.append(("push", lid, node.lineno))
                pushed.append(lid)
        for stmt in node.body:
            self.visit(stmt)
        for lid in reversed(pushed):
            self.events.append(("pop", lid, node.lineno))

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in \
                ("acquire", "release"):
            lid = self._lock_of(f.value)
            if lid is not None:
                kind = "acquire" if f.attr == "acquire" else "release"
                self.events.append((kind, lid, node.lineno))
                for a in node.args:
                    self.visit(a)
                return
        callee = self._callee_of(node)
        if callee is not None:
            self.events.append(("call", callee, node.lineno))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # track `x = ClassName(...)` for later `x.meth()` resolution
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id in self.class_of_module):
            self.local_types[node.targets[0].id] = node.value.func.id
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        pass                                     # nested defs walked separately

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:
        pass


def _collect_imports(mod) -> dict[str, str]:
    """alias -> module stem, for package-internal imports only."""
    out: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                stem = a.name
                out[a.asname or a.name] = stem
        elif isinstance(node, ast.Import):
            for a in node.names:
                stem = a.name.rsplit(".", 1)[-1]
                out[a.asname or a.name.split(".")[0]] = stem
    return out


def build_summaries(tree: Tree, lock_ids: set
                    ) -> dict[str, _Summary]:
    attr_types = _collect_attr_types(tree)
    class_names = {n.name for m in tree.iter()
                   for n in ast.walk(m.tree) if isinstance(n, ast.ClassDef)}
    summaries: dict[str, _Summary] = {}
    for mod in tree.iter():
        imports = _collect_imports(mod)
        for cls, fn, qual in _iter_functions(mod.tree):
            key = (f"{cls.name}.{fn.name}" if cls is not None
                   else f"{_modstem(mod.relpath)}.{fn.name}")
            w = _FnWalker(mod, cls, qual, lock_ids, attr_types, imports,
                          class_names, {})
            for stmt in fn.body:
                w.visit(stmt)
            if key not in summaries:       # first def wins on collision
                summaries[key] = _Summary(key, mod.relpath, w.events)
    return summaries


# ------------------------------------------------------------------ fixpoint
def _replay(s: _Summary, summaries, record_edges=None):
    """One replay of a summary's events against current callee
    summaries.  Returns (acquires, held_at_return, releases_entry);
    optionally records (held, acquired, line) edge triples."""
    held: list[str] = []
    acquires: set[str] = set()
    releases_entry: set[str] = set()
    ever_acquired: set[str] = set()

    def do_acquire(lid, line):
        acquires.add(lid)
        ever_acquired.add(lid)
        if record_edges is not None:
            for h in held:
                if h != lid:
                    record_edges.add((h, lid, line))
        held.append(lid)

    def do_release(lid):
        if lid in held:
            held.reverse()
            held.remove(lid)
            held.reverse()
        elif lid not in ever_acquired:
            releases_entry.add(lid)

    for ev in s.events:
        kind, name, line = ev
        if kind in ("push", "acquire"):
            do_acquire(name, line)
        elif kind in ("pop", "release"):
            do_release(name)
        elif kind == "call":
            cs = summaries.get(name)
            if cs is None or cs is s:
                continue
            for a in sorted(cs.acquires):
                acquires.add(a)
                if record_edges is not None:
                    for h in held:
                        if h != a:
                            record_edges.add((h, a, line))
            for lid in sorted(cs.held_at_return):
                if lid not in held:
                    held.append(lid)
                    ever_acquired.add(lid)
            for lid in sorted(cs.releases_entry):
                do_release(lid)
    return acquires, set(held), releases_entry


def build_edges(tree: Tree, lock_defs: dict[str, LockDef]
                ) -> tuple[set, dict[str, _Summary]]:
    """Fixpoint over summaries, then an edge-recording replay.
    Edges are ``(outer_id, inner_id, line)`` triples."""
    summaries = build_summaries(tree, set(lock_defs))
    for _ in range(24):
        changed = False
        for s in summaries.values():
            acq, ret, rel = _replay(s, summaries)
            if (acq, ret, rel) != (s.acquires, s.held_at_return,
                                   s.releases_entry):
                s.acquires, s.held_at_return, s.releases_entry = \
                    acq, ret, rel
                changed = True
        if not changed:
            break
    edges: set = set()
    edge_sites: dict[tuple[str, str], tuple[str, int]] = {}
    for s in summaries.values():
        local: set = set()
        _replay(s, summaries, record_edges=local)
        for (a, b, line) in local:
            edges.add((a, b))
            edge_sites.setdefault((a, b), (s.relpath, line))
    return {(a, b, *edge_sites[(a, b)]) for (a, b) in edges}, summaries


# ----------------------------------------------------------------- hierarchy
_ROW = re.compile(r"^\s*\|\s*(\d+)\s*\|(.+?)\|")
_TICK = re.compile(r"`([A-Za-z_][\w.]*)`")


def parse_hierarchy(arch_text: str) -> dict[str, int]:
    """Parse the tables file's "Lock hierarchy" table: rows
    ``| <rank> | `LockId`[, `LockId`...] | ... |``.  Lower rank =
    outer.  Raises if the section or table is missing — the docs ARE
    the config."""
    m = re.search(r"^##+\s+Lock hierarchy\b", arch_text, re.M)
    if not m:
        raise ValueError(f"{TABLES} has no 'Lock hierarchy' section")
    section = arch_text[m.end():]
    nxt = re.search(r"^##+\s+", section, re.M)
    if nxt:
        section = section[:nxt.start()]
    ranks: dict[str, int] = {}
    for line in section.splitlines():
        row = _ROW.match(line)
        if not row:
            continue
        rank = int(row.group(1))
        for lid in _TICK.findall(row.group(2)):
            if lid in ranks:
                raise ValueError(f"lock {lid!r} ranked twice in "
                                 f"{TABLES}")
            ranks[lid] = rank
    if not ranks:
        raise ValueError("Lock hierarchy table parsed to zero rows")
    return ranks


# -------------------------------------------------------------------- checker
@checker("locks")
def check_lock_order(tree: Tree) -> list[Finding]:
    lock_defs = collect_inventory(tree)
    edges, _ = build_edges(tree, lock_defs)
    ranks = parse_hierarchy(tree.doc())
    findings: list[Finding] = []

    participants = {a for a, b, *_ in edges} | {b for a, b, *_ in edges}
    for lid in sorted(participants - set(ranks)):
        d = lock_defs[lid]
        findings.append(Finding(
            "locks", "unranked", d.relpath, d.line, lid,
            f"lock {lid} participates in nesting but has no rank in the "
            f"lock-hierarchy table of {TABLES}"))

    for (a, b, relpath, line) in sorted(edges):
        ra, rb = ranks.get(a), ranks.get(b)
        if ra is None or rb is None or a == b:
            continue
        if ra >= rb:
            findings.append(Finding(
                "locks", "inversion", relpath, line, f"{a}->{b}",
                f"{a} (rank {ra}) held while acquiring {b} (rank {rb}); "
                f"the documented hierarchy requires strictly "
                f"outer-to-inner (lower rank first)"))

    # cycles independent of ranks (catches problems even in unranked sets)
    adj: dict[str, set[str]] = {}
    for a, b, *_ in edges:
        if a != b:
            adj.setdefault(a, set()).add(b)
    for a in sorted(adj):
        stack, seen = [(a, iter(sorted(adj.get(a, ()))))], {a}
        path = [a]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                stack.pop()
                path.pop()
                continue
            if nxt == a:
                cyc = "->".join(path + [a])
                sym = "->".join(sorted(set(path)))
                if not any(f.rule == "cycle" and f.symbol == sym
                           for f in findings):
                    d = lock_defs[a]
                    findings.append(Finding(
                        "locks", "cycle", d.relpath, d.line, sym,
                        f"lock acquisition cycle: {cyc}"))
            elif nxt not in seen:
                seen.add(nxt)
                path.append(nxt)
                stack.append((nxt, iter(sorted(adj.get(nxt, ())))))
    return findings
