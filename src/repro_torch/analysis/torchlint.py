"""Torch-hygiene lint for ``engine/``: host syncs and cache hazards inside
device bodies.

The port's counterpart of ``repro.analysis.jaxlint``.  The port has no jit:
its executor caches are ``functools.lru_cache`` factories that hand out a
body per (backend, shape), where the reference's ``jax.jit`` cache stood.
A host sync inside such a body (``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``torch.cuda.synchronize()``, ``np.asarray``, ``float()`` on a
tensor; and a tensor built from host data and copied to the card there,
``torch.tensor(...).to(dev)`` or ``torch.tensor(..., device=dev)``: torch
ends a blocking copy from pageable memory with a stream synchronize) stalls
the host until the card has drained its queue, once per call: on a wave
path that is host-bound already, that is the defect this lint keeps out.  A cache hazard (a mutable-literal default on an
``lru_cache`` factory, which raises on the first call because the cache
key must hash; a body closing over a mutable module binding, which the
cached body keeps seeing as it changes) turns the caches the batch layer
depends on into surprises.

What counts as a device body:

  * a local ``def``/``lambda`` an ``lru_cache``/``cache`` factory in
    ``engine/`` returns, directly or through a same-module helper it calls
    in its ``return`` (followed up to :data:`HELPER_DEPTH` calls deep:
    ``batch._executor`` reaches ``_bucket_body``'s ``run`` through
    ``_body_for``);
  * every row of the "Device bodies" table of the tables file (the twins
    of the reference's remaining ``jax.jit`` sites, and the bodies a
    factory hands out by attribute).  A row naming a function that no
    longer exists is a ``stale-body`` finding.

``int()`` and shape arithmetic on ``.shape``/``.ndim``/``len()`` are
never flagged, as in the reference.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import (PACKAGE, TABLES, Finding, Tree,
                                       checker)

__all__ = ["check_torch_hygiene", "parse_device_bodies", "HELPER_DEPTH"]

_SCOPE = PACKAGE + "/engine/"
_HOST_NP = ("asarray", "array", "frombuffer")
_HOST_METHODS = ("item", "cpu", "tolist", "numpy")
_HOST_TENSOR = ("tensor", "as_tensor", "from_numpy")
_MUTABLE_CALLS = ("dict", "list", "set", "OrderedDict", "defaultdict")

#: How many same-module helper calls a factory's ``return`` is followed.
HELPER_DEPTH = 3


def parse_device_bodies(text: str) -> list[tuple[str, str]]:
    """``(module relpath, dotted body name)`` of every row of the tables
    file's "Device bodies" table: rows ``| `engine/x.py` | `fn[.inner]` |
    ...``, module paths relative to ``src/repro_torch/``."""
    m = re.search(r"^##+\s+Device bodies\b", text, re.M)
    if not m:
        raise ValueError(f"{TABLES} has no 'Device bodies' section")
    section = text[m.end():]
    nxt = re.search(r"^##+\s+", section, re.M)
    if nxt:
        section = section[:nxt.start()]
    rows = []
    for line in section.splitlines():
        cells = [c.strip() for c in line.strip().split("|")[1:-1]]
        if len(cells) < 2:
            continue
        mod = re.fullmatch(r"`([\w/]+\.py)`", cells[0])
        body = re.fullmatch(r"`([A-Za-z_][\w.]*)`", cells[1])
        if mod and body:
            rows.append((f"{PACKAGE}/{mod.group(1)}", body.group(1)))
    return rows


def _host_tensor(node) -> bool:
    """A tensor built from host data right here: ``torch.tensor(...)``,
    ``torch.as_tensor(...)``, ``torch.from_numpy(...)``."""
    return isinstance(node, ast.Call) and \
        isinstance(node.func, ast.Attribute) and \
        node.func.attr in _HOST_TENSOR and \
        isinstance(node.func.value, ast.Name) and \
        node.func.value.id == "torch"


def _device_kw(call: ast.Call) -> bool:
    """``device=`` naming anything but the literal ``"cpu"``."""
    return isinstance(call.func.value, ast.Name) and \
        call.func.value.id == "torch" and any(
            kw.arg == "device" and not (isinstance(kw.value, ast.Constant)
                                        and kw.value.value == "cpu")
            for kw in call.keywords)


def _shape_static(node) -> bool:
    """Expression derived from shapes/dtypes — no device value involved."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim",
                                                       "dtype", "size"):
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and \
                n.func.id == "len":
            return True
    return False


def _is_cache_decorator(d) -> bool:
    """``functools.lru_cache``/``lru_cache``/``functools.cache``/``cache``,
    bare or called."""
    if isinstance(d, ast.Call):
        d = d.func
    name = d.attr if isinstance(d, ast.Attribute) else \
        d.id if isinstance(d, ast.Name) else None
    return name in ("lru_cache", "cache")


def _is_mutable(value) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        f = value.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None
        return name in _MUTABLE_CALLS
    return False


class _BodyLint(ast.NodeVisitor):
    """Flag host syncs inside one device body."""

    def __init__(self, relpath, qual, findings):
        self.relpath = relpath
        self.qual = qual
        self.findings = findings

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_METHODS and not node.args:
                self._flag(node, f".{f.attr}()")
            elif f.attr == "synchronize":
                recv = f.value
                shown = "torch.cuda.synchronize()" if (
                    isinstance(recv, ast.Attribute) and recv.attr == "cuda"
                ) else ".synchronize()"
                self._flag(node, shown)
            elif f.attr in _HOST_NP and isinstance(f.value, ast.Name) \
                    and f.value.id in ("np", "numpy"):
                self._flag(node, f"np.{f.attr}()")
            elif f.attr in ("to", "cuda") and _host_tensor(f.value):
                self._flag(node, f"host tensor .{f.attr}()")
            elif f.attr in _HOST_TENSOR and _device_kw(node):
                self._flag(node, f"torch.{f.attr}(device=)")
        elif isinstance(f, ast.Name) and f.id == "float" and node.args:
            if not isinstance(node.args[0], ast.Constant) and \
                    not _shape_static(node.args[0]):
                self._flag(node, "float() on a tensor")
        self.generic_visit(node)

    def _flag(self, node, what):
        self.findings.append(Finding(
            "torch", "host-sync", self.relpath, node.lineno,
            f"{self.qual}:{what}",
            f"{what} inside the device body {self.qual} blocks the host "
            f"until the card has drained its queue, once per call"))


def _locals_of(fn) -> set[str]:
    args = fn.args
    local = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    for a in (args.vararg, args.kwarg):
        if a is not None:
            local.add(a.arg)
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            local.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                n is not fn:
            local.add(n.name)
        elif isinstance(n, ast.arg):
            local.add(n.arg)
    return local


def _mutable_bindings(scope) -> dict[str, int]:
    """Names a module or function body binds to a mutable value."""
    out = {}
    for stmt in scope.body:
        if isinstance(stmt, ast.Assign) and _is_mutable(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.lineno
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name) and \
                _is_mutable(stmt.value):
            out[stmt.target.id] = stmt.lineno
    return out


def _lint_body(mod, fn, qual, mutables, findings) -> None:
    lint = _BodyLint(mod.relpath, qual, findings)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        lint.visit(stmt)
    local = _locals_of(fn)
    seen = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
                n.id not in local and n.id in mutables and n.id not in seen:
            seen.add(n.id)
            findings.append(Finding(
                "torch", "cache-hazard", mod.relpath, n.lineno,
                f"{qual}:{n.id}",
                f"device body {qual} closes over the mutable binding "
                f"{n.id!r}; the cached body sees every later mutation"))


def _local_defs(fn) -> dict[str, ast.AST]:
    """Local defs and lambda assignments directly in a function body."""
    defs = {}
    for stmt in fn.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Lambda):
            defs[stmt.targets[0].id] = stmt.value
    return defs


def _returns(fn):
    """``return`` values of a function, not of the defs nested in it."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Return) and node.value is not None:
            yield node.value
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda, ast.ClassDef)):
            continue
        else:
            stack.extend(ast.iter_child_nodes(node))


def _factory_bodies(fn, top: dict, depth: int, seen: set):
    """(qualname, body) of every local def/lambda a factory returns,
    following calls of same-module functions in its returns."""
    if fn.name in seen:
        return
    seen.add(fn.name)
    defs = _local_defs(fn)
    for value in _returns(fn):
        for expr in (value.body, value.orelse) \
                if isinstance(value, ast.IfExp) else (value,):
            if isinstance(expr, ast.Lambda):
                yield f"{fn.name}.<lambda>", expr
            elif isinstance(expr, ast.Name) and expr.id in defs:
                yield f"{fn.name}.{expr.id}", defs[expr.id]
            elif isinstance(expr, ast.Call) and \
                    isinstance(expr.func, ast.Name) and \
                    expr.func.id in top and depth > 0:
                yield from _factory_bodies(top[expr.func.id], top,
                                           depth - 1, seen)


def _resolve(module: ast.Module, dotted: str):
    """A (possibly nested) function by dotted name: ``fn``,
    ``fn.inner``, ``Class.meth``."""
    scope = module
    node = None
    for part in dotted.split("."):
        node = None
        for stmt in getattr(scope, "body", []):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and stmt.name == part:
                node = stmt
                break
        if node is None:
            return None
        scope = node
    return node if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) else None


@checker("torch")
def check_torch_hygiene(tree: Tree) -> list[Finding]:
    findings: list[Finding] = []
    linted: set[tuple[str, str]] = set()
    for mod in tree.iter(_SCOPE):
        top = {s.name: s for s in mod.tree.body
               if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
        module_mut = _mutable_bindings(mod.tree)
        for fn in top.values():
            if not any(_is_cache_decorator(d) for d in fn.decorator_list):
                continue
            args = fn.args
            named = (args.posonlyargs + args.args)[
                len(args.posonlyargs + args.args) - len(args.defaults):]
            pairs = list(zip(named, args.defaults)) + [
                (a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                if d is not None]
            for a, d in pairs:
                if _is_mutable(d):
                    findings.append(Finding(
                        "torch", "cache-hazard", mod.relpath, d.lineno,
                        f"{fn.name}:{a.arg}",
                        f"cached factory {fn.name}'s argument {a.arg!r} "
                        f"defaults to a mutable literal — an lru_cache key "
                        f"must hash"))
            for qual, body in _factory_bodies(fn, top, HELPER_DEPTH, set()):
                if (mod.relpath, qual) in linted:
                    continue
                linted.add((mod.relpath, qual))
                owner = top.get(qual.split(".")[0], fn)
                _lint_body(mod, body, qual,
                           {**module_mut, **_mutable_bindings(owner)},
                           findings)

    for relpath, dotted in parse_device_bodies(tree.doc()):
        mod = tree.modules.get(relpath)
        fn = _resolve(mod.tree, dotted) if mod is not None else None
        if fn is None:
            findings.append(Finding(
                "torch", "stale-body", TABLES, 0, f"{relpath}::{dotted}",
                f"the Device bodies table names {dotted} in {relpath}, "
                f"which does not exist"))
            continue
        if (relpath, dotted) in linted:
            continue
        linted.add((relpath, dotted))
        mut = _mutable_bindings(mod.tree)
        if "." in dotted:
            owner = _resolve(mod.tree, dotted.rsplit(".", 1)[0])
            if owner is not None:
                mut.update(_mutable_bindings(owner))
        _lint_body(mod, fn, dotted, mut, findings)
    return findings
