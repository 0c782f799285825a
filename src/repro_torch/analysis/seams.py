"""Seam-coverage checker: durable I/O in ``store/``/``fabric/`` must be
fault-injectable.

The port's twin of ``repro.analysis.seams``, scoped to
``src/repro_torch/store/`` and ``src/repro_torch/fabric/``.

The fault fabric only stays honest if every byte that reaches a disk or
a socket passes a ``repro_torch.fault.seam.fire`` site — otherwise new write
paths silently escape the chaos harness and its "zero acked-write loss"
gate stops meaning anything.  Rule: within any function in ``store/`` or
``fabric/`` that performs raw durable I/O —

  * ``os.fsync(...)`` / ``os.open`` with write flags,
  * builtin ``open(...)`` in a write-capable mode,
  * ``.send``/``.sendall``/``.sendto`` on a ``socket.socket``-typed
    receiver (annotation- or construction-inferred; transport futures'
    ``.send`` is not a socket and is not flagged),
  * ``.write(...)`` on a handle that same function opened or received
    as a ``BinaryIO``/``IO`` parameter (``io.BytesIO`` buffers are not
    I/O and are not flagged),

— the function must also contain a ``seam.fire(...)`` call (or a
``_Gate.admit`` gate, the transport idiom that fires the rpc seams).
Legitimately unseamed paths (e.g. ``fsync_dir`` metadata syncs) live in
the committed baseline with one-line reasons, not in blind spots.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, Tree, checker

__all__ = ["check_seam_coverage"]

_SCOPES = ("src/repro_torch/store/", "src/repro_torch/fabric/")
_SEND = ("send", "sendall", "sendto")
_WRITE_FLAGS = ("O_WRONLY", "O_RDWR", "O_CREAT", "O_APPEND", "O_TRUNC")


def _mode_is_write(call: ast.Call) -> bool:
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if not isinstance(mode, str):
        return False
    return any(c in mode for c in "wa+x")


def _os_open_is_write(call: ast.Call) -> bool:
    for node in ast.walk(call):
        if isinstance(node, ast.Attribute) and node.attr in _WRITE_FLAGS:
            return True
    return False


class _Scanner(ast.NodeVisitor):
    """Per-function scan: raw-I/O sites, seam fires, and local handle /
    socket typing."""

    def __init__(self):
        self.io_sites: list[tuple[int, str]] = []   # (line, what)
        self.fires = False
        self.file_handles: set[str] = set()
        self.buffers: set[str] = set()
        self.sockets: set[str] = set()

    def scan(self, fn) -> None:
        for a in fn.args.args + fn.args.kwonlyargs:
            t = a.annotation
            names = [n.id if isinstance(n, ast.Name) else n.attr
                     for n in ast.walk(t)
                     if isinstance(n, (ast.Name, ast.Attribute))] if t \
                else []
            if any(n in ("BinaryIO", "IO", "TextIO") for n in names):
                self.file_handles.add(a.arg)
            if "socket" in names:
                self.sockets.add(a.arg)
        for stmt in fn.body:
            self.visit(stmt)

    # ---- typing from assignments / with-items
    def _bind(self, name: str, value) -> None:
        if not isinstance(value, ast.Call):
            return
        f = value.func
        if isinstance(f, ast.Name) and f.id == "open":
            self.file_handles.add(name)
        elif isinstance(f, ast.Attribute) and f.attr == "BytesIO":
            self.buffers.add(name)
        elif isinstance(f, ast.Attribute) and f.attr == "StringIO":
            self.buffers.add(name)
        elif isinstance(f, ast.Attribute) and f.attr == "socket" and \
                isinstance(f.value, ast.Name) and f.value.id == "socket":
            self.sockets.add(name)

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            self._bind(node.targets[0].id, node.value)
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if isinstance(item.optional_vars, ast.Name):
                self._bind(item.optional_vars.id, item.context_expr)
        self.generic_visit(node)

    # ---- the interesting calls
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            recv = f.value
            if f.attr == "fire" and isinstance(recv, ast.Name) and \
                    recv.id in ("seam", "fault_seam"):
                self.fires = True
            elif f.attr == "admit":
                self.fires = True          # transport gate fires rpc seams
            elif f.attr == "fsync" and isinstance(recv, ast.Name) and \
                    recv.id == "os":
                self.io_sites.append((node.lineno, "os.fsync"))
            elif f.attr == "open" and isinstance(recv, ast.Name) and \
                    recv.id == "os" and _os_open_is_write(node):
                self.io_sites.append((node.lineno, "os.open(write)"))
            elif f.attr in _SEND and isinstance(recv, ast.Name) and \
                    recv.id in self.sockets:
                self.io_sites.append((node.lineno, f"socket.{f.attr}"))
            elif f.attr == "write" and isinstance(recv, ast.Name):
                if recv.id in self.file_handles and \
                        recv.id not in self.buffers:
                    self.io_sites.append((node.lineno, "file.write"))
        elif isinstance(f, ast.Name):
            if f.id == "fire":
                self.fires = True
            elif f.id == "open" and _mode_is_write(node):
                self.io_sites.append((node.lineno, "open(write)"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        pass                                     # nested defs scanned separately

    visit_AsyncFunctionDef = visit_FunctionDef


def _iter_fns(module: ast.Module):
    def rec(node, prefix):
        for child in getattr(node, "body", []):
            if isinstance(child, ast.ClassDef):
                yield from rec(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                yield child, qual
                yield from rec(child, qual)
    yield from rec(module, "")


@checker("seams")
def check_seam_coverage(tree: Tree) -> list[Finding]:
    findings: list[Finding] = []
    for mod in tree.iter():
        if not any(mod.relpath.startswith(s) for s in _SCOPES):
            continue
        for fn, qual in _iter_fns(mod.tree):
            sc = _Scanner()
            sc.scan(fn)
            if sc.fires or not sc.io_sites:
                continue
            for line, what in sc.io_sites:
                findings.append(Finding(
                    "seams", "unseamed-io", mod.relpath, line,
                    f"{qual}:{what}",
                    f"{qual} performs raw {what} without a fault-seam "
                    f"fire in scope — this write path is invisible to "
                    f"the chaos harness"))
    return findings
