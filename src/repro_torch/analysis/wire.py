"""Wire-exhaustiveness: request kinds, host handlers, and reply kinds
must stay closed sets.

The port's twin of ``repro.analysis.wire``, scoped to
``src/repro_torch/fabric/``.

``ServiceHost`` dispatches ``getattr(self, f"_on_{env.kind}")`` — a
request kind without a handler only fails at runtime, on the wire, as
an ``error`` reply.  This checker closes the loop statically:

  * every ``Envelope("<kind>")`` the tree constructs outside the host
    module must have a matching ``_on_<kind>`` handler;
  * every ``_on_<kind>`` handler must have at least one sender (dead
    handlers hide protocol drift);
  * every reply kind the client side compares against
    (``reply.kind == "..."``) must be a kind some handler actually
    sends via ``env.reply(...)``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import Finding, Tree, checker

__all__ = ["check_wire"]

_SCOPE = "src/repro_torch/fabric/"


def _const_str(node) -> str | None:
    return node.value if isinstance(node, ast.Constant) and \
        isinstance(node.value, str) else None


@checker("wire")
def check_wire(tree: Tree) -> list[Finding]:
    handlers: dict[str, tuple[str, int]] = {}
    host_rel = None
    requests: dict[str, tuple[str, int]] = {}
    replies: dict[str, tuple[str, int]] = {}
    reply_refs: dict[str, tuple[str, int]] = {}

    # the host is the class with the most _on_<kind> handlers (callback
    # classes elsewhere may have an incidental _on_ method)
    best = 0
    for mod in tree.iter(_SCOPE):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                ons = [n for n in node.body
                       if isinstance(n, ast.FunctionDef)
                       and n.name.startswith("_on_")]
                if len(ons) > best:
                    best = len(ons)
                    host_rel = mod.relpath
                    handlers = {fn.name[4:]: (mod.relpath, fn.lineno)
                                for fn in ons}
    if len(handlers) < 2:
        return []

    # kind-forwarding wrappers: `def _broadcast(self, kind, ...)` whose
    # body constructs Envelope(kind) — call-site constants count as sends
    wrappers: dict[str, int] = {}        # func name -> kind param index
    for mod in tree.iter(_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            params = [a.arg for a in node.args.args if a.arg != "self"]
            for call in ast.walk(node):
                if isinstance(call, ast.Call) and \
                        isinstance(call.func, ast.Name) and \
                        call.func.id == "Envelope" and call.args and \
                        isinstance(call.args[0], ast.Name) and \
                        call.args[0].id in params:
                    wrappers[node.name] = params.index(call.args[0].id)

    for mod in tree.iter(_SCOPE):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id == "Envelope":
                kind = None
                if node.args:
                    kind = _const_str(node.args[0])
                for kw in node.keywords:
                    if kw.arg == "kind":
                        kind = _const_str(kw.value)
                if kind is not None and mod.relpath != host_rel:
                    requests.setdefault(kind, (mod.relpath, node.lineno))
            elif isinstance(f, ast.Attribute) and f.attr == "reply" \
                    and node.args:
                kind = _const_str(node.args[0])
                if kind is not None:
                    replies.setdefault(kind, (mod.relpath, node.lineno))
            elif isinstance(f, ast.Attribute) and f.attr in wrappers:
                idx = wrappers[f.attr]
                if idx < len(node.args):
                    kind = _const_str(node.args[idx])
                    if kind is not None:
                        requests.setdefault(kind,
                                            (mod.relpath, node.lineno))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Compare) and \
                    isinstance(node.left, ast.Attribute) and \
                    node.left.attr == "kind" and len(node.comparators) == 1:
                kind = _const_str(node.comparators[0])
                if kind is not None and mod.relpath != host_rel:
                    reply_refs.setdefault(kind,
                                          (mod.relpath, node.lineno))

    findings: list[Finding] = []
    if not handlers:
        return findings                   # no host in this tree — nothing on
    for kind in sorted(set(requests) - set(handlers)):
        rel, line = requests[kind]
        findings.append(Finding(
            "wire", "missing-handler", rel, line, kind,
            f"Envelope kind {kind!r} is sent but the host has no "
            f"_on_{kind} handler — it will fail on the wire"))
    for kind in sorted(set(handlers) - set(requests)):
        rel, line = handlers[kind]
        findings.append(Finding(
            "wire", "dead-handler", rel, line, kind,
            f"handler _on_{kind} has no sender anywhere in the tree"))
    for kind in sorted(set(reply_refs) - set(replies)):
        rel, line = reply_refs[kind]
        findings.append(Finding(
            "wire", "unknown-reply", rel, line, kind,
            f"client code compares against reply kind {kind!r} which "
            f"no handler ever sends"))
    return findings
