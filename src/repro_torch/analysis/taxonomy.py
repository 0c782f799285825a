"""Taxonomy lint: span names and metric names stay on contract.

The port's twin of ``repro.analysis.taxonomy``; its span table is the
port's tables file's (the port emits the reference's span names).

Spans: every name emitted through ``maybe_span``/``tracer.span``/
``tr.make``/``tracer.event`` must match a row of the tables file's
span-taxonomy table (parsed, not duplicated here — the docs are the
config).  Table entries may carry ``<kind>`` placeholders and ``.*``
suffixes; f-string span names lint their literal skeleton against them.

Metrics: the naming scheme is ``<layer>_<noun>_total`` for counters and
bare nouns for everything else; one name means one thing — the same
name registered with two different instrument kinds anywhere in the
tree, or registered on the process-global registry from two different
modules, is a collision.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import TABLES, Finding, Tree, checker

__all__ = ["check_taxonomy", "parse_span_taxonomy"]

_TRACERISH = ("tr", "tracer")
_SPAN_METHODS = ("span", "make", "event", "record", "start")
_METRIC_METHODS = ("counter", "gauge", "histogram", "reservoir")


def parse_span_taxonomy(arch_text: str) -> list[str]:
    """Backticked entries of the first column of the span-taxonomy
    table (the markdown table whose header row is ``| span | scope |``)."""
    rows = []
    in_table = False
    for line in arch_text.splitlines():
        s = line.strip()
        if s.startswith("|") and "span" in s and "scope" in s:
            in_table = True
            continue
        if in_table:
            if not s.startswith("|"):
                break
            first = s.split("|")[1]
            rows.extend(re.findall(r"`([^`]+)`", first))
    if not rows:
        raise ValueError(f"{TABLES}: span-taxonomy table not found")
    return rows


def _pattern_to_regex(entry: str) -> re.Pattern:
    """Doc entry -> regex: ``<kind>`` matches one+ chars, a trailing
    ``.*`` matches the bare name or any dotted suffix."""
    out = []
    i = 0
    while i < len(entry):
        c = entry[i]
        if c == "<":
            j = entry.index(">", i)
            out.append(r".+")
            i = j + 1
        elif entry[i:i + 2] == ".*":
            out.append(r"(\..+)?")
            i += 2
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("".join(out) + "$")


def _span_name_of(call: ast.Call) -> tuple[str, bool] | None:
    """First positional arg -> (skeleton, is_pattern); f-string holes
    become a placeholder segment."""
    if not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, False
    if isinstance(a, ast.JoinedStr):
        parts, holes = [], False
        for v in a.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("\0")
                holes = True
        return "".join(parts), holes
    return None


@checker("taxonomy")
def check_taxonomy(tree: Tree) -> list[Finding]:
    arch = tree.doc()
    allowed = [_pattern_to_regex(e) for e in parse_span_taxonomy(arch)]
    findings: list[Finding] = []
    metric_sites: dict[str, list[tuple[str, str, int, bool]]] = {}

    for mod in tree.iter():
        if mod.relpath.endswith("obs/trace.py") or \
                mod.relpath.endswith("obs/metrics.py") or \
                mod.relpath.startswith("src/repro_torch/analysis/"):
            continue                   # the substrate itself, not emitters
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # ---- spans
            is_span = False
            if isinstance(f, ast.Name) and f.id == "maybe_span":
                is_span = True
            elif isinstance(f, ast.Attribute) and f.attr == "maybe_span":
                is_span = True
            elif isinstance(f, ast.Attribute) and \
                    f.attr in _SPAN_METHODS and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id in _TRACERISH:
                is_span = True
            if is_span:
                got = _span_name_of(node)
                if got is not None:
                    name, is_pat = got
                    probe = name.replace("\0", "X")
                    if not any(rx.match(probe) for rx in allowed):
                        shown = name.replace("\0", "<...>")
                        findings.append(Finding(
                            "taxonomy", "unknown-span", mod.relpath,
                            node.lineno, shown,
                            f"span name {shown!r} is not in the "
                            f"span taxonomy of {TABLES}"))
                continue
            # ---- metrics
            if isinstance(f, ast.Attribute) and \
                    f.attr in _METRIC_METHODS and node.args:
                a = node.args[0]
                name = None
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    name = a.value
                elif isinstance(a, ast.JoinedStr):
                    # dynamic families: lint only the literal suffix
                    tail = a.values[-1]
                    if isinstance(tail, ast.Constant):
                        name = "\0" + str(tail.value)
                if name is None:
                    continue
                is_global = any(
                    isinstance(n, (ast.Name, ast.Attribute)) and
                    (getattr(n, "id", None) == "GLOBAL"
                     or getattr(n, "attr", None) == "GLOBAL")
                    for n in ast.walk(f.value))
                metric_sites.setdefault(name.lstrip("\0"), []).append(
                    (f.attr, mod.relpath, node.lineno, is_global))
                bare = name.lstrip("\0")
                if f.attr == "counter" and not bare.endswith("_total"):
                    findings.append(Finding(
                        "taxonomy", "counter-name", mod.relpath,
                        node.lineno, bare,
                        f"counter {bare!r} must end in '_total' "
                        f"(naming scheme: <layer>_<noun>_total)"))
                elif f.attr != "counter" and bare.endswith("_total"):
                    findings.append(Finding(
                        "taxonomy", "metric-name", mod.relpath,
                        node.lineno, bare,
                        f"{f.attr} {bare!r} must not end in '_total' "
                        f"(reserved for counters)"))

    for name, sites in sorted(metric_sites.items()):
        kinds = {k for k, *_ in sites}
        if len(kinds) > 1:
            k, rel, line, _ = sites[0]
            findings.append(Finding(
                "taxonomy", "metric-collision", rel, line, name,
                f"metric {name!r} registered as multiple kinds "
                f"({', '.join(sorted(kinds))}) — one name, one meaning"))
            continue
        gmods = {rel for _, rel, _, g in sites if g}
        if len(gmods) > 1:
            _, rel, line, _ = sites[0]
            findings.append(Finding(
                "taxonomy", "metric-collision", rel, line, name,
                f"metric {name!r} registered on the GLOBAL registry "
                f"from multiple modules ({', '.join(sorted(gmods))})"))
    return findings
