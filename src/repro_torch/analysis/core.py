"""AST-based static-analysis framework for the ``repro_torch`` tree.

The port's twin of ``repro.analysis.core``.  The serving stack's
correctness rests on cross-cutting invariants no single module can see: a
global lock hierarchy, fault-seam coverage of every durable write,
device-body hygiene (no host sync inside an executor body), one span/metric
taxonomy, and a wire codec whose kinds must stay exhaustive.  This package
checks them mechanically — ``python -m repro_torch.analysis``.

Pieces:

  * :class:`Tree` — every ``src/repro_torch`` module parsed once, shared by
    all checkers (plus the repo root, so checkers can read the port's
    tables file, :data:`TABLES` — docs-as-config, enforcement can't
    drift).
  * :class:`Finding` — one defect: checker, rule, site, stable
    ``symbol`` anchor.  The baseline matches on
    ``(checker, path, rule, symbol)`` — deliberately NOT the line
    number, so suppressions survive unrelated edits.
  * :func:`checker` registry + :func:`run` driver.
  * :class:`Baseline` — committed JSON of explicitly-suppressed
    findings, each with a one-line ``reason``.  Stale entries (matching
    nothing) are reported so the file can't rot.

Stdlib-only, import-light: the analyzer never imports the modules it
checks (pure AST), so it runs in CI without torch installed.  It imports
nothing of the JAX package either: this module is the port's own copy.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Callable, Iterable, Iterator

__all__ = ["Finding", "Module", "Tree", "Baseline", "checker", "run",
           "render_text", "render_json", "find_repo_root", "TABLES"]

#: The package the checkers walk, and the port's machine-parsed tables
#: (lock hierarchy, span taxonomy, device bodies), both repo-relative.
PACKAGE = "src/repro_torch"
TABLES = "src/repro_torch/analysis/TABLES.md"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect.  ``symbol`` is the stable anchor (a qualname, lock
    id, metric name, or edge) that identifies the finding across line
    drift; ``line`` is display-only."""
    checker: str
    rule: str
    path: str                  # repo-relative, forward slashes
    line: int
    symbol: str
    message: str
    severity: str = "error"    # "error" | "warning"

    @property
    def fingerprint(self) -> tuple[str, str, str, str]:
        return (self.checker, self.path, self.rule, self.symbol)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
                f"{self.severity}: {self.message}  ({self.symbol})")


class Module:
    """One parsed source module."""

    __slots__ = ("path", "relpath", "tree", "source")

    def __init__(self, path: str, relpath: str, tree: ast.Module,
                 source: str):
        self.path = path
        self.relpath = relpath
        self.tree = tree
        self.source = source


class Tree:
    """All of ``src/repro_torch`` parsed once, keyed by repo-relative
    path."""

    def __init__(self, root: str):
        self.root = root
        self.modules: dict[str, Module] = {}

    @classmethod
    def load(cls, root: str, subdir: str = PACKAGE) -> "Tree":
        t = cls(root)
        base = os.path.join(root, subdir)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__",)]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                t.modules[rel] = Module(path, rel,
                                        ast.parse(src, filename=rel), src)
        return t

    def iter(self, prefix: str | None = None) -> Iterator[Module]:
        for rel in sorted(self.modules):
            if prefix is None or rel.startswith(prefix):
                yield self.modules[rel]

    def doc(self, name: str = TABLES) -> str:
        """A document's text by repo-relative path (default: the port's
        tables file)."""
        with open(os.path.join(self.root, name), encoding="utf-8") as f:
            return f.read()


# ------------------------------------------------------------------ registry
CHECKERS: dict[str, Callable[[Tree], list[Finding]]] = {}


def checker(name: str):
    """Register ``fn(tree) -> list[Finding]`` under ``name``."""
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


def run(root: str, names: Iterable[str] | None = None) -> list[Finding]:
    """Load the tree and run the named checkers (default: all),
    returning findings sorted by site."""
    # import for side effect: registers the checkers
    from repro_torch.analysis import (locks, seams,  # noqa: F401
                                      taxonomy, torchlint, wire)
    tree = Tree.load(root)
    selected = list(names) if names else sorted(CHECKERS)
    out: list[Finding] = []
    for name in selected:
        if name not in CHECKERS:
            raise KeyError(f"unknown checker {name!r}; have "
                           f"{sorted(CHECKERS)}")
        out.extend(CHECKERS[name](tree))
    out.sort(key=lambda f: (f.path, f.line, f.checker, f.rule, f.symbol))
    return out


# ------------------------------------------------------------------ baseline
class Baseline:
    """Committed suppressions: a JSON list of
    ``{checker, path, rule, symbol, reason}`` entries.  Matching is by
    fingerprint; every entry must carry a non-empty reason."""

    def __init__(self, entries: list[dict]):
        for e in entries:
            if not str(e.get("reason", "")).strip():
                raise ValueError(f"baseline entry without a reason: {e}")
        self.entries = entries
        self._index = {(e["checker"], e["path"], e["rule"], e["symbol"])
                       : e for e in entries}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def matches(self, f: Finding) -> bool:
        return f.fingerprint in self._index

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """-> (unbaselined, suppressed, stale_entries)."""
        unbase = [f for f in findings if not self.matches(f)]
        supp = [f for f in findings if self.matches(f)]
        hit = {f.fingerprint for f in supp}
        stale = [e for k, e in self._index.items() if k not in hit]
        return unbase, supp, stale


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


# ----------------------------------------------------------------- reporters
def render_text(unbaselined: list[Finding], suppressed: list[Finding],
                stale: list[dict]) -> str:
    lines = [f.render() for f in unbaselined]
    lines.append(f"{len(unbaselined)} finding(s), "
                 f"{len(suppressed)} baselined, "
                 f"{len(stale)} stale baseline entr(y/ies)")
    for e in stale:
        lines.append(f"  stale baseline: {e['checker']}/{e['rule']} "
                     f"{e['path']} {e['symbol']} — {e['reason']}")
    return "\n".join(lines)


def render_json(unbaselined: list[Finding], suppressed: list[Finding],
                stale: list[dict]) -> str:
    return json.dumps({
        "findings": [f.to_dict() for f in unbaselined],
        "suppressed": [f.to_dict() for f in suppressed],
        "stale_baseline": stale,
        "counts": {"unbaselined": len(unbaselined),
                   "suppressed": len(suppressed),
                   "stale": len(stale)},
    }, indent=2, sort_keys=True)


def find_repo_root(start: str | None = None) -> str:
    """Walk up from ``start`` (default cwd) to the directory holding
    both ``src/repro_torch`` and the port's tables file; falls back to the
    package's own grandparent (src/repro_torch/analysis -> repo)."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if (os.path.isdir(os.path.join(cur, PACKAGE))
                and os.path.exists(os.path.join(cur, TABLES))):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            break
        cur = nxt
    pkg = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(pkg)))
