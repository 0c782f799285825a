"""Domain-aware static analysis for the ``repro_torch`` tree.

The port's twin of ``repro.analysis``.  ``python -m repro_torch.analysis``
runs five checkers — lock order against the port's documented hierarchy,
fault-seam coverage of durable I/O, torch hygiene in device bodies (host
syncs and cache hazards), span/metric taxonomy, and wire-kind
exhaustiveness — plus a runtime lock-order witness
(``repro_torch.analysis.witness``) that cross-validates the static
hierarchy while the port's threads run.  The tables both read live in
``TABLES.md`` beside this module.  Pure stdlib: nothing here imports torch,
JAX or the JAX package.
"""
from repro_torch.analysis.core import (Baseline, Finding, Tree,  # noqa: F401
                                       checker, find_repo_root, run)

__all__ = ["Baseline", "Finding", "Tree", "checker", "find_repo_root",
           "run"]
