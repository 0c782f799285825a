"""Deterministic fault-injection fabric.

The store and serving layers carry injection *seams* (named sites fired
through :mod:`repro_torch.fault.seam` — one global ``None`` check when the
fabric is off); this package supplies the scheduled faults that flow
through them:

  * :class:`FaultPlan` — a seed-reproducible, JSON-serializable fault
    schedule (torn writes, ENOSPC, EIO, read-side bit flips, failed
    fsyncs, I/O stalls, transient dispatch/maintenance errors).
  * :class:`FaultInjector` — installs a plan behind the seam, executes
    it deterministically, and logs every fault that actually fired (the
    chaos harness's failure artifact).

Stdlib-only, below everything: :mod:`repro_torch.store.format` fires the seam
without importing anything heavier than it already does.
"""
from repro_torch.fault.inject import (FaultInjector, FaultPlan,  # noqa: F401
                                FaultSpec, InjectedFault, InjectedOSError,
                                SITE_KINDS)
from repro_torch.fault import seam  # noqa: F401

__all__ = ["FaultInjector", "FaultPlan", "FaultSpec", "InjectedFault",
           "InjectedOSError", "SITE_KINDS", "seam"]
