"""The injection seam every hooked module fires through.

This module is deliberately trivial and dependency-free (stdlib only) so
it can be imported from the very bottom of the stack
(:mod:`repro_torch.store.format` imports nothing above stdlib + numpy) without
creating a cycle or a heavyweight import.  With no injector installed the
fast path is one global read and a ``None`` check — the production cost
of the whole fault fabric.

``fire(site, **ctx)`` returns whatever the installed hook returns (sites
that can transform data, like ``format.read``, use the return value;
most sites ignore it).  Hooks communicate faults by RAISING — an injected
``OSError(ENOSPC)`` travels the exact error path a real full disk would.

Known sites (the contract the fabric and the hooked modules share)::

    format.write     path, size          atomic array/manifest file writes
    format.read      path, data          array-file reads (may return
                                         mutated bytes -> CRC failure)
    log.append       path, size          one framed-log entry write
    wal.append       path, start, size   WAL block append (pre-write)
    engine.dispatch  backend, queries    one batched wave dispatch
    maintenance.task kind                one background maintenance task
    rpc.send         path, kind, size    one fabric envelope leaving a
                                         transport (may return
                                         drop/duplicate/hold directives)
    rpc.recv         path, kind, size    one fabric envelope arriving
"""
from __future__ import annotations

from typing import Any, Callable

#: the installed injector's fire callback (None = fabric disabled)
HOOK: Callable[[str, dict], Any] | None = None


def fire(site: str, **ctx) -> Any:
    """Fire one site occurrence through the installed hook (no-op without
    one).  The hook may raise (the injected fault) or return a value the
    site knows how to use (e.g. mutated read bytes)."""
    hook = HOOK
    if hook is None:
        return None
    return hook(site, ctx)


def install(hook: Callable[[str, dict], Any]) -> None:
    global HOOK
    if HOOK is not None and HOOK is not hook:
        raise RuntimeError("a fault injector is already installed")
    HOOK = hook


def uninstall(hook: Callable[[str, dict], Any] | None = None) -> None:
    """Remove the installed hook (idempotent; passing the hook asserts
    ownership so one injector cannot tear down another's)."""
    global HOOK
    if hook is not None and HOOK is not None and HOOK is not hook:
        raise RuntimeError("refusing to uninstall another injector's hook")
    HOOK = None
