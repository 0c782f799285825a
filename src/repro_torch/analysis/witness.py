"""Runtime lock-order witness for the port: the dynamic half of the lock
checker.

The port's twin of ``repro.analysis.witness``, with the same API
(:class:`LockWitness` with ``install``/``uninstall``/``reset_thread``/
``violations``, and the module's :func:`install`/:func:`current`).  The
static analyzer can only see acquisitions it can resolve; the runtime can
only see orderings a particular run happened to execute.  This module
patches the ``threading.Lock/RLock/Condition`` factories so every lock
created by ``src/repro_torch`` source is wrapped, records every observed
``(held, acquired)`` nesting keyed by the port's static inventory ids
(creation-site mapping), and checks the observed pairs against the rank
table of the port's tables file.

Three rules keep it from observing what is not the port's:

  * **Rooted at ``src/repro_torch/`` only** (a trailing separator: the
    JAX package's ``src/repro/`` never matches), so it wraps no lock of
    the reference.
  * **Only the immediate creator counts.**  A lock is wrapped only when
    the frame that called the factory is itself port source at an
    inventoried site.  Locks that the stdlib or torch create while a port
    frame is further up the stack (``threading.Event``'s condition inside
    ``ReplyFuture.__init__``, ``concurrent.futures.Future``'s, torch's
    own) pass through unwrapped, even where a port lock site lies within
    the ±2-line tolerance.
  * **Real factories, composable.**  The wrapped locks are made from the
    interpreter's own factories (``_thread.allocate_lock``,
    ``threading._CRLock``, the ``Condition`` class), captured whatever is
    installed when this module is imported.  Every lock that is not the
    port's goes to the factory installed before :meth:`LockWitness.install`
    (the JAX package's witness, when ``REPRO_LOCK_WITNESS=1`` installed
    it), and :meth:`LockWitness.uninstall` puts that factory back.  The
    patched factories carry a code filename outside ``src/``, so the JAX
    package's witness, walking up to the first frame of its own tree,
    steps over them to the real creator.
"""
from __future__ import annotations

import _thread
import os
import sys
import threading

from repro_torch.analysis import locks as locks_mod
from repro_torch.analysis.core import PACKAGE, Tree, find_repo_root

__all__ = ["LockWitness", "install", "uninstall", "current"]


def _real_condition():
    """The ``threading.Condition`` class, even when another witness has
    replaced the module attribute by a factory function (which hands
    ``threading.Event`` the real class for a lock it does not own)."""
    cond = threading.Condition
    if isinstance(cond, type):
        return cond
    return type(threading.Event()._cond)


_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = getattr(threading, "_CRLock", None) or threading._PyRLock
_REAL_CONDITION = _real_condition()

#: The code filename the patched factories carry (not a path under src/).
_FACTORY_FILENAME = "<repro_torch.analysis.witness factory>"


class _Wrapped:
    """Order-observing proxy around one lock/rlock/condition."""

    __slots__ = ("_real", "_wit", "lock_id")

    def __init__(self, real, wit: "LockWitness", lock_id: str):
        self._real = real
        self._wit = wit
        self.lock_id = lock_id

    # --- acquisition surface
    def acquire(self, *a, **kw):
        got = self._real.acquire(*a, **kw)
        if got:
            self._wit.note_acquire(self)
        return got

    def release(self):
        self._wit.note_release(self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # --- condition surface (only present on real conditions)
    def wait(self, timeout=None):
        # wait releases and reacquires the underlying lock; the witness
        # stack keeps the cv entry (orderings observed after the wakeup
        # still happen under the reacquired cv)
        return self._real.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._real.wait_for(predicate, timeout)

    def notify(self, n=1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()

    def locked(self):
        return self._real.locked()

    def __getattr__(self, name):
        return getattr(self._real, name)


class LockWitness:
    """Observed-nesting recorder + factory patcher."""

    def __init__(self, root: str | None = None):
        self.root = root or find_repo_root()
        tree = Tree.load(self.root)
        inv = locks_mod.collect_inventory(tree)
        self.ranks = locks_mod.parse_hierarchy(tree.doc())
        # (abspath, line) -> lock id
        self._sites: dict[tuple[str, int], str] = {}
        for d in inv.values():
            key = (os.path.normpath(os.path.join(self.root, d.relpath)),
                   d.line)
            self._sites[key] = d.id
        self._src_root = os.path.normpath(
            os.path.join(self.root, PACKAGE)) + os.sep
        # (outer, inner) -> (file, line, full held stack at first sighting)
        self.pairs: dict[tuple[str, str], tuple[str, int, tuple]] = {}
        self._pairs_lock = _REAL_LOCK()
        self._tls = threading.local()
        self._previous = None           # the factories install() replaced

    # ------------------------------------------------------------- recording
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def note_acquire(self, w: _Wrapped) -> None:
        st = self._stack()
        if st and not any(x.lock_id == w.lock_id for x in st):
            top = st[-1]
            key = (top.lock_id, w.lock_id)
            if key not in self.pairs:
                fr = sys._getframe(1)
                while fr is not None and \
                        fr.f_code.co_filename == __file__:
                    fr = fr.f_back          # skip the proxy's own frames
                where = (fr.f_code.co_filename, fr.f_lineno) \
                    if fr is not None else ("<unknown>", 0)
                held = tuple(x.lock_id for x in st)
                with self._pairs_lock:
                    self.pairs.setdefault(key, (*where, held))
        st.append(w)

    def note_release(self, w: _Wrapped) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is w:
                del st[i]
                break

    def reset_thread(self) -> None:
        """Drop the calling thread's held-lock context.  Test isolation
        hook: crash-simulation tests abandon a deliberately open two-phase
        flush (``prepare_spill`` with no commit), leaving that discarded
        store's flush lock held forever; its stale stack entry would
        poison every nesting this thread observes afterwards."""
        self._tls.stack = []

    # ------------------------------------------------------------- patching
    def site_id(self, frame) -> str | None:
        """The static lock id of the site ``frame`` (the factory's
        immediate caller) stands at, or None when that frame is not port
        source at an inventoried site (the lock is then not the port's)."""
        fn = os.path.normpath(frame.f_code.co_filename)
        if not fn.startswith(self._src_root):
            return None
        line = frame.f_lineno
        for dl in (0, 1, 2, -1, -2):    # tolerate small formatting drift
            lid = self._sites.get((fn, line + dl))
            if lid is not None:
                return lid
        return None

    def install(self) -> "LockWitness":
        if self._previous is not None:
            return self
        prev_lock, prev_rlock, prev_cond = self._previous = (
            threading.Lock, threading.RLock, threading.Condition)
        wit = self

        def make_lock():
            lid = wit.site_id(sys._getframe(1))
            if lid is None:
                return prev_lock()
            return _Wrapped(_REAL_LOCK(), wit, lid)

        def make_rlock(*a, **kw):
            lid = wit.site_id(sys._getframe(1))
            if lid is None:
                return prev_rlock(*a, **kw)
            return _Wrapped(_REAL_RLOCK(), wit, lid)

        def make_condition(lock=None):
            if isinstance(lock, _Wrapped):
                lock = lock._real
            lid = wit.site_id(sys._getframe(1))
            if lid is None:
                return prev_cond(lock)
            return _Wrapped(_REAL_CONDITION(
                _REAL_RLOCK() if lock is None else lock), wit, lid)

        for fn in (make_lock, make_rlock, make_condition):
            fn.__code__ = fn.__code__.replace(co_filename=_FACTORY_FILENAME)
        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_condition
        return self

    def uninstall(self) -> None:
        """Put back the factories :meth:`install` replaced."""
        if self._previous is not None:
            threading.Lock, threading.RLock, threading.Condition = \
                self._previous
            self._previous = None

    # ------------------------------------------------------------ validation
    def violations(self) -> list[str]:
        """Observed nestings that contradict the documented ranks."""
        out = []
        with self._pairs_lock:
            pairs = dict(self.pairs)
        for (outer, inner), (fn, line, held) in sorted(pairs.items()):
            ro, ri = self.ranks.get(outer), self.ranks.get(inner)
            if ro is None or ri is None:
                out.append(f"unranked nesting {outer} -> {inner} "
                           f"(first seen {fn}:{line})")
            elif ro >= ri:
                out.append(f"rank inversion {outer} (rank {ro}) held "
                           f"while acquiring {inner} (rank {ri}) at "
                           f"{fn}:{line} (held: {' -> '.join(held)})")
        return out


_CURRENT: LockWitness | None = None


def install(root: str | None = None) -> LockWitness:
    """Install the process's port witness (once) and return it."""
    global _CURRENT
    if _CURRENT is None:
        _CURRENT = LockWitness(root).install()
    return _CURRENT


def uninstall() -> LockWitness | None:
    """Uninstall the process's port witness, if any, and return it (its
    pairs stay readable); the next :func:`install` starts a fresh one."""
    global _CURRENT
    wit, _CURRENT = _CURRENT, None
    if wit is not None:
        wit.uninstall()
    return wit


def current() -> LockWitness | None:
    return _CURRENT
