"""The port's runtime lock-order witness as pytest fixtures.

A ``tests/test_torch_*.py`` module whose code runs threads opts in with

    from torch_witness import (torch_lock_witness,  # noqa: F401
                               torch_witness_isolation)

Both fixtures are autouse within that module.  With
``REPRO_TORCH_LOCK_WITNESS=1`` in the environment, ``torch_lock_witness``
installs :mod:`repro_torch.analysis.witness` before the module's first test
(so every port lock its tests create is wrapped and every nesting recorded
against the rank table of ``src/repro_torch/analysis/TABLES.md``),
uninstalls it after the last, and fails the module's teardown if any
observed nesting contradicts the table.  ``torch_witness_isolation`` clears
the calling thread's held-lock context after every test: a crash-simulation
test that abandons an open two-phase flush leaves that discarded store's
lock "held", which would otherwise poison every later nesting.  Without the
variable both fixtures do nothing.
"""
import os

import pytest

ENV = "REPRO_TORCH_LOCK_WITNESS"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enabled() -> bool:
    return os.environ.get(ENV) == "1"


@pytest.fixture(scope="module", autouse=True)
def torch_lock_witness():
    """The port's witness over one test module (see the module docstring);
    yields it, or None when the variable is unset."""
    if not enabled():
        yield None
        return
    from repro_torch.analysis import witness
    wit = witness.install(ROOT)
    try:
        yield wit
    finally:
        witness.uninstall()
    violations = wit.violations()
    assert not violations, (
        "the port's lock-order witness observed nestings that contradict "
        "the TABLES.md lock hierarchy:\n  " + "\n  ".join(violations))


@pytest.fixture(autouse=True)
def torch_witness_isolation():
    """After each test, clear the calling thread's witness context."""
    yield
    if enabled():
        from repro_torch.analysis import witness
        wit = witness.current()
        if wit is not None:
            wit.reset_thread()
