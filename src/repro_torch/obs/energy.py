"""Per-phase energy ledger on the paper's operating points.

The paper's claim is an *energy* claim — 162.9 pJ/cycle active at
1.2 V / 41 MHz, 10.6 uW clock-gated standby, 2.64 nW (0.31 pW/bit) with
reverse back-gate biasing at 0.4 V — and :class:`ElasticScheduler`
already turns those operating points into joule totals per tick.  What
it cannot say is *which query* the joules belong to.  The ledger closes
that gap:

  * every charge lands in exactly one **phase** — ``busy`` (device
    executing a wave, active power), ``awake_idle`` (core awake between
    waves, active power), ``standby`` (duty-cycled down, standby power
    at the configured CG/RBB point);
  * :meth:`EnergyLedger.attribute` drains the not-yet-attributed pool
    evenly over a wave's queries, so **sum(per-query pJ) +
    unattributed == total joules exactly** (the reconciliation rule
    ARCHITECTURE.md documents and the bench's ``energy_reconciled``
    flag checks);
  * :meth:`EnergyLedger.attribute_bits` rolls the same pool up to
    pJ-per-indexed-bit for the ingest side (MulticoreRuntime ticks
    arrive via :meth:`charge_report`).

Reconciling with the scheduler totals is by construction, not by
bookkeeping discipline: the ledger *owns* the
:class:`~repro_torch.core.elastic.EnergyReport` that ``BitmapService``
exposes, and every joule enters through :meth:`charge` /
:meth:`charge_report` — there is no second path that could drift.
"""
from __future__ import annotations

import collections
import threading

from repro_torch.core import power as power_model
from repro_torch.core.elastic import ElasticScheduler, EnergyReport

__all__ = ["EnergyLedger", "PHASES"]

#: ledger phases, in the order snapshots report them
PHASES = ("busy", "awake_idle", "standby")


class EnergyLedger:
    """Joule accounting per phase with per-query attribution.

    ``scheduler`` supplies the operating points (its ``p_active`` /
    ``p_standby`` watts are the paper's calibrated powers); the ledger
    charges wall-clock phase durations at those powers into its own
    :attr:`report` (an :class:`EnergyReport` — hand this to the service
    as THE energy report so scheduler reconciliation is structural).
    """

    def __init__(self, scheduler: ElasticScheduler, *,
                 per_query_window: int = 65536):
        state = scheduler.state
        self._power = {"busy": scheduler.p_active,
                       "awake_idle": scheduler.p_active,
                       "standby": scheduler.p_standby}
        vbb = state.vbb_standby if state.use_rbb else 0.0
        #: the paper's operating points, resolved once for snapshots
        self.operating_points = {
            "vdd_active_v": state.vdd_active,
            "vdd_standby_v": state.vdd_standby,
            "vbb_standby_v": vbb,
            "standby_mode": "rbb" if state.use_rbb else "cg",
            "active_w": scheduler.p_active,
            "standby_w": scheduler.p_standby,
            "standby_cg_w": power_model.standby_power(state.vdd_standby,
                                                      0.0),
            "standby_rbb_w": power_model.standby_power(
                state.vdd_standby, state.vbb_standby),
        }
        self._lock = threading.Lock()
        #: the service-visible report; every charge merges into it
        self.report = EnergyReport()
        self.phase_seconds = {p: 0.0 for p in PHASES}
        self.phase_joules = {p: 0.0 for p in PHASES}
        self._unattributed = 0.0
        self._attributed = 0.0
        self._indexed_bits = 0
        self._per_query: collections.deque[tuple[int, float]] = (
            collections.deque(maxlen=per_query_window))

    # ------------------------------------------------------------- charging
    def charge(self, phase: str, dt: float) -> float:
        """Charge ``dt`` seconds spent in ``phase``; returns the joules
        added.  Negative/zero intervals are ignored (clock skew on tiny
        spans must not un-charge energy)."""
        if dt <= 0.0:
            return 0.0
        joules = self._power[phase] * dt
        rep = self.report
        with self._lock:
            self.phase_seconds[phase] += dt
            self.phase_joules[phase] += joules
            self._unattributed += joules
            if phase == "busy":
                rep.active_joules += joules
                rep.busy_core_seconds += dt
            elif phase == "awake_idle":
                rep.active_joules += joules
                rep.idle_core_seconds += dt
            else:
                rep.standby_joules += joules
                rep.idle_core_seconds += dt
        return joules

    def charge_report(self, tick: EnergyReport) -> None:
        """Absorb a scheduler-produced tick report (the ingest runtime's
        ``run_tick`` path): active joules land in ``busy``, standby in
        ``standby``, and the report totals merge exactly."""
        with self._lock:
            self.phase_seconds["busy"] += tick.busy_core_seconds
            self.phase_joules["busy"] += tick.active_joules
            self.phase_seconds["standby"] += tick.idle_core_seconds
            self.phase_joules["standby"] += tick.standby_joules
            self._unattributed += tick.total_joules
            self.report.merge(tick)

    def note_batch(self) -> None:
        with self._lock:
            self.report.batches += 1

    # ---------------------------------------------------------- attribution
    def attribute(self, trace_ids) -> list[float]:
        """Drain the unattributed pool evenly over ``trace_ids`` (one
        wave's queries); returns each query's share in **pJ**.  The split
        is exact by construction: the pool decreases by precisely the
        amount handed out, so attributed + unattributed always equals
        the report total."""
        ids = list(trace_ids)
        if not ids:
            return []
        with self._lock:
            take = self._unattributed
            self._unattributed = 0.0
            self._attributed += take
            share_pj = take / len(ids) * 1e12
            for tid in ids:
                self._per_query.append((tid if tid is not None else 0,
                                        share_pj))
        return [share_pj] * len(ids)

    def attribute_bits(self, bits: int) -> None:
        """Credit ``bits`` freshly indexed bits against the energy spent
        so far (ingest-side roll-up; pairs with :meth:`charge_report`)."""
        if bits > 0:
            with self._lock:
                self._indexed_bits += bits

    # -------------------------------------------------------------- reading
    def per_query_pj(self) -> list[tuple[int, float]]:
        """Recent ``(trace_id, pJ)`` attributions, oldest first (bounded
        by ``per_query_window``)."""
        with self._lock:
            return list(self._per_query)

    def snapshot(self, *, num_records: int = 0, num_keys: int = 0) -> dict:
        """One dict with phases, totals, and the paper-style roll-ups.
        ``num_records``/``num_keys`` size the serving-side index so
        pJ-per-indexed-bit is reportable even when ingest happened
        before the ledger existed."""
        with self._lock:
            seconds = dict(self.phase_seconds)
            joules = dict(self.phase_joules)
            unattributed = self._unattributed
            attributed = self._attributed
            n_queries = len(self._per_query)
            mean_pj = (sum(pj for _, pj in self._per_query) / n_queries
                       if n_queries else 0.0)
            bits = self._indexed_bits or num_records * num_keys
            total = self.report.total_joules
        return {
            "phase_seconds": seconds,
            "phase_joules": joules,
            "total_joules": total,
            "attributed_joules": attributed,
            "unattributed_joules": unattributed,
            "pj_per_query_mean": mean_pj,
            "pj_per_indexed_bit": (total * 1e12 / bits) if bits else 0.0,
            "indexed_bits": bits,
            "operating_points": dict(self.operating_points),
        }

    def reconcile(self, *, rel_tol: float = 1e-9) -> dict:
        """Check the two ledger invariants; returns a dict with ``ok``
        plus the compared quantities (bench artifacts embed it).

        1. phase joules sum to the report total (one path in);
        2. attributed + unattributed equals that same total (nothing
           leaks out of the per-query split).
        """
        with self._lock:
            phase_sum = sum(self.phase_joules.values())
            handed = self._attributed + self._unattributed
            total = self.report.total_joules
        tol = rel_tol * max(abs(total), 1e-30)
        ok = abs(phase_sum - total) <= tol and abs(handed - total) <= tol
        return {"ok": ok, "total_joules": total,
                "phase_joules_sum": phase_sum,
                "attributed_plus_unattributed": handed}

    def __repr__(self) -> str:
        with self._lock:
            total = self.report.total_joules
        return f"<EnergyLedger total={total:.3e}J>"
