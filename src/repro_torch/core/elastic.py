"""Elastic multi-core *policy*: energy accounting and straggler scheduling.

The paper deploys Z BIC cores, feeds each a batch from external memory, and
puts idle cores in standby (CG + RBB).  The GPU translation:

  * "Z cores"            -> Z CUDA devices (one H100 is one core); the
                            engine runtime (``repro_torch.engine.runtime``)
                            runs one BIC pipeline per device, blocks
                            assigned round-robin.
  * "standby idle cores" -> the elastic scheduler activates only
                            ceil(workload / batches_per_core) cores per tick
                            and accounts the rest at standby power using the
                            calibrated model (core/power.py).
  * stragglers           -> longest-processing-time dynamic assignment
                            (work stealing): batches are handed to the
                            earliest-finishing core instead of statically
                            striped, bounding makespan at max(LPT) instead
                            of max(static stripe x slowest core).

Actual sharded execution lives in :mod:`repro_torch.engine.runtime`
(``MulticoreRuntime`` fuses it with this module's energy accounting);
``multicore_create_index`` below is a thin compatibility wrapper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core.bic import BICConfig, PaperConfig
from repro_torch.core import power


# ------------------------------------------------------------- multi-core op
def multicore_create_index(records, keys, devices=None,
                           *, backend: str = "auto") -> torch.Tensor:
    """Compatibility wrapper over the engine runtime's per-device build.

    records (Z*B, N, W), block b built on ``devices[b % Z]``; keys
    replicated.  Returns (Z*B, M, ceil(N/32)).  See
    ``repro_torch.engine.runtime``.
    """
    from repro_torch.engine.runtime import multicore_create_index as _impl
    return _impl(records, keys, devices, backend=backend)


# -------------------------------------------------------- elastic energy sim
@dataclasses.dataclass(frozen=True)
class PowerState:
    """Operating point of one core."""
    vdd_active: float = 1.2
    vdd_standby: float = 0.4
    vbb_standby: float = -2.0
    use_rbb: bool = True


@dataclasses.dataclass
class EnergyReport:
    active_joules: float = 0.0
    standby_joules: float = 0.0
    busy_core_seconds: float = 0.0
    idle_core_seconds: float = 0.0
    batches: int = 0

    @property
    def total_joules(self) -> float:
        return self.active_joules + self.standby_joules

    def merge(self, other: "EnergyReport") -> "EnergyReport":
        """Accumulate another report into this one, field by field."""
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self


def cycles_per_batch(cfg: BICConfig = PaperConfig) -> int:
    """BIC core cycle count for one batch: N records x (load + M key probes)
    + M transpose flush cycles (paper §III dataflow)."""
    return cfg.num_records * (cfg.num_keys + 1) + cfg.num_keys


class ElasticScheduler:
    """Workload-aware core activation with energy accounting.

    Each tick: ``workload`` batches arrive; the scheduler activates the
    minimum number of cores that finishes within the tick, puts the rest in
    standby (CG, optionally +RBB), and integrates energy with the calibrated
    silicon model.
    """

    def __init__(self, num_cores: int, cfg: BICConfig = PaperConfig,
                 state: PowerState = PowerState()):
        self.num_cores = num_cores
        self.cfg = cfg
        self.state = state
        self.freq = power.frequency(state.vdd_active)
        self.batch_seconds = cycles_per_batch(cfg) / self.freq
        self.p_active = power.active_power(state.vdd_active)
        vbb = state.vbb_standby if state.use_rbb else 0.0
        self.p_standby = power.standby_power(state.vdd_standby, vbb)

    def cores_needed(self, workload: int, tick_seconds: float) -> int:
        cap_per_core = max(1, int(tick_seconds / self.batch_seconds))
        return min(self.num_cores, math.ceil(workload / cap_per_core))

    def calibrate(self, measured_mbps_per_core: float) -> None:
        """Re-derive the per-core batch time from a *measured* per-core
        indexing throughput, so ``cores_needed`` and the busy-time model
        track the device actually executing instead of the paper clock.
        MB/s is in PAPER units — one 8-bit record word per byte, the same
        accounting as ``cycles_per_batch`` and ``TickResult.measured_mbps``
        — so both sides of the division stay consistent.  Ignores
        non-positive measurements."""
        if measured_mbps_per_core <= 0:
            return
        batch_bytes = self.cfg.num_records * self.cfg.words_per_record
        self.batch_seconds = batch_bytes / (measured_mbps_per_core * 1e6)

    def account(self, workload: int, tick_seconds: float, *,
                busy_seconds: float | None = None) -> EnergyReport:
        """Energy for ONE tick of ``workload`` batches.  By default the
        busy time comes from the model (workload count x per-core batch
        time); pass ``busy_seconds`` to charge active energy over a
        measured dispatch wall-clock instead."""
        rep = EnergyReport()
        z = self.cores_needed(workload, tick_seconds) if workload else 0
        if z:
            model_busy = min(tick_seconds,
                             (workload / max(z, 1)) * self.batch_seconds)
            busy = (model_busy if busy_seconds is None
                    else min(tick_seconds, busy_seconds))
        else:
            busy = 0.0
        rep.active_joules += z * self.p_active * busy
        # active cores idle-standby for the remainder of the tick too
        rep.standby_joules += (
            z * self.p_standby * (tick_seconds - busy)
            + (self.num_cores - z) * self.p_standby * tick_seconds)
        rep.busy_core_seconds += z * busy
        rep.idle_core_seconds += self.num_cores * tick_seconds - z * busy
        rep.batches += workload
        return rep

    def run(self, workloads: Sequence[int], tick_seconds: float) -> EnergyReport:
        rep = EnergyReport()
        for wl in workloads:
            rep.merge(self.account(wl, tick_seconds))
        return rep


# ------------------------------------------------------ straggler mitigation
def lpt_schedule(batch_costs: Sequence[float], speeds: Sequence[float]
                 ) -> tuple[float, list[int]]:
    """Dynamic longest-processing-time assignment to heterogeneous cores.

    Returns (makespan, assignment core-index per batch).  This is the
    work-stealing policy the distributed runtime uses when a core (device
    host) runs slow: batches go to the earliest-available core.
    """
    finish = [0.0] * len(speeds)
    order = sorted(range(len(batch_costs)), key=lambda i: -batch_costs[i])
    assign_of = [0] * len(batch_costs)
    for i in order:
        core = min(range(len(speeds)),
                   key=lambda c: finish[c] + batch_costs[i] / speeds[c])
        finish[core] += batch_costs[i] / speeds[core]
        assign_of[i] = core
    return max(finish) if finish else 0.0, assign_of


def static_schedule(batch_costs: Sequence[float], speeds: Sequence[float]
                    ) -> float:
    """Baseline: round-robin striping (no straggler awareness)."""
    finish = [0.0] * len(speeds)
    for i, c in enumerate(batch_costs):
        core = i % len(speeds)
        finish[core] += c / speeds[core]
    return max(finish) if finish else 0.0
