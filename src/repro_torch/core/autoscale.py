"""Autoscaling control loop over the engine's telemetry (§VII cost story).

The paper's headline is that a 15 W in-storage accelerator beats a 250 W
GPU on end-to-end serverless *cost and energy* — but that comparison only
bites under time-varying load, where a fixed fleet is provisioned for the
peak and burns idle power and amortized CAPEX through every trough.  This
module closes that gap: a control loop steps alongside the discrete-event
engine at fixed epoch boundaries (``ClusterEngine.run_soa(...,
controller=policy)``), reads the engine's live queue-depth/utilization
telemetry as a :class:`~repro_torch.core.engine.FleetSnapshot`, and resizes the
fleet —

  * the **CPU fallback pool** scales by (de)activating nodes: a
    deactivated node takes no new dispatch, drains run-to-completion, then
    powers off;
  * **DSCS drives** power up/down: a powered-off drive woken by an arrival
    (its data lives there — placement never moves) or proactively by the
    controller serves only after the modeled ``dscs_wake_s`` penalty.

Three shipped policies span the classic design space (cf. Hardless,
arXiv 2208.03192, on heterogeneous pool sizing):

  * :class:`StaticPolicy`    — fixed fleet, the paper's (and PR-2's) setting
  * :class:`ReactivePolicy`  — threshold controller on queue depth
    (scale up) and utilization (scale down)
  * :class:`EWMAPolicy`      — predictive: EWMA over the arrival rate,
    provisioned by Little's law with headroom
  * :class:`WorstTenantPolicy` — multi-tenant aware: reads the snapshot's
    per-tenant live backlogs (``FleetSnapshot.tenant_queue``) and sizes
    the pools for the worst-off tenant instead of the fleet aggregate

:func:`evaluate_policy` runs a policy and scores it on the ServerMix-style
(arXiv 1907.11465) axes the evaluation should output: **cost per SLA-met
request** (amortized CAPEX rental of powered servers + metered
electricity, via :mod:`repro_torch.core.cost`) and **energy per request** (busy/
idle server power integrated over the run, via :mod:`repro_torch.core.energy`).
``benchmarks/figures.py::fig20_autoscaling`` sweeps all three policies
under the diurnal and bursty MMPP arrival processes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.cost import (ELECTRICITY_USD_PER_KWH, REPAIR_USD_PER_GB,
                             rental_rate_usd_per_s)
from repro_torch.core.energy import node_power_w
from repro_torch.core.engine import ClusterEngine, FleetSnapshot
from repro_torch.core.faults import FaultPlan
from repro_torch.core.function import Pipeline, is_acceleratable
from repro_torch.core.latency import LatencyModel
from repro_torch.core.platforms import (CPU_FALLBACK_PLATFORM, DSCS_PLATFORM,
                                  PLATFORMS)

__all__ = [
    "AutoscaleAction", "AutoscalePolicy", "AutoscaleReport", "EWMAPolicy",
    "ReactivePolicy", "StaticPolicy", "WorstTenantPolicy", "evaluate_policy",
    "fleet_cost_usd", "fleet_energy_j",
]


@dataclass(frozen=True)
class AutoscaleAction:
    """What a policy asks of the fleet at one epoch: the target number of
    active CPU fallback nodes and of powered DSCS drives.  The engine
    clamps to ``[1, n_cpu_total]`` / ``[0, n_dscs_total]`` and treats
    drive power-down as best-effort (busy or backlogged drives are never
    yanked)."""
    n_cpu: int
    n_dscs_on: int


class AutoscalePolicy:
    """Base class for autoscaling policies.

    Subclasses set ``epoch_s`` (the control period, simulated seconds) and
    implement :meth:`observe`, which receives a
    :class:`~repro_torch.core.engine.FleetSnapshot` at every epoch boundary and
    returns an :class:`AutoscaleAction` (or ``None`` to leave the fleet
    untouched this epoch).  Policies may keep state across epochs;
    :meth:`reset` clears it so one policy object can score several runs.
    """

    name = "base"
    epoch_s: float = 1.0

    def observe(self, snap: FleetSnapshot) -> Optional[AutoscaleAction]:
        """One control step; called by the engine at each epoch boundary."""
        raise NotImplementedError

    def reset(self) -> None:
        """Clear cross-epoch state before a fresh run (no-op by default)."""


class StaticPolicy(AutoscalePolicy):
    """Fixed fleet baseline: pin ``n_cpu`` active nodes and ``n_dscs_on``
    powered drives every epoch.  With the full provisioned fleet this is
    bit-identical to running without a controller (tested), which makes it
    the control arm of the fig20 sweep."""

    name = "static"

    def __init__(self, n_cpu: int, n_dscs_on: int, *, epoch_s: float = 1.0):
        self.n_cpu = n_cpu
        self.n_dscs_on = n_dscs_on
        self.epoch_s = epoch_s

    def observe(self, snap: FleetSnapshot) -> AutoscaleAction:
        return AutoscaleAction(self.n_cpu, self.n_dscs_on)


class ReactivePolicy(AutoscalePolicy):
    """Threshold controller on the engine's queue/utilization telemetry.

    Scale **up** multiplicatively when the live queue depth per powered
    server crosses ``high_water`` (backlog is building faster than the
    pool drains); scale **down** multiplicatively when the pool is nearly
    queue-free *and* its busy fraction sits below ``low_util`` (capacity
    is idling).  CPU nodes and DSCS drives are controlled independently
    with the same rule.
    """

    name = "reactive"

    def __init__(self, *, epoch_s: float = 1.0, high_water: float = 1.0,
                 low_water: float = 0.1, low_util: float = 0.6,
                 grow: float = 1.5, shrink: float = 0.85,
                 min_cpu: int = 1, min_dscs_on: int = 0):
        self.epoch_s = epoch_s
        self.high_water = high_water
        self.low_water = low_water
        self.low_util = low_util
        self.grow = grow
        self.shrink = shrink
        self.min_cpu = min_cpu
        self.min_dscs_on = min_dscs_on

    def _resize(self, current: int, queue: int, busy: int, floor: int,
                ceiling: int) -> int:
        pool = max(1, current)
        depth = queue / pool
        util = busy / pool
        if depth > self.high_water:
            want = max(current + 1, math.ceil(current * self.grow))
        elif depth < self.low_water and util < self.low_util:
            want = math.floor(current * self.shrink)
        else:
            want = current
        return min(ceiling, max(floor, want))

    def observe(self, snap: FleetSnapshot) -> AutoscaleAction:
        return AutoscaleAction(
            n_cpu=self._resize(snap.n_cpu_active, snap.cpu_queue,
                               snap.cpu_busy, self.min_cpu,
                               snap.n_cpu_total),
            n_dscs_on=self._resize(snap.n_dscs_on, snap.dscs_queue,
                                   snap.dscs_busy, self.min_dscs_on,
                                   snap.n_dscs_total))


class EWMAPolicy(AutoscalePolicy):
    """Predictive sizing from a smoothed arrival-rate estimate.

    Each epoch updates an exponentially-weighted moving average of the
    observed arrival rate, splits it into the acceleratable share (served
    by drives) and the CPU share (plus a hedge-duplicate allowance), and
    provisions each pool by Little's law:

        servers = ceil(rate_share * mean_service_s / target_util)

    ``target_util`` < 1 is the headroom that absorbs within-epoch
    stochastic bursts; the EWMA's memory (``alpha``) is what rides the
    diurnal profile instead of chasing every epoch's noise.  Use
    :meth:`for_pipelines` to derive the service-time/share constants from
    the same :class:`~repro_torch.core.latency.LatencyModel` the engine draws
    from.
    """

    name = "ewma"

    def __init__(self, *, cpu_service_s: float, dscs_service_s: float,
                 accel_frac: float, epoch_s: float = 1.0, alpha: float = 0.3,
                 target_util: float = 0.7, hedge_allowance: float = 0.1,
                 min_cpu: int = 1, min_dscs_on: int = 0):
        self.cpu_service_s = cpu_service_s
        self.dscs_service_s = dscs_service_s
        self.accel_frac = accel_frac
        self.epoch_s = epoch_s
        self.alpha = alpha
        self.target_util = target_util
        self.hedge_allowance = hedge_allowance
        self.min_cpu = min_cpu
        self.min_dscs_on = min_dscs_on
        self._rate: Optional[float] = None

    @classmethod
    def for_pipelines(cls, lm: LatencyModel, pipelines: Sequence[Pipeline],
                      **kw) -> "EWMAPolicy":
        """Derive service means (median e2e per platform, averaged over
        the pipeline mix) and the acceleratable share from the latency
        model — the same decomposition the engine samples from."""
        accel = [is_acceleratable(p) for p in pipelines]
        cpu_s = float(np.mean([lm.e2e(PLATFORMS[CPU_FALLBACK_PLATFORM],
                                      p.workload, q=0.5)
                               for p in pipelines]))
        dscs_s = float(np.mean([lm.e2e(PLATFORMS[DSCS_PLATFORM], p.workload,
                                       q=0.5) for p in pipelines]))
        return cls(cpu_service_s=cpu_s, dscs_service_s=dscs_s,
                   accel_frac=float(np.mean(accel)), **kw)

    def reset(self) -> None:
        self._rate = None

    def observe(self, snap: FleetSnapshot) -> AutoscaleAction:
        rate = snap.arrivals / self.epoch_s
        if self._rate is None:
            self._rate = rate
        else:
            self._rate = self.alpha * rate + (1.0 - self.alpha) * self._rate
        accel_rate = self._rate * self.accel_frac
        # hedged duplicates of accelerated requests land on the CPU pool
        cpu_rate = (self._rate * (1.0 - self.accel_frac)
                    + accel_rate * self.hedge_allowance)
        n_cpu = math.ceil(cpu_rate * self.cpu_service_s / self.target_util)
        n_dscs = math.ceil(accel_rate * self.dscs_service_s
                           / self.target_util)
        return AutoscaleAction(
            n_cpu=min(snap.n_cpu_total, max(self.min_cpu, n_cpu)),
            n_dscs_on=min(snap.n_dscs_total, max(self.min_dscs_on, n_dscs)))


class WorstTenantPolicy(ReactivePolicy):
    """Reactive scaling driven by the *worst-off tenant*, not the fleet
    aggregate.

    On multi-tenant runs the engine's :class:`~repro_torch.core.engine.
    FleetSnapshot` carries per-tenant live backlogs (``tenant_queue``).
    A fleet-level average can look healthy while one tenant drowns behind
    a noisy neighbor; this policy sizes both pools as if *every* tenant
    were as backlogged as the worst one (``max(tenant_queue) * n_tenants``
    replaces the aggregate queue in the scale-up rule), so isolation
    pressure, not mean load, drives capacity.  On single-tenant runs
    (empty ``tenant_queue``) it degrades to plain :class:`ReactivePolicy`.
    """

    name = "worst-tenant"

    def observe(self, snap: FleetSnapshot) -> AutoscaleAction:
        if not snap.tenant_queue:
            return super().observe(snap)
        worst = max(snap.tenant_queue) * len(snap.tenant_queue)
        # per-tenant backlogs aggregate both classes; split the pessimistic
        # total across the pools in proportion to their live queues
        total = max(1, snap.dscs_queue + snap.cpu_queue)
        dscs_q = math.ceil(worst * snap.dscs_queue / total)
        cpu_q = math.ceil(worst * snap.cpu_queue / total)
        return AutoscaleAction(
            n_cpu=self._resize(snap.n_cpu_active, cpu_q, snap.cpu_busy,
                               self.min_cpu, snap.n_cpu_total),
            n_dscs_on=self._resize(snap.n_dscs_on, dscs_q, snap.dscs_busy,
                                   self.min_dscs_on, snap.n_dscs_total))


# --------------------------------------------------------------------------
# evaluation: cost per SLA-met request + energy per request
# --------------------------------------------------------------------------

def fleet_energy_j(power_stats: Dict[str, object]) -> Dict[str, float]:
    """Fleet energy from the engine's ``power_stats()``: busy seconds at
    each platform's active power plus powered-idle seconds at its idle
    power (:func:`repro_torch.core.energy.node_power_w`); powered-off servers
    draw nothing."""
    out: Dict[str, float] = {}
    for cls, plat_name in (("cpu", CPU_FALLBACK_PLATFORM),
                           ("dscs", DSCS_PLATFORM)):
        plat = PLATFORMS[plat_name]
        st = power_stats[cls]
        busy = float(st["busy_s"])
        idle = max(0.0, float(st["powered_s"]) - busy)
        out[cls] = (busy * node_power_w(plat, True)
                    + idle * node_power_w(plat, False))
    out["total"] = out["cpu"] + out["dscs"]
    return out


def fleet_cost_usd(power_stats: Dict[str, object], energy_j: float,
                   repair_bytes: float = 0.0) -> Dict[str, float]:
    """Fleet cost over the run: powered server-seconds priced at each
    platform's amortized CAPEX rental rate
    (:func:`repro_torch.core.cost.rental_rate_usd_per_s`) plus metered
    electricity for the consumed energy, plus re-replication traffic
    (``repair_bytes``, from the engine's ``fault_stats()``) priced at
    :data:`repro_torch.core.cost.REPAIR_USD_PER_GB` — so a policy that
    power-cycles drives is charged for the repair bytes it triggers."""
    out = {
        "cpu_capex": (rental_rate_usd_per_s(PLATFORMS[CPU_FALLBACK_PLATFORM])
                      * float(power_stats["cpu"]["powered_s"])),
        "dscs_capex": (rental_rate_usd_per_s(PLATFORMS[DSCS_PLATFORM])
                       * float(power_stats["dscs"]["powered_s"])),
        "electricity": energy_j / 3.6e6 * ELECTRICITY_USD_PER_KWH,
        "repair": repair_bytes / 1e9 * REPAIR_USD_PER_GB,
    }
    out["total"] = (out["cpu_capex"] + out["dscs_capex"]
                    + out["electricity"] + out["repair"])
    return out


@dataclass(frozen=True)
class AutoscaleReport:
    """Scorecard of one policy run — the run summary fig20 sweeps.

    ``mean_cpu_active`` / ``mean_dscs_on`` are powered server-seconds over
    the horizon (time-average fleet size); ``cost_per_sla_req_usd`` is the
    headline ServerMix-style metric (infinite when nothing met the SLA).
    """
    policy: str
    n_requests: int
    sla_met: int
    sla_frac: float
    p50_s: float
    p99_s: float
    horizon_s: float
    mean_cpu_active: float
    mean_dscs_on: float
    wake_events: int
    epochs: int
    energy_j: float
    energy_per_req_j: float
    cost_usd: float
    cost_per_sla_req_usd: float
    repair_gb: float = 0.0


def evaluate_policy(policy: AutoscalePolicy, pipelines: Sequence[Pipeline], *,
                    arrivals: ArrivalProcess, duration_s: float,
                    n_dscs: int, n_cpu: int, sla_s: float,
                    hedge_budget_s: Optional[float] = None, seed: int = 0,
                    latency_model: Optional[LatencyModel] = None,
                    dscs_wake_s: float = 0.2, tier=None,
                    faults: Optional[FaultPlan] = None,
                    timeout_s: Optional[float] = None,
                    overload=None) -> AutoscaleReport:
    """Run ``policy`` over a fresh engine and score it.

    ``n_dscs``/``n_cpu`` are the provisioned maxima the policy scales
    within; everything stochastic derives from ``seed``, so two policies
    evaluated with equal seeds face the identical arrival stream and
    service-tail draws — the comparison isolates the control decision.
    ``tier`` optionally attaches a :class:`~repro_torch.core.tiering.TierConfig`
    (replica routing prefers powered drives, so the tier composes with
    power cycling); ``None`` keeps the classic placement path.
    ``faults`` attaches a :class:`~repro_torch.core.faults.FaultPlan`; when its
    repair model is enabled (and the tier carries an object catalog), a
    policy decision that powers a drive off triggers the same replica
    repair as a fail-stop, and those repair bytes are charged to the cost
    scorecard (``repair_gb``, priced in :func:`fleet_cost_usd`) — power
    cycling is no longer free.  ``timeout_s`` adds per-request deadlines;
    abandoned requests never count as SLA-met.  ``overload`` attaches an
    :class:`~repro_torch.core.overload.OverloadControl`; rejected/shed requests
    never count as SLA-met either, and the policy's ``observe`` sees the
    per-epoch rejection and pushback signals on its
    :class:`~repro_torch.core.engine.FleetSnapshot`.
    """
    policy.reset()
    eng = ClusterEngine(n_dscs=n_dscs, n_cpu=n_cpu,
                        latency_model=latency_model,
                        hedge_budget_s=hedge_budget_s, seed=seed,
                        dscs_wake_s=dscs_wake_s, tier=tier, faults=faults,
                        overload=overload)
    trace = eng.run_soa(pipelines, arrivals=arrivals, duration_s=duration_s,
                        controller=policy, timeout_s=timeout_s)
    ps = eng.power_stats()
    energy = fleet_energy_j(ps)
    fstats = eng.fault_stats()
    repair_bytes = (float(fstats["repair"]["bytes"])
                    if fstats and fstats.get("enabled") else 0.0)
    cost = fleet_cost_usd(ps, energy["total"], repair_bytes)
    n = trace.n
    lat = trace.latency
    lat = lat[~np.isnan(lat)]           # abandoned requests: no latency
    sla_met = int(np.count_nonzero(lat <= sla_s)) if n else 0
    horizon = float(ps["horizon"])
    return AutoscaleReport(
        policy=getattr(policy, "name", type(policy).__name__),
        n_requests=n, sla_met=sla_met,
        sla_frac=sla_met / n if n else 1.0,
        p50_s=(float(np.percentile(lat, 50)) if lat.size
               else (0.0 if not n else math.inf)),
        p99_s=(float(np.percentile(lat, 99)) if lat.size
               else (0.0 if not n else math.inf)),
        horizon_s=horizon,
        mean_cpu_active=(float(ps["cpu"]["powered_s"]) / horizon
                         if horizon > 0 else 0.0),
        mean_dscs_on=(float(ps["dscs"]["powered_s"]) / horizon
                      if horizon > 0 else 0.0),
        wake_events=int(ps["wake_events"]), epochs=int(ps["epochs"]),
        energy_j=energy["total"],
        energy_per_req_j=energy["total"] / n if n else 0.0,
        cost_usd=cost["total"],
        cost_per_sla_req_usd=(cost["total"] / sla_met if sla_met
                              else math.inf),
        repair_gb=repair_bytes / 1e9)
