"""Function scheduling, fallback and straggler mitigation (§V, §VI-C).

Thin façade over the discrete-event engine in :mod:`repro_torch.core.engine`.
``ClusterSim`` keeps the public surface the figures, examples and tests
have always used (``run``, ``max_throughput``, ``telemetry``,
``RequestResult``) while the actual fleet dynamics — per-drive FCFS
queues, data-aware placement through :class:`StoragePool`, hedged dispatch
racing the DSCS and CPU paths, and pluggable arrival processes — live in
the engine's event loop:

  * FCFS per node, run-to-completion, no multi-tenancy on a DSA
  * acceleratable functions are dispatched to the DSCS drive that HOLDS the
    request's data (deterministic placement hash), never a random draw
  * Prometheus-style telemetry drives the busy/available decision
  * hedged dispatch: if a request is still queued past ``hedge_budget_s``,
    a second copy is issued on the least-loaded CPU node, both copies race,
    the earlier finisher wins and the loser is cancelled (tail/straggler
    mitigation — our addition, evaluated in fig16)
  * autoscaling: ``run_autoscaled`` attaches an
    :class:`~repro_torch.core.autoscale.AutoscalePolicy` control loop that
    resizes the active fleet at epoch boundaries and scores the run on
    cost per SLA-met request and energy per request (fig20); the policy
    classes are re-exported here as the public API
  * multi-tenancy: ``run_tenants`` serves several
    :class:`~repro_torch.core.tenancy.TenantSpec` streams through one fleet
    under a pluggable drive scheduler (FCFS run-to-completion baseline,
    weighted time-slicing, spatial DSA-lane partitioning) and returns
    per-tenant :class:`~repro_torch.core.tenancy.TenantReport` scorecards
    (fig21 fairness study); the tenancy API is re-exported here
  * fault injection: ``ClusterSim(faults=FaultPlan(...))`` attaches the
    seeded failure/recovery layer from :mod:`repro_torch.core.faults` — drive
    fail-stop and gray-failure stalls, CPU node crashes, retry with
    backoff under a budget, replica repair, timeout-based failure
    detection — scored by ``fault_stats()`` and studied in fig23; the
    fault API is re-exported here
  * overload control: ``ClusterSim(overload=OverloadControl(...))``
    attaches the deterministic admission / load-shedding / backpressure /
    brownout layer from :mod:`repro_torch.core.overload` that keeps goodput
    near capacity past the saturation knee instead of collapsing into a
    retry storm — scored by ``overload_stats()`` and studied in fig24;
    the overload API is re-exported here

Every run is reproducible from the constructor seed: repeated ``run``
calls on one ``ClusterSim`` (and two sims built with equal seeds) produce
identical ``RequestResult`` streams.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess, PoissonProcess
from repro_torch.core.autoscale import (AutoscaleAction,  # noqa: F401
                                  AutoscalePolicy, AutoscaleReport,
                                  EWMAPolicy, ReactivePolicy, StaticPolicy,
                                  WorstTenantPolicy, evaluate_policy)
from repro_torch.core.engine import (ClusterEngine, EngineTrace,  # noqa: F401
                               FleetSnapshot, RequestResult, Telemetry)
from repro_torch.core.faults import (CpuCrash, DriveFailure,  # noqa: F401
                               DriveStall, ExponentialBackoff, FaultPlan,
                               FixedRetry, NoRetry, RepairModel,
                               RetryBudget, RetryPolicy)
from repro_torch.core.function import Pipeline
from repro_torch.core.latency import LatencyModel
from repro_torch.core.lindley import DEFAULT_BACKEND
from repro_torch.core.overload import (AdmitAll, Backpressure,  # noqa: F401
                                 Brownout, OverloadControl, QueueThreshold,
                                 ShedPolicy, ThrottledArrivals, TokenBucket)
from repro_torch.core.placement import StoragePool
from repro_torch.core.tenancy import (DriveScheduler,  # noqa: F401
                                FCFSRunToCompletion, SpatialPartition,
                                TenantReport, TenantSpec, WeightedTimeSlice,
                                jain_index, tenant_reports)
from repro_torch.core.sharding import (MailboxOverflow, ShardMailbox,  # noqa: F401
                                 ShardPlan)
from repro_torch.core.tiering import (DriveCache, MigrationPolicy,  # noqa: F401
                                TierConfig)

__all__ = ["AdmitAll", "AutoscaleAction", "AutoscalePolicy",
           "AutoscaleReport", "Backpressure", "Brownout", "ClusterSim",
           "CpuCrash", "DriveCache", "DriveFailure", "DriveScheduler",
           "DriveStall", "EWMAPolicy", "ExponentialBackoff",
           "FCFSRunToCompletion", "FaultPlan", "FixedRetry",
           "FleetSnapshot", "MailboxOverflow", "MigrationPolicy",
           "NoRetry", "OverloadControl", "QueueThreshold",
           "ReactivePolicy", "RepairModel", "RequestResult",
           "RetryBudget", "RetryPolicy", "ShardMailbox", "ShardPlan",
           "ShedPolicy", "SpatialPartition", "StaticPolicy", "Telemetry",
           "TenantReport", "TenantSpec", "ThrottledArrivals",
           "TierConfig", "TokenBucket", "WeightedTimeSlice",
           "WorstTenantPolicy", "jain_index", "tenant_reports"]


class ClusterSim:
    """Simulates a fleet: N DSCS drives + M CPU fallback nodes serving a
    request stream of Table I pipelines (Poisson by default; any
    :class:`ArrivalProcess` via ``arrivals=``)."""

    def __init__(self, *, n_dscs: int = 100, n_cpu: int = 100,
                 latency_model: Optional[LatencyModel] = None,
                 hedge_budget_s: Optional[float] = None, seed: int = 0,
                 tier: Optional[TierConfig] = None,
                 faults: Optional[FaultPlan] = None,
                 overload: Optional[OverloadControl] = None):
        self.lm = latency_model or LatencyModel(seed=seed)
        self.pool = StoragePool(n_plain=64, n_dscs=n_dscs)
        self.n_dscs = n_dscs
        self.n_cpu = n_cpu
        self.hedge_budget_s = hedge_budget_s
        self.seed = seed
        self.tier = tier
        self.faults = faults
        self.overload = overload
        self.telemetry = Telemetry()
        self.engine = ClusterEngine(
            n_dscs=n_dscs, n_cpu=n_cpu, latency_model=self.lm,
            hedge_budget_s=hedge_budget_s, seed=seed,
            telemetry=self.telemetry, tier=tier, faults=faults,
            overload=overload)

    def run(self, pipelines: List[Pipeline], *, rps: Optional[float] = None,
            duration_s: float = 120.0,
            arrivals: Optional[ArrivalProcess] = None,
            timeout_s: Optional[float] = None) -> List[RequestResult]:
        """Simulate ``duration_s`` of offered load.

        Pass either ``rps`` (Poisson arrivals at that rate — the historical
        interface) or an explicit ``arrivals`` process.  ``timeout_s``
        enforces a per-request deadline: a request still unfinished that
        long after arrival is abandoned (``finish`` NaN, ``winner`` "").
        """
        if arrivals is None:
            if rps is None:
                raise ValueError("pass rps= or arrivals=")
            arrivals = PoissonProcess(rate=rps)
        elif rps is not None:
            raise ValueError("pass either rps= or arrivals=, not both "
                             "(rps would be silently ignored)")
        return self.engine.run(pipelines, arrivals=arrivals,
                               duration_s=duration_s, timeout_s=timeout_s)

    def run_sharded(self, pipelines: List[Pipeline], *,
                    rps: Optional[float] = None, duration_s: float = 120.0,
                    arrivals: Optional[ArrivalProcess] = None,
                    n_shards: int = 1, processes: Optional[int] = None,
                    timeout_s: Optional[float] = None,
                    backend: str = DEFAULT_BACKEND) -> EngineTrace:
        """Simulate the same offered load sharded by drive partition.

        ``n_shards=1`` is the classic event loop (identical to ``run``,
        but returning the raw :class:`EngineTrace` arrays instead of
        materialized :class:`RequestResult` objects — the natural form
        at the fleet scales sharding targets).  With ``n_shards >= 2``
        the fleet splits into disjoint drive partitions executed by
        :mod:`repro_torch.core.sharding`; see
        :meth:`ClusterEngine.run_sharded`.  ``queue_stats``,
        ``power_stats``, ``fault_stats`` and ``tier_stats`` all report
        the merged fleet view afterwards.  ``backend`` selects the fast
        path's Lindley solver (:mod:`repro_torch.core.lindley`; ``cuda``,
        the default, runs K6 on the card, raises without one and needs
        ``processes=1``).
        """
        if arrivals is None:
            if rps is None:
                raise ValueError("pass rps= or arrivals=")
            arrivals = PoissonProcess(rate=rps)
        elif rps is not None:
            raise ValueError("pass either rps= or arrivals=, not both "
                             "(rps would be silently ignored)")
        return self.engine.run_sharded(pipelines, arrivals=arrivals,
                                       duration_s=duration_s,
                                       n_shards=n_shards,
                                       processes=processes,
                                       timeout_s=timeout_s,
                                       backend=backend)

    def queue_stats(self):
        """Queue-depth telemetry from the most recent ``run``."""
        return self.engine.queue_stats()

    def fault_stats(self):
        """Fault-injection & recovery telemetry from the most recent run
        (``None`` when the sim was built without a
        :class:`~repro_torch.core.faults.FaultPlan` and the run set no
        ``timeout_s``)."""
        return self.engine.fault_stats()

    def tier_stats(self):
        """Tiered data-layer telemetry from the most recent run (``None``
        when the sim was built without an enabled
        :class:`~repro_torch.core.tiering.TierConfig`)."""
        return self.engine.tier_stats()

    def overload_stats(self):
        """Overload-control telemetry from the most recent run (``None``
        when the sim was built without an enabled
        :class:`~repro_torch.core.overload.OverloadControl`): admitted /
        rejected / shed counts split by cause, class and tenant, the
        pushback timeline, brownout intervals and goodput."""
        return self.engine.overload_stats()

    # -- multi-tenancy (ROADMAP item; see repro_torch.core.tenancy) ----------------
    def run_tenants(self, tenants: Sequence[TenantSpec], *,
                    duration_s: float,
                    scheduler: Optional[DriveScheduler] = None,
                    controller: Optional[AutoscalePolicy] = None,
                    ) -> Tuple[EngineTrace, List[TenantReport]]:
        """Serve several tenants' streams through this fleet and score
        each tenant.

        Every :class:`~repro_torch.core.tenancy.TenantSpec` brings its own
        pipeline mix, arrival process, SLA target and share weight; the
        streams are multiplexed deterministically from the sim seed.
        ``scheduler`` picks how drives share their DSA —
        :class:`FCFSRunToCompletion` (default, the paper's §V baseline),
        :class:`WeightedTimeSlice` or :class:`SpatialPartition`.
        ``controller`` optionally attaches an autoscaling policy (FCFS
        scheduler only).  Returns the raw
        :class:`~repro_torch.core.engine.EngineTrace` (``trace.tenant`` maps
        each request to its tenant) and one
        :class:`~repro_torch.core.tenancy.TenantReport` per tenant; the
        engine's :meth:`~repro_torch.core.engine.ClusterEngine.tenant_stats`
        holds the per-tenant queue/busy-seconds telemetry afterwards.
        """
        trace = self.engine.run_soa(tenants=tenants, duration_s=duration_s,
                                    scheduler=scheduler,
                                    controller=controller)
        return trace, tenant_reports(trace, tenants,
                                     self.engine.tenant_stats())

    def tenant_stats(self):
        """Per-tenant telemetry from the most recent ``run_tenants``."""
        return self.engine.tenant_stats()

    # -- autoscaling (ROADMAP item; see repro_torch.core.autoscale) ----------------
    def run_autoscaled(self, pipelines: List[Pipeline], *,
                       policy: AutoscalePolicy, arrivals: ArrivalProcess,
                       duration_s: float, sla_s: float = 0.6,
                       dscs_wake_s: float = 0.2) -> AutoscaleReport:
        """Run ``duration_s`` of offered load with ``policy`` resizing the
        fleet at its epoch boundaries, and score the run on cost per
        SLA-met request and energy per request.

        The sim's ``n_dscs``/``n_cpu`` become the provisioned maxima the
        policy scales within; the run uses a fresh engine with this sim's
        seed/latency model, so it neither consumes nor disturbs the sim's
        own telemetry, and repeated calls are exactly reproducible.
        """
        return evaluate_policy(
            policy, pipelines, arrivals=arrivals, duration_s=duration_s,
            n_dscs=self.n_dscs, n_cpu=self.n_cpu, sla_s=sla_s,
            hedge_budget_s=self.hedge_budget_s, seed=self.seed,
            latency_model=self.lm, dscs_wake_s=dscs_wake_s)

    # -- throughput under SLA (Fig. 12 methodology) ------------------------
    def max_throughput(self, pipelines: List[Pipeline], *, sla_s: float,
                       sla_frac: float = 0.99, duration_s: float = 60.0,
                       lo: float = 1.0, hi: float = 4096.0,
                       arrivals: Optional[ArrivalProcess] = None) -> float:
        """Binary-search the highest mean RPS meeting the SLA.  ``arrivals``
        selects the load *shape*; its rate is rescaled at every probe (so
        trace replay, which has no free rate, is rejected).

        Every probe replays the same :class:`~repro_torch.core.engine.SampleBank`
        (common random numbers): pipeline picks and service-tail draws are
        sampled once for the whole search, and for Poisson load the arrival
        stream itself is one cached vector of unit-rate exponential gaps
        rescaled per probe (``t_i(r) = cumsum(gaps)_i / r``) — a single
        sampling pass instead of twelve, and probes differ only through
        the offered rate, not sampling noise.  Shaped (bursty/diurnal)
        processes keep their wall-clock phase structure, so only their
        arrival stream is redrawn per probe; picks and service draws stay
        banked.
        """
        proto = arrivals if arrivals is not None else PoissonProcess(rate=1.0)
        bank = self.engine.sample_bank(pipelines)
        poisson = type(proto) is PoissonProcess
        if poisson:
            # one cached unit-rate arrival stream for the whole search
            gap_rng = np.random.default_rng(
                np.random.SeedSequence(self.seed).spawn(2)[0])
            cum = np.cumsum(gap_rng.standard_exponential(
                max(int(hi * duration_s * 1.25), 64)))

        def probe(rps: float) -> EngineTrace:
            nonlocal cum
            if not poisson:
                return self.engine.run_soa(pipelines, duration_s=duration_s,
                                           arrivals=proto.with_rate(rps),
                                           bank=bank)
            horizon = rps * duration_s
            while cum[-1] < horizon:    # rare: extend the cached stream
                cum = np.concatenate([cum, cum[-1] + np.cumsum(
                    gap_rng.standard_exponential(cum.size))])
            times = cum[:np.searchsorted(cum, horizon)] / rps
            return self.engine.run_soa(pipelines, times=times, bank=bank)

        def ok(rps: float) -> bool:
            trace = probe(rps)
            if not trace.n:
                return True
            return float(np.mean(trace.latency <= sla_s)) >= sla_frac

        for _ in range(12):
            mid = math.sqrt(lo * hi)
            if ok(mid):
                lo = mid
            else:
                hi = mid
        return lo
