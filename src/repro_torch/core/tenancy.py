"""Multi-tenant DSA sharing: tenant model + pluggable drive schedulers.

The paper's §V scheduler dedicates each drive's 15 W DSA to one request at
a time (run-to-completion, no multi-tenancy) — which wastes
accelerator-seconds exactly when serverless multiplexing should shine, and
ROADMAP names "Multi-tenant DSAs" as the top open item.  This module is
the tenant-facing layer of that relaxation (cf. Hardless, arXiv
2208.03192, on shared serverless accelerator pools, and ServerMix, arXiv
1907.11465, on fairness/interference of multiplexed serverless resources):

  * :class:`TenantSpec` — one tenant's contract: its pipeline (workload)
    mix, its own arrival process (multiplexed deterministically by
    :class:`repro_torch.core.arrivals.MergedArrivals`), an SLA target, and a
    share weight the drive schedulers honor.
  * :class:`DriveScheduler` policies — how a drive's DSA is shared between
    tenants.  Value objects; the engine implements the mechanics:

      - :class:`FCFSRunToCompletion` — the paper's baseline: one FCFS
        queue per drive, run-to-completion, tenants interleave
        arbitrarily (no isolation).
      - :class:`WeightedTimeSlice` — weighted round-robin time-slicing:
        each rotation serves the next backlogged tenant for a quantum of
        ``quantum_s * weight``, preempting the copy (its remaining service
        resumes at the tenant's next turn) and paying a modeled
        ``switch_s`` DSA context-switch cost whenever the serving tenant
        changes.
      - :class:`SpatialPartition` — the drive's DSA is split into
        ``lanes`` PE groups assigned to tenants in proportion to their
        weights (largest-remainder, at least one lane each).  Each
        tenant's lane group is an independent FCFS run-to-completion
        server whose service time is inflated by ``lanes/assigned`` —
        hard isolation at a per-request throughput cost.

  * fairness scoring — :func:`jain_index`,
    :func:`isolation_violation_rate` and per-tenant
    :func:`tenant_reports` over an :class:`~repro_torch.core.engine.EngineTrace`
    (consumed duck-typed: this module never imports the engine).

``benchmarks/figures.py::fig21_tenant_fairness`` is the fairness study: a
bursty noisy-neighbor tenant degrading a latency-sensitive tenant's p99
under FCFS, with time-slicing/partitioning restoring isolation at a
quantified throughput cost.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.function import Pipeline

__all__ = [
    "DriveScheduler", "FCFSRunToCompletion", "SpatialPartition",
    "TenantReport", "TenantSpec", "WeightedTimeSlice", "assign_lanes",
    "isolation_violation_rate", "jain_index", "tenant_reports",
]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's contract with the shared fleet.

    ``pipelines`` is the tenant's workload mix (each request picks
    uniformly from it, like the single-tenant engine does over its
    pipeline list); ``arrivals`` is the tenant's own offered-load process,
    multiplexed with the other tenants' streams deterministically;
    ``sla_s`` is the per-tenant latency SLO that
    :func:`tenant_reports` scores attainment against; ``weight`` is the
    share the drive schedulers honor (quantum length under
    :class:`WeightedTimeSlice`, lane count under
    :class:`SpatialPartition`).
    """
    name: str
    pipelines: Tuple[Pipeline, ...]
    arrivals: ArrivalProcess
    sla_s: float = 0.6
    weight: float = 1.0

    def __post_init__(self) -> None:
        object.__setattr__(self, "pipelines", tuple(self.pipelines))
        if not self.pipelines:
            raise ValueError(f"tenant {self.name!r} needs at least one "
                             "pipeline in its mix")
        if self.sla_s <= 0.0:
            raise ValueError("sla_s must be positive")
        if self.weight <= 0.0:
            raise ValueError("weight must be positive")


# --------------------------------------------------------------------------
# drive schedulers (value objects; mechanics live in the engine loop)
# --------------------------------------------------------------------------

class DriveScheduler:
    """Base marker for drive-side DSA sharing policies.  Instances are
    immutable configuration; :meth:`repro_torch.core.engine.ClusterEngine.run_soa`
    interprets them in its event loop."""
    name = "base"


@dataclass(frozen=True)
class FCFSRunToCompletion(DriveScheduler):
    """The paper's §V baseline: one FCFS queue per drive, run-to-
    completion, no DSA multi-tenancy.  Tenants share the queue with no
    isolation — a bursty neighbor heads-of-line-blocks everyone.  With a
    single default tenant this is bit-identical to the classic engine
    path (golden-trace gated)."""
    name = "fcfs"


@dataclass(frozen=True)
class WeightedTimeSlice(DriveScheduler):
    """Weighted round-robin time-slicing of a drive's DSA across tenants.

    Each scheduling decision serves the next backlogged tenant (cyclic
    order) for at most ``quantum_s * weight`` seconds; an unfinished copy
    is preempted and resumes (remaining service intact) at the tenant's
    next turn.  Whenever the serving tenant changes, the DSA pays
    ``switch_s`` of context-switch overhead (weight/scratchpad reload)
    before service resumes — the modeled cost that makes time-slicing a
    quantified throughput-vs-isolation tradeoff rather than a free lunch.
    """
    name = "timeslice"
    quantum_s: float = 0.02
    switch_s: float = 0.002

    def __post_init__(self) -> None:
        if self.quantum_s <= 0.0:
            raise ValueError("quantum_s must be positive")
        if self.switch_s < 0.0:
            raise ValueError("switch_s must be >= 0")


@dataclass(frozen=True)
class SpatialPartition(DriveScheduler):
    """Spatial partitioning of a drive's DSA PE array into lanes.

    ``lanes`` PE groups (0 = one lane per tenant) are assigned to tenants
    in proportion to their weights (largest remainder, at least one lane
    each — see :func:`assign_lanes`).  Each tenant's lane group on each
    drive is an independent FCFS run-to-completion server; a tenant
    holding ``l`` of ``L`` lanes runs every request ``L/l`` times slower
    (fewer PEs), which is the partitioning throughput cost.  Isolation is
    hard: a noisy neighbor cannot touch another tenant's lanes.
    """
    name = "spatial"
    lanes: int = 0

    def __post_init__(self) -> None:
        if self.lanes < 0:
            raise ValueError("lanes must be >= 0 (0 = one lane per tenant)")


def assign_lanes(weights: Sequence[float], lanes: int) -> List[int]:
    """Largest-remainder lane assignment with a one-lane floor per tenant.

    Deterministic: remainder ties break toward the lower tenant index.
    Raises if there are fewer lanes than tenants (every tenant must hold
    at least one lane or it could never be served).
    """
    k = len(weights)
    if lanes < k:
        raise ValueError(f"{lanes} lanes cannot cover {k} tenants "
                         "(every tenant needs at least one)")
    spare = lanes - k                   # one guaranteed lane each
    total_w = float(sum(weights))
    shares = [w / total_w * spare for w in weights]
    out = [1 + int(s) for s in shares]
    rem = [(-(s - int(s)), i) for i, s in enumerate(shares)]
    rem.sort()
    for j in range(spare - sum(int(s) for s in shares)):
        out[rem[j][1]] += 1
    return out


# --------------------------------------------------------------------------
# fairness scoring
# --------------------------------------------------------------------------

def jain_index(values: Sequence[float]) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` — 1.0 when every tenant
    gets an equal share, → 1/n when one tenant takes everything.  An
    empty or all-zero vector scores 1.0 (nothing to be unfair about)."""
    xs = np.asarray(values, dtype=float)
    if xs.size == 0:
        return 1.0
    sq = float(np.sum(xs * xs))
    if sq == 0.0:
        return 1.0
    s = float(np.sum(xs))
    return s * s / (xs.size * sq)


def isolation_violation_rate(shared_sla_frac: float,
                             solo_sla_frac: float) -> float:
    """How much SLA attainment a tenant *lost to its neighbors*: the drop
    from its solo-run attainment (same fleet, neighbors absent) to its
    attainment in the shared run, floored at zero (sharing can also help,
    e.g. via statistically multiplexed capacity)."""
    return max(0.0, float(solo_sla_frac) - float(shared_sla_frac))


@dataclass(frozen=True)
class TenantReport:
    """Per-tenant scorecard of one multi-tenant run."""
    name: str
    arrivals: int
    completions: int
    sla_s: float
    sla_met: int
    sla_frac: float
    p50_s: float
    p99_s: float
    mean_s: float
    busy_dscs_s: float                  # DSA service-seconds consumed
    busy_cpu_s: float                   # CPU service-seconds consumed
    max_queue_depth: float              # live queued copies, both classes
    mean_queue_depth: float             # time-averaged over the horizon


def tenant_reports(trace, tenants: Sequence[TenantSpec],
                   stats: Optional[Dict] = None) -> List[TenantReport]:
    """Score each tenant from an :class:`~repro_torch.core.engine.EngineTrace`
    (duck-typed: needs ``.tenant``, ``.latency`` arrays) plus, optionally,
    the engine's :meth:`~repro_torch.core.engine.ClusterEngine.tenant_stats`
    dict for the queue/busy-seconds columns (zeros when absent)."""
    tid = np.asarray(trace.tenant)
    lat = trace.latency
    out: List[TenantReport] = []
    for k, ten in enumerate(tenants):
        lk = lat[tid == k]
        n = int(lk.size)
        met = int(np.count_nonzero(lk <= ten.sla_s)) if n else 0
        if stats is not None:
            done = int(stats["completions"][k])
            busy_d = float(stats["busy_dscs_s"][k])
            busy_c = float(stats["busy_cpu_s"][k])
            maxd = float(max(stats["queue"]["dscs"]["max_depth"][k],
                             stats["queue"]["cpu"]["max_depth"][k]))
            meand = float(stats["queue"]["dscs"]["mean_depth"][k]
                          + stats["queue"]["cpu"]["mean_depth"][k])
        else:
            done = n                    # the engine drains every arrival
            busy_d = busy_c = maxd = meand = 0.0
        out.append(TenantReport(
            name=ten.name, arrivals=n, completions=done, sla_s=ten.sla_s,
            sla_met=met, sla_frac=met / n if n else 1.0,
            p50_s=float(np.percentile(lk, 50)) if n else 0.0,
            p99_s=float(np.percentile(lk, 99)) if n else 0.0,
            mean_s=float(np.mean(lk)) if n else 0.0,
            busy_dscs_s=busy_d, busy_cpu_s=busy_c,
            max_queue_depth=maxd, mean_queue_depth=meand))
    return out
