"""Fault injection & failure recovery (robustness layer, ISSUE 7).

The fleet simulator modeled drives and CPU nodes as infallible, so every
headline figure silently assumed 100% availability.  This module supplies
the dependability vocabulary the engine interprets
(``ClusterEngine(faults=FaultPlan(...))``):

  * **fault taxonomy** — four injectable fault kinds, either listed
    explicitly (:class:`DriveFailure`, :class:`DriveStall`,
    :class:`CpuCrash`) or generated from per-class MTBF/MTTR knobs on the
    plan; plus a per-fetch backing-store failure probability:

      - *drive fail-stop*: the drive vanishes; queued and in-flight
        requests are lost, its materialized objects are gone (a repaired/
        replaced drive comes back empty and refills lazily).
      - *drive stall* (gray failure): the drive keeps serving but every
        service started inside the window runs ``factor`` x slower.
      - *CPU node crash*: the fallback node vanishes; its queued and
        running copies are lost.  A crash that would leave zero live CPU
        nodes is skipped (and counted), so the fallback path always
        exists.
      - *backing-store fetch failure*: each remote fetch independently
        fails with probability ``backing_fail_p``; every failed attempt
        costs ``backing_retry_s`` before the retry succeeds.

  * **retry with backoff** — a pluggable :class:`RetryPolicy` decides how
    a lost request is re-dispatched: :class:`NoRetry` (the request is
    abandoned), :class:`FixedRetry` (constant delay), or
    :class:`ExponentialBackoff` with *decorrelated jitter*
    (``delay = min(cap, U(base, 3 * prev))``, the AWS-architecture-blog
    scheme the Lithops/ServerMix executors use), all under a
    ``max_attempts`` cap and an optional fleet-wide :class:`RetryBudget`
    circuit breaker (retries stop when they exceed a fraction of the
    arrivals seen so far, so retry storms cannot melt a degraded fleet).

  * **repair** — a :class:`RepairModel` re-replicates the objects that
    lost a replica (drive failure, or an autoscaler power-down — the
    ROADMAP follow-on) onto surviving drives through one serialized
    repair pipe of ``bandwidth_bps``; the replica table is patched when
    the transfer completes, and the moved bytes/seconds are reported so
    :func:`repro_torch.core.autoscale.evaluate_policy` can charge them to the
    cost model.

  * **timeout-based failure detection** — ``detect_timeout_s`` arms a
    watchdog per DSCS dispatch: a request still unfinished that long
    after dispatch gets a CPU hedge copy, so a stalled (not failed) drive
    is routed around before the stall clears.  Per-request
    ``timeout_s`` deadline abandonment is independent of this module
    (``ClusterEngine.run_soa(timeout_s=...)``) and works faults-on or
    faults-off.

Everything stochastic (generated fault times, jitter, backing-fetch coin
flips) draws from a dedicated SeedSequence child of the engine seed that
is **only spawned when a plan is attached**, so fault-free runs keep the
golden-trace streams bit-for-bit, and one (seed, plan) pair always yields
the identical :class:`~repro_torch.core.engine.EngineTrace` and
``fault_stats()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "CpuCrash", "DriveFailure", "DriveStall", "ExponentialBackoff",
    "FaultPlan", "FixedRetry", "NoRetry", "RepairModel", "RetryBudget",
    "RetryPolicy",
]

# internal timeline event kinds (time-ordered tuples the engine consumes)
DRIVE_FAIL, DRIVE_RECOVER, STALL_BEGIN, STALL_END, CPU_CRASH, CPU_RECOVER = \
    range(6)


# --------------------------------------------------------------------------
# explicit fault events
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DriveFailure:
    """Fail-stop: drive ``drive`` dies at ``time``; with a finite
    ``down_s`` a replacement comes back (empty) that much later."""
    time: float
    drive: int
    down_s: float = math.inf


@dataclass(frozen=True)
class DriveStall:
    """Gray failure: services started on ``drive`` inside
    ``[time, time + duration_s)`` run ``factor`` x slower."""
    time: float
    drive: int
    duration_s: float
    factor: float = 8.0


@dataclass(frozen=True)
class CpuCrash:
    """CPU fallback node ``node`` dies at ``time`` for ``down_s``."""
    time: float
    node: int
    down_s: float = math.inf


# --------------------------------------------------------------------------
# retry policies
# --------------------------------------------------------------------------

class RetryPolicy:
    """Decides the re-dispatch delay of a lost request.

    ``delay_s(attempt, prev_delay_s, rng)`` returns the seconds to wait
    before attempt ``attempt`` (1-based count of losses so far), or
    ``None`` to give up.  ``prev_delay_s`` is the delay granted to this
    request's previous attempt (0.0 on the first), which is the state
    decorrelated jitter needs.
    """

    name = "base"
    max_attempts: int = 0

    def delay_s(self, attempt: int, prev_delay_s: float,
                rng: np.random.Generator) -> Optional[float]:
        raise NotImplementedError


class NoRetry(RetryPolicy):
    """Lost requests are never re-dispatched (abandoned)."""

    name = "none"

    def delay_s(self, attempt, prev_delay_s, rng):
        return None


@dataclass(frozen=True)
class FixedRetry(RetryPolicy):
    """Constant re-dispatch delay, up to ``max_attempts`` losses."""

    delay: float = 0.05
    max_attempts: int = 4
    name = "fixed"

    def delay_s(self, attempt, prev_delay_s, rng):
        if attempt > self.max_attempts:
            return None
        return self.delay


@dataclass(frozen=True)
class ExponentialBackoff(RetryPolicy):
    """Exponential backoff with decorrelated jitter.

    ``delay = min(cap_s, U(base_s, max(base_s, 3 * prev_delay)))`` — the
    expected delay grows geometrically with each loss while successive
    delays stay decorrelated across requests, so synchronized retry
    storms (every lost request hammering the repaired drive at once)
    cannot form.
    """

    base_s: float = 0.02
    cap_s: float = 2.0
    max_attempts: int = 6
    name = "exponential"

    def delay_s(self, attempt, prev_delay_s, rng):
        if attempt > self.max_attempts:
            return None
        hi = max(self.base_s, 3.0 * prev_delay_s)
        return min(self.cap_s, float(rng.uniform(self.base_s, hi))
                   if hi > self.base_s else self.base_s)


@dataclass(frozen=True)
class RetryBudget:
    """Fleet-wide retry circuit breaker (per run).

    Retries are granted while ``granted < min_tokens + ratio * arrivals``
    — i.e. the retry stream may never exceed ``ratio`` of the offered
    load (plus a small floor so early failures can still retry).  Beyond
    that the circuit opens and further losses are abandoned/degraded,
    which is what keeps a mass failure from doubling the offered load.
    """

    ratio: float = 0.25
    min_tokens: int = 16

    def allows(self, granted: int, arrivals: int) -> bool:
        return granted < self.min_tokens + self.ratio * arrivals


@dataclass(frozen=True)
class RepairModel:
    """Re-replication pipe: lost replicas are copied back onto surviving
    drives through one serialized stream of ``bandwidth_bps`` bytes/s
    (repairs queue behind each other, so a failure burst stretches the
    window during which objects sit under-replicated)."""

    bandwidth_bps: float = 200e6

    def validate(self) -> None:
        if self.bandwidth_bps <= 0.0:
            raise ValueError("repair bandwidth_bps must be positive")


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultPlan:
    """Everything the engine needs to inject faults and recover.

    ``events`` lists explicit faults; the ``*_mtbf_s`` knobs additionally
    generate per-server fault processes (exponential inter-fault gaps,
    drawn from the run's dedicated fault rng — deterministic per seed).
    ``drive_mttr_s``/``cpu_mttr_s`` of ``None`` mean fail-stop for the
    rest of the run.  ``retry``/``retry_budget`` govern re-dispatch of
    lost requests; ``repair`` attaches the re-replication pipe (needs the
    tiered data layer with a finite object universe);
    ``detect_timeout_s`` arms the per-dispatch stall watchdog;
    ``backing_fail_p``/``backing_retry_s`` make remote fetches fallible.
    """

    events: Tuple[object, ...] = ()
    drive_mtbf_s: Optional[float] = None
    drive_mttr_s: Optional[float] = None
    stall_mtbf_s: Optional[float] = None
    stall_s: float = 2.0
    stall_factor: float = 8.0
    cpu_mtbf_s: Optional[float] = None
    cpu_mttr_s: Optional[float] = None
    backing_fail_p: float = 0.0
    backing_retry_s: float = 0.03
    retry: RetryPolicy = field(default_factory=ExponentialBackoff)
    retry_budget: Optional[RetryBudget] = field(default_factory=RetryBudget)
    repair: Optional[RepairModel] = None
    detect_timeout_s: Optional[float] = None

    def validate(self) -> None:
        for ev in self.events:
            if not isinstance(ev, (DriveFailure, DriveStall, CpuCrash)):
                raise TypeError(f"unknown fault event: {ev!r}")
            if ev.time < 0.0:
                raise ValueError(f"fault event time must be >= 0: {ev!r}")
        for nm in ("drive_mtbf_s", "drive_mttr_s", "stall_mtbf_s",
                   "cpu_mtbf_s", "cpu_mttr_s"):
            v = getattr(self, nm)
            if v is not None and v <= 0.0:
                raise ValueError(f"{nm} must be positive")
        if self.stall_s <= 0.0 or self.stall_factor < 1.0:
            raise ValueError("stall_s must be positive and stall_factor "
                             ">= 1")
        if not 0.0 <= self.backing_fail_p < 1.0:
            raise ValueError("backing_fail_p must be in [0, 1)")
        if self.backing_retry_s < 0.0:
            raise ValueError("backing_retry_s must be >= 0")
        if not isinstance(self.retry, RetryPolicy):
            raise TypeError("retry must be a RetryPolicy")
        if self.repair is not None:
            self.repair.validate()
        if self.detect_timeout_s is not None and self.detect_timeout_s <= 0:
            raise ValueError("detect_timeout_s must be positive")

    # -- timeline expansion (deterministic from the fault rng) --------------
    def timeline(self, n_dscs: int, n_cpu: int, horizon_s: float,
                 rng: np.random.Generator) -> List[Tuple[float, int, int,
                                                         float]]:
        """Expand the plan into a sorted ``(time, kind, target, extra)``
        event list over ``[0, horizon_s)``.

        Generated processes draw exponential inter-fault gaps per server
        in index order, so the expansion is exactly reproducible from
        ``rng``; explicit events are merged in afterwards.  ``extra`` is
        the stall slowdown factor on ``STALL_BEGIN`` events and 0.0
        elsewhere.
        """
        out: List[Tuple[float, int, int, float]] = []

        def windows(mtbf: Optional[float], mttr: Optional[float], n: int,
                    k_begin: int, k_end: int, extra: float = 0.0,
                    width: Optional[float] = None) -> None:
            if mtbf is None or n <= 0 or horizon_s <= 0.0:
                return
            for srv in range(n):
                t = float(rng.exponential(mtbf))
                while t < horizon_s:
                    out.append((t, k_begin, srv, extra))
                    dur = width if width is not None else mttr
                    if dur is None:
                        break           # down for the rest of the run
                    out.append((t + dur, k_end, srv, 0.0))
                    t = t + dur + float(rng.exponential(mtbf))

        windows(self.drive_mtbf_s, self.drive_mttr_s, n_dscs,
                DRIVE_FAIL, DRIVE_RECOVER)
        windows(self.stall_mtbf_s, None, n_dscs, STALL_BEGIN, STALL_END,
                extra=self.stall_factor, width=self.stall_s)
        windows(self.cpu_mtbf_s, self.cpu_mttr_s, n_cpu,
                CPU_CRASH, CPU_RECOVER)

        for ev in self.events:
            if isinstance(ev, DriveFailure):
                if not 0 <= ev.drive < n_dscs:
                    raise ValueError(f"DriveFailure.drive {ev.drive} out of "
                                     f"range for {n_dscs} drives")
                out.append((ev.time, DRIVE_FAIL, ev.drive, 0.0))
                if math.isfinite(ev.down_s):
                    out.append((ev.time + ev.down_s, DRIVE_RECOVER,
                                ev.drive, 0.0))
            elif isinstance(ev, DriveStall):
                if not 0 <= ev.drive < n_dscs:
                    raise ValueError(f"DriveStall.drive {ev.drive} out of "
                                     f"range for {n_dscs} drives")
                out.append((ev.time, STALL_BEGIN, ev.drive, ev.factor))
                out.append((ev.time + ev.duration_s, STALL_END, ev.drive,
                            0.0))
            else:
                if not 0 <= ev.node < n_cpu:
                    raise ValueError(f"CpuCrash.node {ev.node} out of range "
                                     f"for {n_cpu} nodes")
                out.append((ev.time, CPU_CRASH, ev.node, 0.0))
                if math.isfinite(ev.down_s):
                    out.append((ev.time + ev.down_s, CPU_RECOVER, ev.node,
                                0.0))
        out.sort()
        return out


# --------------------------------------------------------------------------
# shard-local bookkeeping merge (sharded runs)
# --------------------------------------------------------------------------

def merge_fault_stats(states: List[Optional[dict]],
                      offered: int) -> Optional[dict]:
    """Merge per-shard ``fault_stats()`` dicts into one fleet view.

    Each shard of a sharded run injects faults and repairs replicas over
    its *own* drive/CPU slice from its own seed child; this folds those
    shard-local books back into the single-engine schema: counters sum,
    per-drive unavailability concatenates in shard (= drive) order, and
    the goodput fraction is recomputed against the fleet-wide ``offered``
    total.  Returns ``None`` when no shard tracked faults or deadlines.
    """
    live = [s for s in states if s is not None]
    if not live:
        return None
    completed = sum(s["goodput"]["completed"] for s in live)
    goodput = {"offered": offered, "completed": completed,
               "goodput_frac": completed / offered if offered else 0.0}
    dead = sum(s["deadline_abandoned"] for s in live)
    rejected = sum(s.get("rejected", 0) for s in live)
    shed = sum(s.get("shed", 0) for s in live)
    full = [s for s in live if s["enabled"]]
    if not full:
        return {"enabled": False, "abandoned": 0,
                "deadline_abandoned": dead, "rejected": rejected,
                "shed": shed, "goodput": goodput}
    per_drive: List[float] = []
    for s in live:
        per_drive += s["unavailability"]["per_drive_s"] if s["enabled"] else []
    out = {
        "enabled": True,
        "injected": {k: sum(s["injected"][k] for s in full)
                     for k in full[0]["injected"]},
        "lost": sum(s["lost"] for s in full),
        "retries": {k: sum(s["retries"][k] for s in full)
                    for k in full[0]["retries"]},
        "abandoned": sum(s["abandoned"] for s in full),
        "deadline_abandoned": dead,
        "rejected": rejected,
        "shed": shed,
        "degraded": sum(s["degraded"] for s in full),
        "detect_hedges": sum(s["detect_hedges"] for s in full),
        "unavailability": {"per_drive_s": per_drive,
                           "total_s": sum(per_drive)},
        "repair": {k: sum(s["repair"][k] for s in full)
                   for k in full[0]["repair"]},
        "goodput": goodput,
    }
    return out


__all__.append("merge_fault_stats")
