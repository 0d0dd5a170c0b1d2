"""Overload control & metastable-failure resilience for the cluster engine.

The fault layer (:mod:`repro_torch.core.faults`) lets the fleet survive
*failures*; this module defends it against *overload*.  Without it, every
arrival is admitted, queues are unbounded, and ``ExponentialBackoff``
re-dispatch can amplify a transient spike into a retry storm — the classic
metastable congestion collapse real serverless platforms prevent with
concurrency limits and throttling.  Four cooperating mechanisms, all value
objects the engine interprets (like the drive schedulers in
:mod:`repro_torch.core.tenancy`):

  * **Admission control** (applied at arrival time, before placement):
    :class:`AdmitAll` (unconditional baseline), :class:`TokenBucket`
    (deterministic refill, optionally per request class, with per-tenant
    shares proportional to tenant weight), or :class:`QueueThreshold`
    (reject when fleet queue depth per active server, or busy-server
    utilization, exceeds a threshold).
  * **SLA-aware load shedding** inside the drive/CPU queues
    (:class:`ShedPolicy`): bounded queue lengths with a drop-oldest or
    drop-incoming overflow victim, deadline-hopeless dispatch shedding
    (a copy that cannot meet its deadline even with zero further wait is
    dropped instead of served), and CoDel-style sojourn-time shedding
    (persistently above-target queueing delay sheds at dispatch).
  * **Backpressure** (:class:`Backpressure`): at control-epoch boundaries
    the engine derives a pushback factor in ``[min_factor, 1]`` from the
    live queue depth; arrivals are deterministically thinned by that
    factor (modeling client-side throttling) and the factor timeline is
    recorded so an :class:`ThrottledArrivals` wrapper can replay the
    throttling open-loop.  Retries consult the same admission gate, so
    backoff cannot storm a saturated fleet.
  * **Brownout degradation** (:class:`Brownout`): under sustained
    overload (queue depth above ``on_depth`` for ``min_epochs``
    consecutive control epochs) hedging is suspended — requests degrade
    to the cheaper single-copy path — until depth falls back below
    ``off_depth`` (hysteresis).

**Continuity rule**: every policy here is a *deterministic function of
engine state* — token-bucket refill, queue-depth thresholds, sojourn
times, the pushback accumulator.  No random draw is ever taken, so the
layer spawns no SeedSequence child at all, and a disabled layer
(``overload=None`` or a config with every mechanism off) is trivially
bit-identical to the golden traces.

Telemetry lands in :meth:`ClusterEngine.overload_stats`
(admitted/rejected/shed per class and tenant, the pushback timeline,
brownout epochs); sharded fallback runs merge per-shard books through
:func:`merge_overload_stats`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess

__all__ = ["AdmissionPolicy", "AdmitAll", "TokenBucket", "QueueThreshold",
           "ShedPolicy", "Backpressure", "Brownout", "OverloadControl",
           "ThrottledArrivals", "merge_overload_stats"]

#: Request classes the per-class books are keyed by, in index order.
CLASSES = ("accel", "plain")


# -- admission policies ------------------------------------------------------
@dataclass(frozen=True)
class AdmissionPolicy:
    """Base marker for arrival-time admission policies."""
    name = "admission"

    def validate(self) -> None:
        return None


@dataclass(frozen=True)
class AdmitAll(AdmissionPolicy):
    """Unconditional admission — the naive baseline every real platform
    starts from (and the collapse mode fig24 measures)."""
    name = "admit_all"


@dataclass(frozen=True)
class TokenBucket(AdmissionPolicy):
    """Deterministic token-bucket admission.

    The bucket starts full (``burst`` tokens) and refills continuously at
    ``rate`` tokens/second; each admitted request consumes one token and
    an arrival finding less than one token is rejected.  With
    ``per_class=True`` the acceleratable and plain classes meter through
    independent buckets (each with the full ``rate``/``burst``); on
    multi-tenant runs every tenant gets its own bucket scaled to its
    weight share (``rate * w_k / sum(w)``), so a greedy tenant exhausts
    only its own allocation.
    """
    name = "token_bucket"
    rate: float = 100.0                 # tokens (admissions) per second
    burst: float = 16.0                 # bucket capacity
    per_class: bool = False

    def validate(self) -> None:
        if self.rate <= 0.0:
            raise ValueError("TokenBucket.rate must be positive")
        if self.burst < 1.0:
            raise ValueError("TokenBucket.burst must be >= 1 (a smaller "
                             "bucket could never admit anything)")


@dataclass(frozen=True)
class QueueThreshold(AdmissionPolicy):
    """Reject arrivals when the fleet looks saturated.

    ``max_queue_per_server`` rejects while the live queued-request count
    per active server exceeds the threshold; ``max_utilization`` rejects
    while the busy-server fraction exceeds it.  Either may be ``None``
    (unused); both set means *either* trips rejection.
    """
    name = "queue_threshold"
    max_queue_per_server: Optional[float] = 4.0
    max_utilization: Optional[float] = None

    def validate(self) -> None:
        if self.max_queue_per_server is None and self.max_utilization is None:
            raise ValueError("QueueThreshold needs max_queue_per_server "
                             "and/or max_utilization")
        if self.max_queue_per_server is not None \
                and self.max_queue_per_server < 0.0:
            raise ValueError("max_queue_per_server must be >= 0")
        if self.max_utilization is not None \
                and not 0.0 < self.max_utilization <= 1.0:
            raise ValueError("max_utilization must be in (0, 1]")


# -- load shedding -----------------------------------------------------------
@dataclass(frozen=True)
class ShedPolicy:
    """SLA-aware shedding inside the drive/CPU queues.

    ``max_queue`` bounds every per-server queue's *live* depth; an
    arrival (or retry/hedge copy) finding the queue full sheds the
    oldest live queued copy to make room (``drop="oldest"``) or is
    itself dropped (``drop="incoming"``).  ``hopeless=True`` sheds, at
    dispatch time, any copy that cannot meet its ``timeout_s`` deadline
    even if served immediately (judged against the service-time floor —
    the deterministic component of the copy's service model), instead of
    burning a server on a request that is already lost.
    ``codel_target_s`` enables CoDel-style shedding: when the sojourn
    time (dispatch minus arrival) of dequeued copies stays above the
    target for a full ``codel_interval_s``, copies are shed at dispatch
    until sojourn falls back under the target.
    """
    max_queue: Optional[int] = None
    drop: str = "oldest"                # bounded-queue overflow victim
    hopeless: bool = False              # shed deadline-hopeless at dispatch
    codel_target_s: Optional[float] = None
    codel_interval_s: float = 0.1

    def validate(self) -> None:
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("ShedPolicy.max_queue must be >= 1")
        if self.drop not in ("oldest", "incoming"):
            raise ValueError("ShedPolicy.drop must be 'oldest' or "
                             "'incoming'")
        if self.codel_target_s is not None and self.codel_target_s <= 0.0:
            raise ValueError("codel_target_s must be positive")
        if self.codel_interval_s <= 0.0:
            raise ValueError("codel_interval_s must be positive")

    @property
    def enabled(self) -> bool:
        return (self.max_queue is not None or self.hopeless
                or self.codel_target_s is not None)


# -- backpressure ------------------------------------------------------------
@dataclass(frozen=True)
class Backpressure:
    """Per-epoch pushback to the arrival sources.

    At every control-epoch boundary the engine computes the live queued
    requests per active server, ``depth``, and sets the pushback factor

        ``f = clamp(target_depth / depth, min_factor, 1.0)``

    (``f = 1`` while ``depth <= target_depth``).  Arrivals in the next
    epoch are thinned deterministically to a fraction ``f`` (an
    accumulator admits every request while ``f = 1`` and exactly ``f`` of
    them otherwise — modeling clients honoring a throttle signal); the
    ``(t, f)`` timeline is recorded in ``overload_stats()`` and can be
    replayed open-loop through :class:`ThrottledArrivals`.
    """
    target_depth: float = 4.0           # live queued per active server
    min_factor: float = 0.05            # floor: never silence clients fully

    def validate(self) -> None:
        if self.target_depth <= 0.0:
            raise ValueError("Backpressure.target_depth must be positive")
        if not 0.0 < self.min_factor <= 1.0:
            raise ValueError("Backpressure.min_factor must be in (0, 1]")


# -- brownout ----------------------------------------------------------------
@dataclass(frozen=True)
class Brownout:
    """Sustained-overload degradation with hysteresis.

    Brownout engages after the live queue depth per active server has
    been at or above ``on_depth`` for ``min_epochs`` consecutive control
    epochs, and disengages once depth falls to or below ``off_depth``
    (which must be below ``on_depth``).  While engaged, hedging is
    suspended — requests run the cheaper single-copy path — shedding the
    duplicate-work amplification exactly when the fleet can least afford
    it.  (Failure-*detection* hedges from a
    :class:`~repro_torch.core.faults.FaultPlan` watchdog stay active: they
    rescue stuck requests rather than shave tails.)
    """
    on_depth: float = 8.0
    off_depth: float = 2.0
    min_epochs: int = 2

    def validate(self) -> None:
        if self.on_depth <= 0.0:
            raise ValueError("Brownout.on_depth must be positive")
        if not 0.0 <= self.off_depth < self.on_depth:
            raise ValueError("Brownout.off_depth must be in "
                             "[0, on_depth) for hysteresis")
        if self.min_epochs < 1:
            raise ValueError("Brownout.min_epochs must be >= 1")


# -- the composite config ----------------------------------------------------
@dataclass(frozen=True)
class OverloadControl:
    """The overload-control layer: any subset of the four mechanisms.

    ``epoch_s`` is the control period for backpressure/brownout
    evaluation (admission and shedding act per event, not per epoch).
    A config with every mechanism off (or ``overload=None``) keeps the
    classic bit-exact path — see the module docstring's continuity rule.
    """
    admission: Optional[AdmissionPolicy] = None
    shed: Optional[ShedPolicy] = None
    backpressure: Optional[Backpressure] = None
    brownout: Optional[Brownout] = None
    epoch_s: float = 0.25

    @property
    def enabled(self) -> bool:
        return (
            (self.admission is not None
             and not isinstance(self.admission, AdmitAll))
            or (self.shed is not None and self.shed.enabled)
            or self.backpressure is not None
            or self.brownout is not None)

    def validate(self) -> None:
        if self.epoch_s <= 0.0:
            raise ValueError("OverloadControl.epoch_s must be positive")
        if self.admission is not None:
            if not isinstance(self.admission, AdmissionPolicy):
                raise TypeError(f"unknown admission policy: "
                                f"{self.admission!r}")
            self.admission.validate()
        if self.shed is not None:
            self.shed.validate()
        if self.backpressure is not None:
            self.backpressure.validate()
        if self.brownout is not None:
            self.brownout.validate()


# -- open-loop pushback replay ----------------------------------------------
@dataclass(frozen=True)
class ThrottledArrivals(ArrivalProcess):
    """An :class:`ArrivalProcess` wrapper honoring a pushback timeline.

    ``timeline`` is a sequence of ``(t, factor)`` pairs (exactly what
    ``overload_stats()["pushback"]["timeline"]`` records): from time
    ``t`` on, clients emit only a ``factor`` fraction of the inner
    process's arrivals, thinned by the same deterministic accumulator
    the engine's closed-loop gate uses — so replaying a run's recorded
    timeline open-loop reproduces the engine's admitted-by-pushback
    stream.  Before the first breakpoint the factor is 1.0.
    """
    rate: float = -1.0
    inner: Optional[ArrivalProcess] = None
    timeline: Tuple[Tuple[float, float], ...] = ()

    def __post_init__(self) -> None:
        if self.inner is None:
            raise ValueError("ThrottledArrivals needs an inner process")
        tl = tuple((float(t), float(f)) for t, f in self.timeline)
        if any(t1 < t0 for (t0, _), (t1, _) in zip(tl, tl[1:])):
            raise ValueError("timeline breakpoints must be sorted by time")
        if any(not 0.0 <= f <= 1.0 for _, f in tl):
            raise ValueError("pushback factors must be in [0, 1]")
        object.__setattr__(self, "timeline", tl)
        if self.rate < 0.0:
            object.__setattr__(self, "rate", float(self.inner.rate))

    def times(self, duration_s: float,
              rng: np.random.Generator) -> np.ndarray:
        ts = self.inner.times(duration_s, rng)
        if not ts.size or not self.timeline:
            return ts
        keep = np.zeros(ts.size, dtype=bool)
        bps = self.timeline
        j = -1                          # active breakpoint (-1 = factor 1.0)
        acc = 0.0
        for i, t in enumerate(ts.tolist()):
            while j + 1 < len(bps) and bps[j + 1][0] <= t:
                j += 1
            f = bps[j][1] if j >= 0 else 1.0
            if f >= 1.0:
                keep[i] = True
                continue
            acc += f
            if acc >= 1.0:
                acc -= 1.0
                keep[i] = True
        return ts[keep]

    def with_rate(self, rate: float) -> "ArrivalProcess":
        return ThrottledArrivals(rate=rate,
                                 inner=self.inner.with_rate(rate),
                                 timeline=self.timeline)


# -- sharded merge -----------------------------------------------------------
def merge_overload_stats(states: Sequence[Optional[dict]]
                         ) -> Optional[dict]:
    """Merge per-shard ``overload_stats()`` dicts into one fleet view.

    Counters sum; the pushback timelines concatenate (tagged with the
    shard index, since each shard ran its own control loop); brownout
    epoch counts sum.  ``None`` in means that shard ran without the
    layer — all-``None`` merges to ``None``.
    """
    live = [s for s in states if s is not None]
    if not live:
        return None
    out = {
        "enabled": True,
        "admitted": sum(s["admitted"] for s in live),
        "rejected": sum(s["rejected"] for s in live),
        "shed": sum(s["shed"] for s in live),
        "copies_cancelled": sum(s["copies_cancelled"] for s in live),
        "rejected_by": {
            k: sum(s["rejected_by"][k] for s in live)
            for k in live[0]["rejected_by"]},
        "shed_by": {k: sum(s["shed_by"][k] for s in live)
                    for k in live[0]["shed_by"]},
        "per_class": {
            c: {k: sum(s["per_class"][c][k] for s in live)
                for k in live[0]["per_class"][c]}
            for c in live[0]["per_class"]},
        "per_tenant": None,
        "retries_denied": sum(s["retries_denied"] for s in live),
        "hedges_suppressed": sum(s["hedges_suppressed"] for s in live),
        "brownout": {
            "entered": sum(s["brownout"]["entered"] for s in live),
            "active_epochs": sum(s["brownout"]["active_epochs"]
                                 for s in live),
            "intervals": [iv for s in live
                          for iv in s["brownout"]["intervals"]],
        },
        "pushback": {
            "timeline": [(sh, t, f) for sh, s in enumerate(states)
                         if s is not None
                         for t, f in s["pushback"]["timeline"]],
            "final": min(s["pushback"]["final"] for s in live),
        },
        "epochs": sum(s["epochs"] for s in live),
    }
    offered = sum(s["goodput"]["offered"] for s in live)
    completed = sum(s["goodput"]["completed"] for s in live)
    out["goodput"] = {"offered": offered, "completed": completed,
                      "goodput_frac": completed / offered if offered else 0.0}
    return out
