"""Discrete-event cluster engine (§V scheduler, §VI-C straggler study).

A genuine event-driven simulator of the extended Kubernetes scheduler from
the paper, rearchitected (PR 2) for million-request runs.  The simulation
semantics are unchanged from the PR-1 engine — the golden-trace tests pin
a bit-identical ``RequestResult`` stream seed-for-seed against the frozen
reference in :mod:`repro_torch.core.engine_ref` — but the hot path is now
array-backed:

  * **batched event path** — per-request state lives in structure-of-arrays
    storage (numpy ``float64``/``int8`` arrays plus parallel Python lists
    for the per-event mutable codes), not per-request ``_Req``/``_Copy``
    objects.  Pipeline picks, acceleratability, placement hashes and
    service-quantile tail multipliers are pre-sampled in vectorized batches
    before/alongside the loop; the loop itself touches only plain tuples,
    ints and floats.
  * **streamed arrivals** — arrivals are consumed from the sorted arrival
    vector through an index cursor (materialized to Python floats in
    64K-request chunks), so the event heap holds only O(in-flight) events
    instead of O(total requests).  Hedge timers all share one constant
    budget, so they fire in arrival order and live in a FIFO deque rather
    than the heap — the heap holds only the finish events of currently
    running copies (at most one per server).  Ties between an arrival and
    a dynamic event break toward the arrival, exactly like the PR-1 global
    event sequence numbers did.
  * **O(1) queues** — each server's FCFS queue is a ``deque``; hedged-loser
    cancellation tombstones the copy in place (state flip) instead of an
    O(n) ``list.remove``, and the dispatch loop discards tombstones when
    they surface at the head.  A tombstoned copy is never started (asserted
    in the dispatch loop and counted in ``tombstones_discarded``).
  * **indexed CPU load heap** — the least-loaded CPU pick is a lazy
    ``(load, index)`` heap with stale-entry invalidation instead of an
    O(n_cpu) scan; ties still break toward the lowest node index.
  * **event model** — three event kinds, exactly as before:
      - ``arrival``  — a request enters (times from a pluggable
        :mod:`repro_torch.core.arrivals` process)
      - ``finish``   — a running copy completes service on its node
      - ``hedge``    — the hedge timer for a queued acceleratable request
        expires
  * **data-aware placement** — each acceleratable request's payload lands
    on the ``Acceleratable_Storage`` drive its key hashes to (the same
    SHA-1 spread :class:`repro_torch.core.placement.StoragePool` computes) and
    the request is dispatched to the drive that *holds* it.  Per-drive
    FCFS, run-to-completion, no DSA multi-tenancy (§V), with
    time-weighted queue-depth telemetry finalized to a common end-of-run
    horizon.
  * **real hedged dispatch** — if an acceleratable request is still queued
    ``hedge_budget_s`` after arrival, a second copy is issued on the
    least-loaded CPU node.  Both copies race; the first finisher wins and
    the loser is cancelled: a still-queued loser is tombstoned (consumes
    no service), while an already-running loser runs to completion
    occupying its node (run-to-completion — no preemption) and its result
    is discarded.  ``RequestResult`` records ``hedged``, ``winner`` and
    both finish times so tail-latency attribution (Fig. 16) is observable.

Every stochastic choice — pipeline sampling, service-time tails (drawn by
quantile inversion through ``LatencyModel.e2e(q=u)``) and the arrival
stream — derives from the single engine seed, so a run is exactly
reproducible and two engines with equal seeds emit identical
``RequestResult`` streams.  ``run()`` returns the historical
``List[RequestResult]``; ``run_soa()`` returns the native
:class:`EngineTrace` structure-of-arrays view (what
``benchmarks/bench_engine.py`` measures), and :class:`SampleBank` lets
repeated runs share one sampling pass (common random numbers for the
throughput binary search).

Autoscaling (PR 3): ``run_soa(..., controller=...)`` steps a control loop
at fixed epoch boundaries — the controller reads a :class:`FleetSnapshot`
of the engine's live queue/utilization telemetry and resizes the active
CPU subset and the powered drive set (powered-off drives wake with a
modeled ``dscs_wake_s`` latency).  ``power_stats()`` reports busy/powered
server-seconds for the energy/cost evaluation in
:mod:`repro_torch.core.autoscale`.  Without a controller every hook is inert and
the event stream stays bit-identical to the PR-2 engine.

Multi-tenant DSA sharing (PR 4): ``run_soa(tenants=[...], scheduler=...)``
runs several :class:`~repro_torch.core.tenancy.TenantSpec` streams — each with
its own pipeline mix, arrival process, SLA target and share weight —
through one fleet.  Arrival streams are multiplexed deterministically
(:class:`~repro_torch.core.arrivals.MergedArrivals`), every request carries its
tenant id through the SoA columns (``EngineTrace.tenant``), and the
drive-side scheduling policy is pluggable:

  * :class:`~repro_torch.core.tenancy.FCFSRunToCompletion` (default) — the
    paper's single-queue run-to-completion drives; with one default
    tenant this path is bit-identical to the classic engine (the
    golden-trace gates pin it).
  * :class:`~repro_torch.core.tenancy.WeightedTimeSlice` — weighted round-robin
    quanta per tenant with preempt/resume and a modeled DSA
    context-switch cost.
  * :class:`~repro_torch.core.tenancy.SpatialPartition` — per-tenant DSA lane
    groups (independent FCFS sub-servers, service inflated by the lane
    fraction).

Per-tenant telemetry (arrivals, completions, busy service-seconds,
time-weighted queue depths finalized to the common horizon) comes back
through :meth:`ClusterEngine.tenant_stats`, and :class:`FleetSnapshot`
exposes per-tenant live views so autoscaling policies can scale on the
worst-off tenant.  ``preempt_losers=True`` additionally cancels hedge
losers *in service* (the classic engine only discards never-started
tombstones), counting the reclaimed server-seconds in telemetry.

Tiered data layer (PR 5): ``ClusterEngine(tier=TierConfig(...))`` swaps
the memoized single-hash placement for cache-warmth- and load-aware
routing over each object's k-way replica set (``drive_l`` becomes the
replica-choice column), models per-drive DRAM caches (hits shave the
flash-P2P + NS-driver time off the service draw), lazily materializes
secondary replicas from a remote backing store, and lets a
:class:`~repro_torch.core.tiering.MigrationController` retarget Zipf-hot keys
off saturated drives at its own epoch boundaries.  Telemetry lands in
:meth:`ClusterEngine.tier_stats`.  A ``None``/disabled tier takes the
classic path — same rng spawns, no extra draws — so tier-off runs stay
bit-identical to the golden traces.  The tier composes with autoscaling
and with multi-tenant FCFS; time-sliced/partitioned DSAs raise.
"""
from __future__ import annotations

import hashlib
import heapq
import math
from array import array
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess, MergedArrivals
from repro_torch.core.faults import (CPU_CRASH, CPU_RECOVER, DRIVE_FAIL,
                               DRIVE_RECOVER, STALL_BEGIN, STALL_END,
                               FaultPlan)
from repro_torch.core.function import Pipeline, is_acceleratable
from repro_torch.core.latency import LatencyModel, _erfinv
from repro_torch.core.lindley import DEFAULT_BACKEND
from repro_torch.core.overload import AdmitAll, OverloadControl, QueueThreshold, \
    TokenBucket
from repro_torch.core.platforms import (CPU_FALLBACK_PLATFORM, DSCS_PLATFORM,
                                  PLATFORMS)
from repro_torch.core.tenancy import (FCFSRunToCompletion, SpatialPartition,
                                TenantSpec, WeightedTimeSlice, assign_lanes)
from repro_torch.core.tiering import (DriveCache, MigrationController, TierConfig,
                                _hrw_ranking, build_replica_table,
                                zipf_object_ids)
from repro_torch.core.workloads import Workload


@dataclass
class Telemetry:
    """Prometheus-analogue counters (shared with the scheduler façade)."""
    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    def inc(self, name: str, v: float = 1.0) -> None:
        """Add ``v`` to counter ``name`` (created at zero on first use)."""
        self.counters[name] += v

    def get(self, name: str) -> float:
        """Current value of counter ``name`` (zero if never incremented)."""
        return self.counters[name]


def _erfinv_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized Winitzki approximation — same formula as
    :func:`repro_torch.core.latency._erfinv`, batched through numpy."""
    a = 0.147
    ln = np.log(1.0 - x * x)
    t = 2.0 / (math.pi * a) + ln / 2.0
    return np.copysign(np.sqrt(np.sqrt(t * t - ln / a) - t), x)


class _ServiceSampler:
    """Chunked, vectorized service-time sampler by quantile inversion.

    ``LatencyModel.pipeline_breakdown`` at quantile ``q`` decomposes as
    ``A + R*Tr(q) + W*Tw(q)`` — a deterministic part plus the summed
    network-read/-write bases scaled by their shared lognormal quantile
    multipliers.  Solving that 3x3 system once per (workload, platform)
    turns every per-request draw into one fused multiply-add over
    pre-transformed tail multipliers.

    Uniform draws are taken from the engine rng in chunks of ``chunk`` and
    pushed through the erfinv/exp transform in one vectorized batch, then
    consumed one value per service start — the consumption *order* is the
    engine's event order, so two engines that process events identically
    draw identical values.  ``numpy``'s vectorized chunk draw consumes the
    PCG64 stream exactly like per-call scalar draws, and because both the
    optimized and the frozen reference engine share this sampler, their
    streams are bit-identical regardless of the host's libm/SIMD exp.

    Modeling note: a single uniform draw ``u`` drives every tail multiplier
    of a request comonotonically (all reads and writes are slow together),
    whereas the pre-engine scheduler sampled each network component
    independently.  The comonotone total has a somewhat fatter tail than
    the independent sum, so absolute p99/SLA numbers shift slightly versus
    the seed model; within-experiment comparisons (hedging on/off, arrival
    shapes, fleet ratios) are unaffected.
    """

    def __init__(self, lm: LatencyModel, chunk: int = 4096,
                 persistent: bool = False):
        self.lm = lm
        self.chunk = chunk
        self.persistent = persistent        # keep draws across start() calls
        self._coef: Dict[tuple, Tuple[float, float, float]] = {}
        self._rng: Optional[np.random.Generator] = None
        self._tr: List[float] = []
        self._tw: List[float] = []
        self._i = 0

    # -- coefficient fitting (deterministic, no rng) -------------------------
    def _tails(self, q: float) -> tuple:
        z = math.sqrt(2.0) * _erfinv(2.0 * q - 1.0)
        return (math.exp(self.lm.params.read_sigma * z),
                math.exp(self.lm.params.write_sigma * z))

    def coef(self, workload: Workload, platform: str) -> Tuple[float, float, float]:
        # service time depends only on (workload, platform); Workload is a
        # frozen dataclass, so this key is stable (unlike id()) and shared
        # across pipeline variants of the same workload
        key = (workload, platform)
        c = self._coef.get(key)
        if c is None:
            plat = PLATFORMS[platform]
            qs = (0.5, 0.84, 0.975)
            rows = [(1.0,) + self._tails(q) for q in qs]
            e2e = [self.lm.e2e(plat, workload, q=q) for q in qs]
            # lstsq, not solve: with read_sigma == write_sigma the Tr and Tw
            # columns coincide and the system is rank-2; the minimum-norm
            # solution still reproduces e2e(q) exactly
            sol = np.linalg.lstsq(np.array(rows), np.array(e2e), rcond=None)[0]
            c = (float(sol[0]), float(sol[1]), float(sol[2]))
            self._coef[key] = c
        return c

    # -- draw stream ---------------------------------------------------------
    def start(self, rng: np.random.Generator) -> None:
        """Bind the per-run rng and reset the draw cursor (persistent
        samplers keep their already-transformed draws)."""
        self._rng = rng
        self._i = 0
        if not self.persistent:
            self._tr = []
            self._tw = []

    def rewind(self) -> None:
        """Replay the cached draw stream from the top (common random
        numbers across runs)."""
        self._i = 0

    def _grow(self) -> None:
        u = self._rng.uniform(size=self.chunk)
        np.clip(u, 1e-4, 1.0 - 1e-4, out=u)
        z = math.sqrt(2.0) * _erfinv_vec(2.0 * u - 1.0)
        self._tr.extend(np.exp(self.lm.params.read_sigma * z).tolist())
        self._tw.extend(np.exp(self.lm.params.write_sigma * z).tolist())

    def draw(self, coef: Tuple[float, float, float]) -> float:
        """One service time: the next cached tail pair through the
        (workload, platform) coefficients."""
        i = self._i
        if i == len(self._tr):
            self._grow()
        self._i = i + 1
        return coef[0] + coef[1] * self._tr[i] + coef[2] * self._tw[i]


@dataclass(frozen=True)
class FleetSnapshot:
    """What an autoscaling controller sees at one epoch boundary.

    Built from the engine's own live telemetry — queue depths exclude
    tombstoned (cancelled-in-queue) copies, busy counts are servers with a
    copy in service, and ``arrivals``/``completions`` are deltas since the
    previous epoch.  ``n_cpu_active`` / ``n_dscs_on`` are the *powered*
    capacity the previous actions produced (waking drives count as on);
    ``n_cpu_total`` / ``n_dscs_total`` are the provisioned maxima the
    controller may scale within.
    """
    time: float                         # epoch boundary (simulated seconds)
    epoch: int                          # 1-based epoch index
    arrivals: int                       # arrivals since the previous epoch
    completions: int                    # requests completed since then
    dscs_queue: int                     # live queued DSCS copies, fleet-wide
    cpu_queue: int                      # live queued CPU copies, fleet-wide
    dscs_busy: int                      # drives with a copy in service
    cpu_busy: int                       # CPU nodes with a copy in service
    n_cpu_active: int                   # nodes eligible for new dispatch
    n_dscs_on: int                      # powered (on or waking) drives
    n_cpu_total: int
    n_dscs_total: int
    # per-tenant views (empty tuples on single-tenant runs): live queued
    # copies fleet-wide (both classes) and arrival/completion deltas since
    # the previous epoch, indexed by tenant — so a policy can scale on the
    # worst-off tenant instead of the fleet aggregate.
    tenant_queue: Tuple[int, ...] = ()
    tenant_arrivals: Tuple[int, ...] = ()
    tenant_completions: Tuple[int, ...] = ()
    # overload-control signals (zero/neutral without an OverloadControl):
    # arrivals rejected / requests shed since the previous epoch, and the
    # pushback factor currently applied to the arrival sources — so a
    # policy can scale out on rejection pressure before queues even grow.
    rejected: int = 0
    shed: int = 0
    pushback: float = 1.0


@dataclass
class RequestResult:
    """One completed request.  ``finish``/``accelerated`` describe the
    winning copy; for hedged requests both per-path finish times are kept
    (the loser's is back-filled when its run-to-completion copy drains, and
    stays ``None`` if it was cancelled while still queued)."""
    arrival: float
    finish: float
    accelerated: bool
    hedged: bool = False
    winner: str = ""                    # "dscs" | "cpu"
    drive: int = -1                     # serving DSCS drive index, -1 = CPU
    start: float = 0.0                  # winning copy's service start
    service: float = 0.0                # winning copy's service duration
    dscs_finish: Optional[float] = None
    cpu_finish: Optional[float] = None
    tenant: int = 0                     # owning tenant (0 on single-tenant)

    @property
    def latency(self) -> float:
        """End-to-end latency of the winning copy (finish - arrival)."""
        return self.finish - self.arrival

    @property
    def queue_wait(self) -> float:
        """Time the winning copy spent queued before service began."""
        return self.start - self.arrival


@dataclass
class EngineTrace:
    """Structure-of-arrays view of one run — the engine's native output.

    One slot per arrival, in arrival order.  ``winner`` is 0 for the DSCS
    path, 1 for the CPU path, -1 for requests abandoned by a fault-retry
    exhaustion or a ``timeout_s`` deadline (their ``finish`` is NaN);
    ``drive`` is the serving DSCS drive index or
    -1 for CPU-served requests; ``dscs_finish``/``cpu_finish`` are NaN
    where the path never completed (maps to ``None`` in
    :class:`RequestResult`).  ``to_results()`` materializes the historical
    object stream; large sweeps should consume the arrays directly.
    """
    arrival: np.ndarray                 # float64 arrival times
    finish: np.ndarray                  # float64 winning-copy finish
    winner: np.ndarray                  # int8: 0 = dscs, 1 = cpu
    drive: np.ndarray                   # int32 serving drive or -1
    start: np.ndarray                   # float64 winning-copy service start
    service: np.ndarray                 # float64 winning-copy service time
    hedged: np.ndarray                  # bool
    dscs_finish: np.ndarray             # float64, NaN = path never finished
    cpu_finish: np.ndarray              # float64, NaN = path never finished
    events: int = 0                     # events processed (incl. arrivals)
    tenant: Optional[np.ndarray] = None  # int32 tenant ids (zeros if 1-tenant)

    @property
    def n(self) -> int:
        """Number of requests in the trace (= arrivals simulated)."""
        return int(self.arrival.size)

    @property
    def latency(self) -> np.ndarray:
        """Per-request end-to-end latency vector (finish - arrival).
        NaN for requests abandoned by faults or deadlines."""
        return self.finish - self.arrival

    @property
    def completed(self) -> np.ndarray:
        """Boolean mask of requests that finished (fault/deadline
        abandonments have NaN finish and winner -1)."""
        return ~np.isnan(self.finish)

    def to_results(self) -> List[RequestResult]:
        isnan = math.isnan
        arr, fin = self.arrival.tolist(), self.finish.tolist()
        win, drv = self.winner.tolist(), self.drive.tolist()
        st, sv = self.start.tolist(), self.service.tolist()
        hg = self.hedged.tolist()
        df, cf = self.dscs_finish.tolist(), self.cpu_finish.tolist()
        tn = (self.tenant.tolist() if self.tenant is not None
              else [0] * len(arr))
        out = []
        for i in range(len(arr)):
            w = win[i]
            out.append(RequestResult(
                arrival=arr[i], finish=fin[i], accelerated=w == 0,
                hedged=hg[i],
                winner="dscs" if w == 0 else ("cpu" if w == 1 else ""),
                drive=drv[i], start=st[i], service=sv[i],
                dscs_finish=None if isnan(df[i]) else df[i],
                cpu_finish=None if isnan(cf[i]) else cf[i],
                tenant=tn[i]))
        return out


class SampleBank:
    """Common-random-numbers cache shared across engine runs.

    The throughput binary search probes the same fleet at many rates; with
    a bank, pipeline picks and service-tail draws are sampled once (grown
    on demand, never redrawn) and replayed by every probe, so the whole
    search costs one sampling pass and probes differ only through the
    offered load — the classic variance-reduction setup that also makes
    ``max_throughput`` monotone-friendly in fleet size.

    The bank draws from dedicated SeedSequence children (2, 3) of the
    engine seed, so banked runs are reproducible but statistically
    independent of the engine's own (0, 1) arrival/service streams.
    """

    def __init__(self, engine: "ClusterEngine", pipelines: Sequence[Pipeline]):
        kids = np.random.SeedSequence(engine.seed).spawn(4)
        self._pick_rng = np.random.default_rng(kids[2])
        self._n_pipes = len(pipelines)
        self._picks = np.empty(0, dtype=np.int64)
        self.tails = _ServiceSampler(engine.lm, persistent=True)
        self.tails.start(np.random.default_rng(kids[3]))

    def picks(self, n: int) -> np.ndarray:
        """The first ``n`` pipeline picks (a prefix of one fixed stream)."""
        if n > self._picks.size:
            grow = max(n - self._picks.size, self._picks.size, 1024)
            self._picks = np.concatenate(
                [self._picks, self._pick_rng.integers(self._n_pipes, size=grow)])
        return self._picks[:n]


# copy states (per path, per request).  _PREEMPTED marks a cancelled copy
# whose server was already freed (preemptive loser cancellation / dropped
# time-slice segment): any stale heap event for it is skipped on pop.
_FREE, _QUEUED, _RUNNING, _DONE, _CANCELLED, _PREEMPTED = 0, 1, 2, 3, 4, 5
_CHUNK = 1 << 16                        # arrival-streaming chunk

# Memoized data-aware placement: drive index for request id i is
# SHA-1("req-i") mod the Acceleratable_Storage drive count — exactly the
# spread StoragePool.place computes.  Placement is deterministic, so the
# table is shared by every run and throughput probe with the same fleet.
_PLACEMENT_CACHE: Dict[int, np.ndarray] = {}


def _placement(n_dscs: int, n: int) -> np.ndarray:
    arr = _PLACEMENT_CACHE.get(n_dscs)
    if arr is None or arr.size < n:
        start = 0 if arr is None else int(arr.size)
        size = max(n, 2 * start, 1024)
        sha1 = hashlib.sha1
        grown = np.empty(size, dtype=np.int32)
        if start:
            grown[:start] = arr
        nd = np.uint64(n_dscs)
        # digests are joined and Horner-reduced in bounded chunks so the
        # transient digest buffer stays a few MB at any request count;
        # acc < n_dscs <= 2^31 keeps the uint64 intermediate
        # (acc << 32) + word exact, so the result is bit-identical to
        # int.from_bytes(digest, "big") % n_dscs
        for c0 in range(start, size, _CHUNK):
            c1 = min(c0 + _CHUNK, size)
            buf = b"".join([sha1(b"req-%d" % i).digest()
                            for i in range(c0, c1)])
            words = np.frombuffer(buf, dtype=">u4").reshape(-1, 5) \
                .astype(np.uint64)
            acc = words[:, 0] % nd
            for j in range(1, 5):
                acc = ((acc << np.uint64(32)) + words[:, j]) % nd
            grown[c0:c1] = acc
        _PLACEMENT_CACHE[n_dscs] = arr = grown
    return arr[:n]


class ClusterEngine:
    """The discrete-event fleet: ``n_dscs`` DSCS drives with per-drive FCFS
    queues + ``n_cpu`` CPU fallback nodes, fed by an arrival process."""

    def __init__(self, *, n_dscs: int, n_cpu: int,
                 latency_model: Optional[LatencyModel] = None,
                 hedge_budget_s: Optional[float] = None, seed: int = 0,
                 n_plain: int = 64,
                 telemetry: Optional[Telemetry] = None,
                 dscs_wake_s: float = 0.2,
                 preempt_losers: bool = False,
                 tier: Optional[TierConfig] = None,
                 faults: Optional[FaultPlan] = None,
                 overload: Optional[OverloadControl] = None):
        if n_cpu <= 0:
            raise ValueError("the fleet needs at least one CPU fallback node")
        self.n_dscs = n_dscs
        self.n_cpu = n_cpu
        self.n_plain = n_plain
        self.lm = latency_model or LatencyModel(seed=seed)
        self.hedge_budget_s = hedge_budget_s
        self.seed = seed
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.dscs_wake_s = dscs_wake_s  # powered-off drive wake-up latency
        # preemptive loser cancellation: when True, a hedge loser caught
        # *in service* is cancelled immediately (its server is freed and
        # the reclaimed service-seconds are counted in telemetry) instead
        # of draining run-to-completion.  Default False = the paper's §V
        # run-to-completion semantics (golden-trace gated).
        self.preempt_losers = preempt_losers
        # tiered data layer (tiering.py): per-drive DRAM caches, k-way
        # replica routing, lazy backing-store fills and hot-key migration.
        # None or a disabled config keeps the classic bit-exact path.
        self.tier = tier
        if tier is not None:
            tier.validate()
        # fault injection & recovery (faults.py): seeded drive/CPU failure
        # processes, retry-with-backoff re-dispatch, replica repair and
        # timeout-based failure detection.  None keeps the classic
        # bit-exact path (no extra SeedSequence child is even spawned).
        self.faults = faults
        if faults is not None:
            faults.validate()
        # overload control (overload.py): admission, queue shedding,
        # backpressure and brownout.  Every policy is a deterministic
        # function of engine state — the layer draws no randomness, spawns
        # no SeedSequence child, and None (or a config with every
        # mechanism off) keeps the classic bit-exact path.
        self.overload = overload
        if overload is not None:
            overload.validate()
        self._sampler = _ServiceSampler(self.lm)
        self._qstate: Optional[dict] = None
        self.last_shard_stats: Optional[dict] = None
        self._pstate: Optional[dict] = None
        self._tstate: Optional[dict] = None
        self._tierstate: Optional[dict] = None
        self._fstate: Optional[dict] = None
        self._ovstate: Optional[dict] = None

    def sample_bank(self, pipelines: Sequence[Pipeline]) -> SampleBank:
        """A :class:`SampleBank` for common-random-number runs."""
        return SampleBank(self, pipelines)

    # -- public API ----------------------------------------------------------
    def run(self, pipelines: List[Pipeline], *, arrivals: ArrivalProcess,
            duration_s: float,
            timeout_s: Optional[float] = None) -> List[RequestResult]:
        """Simulate ``duration_s`` of offered load and drain every request;
        returns one ``RequestResult`` per arrival, in arrival order."""
        return self.run_soa(pipelines, arrivals=arrivals,
                            duration_s=duration_s,
                            timeout_s=timeout_s).to_results()

    def run_soa(self, pipelines: Optional[Sequence[Pipeline]] = None, *,
                arrivals: Optional[ArrivalProcess] = None,
                duration_s: float = 0.0,
                times: Optional[np.ndarray] = None,
                bank: Optional[SampleBank] = None,
                controller=None,
                tenants: Optional[Sequence[TenantSpec]] = None,
                scheduler=None,
                timeout_s: Optional[float] = None,
                overload: Optional[OverloadControl] = None) -> EngineTrace:
        """The batched event loop; returns the run as an
        :class:`EngineTrace`.

        ``times`` (a sorted arrival-time vector) overrides ``arrivals``;
        ``bank`` replays pre-sampled picks/service draws instead of the
        engine's own seed-derived streams (common random numbers).

        ``controller`` attaches an autoscaling control loop (see
        :mod:`repro_torch.core.autoscale`): an object with an ``epoch_s`` period
        and an ``observe(snapshot) -> action`` method.  At every epoch
        boundary the engine hands it a :class:`FleetSnapshot` and applies
        the returned action — resizing the *active* CPU subset (deactivated
        nodes drain run-to-completion, then power off) and powering DSCS
        drives up/down (a powered-off drive woken by an arrival, or
        proactively by the controller, serves only after ``dscs_wake_s``).
        Epoch boundaries fire before same-time dynamic events but after
        same-time arrivals, and stop once the fleet has fully drained.
        With ``controller=None`` none of this machinery runs and the event
        stream is bit-identical to the pre-autoscaling engine (the
        golden-trace gates pin this).

        ``tenants`` switches the run to multi-tenant mode: each
        :class:`~repro_torch.core.tenancy.TenantSpec` brings its own pipeline
        mix and arrival process (multiplexed deterministically, each
        stream drawn from its own child generator), and every request
        carries its tenant id (``EngineTrace.tenant``).  ``scheduler``
        picks how drives share their DSA between tenants —
        :class:`~repro_torch.core.tenancy.FCFSRunToCompletion` (default, and
        with one tenant bit-identical to the classic path),
        :class:`~repro_torch.core.tenancy.WeightedTimeSlice` (weighted quanta,
        preempt/resume, modeled context-switch cost; a preempted copy's
        ``start``/``service`` record its first service start and total
        service demand, so ``finish > start + service`` when segments are
        interleaved), or :class:`~repro_torch.core.tenancy.SpatialPartition`
        (per-tenant lane groups with proportionally inflated service).
        Per-tenant telemetry lands in :meth:`tenant_stats`.  The CPU
        fallback pool stays least-loaded/FCFS in every mode.

        ``overload`` attaches the overload-control layer
        (:class:`~repro_torch.core.overload.OverloadControl`: admission control,
        queue shedding, backpressure, brownout), overriding the engine-
        level config for this run; telemetry lands in
        :meth:`overload_stats`.  The layer is rng-free — ``None`` or a
        fully-disabled config keeps the classic bit-exact event stream.
        """
        mt = tenants is not None
        sk = 0                          # 0 fcfs | 1 timeslice | 2 spatial
        sched = scheduler
        if not mt:
            if scheduler is not None:
                raise ValueError("scheduler= requires tenants= (single-"
                                 "tenant runs always use per-drive FCFS)")
            if pipelines is None:
                raise ValueError("pass pipelines= (or tenants=)")
        else:
            tenants = list(tenants)
            if not tenants:
                raise ValueError("tenants= must name at least one tenant")
            if pipelines is not None:
                raise ValueError("with tenants=, pipelines come from each "
                                 "TenantSpec's mix; drop the pipelines "
                                 "argument")
            if times is not None or arrivals is not None:
                raise ValueError("with tenants=, arrivals come from each "
                                 "TenantSpec; pass neither times= nor "
                                 "arrivals=")
            if bank is not None:
                raise ValueError("SampleBank CRN replay is single-tenant "
                                 "only")
            if duration_s <= 0.0:
                raise ValueError("tenants= needs a positive duration_s")
            if sched is None:
                sched = FCFSRunToCompletion()
            if isinstance(sched, WeightedTimeSlice):
                sk = 1
            elif isinstance(sched, SpatialPartition):
                sk = 2
            elif isinstance(sched, FCFSRunToCompletion):
                sk = 0
            else:
                raise TypeError(f"unknown drive scheduler: {sched!r}")
            if controller is not None and sk != 0:
                raise NotImplementedError(
                    "autoscaling composes with the FCFS drive scheduler "
                    "only; time-sliced/partitioned DSAs with power "
                    "cycling are future work")

        tier = self.tier
        tier_on = tier is not None and tier.enabled
        if tier_on:
            if sk != 0:
                raise NotImplementedError(
                    "the tiered data layer composes with the FCFS drive "
                    "scheduler only; cache/replica routing under time-"
                    "sliced or partitioned DSAs is future work")
            if self.n_dscs < 1:
                raise ValueError("the tiered data layer needs n_dscs >= 1")
        self._tierstate = None
        self._fstate = None
        self._ovstate = None

        fp = self.faults
        fa = fp is not None
        if fa and mt:
            raise NotImplementedError(
                "fault injection composes with single-tenant runs only; "
                "lost-copy accounting under multi-tenant schedulers is "
                "future work")
        if timeout_s is not None:
            if timeout_s <= 0.0:
                raise ValueError("timeout_s must be positive")
            if mt:
                raise NotImplementedError(
                    "timeout_s deadlines compose with single-tenant "
                    "runs only")

        # overload control: a run_soa override falls back to the engine-
        # level config (like tier/faults).  Enabled means at least one of
        # admission / shedding / backpressure / brownout is active; the
        # layer is rng-free, so no SeedSequence child is spawned either way
        ov = overload if overload is not None else self.overload
        ov_on = ov is not None and ov.enabled
        if ov_on:
            ov.validate()
            if sk != 0:
                raise NotImplementedError(
                    "overload control composes with the FCFS drive "
                    "scheduler only; queue shedding under time-sliced or "
                    "partitioned DSAs is future work")

        ss = np.random.SeedSequence(self.seed)
        # SeedSequence children are keyed by index, so earlier children are
        # identical regardless of how many later ones (tier, faults) are
        # spawned — fault-free tier-off runs keep the exact golden-trace
        # streams
        kids = ss.spawn(4 if fa else (3 if tier_on else 2))
        arr_rng, rng = (np.random.default_rng(s) for s in kids[:2])
        tier_rng = np.random.default_rng(kids[2]) if tier_on else None
        frng = np.random.default_rng(kids[3]) if fa else None
        src: Optional[np.ndarray] = None
        if mt:
            merged = MergedArrivals(
                processes=tuple(t.arrivals for t in tenants))
            times, src = merged.times_and_sources(duration_s, arr_rng)
        elif times is None:
            if arrivals is None:
                raise ValueError("pass arrivals= or times=")
            if duration_s <= 0.0:
                raise ValueError("arrivals= needs a positive duration_s "
                                 "(an empty window would silently simulate "
                                 "zero requests)")
            times = arrivals.times(duration_s, arr_rng)
        times = np.ascontiguousarray(np.asarray(times, dtype=np.float64))
        n = int(times.size)

        if mt:
            # the combined pipeline list concatenates each tenant's mix;
            # per-request picks index the owning tenant's slice (drawn in
            # tenant order, so the stream is deterministic per seed)
            pipelines = [p for t in tenants for p in t.pipelines]
            picks = np.empty(n, dtype=np.int64)
            off = 0
            for k, ten in enumerate(tenants):
                mask = src == k
                picks[mask] = off + rng.integers(
                    len(ten.pipelines), size=int(np.count_nonzero(mask)))
                off += len(ten.pipelines)
            sampler = self._sampler
            sampler.start(rng)
        elif bank is not None:
            picks = bank.picks(n)
            sampler = bank.tails
            sampler.rewind()
        else:
            picks = (rng.integers(len(pipelines), size=n) if n
                     else np.empty(0, dtype=np.int64))
            sampler = self._sampler
            sampler.start(rng)

        # -- vectorized pre-sampling ----------------------------------------
        nd, nc = self.n_dscs, self.n_cpu
        coef_d = [sampler.coef(p.workload, DSCS_PLATFORM) for p in pipelines]
        coef_c = [sampler.coef(p.workload, CPU_FALLBACK_PLATFORM)
                  for p in pipelines]
        accel_pipe = np.array(
            [nd > 0 and is_acceleratable(p) for p in pipelines], dtype=bool)
        picks_l = picks.tolist()
        accel_l = (accel_pipe[picks].tolist() if n else [])
        if nd and n and not tier_on:
            drive_l = _placement(nd, n).tolist()
        else:
            # tier on: drive_l is the replica-choice column, written at
            # arrival time by the replica router below (-1 until routed)
            drive_l = [-1] * n

        # -- per-request SoA state ------------------------------------------
        ds_l = [0] * n                  # DSCS-copy state codes
        cs_l = [0] * n                  # CPU-copy state codes
        c_node_l = [-1] * n
        hedged_l = [False] * n
        winner_l = [-1] * n
        nan = math.nan
        finish_a = array("d", [nan]) * n
        dfin_a = array("d", [nan]) * n
        cfin_a = array("d", [nan]) * n
        d_start_a = array("d", bytes(8 * n))
        d_svc_a = array("d", bytes(8 * n))
        c_start_a = array("d", bytes(8 * n))
        c_svc_a = array("d", bytes(8 * n))

        # -- per-server state ------------------------------------------------
        d_queues = [deque() for _ in range(nd)]
        c_queues = [deque() for _ in range(nc)]
        d_busy = [0] * nd; c_busy = [0] * nc
        d_qd = [0] * nd; c_qd = [0] * nc        # live queued (no tombstones)
        d_area = [0.0] * nd; c_area = [0.0] * nc
        d_last = [0.0] * nd; c_last = [0.0] * nc
        d_maxd = [0] * nd; c_maxd = [0] * nc
        c_load = [0] * nc
        loadheap = [(0, i) for i in range(nc)]  # sorted => already a heap

        hpush, hpop = heapq.heappush, heapq.heappop
        INF = math.inf
        NAN = math.nan
        hedge = self.hedge_budget_s
        heap: List[tuple] = []          # (time, (rid << 1) | path), or
                                        # (time, -(drive + 1)) wake events
        hedge_dq: deque = deque()       # (time, rid): FIFO, arrival order
        end_t = 0.0                     # time of the last completion
        # the sampler's chunked draw stream, inlined: _grow() extends the
        # tr/tw lists in place, so these aliases stay valid across refills
        s_tr = sampler._tr; s_tw = sampler._tw
        s_grow = sampler._grow
        s_i = sampler._i
        # telemetry accumulators (flushed once at the end)
        t_ddisp = t_cdisp = t_hedge = 0
        t_won_d = t_won_c = t_srv_d = t_srv_c = 0
        t_can_q = t_can_s = t_tomb = 0
        d_busy_s = c_busy_s = 0.0       # service-seconds per class
        preempt = self.preempt_losers
        rec_d = rec_c = 0.0             # reclaimed service-seconds per class
        t_switch_s = 0.0                # time-slice context-switch overhead
        t_pre = 0                       # quantum-expiry events processed

        # -- tiered data-layer state (tiering.py) ----------------------------
        # Replica routing replaces the memoized single-hash placement:
        # drive_l becomes the replica-choice column of the SoA state,
        # written per arrival from the object's replica set.
        t_fill = 0                      # backing-store fetches (lazy fills)
        fill_s = 0.0                    # backing-fetch seconds added
        mig = None
        mig_t = INF                     # next migration epoch boundary
        if tier_on:
            t_k = min(tier.replication_k, nd)
            t_nobj = tier.n_objects
            t_objbytes = tier.object_bytes
            rb = [p.workload.request_bytes for p in pipelines]
            if t_nobj:
                obj_l = zipf_object_ids(n, t_nobj, tier.zipf_s,
                                        tier_rng).tolist()
                replicas = build_replica_table(t_nobj, nd, t_k)
            else:
                # one unique object per request: replica sets computed
                # lazily at arrival (object id = request id)
                obj_l = None
                replicas = {}
            # primary copies are durably materialized up front; secondary
            # and migrated-to drives fill lazily from the backing store
            mat = [set() for _ in range(nd)]
            if t_nobj:
                for o2, r2 in enumerate(replicas):
                    mat[r2[0]].add(o2)
            caches = ([DriveCache(tier.cache_bytes, tier.admit_after)
                       for _ in range(nd)]
                      if tier.cache_bytes > 0 else None)
            if tier.migration is not None:
                mig = MigrationController(tier.migration)
                mig_s = tier.migration.epoch_s
                mig_t = mig_s
                acc = [dict() for _ in range(nd)]  # per-drive obj hits/epoch

        # -- per-tenant state (multi-tenant runs only) -----------------------
        if mt:
            K = len(tenants)
            ten_l = src.tolist()
            tarr = [0] * K              # arrivals per tenant
            tdone = [0] * K             # completions per tenant
            tb_d = [0.0] * K            # DSA service-seconds per tenant
            tb_c = [0.0] * K            # CPU service-seconds per tenant
            # fleet-wide per-tenant live queue depth, time-weighted per
            # class (finalized to the common end-of-run horizon)
            tqa_d = [0.0] * K; tqa_c = [0.0] * K
            tqd_d = [0] * K; tqd_c = [0] * K
            tql_d = [0.0] * K; tql_c = [0.0] * K
            tqm_d = [0] * K; tqm_c = [0] * K

            def tacct_d(k: int, t: float, delta: int) -> None:
                tqa_d[k] += tqd_d[k] * (t - tql_d[k]); tql_d[k] = t
                v = tqd_d[k] + delta; tqd_d[k] = v
                if v > tqm_d[k]: tqm_d[k] = v

            def tacct_c(k: int, t: float, delta: int) -> None:
                tqa_c[k] += tqd_c[k] * (t - tql_c[k]); tql_c[k] = t
                v = tqd_c[k] + delta; tqd_c[k] = v
                if v > tqm_c[k]: tqm_c[k] = v
        else:
            ten_l = None

        # -- drive-scheduler state (non-FCFS modes) --------------------------
        if sk == 1:
            # weighted time-slicing: per-drive per-tenant FIFO queues, a
            # rotation cursor, the last tenant whose context is loaded on
            # the DSA, and per-request remaining service (-1 = not started)
            d_tq = [[deque() for _ in range(K)] for _ in range(nd)]
            d_cur = [-1] * nd
            d_rr = [0] * nd
            d_lastten = [-1] * nd
            rem_l = [-1.0] * n
            ts_q = [sched.quantum_s * t.weight for t in tenants]
            ts_switch = sched.switch_s
        elif sk == 2:
            # spatial partitioning: per (drive, tenant) lane-group FCFS
            # sub-servers; service inflated by total/assigned lanes
            lanes_total = sched.lanes or K
            lane_of = assign_lanes([t.weight for t in tenants], lanes_total)
            sp_scale = [lanes_total / l for l in lane_of]
            sp_q = [[deque() for _ in range(K)] for _ in range(nd)]
            sp_busy = [[0] * K for _ in range(nd)]

        # -- autoscaling state (inert without a controller) ------------------
        # The CPU pool scales by (de)activating a subset of the provisioned
        # nc nodes: inactive nodes take no new dispatch, drain what they
        # hold run-to-completion, then power off.  Drives power-cycle:
        # d_power is 1 (on) / 2 (waking) / 0 (off); an arrival for an off
        # drive starts a wake (the drive holds its queue, marked busy, and
        # a wake event fires dscs_wake_s later).  Powered-seconds per class
        # accumulate on power-off and finalize to the end-of-run horizon.
        dyn = controller is not None
        c_active = [True] * nc
        n_c_active = nc
        d_power = [1] * nd
        n_d_on = nd
        t_wake = ep_idx = 0
        if dyn:
            ep_s = float(controller.epoch_s)
            if ep_s <= 0.0:
                raise ValueError("controller.epoch_s must be positive")
            ep_t = ep_s
            wake_s = self.dscs_wake_s
            n_waking = 0                # drives held busy by a pending wake
            c_on_since = [0.0] * nc     # -1.0 once powered off
            d_on_since = [0.0] * nd
            # completed power-on intervals; kept as (start, stop) pairs so
            # finalization can clip them to the end-of-run horizon (stale
            # hedge timers / wake events let epochs fire past the last
            # completion, and power-offs there must not inflate powered_s)
            c_on_ivals: List[Tuple[float, float]] = []
            d_on_ivals: List[Tuple[float, float]] = []
            ep_last_ai = ep_last_done = 0
            ep_last_rej = ep_last_shed = 0
            if mt:
                ep_last_ta = [0] * K
                ep_last_tc = [0] * K
        else:
            ep_t = INF

        # -- fault-injection & deadline state (faults.py; inert without a
        # plan / timeout).  The expanded timeline is consumed through a
        # cursor like the arrival stream; retry timers reuse the
        # -(nd+1+rid) heap code range (mutually exclusive with time-slice
        # quanta: faults force the single-tenant FCFS path) and repair
        # completions use the constant code -(nd+1+n).
        if fa:
            horizon = (duration_s if duration_s > 0.0
                       else (float(times[-1]) if n else 0.0))
            ftl = fp.timeline(nd, nc, horizon, frng)
            fn = len(ftl)
            d_alive = [True] * nd
            c_alive = [True] * nc
            n_alive_active = nc         # alive AND active CPU nodes
            d_stall = [1.0] * nd        # live slowdown factor per drive
            d_run = [-1] * nd           # running request per drive
            c_run = [-1] * nc           # running request per CPU node
            att_l = [0] * n             # losses so far per request
            prevdel_l = [0.0] * n       # previous granted retry delay
            degr = {}                   # rid -> degraded-path fetch extra
            d_down_since = [-1.0] * nd
            d_down_s = [0.0] * nd
            rp = fp.retry
            rbud = fp.retry_budget
            det_s = fp.detect_timeout_s
            bf_p = fp.backing_fail_p
            bf_retry = fp.backing_retry_s
            lm_bf2 = self.lm.backing_fetch
            f_rb = [p.workload.request_bytes for p in pipelines]
            rb_granted = 0
            f_inj = [0] * 6             # timeline events applied, per kind
            f_cpu_skip = f_back_fail = 0
            f_lost = f_retry_sched = f_redisp = f_budget_deny = 0
            f_aband = f_degraded = f_detect = 0
            repair_on = (fp.repair is not None and tier_on and t_nobj > 0)
            if repair_on:
                rep_bw = fp.repair.bandwidth_bps
                rep_objbytes = (t_objbytes if t_objbytes
                                else sum(f_rb) / len(f_rb))
                rep_until = 0.0         # when the serialized pipe frees up
                rep_pending: deque = deque()
            rep_bytes = rep_s = 0.0
            rep_jobs = rep_objs = 0
        else:
            fn = 0
            ftl = ()
            det_s = None
        fi = 0
        dead_l = (bytearray(n) if (fa or timeout_s is not None or ov_on)
                  else None)
        t_dead = 0                      # deadline abandonments
        x_ev = 0                        # fault/retry/repair/deadline events
        dl_dq: deque = deque()          # (deadline, rid): FIFO, const offset
        det_dq: deque = deque()         # (detect time, rid): FIFO likewise

        # -- overload-control state (overload.py; inert without a config).
        # Every mechanism is a deterministic function of engine state —
        # token-bucket refill, queue-depth thresholds, head-age CoDel, the
        # pushback accumulator — so no random draw is taken and the
        # seed-derived streams never shift with the layer on or off.
        ov_admitted = ov_rej = ov_rej_push = ov_rej_adm = 0
        ov_shed = ov_cc = ov_retry_deny = ov_hedge_sup = 0
        ov_epochs = bro_entered = bro_ep_act = 0
        push_f = 1.0                    # current pushback factor
        bro_active = False              # brownout engaged
        ov_t = INF                      # next overload control epoch
        ov_gate_on = False              # arrival/retry admission gate live
        ov_maxq = None                  # bounded-queue shed threshold
        ov_incoming = False             # overflow victim: incoming copy
        ov_disp = False                 # dispatch-time sheds (hopeless/CoDel)
        if ov_on:
            adm = ov.admission
            if isinstance(adm, AdmitAll):
                adm = None              # the unconditional baseline
            shp = (ov.shed if (ov.shed is not None and ov.shed.enabled)
                   else None)
            bp = ov.backpressure
            bro = ov.brownout
            ov_ep_s = ov.epoch_s
            if bp is not None or bro is not None:
                ov_t = ov_ep_s          # epochs only drive those two
            ov_gate_on = adm is not None or bp is not None
            ov_adm_cls = [0, 0]; ov_rej_cls = [0, 0]; ov_shed_cls = [0, 0]
            ov_shed_by = [0, 0, 0]      # bounded / hopeless / codel
            push_acc = 0.0              # deterministic thinning accumulator
            push_tl: List[Tuple[float, float]] = []
            bro_above = 0               # consecutive epochs above on_depth
            bro_since = 0.0
            bro_ivals: List[Tuple[float, float]] = []
            K_ov = K if mt else 1
            if mt:
                ov_ten_adm = [0] * K; ov_ten_rej = [0] * K
                ov_ten_shed = [0] * K
            tb_on = isinstance(adm, TokenBucket)
            if tb_on:
                # buckets flattened [class][tenant], accel rows first; a
                # tenant's bucket is sized to its weight share so a greedy
                # tenant exhausts only its own allocation
                n_cls = 2 if adm.per_class else 1
                if mt:
                    wsum = sum(t2.weight for t2 in tenants)
                    shares = [t2.weight / wsum for t2 in tenants]
                else:
                    shares = [1.0]
                tb_rate = [adm.rate * s2 for s2 in shares] * n_cls
                tb_cap = [max(1.0, adm.burst * s2)
                          for s2 in shares] * n_cls
                tb_tok = list(tb_cap)   # buckets start full
                tb_last = [0.0] * (n_cls * K_ov)
            qt_on = isinstance(adm, QueueThreshold)
            if shp is not None:
                ov_maxq = shp.max_queue
                ov_incoming = shp.drop == "incoming"
                shp_hope = shp.hopeless and timeout_s is not None
                codel_t = shp.codel_target_s
                codel_i = shp.codel_interval_s
                ov_disp = shp_hope or codel_t is not None
                if codel_t is not None:
                    # per-server time the head age first exceeded target
                    codel_d = [-1.0] * nd
                    codel_c = [-1.0] * nc

            def ov_admit(rid2: int, t2: float) -> int:
                """The arrival/retry admission gate: 0 admit, 1 rejected
                by pushback (client-side throttling), 2 rejected by the
                admission policy."""
                nonlocal push_acc
                if push_f < 1.0:
                    # thin to exactly push_f of offered arrivals: the
                    # accumulator passes a request each time it crosses 1
                    push_acc += push_f
                    if push_acc >= 1.0:
                        push_acc -= 1.0
                    else:
                        return 1
                if tb_on:
                    idx = ((ten_l[rid2] if mt else 0)
                           + (0 if (n_cls == 1 or accel_l[rid2])
                              else K_ov))
                    tok = tb_tok[idx] + (t2 - tb_last[idx]) * tb_rate[idx]
                    cap = tb_cap[idx]
                    if tok > cap:
                        tok = cap
                    tb_last[idx] = t2
                    if tok >= 1.0:
                        tb_tok[idx] = tok - 1.0
                        return 0
                    tb_tok[idx] = tok
                    return 2
                if qt_on:
                    active = n_d_on + n_c_active
                    if active <= 0:
                        return 2
                    mq = adm.max_queue_per_server
                    if mq is not None and \
                            sum(d_qd) + sum(c_qd) > mq * active:
                        return 2
                    mu = adm.max_utilization
                    if mu is not None:
                        busy = sum(d_busy) + sum(c_busy)
                        if dyn:
                            busy -= n_waking
                        if busy > mu * active:
                            return 2
                return 0

            def ov_after_cancel(r2: int, t2: float, was_cpu: bool,
                                reason: int) -> None:
                """A queued copy was just shed (state already flipped to
                ``_CANCELLED`` and its queue accounting settled): when a
                sibling copy is still racing, only the copy dies; else the
                request itself is shed."""
                nonlocal ov_shed, ov_cc, end_t
                sib = ds_l[r2] if was_cpu else cs_l[r2]
                if sib == _QUEUED or sib == _RUNNING \
                        or winner_l[r2] >= 0 or dead_l[r2]:
                    ov_cc += 1
                    return
                dead_l[r2] = 1
                ov_shed += 1
                ov_shed_by[reason] += 1
                ov_shed_cls[0 if accel_l[r2] else 1] += 1
                if mt:
                    ov_ten_shed[ten_l[r2]] += 1
                if t2 > end_t:
                    end_t = t2

            def ov_drop_incoming(r2: int, t2: float) -> None:
                """Bounded-queue overflow with ``drop="incoming"``: the
                arriving/retried copy is never enqueued and the request is
                shed on the spot (callers rule out racing siblings)."""
                nonlocal ov_shed, end_t
                dead_l[r2] = 1
                ov_shed += 1
                ov_shed_by[0] += 1
                ov_shed_cls[0 if accel_l[r2] else 1] += 1
                if mt:
                    ov_ten_shed[ten_l[r2]] += 1
                if t2 > end_t:
                    end_t = t2

            def ov_evict_drive(d2: int, t2: float) -> None:
                """Shed the oldest live queued copy on drive ``d2`` to
                make room (``drop="oldest"`` overflow)."""
                nonlocal t_tomb
                dq2 = d_queues[d2]
                while dq2:
                    v = dq2.popleft()
                    if ds_l[v] == _CANCELLED:
                        t_tomb += 1
                        continue
                    d_area[d2] += d_qd[d2] * (t2 - d_last[d2])
                    d_last[d2] = t2
                    d_qd[d2] -= 1
                    ds_l[v] = _CANCELLED
                    if mt:
                        tacct_d(ten_l[v], t2, -1)
                    ov_after_cancel(v, t2, False, 0)
                    return

            def ov_evict_cpu(node2: int, t2: float) -> None:
                nonlocal t_tomb
                cq2 = c_queues[node2]
                while cq2:
                    v = cq2.popleft()
                    if cs_l[v] == _CANCELLED:
                        t_tomb += 1
                        continue
                    c_area[node2] += c_qd[node2] * (t2 - c_last[node2])
                    c_last[node2] = t2
                    c_qd[node2] -= 1
                    load2 = c_load[node2] - 1; c_load[node2] = load2
                    hpush(loadheap, (load2, node2))
                    cs_l[v] = _CANCELLED
                    if mt:
                        tacct_c(ten_l[v], t2, -1)
                    ov_after_cancel(v, t2, True, 0)
                    return

            def ov_shed_dispatch(r2: int, t2: float, cpu: bool,
                                 srv: int) -> int:
                """Dispatch-time shedding for the copy about to start
                service: deadline-hopeless first (even a zero-wait start
                cannot meet the request's deadline, judged against the
                deterministic service-time floor), then head-age CoDel
                (the dequeued copy's age stayed above target for a full
                interval; at most one shed per interval per server).
                Returns the shed_by reason index, or 0 to serve."""
                if shp_hope:
                    c2 = (coef_c if cpu else coef_d)[picks_l[r2]]
                    if t2 + c2[0] > times[r2] + timeout_s:
                        return 1
                if codel_t is not None:
                    first = codel_c if cpu else codel_d
                    age = t2 - times[r2]
                    if age > codel_t:
                        f0 = first[srv]
                        if f0 < 0.0:
                            first[srv] = t2
                        elif t2 - f0 >= codel_i:
                            first[srv] = t2
                            return 2
                    else:
                        first[srv] = -1.0
                return 0

        # -- dispatch helpers ------------------------------------------------
        if tier_on:
            lm_bf = self.lm.backing_fetch
            lm_chs = self.lm.cache_hit_savings
            _sav: Dict[int, float] = {}     # size -> cache-hit savings

            def tier_adjust(rid2: int, d2: int, svc: float) -> float:
                """Tier effects on one DSCS service start: a first access
                on a drive the object isn't materialized on pays the
                backing-store fill; a DRAM cache hit subtracts the
                flash-P2P + NS-driver savings."""
                nonlocal t_fill, fill_s
                o = obj_l[rid2] if obj_l is not None else rid2
                sz = t_objbytes or rb[picks_l[rid2]]
                m = mat[d2]
                if o not in m:
                    f = lm_bf(sz)
                    svc += f
                    fill_s += f; t_fill += 1
                    m.add(o)
                if caches is not None and caches[d2].access(o, sz):
                    sav = _sav.get(sz)
                    if sav is None:
                        sav = lm_chs(sz); _sav[sz] = sav
                    svc -= sav
                return svc if svc > 1e-9 else 1e-9

        def start_drive(d: int, t: float) -> None:
            nonlocal t_tomb, s_i, d_busy_s
            dq = d_queues[d]
            while dq:
                r2 = dq.popleft()
                st = ds_l[r2]
                if st == _CANCELLED:    # tombstone surfaced: discard, never start
                    t_tomb += 1
                    continue
                assert st == _QUEUED, "only queued copies may start service"
                if ov_disp:
                    why2 = ov_shed_dispatch(r2, t, False, d)
                    if why2:
                        d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                        d_qd[d] -= 1
                        ds_l[r2] = _CANCELLED
                        if mt:
                            tacct_d(ten_l[r2], t, -1)
                        ov_after_cancel(r2, t, False, why2)
                        continue
                d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                d_qd[d] -= 1
                ds_l[r2] = _RUNNING
                i = s_i
                if i == len(s_tr):
                    s_grow()
                s_i = i + 1
                c = coef_d[picks_l[r2]]
                svc = c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]
                if tier_on:
                    svc = tier_adjust(r2, d, svc)
                if fa:
                    sf = d_stall[d]
                    if sf != 1.0:       # gray failure: slowed service
                        svc *= sf
                    d_run[d] = r2
                d_busy_s += svc
                d_start_a[r2] = t; d_svc_a[r2] = svc
                d_busy[d] = 1
                if mt:
                    k = ten_l[r2]
                    tacct_d(k, t, -1)
                    tb_d[k] += svc
                hpush(heap, (t + svc, r2 << 1))
                return

        def start_cpu(node: int, t: float) -> None:
            nonlocal t_tomb, s_i, c_busy_s
            cq = c_queues[node]
            while cq:
                r2 = cq.popleft()
                st = cs_l[r2]
                if st == _CANCELLED:
                    t_tomb += 1
                    continue
                assert st == _QUEUED, "only queued copies may start service"
                if ov_disp:
                    why2 = ov_shed_dispatch(r2, t, True, node)
                    if why2:
                        c_area[node] += c_qd[node] * (t - c_last[node])
                        c_last[node] = t
                        c_qd[node] -= 1
                        load2 = c_load[node] - 1; c_load[node] = load2
                        hpush(loadheap, (load2, node))
                        cs_l[r2] = _CANCELLED
                        if mt:
                            tacct_c(ten_l[r2], t, -1)
                        ov_after_cancel(r2, t, True, why2)
                        continue
                c_area[node] += c_qd[node] * (t - c_last[node])
                c_last[node] = t
                c_qd[node] -= 1
                cs_l[r2] = _RUNNING
                i = s_i
                if i == len(s_tr):
                    s_grow()
                s_i = i + 1
                c = coef_c[picks_l[r2]]
                svc = c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]
                if fa:
                    ext = degr.get(r2)
                    if ext is not None: # degraded: remote backing fetch
                        svc += ext
                    c_run[node] = r2
                c_busy_s += svc
                c_start_a[r2] = t; c_svc_a[r2] = svc
                c_busy[node] = 1
                if mt:
                    k = ten_l[r2]
                    tacct_c(k, t, -1)
                    tb_c[k] += svc
                hpush(heap, (t + svc, (r2 << 1) | 1))
                return

        def issue_cpu(rid: int, t: float) -> None:
            nonlocal s_i, c_busy_s, ov_cc
            # least-loaded *active* CPU node, lowest index on ties: lazy
            # indexed heap (inactive nodes' entries are popped on sight; an
            # active node always holds its current entry — pushed on every
            # load change and on reactivation — so the heap never runs dry
            # while n_c_active >= 1, which the epoch handler guarantees)
            while True:
                load, node = loadheap[0]
                if c_load[node] == load and c_active[node] \
                        and (not fa or c_alive[node]):
                    break
                hpop(loadheap)          # stale, deactivated or dead entry
            if ov_maxq is not None and c_qd[node] >= ov_maxq \
                    and (c_busy[node] or c_queues[node]):
                # bounded CPU queue: shed the oldest live copy to make
                # room, or drop the incoming copy itself.  A dropped
                # hedge/detect copy leaves its DSCS sibling racing (copy-
                # level loss); a dropped primary copy sheds the request.
                if ov_incoming:
                    if ds_l[rid] == _QUEUED or ds_l[rid] == _RUNNING:
                        ov_cc += 1
                    else:
                        ov_drop_incoming(rid, t)
                    return
                ov_evict_cpu(node, t)
            c_node_l[rid] = node
            load += 1; c_load[node] = load
            hpush(loadheap, (load, node))
            if c_busy[node] or c_queues[node]:
                c_area[node] += c_qd[node] * (t - c_last[node])
                c_last[node] = t
                c_queues[node].append(rid)
                q = c_qd[node] + 1; c_qd[node] = q
                if q > c_maxd[node]: c_maxd[node] = q
                cs_l[rid] = _QUEUED
                if mt:
                    tacct_c(ten_l[rid], t, 1)
                # a server only goes idle by draining its deque to empty
                # (discarding tombstones), so nonempty deque => busy
                assert c_busy[node], "idle CPU node held a nonempty queue"
            else:
                # idle node: start immediately (transient depth 1)
                c_last[node] = t
                if not c_maxd[node]: c_maxd[node] = 1
                cs_l[rid] = _RUNNING
                i = s_i
                if i == len(s_tr):
                    s_grow()
                s_i = i + 1
                c = coef_c[picks_l[rid]]
                svc = c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]
                if fa:
                    ext = degr.get(rid)
                    if ext is not None:
                        svc += ext
                    c_run[node] = rid
                c_busy_s += svc
                c_start_a[rid] = t; c_svc_a[rid] = svc
                c_busy[node] = 1
                if mt:
                    tb_c[ten_l[rid]] += svc
                hpush(heap, (t + svc, (rid << 1) | 1))

        if fa:
            def degrade(rid2: int, t: float) -> None:
                """Every replica of the request's object is down (or its
                home drive is dead, tier off): serve on the CPU path with
                the object fetched from the remote backing store, each
                fetch attempt failing independently with ``backing_fail_p``
                (failed attempts cost ``backing_retry_s`` apiece)."""
                nonlocal f_degraded, f_back_fail
                f_degraded += 1
                sz = (t_objbytes or rb[picks_l[rid2]]) if tier_on \
                    else f_rb[picks_l[rid2]]
                ext = lm_bf2(sz)
                if bf_p > 0.0:
                    while frng.random() < bf_p:
                        f_back_fail += 1
                        ext += bf_retry
                degr[rid2] = ext
                issue_cpu(rid2, t)

            def try_retry(rid2: int, t: float) -> None:
                """One copy of ``rid2`` was just lost and no other copy is
                live: grant a retry (backoff delay on the heap) under the
                policy + budget, or abandon the request."""
                nonlocal f_retry_sched, f_aband, f_budget_deny, \
                    rb_granted, end_t, ov_retry_deny
                if ov_gate_on and ov_admit(rid2, t):
                    # retries consult the same admission gate as fresh
                    # arrivals, so backoff cannot storm a pushed-back or
                    # token-exhausted fleet: the denied retry abandons
                    ov_retry_deny += 1
                    dead_l[rid2] = 1
                    f_aband += 1
                    if t > end_t:
                        end_t = t
                    return
                att = att_l[rid2] + 1
                att_l[rid2] = att
                delay = None
                if rbud is None or rbud.allows(rb_granted, ai):
                    delay = rp.delay_s(att, prevdel_l[rid2], frng)
                else:
                    f_budget_deny += 1
                if delay is None:
                    dead_l[rid2] = 1
                    f_aband += 1
                    if t > end_t:
                        end_t = t
                    return
                prevdel_l[rid2] = delay
                rb_granted += 1
                f_retry_sched += 1
                hpush(heap, (t + delay, -(nd + 1 + rid2)))

            def redispatch(rid2: int, t: float) -> None:
                """A granted retry timer fired: re-dispatch the request to
                a surviving drive (alive replicas under tiering, the home
                drive otherwise), to a surviving CPU node for
                non-acceleratable requests, or degrade when no drive
                holding the object survives."""
                nonlocal f_redisp, n_d_on, n_waking, t_wake
                if not accel_l[rid2]:
                    f_redisp += 1
                    issue_cpu(rid2, t)
                    return
                d = -1
                if tier_on:
                    o = obj_l[rid2] if obj_l is not None else rid2
                    reps = replicas[o]
                    best = None
                    for d2 in reps:
                        if not d_alive[d2]:
                            continue
                        key2 = (1 if (dyn and not d_power[d2]) else 0,
                                d_qd[d2] + d_busy[d2],
                                0 if (caches is not None
                                      and caches[d2].warm(o)) else 1,
                                d2)
                        if best is None or key2 < best:
                            best = key2; d = d2
                else:
                    d0 = drive_l[rid2]
                    if d_alive[d0]:
                        d = d0
                if d < 0:
                    degrade(rid2, t)
                    return
                if ov_maxq is not None and d_qd[d] >= ov_maxq:
                    if ov_incoming:
                        ov_drop_incoming(rid2, t)
                        return
                    ov_evict_drive(d, t)
                f_redisp += 1
                drive_l[rid2] = d
                ds_l[rid2] = _QUEUED
                if dyn and d_power[d] == 0:
                    d_power[d] = 2
                    n_d_on += 1
                    n_waking += 1
                    d_on_since[d] = t
                    d_busy[d] = 1
                    hpush(heap, (t + wake_s, -(d + 1)))
                    t_wake += 1
                d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                d_queues[d].append(rid2)
                q = d_qd[d] + 1; d_qd[d] = q
                if q > d_maxd[d]: d_maxd[d] = q
                if not d_busy[d]:
                    start_drive(d, t)

            def schedule_repair(dd: int, t: float) -> None:
                """Drive ``dd`` just left the fleet (fail-stop or
                autoscaler power-down): queue the re-replication of every
                object that kept a replica there onto surviving drives
                (HRW order), through the serialized repair pipe.  The
                replica table is patched when the transfer completes."""
                nonlocal rep_until
                if not repair_on:
                    return
                moves = []
                for o2, r2 in enumerate(replicas):
                    if dd in r2:
                        for cand in _hrw_ranking(f"obj-{o2}", nd):
                            if cand != dd and d_alive[cand] \
                                    and cand not in r2:
                                moves.append((o2, dd, cand))
                                break
                if not moves:
                    return
                nbytes = len(moves) * rep_objbytes
                start = rep_until if rep_until > t else t
                rep_until = start + nbytes / rep_bw
                rep_pending.append((nbytes, moves))
                hpush(heap, (rep_until, -(nd + 1 + n)))

        if sk == 1:
            def ts_select(d: int, t: float) -> None:
                """Weighted-round-robin scheduling decision for drive ``d``:
                serve the next backlogged tenant's head copy for at most
                its weighted quantum, paying the context-switch cost when
                the serving tenant changes.  Tombstoned (cancelled while
                queued) copies are discarded on sight."""
                nonlocal t_tomb, s_i, d_busy_s, t_switch_s
                tq = d_tq[d]
                sel = -1
                cursor = d_rr[d]
                for step in range(1, K + 1):
                    k = (cursor + step) % K
                    q = tq[k]
                    while q and ds_l[q[0]] == _CANCELLED:
                        q.popleft()     # tombstone (reclaim counted at cancel)
                        t_tomb += 1
                    if q:
                        sel = k
                        break
                if sel < 0:
                    d_cur[d] = -1
                    d_busy[d] = 0
                    return
                rid2 = tq[sel].popleft()
                d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                d_qd[d] -= 1
                tacct_d(sel, t, -1)
                pay = 0.0
                if d_lastten[d] != sel:
                    if d_lastten[d] >= 0:
                        pay = ts_switch
                        t_switch_s += pay
                    d_lastten[d] = sel
                d_rr[d] = sel
                if rem_l[rid2] < 0.0:   # first start: draw the full service
                    i = s_i
                    if i == len(s_tr):
                        s_grow()
                    s_i = i + 1
                    c = coef_d[picks_l[rid2]]
                    svc = c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]
                    rem_l[rid2] = svc
                    d_start_a[rid2] = t + pay
                    d_svc_a[rid2] = svc
                ds_l[rid2] = _RUNNING
                d_cur[d] = rid2
                d_busy[d] = 1
                rem = rem_l[rid2]
                q_s = ts_q[sel]
                seg = rem if rem <= q_s else q_s
                d_busy_s += pay + seg
                tb_d[sel] += pay + seg
                if rem <= q_s:          # final segment: completion event
                    hpush(heap, (t + pay + rem, rid2 << 1))
                else:                   # quantum expiry: preempt event
                    hpush(heap, (t + pay + q_s, -(nd + 1 + rid2)))
        elif sk == 2:
            def sp_start_new(d: int, k: int, rid2: int, t: float) -> None:
                """Idle lane group: start ``rid2`` immediately (transient
                depth 1), service inflated by the tenant's lane share."""
                nonlocal s_i, d_busy_s
                # settle the drive's pending depth area first: unlike an
                # idle FCFS drive, an idle *lane* can coexist with copies
                # queued on the drive's other lanes (d_qd > 0)
                d_area[d] += d_qd[d] * (t - d_last[d])
                d_last[d] = t
                if not d_maxd[d]: d_maxd[d] = 1
                ds_l[rid2] = _RUNNING
                i = s_i
                if i == len(s_tr):
                    s_grow()
                s_i = i + 1
                c = coef_d[picks_l[rid2]]
                svc = (c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]) * sp_scale[k]
                d_busy_s += svc
                tb_d[k] += svc
                d_start_a[rid2] = t; d_svc_a[rid2] = svc
                sp_busy[d][k] = 1
                hpush(heap, (t + svc, rid2 << 1))

            def sp_start(d: int, k: int, t: float) -> None:
                """Start the next queued copy on drive ``d``'s lane group
                for tenant ``k``, discarding tombstones."""
                nonlocal t_tomb, s_i, d_busy_s
                q = sp_q[d][k]
                while q:
                    rid2 = q.popleft()
                    if ds_l[rid2] == _CANCELLED:
                        t_tomb += 1
                        continue
                    assert ds_l[rid2] == _QUEUED, \
                        "only queued copies may start service"
                    d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                    d_qd[d] -= 1
                    tacct_d(k, t, -1)
                    ds_l[rid2] = _RUNNING
                    i = s_i
                    if i == len(s_tr):
                        s_grow()
                    s_i = i + 1
                    c = coef_d[picks_l[rid2]]
                    svc = (c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]) \
                        * sp_scale[k]
                    d_busy_s += svc
                    tb_d[k] += svc
                    d_start_a[rid2] = t; d_svc_a[rid2] = svc
                    sp_busy[d][k] = 1
                    hpush(heap, (t + svc, rid2 << 1))
                    return

        # -- main loop -------------------------------------------------------
        # Event order: arrivals win every tie (they had the lowest sequence
        # numbers in the PR-1 heap); hedge timers share one constant budget
        # so they fire in FIFO order from hedge_dq; finish events order by
        # (time, copy id) — service times are continuous draws, so exact
        # finish-time ties have measure zero and the golden-trace gates pin
        # that the ordering stays equivalent.
        ai = 0
        base = 0
        if n:
            limit = min(n, _CHUNK)
            times_l = times[:limit].tolist()
            next_t = times_l[0]
        else:
            limit, times_l, next_t = 0, [], INF

        while True:
            ft = heap[0][0] if heap else INF
            ht = hedge_dq[0][0] if hedge_dq else INF
            fault_t = ftl[fi][0] if fi < fn else INF
            dlt = dl_dq[0][0] if dl_dq else INF
            dtt = det_dq[0][0] if det_dq else INF
            if ov_t <= ft and ov_t <= ht and ov_t < ep_t and \
                    ov_t <= mig_t and ov_t <= fault_t and ov_t <= dlt and \
                    ov_t <= dtt and ov_t < next_t and \
                    (next_t != INF or heap or hedge_dq):
                # overload control epoch: derive the pushback factor and
                # the brownout state from the live queue depth per active
                # server.  Same-time autoscale epochs win the tie (strict
                # ov_t < ep_t), arrivals win against both, and the epoch
                # stream stops once the fleet has drained.
                t = ov_t
                ov_epochs += 1
                active = n_d_on + n_c_active
                depth = ((sum(d_qd) + sum(c_qd)) / active
                         if active else 0.0)
                if bp is not None:
                    f2 = 1.0
                    if depth > bp.target_depth:
                        f2 = bp.target_depth / depth
                        if f2 < bp.min_factor:
                            f2 = bp.min_factor
                    if f2 != push_f:
                        push_f = f2
                        push_tl.append((t, f2))
                if bro is not None:
                    if bro_active:
                        if depth <= bro.off_depth:
                            bro_active = False
                            bro_ivals.append((bro_since, t))
                            bro_above = 0
                        else:
                            bro_ep_act += 1
                    elif depth >= bro.on_depth:
                        bro_above += 1
                        if bro_above >= bro.min_epochs:
                            bro_active = True
                            bro_entered += 1
                            bro_since = t
                            bro_ep_act += 1
                    else:
                        bro_above = 0
                ov_t += ov_ep_s
                continue
            if ep_t <= ft and ep_t <= ht and ep_t <= mig_t and \
                    ep_t <= fault_t and ep_t <= dlt and ep_t <= dtt and \
                    ep_t < next_t and (next_t != INF or heap or hedge_dq):
                # epoch boundary: snapshot telemetry, apply the controller's
                # action.  Fires before same-time dynamic events, after
                # same-time arrivals, and stops once the fleet has drained.
                t = ep_t
                ep_idx += 1
                done = t_srv_d + t_srv_c + t_won_d + t_won_c
                if mt:
                    snap_tq = tuple(tqd_d[k] + tqd_c[k] for k in range(K))
                    snap_ta = tuple(a - b for a, b in zip(tarr, ep_last_ta))
                    snap_tc = tuple(a - b for a, b in zip(tdone, ep_last_tc))
                    ep_last_ta = list(tarr)
                    ep_last_tc = list(tdone)
                else:
                    snap_tq = snap_ta = snap_tc = ()
                act = controller.observe(FleetSnapshot(
                    time=t, epoch=ep_idx,
                    arrivals=ai - ep_last_ai,
                    completions=done - ep_last_done,
                    dscs_queue=sum(d_qd), cpu_queue=sum(c_qd),
                    dscs_busy=sum(d_busy) - n_waking, cpu_busy=sum(c_busy),
                    n_cpu_active=n_c_active, n_dscs_on=n_d_on,
                    n_cpu_total=nc, n_dscs_total=nd,
                    tenant_queue=snap_tq, tenant_arrivals=snap_ta,
                    tenant_completions=snap_tc,
                    rejected=ov_rej - ep_last_rej,
                    shed=ov_shed - ep_last_shed, pushback=push_f))
                ep_last_ai, ep_last_done = ai, done
                ep_last_rej, ep_last_shed = ov_rej, ov_shed
                if act is not None:
                    # CPU pool: activate lowest-index first / deactivate
                    # highest-index first (deterministic); a deactivated
                    # node drains run-to-completion, then powers off
                    want_c = min(nc, max(1, int(act.n_cpu)))
                    if want_c > n_c_active:
                        for node in range(nc):
                            if n_c_active >= want_c:
                                break
                            if not c_active[node]:
                                c_active[node] = True
                                n_c_active += 1
                                if fa and c_alive[node]:
                                    n_alive_active += 1
                                if c_on_since[node] < 0.0 and \
                                        (not fa or c_alive[node]):
                                    c_on_since[node] = t
                                hpush(loadheap, (c_load[node], node))
                    elif want_c < n_c_active:
                        for node in range(nc - 1, -1, -1):
                            if n_c_active <= want_c:
                                break
                            if c_active[node]:
                                if fa and c_alive[node] \
                                        and n_alive_active <= 1:
                                    continue    # keep one live CPU node
                                c_active[node] = False
                                n_c_active -= 1
                                if fa and c_alive[node]:
                                    n_alive_active -= 1
                                if not c_busy[node] and not c_queues[node] \
                                        and c_on_since[node] >= 0.0:
                                    c_on_ivals.append((c_on_since[node], t))
                                    c_on_since[node] = -1.0
                    # drives: power on lowest-index off drives (they wake,
                    # serving after dscs_wake_s) / power off highest-index
                    # idle drives (busy, waking or backlogged drives are
                    # never yanked — best effort toward the target)
                    want_d = min(nd, max(0, int(act.n_dscs_on)))
                    if want_d > n_d_on:
                        for d in range(nd):
                            if n_d_on >= want_d:
                                break
                            if fa and not d_alive[d]:
                                continue    # dead drives cannot be woken
                            if d_power[d] == 0:
                                d_power[d] = 2
                                n_d_on += 1
                                n_waking += 1
                                d_on_since[d] = t
                                d_busy[d] = 1
                                hpush(heap, (t + wake_s, -(d + 1)))
                                t_wake += 1
                    elif want_d < n_d_on:
                        for d in range(nd - 1, -1, -1):
                            if n_d_on <= want_d:
                                break
                            if (d_power[d] == 1 and not d_busy[d]
                                    and not d_queues[d]):
                                d_power[d] = 0
                                n_d_on -= 1
                                d_on_ivals.append((d_on_since[d], t))
                                d_on_since[d] = -1.0
                                if fa:
                                    # an autoscaler power-down removes the
                                    # drive's replicas from service just
                                    # like a fail-stop: re-replicate them
                                    # (ROADMAP "replication under the
                                    # autoscaler" follow-on)
                                    schedule_repair(d, t)
                ep_t += ep_s
                continue
            if mig_t <= ft and mig_t <= ht and mig_t < ep_t and \
                    mig_t <= fault_t and mig_t <= dlt and mig_t <= dtt and \
                    mig_t < next_t and (next_t != INF or heap or hedge_dq):
                # hot-key migration epoch: rebalance the replica table from
                # the live per-drive backlogs and this epoch's access
                # counts.  A moved key only retargets *routing* — the
                # durable copy materializes on its new drive through a
                # backing-store fetch on first access, like a lazy replica.
                for o2, frm, to in mig.plan(mig_t, d_qd, d_busy, acc,
                                            replicas):
                    r2 = replicas[o2]
                    r2[r2.index(frm)] = to
                for a2 in acc:
                    a2.clear()
                mig_t += mig_s
                continue
            if fault_t <= ft and fault_t <= ht and fault_t < ep_t and \
                    fault_t < mig_t and fault_t <= dlt and fault_t <= dtt \
                    and fault_t < next_t:
                # injected fault from the plan's timeline (self-
                # terminating: the cursor only ever advances)
                t, kind, srv, extra = ftl[fi]
                fi += 1
                x_ev += 1
                if kind == DRIVE_FAIL:
                    d = srv
                    if not d_alive[d]:
                        continue        # overlapping window: already dead
                    d_alive[d] = False
                    f_inj[DRIVE_FAIL] += 1
                    d_down_since[d] = t
                    lost = []
                    dq = d_queues[d]
                    if dq or d_qd[d]:
                        d_area[d] += d_qd[d] * (t - d_last[d])
                        d_last[d] = t
                        while dq:
                            r2 = dq.popleft()
                            if ds_l[r2] == _CANCELLED:
                                t_tomb += 1
                                continue
                            ds_l[r2] = _CANCELLED
                            lost.append(r2)
                        d_qd[d] = 0
                    r3 = d_run[d]
                    if r3 >= 0:
                        left = d_start_a[r3] + d_svc_a[r3] - t
                        d_busy_s -= left
                        if ds_l[r3] != _CANCELLED:  # not a draining loser
                            lost.append(r3)
                        else:
                            rec_d += left
                        ds_l[r3] = _PREEMPTED
                        # invalidate the recorded service so the dead
                        # copy's in-heap finish event can never match a
                        # later re-dispatch that is still queued (NaN
                        # fails the exact-time staleness check)
                        d_svc_a[r3] = NAN
                        d_run[d] = -1
                    d_busy[d] = 0
                    if dyn:
                        if d_power[d] == 2:
                            n_waking -= 1   # stale wake event skipped later
                        if d_power[d] != 0:
                            n_d_on -= 1
                            d_on_ivals.append((d_on_since[d], t))
                            d_on_since[d] = -1.0
                    d_power[d] = 0
                    schedule_repair(d, t)
                    for r2 in lost:
                        if winner_l[r2] >= 0 or dead_l[r2]:
                            continue
                        f_lost += 1
                        cst = cs_l[r2]
                        if cst == _QUEUED or cst == _RUNNING:
                            continue    # the hedge copy races on
                        try_retry(r2, t)
                elif kind == DRIVE_RECOVER:
                    d = srv
                    if d_alive[d]:
                        continue
                    d_alive[d] = True
                    f_inj[DRIVE_RECOVER] += 1
                    d_down_s[d] += t - d_down_since[d]
                    d_down_since[d] = -1.0
                    if tier_on:
                        # the replacement drive comes back empty: durable
                        # copies refill lazily from the backing store
                        mat[d].clear()
                    d_power[d] = 1
                    d_busy[d] = 0
                    if dyn:
                        n_d_on += 1
                        d_on_since[d] = t
                elif kind == STALL_BEGIN:
                    if d_alive[srv]:
                        f_inj[STALL_BEGIN] += 1
                    d_stall[srv] = extra
                elif kind == STALL_END:
                    d_stall[srv] = 1.0
                elif kind == CPU_CRASH:
                    node = srv
                    if not c_alive[node]:
                        continue
                    if c_active[node] and n_alive_active <= 1:
                        f_cpu_skip += 1  # never kill the last live node
                        continue
                    c_alive[node] = False
                    f_inj[CPU_CRASH] += 1
                    if c_active[node]:
                        n_alive_active -= 1
                    lost = []
                    cq = c_queues[node]
                    if cq or c_qd[node]:
                        c_area[node] += c_qd[node] * (t - c_last[node])
                        c_last[node] = t
                        while cq:
                            r2 = cq.popleft()
                            if cs_l[r2] == _CANCELLED:
                                t_tomb += 1
                                continue
                            cs_l[r2] = _CANCELLED
                            lost.append(r2)
                        c_qd[node] = 0
                    r3 = c_run[node]
                    if r3 >= 0:
                        left = c_start_a[r3] + c_svc_a[r3] - t
                        c_busy_s -= left
                        if cs_l[r3] != _CANCELLED:
                            lost.append(r3)
                        else:
                            rec_c += left
                        cs_l[r3] = _PREEMPTED
                        c_svc_a[r3] = NAN   # kill the stale finish event
                        c_run[node] = -1
                    c_busy[node] = 0
                    c_load[node] = 0
                    if dyn and c_on_since[node] >= 0.0:
                        c_on_ivals.append((c_on_since[node], t))
                        c_on_since[node] = -1.0
                    for r2 in lost:
                        if winner_l[r2] >= 0 or dead_l[r2]:
                            continue
                        f_lost += 1
                        dst = ds_l[r2]
                        if dst == _QUEUED or dst == _RUNNING:
                            continue    # the DSCS copy races on
                        try_retry(r2, t)
                else:                   # CPU_RECOVER
                    node = srv
                    if c_alive[node]:
                        continue
                    c_alive[node] = True
                    f_inj[CPU_RECOVER] += 1
                    if c_active[node]:
                        n_alive_active += 1
                        hpush(loadheap, (c_load[node], node))
                        if dyn and c_on_since[node] < 0.0:
                            c_on_since[node] = t
                continue
            if dlt <= ft and dlt <= ht and dlt < ep_t and dlt < mig_t \
                    and dlt <= dtt and dlt < next_t:
                # per-request deadline: cancel whatever is still pending
                # (queued copies tombstone; running copies free their
                # server and return the unserved remainder)
                t, rid = dl_dq.popleft()
                x_ev += 1
                if winner_l[rid] >= 0 or dead_l[rid]:
                    continue
                dst = ds_l[rid]
                if dst == _QUEUED:
                    d = drive_l[rid]
                    d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                    d_qd[d] -= 1
                    ds_l[rid] = _CANCELLED
                elif dst == _RUNNING:
                    ds_l[rid] = _PREEMPTED
                    d = drive_l[rid]
                    left = d_start_a[rid] + d_svc_a[rid] - t
                    rec_d += left
                    d_busy_s -= left
                    d_busy[d] = 0
                    if fa:
                        d_run[d] = -1
                    if d_queues[d]:
                        start_drive(d, t)
                cst = cs_l[rid]
                if cst == _QUEUED:
                    node = c_node_l[rid]
                    c_area[node] += c_qd[node] * (t - c_last[node])
                    c_last[node] = t
                    c_qd[node] -= 1
                    load = c_load[node] - 1; c_load[node] = load
                    hpush(loadheap, (load, node))
                    cs_l[rid] = _CANCELLED
                elif cst == _RUNNING:
                    cs_l[rid] = _PREEMPTED
                    node = c_node_l[rid]
                    left = c_start_a[rid] + c_svc_a[rid] - t
                    rec_c += left
                    c_busy_s -= left
                    c_busy[node] = 0
                    if fa:
                        c_run[node] = -1
                    load = c_load[node] - 1; c_load[node] = load
                    hpush(loadheap, (load, node))
                    if c_queues[node]:
                        start_cpu(node, t)
                    if dyn and not c_active[node] and not c_busy[node] \
                            and not c_queues[node] \
                            and c_on_since[node] >= 0.0:
                        c_on_ivals.append((c_on_since[node], t))
                        c_on_since[node] = -1.0
                dead_l[rid] = 1
                t_dead += 1
                if t > end_t:
                    end_t = t
                continue
            if dtt <= ft and dtt <= ht and dtt < ep_t and dtt < mig_t \
                    and dtt < next_t:
                # timeout-based failure detection: the DSCS copy is still
                # unfinished detect_timeout_s after dispatch (stalled or
                # backlogged drive) — hedge it on the CPU path now
                t, rid = det_dq.popleft()
                x_ev += 1
                if winner_l[rid] < 0 and not dead_l[rid] \
                        and cs_l[rid] == _FREE \
                        and (ds_l[rid] == _QUEUED
                             or ds_l[rid] == _RUNNING):
                    hedged_l[rid] = True
                    f_detect += 1
                    issue_cpu(rid, t)
                continue
            if ht <= ft:
                if ht < next_t:         # hedge timer fires
                    t, rid = hedge_dq.popleft()
                    # still waiting (and, under time-slicing, never
                    # serviced — a preempted copy re-queues as _QUEUED but
                    # holds partial progress, so it is no straggler)
                    if ds_l[rid] == _QUEUED and (sk != 1
                                                 or rem_l[rid] < 0.0) \
                            and (not fa or cs_l[rid] == _FREE):
                        # under faults a detection hedge may already have
                        # issued the CPU copy; never issue a third
                        if bro_active:
                            # brownout: hedging suspended under sustained
                            # overload — the request degrades to the
                            # single-copy path.  (Failure-*detection*
                            # hedges stay active: they rescue stuck
                            # requests rather than shave tails.)
                            ov_hedge_sup += 1
                        else:
                            hedged_l[rid] = True
                            t_hedge += 1
                            issue_cpu(rid, t)
                    continue
            elif ft < next_t:           # a dynamic event fires
                t, code = hpop(heap)
                if code < 0:
                    k2 = -code - 1
                    if k2 < nd:         # wake event: drive is serviceable
                        d = k2
                        if fa and d_power[d] != 2:
                            continue    # drive failed while waking
                        assert d_power[d] == 2, \
                            "wake event for a non-waking drive"
                        d_power[d] = 1
                        d_busy[d] = 0
                        n_waking -= 1
                        if d_queues[d]:
                            start_drive(d, t)
                        continue
                    if fa:
                        # the -(nd+1+...) code range holds retry timers
                        # (rid < n) and repair completions (rid == n) on
                        # faulted runs — time-slicing is mutually
                        # exclusive with fault injection
                        rid = k2 - nd
                        x_ev += 1
                        if rid >= n:    # repair transfer completed
                            nbytes, moves = rep_pending.popleft()
                            for o2, frm, tgt in moves:
                                r2 = replicas[o2]
                                if frm in r2 and d_alive[tgt]:
                                    r2[r2.index(frm)] = tgt
                                    mat[tgt].add(o2)
                                    rep_objs += 1
                            rep_bytes += nbytes
                            rep_s += nbytes / rep_bw
                            rep_jobs += 1
                            continue
                        if winner_l[rid] >= 0 or dead_l[rid] \
                                or ds_l[rid] == _QUEUED \
                                or ds_l[rid] == _RUNNING \
                                or cs_l[rid] == _QUEUED \
                                or cs_l[rid] == _RUNNING:
                            continue    # resolved, or a copy is racing
                        redispatch(rid, t)
                        continue
                    # time-slice quantum expiry: preempt the running copy
                    rid = k2 - nd
                    t_pre += 1
                    d = drive_l[rid]
                    k = ten_l[rid]
                    rem_l[rid] -= ts_q[k]
                    if ds_l[rid] == _CANCELLED:
                        # hedge loser caught mid-slice: drop it at the
                        # quantum boundary and reclaim the remainder
                        # (time-slicing always preempts — the §V run-to-
                        # completion argument doesn't apply to a DSA that
                        # already context-switches)
                        ds_l[rid] = _PREEMPTED
                        rec_d += rem_l[rid]
                    else:
                        # resume at the tenant's next turn (head of queue)
                        d_tq[d][k].appendleft(rid)
                        ds_l[rid] = _QUEUED
                        d_area[d] += d_qd[d] * (t - d_last[d])
                        d_last[d] = t
                        q = d_qd[d] + 1; d_qd[d] = q
                        if q > d_maxd[d]: d_maxd[d] = q
                        tacct_d(k, t, 1)
                    d_cur[d] = -1
                    ts_select(d, t)
                    continue
                rid = code >> 1
                if code & 1:            # CPU copy finished
                    if cs_l[rid] == _PREEMPTED:
                        continue        # stale: node freed at cancellation
                    if fa and t != c_start_a[rid] + c_svc_a[rid]:
                        # stale event of a copy lost to a fault and since
                        # re-issued: the live copy's own event carries the
                        # recomputed (bit-identical) start + service time
                        continue
                    end_t = t
                    node = c_node_l[rid]
                    c_busy[node] = 0
                    if fa:
                        c_run[node] = -1
                    load = c_load[node] - 1; c_load[node] = load
                    hpush(loadheap, (load, node))
                    if cs_l[rid] == _CANCELLED:
                        cfin_a[rid] = t        # run-to-completion loser drains
                    else:
                        cs_l[rid] = _DONE
                        finish_a[rid] = t
                        winner_l[rid] = 1
                        cfin_a[rid] = t
                        if mt:
                            tdone[ten_l[rid]] += 1
                        dst = ds_l[rid]
                        if dst == _QUEUED:     # tombstone the DSCS loser
                            d = drive_l[rid]
                            d_area[d] += d_qd[d] * (t - d_last[d])
                            d_last[d] = t
                            d_qd[d] -= 1
                            ds_l[rid] = _CANCELLED
                            t_can_q += 1
                            if mt:
                                tacct_d(ten_l[rid], t, -1)
                            if sk == 1 and rem_l[rid] >= 0.0:
                                # preempted copy cancelled while waiting
                                # its next slice: its remainder is
                                # reclaimed DSA time
                                rec_d += rem_l[rid]
                        elif dst == _RUNNING:
                            ds_l[rid] = _CANCELLED
                            t_can_s += 1
                            if preempt and sk != 1:
                                # preemptive cancellation: free the DSA
                                # now and reclaim the loser's remaining
                                # service (its stale finish event is
                                # skipped on pop); time-slicing instead
                                # drops the copy at its quantum boundary
                                ds_l[rid] = _PREEMPTED
                                d = drive_l[rid]
                                left = d_start_a[rid] + d_svc_a[rid] - t
                                rec_d += left
                                d_busy_s -= left
                                if mt:
                                    tb_d[ten_l[rid]] -= left
                                if sk == 0:
                                    d_busy[d] = 0
                                    if fa:
                                        d_run[d] = -1
                                    if d_queues[d]:
                                        start_drive(d, t)
                                else:
                                    k = ten_l[rid]
                                    sp_busy[d][k] = 0
                                    if sp_q[d][k]:
                                        sp_start(d, k, t)
                        if hedged_l[rid]:
                            t_won_c += 1
                        else:
                            t_srv_c += 1
                    if c_queues[node]:
                        start_cpu(node, t)
                    if dyn and not c_active[node] and not c_busy[node] \
                            and not c_queues[node] and c_on_since[node] >= 0.0:
                        # deactivated node fully drained: power it off
                        c_on_ivals.append((c_on_since[node], t))
                        c_on_since[node] = -1.0
                else:                   # DSCS copy finished
                    if ds_l[rid] == _PREEMPTED:
                        continue        # stale: drive freed at cancellation
                    if fa and t != d_start_a[rid] + d_svc_a[rid]:
                        continue        # stale event of a re-dispatched copy
                    end_t = t
                    d = drive_l[rid]
                    if ds_l[rid] == _CANCELLED:
                        dfin_a[rid] = t
                    else:
                        ds_l[rid] = _DONE
                        finish_a[rid] = t
                        winner_l[rid] = 0
                        dfin_a[rid] = t
                        if mt:
                            tdone[ten_l[rid]] += 1
                        if hedged_l[rid]:
                            t_won_d += 1
                            cst = cs_l[rid]
                            if cst == _QUEUED:     # tombstone the CPU loser
                                node = c_node_l[rid]
                                c_area[node] += c_qd[node] * (t - c_last[node])
                                c_last[node] = t
                                c_qd[node] -= 1
                                load = c_load[node] - 1; c_load[node] = load
                                hpush(loadheap, (load, node))
                                cs_l[rid] = _CANCELLED
                                t_can_q += 1
                                if mt:
                                    tacct_c(ten_l[rid], t, -1)
                            elif cst == _RUNNING:
                                cs_l[rid] = _CANCELLED
                                t_can_s += 1
                                if preempt:
                                    # preemptive cancellation of the CPU
                                    # loser: free the node immediately
                                    cs_l[rid] = _PREEMPTED
                                    node = c_node_l[rid]
                                    left = (c_start_a[rid] + c_svc_a[rid]
                                            - t)
                                    rec_c += left
                                    c_busy_s -= left
                                    if mt:
                                        tb_c[ten_l[rid]] -= left
                                    c_busy[node] = 0
                                    if fa:
                                        c_run[node] = -1
                                    load = c_load[node] - 1
                                    c_load[node] = load
                                    hpush(loadheap, (load, node))
                                    if c_queues[node]:
                                        start_cpu(node, t)
                                    if dyn and not c_active[node] \
                                            and not c_busy[node] \
                                            and not c_queues[node] \
                                            and c_on_since[node] >= 0.0:
                                        c_on_ivals.append(
                                            (c_on_since[node], t))
                                        c_on_since[node] = -1.0
                        else:
                            t_srv_d += 1
                    # free the DSA and continue its queue, per scheduler
                    if sk == 0:
                        d_busy[d] = 0
                        if fa:
                            d_run[d] = -1
                        if d_queues[d]:
                            start_drive(d, t)
                    elif sk == 1:
                        d_cur[d] = -1
                        d_busy[d] = 0
                        ts_select(d, t)
                    else:
                        k = ten_l[rid]
                        sp_busy[d][k] = 0
                        if sp_q[d][k]:
                            sp_start(d, k, t)
                continue
            if next_t == INF:
                break
            # arrival (wins ties against dynamic events, like the PR-1 seq)
            t = next_t
            rid = ai
            if mt:
                tarr[ten_l[rid]] += 1
            if ov_on:
                # admission control fires before placement, deadlines and
                # hedging: a rejected arrival consumes no queue slot, no
                # sampler draw and no timer
                why = ov_admit(rid, t) if ov_gate_on else 0
                if why:
                    ov_rej += 1
                    if why == 1:
                        ov_rej_push += 1
                    else:
                        ov_rej_adm += 1
                    ov_rej_cls[0 if accel_l[rid] else 1] += 1
                    if mt:
                        ov_ten_rej[ten_l[rid]] += 1
                    dead_l[rid] = 1
                    if t > end_t:
                        end_t = t
                    ai += 1
                    if ai < n:
                        if ai == limit:
                            base = ai
                            limit = min(n, ai + _CHUNK)
                            times_l = times[ai:limit].tolist()
                        next_t = times_l[ai - base]
                    else:
                        next_t = INF
                    continue
                ov_admitted += 1
                ov_adm_cls[0 if accel_l[rid] else 1] += 1
                if mt:
                    ov_ten_adm[ten_l[rid]] += 1
            if timeout_s is not None:
                dl_dq.append((t + timeout_s, rid))
            if accel_l[rid]:
                if tier_on:
                    # replica routing: among the object's replica drives
                    # prefer powered, then least-loaded, then cache-warm
                    # (lowest drive index on ties).  Load outranks warmth:
                    # a cache hit saves ~ms while a queued copy costs a
                    # full service time, so warmth-first would pile every
                    # hot-key request back onto one drive and recreate
                    # exactly the hotspot replication exists to dissolve
                    if obj_l is not None:
                        o = obj_l[rid]
                        reps = replicas[o]
                    else:
                        o = rid
                        reps = replicas.get(o)
                        if reps is None:
                            reps = _hrw_ranking(f"req-{rid}", nd)[:t_k]
                            replicas[o] = reps
                            mat[reps[0]].add(o)
                    d = reps[0]
                    if len(reps) > 1 or fa:
                        best = None
                        for d2 in reps:
                            if fa and not d_alive[d2]:
                                continue    # route around dead drives
                            key2 = (1 if (dyn and not d_power[d2]) else 0,
                                    d_qd[d2] + d_busy[d2],
                                    0 if (caches is not None
                                          and caches[d2].warm(o)) else 1,
                                    d2)
                            if best is None or key2 < best:
                                best = key2; d = d2
                        if fa and best is None:
                            d = -1          # every replica is down
                    drive_l[rid] = d
                    if mig is not None and d >= 0:
                        a2 = acc[d]
                        a2[o] = a2.get(o, 0) + 1
                else:
                    d = drive_l[rid]
                    if fa and not d_alive[d]:
                        d = -1
                if fa and d < 0:
                    # no surviving drive holds the object: gracefully
                    # degrade to the CPU path + remote backing fetch
                    drive_l[rid] = -1
                    t_cdisp += 1
                    degrade(rid, t)
                    ai += 1
                    if ai < n:
                        if ai == limit:
                            base = ai
                            limit = min(n, ai + _CHUNK)
                            times_l = times[ai:limit].tolist()
                        next_t = times_l[ai - base]
                    else:
                        next_t = INF
                    continue
                if ov_maxq is not None and d_qd[d] >= ov_maxq:
                    # bounded drive queue: make room by shedding the
                    # oldest live queued copy, or drop the arrival itself
                    # (before any hedge/detect timer is enqueued)
                    if ov_incoming:
                        ds_l[rid] = _CANCELLED
                        ov_drop_incoming(rid, t)
                        ai += 1
                        if ai < n:
                            if ai == limit:
                                base = ai
                                limit = min(n, ai + _CHUNK)
                                times_l = times[ai:limit].tolist()
                            next_t = times_l[ai - base]
                        else:
                            next_t = INF
                        continue
                    ov_evict_drive(d, t)
                t_ddisp += 1
                if hedge is not None:
                    hedge_dq.append((t + hedge, rid))
                if det_s is not None:
                    det_dq.append((t + det_s, rid))
                if sk == 1:
                    # time-slicing: enqueue on the owning tenant's
                    # per-drive queue; kick the scheduler if the DSA idles
                    k = ten_l[rid]
                    d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                    d_tq[d][k].append(rid)
                    q = d_qd[d] + 1; d_qd[d] = q
                    if q > d_maxd[d]: d_maxd[d] = q
                    tacct_d(k, t, 1)
                    ds_l[rid] = _QUEUED
                    if d_cur[d] < 0:
                        ts_select(d, t)
                elif sk == 2:
                    # spatial partitioning: the tenant's own lane group
                    k = ten_l[rid]
                    if sp_busy[d][k] or sp_q[d][k]:
                        d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                        sp_q[d][k].append(rid)
                        q = d_qd[d] + 1; d_qd[d] = q
                        if q > d_maxd[d]: d_maxd[d] = q
                        tacct_d(k, t, 1)
                        ds_l[rid] = _QUEUED
                    else:
                        sp_start_new(d, k, rid, t)
                else:
                    if dyn and d_power[d] == 0:
                        # data lives on a powered-off drive: start its wake
                        # (serviceable after dscs_wake_s) and queue the
                        # request there; marking the drive busy routes this
                        # and any later arrivals through the normal queue
                        # path below
                        d_power[d] = 2
                        n_d_on += 1
                        n_waking += 1
                        d_on_since[d] = t
                        d_busy[d] = 1
                        hpush(heap, (t + wake_s, -(d + 1)))
                        t_wake += 1
                    if d_busy[d] or d_queues[d]:
                        d_area[d] += d_qd[d] * (t - d_last[d]); d_last[d] = t
                        d_queues[d].append(rid)
                        q = d_qd[d] + 1; d_qd[d] = q
                        if q > d_maxd[d]: d_maxd[d] = q
                        ds_l[rid] = _QUEUED
                        if mt:
                            tacct_d(ten_l[rid], t, 1)
                        # a server only goes idle by draining its deque to
                        # empty (discarding tombstones), so nonempty deque
                        # => busy
                        assert d_busy[d], "idle drive held a nonempty queue"
                    else:
                        # idle drive: start immediately (transient depth 1)
                        d_last[d] = t
                        if not d_maxd[d]: d_maxd[d] = 1
                        ds_l[rid] = _RUNNING
                        i = s_i
                        if i == len(s_tr):
                            s_grow()
                        s_i = i + 1
                        c = coef_d[picks_l[rid]]
                        svc = c[0] + c[1] * s_tr[i] + c[2] * s_tw[i]
                        if tier_on:
                            svc = tier_adjust(rid, d, svc)
                        if fa:
                            sf = d_stall[d]
                            if sf != 1.0:
                                svc *= sf
                            d_run[d] = rid
                        d_busy_s += svc
                        d_start_a[rid] = t; d_svc_a[rid] = svc
                        d_busy[d] = 1
                        if mt:
                            tb_d[ten_l[rid]] += svc
                        hpush(heap, (t + svc, rid << 1))
            else:
                issue_cpu(rid, t)
                t_cdisp += 1
            ai += 1
            if ai < n:
                if ai == limit:
                    base = ai
                    limit = min(n, ai + _CHUNK)
                    times_l = times[ai:limit].tolist()
                next_t = times_l[ai - base]
            else:
                next_t = INF
        # every enqueued hedge timer is eventually popped and every started
        # copy (= one sampler draw) reaches a terminal event, so the count
        # is exact (quantum expiries counted separately)
        events = (n + (s_i - sampler._i)
                  + (t_ddisp if hedge is not None else 0) + t_wake + t_pre
                  + x_ev)
        sampler._i = s_i                # keep the sampler cursor consistent

        # -- power accounting (busy/powered seconds per class) ---------------
        if dyn:
            # clip every powered interval to the common horizon: epochs can
            # fire past the last completion (stale hedge timers, pending
            # wakes), and neither a power-off there nor a still-open
            # interval may contribute powered time beyond end_t
            c_on_s = sum(max(0.0, min(b, end_t) - a) for a, b in c_on_ivals)
            d_on_s = sum(max(0.0, min(b, end_t) - a) for a, b in d_on_ivals)
            for ts0 in c_on_since:
                if ts0 >= 0.0:
                    c_on_s += max(0.0, end_t - ts0)
            for ts0 in d_on_since:
                if ts0 >= 0.0:
                    d_on_s += max(0.0, end_t - ts0)
        else:
            c_on_s = end_t * nc
            d_on_s = end_t * nd
        self._pstate = {
            "horizon": end_t,
            "dscs": {"busy_s": d_busy_s, "powered_s": d_on_s, "n": nd},
            "cpu": {"busy_s": c_busy_s, "powered_s": c_on_s, "n": nc},
            "wake_events": t_wake, "epochs": ep_idx}

        # -- fault & deadline telemetry --------------------------------------
        # surfaced whenever any of faults / timeout / overload is enabled:
        # a timeout- or overload-only run must not silently lose its
        # abandonment and rejection counts just because no FaultPlan is set
        if fa or timeout_s is not None or ov_on:
            completed = t_srv_d + t_srv_c + t_won_d + t_won_c
            if fa:
                for d in range(nd):
                    if d_down_since[d] >= 0.0:  # still down at the horizon
                        down = end_t - d_down_since[d]
                        if down > 0.0:
                            d_down_s[d] += down
                self._fstate = {
                    "enabled": True,
                    "injected": {
                        "drive_fail": f_inj[DRIVE_FAIL],
                        "drive_recover": f_inj[DRIVE_RECOVER],
                        "stall": f_inj[STALL_BEGIN],
                        "cpu_crash": f_inj[CPU_CRASH],
                        "cpu_recover": f_inj[CPU_RECOVER],
                        "cpu_crash_skipped": f_cpu_skip,
                        "backing_fetch_failures": f_back_fail,
                    },
                    "lost": f_lost,
                    "retries": {"scheduled": f_retry_sched,
                                "redispatched": f_redisp,
                                "budget_denied": f_budget_deny},
                    "abandoned": f_aband,
                    "deadline_abandoned": t_dead,
                    "rejected": ov_rej,
                    "shed": ov_shed,
                    "degraded": f_degraded,
                    "detect_hedges": f_detect,
                    "unavailability": {"per_drive_s": list(d_down_s),
                                       "total_s": sum(d_down_s)},
                    "repair": {"bytes": rep_bytes, "seconds": rep_s,
                               "jobs": rep_jobs, "objects": rep_objs},
                    "goodput": {"offered": n, "completed": completed,
                                "goodput_frac": (completed / n
                                                 if n else 0.0)},
                }
                for nm2, v2 in (("fault_lost", f_lost),
                                ("fault_retries", f_retry_sched),
                                ("fault_abandoned", f_aband),
                                ("fault_degraded", f_degraded),
                                ("fault_detect_hedges", f_detect),
                                ("repair_bytes", rep_bytes),
                                ("repair_s", rep_s)):
                    if v2:
                        self.telemetry.inc(nm2, v2)
            else:
                self._fstate = {
                    "enabled": False,
                    "abandoned": 0,
                    "deadline_abandoned": t_dead,
                    "rejected": ov_rej,
                    "shed": ov_shed,
                    "goodput": {"offered": n, "completed": completed,
                                "goodput_frac": (completed / n
                                                 if n else 0.0)},
                }
            if t_dead:
                self.telemetry.inc("deadline_abandoned", t_dead)

        # -- overload-control telemetry --------------------------------------
        if ov_on:
            if bro_active:
                bro_ivals.append((bro_since, end_t))
            self._ovstate = {
                "enabled": True,
                "admitted": ov_admitted,
                "rejected": ov_rej,
                "shed": ov_shed,
                "copies_cancelled": ov_cc,
                "rejected_by": {"pushback": ov_rej_push,
                                "admission": ov_rej_adm},
                "shed_by": {"bounded": ov_shed_by[0],
                            "hopeless": ov_shed_by[1],
                            "codel": ov_shed_by[2]},
                "per_class": {
                    "accel": {"admitted": ov_adm_cls[0],
                              "rejected": ov_rej_cls[0],
                              "shed": ov_shed_cls[0]},
                    "plain": {"admitted": ov_adm_cls[1],
                              "rejected": ov_rej_cls[1],
                              "shed": ov_shed_cls[1]},
                },
                "per_tenant": ({
                    "names": [ten.name for ten in tenants],
                    "admitted": ov_ten_adm,
                    "rejected": ov_ten_rej,
                    "shed": ov_ten_shed,
                } if mt else None),
                "retries_denied": ov_retry_deny,
                "hedges_suppressed": ov_hedge_sup,
                "brownout": {"entered": bro_entered,
                             "active_epochs": bro_ep_act,
                             "intervals": bro_ivals},
                "pushback": {"timeline": push_tl, "final": push_f},
                "epochs": ov_epochs,
                "goodput": {"offered": n, "completed": completed,
                            "goodput_frac": (completed / n
                                             if n else 0.0)},
            }
            for nm2, v2 in (("overload_rejected", ov_rej),
                            ("overload_shed", ov_shed),
                            ("overload_retries_denied", ov_retry_deny),
                            ("overload_hedges_suppressed", ov_hedge_sup)):
                if v2:
                    self.telemetry.inc(nm2, v2)

        # -- per-tenant telemetry (finalized to the common horizon) ----------
        if mt:
            for k in range(K):
                tqa_d[k] += tqd_d[k] * (end_t - tql_d[k]); tql_d[k] = end_t
                tqa_c[k] += tqd_c[k] * (end_t - tql_c[k]); tql_c[k] = end_t
            hz = end_t
            self._tstate = {
                "horizon": hz,
                "scheduler": sched.name,
                "names": [ten.name for ten in tenants],
                "sla_s": [ten.sla_s for ten in tenants],
                "weight": [ten.weight for ten in tenants],
                "arrivals": tarr,
                "completions": tdone,
                "busy_dscs_s": tb_d,
                "busy_cpu_s": tb_c,
                "queue": {
                    "dscs": {"mean_depth": [a / hz if hz > 0 else 0.0
                                            for a in tqa_d],
                             "max_depth": [float(v) for v in tqm_d]},
                    "cpu": {"mean_depth": [a / hz if hz > 0 else 0.0
                                           for a in tqa_c],
                            "max_depth": [float(v) for v in tqm_c]},
                },
                "switch_overhead_s": t_switch_s,
                "reclaimed_dscs_s": rec_d,
                "reclaimed_cpu_s": rec_c,
            }
        else:
            self._tstate = None

        # -- tiered data-layer telemetry -------------------------------------
        if tier_on:
            cs = [c.stats() for c in caches] if caches is not None else []
            hits = sum(s["hits"] for s in cs)
            misses = sum(s["misses"] for s in cs)
            self._tierstate = {
                "replication_k": t_k,
                "n_objects": t_nobj if t_nobj else n,
                "cache_bytes": tier.cache_bytes,
                "cache": {
                    "hits": hits, "misses": misses,
                    "hit_rate": (hits / (hits + misses)
                                 if hits + misses else 0.0),
                    "evictions": sum(s["evictions"] for s in cs),
                    "per_drive": cs,
                },
                "backing_fetches": t_fill,
                "backing_s": fill_s,
                "migration": (None if mig is None else
                              {"moves": mig.moves, "epochs": mig.epochs,
                               "log": list(mig.log)}),
            }
            for nm, v in (("cache_hits", hits), ("cache_misses", misses),
                          ("backing_fetches", t_fill),
                          ("backing_fetch_s", fill_s),
                          ("migration_moves",
                           0 if mig is None else mig.moves)):
                if v:
                    self.telemetry.inc(nm, v)

        # -- flush telemetry -------------------------------------------------
        inc = self.telemetry.inc
        for name, v in (("dscs_dispatch", t_ddisp), ("cpu_dispatch", t_cdisp),
                        ("hedge_issued", t_hedge), ("dscs_fallback", t_hedge),
                        ("hedge_won_dscs", t_won_d), ("hedge_won_cpu", t_won_c),
                        ("dscs_served", t_srv_d), ("cpu_served", t_srv_c),
                        ("cancelled_in_queue", t_can_q),
                        ("cancelled_in_service", t_can_s),
                        ("tombstones_discarded", t_tomb),
                        ("reclaimed_dscs_s", rec_d),
                        ("reclaimed_cpu_s", rec_c),
                        ("ts_switch_overhead_s", t_switch_s),
                        ("ts_preemptions", t_pre)):
            if v:
                inc(name, v)

        # queue telemetry, finalized to the common end-of-run horizon
        self._qstate = {"horizon": end_t,
                        "dscs": (d_area, d_maxd), "cpu": (c_area, c_maxd),
                        "tombstones_discarded": t_tomb,
                        "cancelled_in_queue": t_can_q}

        # -- assemble the trace ---------------------------------------------
        def as_np(a: array) -> np.ndarray:
            return (np.frombuffer(a, dtype=np.float64) if n
                    else np.empty(0, dtype=np.float64))

        winner_np = np.array(winner_l, dtype=np.int8)
        drive_np = np.array(drive_l, dtype=np.int32)
        dscs_won = winner_np == 0
        return EngineTrace(
            arrival=times, finish=as_np(finish_a), winner=winner_np,
            drive=np.where(dscs_won, drive_np, -1).astype(np.int32),
            start=np.where(dscs_won, as_np(d_start_a), as_np(c_start_a)),
            service=np.where(dscs_won, as_np(d_svc_a), as_np(c_svc_a)),
            hedged=np.array(hedged_l, dtype=bool),
            dscs_finish=as_np(dfin_a), cpu_finish=as_np(cfin_a),
            events=events,
            tenant=(src if mt else np.zeros(n, dtype=np.int32)))

    # -- sharded execution ---------------------------------------------------
    def run_sharded(self, pipelines: Optional[Sequence[Pipeline]] = None, *,
                    arrivals: Optional[ArrivalProcess] = None,
                    duration_s: float = 0.0,
                    times: Optional[np.ndarray] = None,
                    n_shards: int = 1,
                    processes: Optional[int] = None,
                    timeout_s: Optional[float] = None,
                    epoch_count: int = 64,
                    mailbox_capacity: Optional[int] = None,
                    backend: str = DEFAULT_BACKEND,
                    overload: Optional[OverloadControl] = None
                    ) -> EngineTrace:
        """Run the fleet sharded by drive partition across workers.

        ``n_shards=1`` runs the classic event loop — byte-for-byte the
        same trace :meth:`run_soa` produces (the golden-trace stream).
        With ``n_shards >= 2`` the fleet is split into disjoint drive
        partitions (plus weighted CPU slices) executed by
        :mod:`repro_torch.core.sharding`: shard-count- and process-count-
        independent on the fault-free fast path, shard-isolated classic
        loops under faults/tiering/deadlines.  ``processes`` bounds the
        worker pool (default: one per shard up to the core count;
        ``processes=1`` runs the shards serially in-process with
        identical results).  ``epoch_count`` and ``mailbox_capacity``
        tune the bounded cross-shard mailbox.  Multi-tenant runs are not
        supported sharded — use ``n_shards=1``.  ``backend`` selects the
        fast path's Lindley solver (``segmented``/``torch``/``cuda``/
        ``dense``, see :mod:`repro_torch.core.lindley` — all bit-identical;
        ``cuda``, the default, needs a card and ``processes=1``;
        ``n_shards=1`` and the shard-isolated fallback run the classic
        event loop and ignore it).
        """
        if n_shards == 1:
            return self.run_soa(pipelines, arrivals=arrivals,
                                duration_s=duration_s, times=times,
                                timeout_s=timeout_s, overload=overload)
        from repro_torch.core.sharding import run_partitioned
        return run_partitioned(self, pipelines, arrivals=arrivals,
                               duration_s=duration_s, times=times,
                               n_shards=n_shards, processes=processes,
                               timeout_s=timeout_s, epoch_count=epoch_count,
                               mailbox_capacity=mailbox_capacity,
                               backend=backend, overload=overload)

    # -- telemetry -----------------------------------------------------------
    def queue_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class queue-depth telemetry from the last run.

        Every server is finalized to the *common* end-of-run horizon (the
        time of the last event anywhere in the fleet), so servers of a
        class that idled early no longer skew ``mean_depth``.  A drained
        server holds depth 0 after its last event, so its depth integral is
        already complete; the shared horizon only fixes the denominator.
        """
        empty = {"max_depth": 0.0, "mean_depth": 0.0}
        if self._qstate is None:
            return {"dscs": dict(empty), "cpu": dict(empty)}
        horizon = self._qstate["horizon"]

        def summarize(area: List[float], maxd: List[int]) -> Dict[str, float]:
            if not area:
                return dict(empty)
            mean = sum(area) / (horizon * len(area)) if horizon > 0 else 0.0
            return {"max_depth": float(max(maxd)), "mean_depth": float(mean)}

        return {"dscs": summarize(*self._qstate["dscs"]),
                "cpu": summarize(*self._qstate["cpu"])}

    def power_stats(self) -> Dict[str, object]:
        """Busy/powered server-seconds per class from the last run.

        ``busy_s`` sums every started copy's service time (including
        run-to-completion hedge losers — they occupy their server);
        ``powered_s`` sums each server's powered-on intervals, clipped to
        the common end-of-run horizon.  Without an autoscaling controller
        the whole provisioned fleet is powered for the whole run, so
        ``powered_s = horizon * n``.  :mod:`repro_torch.core.autoscale` turns
        these into fleet energy and cost.
        """
        if self._pstate is None:
            zero = {"busy_s": 0.0, "powered_s": 0.0, "n": 0}
            return {"horizon": 0.0, "dscs": dict(zero), "cpu": dict(zero),
                    "wake_events": 0, "epochs": 0}
        return self._pstate

    def tier_stats(self) -> Optional[Dict[str, object]]:
        """Tiered data-layer telemetry from the last run (``None`` when the
        tier was absent or disabled).

        Keys: ``replication_k`` (effective factor), ``n_objects``,
        ``cache_bytes``; ``cache`` with aggregate ``hits``/``misses``/
        ``hit_rate``/``evictions`` plus ``per_drive`` stat dicts;
        ``backing_fetches``/``backing_s`` (lazy replica + migration fills
        from the remote backing store); and ``migration`` (``None`` without
        a controller, else its ``moves``/``epochs`` counters and the
        ``(t, obj, from, to)`` move ``log``).
        """
        return self._tierstate

    def fault_stats(self) -> Optional[Dict[str, object]]:
        """Fault-injection & recovery telemetry from the last run
        (``None`` when neither a :class:`~repro_torch.core.faults.FaultPlan`
        nor a ``timeout_s`` deadline was configured).

        With a plan: ``injected`` (timeline events applied per kind, plus
        ``cpu_crash_skipped`` last-live-node vetoes and
        ``backing_fetch_failures``), ``lost`` (copies killed with no
        sibling copy racing), ``retries``
        (``scheduled``/``redispatched``/``budget_denied``), ``abandoned``
        (retry-path give-ups), ``deadline_abandoned``, ``degraded``
        (requests served CPU + backing fetch because no live drive held
        their object), ``detect_hedges`` (watchdog-issued CPU copies),
        ``unavailability`` (``per_drive_s`` down-seconds clipped to the
        horizon and their ``total_s``), ``repair``
        (``bytes``/``seconds``/``jobs``/``objects`` re-replicated), and
        ``goodput`` (``offered``/``completed``/``goodput_frac``).  With
        only ``timeout_s`` (or an overload layer), the dict carries
        ``abandoned``/``deadline_abandoned``/``rejected``/``shed`` and
        ``goodput``.
        """
        return self._fstate

    def overload_stats(self) -> Optional[Dict[str, object]]:
        """Overload-control telemetry from the last run (``None`` when no
        :class:`~repro_torch.core.overload.OverloadControl` was active).

        Keys: ``admitted``/``rejected``/``shed`` request counts with
        ``rejected_by`` (``pushback``/``admission``) and ``shed_by``
        (``bounded``/``hopeless``/``codel``) breakdowns;
        ``copies_cancelled`` (copy-level sheds whose request survived on a
        sibling copy); ``per_class`` (accel/plain) and ``per_tenant``
        books; ``retries_denied`` (retry attempts refused by the admission
        gate) and ``hedges_suppressed`` (hedge timers swallowed by
        brownout); ``brownout`` (``entered``/``active_epochs`` and the
        ``(start, stop)`` ``intervals``); ``pushback`` (the ``(t, factor)``
        change ``timeline`` — replayable open-loop through
        :class:`~repro_torch.core.overload.ThrottledArrivals` — and the
        ``final`` factor); ``epochs``; and ``goodput``.
        """
        return self._ovstate

    def tenant_stats(self) -> Optional[Dict[str, object]]:
        """Per-tenant telemetry from the last multi-tenant run (``None``
        after single-tenant runs).

        Keys: ``horizon`` (common end-of-run time every depth integral is
        finalized to), ``scheduler``, and per-tenant parallel lists
        indexed by tenant — ``names``/``sla_s``/``weight`` echo the specs;
        ``arrivals``/``completions`` are request counts;
        ``busy_dscs_s``/``busy_cpu_s`` are consumed service-seconds per
        class (time-slice context-switch overhead is charged to the
        incoming tenant); ``queue`` holds per-class
        ``mean_depth``/``max_depth`` of the tenant's live queued copies
        fleet-wide (mean is the depth integral over the common horizon).
        ``switch_overhead_s`` and ``reclaimed_dscs_s``/``reclaimed_cpu_s``
        are run-level scalars.
        """
        return self._tstate
