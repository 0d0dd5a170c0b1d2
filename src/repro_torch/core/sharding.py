"""Sharded fleet execution: partition the drive fleet across workers.

The classic engine (:meth:`ClusterEngine.run_soa`) is one event loop over
the whole fleet, which caps fleet-scale studies around ~10^5 req/s of
simulated throughput.  This module shards a run **by drive partition**:

* Each shard owns a contiguous, disjoint drive range plus a slice of the
  CPU fallback pool weighted by its drive share (every shard keeps at
  least one CPU node).  :class:`ShardPlan` pins the partition.
* Arrivals are split by the data-placement hash: request ``i`` belongs to
  the shard owning drive ``_placement(n_dscs, i)`` — the same memoized
  SHA-1 spread the classic engine dispatches on, so the per-request
  ``drive`` column is identical to the classic engine's.
* CPU copies (non-acceleratable requests and hedge fallbacks) are routed
  by a second consistent hash into the CPU block *derived from the
  request's drive*, so almost all CPU traffic stays shard-local; copies
  whose node lands in another shard's slice cross through a **bounded
  mailbox drained at epoch boundaries** (:class:`ShardMailbox`), counted
  in telemetry as ``shard_cpu_spillover`` / ``shard_cross_hedges``.
* Per-shard :class:`numpy.random.SeedSequence` children (spawned at
  stable indices ``4 + shard``) keep every shard bit-reproducible; the
  arrival stream and the pipeline-pick stream come from the same children
  (0, 1) the classic engine uses, so sharded runs simulate the same
  arrivals and the same accelerate/fallback mix.

Two execution paths, selected automatically:

**Partitioned fast path** (single-tenant, fault-free, tier-off, no
timeout): service times are materialized *per request* from the engine's
quantile-inversion transform (child 1, the classic pick/service stream),
and each shard solves its drives' FCFS queues with a vectorized Lindley
recursion; hedged CPU copies race per-node FCFS queues the same way.
Results are **independent of the shard count and of the process count**
— ``n_shards=2`` and ``n_shards=8``, serial or multiprocess, produce
byte-identical traces and telemetry — which is the property the
differential harness in ``tests/test_sharding.py`` gates.  Documented
deltas versus the classic event loop (which consumes service draws in
global event order and routes CPU copies to the least-loaded node):
per-request draws, consistent-hash CPU routing, and hedge losers running
to completion without queue-tombstone feedback.  On a single drive with
no hedging the two models coincide draw-for-draw.

**Shard-isolated fallback** (faults, tiering, a deadline, or overload
control): each shard
runs the full classic event loop on its own sub-fleet — tier replica
sets are built shard-local over the shard's drives and fault timelines
are drawn from the shard's own seed child, so no routing ever crosses a
shard boundary.  Aggregate conservation (``arrivals == completed +
abandoned``) and per-class busy-second caps hold exactly; per-request
timings are defined by the shard-local dynamics.

``ClusterEngine.run_sharded(n_shards=1)`` bypasses all of this and runs
the classic loop — byte-for-byte the golden-trace stream.
"""
from __future__ import annotations

import math
import multiprocessing as mp
import os
import warnings
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import lindley
from repro_torch.core.faults import merge_fault_stats
from repro_torch.core.function import Pipeline, is_acceleratable
from repro_torch.core.overload import TokenBucket, merge_overload_stats
from repro_torch.core.platforms import CPU_FALLBACK_PLATFORM, DSCS_PLATFORM
from repro_torch.core.tiering import merge_tier_stats

__all__ = ["MailboxOverflow", "ShardMailbox", "ShardPlan", "cpu_affinity",
           "run_partitioned"]


# -- partition plan ----------------------------------------------------------
@dataclass(frozen=True)
class ShardPlan:
    """A drive/CPU partition of the fleet plus per-shard seeds.

    ``drive_bounds``/``cpu_bounds`` are ``n_shards + 1`` fenceposts:
    shard ``s`` owns drives ``[drive_bounds[s], drive_bounds[s+1])`` and
    CPU nodes ``[cpu_bounds[s], cpu_bounds[s+1])``.  The CPU slice is
    weighted by the shard's drive share and never empty.  ``shard_seeds``
    are derived from stable SeedSequence children ``4 + s`` of the engine
    seed (children 0–3 are the classic engine's arrival / pick-service /
    tier / fault streams), so adding shards never perturbs the streams
    any other component draws.
    """
    n_dscs: int
    n_cpu: int
    n_shards: int
    seed: int
    drive_bounds: Tuple[int, ...]
    cpu_bounds: Tuple[int, ...]
    shard_seeds: Tuple[int, ...]

    @classmethod
    def build(cls, n_dscs: int, n_cpu: int, n_shards: int,
              seed: int) -> "ShardPlan":
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if n_shards > n_dscs:
            raise ValueError(f"n_shards={n_shards} exceeds n_dscs={n_dscs}: "
                             "every shard needs at least one drive")
        if n_shards > n_cpu:
            raise ValueError(f"n_shards={n_shards} exceeds n_cpu={n_cpu}: "
                             "every shard needs at least one CPU node")
        k = n_shards
        db = [(s * n_dscs) // k for s in range(k + 1)]
        # CPU fenceposts track the drive share, then a monotone fix-up
        # guarantees >= 1 node per shard (k <= n_cpu makes this feasible)
        cb = [(db[s] * n_cpu) // n_dscs for s in range(k + 1)]
        cb[k] = n_cpu
        for s in range(1, k + 1):
            if cb[s] <= cb[s - 1]:
                cb[s] = cb[s - 1] + 1
        for s in range(k - 1, 0, -1):
            if cb[s] > n_cpu - (k - s):
                cb[s] = n_cpu - (k - s)
        kids = np.random.SeedSequence(seed).spawn(4 + k)[4:]
        seeds = tuple(int(c.generate_state(1, np.uint64)[0]) for c in kids)
        return cls(n_dscs=n_dscs, n_cpu=n_cpu, n_shards=k, seed=seed,
                   drive_bounds=tuple(db), cpu_bounds=tuple(cb),
                   shard_seeds=seeds)

    def shard_of_drive(self, drives: np.ndarray) -> np.ndarray:
        """Owning shard id for each drive index (vectorized)."""
        return (np.searchsorted(np.asarray(self.drive_bounds), drives,
                                side="right") - 1).astype(np.int32)

    def shard_of_cpu(self, nodes: np.ndarray) -> np.ndarray:
        """Owning shard id for each CPU node index (vectorized)."""
        return (np.searchsorted(np.asarray(self.cpu_bounds), nodes,
                                side="right") - 1).astype(np.int32)


# -- consistent-hash CPU routing ---------------------------------------------
# Vectorized splitmix64 finalizer over the request id: a fixed
# deterministic map (never reseeded), so the routed node is
# k-independent and the per-node CPU queues decompose the same way the
# per-drive queues do.  Unlike the placement table this hash is private
# to the sharded path, so it can use a numpy-wide mixer instead of the
# per-request SHA-1 the placement cache pays.
def _cpu_hash(n: int) -> np.ndarray:
    z = (np.arange(n, dtype=np.uint64)
         + np.uint64(0x9E3779B97F4A7C15)) * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


def cpu_affinity(n_dscs: int, n_cpu: int, n: int) -> np.ndarray:
    """Per-request CPU fallback node: a consistent hash into the CPU
    block derived from the request's placement drive.

    Drive ``d`` maps to nodes ``[d*nc//nd, (d+1)*nc//nd)`` (or the single
    node ``min(nc-1, d*nc//nd)`` when the fleet has more drives than CPU
    nodes), so CPU traffic stays near its shard; the result depends only
    on ``(n_dscs, n_cpu, i)``, never on the shard count.
    """
    from repro_torch.core.engine import _placement
    d = _placement(n_dscs, n).astype(np.int64)
    lo = (d * n_cpu) // n_dscs
    hi = ((d + 1) * n_cpu) // n_dscs
    width = np.maximum(hi - lo, 1)
    np.minimum(lo, n_cpu - 1, out=lo)
    return (lo + (_cpu_hash(n) % width.astype(np.uint64)).astype(np.int64)
            ).astype(np.int32)


# -- bounded epoch mailbox ---------------------------------------------------
class MailboxOverflow(RuntimeError):
    """Raised when outstanding cross-phase messages exceed the mailbox
    capacity before the destination shard drains its epoch buckets."""


class ShardMailbox:
    """Bounded per-destination mailbox, drained at epoch boundaries.

    Shards never share queues directly: the drive phase posts CPU-copy
    batches ``(rids, dispatch_t, node)`` keyed by ``(dst_shard, epoch)``,
    and the CPU phase drains its buckets in epoch order before solving
    its node queues.  ``capacity`` bounds the total outstanding messages
    (posted, not yet drained); exceeding it raises
    :class:`MailboxOverflow`.  Counters: ``posted`` (messages routed),
    ``cross_shard`` (messages whose source and destination differ),
    ``max_outstanding`` (high-water mark).
    """

    def __init__(self, n_shards: int, capacity: int):
        self.capacity = int(capacity)
        self._box: List[Dict[int, list]] = [{} for _ in range(n_shards)]
        self.posted = 0
        self.cross_shard = 0
        self.outstanding = 0
        self.max_outstanding = 0

    def post(self, src: int, dst: int, epoch: int, rids: np.ndarray,
             disp: np.ndarray, node: np.ndarray) -> None:
        m = int(rids.size)
        if not m:
            return
        self.posted += m
        self.outstanding += m
        if self.outstanding > self.max_outstanding:
            self.max_outstanding = self.outstanding
        if self.outstanding > self.capacity:
            raise MailboxOverflow(
                f"{self.outstanding} outstanding messages exceed the "
                f"mailbox capacity {self.capacity}; raise "
                f"mailbox_capacity= or epoch_count=")
        if src != dst:
            self.cross_shard += m
        self._box[dst].setdefault(epoch, []).append((rids, disp, node))

    def drain(self, dst: int) -> List[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
        """All batches destined to ``dst``, concatenated per epoch, in
        epoch order; the buckets are emptied."""
        box = self._box[dst]
        out = []
        for ep in sorted(box):
            batches = box.pop(ep)
            rids = np.concatenate([b[0] for b in batches])
            disp = np.concatenate([b[1] for b in batches])
            node = np.concatenate([b[2] for b in batches])
            self.outstanding -= int(rids.size)
            out.append((rids, disp, node))
        return out


# -- per-request tables (the partitioned fast path's sampling) ---------------
def _erfinv_vec(x: np.ndarray) -> np.ndarray:
    a = 0.147
    ln = np.log(1.0 - x * x)
    t = 2.0 / (math.pi * a) + ln / 2.0
    return np.copysign(np.sqrt(np.sqrt(t * t - ln / a) - t), x)


def _build_tables(engine, pipelines: Sequence[Pipeline],
                  times: np.ndarray) -> dict:
    """Materialize the per-request columns every shard slices.

    Picks come from SeedSequence child 1 exactly like the classic engine
    (same stream, same values), then the *same* generator supplies 2n
    uniform draws through the sampler's erfinv/lognormal transform:
    positions ``[0, n)`` are the DSCS-copy tails, ``[n, 2n)`` the
    CPU-copy tails.  The classic engine consumes the identical stream in
    event order instead of request order — on a single drive with no
    hedging the orders coincide and the service columns are bit-equal.

    The uniform stream is consumed in bounded chunks (sequential
    ``Generator.uniform`` calls concatenate to the same stream as one
    call, pinned by a test) so the erfinv/exp temporaries never
    materialize at full 2n length — at 10^7 requests that alone drops
    ~0.6 GB of transient peak.
    """
    n = int(times.size)
    nd, nc = engine.n_dscs, engine.n_cpu
    rng = np.random.default_rng(np.random.SeedSequence(engine.seed).spawn(2)[1])
    picks = (rng.integers(len(pipelines), size=n) if n
             else np.empty(0, dtype=np.int64))
    sampler = engine._sampler
    coef_d = np.array([sampler.coef(p.workload, DSCS_PLATFORM)
                       for p in pipelines])
    coef_c = np.array([sampler.coef(p.workload, CPU_FALLBACK_PLATFORM)
                       for p in pipelines])
    rs, ws = engine.lm.params.read_sigma, engine.lm.params.write_sigma
    chunk = 1 << 20

    def _service(coef: np.ndarray) -> np.ndarray:
        # consumes the next n uniforms; element-wise math is unchanged,
        # so chunking is invisible to the output bits
        out = np.empty(n)
        for a in range(0, n, chunk):
            u = rng.uniform(size=min(chunk, n - a))
            np.clip(u, 1e-4, 1.0 - 1e-4, out=u)
            z = math.sqrt(2.0) * _erfinv_vec(2.0 * u - 1.0)
            pk = picks[a:a + u.size]
            out[a:a + u.size] = (coef[pk, 0] + coef[pk, 1] * np.exp(rs * z)
                                 + coef[pk, 2] * np.exp(ws * z))
        return out

    svc_d = _service(coef_d)
    svc_c = _service(coef_c)
    accel_pipe = np.array([nd > 0 and is_acceleratable(p) for p in pipelines],
                          dtype=bool)
    from repro_torch.core.engine import _placement
    accel = accel_pipe[picks] if n else np.empty(0, dtype=bool)
    drive = (_placement(nd, n).astype(np.int64) if n
             else np.empty(0, dtype=np.int64))
    # drive-sorted orders, computed once: each shard slices its own
    # contiguous block with two binary searches instead of scanning and
    # re-sorting the full request stream
    acc_idx = np.flatnonzero(accel)
    acc_order = acc_idx[np.argsort(drive[acc_idx], kind="stable")]
    na_idx = np.flatnonzero(~accel)
    na_order = na_idx[np.argsort(drive[na_idx], kind="stable")]
    return {"picks": picks, "svc_d": svc_d, "svc_c": svc_c,
            "accel": accel, "drive": drive, "cnode": cpu_affinity(nd, nc, n),
            "acc_order": acc_order, "acc_drive": drive[acc_order],
            "na_order": na_order, "na_drive": drive[na_order]}


# -- vectorized FCFS (Lindley recursion) -------------------------------------
def _fcfs_segment(t: np.ndarray, s: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Service start/finish for one FCFS single-server queue: arrivals
    ``t`` (sorted), service demands ``s``.  ``f_j = max_{i<=j}(t_i +
    sum(s_i..s_j))`` via cumsum + running max; the start is clamped to
    the arrival so idle starts are exact."""
    c = np.cumsum(s)
    prev = c - s
    m = np.maximum.accumulate(t - prev)
    start = np.maximum(t, m + prev)
    return start, start + s


def _queue_depth_max(start: np.ndarray, t: np.ndarray) -> int:
    """Max queued-copy depth of one FCFS queue, sampled at arrivals
    (depth only grows at an arrival).  The classic engine pins max_depth
    >= 1 whenever the server dispatched at all."""
    m = int(t.size)
    if not m:
        return 0
    depth = np.arange(1, m + 1) - np.searchsorted(start, t, side="right")
    return max(int(depth.max()), 1)


def _grouped_fcfs(keys: np.ndarray, lo: int, hi: int, t: np.ndarray,
                  s: np.ndarray, start: np.ndarray, fin: np.ndarray,
                  backend: str = lindley.DEFAULT_BACKEND
                  ) -> Tuple[List[float], List[float], List[int]]:
    """Solve every server's FCFS queue for rows sorted by ``keys``
    (server ids in ``[lo, hi)``): `_fcfs_segment` batched over all
    servers at once through :mod:`repro_torch.core.lindley` (length-bucketed
    scan on the card's fp64 kernel by default; ``backend`` selects the
    numpy or plain-PyTorch scan or the legacy padded-dense layout — all
    bit-identical).  Fills
    ``start``/``fin`` in place and returns per-server (busy_s,
    queue-area, max-depth) lists."""
    nserv = hi - lo
    if not t.size:
        return [0.0] * nserv, [0.0] * nserv, [0] * nserv
    seg = lindley.segment_fenceposts(keys, lo, hi)
    lindley.solve_segments(seg, t, s, start, fin, backend=backend)
    lens = np.diff(seg)
    rows = np.repeat(np.arange(nserv), lens)
    busy = np.bincount(rows, weights=s, minlength=nserv).tolist()
    area = np.bincount(rows, weights=start - t, minlength=nserv).tolist()
    maxd = lindley.queue_depth_max(seg, start, t)
    return busy, area, maxd


# -- fork-shared worker state ------------------------------------------------
# Workers are forked (Linux): the parent stashes the read-only tables
# here *before* creating the pool, so children see them copy-on-write
# and only the per-shard results travel back through pickling.
_FORK_STATE: Optional[dict] = None


def _iter_shards(fn, items, processes: int):
    """Yield ``fn(item)`` results in item order, lazily.

    Serial execution runs one shard at a time; the fork pool streams
    results back via ``imap`` (order-preserving).  Either way the caller
    can merge-and-free each shard's arrays while later shards are still
    being solved, so parent peak RSS holds one shard's result set, not
    the whole run's.
    """
    if processes <= 1:
        for x in items:
            yield fn(x)
        return
    ctx = mp.get_context("fork")
    with ctx.Pool(min(processes, len(items))) as pool:
        for res in pool.imap(fn, items):
            yield res


def _map_shards(fn, items, processes: int):
    return list(_iter_shards(fn, items, processes))


# -- partitioned fast path ---------------------------------------------------
def _drive_phase(s: int) -> dict:
    st = _FORK_STATE
    plan: ShardPlan = st["plan"]
    lo, hi = plan.drive_bounds[s], plan.drive_bounds[s + 1]
    times, svc_d = st["times"], st["tab"]["svc_d"]
    cnode = st["tab"]["cnode"]
    hedge = st["hedge"]

    a0, a1 = np.searchsorted(st["tab"]["acc_drive"], [lo, hi])
    order = st["tab"]["acc_order"][a0:a1]
    t = times[order]
    sv = svc_d[order]
    start = np.empty_like(t)
    fin = np.empty_like(t)
    busy, area, maxd = _grouped_fcfs(st["tab"]["acc_drive"][a0:a1], lo, hi,
                                     t, sv, start, fin,
                                     backend=st["backend"])

    # hedge decisions are a pure function of the drive-side wait (the
    # classic engine fires the hedge timer when the copy is still queued
    # at t + budget; timers win ties against finish events, hence >=)
    if hedge is not None and order.size:
        hm = (start - t) >= hedge
        h_rids = order[hm]
        h_disp = t[hm] + hedge
    else:
        h_rids = np.empty(0, dtype=np.int64)
        h_disp = np.empty(0, dtype=np.float64)

    n0, n1 = np.searchsorted(st["tab"]["na_drive"], [lo, hi])
    na = st["tab"]["na_order"][n0:n1]
    c_rids = np.concatenate([na, h_rids])
    c_disp = np.concatenate([times[na], h_disp])
    c_node = cnode[c_rids]

    # batch outgoing CPU copies by (destination shard, epoch)
    batches = []
    if c_rids.size:
        dest = plan.shard_of_cpu(c_node)
        epoch = np.minimum((c_disp / st["epoch_s"]).astype(np.int64),
                           st["epoch_count"] - 1)
        g = np.lexsort((epoch, dest))
        dest_g, epoch_g = dest[g], epoch[g]
        cut = np.flatnonzero(np.diff(dest_g) | np.diff(epoch_g))
        bounds = np.concatenate([[0], cut + 1, [dest_g.size]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            sel = g[a:b]
            batches.append((int(dest_g[a]), int(epoch_g[a]), c_rids[sel],
                            c_disp[sel], c_node[sel]))
    return {"rids": order, "start": start, "fin": fin,
            "busy": busy, "area": area, "maxd": maxd,
            "n_accel": int(order.size), "n_hedged": int(h_rids.size),
            "n_nonaccel": int(na.size), "batches": batches}


def _cpu_phase(args) -> dict:
    s, inbox = args
    st = _FORK_STATE
    plan: ShardPlan = st["plan"]
    clo, chi = plan.cpu_bounds[s], plan.cpu_bounds[s + 1]
    svc_c = st["tab"]["svc_c"]
    if inbox:
        rids = np.concatenate([b[0] for b in inbox])
        disp = np.concatenate([b[1] for b in inbox])
        node = np.concatenate([b[2] for b in inbox])
    else:
        rids = np.empty(0, dtype=np.int64)
        disp = np.empty(0, dtype=np.float64)
        node = np.empty(0, dtype=np.int32)
    # one deterministic total order per node, independent of the epoch
    # batching (epochs bound the transport, not the math)
    g = np.lexsort((rids, disp, node))
    rids, disp, node = rids[g], disp[g], node[g]
    sv = svc_c[rids]
    start = np.empty_like(disp)
    fin = np.empty_like(disp)
    busy, area, maxd = _grouped_fcfs(node, clo, chi, disp, sv, start, fin,
                                     backend=st["backend"])
    return {"rids": rids, "start": start, "fin": fin, "node": node,
            "busy": busy, "area": area, "maxd": maxd}


def _run_partitioned_pure(engine, pipelines, times, plan: ShardPlan,
                          processes: int, epoch_count: int,
                          mailbox_capacity: Optional[int],
                          backend: str = lindley.DEFAULT_BACKEND):
    from repro_torch.core.engine import EngineTrace
    global _FORK_STATE
    n = int(times.size)
    nd, nc = engine.n_dscs, engine.n_cpu
    k = plan.n_shards
    tab = _build_tables(engine, pipelines, times)
    hedge = engine.hedge_budget_s
    horizon_est = float(times[-1]) + (hedge or 0.0) + 1e-9 if n else 1.0
    _FORK_STATE = {"plan": plan, "times": times, "tab": tab, "hedge": hedge,
                   "epoch_s": horizon_est / epoch_count,
                   "epoch_count": epoch_count, "backend": backend}

    # -- solve + streaming merge ---------------------------------------------
    # Each shard's result is merged into the full-length columns and
    # freed as soon as it lands (results arrive in shard order), so the
    # parent never holds every shard's arrays at once.
    nan = math.nan
    d_start = np.full(n, nan)
    d_fin = np.full(n, nan)
    c_start = np.full(n, nan)
    c_fin = np.full(n, nan)
    hedged = np.zeros(n, dtype=bool)
    d_busy_l: List[float] = []
    d_area_l: List[float] = []
    d_maxd_l: List[int] = []
    c_busy_l: List[float] = []
    c_area_l: List[float] = []
    c_maxd_l: List[int] = []
    n_hedged = 0
    mailbox = ShardMailbox(
        k, mailbox_capacity if mailbox_capacity is not None
        else max(65536, 2 * n))
    try:
        for s, res in enumerate(_iter_shards(_drive_phase, list(range(k)),
                                             processes)):
            d_start[res["rids"]] = res["start"]
            d_fin[res["rids"]] = res["fin"]
            d_busy_l += res["busy"]
            d_area_l += res["area"]
            d_maxd_l += res["maxd"]
            n_hedged += res["n_hedged"]
            for dst, ep, rids, disp, node in res["batches"]:
                mailbox.post(s, dst, ep, rids, disp, node)
        for res in _iter_shards(_cpu_phase,
                                [(s, mailbox.drain(s)) for s in range(k)],
                                processes):
            c_start[res["rids"]] = res["start"]
            c_fin[res["rids"]] = res["fin"]
            c_busy_l += res["busy"]
            c_area_l += res["area"]
            c_maxd_l += res["maxd"]
    finally:
        _FORK_STATE = None
    accel, drive = tab["accel"], tab["drive"]
    hedged[accel & ~np.isnan(c_fin)] = True

    # the winner is the first finisher; the classic heap pops the DSCS
    # finish first on exact ties, hence <=
    winner = np.where(accel, np.int8(0), np.int8(1))
    raced = hedged & (c_fin < d_fin)
    winner[raced] = 1
    dscs_won = winner == 0
    finish = np.where(dscs_won, d_fin, c_fin)
    start = np.where(dscs_won, d_start, c_start)
    service = np.where(dscs_won, tab["svc_d"], tab["svc_c"])
    end_t = 0.0
    if n:
        end_t = float(max(np.nanmax(d_fin) if accel.any() else 0.0,
                          np.nanmax(c_fin) if (~dscs_won | hedged).any()
                          else 0.0))
    n_accel = int(np.count_nonzero(accel))
    n_nonaccel = n - n_accel
    n_copies = n_accel + n_nonaccel + n_hedged
    events = n + n_copies + (n_accel if hedge is not None else 0)

    # -- telemetry / stats, mirroring the classic finalization ---------------
    inc = engine.telemetry.inc
    won_d = int(np.count_nonzero(hedged & dscs_won))
    won_c = int(np.count_nonzero(hedged & ~dscs_won))
    for name, v in (("dscs_dispatch", n_accel), ("cpu_dispatch", n_nonaccel),
                    ("hedge_issued", n_hedged), ("dscs_fallback", n_hedged),
                    ("hedge_won_dscs", won_d), ("hedge_won_cpu", won_c),
                    ("dscs_served", n_accel - n_hedged),
                    ("cpu_served", n_nonaccel),
                    ("shard_mailbox_msgs", mailbox.posted),
                    ("shard_cpu_spillover", mailbox.cross_shard)):
        if v:
            inc(name, v)
    engine._qstate = {"horizon": end_t,
                      "dscs": (d_area_l, d_maxd_l),
                      "cpu": (c_area_l, c_maxd_l),
                      "tombstones_discarded": 0, "cancelled_in_queue": 0}
    engine._pstate = {"horizon": end_t,
                      "dscs": {"busy_s": float(sum(d_busy_l)),
                               "powered_s": end_t * nd, "n": nd},
                      "cpu": {"busy_s": float(sum(c_busy_l)),
                              "powered_s": end_t * nc, "n": nc},
                      "wake_events": 0, "epochs": 0}
    engine._tstate = None
    engine._fstate = None
    engine._tierstate = None
    engine._ovstate = None
    engine.last_shard_stats = {
        "n_shards": k, "processes": processes,
        "mailbox": {"posted": mailbox.posted,
                    "cross_shard": mailbox.cross_shard,
                    "max_outstanding": mailbox.max_outstanding,
                    "capacity": mailbox.capacity},
        "cross_shard_hedges": _cross_shard_hedges(plan, tab, hedged),
        "path": "partitioned"}

    return EngineTrace(
        arrival=times, finish=finish, winner=winner,
        drive=np.where(dscs_won, drive, -1).astype(np.int32),
        start=start, service=service, hedged=hedged,
        dscs_finish=d_fin, cpu_finish=c_fin, events=events,
        tenant=np.zeros(n, dtype=np.int32))


def _cross_shard_hedges(plan: ShardPlan, tab: dict,
                        hedged: np.ndarray) -> int:
    """Hedged requests whose CPU copy landed in another shard's slice."""
    h = np.flatnonzero(hedged)
    if not h.size:
        return 0
    src = plan.shard_of_drive(tab["drive"][h])
    dst = plan.shard_of_cpu(tab["cnode"][h])
    return int(np.count_nonzero(src != dst))


# -- shard-isolated fallback (faults / tiering / deadlines) ------------------
def _fallback_worker(s: int) -> dict:
    st = _FORK_STATE
    from repro_torch.core.engine import ClusterEngine
    plan: ShardPlan = st["plan"]
    lo, hi = plan.drive_bounds[s], plan.drive_bounds[s + 1]
    clo, chi = plan.cpu_bounds[s], plan.cpu_bounds[s + 1]
    rids = st["rids"][s]
    sub = ClusterEngine(
        n_dscs=hi - lo, n_cpu=chi - clo, latency_model=st["lm"],
        hedge_budget_s=st["hedge"], seed=plan.shard_seeds[s],
        n_plain=st["n_plain"], dscs_wake_s=st["dscs_wake_s"],
        preempt_losers=st["preempt_losers"], tier=st["tier"],
        faults=st["faults"], overload=st["overload"][s])
    tr = sub.run_soa(st["pipelines"], times=st["times"][rids],
                     timeout_s=st["timeout_s"])
    return {"trace": tr, "qstate": sub._qstate, "pstate": sub._pstate,
            "fstate": sub._fstate, "tierstate": sub._tierstate,
            "ovstate": sub._ovstate,
            "counters": dict(sub.telemetry.counters)}


def _shard_overload(ov, rids, n: int) -> list:
    """Per-shard overload configs for the isolated fallback: each shard
    runs its own control loop over its sub-fleet, so a fleet-wide
    :class:`TokenBucket` rate/burst is scaled by the shard's arrival
    share (depth-relative policies — thresholds, shedding, backpressure,
    brownout — carry over unchanged)."""
    if ov is None:
        return [None] * len(rids)
    out = []
    for ix in rids:
        adm = ov.admission
        if isinstance(adm, TokenBucket) and n:
            frac = len(ix) / n
            out.append(replace(ov, admission=replace(
                adm, rate=adm.rate * frac,
                burst=max(1.0, adm.burst * frac))))
        else:
            out.append(ov)
    return out


def _run_shard_isolated(engine, pipelines, times, plan: ShardPlan,
                        processes: int, timeout_s: Optional[float],
                        overload=None):
    from repro_torch.core.engine import EngineTrace, _placement
    global _FORK_STATE
    n = int(times.size)
    k = plan.n_shards
    owner = plan.shard_of_drive(_placement(engine.n_dscs, n)) if n else \
        np.empty(0, dtype=np.int32)
    rids = [np.flatnonzero(owner == s) for s in range(k)]
    _FORK_STATE = {
        "plan": plan, "times": times, "rids": rids, "pipelines": pipelines,
        "lm": engine.lm, "hedge": engine.hedge_budget_s,
        "n_plain": engine.n_plain, "dscs_wake_s": engine.dscs_wake_s,
        "preempt_losers": engine.preempt_losers, "tier": engine.tier,
        "faults": engine.faults, "timeout_s": timeout_s,
        "overload": _shard_overload(overload, rids, n)}
    try:
        results = _map_shards(_fallback_worker, list(range(k)), processes)
    finally:
        _FORK_STATE = None

    nan = math.nan
    finish = np.full(n, nan)
    winner = np.full(n, -1, dtype=np.int8)
    drive = np.full(n, -1, dtype=np.int32)
    start = np.zeros(n)
    service = np.zeros(n)
    hedged = np.zeros(n, dtype=bool)
    d_fin = np.full(n, nan)
    c_fin = np.full(n, nan)
    events = 0
    d_area: List[float] = []
    d_maxd: List[int] = []
    c_area: List[float] = []
    c_maxd: List[int] = []
    horizon = 0.0
    d_busy = c_busy = d_pow = c_pow = 0.0
    wake = epochs = tomb = can_q = 0
    counters: Dict[str, float] = {}
    for s, res in enumerate(results):
        tr = res["trace"]
        ix = rids[s]
        finish[ix] = tr.finish
        winner[ix] = tr.winner
        drv = tr.drive.astype(np.int32)
        drive[ix] = np.where(drv >= 0, drv + plan.drive_bounds[s], -1)
        start[ix] = tr.start
        service[ix] = tr.service
        hedged[ix] = tr.hedged
        d_fin[ix] = tr.dscs_finish
        c_fin[ix] = tr.cpu_finish
        events += tr.events
        qs, ps = res["qstate"], res["pstate"]
        horizon = max(horizon, qs["horizon"])
        d_area += qs["dscs"][0]
        d_maxd += qs["dscs"][1]
        c_area += qs["cpu"][0]
        c_maxd += qs["cpu"][1]
        tomb += qs["tombstones_discarded"]
        can_q += qs["cancelled_in_queue"]
        d_busy += ps["dscs"]["busy_s"]
        d_pow += ps["dscs"]["powered_s"]
        c_busy += ps["cpu"]["busy_s"]
        c_pow += ps["cpu"]["powered_s"]
        wake += ps["wake_events"]
        epochs += ps["epochs"]
        for name, v in res["counters"].items():
            counters[name] = counters.get(name, 0.0) + v
    for name, v in counters.items():
        if v:
            engine.telemetry.inc(name, v)
    engine._qstate = {"horizon": horizon, "dscs": (d_area, d_maxd),
                      "cpu": (c_area, c_maxd),
                      "tombstones_discarded": tomb,
                      "cancelled_in_queue": can_q}
    engine._pstate = {"horizon": horizon,
                      "dscs": {"busy_s": d_busy, "powered_s": d_pow,
                               "n": engine.n_dscs},
                      "cpu": {"busy_s": c_busy, "powered_s": c_pow,
                              "n": engine.n_cpu},
                      "wake_events": wake, "epochs": epochs}
    engine._tstate = None
    engine._fstate = merge_fault_stats(
        [res["fstate"] for res in results], offered=n)
    engine._tierstate = merge_tier_stats(
        [res["tierstate"] for res in results])
    engine._ovstate = merge_overload_stats(
        [res["ovstate"] for res in results])
    engine.last_shard_stats = {"n_shards": k, "processes": processes,
                               "mailbox": None, "cross_shard_hedges": 0,
                               "path": "shard-isolated"}
    return EngineTrace(
        arrival=times, finish=finish, winner=winner, drive=drive,
        start=start, service=service, hedged=hedged,
        dscs_finish=d_fin, cpu_finish=c_fin, events=events,
        tenant=np.zeros(n, dtype=np.int32))


# -- entry point -------------------------------------------------------------
def run_partitioned(engine, pipelines: Optional[Sequence[Pipeline]], *,
                    arrivals=None, duration_s: float = 0.0,
                    times: Optional[np.ndarray] = None, n_shards: int,
                    processes: Optional[int] = None,
                    timeout_s: Optional[float] = None,
                    epoch_count: int = 64,
                    mailbox_capacity: Optional[int] = None,
                    backend: str = lindley.DEFAULT_BACKEND,
                    overload=None):
    """Execute one sharded run (``n_shards >= 2``); see the module
    docstring for the two paths.  Called via
    :meth:`ClusterEngine.run_sharded`.

    ``backend`` picks the Lindley solver on the partitioned fast path
    (:data:`repro_torch.core.lindley.BACKENDS`: ``segmented``/``torch``/
    ``cuda``/``dense`` — all bit-identical; ``cuda``, the default, needs
    a card and runs the shards in this process, since the worker pool
    forks and CUDA cannot run in a child forked after it started); the
    shard-isolated fallback runs the classic event loop and ignores it —
    a non-default ``backend`` on a fallback run raises a ``UserWarning``
    so the solver knob never silently does nothing.

    ``overload`` (or the engine-level config) routes the run through the
    shard-isolated fallback; each shard runs its own control loop
    (fleet-wide :class:`TokenBucket` rates are scaled to the shard's
    arrival share) and the per-shard books merge through
    :func:`repro_torch.core.overload.merge_overload_stats`.
    """
    if pipelines is None or not len(pipelines):
        raise ValueError("run_sharded needs a non-empty pipelines list "
                         "(tenants= is not supported sharded; run them "
                         "with n_shards=1)")
    if epoch_count < 1:
        raise ValueError("epoch_count must be >= 1")
    if backend not in lindley.BACKENDS:
        raise ValueError(f"backend must be one of {lindley.BACKENDS}, "
                         f"got {backend!r}")
    plan = ShardPlan.build(engine.n_dscs, engine.n_cpu, n_shards, engine.seed)
    if processes is None:
        processes = (1 if backend == "cuda"
                     else min(n_shards, os.cpu_count() or 1))

    if times is None:
        if arrivals is None:
            raise ValueError("pass arrivals= or times=")
        if duration_s <= 0.0:
            raise ValueError("arrivals= needs a positive duration_s")
        # child 0, exactly like the classic engine's arrival stream
        arr_rng = np.random.default_rng(
            np.random.SeedSequence(engine.seed).spawn(1)[0])
        times = arrivals.times(duration_s, arr_rng)
    times = np.ascontiguousarray(np.asarray(times, dtype=np.float64))

    tier_on = engine.tier is not None and engine.tier.enabled
    ov = overload if overload is not None else engine.overload
    ov_on = ov is not None and ov.enabled
    if engine.faults is not None or tier_on or timeout_s is not None \
            or ov_on:
        if backend != lindley.DEFAULT_BACKEND:
            warnings.warn(
                f"backend={backend!r} has no effect: faults/tiering/"
                "deadline/overload runs take the shard-isolated fallback "
                "(the classic event loop), not the Lindley fast path",
                UserWarning, stacklevel=3)
        return _run_shard_isolated(engine, pipelines, times, plan,
                                   processes, timeout_s,
                                   overload=ov if ov_on else None)
    if backend == "cuda" and processes > 1:
        raise ValueError("backend='cuda' runs the shards in one process "
                         f"(processes=1), got processes={processes}: the "
                         "worker pool forks, and CUDA cannot run in a "
                         "forked child")
    return _run_partitioned_pure(engine, pipelines, times, plan, processes,
                                 epoch_count, mailbox_capacity, backend)
