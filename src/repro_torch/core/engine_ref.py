"""Frozen pre-PR2 reference engine (golden-trace oracle + perf baseline).

This module preserves the PR-1 object-based discrete-event hot path —
``_Event`` dataclass heap holding every arrival up front, ``_Req``/``_Copy``
per-request objects, ``list``-backed FCFS queues with O(n) ``pop(0)`` /
``remove`` cancellation, and the O(n_cpu) least-loaded scan — exactly as it
shipped, so that:

  * the golden-trace tests can prove the optimized array-backed engine in
    :mod:`repro_torch.core.engine` emits a bit-identical ``RequestResult`` stream
    seed-for-seed, and
  * ``benchmarks/bench_engine.py`` can measure real speedups against the
    pre-refactor baseline on any host.

The only change versus the shipped PR-1 code is that service-time draws go
through the shared :class:`repro_torch.core.engine._ServiceSampler` (chunked,
numpy-vectorized quantile inversion) instead of per-draw ``math.exp`` —
both engines consume the *same* pre-transformed tail multipliers in the
same order, which is what makes bit-exact equivalence well-defined across
libm/SIMD implementations.  Draw *order* and every other simulation
semantic are untouched.  Do not optimize this module; it is the baseline.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.arrivals import ArrivalProcess
from repro_torch.core.engine import (RequestResult, Telemetry,  # noqa: F401
                               _ServiceSampler)
from repro_torch.core.function import Pipeline
from repro_torch.core.latency import LatencyModel
from repro_torch.core.placement import StoragePool


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: object = field(compare=False, default=None)


class _Copy:
    """One issued execution path of a request (DSCS or CPU)."""
    __slots__ = ("req", "path", "node", "state", "start", "service")

    def __init__(self, req: "_Req", path: str, node: int):
        self.req = req
        self.path = path                # "dscs" | "cpu"
        self.node = node
        self.state = "queued"           # queued | running | done | cancelled
        self.start = 0.0
        self.service = 0.0


class _Req:
    __slots__ = ("rid", "arrival", "pipe", "accel", "drive", "copies",
                 "hedged", "result")

    def __init__(self, rid: int, arrival: float, pipe: Pipeline):
        self.rid = rid
        self.arrival = arrival
        self.pipe = pipe
        self.accel = False
        self.drive = -1
        self.copies: Dict[str, _Copy] = {}
        self.hedged = False
        self.result: Optional[RequestResult] = None


class _Server:
    """Single-server FCFS queue with time-weighted depth accounting."""
    __slots__ = ("queue", "running", "depth_area", "max_depth", "_last_t")

    def __init__(self):
        self.queue: List[_Copy] = []
        self.running: Optional[_Copy] = None
        self.depth_area = 0.0           # integral of queue depth over time
        self.max_depth = 0
        self._last_t = 0.0

    def _account(self, t: float) -> None:
        self.depth_area += len(self.queue) * (t - self._last_t)
        self._last_t = t

    def push(self, copy: _Copy, t: float) -> None:
        self._account(t)
        self.queue.append(copy)
        self.max_depth = max(self.max_depth, len(self.queue))

    def cancel_queued(self, copy: _Copy, t: float) -> None:
        self._account(t)
        self.queue.remove(copy)

    def pop(self, t: float) -> Optional[_Copy]:
        if self.running is not None or not self.queue:
            return None
        self._account(t)
        return self.queue.pop(0)

    @property
    def load(self) -> int:
        return len(self.queue) + (1 if self.running is not None else 0)


class ReferenceClusterEngine:
    """The frozen PR-1 discrete-event fleet: ``n_dscs`` DSCS drives with
    per-drive FCFS queues + ``n_cpu`` CPU fallback nodes, fed by an arrival
    process.  Object-per-request, eager arrival heap, O(n) queue ops."""

    def __init__(self, *, n_dscs: int, n_cpu: int,
                 latency_model: Optional[LatencyModel] = None,
                 hedge_budget_s: Optional[float] = None, seed: int = 0,
                 n_plain: int = 64,
                 telemetry: Optional[Telemetry] = None):
        if n_cpu <= 0:
            raise ValueError("the fleet needs at least one CPU fallback node")
        self.n_dscs = n_dscs
        self.n_cpu = n_cpu
        self.n_plain = n_plain
        self.lm = latency_model or LatencyModel(seed=seed)
        self.hedge_budget_s = hedge_budget_s
        self.seed = seed
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.drives: List[_Server] = []
        self.cpus: List[_Server] = []
        self._sampler = _ServiceSampler(self.lm)

    # -- main loop -----------------------------------------------------------
    def run(self, pipelines: List[Pipeline], *, arrivals: ArrivalProcess,
            duration_s: float) -> List[RequestResult]:
        """Simulate ``duration_s`` of offered load and drain every request;
        returns one ``RequestResult`` per arrival, in arrival order."""
        ss = np.random.SeedSequence(self.seed)
        arr_rng, rng = (np.random.default_rng(s) for s in ss.spawn(2))
        self._sampler.start(rng)
        pool = StoragePool(n_plain=self.n_plain, n_dscs=self.n_dscs)
        drive_idx = {d.drive_id: i for i, d in enumerate(pool.dscs_drives())}
        self.drives = [_Server() for _ in range(self.n_dscs)]
        self.cpus = [_Server() for _ in range(self.n_cpu)]

        heap: List[_Event] = []
        seq = 0

        def push(t: float, kind: str, payload) -> None:
            nonlocal seq
            seq += 1
            heapq.heappush(heap, _Event(t, seq, kind, payload))

        times = arrivals.times(duration_s, arr_rng)
        reqs: List[_Req] = []
        for rid, t in enumerate(map(float, times)):
            pipe = pipelines[int(rng.integers(len(pipelines)))]
            reqs.append(_Req(rid, t, pipe))
            push(t, "arrival", reqs[-1])

        while heap:
            ev = heapq.heappop(heap)
            if ev.kind == "arrival":
                self._on_arrival(ev.payload, ev.time, pool, drive_idx,
                                 rng, push)
            elif ev.kind == "hedge":
                self._on_hedge(ev.payload, ev.time, rng, push)
            else:                       # finish
                self._on_finish(ev.payload, ev.time, rng, push)

        return [r.result for r in reqs]

    # -- event handlers ------------------------------------------------------
    def _on_arrival(self, req: _Req, t: float, pool: StoragePool,
                    drive_idx: Dict[int, int], rng, push) -> None:
        req.accel = (self.n_dscs > 0
                     and all(f.acceleratable for f in req.pipe.functions[:2]))
        if req.accel:
            # data-aware placement: the payload is written to an
            # Acceleratable_Storage drive at arrival; the request is then
            # dispatched to the drive that holds it.
            drive = pool.place(f"req-{req.rid}", req.pipe.workload.request_bytes,
                               "Acceleratable_Storage")
            req.drive = drive_idx[drive.drive_id]
            copy = _Copy(req, "dscs", req.drive)
            req.copies["dscs"] = copy
            self.drives[req.drive].push(copy, t)
            self.telemetry.inc("dscs_dispatch")
            if self.hedge_budget_s is not None:
                push(t + self.hedge_budget_s, "hedge", req)
            self._maybe_start(self.drives[req.drive], t, rng, push)
        else:
            self._issue_cpu(req, t, rng, push)
            self.telemetry.inc("cpu_dispatch")

    def _issue_cpu(self, req: _Req, t: float, rng, push) -> None:
        node = min(range(self.n_cpu), key=lambda i: (self.cpus[i].load, i))
        copy = _Copy(req, "cpu", node)
        req.copies["cpu"] = copy
        self.cpus[node].push(copy, t)
        self._maybe_start(self.cpus[node], t, rng, push)

    def _on_hedge(self, req: _Req, t: float, rng, push) -> None:
        dscs = req.copies.get("dscs")
        if dscs is None or dscs.state != "queued" or req.result is not None:
            return                      # started or finished in time: no hedge
        req.hedged = True
        self.telemetry.inc("hedge_issued")
        self.telemetry.inc("dscs_fallback")   # budget blown -> CPU path opens
        self._issue_cpu(req, t, rng, push)

    def _on_finish(self, copy: _Copy, t: float, rng, push) -> None:
        server = (self.drives if copy.path == "dscs" else self.cpus)[copy.node]
        server.running = None
        req = copy.req
        if copy.state == "cancelled":
            # run-to-completion loser draining; back-fill its finish time
            if req.result is not None:
                self._record_path_finish(req.result, copy.path, t)
        else:
            copy.state = "done"
            if req.result is None:
                self._record_win(req, copy, t)
            self._record_path_finish(req.result, copy.path, t)
        self._maybe_start(server, t, rng, push)

    def _record_win(self, req: _Req, copy: _Copy, t: float) -> None:
        req.result = RequestResult(
            arrival=req.arrival, finish=t, accelerated=copy.path == "dscs",
            hedged=req.hedged, winner=copy.path,
            drive=req.drive if copy.path == "dscs" else -1,
            start=copy.start, service=copy.service)
        self.telemetry.inc(f"hedge_won_{copy.path}" if req.hedged
                           else f"{copy.path}_served")
        loser = req.copies.get("cpu" if copy.path == "dscs" else "dscs")
        if loser is None or loser.state in ("done", "cancelled"):
            return
        if loser.state == "queued":
            lsrv = (self.drives if loser.path == "dscs"
                    else self.cpus)[loser.node]
            lsrv.cancel_queued(loser, t)
            self.telemetry.inc("cancelled_in_queue")
        else:                           # running: no preemption, drains
            self.telemetry.inc("cancelled_in_service")
        loser.state = "cancelled"

    @staticmethod
    def _record_path_finish(res: Optional[RequestResult], path: str,
                            t: float) -> None:
        if res is None:
            return
        if path == "dscs" and res.dscs_finish is None:
            res.dscs_finish = t
        elif path == "cpu" and res.cpu_finish is None:
            res.cpu_finish = t

    def _maybe_start(self, server: _Server, t: float, rng, push) -> None:
        while True:
            copy = server.pop(t)
            if copy is None:
                return
            if copy.state == "cancelled":   # defensive: cancelled are removed
                continue
            copy.state = "running"
            copy.start = t
            plat = "DSCS-Serverless" if copy.path == "dscs" else "Baseline-CPU"
            copy.service = self._sampler.draw(
                self._sampler.coef(copy.req.pipe.workload, plat))
            server.running = copy
            push(t + copy.service, "finish", copy)
            return

    # -- telemetry -----------------------------------------------------------
    def queue_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-class queue-depth telemetry from the last run.

        Kept with the PR-1 per-class horizon (``max _last_t`` of the class)
        including its known skew — the optimized engine finalizes every
        server to the common end-of-run horizon instead; only the
        ``RequestResult`` stream is golden-trace-gated."""
        def summarize(servers: List[_Server]) -> Dict[str, float]:
            if not servers:
                return {"max_depth": 0.0, "mean_depth": 0.0}
            horizon = max((s._last_t for s in servers), default=0.0)
            mean = (sum(s.depth_area for s in servers)
                    / (horizon * len(servers))) if horizon > 0 else 0.0
            return {"max_depth": float(max(s.max_depth for s in servers)),
                    "mean_depth": float(mean)}
        return {"dscs": summarize(self.drives), "cpu": summarize(self.cpus)}
