"""Segmented-scan Lindley solver: every server's FCFS queue in one pass.

The partitioned fast path (:mod:`repro_torch.core.sharding`) solves per-server
FCFS queues with the Lindley recurrence.  For rows sorted by server key
with per-segment arrivals ``t`` and service demands ``s``, the service
start obeys the segment-reset scan identity::

    start_j = max(t_j,  max_{i <= j, same segment} (t_i - P_i)  +  P_j)

where ``P_j = sum(s_a .. s_{j-1})`` is the within-segment exclusive
prefix of the service demands — a cumulative sum plus a running maximum,
both resetting at segment boundaries.  Until this module, the engine
evaluated that identity through one zero-padded dense ``(n_servers,
longest_queue)`` array: under a skewed key distribution (one hot server
holding most of the stream) ``longest_queue -> n`` and the pad blows up
to ``O(n_servers * n)`` memory — the exact regime (Zipf object
popularity, hot drives) where the simulator must be fastest.

Two backends evaluate the identity over the contiguous flat layout:

``segmented`` (numpy)
    Segments are grouped into power-of-two **length buckets** (segment
    length in ``(2^{b-1}, 2^b]`` lands in bucket ``b``), each bucket
    solved as a dense ``(rows_in_bucket, 2^b)`` block.  A bucket's pad
    is < 2x its real rows, so peak scratch is ``O(n)`` no matter how
    skewed the keys are, and the per-bucket math is the *identical*
    sequence of IEEE-754 operations the old padded-dense layout ran
    (row-wise ``cumsum`` / ``maximum.accumulate``) — outputs are
    byte-for-byte the same, which is what lets the differential
    shard-equivalence harness and the golden traces extend over the new
    backend unchanged.  A flat global-cumsum formulation was rejected:
    re-associating the prefix sums changes the low-order float bits and
    would have broken the bit-identity gate.

``torch`` / ``cuda``
    The same bucketed recurrence through
    :func:`repro_torch.kernels.ops.lindley`, one call per bucket on
    float64 tensors.  ``cuda`` (the default,
    :data:`DEFAULT_BACKEND`) puts each bucket on the card and runs the
    hand-written fp64 scan of :mod:`repro_torch.kernels.lindley`, which
    walks each row in order with the same fp64 operations; it raises
    where CUDA is absent.  ``torch`` keeps the bucket on the CPU and runs
    the kernel's plain PyTorch version, the numpy op sequence.  Both are
    byte-equal to the numpy backend (pinned in
    ``tests/test_torch_lindley.py``).

``dense``
    The legacy zero-padded ``(n_servers, longest_queue)`` layout, kept
    as the perf baseline ``benchmarks/bench_engine.py`` measures the
    skew speedup against.

Scratch buffers are pooled per process (:data:`_POOL`) and reused across
buckets, shards, and the accel/non-accel solve phases, so a long run
allocates its working set once.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops

__all__ = ["BACKENDS", "DEFAULT_BACKEND", "queue_depth_max",
           "segment_fenceposts", "solve_segments"]

BACKENDS = ("segmented", "torch", "cuda", "dense")
# The port's entry points run on the card unless the caller asks otherwise.
DEFAULT_BACKEND = "cuda"

# Reusable scratch: name -> grow-only 1D float64 buffer.  Forked shard
# workers each inherit (copy-on-write) and then own their pool, so the
# drive phase and the CPU phase of one worker share one working set.
_POOL: Dict[str, np.ndarray] = {}


def _scratch(name: str, size: int) -> np.ndarray:
    buf = _POOL.get(name)
    if buf is None or buf.size < size:
        buf = np.empty(max(size, 1), dtype=np.float64)
        _POOL[name] = buf
    return buf


def segment_fenceposts(keys: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """``n_servers + 1`` fenceposts into ``keys`` (sorted server ids in
    ``[lo, hi)``): server ``j``'s rows are ``[seg[j], seg[j+1])``."""
    return np.searchsorted(keys, np.arange(lo, hi + 1))


def _solve_dense(seg: np.ndarray, t: np.ndarray, s: np.ndarray,
                 start: np.ndarray) -> None:
    """Legacy padded-dense evaluation: one ``(n_servers, longest)``
    zero-padded block (pads sit after each row's data, so the row-wise
    prefix scans never see them)."""
    lens = np.diff(seg)
    nserv = lens.size
    rows = np.repeat(np.arange(nserv), lens)
    pos = np.arange(t.size) - np.repeat(seg[:-1], lens)
    shape = (nserv, int(lens.max()))
    T = np.zeros(shape)
    S = np.zeros(shape)
    T[rows, pos] = t
    S[rows, pos] = s
    C = np.cumsum(S, axis=1)
    prev = C - S
    M = np.maximum.accumulate(T - prev, axis=1)
    start[:] = np.maximum(T, M + prev)[rows, pos]


def _bucket_rows(lens: np.ndarray):
    """Group nonempty segments into power-of-two length buckets.

    Returns ``(order, bounds, widths)``: ``order`` lists segment indices
    sorted by bucket, ``bounds`` are fenceposts into ``order`` per
    bucket, ``widths[b]`` is the bucket's padded row width (< 2x the
    shortest member, so bucket scratch is < 2x its real row count).
    """
    ne = np.flatnonzero(lens)
    if not ne.size:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(1, dtype=np.int64), z
    # bucket id = ceil(log2(len)): len in (2^{b-1}, 2^b] -> width 2^b
    b = np.asarray([(int(v) - 1).bit_length() for v in lens[ne]],
                   dtype=np.int64)
    srt = np.argsort(b, kind="stable")
    order, bs = ne[srt], b[srt]
    cut = np.flatnonzero(np.diff(bs)) + 1
    bounds = np.concatenate([[0], cut, [order.size]]).astype(np.int64)
    widths = (np.int64(1) << bs[bounds[:-1]]).astype(np.int64)
    return order, bounds, widths


def _solve_segmented(seg: np.ndarray, t: np.ndarray, s: np.ndarray,
                     start: np.ndarray,
                     device: Optional[torch.device] = None) -> None:
    """Bucketed evaluation over the flat layout; fills ``start``."""
    lens = np.diff(seg)
    order, bounds, widths = _bucket_rows(lens)
    for bi in range(bounds.size - 1):
        rows = order[bounds[bi]:bounds[bi + 1]]
        w = int(widths[bi])
        r = rows.size
        rl = lens[rows]
        mass = int(rl.sum())
        # flat gather indices for this bucket's rows
        rr = np.repeat(np.arange(r), rl)
        pp = np.arange(mass) - np.repeat(np.cumsum(rl) - rl, rl)
        flat = np.repeat(seg[:-1][rows], rl) + pp
        T = _scratch("T", r * w)[:r * w].reshape(r, w)
        S = _scratch("S", r * w)[:r * w].reshape(r, w)
        # pads sit after each row's data; garbage there never reaches a
        # real row's prefix, so only the data region is written
        T.fill(0.0)
        S.fill(0.0)
        T[rr, pp] = t[flat]
        S[rr, pp] = s[flat]
        if device is not None:
            # T/S are pooled scratch the next bucket overwrites: copy the
            # result back synchronously before moving on
            st = ops.lindley(torch.from_numpy(T).to(device),
                             torch.from_numpy(S).to(device)).cpu().numpy()
            start[flat] = st[rr, pp]
            continue
        C = _scratch("C", r * w)[:r * w].reshape(r, w)
        P = _scratch("P", r * w)[:r * w].reshape(r, w)
        np.cumsum(S, axis=1, out=C)
        np.subtract(C, S, out=P)             # P = within-segment prefix
        np.subtract(T, P, out=C)             # C := T - P (C is free)
        np.maximum.accumulate(C, axis=1, out=C)   # running max, resets/row
        np.add(C, P, out=C)
        np.maximum(T, C, out=C)              # start, padded layout
        start[flat] = C[rr, pp]


def solve_segments(seg: np.ndarray, t: np.ndarray, s: np.ndarray,
                   start: np.ndarray, fin: np.ndarray, *,
                   backend: str = DEFAULT_BACKEND) -> None:
    """Fill ``start``/``fin`` for every segment's FCFS queue.

    ``seg`` are :func:`segment_fenceposts`; ``t`` (sorted per segment)
    and ``s`` are the flat arrival/service columns.  All four backends
    produce bit-identical results (see the module docstring).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    dev = None
    if backend in ("torch", "cuda"):
        dev = _device.resolve("cpu" if backend == "torch" else "cuda")
    if not t.size:
        return
    if backend == "dense":
        _solve_dense(seg, t, s, start)
    else:
        _solve_segmented(seg, t, s, start, device=dev)
    np.add(start, s, out=fin)


def queue_depth_max(seg: np.ndarray, start: np.ndarray,
                    t: np.ndarray) -> List[int]:
    """Per-segment max queued-copy depth, vectorized across segments.

    Depth is sampled at arrivals (it only grows there): at the ``j``-th
    arrival of a segment the depth is ``j + 1`` minus the number of
    copies already started (``start_i <= t_j``).  Both ``start`` and
    ``t`` are non-decreasing within a segment, so the count is a merge
    rank: sort ``(segment, value, kind)`` with starts ordered before
    arrivals on ties (the ``side='right'`` convention) and count starts
    by cumulative sum — exact, comparison-only, no per-server loop.
    Nonempty segments are pinned to depth >= 1 (the classic engine
    counts the in-service copy whenever the server dispatched at all).
    """
    nserv = seg.size - 1
    m = int(t.size)
    maxd = [0] * nserv
    if not m:
        return maxd
    lens = np.diff(seg)
    seg_id = np.repeat(np.arange(nserv, dtype=np.int64), lens)
    val = np.concatenate([start, t])
    kind = np.zeros(2 * m, dtype=np.int8)
    kind[m:] = 1                            # starts sort before ties
    sid2 = np.concatenate([seg_id, seg_id])
    order = np.lexsort((kind, val, sid2))
    started_cum = np.cumsum(order < m)      # starts seen so far, merged
    p = np.flatnonzero(order >= m)          # merged positions of arrivals
    j = order[p] - m                        # flat arrival index
    depth = np.empty(m, dtype=np.int64)
    depth[j] = j + 1 - started_cum[p]
    ne = np.flatnonzero(lens)
    md = np.maximum.reduceat(depth, seg[:-1][ne]) if ne.size else ne
    for k, d in zip(ne.tolist(), np.maximum(md, 1).tolist()):
        maxd[k] = int(d)
    return maxd
