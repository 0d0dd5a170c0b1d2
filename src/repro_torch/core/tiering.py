"""Tiered data layer (ROADMAP item): per-drive DRAM caches, k-way
replication, a remote backing object store, and hot-key migration.

The paper's placement story (§V) pins one static SHA-1 replica per object,
so Zipf-hot keys melt a single drive.  This module models the storage
hierarchy that fixes it, and :class:`~repro_torch.core.engine.ClusterEngine`
interprets it on the SoA hot path (``ClusterEngine(tier=TierConfig(...))``):

  * **per-drive DRAM cache** — :class:`DriveCache`: LRU eviction plus a
    TinyLFU-style frequency-admission filter (``admit_after`` accesses
    before an object may displace residents).  A hit serves the payload
    from drive DRAM instead of flash: the engine subtracts
    ``LatencyModel.cache_hit_savings`` from that copy's service time.
  * **k-way replication** — every object maps to ``replication_k``
    distinct drives by rendezvous hashing (:func:`build_replica_table`,
    the same scheme as ``StoragePool.replicas``).  The engine routes each
    arrival to the cache-warmest, least-loaded replica.
  * **remote backing object store** — replicas materialize lazily: the
    first access on a secondary (or migrated-to) drive pays
    ``LatencyModel.backing_fetch`` to pull the object from the backing
    tier; afterwards the copy is drive-local.
  * **hot-key migration** — :class:`MigrationController` watches the
    engine's per-drive queue telemetry at epoch boundaries (the same hook
    cadence the autoscale control loop uses) and retargets the hottest
    keys of saturated drives onto the coldest drives; the durable copy
    follows via a backing-store fetch on first access.

With the tier disabled (``replication_k == 1``, ``cache_bytes == 0``,
per-request unique objects, no migration) the engine never enters any of
these paths and its event stream stays bit-identical to the golden traces.

The tier interfaces follow the Mooncake-style store connectors (hit-rate
and transfer telemetry per tier); the Zipf-skewed popularity study lives
in ``benchmarks/figures.py::fig22_tiered_storage``.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "DriveCache", "MigrationController", "MigrationPolicy", "TierConfig",
    "build_replica_table", "zipf_object_ids",
]


@dataclass(frozen=True)
class MigrationPolicy:
    """Knobs of the epoch-driven hot-key rebalancer.

    Every ``epoch_s`` simulated seconds the controller compares live
    per-drive backlogs; when the hottest drive's queue exceeds the
    coldest's by at least ``min_queue_imbalance`` copies, up to
    ``max_moves_per_epoch`` of its most-accessed keys are retargeted onto
    the coldest drives.
    """
    epoch_s: float = 1.0
    max_moves_per_epoch: int = 4
    min_queue_imbalance: int = 4

    def validate(self) -> None:
        if self.epoch_s <= 0.0:
            raise ValueError("migration epoch_s must be positive")
        if self.max_moves_per_epoch < 1:
            raise ValueError("max_moves_per_epoch must be >= 1")
        if self.min_queue_imbalance < 1:
            raise ValueError("min_queue_imbalance must be >= 1")


@dataclass(frozen=True)
class TierConfig:
    """The storage-hierarchy configuration one engine run interprets.

    ``replication_k`` durable replicas per object; ``cache_bytes`` of
    DRAM cache per drive (0 disables caching); ``admit_after`` accesses
    before the frequency filter admits an object (1 = plain LRU,
    always-admit); ``n_objects`` distinct objects with Zipf(``zipf_s``)
    popularity (0 keeps the classic one-unique-object-per-request model);
    ``object_bytes`` overrides the per-pipeline request payload size
    (0 = use each pipeline's ``workload.request_bytes``); ``migration``
    attaches the hot-key rebalancer.

    The default config is **disabled**: it models exactly the paper's
    static single-replica placement and the engine takes the classic
    bit-exact path.
    """
    replication_k: int = 1
    cache_bytes: int = 0
    admit_after: int = 1
    n_objects: int = 0
    zipf_s: float = 1.1
    object_bytes: int = 0
    migration: Optional[MigrationPolicy] = None

    @property
    def enabled(self) -> bool:
        """True when any tier mechanism deviates from the paper's static
        single-replica placement."""
        return (self.replication_k > 1 or self.cache_bytes > 0
                or self.n_objects > 0 or self.migration is not None)

    def validate(self) -> None:
        if self.replication_k < 1:
            raise ValueError("replication_k must be >= 1")
        if self.cache_bytes < 0:
            raise ValueError("cache_bytes must be >= 0")
        if self.admit_after < 1:
            raise ValueError("admit_after must be >= 1")
        if self.n_objects < 0:
            raise ValueError("n_objects must be >= 0")
        if self.n_objects and self.zipf_s < 0.0:
            raise ValueError("zipf_s must be >= 0")
        if self.object_bytes < 0:
            raise ValueError("object_bytes must be >= 0")
        if self.migration is not None:
            self.migration.validate()


class DriveCache:
    """One drive's DRAM object cache: LRU eviction behind a TinyLFU-style
    frequency-admission filter.

    ``access(key, size)`` is the read path: a resident key is a **hit**
    (refreshed to MRU); a miss bumps the key's frequency counter and
    admits it once it has been seen ``admit_after`` times, evicting LRU
    residents to make room.  ``warm(key)`` peeks without mutating any
    state — what the replica router consults.  Objects larger than the
    whole cache are never admitted.
    """

    __slots__ = ("capacity_bytes", "admit_after", "used_bytes", "_res",
                 "_freq", "hits", "misses", "evictions", "admitted",
                 "rejected")

    def __init__(self, capacity_bytes: int, admit_after: int = 1):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        if admit_after < 1:
            raise ValueError("admit_after must be >= 1")
        self.capacity_bytes = capacity_bytes
        self.admit_after = admit_after
        self.used_bytes = 0
        self._res: "OrderedDict[int, int]" = OrderedDict()  # key -> size
        self._freq: Dict[int, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.admitted = 0
        self.rejected = 0

    def __contains__(self, key) -> bool:
        return key in self._res

    def warm(self, key) -> bool:
        """Resident check without touching LRU order or frequencies."""
        return key in self._res

    def access(self, key, size: int) -> bool:
        """One read of ``key`` (``size`` bytes); returns True on a hit."""
        res = self._res
        if key in res:
            res.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        f = self._freq.get(key, 0) + 1
        self._freq[key] = f
        if f < self.admit_after or size > self.capacity_bytes:
            self.rejected += 1
            return False
        while self.used_bytes + size > self.capacity_bytes:
            _, ev_size = res.popitem(last=False)
            self.used_bytes -= ev_size
            self.evictions += 1
        res[key] = size
        self.used_bytes += size
        self.admitted += 1
        return False

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions, "admitted": self.admitted,
                "rejected": self.rejected, "used_bytes": self.used_bytes,
                "resident": len(self._res)}


def zipf_object_ids(n: int, n_objects: int, s: float,
                    rng: np.random.Generator) -> np.ndarray:
    """``n`` object ids drawn i.i.d. from a Zipf(``s``) popularity law
    over ``n_objects`` objects (object 0 is the hottest).  Sampled by
    inverse-CDF over the normalized rank weights, so the draw stream is
    exactly reproducible from ``rng``."""
    if n_objects < 1:
        raise ValueError("n_objects must be >= 1")
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    w = ranks ** -s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.uniform(size=n)
    return np.searchsorted(cdf, u, side="left").astype(np.int64)


def _hrw_ranking(key: str, n_drives: int) -> List[int]:
    """Drive indices ordered by rendezvous-hash score for ``key`` — the
    same ``SHA1(f"{key}|{j}")`` scheme as ``StoragePool.replicas``."""
    sha1 = hashlib.sha1
    return sorted(range(n_drives),
                  key=lambda j: int(sha1(
                      f"{key}|{j}".encode()).hexdigest(), 16),
                  reverse=True)


def build_replica_table(n_objects: int, n_drives: int,
                        k: int) -> List[List[int]]:
    """Per-object replica drive lists: object ``o`` (key ``obj-{o}``)
    lives on the top-``k`` drives of its rendezvous ranking, primary
    first.  Mutable on purpose — the migration controller retargets
    entries in place."""
    if n_drives < 1:
        raise ValueError("need at least one drive")
    k = min(max(1, k), n_drives)
    return [_hrw_ranking(f"obj-{o}", n_drives)[:k] for o in range(n_objects)]


@dataclass
class MigrationController:
    """Epoch-driven hot-key rebalancer over the engine's live telemetry.

    The engine feeds it per-drive live queue depths and the per-drive
    object access counts of the closing epoch; :meth:`plan` returns the
    ``(object, from_drive, to_drive)`` moves to apply to the replica
    table.  Moves only retarget *routing* — the durable copy materializes
    on the target via a backing-store fetch on first access, exactly like
    a lazy replica.
    """
    policy: MigrationPolicy = field(default_factory=MigrationPolicy)
    moves: int = 0                      # total keys migrated (telemetry)
    epochs: int = 0                     # epochs evaluated
    log: List[Tuple[float, int, int, int]] = field(default_factory=list)

    def plan(self, t: float, queue_depth: List[int], busy: List[int],
             access: List[Dict[int, int]],
             replicas: List[List[int]]) -> List[Tuple[int, int, int]]:
        """One epoch's decision: hottest keys off the most-backlogged
        drive onto the least-loaded drives.  Deterministic — ties break
        toward lower drive/object ids."""
        self.epochs += 1
        nd = len(queue_depth)
        if nd < 2:
            return []
        load = [queue_depth[d] + busy[d] for d in range(nd)]
        hot = max(range(nd), key=lambda d: (load[d], -d))
        cold_order = sorted(range(nd), key=lambda d: (load[d], d))
        coldest = cold_order[0]
        if load[hot] - load[coldest] < self.policy.min_queue_imbalance:
            return []
        # hottest keys on the hot drive this epoch, most-accessed first
        hot_keys = sorted(access[hot].items(), key=lambda kv: (-kv[1], kv[0]))
        out: List[Tuple[int, int, int]] = []
        for o, _cnt in hot_keys:
            if len(out) >= self.policy.max_moves_per_epoch:
                break
            reps = replicas[o]
            if hot not in reps:
                continue                # routing already moved elsewhere
            tgt = next((d for d in cold_order
                        if d != hot and d not in reps), None)
            if tgt is None:
                continue                # already replicated everywhere
            out.append((o, hot, tgt))
        for o, frm, to in out:
            self.log.append((t, o, frm, to))
        self.moves += len(out)
        return out


# --------------------------------------------------------------------------
# shard-local bookkeeping merge (sharded runs)
# --------------------------------------------------------------------------

def merge_tier_stats(states: List[Optional[dict]]) -> Optional[dict]:
    """Merge per-shard ``tier_stats()`` dicts into one fleet view.

    Sharded runs build replica tables and caches *shard-local* (each
    shard replicates its objects across its own drives only, so tier
    routing never crosses a shard boundary); this folds the books back
    into the single-engine schema: hit/miss/eviction counters and
    backing-store traffic sum, per-drive cache stats concatenate in
    shard (= drive) order, object counts add across the shard-local
    tables, and migration logs concatenate with moves summed.  Returns
    ``None`` when tiering was off.
    """
    live = [s for s in states if s is not None]
    if not live:
        return None
    hits = sum(s["cache"]["hits"] for s in live)
    misses = sum(s["cache"]["misses"] for s in live)
    per_drive: List[dict] = []
    for s in live:
        per_drive += s["cache"]["per_drive"]
    migs = [s["migration"] for s in live if s["migration"] is not None]
    return {
        "replication_k": live[0]["replication_k"],
        "n_objects": sum(s["n_objects"] for s in live),
        "cache_bytes": live[0]["cache_bytes"],
        "cache": {
            "hits": hits, "misses": misses,
            "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "evictions": sum(s["cache"]["evictions"] for s in live),
            "per_drive": per_drive,
        },
        "backing_fetches": sum(s["backing_fetches"] for s in live),
        "backing_s": sum(s["backing_s"] for s in live),
        "migration": (None if not migs else
                      {"moves": sum(m["moves"] for m in migs),
                       "epochs": max(m["epochs"] for m in migs),
                       "log": [e for m in migs for e in m["log"]]}),
    }


__all__.append("merge_tier_stats")
