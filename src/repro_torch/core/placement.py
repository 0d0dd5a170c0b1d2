"""Data placement & storage classes (§V).

``Acceleratable_Storage`` routes an application's data onto DSCS-capable
drives at deployment time; payload-size caps (AWS Lambda's 256 KB request
limit) guarantee a request's payload lands on ONE drive, and independent
requests spread across drives for scale-out.

Beyond the paper's static one-replica SHA-1 spread, the pool also computes
**k-way replica sets** via rendezvous (highest-random-weight) hashing —
the deterministic candidate lists the tiered data layer
(:mod:`repro_torch.core.tiering`) routes across — and enforces the invariants
the original seed only pretended to:

  * ``Drive.put`` keeps ``used_bytes`` exact across key overwrites
    (the seed double-counted every overwrite);
  * the 256 KB request-payload cap is a real ``ValueError`` on the
    request-payload storage classes (the seed asserted against a
    nonexistent ``"request"`` class, so the cap was dead code);
  * ``capacity_bytes`` is enforced — a full hash-selected drive spills to
    the least-full eligible drive instead of silently overfilling;
  * ``locate`` is O(1) through a key→drive index maintained by ``place``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

MAX_PAYLOAD_BYTES = 256 << 10       # AWS Lambda request cap

# Storage classes that hold raw request payloads: §V's one-payload-one-
# drive argument rests on the 256 KB cap, so these classes enforce it.
REQUEST_PAYLOAD_CLASSES = ("request", "Acceleratable_Storage")


@dataclass
class Drive:
    drive_id: int
    dscs_capable: bool
    capacity_bytes: int = 4 << 40
    used_bytes: int = 0
    objects: Dict[str, int] = field(default_factory=dict)  # key -> size

    def put(self, key: str, size: int) -> None:
        """Store (or overwrite) ``key``; accounting stays exact and the
        capacity is enforced — an overflowing put raises without touching
        the stored object."""
        if size < 0:
            raise ValueError(f"negative object size: {size}")
        old = self.objects.get(key, 0)
        if self.used_bytes - old + size > self.capacity_bytes:
            raise ValueError(
                f"drive {self.drive_id} over capacity: "
                f"{self.used_bytes - old + size} > {self.capacity_bytes}")
        self.used_bytes += size - old
        self.objects[key] = size

    def fits(self, key: str, size: int) -> bool:
        """Would ``put(key, size)`` succeed right now?"""
        old = self.objects.get(key, 0)
        return self.used_bytes - old + size <= self.capacity_bytes

    def delete(self, key: str) -> None:
        """Drop ``key`` if present (no-op otherwise); accounting follows."""
        size = self.objects.pop(key, None)
        if size is not None:
            self.used_bytes -= size

    def has(self, key: str) -> bool:
        return key in self.objects


class StoragePool:
    """A fleet of drives; some are DSCS (DSA-bearing) drives."""

    def __init__(self, n_plain: int, n_dscs: int,
                 capacity_bytes: Optional[int] = None):
        kw = {} if capacity_bytes is None else {"capacity_bytes":
                                                capacity_bytes}
        self.drives: List[Drive] = (
            [Drive(i, False, **kw) for i in range(n_plain)]
            + [Drive(n_plain + i, True, **kw) for i in range(n_dscs)])
        self._index: Dict[str, Drive] = {}      # key -> holding drive

    def dscs_drives(self) -> List[Drive]:
        return [d for d in self.drives if d.dscs_capable]

    def _pool_for(self, storage_class: str) -> List[Drive]:
        pool = (self.dscs_drives() if storage_class == "Acceleratable_Storage"
                else self.drives)
        return pool or self.drives

    def place(self, key: str, size: int, storage_class: str) -> Drive:
        """Deterministic spread of independent request payloads across the
        drives of the right class (requests are independent, §V).

        Overwrites land on the drive already holding the key; a full
        hash-selected drive spills to the least-full eligible drive that
        fits (lowest drive id on ties); a pool with no room raises.
        """
        # payload-cap invariant: one request payload -> one drive (§V)
        if storage_class in REQUEST_PAYLOAD_CLASSES and \
                size > MAX_PAYLOAD_BYTES:
            raise ValueError(
                f"request payload {size} B exceeds the "
                f"{MAX_PAYLOAD_BYTES} B cap (storage_class="
                f"{storage_class!r}); §V requires a payload to fit on "
                f"one drive")
        held = self._index.get(key)
        if held is not None:                    # overwrite in place
            held.put(key, size)
            return held
        pool = self._pool_for(storage_class)
        h = int(hashlib.sha1(key.encode()).hexdigest(), 16)
        drive = pool[h % len(pool)]
        if not drive.fits(key, size):           # spill: least-full that fits
            fallback = [d for d in pool if d.fits(key, size)]
            if not fallback:
                raise ValueError(
                    f"no {storage_class!r} drive can hold {size} B "
                    f"(key={key!r})")
            drive = min(fallback, key=lambda d: (d.used_bytes, d.drive_id))
        drive.put(key, size)
        self._index[key] = drive
        return drive

    def replicas(self, key: str, k: int,
                 storage_class: str = "Acceleratable_Storage") -> List[Drive]:
        """The ``k`` distinct drives replica copies of ``key`` map to, by
        rendezvous hashing over the eligible pool: drive ``j`` scores
        ``SHA1(f"{key}|{j}")`` and the top-``k`` scores win (descending,
        drive order breaking exact ties).  Deterministic, and removing a
        drive only remaps the keys it held — the property the tiered data
        layer's replica routing and hot-key migration rely on."""
        pool = self._pool_for(storage_class)
        if k < 1:
            raise ValueError(f"replication factor must be >= 1, got {k}")
        scored = sorted(
            range(len(pool)),
            key=lambda j: int(hashlib.sha1(
                f"{key}|{j}".encode()).hexdigest(), 16),
            reverse=True)
        return [pool[j] for j in scored[:min(k, len(pool))]]

    def locate(self, key: str) -> Optional[Drive]:
        """O(1) via the key→drive index ``place`` maintains; keys put on
        drives directly (bypassing ``place``) fall back to the scan."""
        drive = self._index.get(key)
        if drive is not None and drive.has(key):
            return drive
        for d in self.drives:
            if d.has(key):
                return d
        return None

    def remove(self, key: str) -> None:
        """Drop ``key`` from the pool (index and drive), if present."""
        drive = self._index.pop(key, None)
        if drive is None:
            drive = self.locate(key)
        if drive is not None:
            drive.delete(key)
