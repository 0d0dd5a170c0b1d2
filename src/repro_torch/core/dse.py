"""Design-space exploration for the near-storage DSA (§IV-B, Fig. 7).

Sweeps PE-array X/Y (4..1024, power-of-2), scratchpad (128 KB..32 MB) and
memory technology (DDR4 / DDR5 / HBM2) — 729 configurations (> the paper's
650) — evaluates average throughput over the Table I benchmark suite with
the tile model, and extracts the power<->performance and
area<->performance Pareto frontiers under the CSD power cap.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.dsa import (DSAConfig, dsa_area_mm2, dsa_power_w,
                            network_latency_s)
from repro_torch.core.workloads import WORKLOADS, Workload

PE_SWEEP = (4, 8, 16, 32, 64, 128, 256, 512, 1024)
SPAD_SWEEP = tuple((128 << 10) * (1 << i) for i in range(9))   # 128KB..32MB
MEMBW_SWEEP = (19.2e9, 38e9, 460e9)                            # DDR4/DDR5/HBM2
PCIE_SLOT_CAP_W = 25.0          # PCIe slot budget (upper bound)
CSD_POWER_CAP_W = 18.0          # SmartSSD-class drive TDP
FLASH_POWER_W = 7.0             # reserved for the flash subsystem
DSA_POWER_CAP_W = CSD_POWER_CAP_W - FLASH_POWER_W


@dataclass(frozen=True)
class DSEPoint:
    cfg: DSAConfig
    throughput_fps: float        # average over the benchmark suite
    power_w: float
    area_mm2: float

    @property
    def feasible(self) -> bool:
        return self.power_w <= DSA_POWER_CAP_W


def evaluate(cfg: DSAConfig, workloads: Sequence[Workload] = None) -> DSEPoint:
    wls = list(workloads or WORKLOADS.values())
    lats = [max(network_latency_s(cfg, wl.gemms), 1e-7) for wl in wls]
    fps = len(lats) / sum(lats)  # harmonic-mean throughput (frames/s)
    return DSEPoint(cfg, fps, dsa_power_w(cfg), dsa_area_mm2(cfg))


def sweep(scratch_cap: int = 32 << 20) -> List[DSEPoint]:
    pts = []
    for px in PE_SWEEP:
        for py in PE_SWEEP:
            for bw in MEMBW_SWEEP:
                # scratchpad scaled with the array, capped (paper: large
                # scratchpads blow the power budget)
                spad = min(scratch_cap,
                           max(128 << 10, px * py * 256))
                pts.append(evaluate(DSAConfig(
                    pe_x=px, pe_y=py, scratchpad_bytes=spad, mem_bw=bw)))
    # plus explicit scratchpad sweep at the square design points
    for pe in PE_SWEEP:
        for spad in SPAD_SWEEP:
            for bw in MEMBW_SWEEP:
                pts.append(evaluate(DSAConfig(
                    pe_x=pe, pe_y=pe, scratchpad_bytes=spad, mem_bw=bw)))
    return pts


def pareto(points: Sequence[DSEPoint], x_attr: str) -> List[DSEPoint]:
    """Non-dominated set: minimize x_attr, maximize throughput."""
    pts = sorted(points, key=lambda p: (getattr(p, x_attr), -p.throughput_fps))
    front: List[DSEPoint] = []
    best = -math.inf
    for p in pts:
        if p.throughput_fps > best:
            front.append(p)
            best = p.throughput_fps
    return front


def optimal_design(points: Sequence[DSEPoint] = None) -> DSEPoint:
    """Highest-throughput feasible point on the power Pareto frontier."""
    pts = [p for p in (points or sweep()) if p.feasible]
    front = pareto(pts, "power_w")
    return max(front, key=lambda p: p.throughput_fps)


def optimal_square_design(points: Sequence[DSEPoint] = None) -> DSEPoint:
    """Best feasible SQUARE array — the paper's TPUv1-scaled search space."""
    pts = [p for p in (points or sweep())
           if p.feasible and p.cfg.pe_x == p.cfg.pe_y]
    return max(pts, key=lambda p: p.throughput_fps)
