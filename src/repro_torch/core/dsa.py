"""Analytical tile-level performance model of the DSA (§IV + §VI-A).

Plays the role of the paper's cycle-accurate simulator (which they validated
to <=10% against the SmartSSD FPGA build of the same RTL): a weight-
stationary systolic array executes a network as a sequence of tiled GEMMs;
per (bm, bk, bn) tile the compiler double-buffers the next tile's DMA
against the current tile's compute, so per-tile latency is
max(compute_cycles, dma_cycles) — exactly the overlap argument the paper
uses to explain why 1024x1024 arrays LOSE to 128x128 at batch 1 (huge tiles
make DMA dominate and the pipeline stall).

The same model drives the DSE (core/dse.py) and the end-to-end latency
model (core/latency.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class DSAConfig:
    pe_x: int = 128
    pe_y: int = 128
    scratchpad_bytes: int = 4 << 20
    mem_bw: float = 38e9          # DDR5
    freq_hz: float = 1e9
    dtype_bytes: int = 1          # int8 datapath (TPUv1-style)

    @property
    def name(self) -> str:
        return (f"{self.pe_x}x{self.pe_y}/"
                f"{self.scratchpad_bytes >> 20}MB/{self.mem_bw / 1e9:.0f}GBs")


@dataclass(frozen=True)
class GemmShape:
    """One layer lowered to GEMM (convs via im2col)."""
    m: int      # output rows (batch * output pixels)
    k: int      # reduction
    n: int      # output channels
    vector_ops: int = 0   # trailing vector-engine work (activation etc.)


def tile_dims(cfg: DSAConfig, g: GemmShape) -> Tuple[int, int, int]:
    """Pick (bm, bk, bn): array-aligned K/N, M sized so weights tile,
    activation tile and the fp32 partial-sum accumulators all fit the
    double-buffered scratchpad."""
    bk = min(g.k, cfg.pe_x)
    bn = min(g.n, cfg.pe_y)
    budget = cfg.scratchpad_bytes // 2          # double-buffered halves
    w_bytes = bk * bn * cfg.dtype_bytes
    # per activation row: input (bk) at datapath width + fp32 accumulator (bn)
    per_row = bk * cfg.dtype_bytes + bn * 4
    bm = max(1, min(g.m, (budget - w_bytes) // max(per_row, 1)))
    return bm, bk, bn


def gemm_cycles(cfg: DSAConfig, g: GemmShape) -> Tuple[float, float, float]:
    """Returns (total_cycles, compute_cycles, dma_cycles)."""
    bm, bk, bn = tile_dims(cfg, g)
    n_m = math.ceil(g.m / bm)
    n_k = math.ceil(g.k / bk)
    n_n = math.ceil(g.n / bn)
    tiles = n_m * n_k * n_n
    # systolic, weight-stationary: per tile, weights are preloaded down the
    # array (pe_x cycles) and bm activation rows stream through; the fill/
    # drain latency scales with the PHYSICAL array dims, not the tile dims —
    # this is why batch-1 tiles on a 1024x1024 array stall (Fig. 7 text)
    comp_tile = bm + cfg.pe_x + cfg.pe_y - 2
    bytes_tile = (bk * bn + bm * bk) * cfg.dtype_bytes     # weights + acts
    dma_tile = bytes_tile * cfg.freq_hz / cfg.mem_bw       # cycles
    per_tile = max(comp_tile, dma_tile)                    # double-buffered
    fill = comp_tile + dma_tile                            # pipeline prologue
    out_bytes = g.m * g.n * cfg.dtype_bytes
    drain = out_bytes * cfg.freq_hz / cfg.mem_bw
    total = tiles * per_tile + fill + drain + g.vector_ops / (8 * 128)
    return total, tiles * comp_tile, tiles * dma_tile


def network_latency_s(cfg: DSAConfig, gemms: Sequence[GemmShape]) -> float:
    return sum(gemm_cycles(cfg, g)[0] for g in gemms) / cfg.freq_hz


def network_flops(gemms: Sequence[GemmShape]) -> float:
    return sum(2.0 * g.m * g.k * g.n for g in gemms)


def utilization(cfg: DSAConfig, gemms: Sequence[GemmShape]) -> float:
    fl = network_flops(gemms)
    t = network_latency_s(cfg, gemms)
    peak = 2.0 * cfg.pe_x * cfg.pe_y * cfg.freq_hz
    return fl / (t * peak) if t > 0 else 0.0


# --- power / area model (45 nm synthesis -> scaled) --------------------------
# Per-PE numbers in the ballpark of the paper's Synopsys DC / FreePDK45
# synthesis at 1 GHz; SRAM numbers CACTI-P-like.
PE_POWER_45NM_W = 6.3e-4         # dynamic+leakage per int8 MAC PE at 1 GHz
PE_AREA_45NM_MM2 = 2.6e-3
SRAM_POWER_45NM_W_PER_MB = 0.12
SRAM_AREA_45NM_MM2_PER_MB = 1.25
BASE_POWER_W = 0.25              # control, NoC, DMA engines
# memory subsystem (PHY + DRAM device) power — off-die, does NOT scale
# with the logic technology node
MEM_POWER_W = {19.2e9: 0.9, 38e9: 1.2, 460e9: 11.5}

# DeepScaleTool-style 45 nm -> 14 nm scaling
SCALE_POWER_14NM = 0.285
SCALE_AREA_14NM = 0.115


def dsa_power_w(cfg: DSAConfig, tech: str = "14nm") -> float:
    logic45 = (cfg.pe_x * cfg.pe_y * PE_POWER_45NM_W
               + (cfg.scratchpad_bytes / (1 << 20)) * SRAM_POWER_45NM_W_PER_MB
               + BASE_POWER_W)
    scale = SCALE_POWER_14NM if tech == "14nm" else 1.0
    return logic45 * scale + MEM_POWER_W.get(cfg.mem_bw, 1.2)


def dsa_area_mm2(cfg: DSAConfig, tech: str = "14nm") -> float:
    a45 = (cfg.pe_x * cfg.pe_y * PE_AREA_45NM_MM2
           + (cfg.scratchpad_bytes / (1 << 20)) * SRAM_AREA_45NM_MM2_PER_MB
           + 2.0)
    return a45 * (SCALE_AREA_14NM if tech == "14nm" else 1.0)
