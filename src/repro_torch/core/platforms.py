"""Table II — evaluated compute platforms.

Traditional platforms access storage over the network; near-storage (NS)
platforms sit behind a P2P PCIe link inside/next to the drive.  Numbers are
the paper's specs plus standard public figures (peak throughput, memory BW,
prices) where the paper doesn't list them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Platform:
    name: str
    kind: str                  # cpu | gpu | fpga | dsa
    location: str              # remote (traditional) | near_storage
    peak_flops: float          # peak ops/s at deployment precision
                               # (int8 for FPGA/DSA systolic designs, per §VI)
    mem_bw: float              # B/s
    tdp_w: float
    idle_w: float
    freq_hz: float
    price_usd: float
    batch1_efficiency: float   # fraction of peak at batch size 1
    batch_saturation: int      # batch size at which efficiency ~ saturates
    pcie: str = "none"
    launch_s: float = 0.0      # per-GEMM kernel-launch / reconfigure cost
    sat_efficiency: float = 0.7  # efficiency at/beyond batch_saturation


# --- traditional (remote-storage) platforms --------------------------------
# 16 cores x 3 GHz x 2 AVX-512 FMA units (64 f32 FLOP/cyc)
XEON_8275CL = Platform(
    name="Baseline-CPU", kind="cpu", location="remote",
    peak_flops=3.0e12, mem_bw=131e9, tdp_w=240.0, idle_w=80.0,
    freq_hz=3.0e9, price_usd=8000.0, batch1_efficiency=0.30,
    batch_saturation=4, pcie="none", launch_s=2e-6, sat_efficiency=0.38)

RTX_2080TI = Platform(
    name="GPU", kind="gpu", location="remote",
    peak_flops=13.4e12, mem_bw=616e9, tdp_w=250.0, idle_w=55.0,
    freq_hz=1.35e9, price_usd=1200.0, batch1_efficiency=0.25,
    batch_saturation=64, pcie="gen3x16", launch_s=1.8e-5)

# 1024-PE DSA build at 250 MHz (Table II), int8
ALVEO_U280 = Platform(
    name="FPGA", kind="fpga", location="remote",
    peak_flops=2.05e12, mem_bw=460e9, tdp_w=225.0, idle_w=60.0,
    freq_hz=250e6, price_usd=7000.0, batch1_efficiency=0.5,
    batch_saturation=8, pcie="gen4x8", launch_s=2.5e-5)

# --- conventional near-storage platforms ------------------------------------
# quad A57, NEON fp16
NS_ARM_A57 = Platform(
    name="NS-ARM", kind="cpu", location="near_storage",
    peak_flops=0.10e12, mem_bw=25.6e9, tdp_w=15.0, idle_w=3.0,
    freq_hz=2.0e9, price_usd=500.0, batch1_efficiency=0.5,
    batch_saturation=2, pcie="gen3x4", launch_s=2e-6)

NS_JETSON_TX2 = Platform(
    name="NS-Mobile-GPU", kind="gpu", location="near_storage",
    peak_flops=1.33e12, mem_bw=59.7e9, tdp_w=15.0, idle_w=2.5,
    freq_hz=1.3e9, price_usd=400.0, batch1_efficiency=0.25,
    batch_saturation=16, pcie="gen3x4", launch_s=2.5e-5)

# 256-PE DSA build on the SmartSSD KU15P at 250 MHz (Table II), int8
NS_SMARTSSD_FPGA = Platform(
    name="NS-FPGA", kind="fpga", location="near_storage",
    peak_flops=0.9e12, mem_bw=19.2e9, tdp_w=18.0, idle_w=6.0,
    freq_hz=250e6, price_usd=1500.0, batch1_efficiency=0.7,
    batch_saturation=8, pcie="gen3x4", launch_s=1e-5)

# --- proposed: the DSA inside the CSD ----------------------------------------
# 128x128 PEs @1 GHz, 4 MB scratchpad, DDR5 — the DSE winner (Fig. 7);
# price is ASIC-Clouds-style amortized silicon + drive electronics (cost.py).
DSA_CSD = Platform(
    name="DSCS-Serverless", kind="dsa", location="near_storage",
    peak_flops=2 * 128 * 128 * 1e9, mem_bw=38e9, tdp_w=4.2, idle_w=0.6,
    freq_hz=1e9, price_usd=550.0, batch1_efficiency=0.75,
    batch_saturation=4, pcie="gen3x4")

PLATFORMS = {p.name: p for p in (
    XEON_8275CL, RTX_2080TI, ALVEO_U280,
    NS_ARM_A57, NS_JETSON_TX2, NS_SMARTSSD_FPGA, DSA_CSD)}

# canonical platform names for the two fleet roles the cluster engine and
# the autoscaling evaluation share (one definition, not scattered literals)
CPU_FALLBACK_PLATFORM = XEON_8275CL.name
DSCS_PLATFORM = DSA_CSD.name

PCIE_GBPS = {  # effective (post-overhead) unidirectional bandwidth
    "gen3x1": 0.85e9, "gen3x2": 1.7e9, "gen3x4": 3.4e9, "gen3x8": 6.8e9,
    "gen3x16": 13.6e9, "gen4x8": 13.6e9, "gen4x16": 27.2e9, "gen3x32": 27.2e9,
    "none": 3.4e9,
}
