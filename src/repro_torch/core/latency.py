"""End-to-end latency model, calibrated to the paper's AWS characterization.

Components (§II, §VI-A):
  * remote storage read/write — S3-style RPC: base latency + size/bw, with
    lognormal tails (Fig. 5: p99/p50 ~ 2.1x reads, ~1.75x writes)
  * ProtoBuf (de)serialization at the storage node
  * read/write syscall + NVMe I/O over PCIe at the storage node
  * serverless system stack (OpenFaaS + Kubernetes dispatch, warm container)
  * PCIe DMA to a discrete accelerator (cudaMemcpy-style) on compute nodes
  * P2P PCIe between flash and the near-storage device (SmartSSD-measured)
  * device driver overhead for near-storage offload (O(ms), §VI-B)
  * cold start: image pull + unpack + health check + weight load

Compute times come from the DSA tile model (dsa.py) for the DSA and from a
peak*efficiency model (batch-1 underutilization per platform) otherwise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.dsa import DSAConfig, network_latency_s
from repro_torch.core.platforms import PCIE_GBPS, Platform
from repro_torch.core.workloads import Workload


@dataclass
class LatencyParams:
    rpc_base_s: float = 12e-3           # S3 REST round-trip (same region)
    get_bw: float = 95e6                # B/s per-object GET
    put_bw: float = 60e6                # B/s per-object PUT
    read_sigma: float = 0.42            # lognormal sigma -> p99/p50 ~ 2.1x
    write_sigma: float = 0.30           # -> p99/p50 ~ 1.75x
    proto_bw: float = 1.2e9             # protobuf (de)serialize
    proto_base_s: float = 3e-4
    syscall_s: float = 1.5e-4
    nvme_bw: float = 3.0e9
    stack_s: float = 9e-3               # OpenFaaS+K8s dispatch, warm
    notify_s: float = 4e-3              # f3 notification service work
    pcie_base_s: float = 1e-5
    p2p_base_s: float = 3e-5
    driver_s: float = 1.3e-3            # NS offload driver (O(ms))
    dsa_invoke_s: float = 5e-5
    # cold start: the image layer is cached node-locally (registry mirror)
    # and the paper ships model weights inside the container image, so the
    # cold path = container start + health check + loading weights into the
    # device (NVMe for CPU/GPU nodes, P2P for the CSD).
    image_unpack_s: float = 0.08
    health_check_s: float = 0.04
    preprocess_flops_per_byte: float = 60.0
    # tiered data layer (tiering.py): a cache hit serves the payload from
    # drive DRAM instead of flash P2P + NS driver; a cache fill pulls the
    # object from the remote backing store (S3-class bandwidth).
    cache_dram_bw: float = 12e9         # B/s drive-DRAM payload read
    cache_hit_base_s: float = 2e-5      # lookup + DMA setup on a hit
    backing_base_s: float = 15e-3       # backing object-store RTT
    backing_bw: float = 80e6            # B/s backing-store GET


@dataclass
class LatencyModel:
    params: LatencyParams = field(default_factory=LatencyParams)
    pcie_lanes: str = "gen3x4"          # P2P link inside the CSD
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    # --- stochastic network components -------------------------------------
    def _tail(self, sigma: float, q: Optional[float]) -> float:
        """Lognormal multiplier; q=None -> sample, else quantile."""
        if q is None:
            return float(np.exp(self.rng.normal(0.0, sigma)))
        return float(np.exp(sigma * math.sqrt(2.0) *
                            _erfinv(2.0 * q - 1.0)))

    def net_read(self, nbytes: int, q: Optional[float] = 0.5) -> float:
        p = self.params
        base = (p.rpc_base_s + nbytes / p.get_bw
                + p.proto_base_s + nbytes / p.proto_bw      # deserialization
                + p.syscall_s + nbytes / p.nvme_bw)         # storage-side IO
        return base * self._tail(p.read_sigma, q)

    def net_write(self, nbytes: int, q: Optional[float] = 0.5) -> float:
        p = self.params
        base = (p.rpc_base_s + nbytes / p.put_bw
                + p.proto_base_s + nbytes / p.proto_bw
                + p.syscall_s + nbytes / p.nvme_bw)
        return base * self._tail(p.write_sigma, q)

    # --- deterministic local components -------------------------------------
    def pcie(self, nbytes: int, lanes: str) -> float:
        return self.params.pcie_base_s + nbytes / PCIE_GBPS[lanes]

    def p2p(self, nbytes: int) -> float:
        return self.params.p2p_base_s + nbytes / PCIE_GBPS[self.pcie_lanes]

    # --- tiered data layer (tiering.py) --------------------------------------
    def dram_read(self, nbytes: int) -> float:
        """Serve a cached payload from drive DRAM (the cache-hit read)."""
        p = self.params
        return p.cache_hit_base_s + nbytes / p.cache_dram_bw

    def cache_hit_savings(self, nbytes: int) -> float:
        """Service-time delta of a DRAM cache hit on the near-storage read
        path: the flash P2P transfer and the NS driver invocation are
        replaced by a DRAM read.  Never negative."""
        return max(0.0, self.p2p(nbytes) + self.params.driver_s
                   - self.dram_read(nbytes))

    def backing_fetch(self, nbytes: int) -> float:
        """One-time cost of materializing an object from the remote backing
        store onto a drive (lazy replica / migration fill)."""
        p = self.params
        return p.backing_base_s + nbytes / p.backing_bw

    # --- compute -------------------------------------------------------------
    def compute_s(self, plat: Platform, wl: Workload, batch: int = 1,
                  dsa_cfg: Optional[DSAConfig] = None) -> float:
        if plat.kind == "dsa":
            cfg = dsa_cfg or DSAConfig(mem_bw=plat.mem_bw,
                                       freq_hz=plat.freq_hz)
            from repro_torch.core.workloads import GemmShape
            gemms = [GemmShape(g.m * batch, g.k, g.n, g.vector_ops * batch)
                     for g in wl.gemms]
            return network_latency_s(cfg, gemms)
        eff = plat.batch1_efficiency + (plat.sat_efficiency - plat.batch1_efficiency) * min(
            1.0, (batch - 1) / max(plat.batch_saturation - 1, 1))
        t_flops = batch * wl.flops / (plat.peak_flops * eff)
        # weights stream from device memory once per request (batch amortizes)
        t_mem = (wl.weight_bytes + batch * wl.input_bytes) / plat.mem_bw
        t_launch = len(wl.gemms) * plat.launch_s
        return max(t_flops, t_mem) + t_launch

    def preprocess_s(self, plat: Platform, wl: Workload, batch: int = 1) -> float:
        flops = wl.request_bytes * self.params.preprocess_flops_per_byte * batch
        if plat.kind == "dsa":   # vector engine: 8x128 lanes @ freq
            return flops / (8 * 128 * plat.freq_hz) + self.params.dsa_invoke_s
        thr = plat.peak_flops * 0.05 if plat.kind != "cpu" else plat.peak_flops * 0.2
        return flops / thr

    # --- end-to-end composition ----------------------------------------------
    def pipeline_breakdown(self, plat: Platform, wl: Workload, *,
                           batch: int = 1, q: Optional[float] = 0.5,
                           dsa_cfg: Optional[DSAConfig] = None,
                           extra_accel_funcs: int = 0,
                           cold: bool = False,
                           cache_hit: bool = False) -> Dict[str, float]:
        """Latency breakdown for the 3-function pipeline (Fig. 2) on one
        platform.  Returns component -> seconds (Fig. 4 / Fig. 9 analogue).

        ``cache_hit`` (near-storage only) serves the request payload from
        the drive's DRAM cache instead of flash P2P + NS driver.
        """
        p = self.params
        bd: Dict[str, float] = {"stack": 0.0, "net": 0.0, "io": 0.0,
                                "compute": 0.0, "driver": 0.0, "cold": 0.0}
        inp = wl.request_bytes * batch
        mid = wl.input_bytes * batch
        out = wl.output_bytes * batch

        if plat.location == "remote":
            # f1: stack + read request + preprocess + write tensor
            bd["stack"] += p.stack_s
            bd["net"] += self.net_read(inp, q) + self.net_write(mid, q)
            bd["compute"] += self.preprocess_s(plat, wl, batch)
            # f2 (+ replicas): stack + read tensor + [pcie in] + infer +
            # [pcie out] + write result
            for _ in range(1 + extra_accel_funcs):
                bd["stack"] += p.stack_s
                bd["net"] += self.net_read(mid, q) + self.net_write(out, q)
                if plat.kind != "cpu":
                    bd["io"] += (self.pcie(mid, plat.pcie)
                                 + self.pcie(out, plat.pcie))
                    bd["driver"] += p.driver_s
                bd["compute"] += self.compute_s(plat, wl, batch, dsa_cfg)
        else:
            # near-storage: f1+f2 run at the drive over P2P; no network for
            # intermediates
            bd["stack"] += p.stack_s                 # dispatch to storage node
            if cache_hit:
                bd["io"] += self.dram_read(inp)      # payload from drive DRAM
            else:
                bd["io"] += self.p2p(inp)
                bd["driver"] += p.driver_s
            bd["compute"] += self.preprocess_s(plat, wl, batch)
            for _ in range(1 + extra_accel_funcs):
                bd["compute"] += self.compute_s(plat, wl, batch, dsa_cfg)
                if plat.kind == "dsa":
                    bd["driver"] += p.dsa_invoke_s
            bd["io"] += self.p2p(out)

        # f3: notification service on a CPU node — reads result remotely
        # in BOTH designs (paper §VI-B runtime-breakdown discussion)
        bd["stack"] += p.stack_s
        bd["net"] += self.net_read(out, q)
        bd["compute"] += p.notify_s

        if cold:
            bd["cold"] = (p.image_unpack_s + p.health_check_s
                          + (self.p2p(wl.weight_bytes)
                             if plat.location == "near_storage"
                             else wl.weight_bytes / p.nvme_bw))
        bd["total"] = sum(v for k, v in bd.items() if k != "total")
        return bd

    def e2e(self, plat: Platform, wl: Workload, **kw) -> float:
        return self.pipeline_breakdown(plat, wl, **kw)["total"]


def _erfinv(x: float) -> float:
    """Winitzki approximation (|err| < 6e-3) — good enough for quantiles."""
    a = 0.147
    ln = math.log(1.0 - x * x)
    t = 2.0 / (math.pi * a) + ln / 2.0
    return math.copysign(math.sqrt(math.sqrt(t * t - ln / a) - t), x)
