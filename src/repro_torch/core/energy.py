"""System energy model (§VI-A Power measurements).

E = sum over phases of (component power x phase time):
  * compute device at TDP-scaled utilization while computing, idle otherwise
  * host/server CPU during system-stack, network and I/O phases
  * PCIe at per-bit transfer energy (Zeppelin-style ~5 pJ/bit effective)
Network (Ethernet/Internet) power is omitted, as in the paper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.latency import LatencyModel
from repro_torch.core.platforms import Platform, PLATFORMS
from repro_torch.core.workloads import Workload

HOST_CPU_ACTIVE_W = 120.0      # storage/compute node host during stack+net
HOST_CPU_LIGHT_W = 45.0        # host while the DSA/NS device computes
PCIE_PJ_PER_BIT = 5.0


def compute_utilization(plat: Platform) -> float:
    """Average device utilization while computing: systolic DSA/FPGA
    dataflows keep more of the array busy than a cache-bound CPU/GPU."""
    return 0.85 if plat.kind in ("dsa", "fpga") else 0.75


def node_power_w(plat: Platform, busy: bool) -> float:
    """Steady-state wall power of one powered fleet node.

    Idle nodes draw ``plat.idle_w``; a node with a copy in service adds the
    TDP-scaled utilization share — the same convention
    :func:`pipeline_energy_j` applies to the compute phase.  This is the
    per-server model the autoscaling evaluation
    (:mod:`repro.core.autoscale`) integrates over busy/powered seconds;
    powered-off servers draw nothing.
    """
    if not busy:
        return plat.idle_w
    return plat.idle_w + (plat.tdp_w - plat.idle_w) * compute_utilization(plat)


def pipeline_energy_j(lm: LatencyModel, plat: Platform, wl: Workload, *,
                      batch: int = 1, q=0.5, dsa_cfg=None,
                      extra_accel_funcs: int = 0) -> Dict[str, float]:
    bd = lm.pipeline_breakdown(plat, wl, batch=batch, q=q, dsa_cfg=dsa_cfg,
                               extra_accel_funcs=extra_accel_funcs)
    util = compute_utilization(plat)
    e: Dict[str, float] = {}
    e["compute"] = bd["compute"] * (plat.idle_w +
                                    (plat.tdp_w - plat.idle_w) * util)
    # host CPU burns cycles on stack / network / driver phases
    e["host"] = (bd["stack"] + bd["net"]) * HOST_CPU_ACTIVE_W \
        + (bd["driver"] + bd["io"]) * HOST_CPU_LIGHT_W \
        + (bd["compute"] * (HOST_CPU_LIGHT_W
                            if plat.location == "near_storage" else
                            HOST_CPU_ACTIVE_W))
    moved_bytes = (wl.request_bytes + wl.input_bytes + wl.output_bytes) * batch
    e["pcie"] = moved_bytes * 8 * PCIE_PJ_PER_BIT * 1e-12 * 2
    e["total"] = sum(v for k, v in e.items() if k != "total")
    return e


def energy_reduction_vs_baseline(lm: LatencyModel, wl: Workload,
                                 plat_name: str, **kw) -> float:
    base = pipeline_energy_j(lm, PLATFORMS["Baseline-CPU"], wl, **kw)["total"]
    tgt = pipeline_energy_j(lm, PLATFORMS[plat_name], wl, **kw)["total"]
    return base / tgt
