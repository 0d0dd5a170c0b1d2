"""Cost-efficiency model (§VI-A):

    CostEfficiency = Throughput x T / (CAPEX + OPEX)
    OPEX = sum(Power x T x Electricity)

CAPEX per platform from vendor list prices; the DSA's CAPEX follows the
ASIC-Clouds amortization (NRE spread over volume + silicon cost per mm^2 +
drive electronics).  T = 3 years, electricity $0.0733/kWh.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dsa import DSAConfig, dsa_area_mm2
from repro_torch.core.energy import pipeline_energy_j
from repro_torch.core.latency import LatencyModel
from repro_torch.core.platforms import Platform, PLATFORMS
from repro_torch.core.workloads import Workload

ELECTRICITY_USD_PER_KWH = 0.0733
# re-replication traffic (replica repair after a drive failure or an
# autoscaler power-down): cross-rack bytes priced like cloud intra-region
# transfer — the autoscaling evaluation charges this per repaired GB so
# aggressive drive power-cycling pays for the repair traffic it causes
REPAIR_USD_PER_GB = 0.02
T_YEARS = 3.0
T_SECONDS = T_YEARS * 365.25 * 24 * 3600
HOST_SHARE_USD = 7500.0          # shared node/server infrastructure

# ASIC-Clouds-style: NRE / volume + wafer cost per mm^2 at 14 nm
NRE_USD = 8e6
VOLUME = 1e5
SILICON_USD_PER_MM2 = 0.10
DRIVE_USD = 320.0                # the SSD itself


DRIVES_PER_STORAGE_NODE = 16     # chassis share amortized across its drives


def dsa_capex_usd(cfg: DSAConfig = DSAConfig()) -> float:
    return (NRE_USD / VOLUME + dsa_area_mm2(cfg) * SILICON_USD_PER_MM2
            + DRIVE_USD + 120.0)  # + board/controller


def rental_rate_usd_per_s(plat: Platform, *, dsa_cfg=None) -> float:
    """Amortized CAPEX of keeping one node provisioned, in $/s over the
    3-year window (cloud-rental style: a powered-down server stops
    accruing).  Electricity is OPEX and accounted separately from metered
    energy.  CPU/GPU nodes carry the full ``HOST_SHARE_USD``; a DSCS drive
    carries 1/``DRIVES_PER_STORAGE_NODE`` of it (many drives share one
    storage chassis) on top of its ASIC-Clouds-amortized silicon.

    This is what the autoscaling evaluation (:mod:`repro_torch.core.autoscale`)
    multiplies by powered server-seconds to price a fleet policy.
    """
    if plat.kind == "dsa":
        capex = (dsa_capex_usd(dsa_cfg or DSAConfig())
                 + HOST_SHARE_USD / DRIVES_PER_STORAGE_NODE)
    else:
        capex = plat.price_usd + HOST_SHARE_USD
    return capex / T_SECONDS


def cost_efficiency(lm: LatencyModel, plat: Platform, wl: Workload, *,
                    batch: int = 1, dsa_cfg=None) -> float:
    """Requests per dollar over the 3-year window."""
    lat = lm.e2e(plat, wl, batch=batch, dsa_cfg=dsa_cfg)
    thr = batch / lat                                   # req/s (run-to-completion)
    energy = pipeline_energy_j(lm, plat, wl, batch=batch, dsa_cfg=dsa_cfg)
    avg_power = energy["total"] / lat
    capex = (dsa_capex_usd(dsa_cfg or DSAConfig())
             if plat.kind == "dsa" else plat.price_usd) + HOST_SHARE_USD
    opex = avg_power * T_SECONDS / 3600.0 / 1000.0 * ELECTRICITY_USD_PER_KWH
    return thr * T_SECONDS / (capex + opex)


def cost_efficiency_vs_baseline(lm: LatencyModel, wl: Workload,
                                plat_name: str, **kw) -> float:
    return (cost_efficiency(lm, PLATFORMS[plat_name], wl, **kw)
            / cost_efficiency(lm, PLATFORMS["Baseline-CPU"], wl, **kw))
