"""Pluggable request-arrival processes for the cluster engine.

The fleet-level figures (Fig. 12 throughput-under-SLA, Fig. 16 straggler
mitigation) are sensitive to the *shape* of the offered load, not just its
mean rate.  This module provides the arrival processes the engine, the
benchmark sweeps and the examples share:

  * ``PoissonProcess``   — memoryless baseline (the paper's setting)
  * ``BurstyOnOff``      — 2-state MMPP: exponential ON/OFF phases with a
                           burst_factor rate multiplier while ON, calibrated
                           so the long-run mean rate equals ``rate``
  * ``DiurnalProcess``   — nonhomogeneous Poisson with a sinusoidal rate
                           profile (thinning / Lewis-Shedler sampling)
  * ``TraceReplay``      — deterministic replay of recorded arrival times
  * ``MergedArrivals``   — deterministic multiplexer of independent
                           component streams (one per tenant), with
                           per-arrival source attribution

Every process draws exclusively from the ``numpy.random.Generator`` handed
to :meth:`times`, so a single engine seed reproduces the full arrival
stream.  Processes are value objects: ``with_rate`` returns a rescaled copy
(used by the throughput binary search) without mutating the original.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Tuple, Type

import numpy as np


@dataclass(frozen=True)
class ArrivalProcess:
    """Base class: a distribution over sorted arrival-time vectors."""
    rate: float                         # long-run mean requests/second

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        """Sample one arrival stream: a sorted float64 vector of arrival
        times in ``[0, duration_s)``, drawn exclusively from ``rng`` (so
        one engine seed reproduces the full stream)."""
        raise NotImplementedError

    def with_rate(self, rate: float) -> "ArrivalProcess":
        """A copy of this process rescaled to a new mean rate."""
        return replace(self, rate=rate)


@dataclass(frozen=True)
class PoissonProcess(ArrivalProcess):
    """Homogeneous Poisson arrivals (i.i.d. exponential gaps)."""

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        """Exponential-gap sampling, drawn in vectorized blocks."""
        if self.rate <= 0.0 or duration_s <= 0.0:
            return np.empty(0)
        # draw in blocks until we pass duration_s
        out = []
        t = 0.0
        block = max(16, int(self.rate * duration_s * 1.2))
        while t < duration_s:
            gaps = rng.exponential(1.0 / self.rate, size=block)
            ts = t + np.cumsum(gaps)
            out.append(ts)
            t = float(ts[-1])
        ts = np.concatenate(out)
        return ts[ts < duration_s]


@dataclass(frozen=True)
class BurstyOnOff(ArrivalProcess):
    """Markov-modulated Poisson process with ON bursts.

    While ON the instantaneous rate is ``burst_factor * rate``; the OFF rate
    is solved so the long-run mean equals ``rate`` given the duty cycle
    ``mean_on_s / (mean_on_s + mean_off_s)`` (floored at zero when the burst
    carries more than the whole budget).
    """
    burst_factor: float = 4.0
    mean_on_s: float = 2.0
    mean_off_s: float = 8.0

    def _phase_rates(self) -> Tuple[float, float]:
        if self.mean_on_s <= 0.0 or self.mean_off_s <= 0.0:
            raise ValueError("mean_on_s and mean_off_s must be positive; "
                             "for an unmodulated stream use PoissonProcess")
        duty = self.mean_on_s / (self.mean_on_s + self.mean_off_s)
        rate_on = self.burst_factor * self.rate
        rate_off = max(0.0, self.rate * (1.0 - self.burst_factor * duty)
                       / (1.0 - duty))
        return rate_on, rate_off

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        """Alternate exponential ON/OFF holds (initial phase drawn from the
        stationary duty cycle) and pour Poisson arrivals into each hold at
        its phase rate."""
        if self.rate <= 0.0 or duration_s <= 0.0:
            return np.empty(0)
        rate_on, rate_off = self._phase_rates()
        duty = self.mean_on_s / (self.mean_on_s + self.mean_off_s)
        out = []
        # draw the initial phase from the stationary duty cycle so even
        # short windows offer ~rate on average
        t, on = 0.0, bool(rng.uniform() < duty)
        while t < duration_s:
            mean = self.mean_on_s if on else self.mean_off_s
            hold = float(rng.exponential(mean))
            r = rate_on if on else rate_off
            if r > 0.0 and hold > 0.0:
                n = int(rng.poisson(r * hold))
                if n:
                    out.append(t + np.sort(rng.uniform(0.0, hold, size=n)))
            t += hold
            on = not on
        if not out:
            return np.empty(0)
        ts = np.concatenate(out)
        return ts[ts < duration_s]


@dataclass(frozen=True)
class DiurnalProcess(ArrivalProcess):
    """Sinusoidal daily profile: rate(t) = rate * (1 + amp*sin(2πt/period)),
    floored at zero.

    Sampled by thinning against the peak rate (Lewis & Shedler), so the
    stream is an exact nonhomogeneous Poisson process; the profile wraps
    seamlessly across period boundaries for any ``duration_s``.  With
    ``amplitude`` <= 1 the trough rate is ``rate * (1 - amplitude)``;
    amplitudes above 1 are allowed and clip the around-trough rate to zero
    (a "dead of night" window with no arrivals at all).
    """
    amplitude: float = 0.6              # >= 0; > 1 clips the trough to zero
    period_s: float = 60.0              # compressed "day"

    def __post_init__(self) -> None:
        if self.amplitude < 0.0:
            raise ValueError("amplitude must be >= 0 (use phase, not sign)")
        if self.period_s <= 0.0:
            raise ValueError("period_s must be positive")

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        if self.rate <= 0.0 or duration_s <= 0.0:
            return np.empty(0)
        lam_max = self.rate * (1.0 + self.amplitude)
        cand = PoissonProcess(lam_max).times(duration_s, rng)
        if cand.size == 0:
            return cand
        # rate floor: amplitudes > 1 would otherwise go negative at the
        # trough, which thinning would merely treat as 0 implicitly — make
        # the floor explicit so the profile is well-defined
        lam = np.maximum(0.0, self.rate * (1.0 + self.amplitude
                         * np.sin(2.0 * math.pi * cand / self.period_s)))
        keep = rng.uniform(0.0, 1.0, size=cand.size) < lam / lam_max
        return cand[keep]


@dataclass(frozen=True)
class TraceReplay(ArrivalProcess):
    """Replay recorded arrival times verbatim (rate is informational and
    defaults to 0.0 — replay has no free rate parameter).

    ``trace`` accepts any sequence of times (tuple, list, or a numpy
    vector straight from another process's :meth:`times` output) and is
    normalized to a tuple of Python floats at construction, so the replay
    round-trips another generator's stream without re-quantization: each
    ``numpy.float64`` converts to the bit-identical IEEE-754 double, and
    an engine run fed the replay reproduces the original run exactly
    (tested in ``tests/test_engine.py``).
    """
    rate: float = 0.0
    trace: Tuple[float, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "trace",
                           tuple(float(t) for t in self.trace))

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        """Sort the recorded trace and clip it to the window; ``rng`` is
        unused (replay is deterministic)."""
        ts = np.sort(np.asarray(self.trace, dtype=np.float64))
        return ts[(ts >= 0.0) & (ts < duration_s)]

    def with_rate(self, rate: float) -> "ArrivalProcess":
        raise TypeError("TraceReplay cannot be rescaled to a target rate; "
                        "use a stochastic process for throughput search")


@dataclass(frozen=True)
class MergedArrivals(ArrivalProcess):
    """Deterministic multiplexer of independent component streams.

    Each component process (one per tenant) draws from its own child
    generator spawned off the handed ``rng`` (``Generator.spawn``), so

      * the merged stream is fully reproduced by one engine seed,
      * every component stream is statistically independent of the
        others, and
      * adding, removing or re-parameterizing one component never
        perturbs another component's draws (the children are indexed).

    :meth:`times_and_sources` is the engine-facing API: the merged sorted
    stream plus a parallel ``int32`` vector attributing each arrival to
    its component index (ties break toward the lower index — stable
    sort).  ``rate`` is derived (sum of component rates) unless given.
    """
    rate: float = -1.0
    processes: Tuple[ArrivalProcess, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "processes", tuple(self.processes))
        if not self.processes:
            raise ValueError("MergedArrivals needs at least one component "
                             "process")
        if self.rate < 0.0:
            object.__setattr__(
                self, "rate", float(sum(p.rate for p in self.processes)))

    def times_and_sources(self, duration_s: float, rng: np.random.Generator
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """The merged sorted arrival vector and the per-arrival component
        index, drawn from per-component child generators of ``rng``.

        A single-component merge passes ``rng`` straight through (there
        is nothing to interleave), so a one-tenant engine run consumes
        the arrival stream bit-identically to a classic single-tenant
        run — the golden-trace gate extends over the tenant layer.
        """
        if len(self.processes) == 1:
            ts = self.processes[0].times(duration_s, rng)
            return ts, np.zeros(ts.size, dtype=np.int32)
        rngs = rng.spawn(len(self.processes))
        parts = [p.times(duration_s, r)
                 for p, r in zip(self.processes, rngs)]
        times = np.concatenate(parts) if parts else np.empty(0)
        src = np.concatenate(
            [np.full(t.size, k, dtype=np.int32)
             for k, t in enumerate(parts)]) if parts else np.empty(0, np.int32)
        order = np.argsort(times, kind="stable")
        return times[order], src[order]

    def times(self, duration_s: float, rng: np.random.Generator) -> np.ndarray:
        return self.times_and_sources(duration_s, rng)[0]

    def with_rate(self, rate: float) -> "ArrivalProcess":
        """Rescale every component proportionally so the merged mean rate
        hits ``rate`` (fails for unscalable components like replay)."""
        if self.rate <= 0.0:
            raise TypeError("cannot rescale a zero-rate merged stream")
        f = rate / self.rate
        return MergedArrivals(
            rate=rate,
            processes=tuple(p.with_rate(p.rate * f) for p in self.processes))


ARRIVAL_KINDS: Dict[str, Type[ArrivalProcess]] = {
    "poisson": PoissonProcess,
    "bursty": BurstyOnOff,
    "diurnal": DiurnalProcess,
    "trace": TraceReplay,
    "merged": MergedArrivals,
}


def make_arrivals(kind: str, rate: float, **kw) -> ArrivalProcess:
    """Factory used by benchmarks/examples: ``make_arrivals("bursty", 100)``."""
    try:
        cls = ARRIVAL_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown arrival kind {kind!r}; "
                         f"choose from {sorted(ARRIVAL_KINDS)}") from None
    return cls(rate=rate, **kw)
