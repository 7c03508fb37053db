"""Wind power generation traces (EMHIRES-calibrated synthetic).

The paper's evaluation uses hourly EMHIRES generation for 4 wind farms
(Iceland, Norway, Switzerland, UK; assumed peak 250 MW each) scaled in time
to one week at 15-min granularity, plus the long-term (1 year) 20th-
percentile thresholds that size each site's compute:

    Iceland 29 MW · Norway 16.5 MW · Switzerland 7 MW · UK 13.25 MW

The dataset itself is not shipped offline, so we synthesize traces with the
properties the paper measures and leverages:

  * lag-1 autocorrelation ≥ 0.98 at 15-min granularity (§2.3.1: 0.991/0.989)
    — from an Ornstein-Uhlenbeck latent with a long correlation time;
  * cross-site complementarity — site latents mix a shared weather
    component with site-specific systems at low/negative correlation, so
    aggregate CoV ≈ 0.45-0.5 (paper: 0.475 for the 4-country pick);
  * exact long-term percentile calibration — each site's marginal is
    quantile-mapped onto a Beta marginal whose 20th pctile equals the
    paper's threshold, so right-sizing reproduces the same MW numbers.

Everything is deterministic given ``seed``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SLOT_MINUTES = 15
SLOTS_PER_DAY = 24 * 60 // SLOT_MINUTES
WEEK_SLOTS = 7 * SLOTS_PER_DAY          # 672
YEAR_SLOTS = 365 * SLOTS_PER_DAY

# (name, peak_MW, paper 20th-ptile threshold MW, marginal beta params)
PAPER_SITES = [
    ("iceland",     250.0, 29.00),
    ("norway",      250.0, 16.50),
    ("switzerland", 250.0,  7.00),
    ("uk",          250.0, 13.25),
]


@dataclass
class WindSite:
    name: str
    peak_mw: float
    series_mw: np.ndarray          # [T] generation at 15-min slots
    long_term_mw: np.ndarray       # [T_year] calibration series

    def percentile_mw(self, pct: float) -> float:
        return float(np.percentile(self.long_term_mw, pct))


@dataclass
class WindFleet:
    sites: list[WindSite]

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.sites]

    def week(self) -> np.ndarray:
        """[S, WEEK_SLOTS] MW."""
        return np.stack([s.series_mw[:WEEK_SLOTS] for s in self.sites])

    def aggregate_cov(self) -> float:
        agg = np.stack([s.long_term_mw for s in self.sites]).sum(0)
        return float(agg.std() / agg.mean())

    def site_cov(self, i: int) -> float:
        s = self.sites[i].long_term_mw
        return float(s.std() / s.mean())


def _ou_latent(rng, n, *, tau_slots: float, jitter: float = 0.15):
    """Ornstein-Uhlenbeck latent: autocorr(1) = exp(-1/tau).

    The AR(1) recursion ``z[t] = phi z[t-1] + sig eps[t]`` runs through
    ``scipy.signal.lfilter`` — the same C-loop arithmetic as the scalar
    Python recursion (same draws, same order, same float64 operations),
    so traces are bit-identical to the historical loop while year-long
    latents stop dominating population construction.
    """
    from scipy.signal import lfilter
    phi = np.exp(-1.0 / tau_slots)
    sig = np.sqrt(1 - phi * phi)
    z0 = rng.standard_normal()
    eps = rng.standard_normal(n)
    x = sig * eps
    x[0] = z0
    z = lfilter([1.0], [1.0, -phi], x)
    # slow seasonal modulation (multi-day weather systems)
    t = np.arange(n)
    season = jitter * np.sin(2 * np.pi * t / (SLOTS_PER_DAY * 3.7) + rng.uniform(0, 6))
    return z + season


def _quantile_map_to_beta(z: np.ndarray, a: float, b: float) -> np.ndarray:
    """Rank-preserving map of ``z`` onto a Beta(a, b) marginal in [0, 1]."""
    from scipy.stats import beta as beta_dist
    ranks = z.argsort().argsort()
    u = (ranks + 0.5) / len(z)
    return beta_dist.ppf(u, a, b)


def _calibrate_beta(target_p20: float, mean_hint: float) -> tuple[float, float]:
    """Find Beta(a,b) with ~mean_hint mean whose 20th pctile is target_p20."""
    from scipy.optimize import brentq
    from scipy.stats import beta as beta_dist

    def p20_of(a):
        b = a * (1 - mean_hint) / mean_hint
        return beta_dist.ppf(0.20, a, b) - target_p20

    lo, hi = 0.05, 50.0
    # p20 rises with a (tighter distribution): bracket then solve
    if p20_of(lo) > 0:
        a = lo
    elif p20_of(hi) < 0:
        a = hi
    else:
        a = brentq(p20_of, lo, hi)
    return a, a * (1 - mean_hint) / mean_hint


def make_default_fleet(seed: int = 7, weeks: int = 1) -> WindFleet:
    """The paper's 4-site European fleet, one year of 15-min generation."""
    rng = np.random.default_rng(seed)
    n = YEAR_SLOTS
    # shared weather component + per-site system; lags decorrelate the sites
    shared = _ou_latent(rng, n + 64, tau_slots=SLOTS_PER_DAY * 3.0)
    mean_hints = {"iceland": 0.52, "norway": 0.38, "switzerland": 0.27, "uk": 0.35}
    mix = {"iceland": 0.25, "norway": 0.35, "switzerland": 0.30, "uk": 0.40}
    lags = {"iceland": 0, "norway": 18, "switzerland": 40, "uk": 60}
    sites = []
    for name, peak, thresh in PAPER_SITES:
        own = _ou_latent(rng, n, tau_slots=SLOTS_PER_DAY * 2.4)
        lam = mix[name]
        z = np.sqrt(1 - lam ** 2) * own + lam * shared[lags[name]:lags[name] + n]
        a, b = _calibrate_beta(thresh / peak, mean_hints[name])
        frac = _quantile_map_to_beta(z, a, b)
        series = frac * peak
        sites.append(WindSite(name=name, peak_mw=peak,
                              series_mw=series[: weeks * WEEK_SLOTS].copy(),
                              long_term_mw=series))
    return WindFleet(sites=sites)


def lag1_autocorr(x: np.ndarray) -> float:
    x = np.asarray(x, float)
    x0, x1 = x[:-1] - x[:-1].mean(), x[1:] - x[1:].mean()
    return float((x0 * x1).mean() / (x0.std() * x1.std() + 1e-12))


def make_site_population(num_sites: int, seed: int = 13,
                         peak_range=(100.0, 1200.0)) -> list[WindSite]:
    """A population of farms for scalability/right-sizing studies (Fig 5/14r).

    Peak capacities follow a truncated Pareto (few giant farms, many small),
    matching the Global Energy Monitor's heavy-tailed size distribution.
    """
    rng = np.random.default_rng(seed)
    n = 8 * WEEK_SLOTS
    shared = _ou_latent(rng, n + 512, tau_slots=SLOTS_PER_DAY * 1.5)
    out = []
    for i in range(num_sites):
        peak = float(np.clip(peak_range[0] * (1 + rng.pareto(1.6)), *peak_range))
        own = _ou_latent(rng, n, tau_slots=SLOTS_PER_DAY * (0.8 + rng.uniform(0, 1.2)))
        lam = rng.uniform(0.2, 0.45)
        lag = int(rng.integers(0, 500))
        z = np.sqrt(1 - lam ** 2) * own + lam * shared[lag:lag + n]
        a, b = _calibrate_beta(rng.uniform(0.02, 0.12), rng.uniform(0.25, 0.5))
        series = _quantile_map_to_beta(z, a, b) * peak
        out.append(WindSite(name=f"site{i:03d}", peak_mw=peak,
                            series_mw=series[:WEEK_SLOTS].copy(), long_term_mw=series))
    return out


def make_synthetic_population(num_sites: int, seed: int = 13,
                              peak_range=(100.0, 1200.0),
                              weeks: int = 1) -> list[WindSite]:
    """Planner-scale population: fully vectorized, no per-site calibration.

    ``make_site_population`` pays an exact Beta quantile-map (brentq +
    ``beta.ppf`` over the full series) per site — the right marginal for
    right-sizing studies, but ~100 ms/site, which walls planning
    benchmarks at 4096-10240 sites. This generator keeps the properties
    the *planner* consumes — heavy-tailed Pareto peak capacities,
    high-autocorrelation cross-correlated power series, and a low
    (~2-12% of peak) long-term P20 that sizes each site's compute — but
    maps the latent onto its marginal with a rank map plus a
    closed-form power curve: per-site ranks give an exactly uniform
    ``u``, and ``frac = u ** (log f20 / log 0.2)`` places the 20th
    percentile at the drawn ``f20`` by construction. All draws and the
    rank maps are batched. Not a substitute where the exact Beta
    marginal matters (Fig. 3-5 right-sizing economics).
    """
    rng = np.random.default_rng(seed)
    S = int(num_sites)
    n = max(1, int(weeks)) * WEEK_SLOTS
    peak = np.clip(peak_range[0] * (1 + rng.pareto(1.6, S)), *peak_range)
    tau = SLOTS_PER_DAY * (0.8 + rng.uniform(0.0, 1.2, S))
    phi = np.exp(-1.0 / tau)                       # per-site AR(1) pole
    sig = np.sqrt(1.0 - phi * phi)
    z = np.empty((S, n))
    z[:, 0] = rng.standard_normal(S)
    eps = rng.standard_normal((S, n))
    for t in range(1, n):                          # vectorized across sites
        z[:, t] = phi * z[:, t - 1] + sig * eps[:, t]
    shared = _ou_latent(rng, n, tau_slots=SLOTS_PER_DAY * 1.5)
    lam = rng.uniform(0.2, 0.45, S)[:, None]
    z = np.sqrt(1.0 - lam ** 2) * z + lam * shared[None, :]
    # rank-preserving uniform marginal per site, then a power map
    # pinning the 20th percentile at the drawn P20 fraction
    ranks = z.argsort(axis=1).argsort(axis=1)
    u = (ranks + 0.5) / n
    f20 = rng.uniform(0.02, 0.12, S)
    gamma = np.log(f20) / np.log(0.2)
    series = (u ** gamma[:, None]) * peak[:, None]
    return [WindSite(name=f"site{i:04d}", peak_mw=float(peak[i]),
                     series_mw=series[i, :WEEK_SLOTS].copy(),
                     long_term_mw=series[i])
            for i in range(S)]
