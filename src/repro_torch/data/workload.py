"""LLM inferencing workload traces (Azure-2024-calibrated synthetic).

The paper uses one week of Azure *coding* and *conversation* production
traces [11]. The public dataset is not shipped offline; we synthesize
traces matching every property the paper measures and exploits:

  Fig 12 (left)   input lengths 1..~8K tokens; coding ≈ 2× conversation at
                  the median (lognormal marginals below);
  Fig 12 (middle) outputs within ~1K tokens; conversation ≈ 6× coding at
                  the 95th percentile;
  Fig 12 (right)  strong diurnal + weekly arrival pattern;
  Fig 7           arrival-count lag-1 autocorrelation > 0.99 at 15-min
                  granularity (slowly-varying AR modulation keeps it high).

Requests are classified into the paper's 9 buckets {S,M,L}×{S,M,L} by the
33rd/66th length percentiles *of the week itself* (§5.1), so the class
boundaries are data-derived exactly as in the paper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.stats import percentiles
from repro_torch.data.wind import SLOT_MINUTES, SLOTS_PER_DAY, WEEK_SLOTS

CLASSES = ["SS", "SM", "SL", "MS", "MM", "ML", "LS", "LM", "LL"]

# lognormal (median, sigma) for token lengths, calibrated to Fig 12
LENGTH_PARAMS = {
    # input: coding 2x conversation at median; both reach ~8K tails
    "conversation": {"in": (950.0, 0.95), "out": (220.0, 0.85)},
    # conversation outputs ~6x coding at p95
    "coding": {"in": (1900.0, 0.90), "out": (80.0, 0.55)},
}
MAX_INPUT = 8192
MAX_OUTPUT = 1024


@dataclass
class WorkloadTrace:
    name: str
    # per-slot arrival counts [WEEK_SLOTS]
    arrivals: np.ndarray
    # per-request lengths for one *representative pool* (resampled on demand)
    input_lens: np.ndarray
    output_lens: np.ndarray
    in_edges: tuple[float, float]    # 33rd/66th pctile boundaries
    out_edges: tuple[float, float]

    # ---- classification (paper §5.1) ----
    def classify(self, lin: np.ndarray, lout: np.ndarray) -> np.ndarray:
        i = np.digitize(lin, self.in_edges)      # 0,1,2 = S,M,L
        o = np.digitize(lout, self.out_edges)
        return i * 3 + o                          # index into CLASSES

    def class_mix(self) -> np.ndarray:
        """[9] fraction of requests per class over the week."""
        c = self.classify(self.input_lens, self.output_lens)
        return np.bincount(c, minlength=9) / len(c)

    def class_arrivals(self, multiplier: float = 1.0) -> np.ndarray:
        """[9, WEEK_SLOTS] expected per-class arrivals per 15-min slot."""
        mix = self.class_mix()[:, None]
        return mix * self.arrivals[None, :] * multiplier

    def mean_lengths(self) -> list[tuple[float, float]]:
        """[(mean_in, mean_out)] per class — drives the profiling exercise."""
        c = self.classify(self.input_lens, self.output_lens)
        out = []
        for k in range(9):
            m = c == k
            if m.sum() == 0:
                out.append((float(np.mean(self.input_lens)),
                            float(np.mean(self.output_lens))))
            else:
                out.append((float(self.input_lens[m].mean()),
                            float(self.output_lens[m].mean())))
        return out

    def sample_requests(self, n: int, seed: int = 0):
        """(input_lens, output_lens, class_ids) for n fresh requests."""
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(self.input_lens), n)
        lin, lout = self.input_lens[idx], self.output_lens[idx]
        return lin, lout, self.classify(lin, lout)


def _diurnal_profile(name: str, rng) -> np.ndarray:
    """[WEEK_SLOTS] multiplicative arrival intensity, mean 1."""
    t = np.arange(WEEK_SLOTS)
    hour = (t % SLOTS_PER_DAY) / SLOTS_PER_DAY * 24
    day = t // SLOTS_PER_DAY
    if name == "coding":
        # work-hours peaked, strong weekday/weekend contrast
        base = 0.35 + 1.0 * np.exp(-0.5 * ((hour - 14.0) / 3.6) ** 2)
        weekly = np.where(day % 7 >= 5, 0.45, 1.0)
    else:
        # conversation: broader daytime bump, smaller weekend dip
        base = 0.45 + 0.85 * np.exp(-0.5 * ((hour - 15.5) / 5.0) ** 2)
        weekly = np.where(day % 7 >= 5, 0.8, 1.0)
    # slowly-varying AR(1) modulation — keeps lag-1 autocorr ~0.99+
    ar = np.empty(WEEK_SLOTS)
    ar[0] = 0.0
    phi, sig = 0.996, 0.012
    eps = rng.standard_normal(WEEK_SLOTS)
    for i in range(1, WEEK_SLOTS):
        ar[i] = phi * ar[i - 1] + sig * eps[i]
    prof = base * weekly * np.exp(ar)
    return prof / prof.mean()


def _lognormal_lengths(rng, n, median, sigma, max_val):
    x = rng.lognormal(np.log(median), sigma, n)
    return np.clip(np.round(x), 1, max_val).astype(np.int64)


def make_trace(name: str, *, base_rps: float = 1.0, seed: int = 11,
               pool: int = 200_000) -> WorkloadTrace:
    """One week of ``coding`` | ``conversation`` workload.

    ``base_rps`` is the mean arrival rate (req/s) before the paper's
    volume multipliers (60× coding / 50× conversation in §5.2).
    """
    assert name in LENGTH_PARAMS, name
    rng = np.random.default_rng(seed + (0 if name == "coding" else 1))
    prof = _diurnal_profile(name, rng)
    per_slot_mean = base_rps * 60 * SLOT_MINUTES
    arrivals = rng.poisson(prof * per_slot_mean).astype(np.int64)
    pin = LENGTH_PARAMS[name]["in"]
    pout = LENGTH_PARAMS[name]["out"]
    lin = _lognormal_lengths(rng, pool, *pin, MAX_INPUT)
    lout = _lognormal_lengths(rng, pool, *pout, MAX_OUTPUT)
    in_edges = tuple(percentiles(lin, (33, 66)))
    out_edges = tuple(percentiles(lout, (33, 66)))
    return WorkloadTrace(name=name, arrivals=arrivals, input_lens=lin,
                         output_lens=lout, in_edges=in_edges, out_edges=out_edges)


# ------------------------------------------------------------------
# streamed million-user request generator (co-sim tentpole)
# ------------------------------------------------------------------
# internal generation granularity: requests are drawn per fixed BLOCK_S-
# second block with a per-(seed, block) substream, then re-chunked to the
# caller's chunk_s — so the SAME seed yields the SAME request stream for
# ANY chunk size (pinned by tests/test_e2e.py)
STREAM_BLOCK_S = 60.0


@dataclass
class RequestChunk:
    """One time-slice of the streamed workload (struct-of-arrays).

    All arrays share the row index; rows are sorted by ``arrival_s``.
    ``site`` is the request's *home affinity* (the region's site a user
    would hit by geography) — the routing layer may land it elsewhere.
    """
    start_s: float
    end_s: float
    rid: np.ndarray         # [n] int64 globally unique (per stream)
    arrival_s: np.ndarray   # [n] float absolute seconds
    site: np.ndarray        # [n] int32 home-site affinity
    lin: np.ndarray         # [n] int64 input tokens
    lout: np.ndarray        # [n] int64 output tokens
    cls: np.ndarray         # [n] int8 paper 9-bucket class id
    kind: np.ndarray        # [n] int8 index into the stream's traces

    def __len__(self) -> int:
        return len(self.rid)


def _region_map(num_sites: int, num_regions: Optional[int]) -> np.ndarray:
    """[S] region id per site — sites round-robin across regions."""
    R = min(num_regions or min(4, num_sites), num_sites)
    return np.arange(num_sites, dtype=np.int64) % max(R, 1)


def stream_requests(
        traces: Union[WorkloadTrace, Sequence[WorkloadTrace]], *,
        num_users: int, num_sites: int, duration_s: float,
        start_s: float = 0.0, chunk_s: float = 60.0, seed: int = 0,
        requests_per_user_day: float = 1.0,
        num_regions: Optional[int] = None,
        region_of_site: Optional[np.ndarray] = None,
) -> Iterator[RequestChunk]:
    """Stream ``(arrival_s, site_affinity, lin, lout)`` requests for a
    user population scaled to ``num_users`` — without materializing the
    week in memory.

    Structure, calibrated to the same Azure-2024 shapes as
    ``make_trace``:

      * total demand: ``num_users * requests_per_user_day / 86400`` mean
        fleet rps, split across ``traces`` proportionally to each
        trace's own arrival volume;
      * diurnal/weekly shape: each trace's per-slot arrival profile
        (Fig 12 right — includes the AR(1) modulation that keeps lag-1
        autocorrelation > 0.99), evaluated at each request's local time;
      * regional structure: sites belong to regions (round-robin by
        default, or an explicit ``region_of_site``), each region's
        diurnal phase shifted by its share of the 24-hour cycle and its
        users' requests carrying that region's sites as home affinity;
      * lengths/classes: per-request lognormal draws from the trace's
        Fig-12 marginals, classified by the trace's own 33/66 edges.

    Determinism: requests are drawn in fixed ``STREAM_BLOCK_S`` blocks
    from per-``(seed, block)`` SeedSequence substreams and re-chunked to
    ``chunk_s``, so the stream is bit-identical across chunk sizes and
    insensitive to how much of the week a consumer actually pulls.
    ``rid`` is the running request index from ``start_s`` (unique per
    stream instance).
    """
    tr = [traces] if isinstance(traces, WorkloadTrace) else list(traces)
    assert tr, "need at least one trace"
    assert num_sites >= 1
    region = (np.asarray(region_of_site, np.int64)
              if region_of_site is not None
              else _region_map(num_sites, num_regions))
    R = int(region.max()) + 1
    sites_of = [np.where(region == r)[0].astype(np.int32) for r in range(R)]
    # region share of users = its share of sites; empty regions get none
    share = np.array([len(s) for s in sites_of], float)
    share = share / share.sum()
    # regional diurnal phase: spread evenly across the day (slot units)
    offset_slots = np.array([(r * SLOTS_PER_DAY) // R for r in range(R)])

    # per-trace normalized diurnal profile (mean 1) and rps split
    profs = [t.arrivals / max(float(t.arrivals.mean()), 1e-12) for t in tr]
    vol = np.array([float(t.arrivals.sum()) for t in tr])
    total_rps = num_users * requests_per_user_day / 86400.0
    kind_rps = total_rps * vol / vol.sum()

    slot_s = SLOT_MINUTES * 60.0
    end_s = start_s + duration_s
    b0 = int(np.floor(start_s / STREAM_BLOCK_S))
    b1 = int(np.ceil(end_s / STREAM_BLOCK_S))
    rid0 = 0
    pending: list[tuple] = []      # generated blocks awaiting a chunk edge
    chunk_lo = start_s

    def _emit(chunk_hi: float) -> RequestChunk:
        nonlocal pending, chunk_lo
        cols = _concat_chunks(pending)
        m = cols[1] < chunk_hi
        out = RequestChunk(start_s=chunk_lo, end_s=chunk_hi,
                           rid=cols[0][m], arrival_s=cols[1][m],
                           site=cols[2][m], lin=cols[3][m], lout=cols[4][m],
                           cls=cols[5][m], kind=cols[6][m])
        pending = [tuple(c[~m] for c in cols)]
        chunk_lo = chunk_hi
        return out

    for b in range(b0, b1):
        t_lo = max(b * STREAM_BLOCK_S, start_s)
        t_hi = min((b + 1) * STREAM_BLOCK_S, end_s)
        if t_hi <= t_lo:
            continue
        rng = np.random.default_rng(np.random.SeedSequence((seed, b)))
        cols, n = _draw_block(rng, tr, profs, kind_rps, share, offset_slots,
                              sites_of, t_lo, t_hi, slot_s, rid0)
        rid0 += n
        if n:
            pending.append(cols)
        # every chunk fully covered by generated blocks can stream out
        while chunk_lo + chunk_s <= t_hi:
            yield _emit(chunk_lo + chunk_s)
    if chunk_lo < end_s or (chunk_lo == start_s and duration_s >= 0):
        yield _emit(end_s)         # final (possibly partial) chunk


def _concat_chunks(parts: list[tuple]) -> tuple:
    if not parts:
        z = np.zeros(0)
        return (z.astype(np.int64), z, z.astype(np.int32), z.astype(np.int64),
                z.astype(np.int64), z.astype(np.int8), z.astype(np.int8))
    return tuple(np.concatenate([p[i] for p in parts])
                 for i in range(len(parts[0])))


def _draw_block(rng, traces, profs, kind_rps, share, offset_slots, sites_of,
                t_lo, t_hi, slot_s, rid0):
    """Draw one block's requests (all kinds x regions, fixed draw order)."""
    span = t_hi - t_lo
    arrs, sites, lins, louts, clss, kinds = [], [], [], [], [], []
    for k, trace in enumerate(traces):
        prof = profs[k]
        for r in range(len(share)):
            if share[r] <= 0:
                continue
            # local time: the region's diurnal phase leads by its offset
            slot = int(t_lo // slot_s + offset_slots[r]) % len(prof)
            lam = kind_rps[k] * share[r] * prof[slot] * span
            n = int(rng.poisson(lam))
            if n == 0:
                continue
            arrs.append(t_lo + rng.uniform(0.0, span, n))
            sites.append(rng.choice(sites_of[r], size=n))
            pin = LENGTH_PARAMS[trace.name]["in"]
            pout = LENGTH_PARAMS[trace.name]["out"]
            lin = _lognormal_lengths(rng, n, *pin, MAX_INPUT)
            lout = _lognormal_lengths(rng, n, *pout, MAX_OUTPUT)
            lins.append(lin)
            louts.append(lout)
            clss.append(trace.classify(lin, lout).astype(np.int8))
            kinds.append(np.full(n, k, np.int8))
    if not arrs:
        return _concat_chunks([]), 0
    arr = np.concatenate(arrs)
    order = np.argsort(arr, kind="stable")
    n = len(arr)
    cols = (rid0 + np.arange(n, dtype=np.int64),
            arr[order],
            np.concatenate(sites)[order].astype(np.int32),
            np.concatenate(lins)[order],
            np.concatenate(louts)[order],
            np.concatenate(clss)[order],
            np.concatenate(kinds)[order])
    return cols, n
