"""Seeded traffic generators for the load driver (a copy of
``tpu_on_k8s/sim/traffic.py``: numpy only, so one seeded
``np.random.default_rng`` gives the reference's arrays bit for bit).

Two generators, two scales:

* ``build_workload`` — the load driver's generator (``serve_load.py``
  re-imports it). It materializes per-request prompt token arrays and
  draws from the rng one request at a time — made for the soak-scale
  traces (tens to hundreds of requests) every soak replays
  byte-identically, too slow at a million requests (per-request ndarray
  allocation the simulator never reads).
* ``build_diurnal_trace`` — the vectorized million-scale variant: a
  sinusoidal diurnal rate curve times per-tenant weights, Poisson
  counts per tick, and flat numpy columns (prompt *lengths*, not
  tokens — a virtual device layer prices work by length).

Both take the seeded ``numpy`` Generator IN — the caller owns
determinism, the trace is a pure function of (seed, parameters).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Arrival:
    """One scheduled request of the trace."""

    step: int
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline_s: Optional[float] = None


def build_workload(rng: np.random.Generator, n_requests: int, *,
                   rate: float = 2.0,
                   prompt_lens: Sequence[int] = (4, 24),
                   new_tokens: Sequence[int] = (4, 16),
                   tenants: Sequence[str] = ("tenant-a", "tenant-b",
                                             "tenant-c"),
                   vocab_size: int = 256,
                   deadline_s: Optional[float] = None,
                   deadline_fraction: float = 0.0,
                   shared_prefixes: int = 0,
                   shared_prefix_len: int = 0,
                   shared_fraction: float = 0.0,
                   burst_start: int = 0,
                   burst_len: int = 0,
                   burst_rate: float = 0.0) -> List[Arrival]:
    """A reproducible trace: Poisson(``rate``) arrivals per engine step
    (the seeded ``rng`` is passed IN — the caller owns determinism), mixed
    uniform prompt/output lengths, tenants round-tripped through the same
    rng. ``deadline_fraction`` of requests carry ``deadline_s``. With
    ``shared_prefixes`` > 0, ``shared_fraction`` of requests prepend one
    of that many fixed ``shared_prefix_len``-token prefixes (the
    system-prompt shape real traffic has — what the fleet router's prefix
    affinity exists to exploit; fully independent prompts would leave
    that path structurally cold). With ``burst_len`` > 0, steps in
    ``[burst_start, burst_start + burst_len)`` arrive at ``burst_rate``
    instead of ``rate`` — the bursty trace the SLO autoscaler's reactive
    loop is measured against."""
    pool = [rng.integers(0, vocab_size,
                         size=shared_prefix_len).astype(np.int32)
            for _ in range(shared_prefixes)] if shared_prefix_len else []
    arrivals: List[Arrival] = []
    step = 0
    while len(arrivals) < n_requests:
        step_rate = (burst_rate if burst_len > 0
                     and burst_start <= step < burst_start + burst_len
                     else rate)
        for _ in range(min(int(rng.poisson(step_rate)),
                           n_requests - len(arrivals))):
            lp = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
            prompt = rng.integers(0, vocab_size, size=lp).astype(np.int32)
            if pool and rng.random() < shared_fraction:
                prompt = np.concatenate(
                    [pool[int(rng.integers(len(pool)))], prompt])
            arrivals.append(Arrival(
                step=step,
                tenant=str(tenants[int(rng.integers(len(tenants)))]),
                prompt=prompt,
                max_new_tokens=int(rng.integers(new_tokens[0],
                                                new_tokens[1] + 1)),
                deadline_s=(deadline_s
                            if deadline_s is not None
                            and rng.random() < deadline_fraction else None)))
        step += 1
    return arrivals


# --------------------------------------------------------- diurnal traffic
@dataclasses.dataclass(frozen=True)
class TenantMix:
    """Named tenants and their relative traffic weights (normalized at
    draw time — ``(2, 1, 1)`` means the first tenant sends half the
    requests)."""

    names: Tuple[str, ...] = ("tenant-a", "tenant-b", "tenant-c")
    weights: Tuple[float, ...] = (1.0, 1.0, 1.0)

    def __post_init__(self):
        if len(self.names) != len(self.weights) or not self.names:
            raise ValueError("TenantMix needs matching non-empty "
                             "names/weights")
        if min(self.weights) < 0 or sum(self.weights) <= 0:
            raise ValueError("TenantMix weights must be >= 0, sum > 0")


@dataclasses.dataclass(frozen=True)
class DiurnalProfile:
    """The day-shaped arrival-rate curve: a cosine with its crest at
    ``peak_at_s``, modulated ``amplitude`` around ``base_rate``, plus
    explicit burst windows (start, length, rate multiplier) layered on
    top — the flash-crowd spikes a smooth curve alone can never give
    the autoscaler to chew on."""

    base_rate: float = 12.5                 # requests/s averaged over a day
    amplitude: float = 0.6                  # 0 = flat, 1 = trough hits zero
    period_s: float = 86_400.0
    peak_at_s: float = 0.6 * 86_400.0       # mid-afternoon crest
    bursts: Tuple[Tuple[float, float, float], ...] = ()

    def __post_init__(self):
        if self.base_rate <= 0 or self.period_s <= 0:
            raise ValueError("base_rate and period_s must be > 0")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError("amplitude must be in [0, 1]")


def diurnal_rate(profile: DiurnalProfile, t: float) -> float:
    """Instantaneous arrival rate (requests/s) at virtual time ``t``."""
    phase = 2.0 * math.pi * (t - profile.peak_at_s) / profile.period_s
    r = profile.base_rate * (1.0 + profile.amplitude * math.cos(phase))
    for start, length, mult in profile.bursts:
        if start <= t < start + length:
            r *= mult
    return max(r, 0.0)


@dataclasses.dataclass(frozen=True)
class ModelMix:
    """Named models and their relative traffic weights — the
    multi-model analogue of `TenantMix`. `zipf` builds the canonical
    long-tail catalog (weight ``1/rank^s``): a handful of hot models
    and a cold tail, the shape that makes one-replica-per-model
    deployments waste chips and model pooling pay."""

    names: Tuple[str, ...]
    weights: Tuple[float, ...]

    def __post_init__(self):
        if len(self.names) != len(self.weights) or not self.names:
            raise ValueError("ModelMix needs matching non-empty "
                             "names/weights")
        if min(self.weights) < 0 or sum(self.weights) <= 0:
            raise ValueError("ModelMix weights must be >= 0, sum > 0")

    @staticmethod
    def zipf(n: int, s: float = 1.05, prefix: str = "model") -> "ModelMix":
        if n <= 0:
            raise ValueError("zipf catalog needs n >= 1")
        return ModelMix(
            names=tuple(f"{prefix}-{i:02d}" for i in range(n)),
            weights=tuple(1.0 / (i + 1) ** s for i in range(n)))


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A million-scale trace as flat numpy columns, one row per request,
    sorted by tick. Prompt *lengths* only — the simulated device layer
    prices prefill by length and never reads token values, and a million
    per-request ndarrays is exactly the allocation cost this generator
    exists to avoid. ``tick_offsets[i] : tick_offsets[i+1]`` slices the
    rows arriving at tick ``i`` (len = n_ticks + 1). The ``model``
    column exists only for multi-model traces (``models`` passed to the
    builder); single-model traces leave it None and draw nothing extra
    from the rng, so their bytes are unchanged."""

    tick_s: float
    tick: np.ndarray                        # int64 tick index per request
    prompt_len: np.ndarray                  # int32
    new_tokens: np.ndarray                  # int32
    tenant: np.ndarray                      # int16 index into tenant_names
    tenant_names: Tuple[str, ...]
    tick_offsets: np.ndarray                # int64, len n_ticks + 1
    model: Optional[np.ndarray] = None      # int16 index into model_names
    model_names: Tuple[str, ...] = ()

    @property
    def n(self) -> int:
        return int(self.tick.shape[0])

    @property
    def n_ticks(self) -> int:
        return int(self.tick_offsets.shape[0]) - 1

    def rows_for_tick(self, i: int) -> range:
        return range(int(self.tick_offsets[i]),
                     int(self.tick_offsets[i + 1]))

    def tenant_counts(self):
        """{tenant name: request count} — summary/report material."""
        counts = np.bincount(self.tenant, minlength=len(self.tenant_names))
        return {name: int(counts[i])
                for i, name in enumerate(self.tenant_names)}

    def model_of(self, j: int) -> str:
        """Model name of request row ``j`` ('' on single-model traces)."""
        if self.model is None:
            return ""
        return self.model_names[int(self.model[j])]

    def model_counts(self):
        """{model name: request count} ({} on single-model traces)."""
        if self.model is None:
            return {}
        counts = np.bincount(self.model, minlength=len(self.model_names))
        return {name: int(counts[i])
                for i, name in enumerate(self.model_names)}


def build_diurnal_trace(rng: np.random.Generator, *,
                        profile: DiurnalProfile,
                        tenants: TenantMix = TenantMix(),
                        duration_s: float,
                        tick_s: float = 1.0,
                        prompt_lens: Sequence[int] = (4, 24),
                        new_tokens: Sequence[int] = (4, 16),
                        models: Optional[ModelMix] = None) -> ArrivalTrace:
    """The vectorized diurnal trace: per-tick rates off the profile
    curve, one Poisson draw per tick (vectorized), then single vectorized
    uniform draws for every per-request column. Draw order is fixed —
    (counts, prompt_len, new_tokens, tenant[, model]) — so a trace is a
    pure function of (seed, parameters); same seed, same bytes. The
    model column draws LAST and only when ``models`` is given, so every
    pre-existing single-model trace keeps its exact bytes."""
    n_ticks = int(math.ceil(duration_s / tick_s))
    if n_ticks <= 0:
        raise ValueError("duration_s must cover at least one tick")
    times = np.arange(n_ticks, dtype=np.float64) * tick_s
    rates = (profile.base_rate
             * (1.0 + profile.amplitude
                * np.cos(2.0 * np.pi * (times - profile.peak_at_s)
                         / profile.period_s)))
    for start, length, mult in profile.bursts:
        mask = (times >= start) & (times < start + length)
        rates[mask] *= mult
    np.maximum(rates, 0.0, out=rates)
    counts = rng.poisson(rates * tick_s)
    total = int(counts.sum())
    tick = np.repeat(np.arange(n_ticks, dtype=np.int64), counts)
    lp = rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                      size=total).astype(np.int32)
    nt = rng.integers(new_tokens[0], new_tokens[1] + 1,
                      size=total).astype(np.int32)
    w = np.asarray(tenants.weights, dtype=np.float64)
    edges = np.cumsum(w / w.sum())
    tenant = np.searchsorted(edges, rng.random(total),
                             side="right").astype(np.int16)
    np.minimum(tenant, len(tenants.names) - 1, out=tenant)
    model = None
    model_names: Tuple[str, ...] = ()
    if models is not None:
        mw = np.asarray(models.weights, dtype=np.float64)
        medges = np.cumsum(mw / mw.sum())
        model = np.searchsorted(medges, rng.random(total),
                                side="right").astype(np.int16)
        np.minimum(model, len(models.names) - 1, out=model)
        model_names = tuple(models.names)
    offsets = np.zeros(n_ticks + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return ArrivalTrace(tick_s=float(tick_s), tick=tick, prompt_len=lp,
                        new_tokens=nt, tenant=tenant,
                        tenant_names=tuple(tenants.names),
                        tick_offsets=offsets, model=model,
                        model_names=model_names)
