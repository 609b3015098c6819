"""InferenceService API type: the serving half of the model pipeline.

The reference operator's serving story ends the moment the trained
artifact is baked into an OCI image (SURVEY §3.5 — ModelVersion sets
``Model.status.latest_image`` and stops). An ``InferenceService`` is the
missing kind that *deploys* that image: a declarative request for N
engine replicas on GPU slices, following a ``Model``'s latest image, with
a rollout policy that governs how traffic and capacity move when a new
``ModelVersion`` lands.

Two planes consume this type:

* `controller/inferenceservice.py` reconciles gang-scheduled replica pods
  from the spec (one gang of ``hosts_per_slice`` pods per replica) and
  drives the rolling rollout — surge within ``max_surge``, drain old
  replicas before deletion, never dip below
  ``replicas - max_unavailable`` ready;
* `serve/fleet.py` is the in-process realization of the same state
  machine: a ``ServingFleet`` owning one gateway per replica and a
  ``Router`` that honors the canary weight while a rollout progresses.

``RolloutPolicy`` deliberately mirrors a Deployment's rollingUpdate knobs
(maxSurge / maxUnavailable) plus the serving-specific ``canary_weight`` —
the traffic share the FIRST ready new-version replica receives before the
fleet commits to shifting the rest.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import ObjectMeta
from tpu_on_k8s_torch.api.types import GPUPolicy


@dataclass
class RolloutPolicy:
    """How a new model image replaces the old one under live traffic.

    ``max_surge`` extra replicas may exist above ``spec.replicas`` during
    a rollout (capacity first, then traffic); at most ``max_unavailable``
    of the desired replicas may be not-ready at any instant.
    ``canary_weight`` is the router share granted to the new version once
    its first replica is ready — held until more new replicas come up,
    after which the share grows with the replaced fraction.
    ``drain_seconds`` is the grace an old replica gets between
    stop-accepting and deletion (the serving analog of
    terminationGracePeriodSeconds)."""

    max_surge: int = 1
    max_unavailable: int = 0
    canary_weight: float = 0.1
    drain_seconds: float = 30.0

    def normalized(self) -> "RolloutPolicy":
        """Defaulted-and-clamped copy (API types stay passive records, like
        the reference's defaulting webhook shape): surge/unavailable floors
        at 0, surge forced to >= 1 when both knobs are 0 (a rollout that can
        neither add nor remove a replica would wedge), canary weight clamped
        to [0, 1], drain floored at 0."""
        surge = max(int(self.max_surge), 0)
        unavail = max(int(self.max_unavailable), 0)
        if surge == 0 and unavail == 0:
            surge = 1
        return RolloutPolicy(
            max_surge=surge, max_unavailable=unavail,
            canary_weight=min(max(float(self.canary_weight), 0.0), 1.0),
            drain_seconds=max(float(self.drain_seconds), 0.0))


@dataclass
class DecodePolicy:
    """Decode-path acceleration for a serving replica — the knobs behind
    the tokens-per-chip headline (`tpu_on_k8s_torch/models/serving.py`):

    * ``draft_model`` names the small draft checkpoint (a ``Model``
      ref, e.g. a GPT-2 draft loaded via the HF interop layer in
      `models/convert.py`) for batched speculative decoding; ``""``
      disables speculation. ``spec_k`` is the proposals-per-round
      window.
    * ``int8_weights`` serves W8A16 int8 weights
      (`models/convert.quantize_serving_tree`) instead of bf16 —
      ~half the weight bytes in the bandwidth-bound decode loop.

    A DecodePolicy change is part of what a replica RUNS: the
    reconciler folds it into the replica-group identity hash, so
    flipping int8 (or the draft) rolls the fleet through the SAME
    surge/drain/canary machinery a new image does — the router's canary
    split A/Bs the variant under live traffic before the fleet commits
    (`controller/inferenceservice.py`, `serve/router.py`)."""

    draft_model: str = ""
    spec_k: int = 4
    int8_weights: bool = False

    def normalized(self) -> "DecodePolicy":
        """Defaulted-and-clamped copy (same passive-record shape as
        ``RolloutPolicy``): the speculation window floors at 1."""
        return DecodePolicy(
            draft_model=str(self.draft_model),
            spec_k=max(int(self.spec_k), 1),
            int8_weights=bool(self.int8_weights))


@dataclass
class ShardingPolicy:
    """How each serving replica shards its engine over its slice's
    chips (`tpu_on_k8s_torch/models/serving.py` mesh path over
    `parallel/mesh.serving_mesh`): ``data`` × ``model`` × ``expert``
    must equal the replica's chip count. ``model`` carries
    tensor-parallel decode (attention heads / MLP dims split, per-layer
    collectives on ICI — the axis that lets one replica serve a model
    bigger than one chip's HBM), ``expert`` shards MoE expert tables,
    ``data`` splits the slot pool. ``rules`` names the partition-rule
    preset (``"serving"`` — `transformer.serving_partition_rules`, the
    int8-aware Megatron layout; ``"flagship"`` — the raw training
    rules).

    Like ``DecodePolicy``, the sharding is part of what a replica RUNS:
    the reconciler folds it into the replica identity hash, so changing
    the mesh shape ROLLS the fleet (surge → canary → drain) — params
    cannot be relaid out under a live engine's compiled programs. An
    absent block (or the all-1 default) is the single-program engine,
    bit-for-bit."""

    data: int = 1
    model: int = 1
    expert: int = 1
    rules: str = "serving"

    def normalized(self) -> "ShardingPolicy":
        """Defaulted-and-clamped copy (passive record, like
        ``RolloutPolicy``): axis sizes floor at 1; unknown rule presets
        fall back to "serving"."""
        rules = str(self.rules or "serving")
        if rules not in ("serving", "flagship"):
            rules = "serving"
        return ShardingPolicy(
            data=max(int(self.data), 1), model=max(int(self.model), 1),
            expert=max(int(self.expert), 1), rules=rules)

    @property
    def chips(self) -> int:
        """Chips one replica's mesh spans."""
        n = self.normalized()
        return n.data * n.model * n.expert

    def is_trivial(self) -> bool:
        """All-1 axes = the single-program engine: applying
        ``sharding: {}`` to a running fleet must not trigger a no-op
        rollout (same principle as ``decode: {}``)."""
        n = self.normalized()
        return n.data == n.model == n.expert == 1


@dataclass
class AutoscalePolicy:
    """SLO-driven replica autoscaling for the serving fleet (consumed by
    `controller/fleetautoscaler.py`; decision core in
    `tpu_on_k8s_torch/autoscale/policy.py`). Setting this block opts the
    service into autoscaling: ``spec.replicas`` becomes the
    autoscaler's output rather than a hand-set value.

    ``target_ttft_s`` / ``target_queue_wait_s`` are the latency SLOs
    (p95, seconds; 0 disables that signal). ``util_high``/``util_low``
    bound tokens-in-flight per engine slot — the early-warning band that
    scales up before latency degrades. ``min_warm`` is the warm floor:
    replicas pre-provisioned for burst absorption, because a GPU slice
    spins up in minutes and reactive-only scaling structurally misses
    the front of every burst. ``hysteresis`` is the dead band around
    each target; ``max_step`` bounds how many slice-legal quanta one
    decision may jump; cooldowns and ``flap_guard_s`` (minimum spacing
    between direction reversals) set the tempo. ``slice_legal`` snaps
    targets to `gang/topology` host-count quanta for the service's
    accelerator (on a 3D-torus part, N+1 replicas may simply not
    exist)."""

    min_replicas: int = 1
    max_replicas: int = 8
    min_warm: int = 0
    target_ttft_s: float = 0.0
    target_queue_wait_s: float = 0.0
    #: TPOT p95 SLO (seconds per output token; 0 disables): the decode
    #: pool's scaling signal in disaggregated serving — queue-wait says
    #: "prefill cannot keep up", TPOT says "decode cannot keep up"
    target_tpot_s: float = 0.0
    #: model swap-in latency p95 SLO (seconds; 0 disables) for
    #: multi-model replicas (`serve/modelpool.py`): swap-in is the
    #: pool's cold-start cost, and when its p95 breaches this target the
    #: density bet has failed — models are fighting over too few
    #: replicas and the fleet needs more residency, exactly like a TTFT
    #: breach says it needs more decode seats
    target_swap_s: float = 0.0
    util_high: float = 0.0
    util_low: float = 0.0
    hysteresis: float = 0.1
    max_step: int = 1
    scale_up_cooldown_s: float = 30.0
    scale_down_cooldown_s: float = 120.0
    flap_guard_s: float = 180.0
    slice_legal: bool = True

    def normalized(self) -> "AutoscalePolicy":
        """Defaulted-and-clamped copy (same passive-record defaulting
        shape as ``RolloutPolicy``): floors at 1 replica, max >= min,
        warm floor within [0, max], non-negative targets/tempo, at
        least one legal step per decision."""
        lo = max(int(self.min_replicas), 1)
        hi = max(int(self.max_replicas), lo)
        return AutoscalePolicy(
            min_replicas=lo, max_replicas=hi,
            min_warm=min(max(int(self.min_warm), 0), hi),
            target_ttft_s=max(float(self.target_ttft_s), 0.0),
            target_queue_wait_s=max(float(self.target_queue_wait_s), 0.0),
            target_tpot_s=max(float(self.target_tpot_s), 0.0),
            target_swap_s=max(float(self.target_swap_s), 0.0),
            util_high=max(float(self.util_high), 0.0),
            util_low=max(float(self.util_low), 0.0),
            hysteresis=max(float(self.hysteresis), 0.0),
            max_step=max(int(self.max_step), 1),
            scale_up_cooldown_s=max(float(self.scale_up_cooldown_s), 0.0),
            scale_down_cooldown_s=max(float(self.scale_down_cooldown_s),
                                      0.0),
            flap_guard_s=max(float(self.flap_guard_s), 0.0),
            slice_legal=bool(self.slice_legal))


#: latency-percentile objectives an ``SLOObjective`` may target (the
#: ``availability`` objective rides beside them); the catalog matches
#: `tpu_on_k8s_torch/obs/slo.py` — the engine that evaluates these specs
SLO_OBJECTIVES = ("ttft_p95", "tpot_p95", "queue_wait_p95",
                  "availability")


@dataclass
class SLOObjective:
    """One declarative service-level objective: *what* is measured
    (``objective``), the ``target`` (seconds for latency percentiles; a
    fraction like 0.999 for availability), and the compliance
    ``window_s`` the error budget covers. The four burn windows default
    to the SRE ratios of ``window_s`` (5m/1h fast pair pages at
    ``page_burn``; 6h/3d slow pair warns at ``warn_burn`` — at the
    30-day default) and may be pinned explicitly. ``name`` keys the
    objective in ``status.slo`` and the metric labels."""

    name: str = ""
    objective: str = "ttft_p95"
    target: float = 0.0
    window_s: float = 2_592_000.0          # 30 days
    fast_short_s: float = 0.0              # 0 → window_s/8640
    fast_long_s: float = 0.0               # 0 → window_s/720
    slow_short_s: float = 0.0              # 0 → window_s/120
    slow_long_s: float = 0.0               # 0 → window_s/10
    page_burn: float = 14.4
    warn_burn: float = 1.0
    hysteresis: float = 0.2

    def normalized(self) -> Optional["SLOObjective"]:
        """Defaulted-and-clamped copy, or None when the objective can
        never evaluate (unknown objective name, non-positive target) —
        the API layer drops dead objectives rather than raising, the
        same passive-record posture as the other policies (the engine
        itself raises; a CRD must tolerate junk)."""
        if self.objective not in SLO_OBJECTIVES:
            return None
        if float(self.target) <= 0 or float(self.window_s) <= 0:
            return None
        return SLOObjective(
            name=str(self.name) or str(self.objective),
            objective=str(self.objective),
            target=float(self.target),
            window_s=float(self.window_s),
            fast_short_s=max(float(self.fast_short_s), 0.0),
            fast_long_s=max(float(self.fast_long_s), 0.0),
            slow_short_s=max(float(self.slow_short_s), 0.0),
            slow_long_s=max(float(self.slow_long_s), 0.0),
            page_burn=max(float(self.page_burn), 1.0),
            warn_burn=max(float(self.warn_burn), 0.0),
            hysteresis=min(max(float(self.hysteresis), 0.0), 0.9))


@dataclass
class SLOPolicy:
    """Service-level objectives for a serving fleet, evaluated by the
    fleet autoscaler's tick (`controller/fleetautoscaler.py` →
    `tpu_on_k8s_torch/obs/slo.py`): every tick feeds the scraped latency
    signals into sliding windows, computes multi-window error-budget
    burn rates per objective, writes the result to ``status.slo``, and
    — when an objective reaches ``page`` — lets one scale-up bypass the
    up-cooldown (dead-banded by the budget-state hysteresis, so a burn
    oscillating at the threshold cannot pump the fleet). Absent, none
    of this runs and the autoscaler's decision logs are byte-identical
    to the pre-SLO behavior."""

    objectives: List[SLOObjective] = field(default_factory=list)

    def normalized(self) -> "SLOPolicy":
        """Drops dead objectives and de-duplicates names (first wins —
        a duplicate would make ``status.slo`` ambiguous)."""
        out: List[SLOObjective] = []
        seen = set()
        for obj in self.objectives:
            norm = obj.normalized()
            if norm is None or norm.name in seen:
                continue
            seen.add(norm.name)
            out.append(norm)
        return SLOPolicy(objectives=out)


@dataclass
class SLOObjectiveStatus:
    """One objective's evaluated budget state in ``status.slo``:
    ``state`` is ``ok``/``warn``/``page``/``exhausted``; burn rates are
    the multi-window pair burns (-1 = no data in the window — JSON has
    no NaN, and absent-vs-zero must stay distinguishable on the wire);
    ``budget_remaining`` is the fraction of the window's error budget
    left (negative = overdrawn). ``stale`` means the signal source went
    dark — the burn rates are unknowable, NOT whatever they last were."""

    objective: str = ""
    target: float = 0.0
    state: str = "ok"
    burn_fast: float = -1.0
    burn_slow: float = -1.0
    budget_remaining: float = 1.0
    stale: bool = False


@dataclass
class ModelRef:
    """One model of a multi-model service (``spec.models``): a replica's
    ``ModelPool`` (`serve/modelpool.py`) hosts ALL of them behind one
    engine and hot-swaps the active params. ``name`` keys everything —
    the pool's request lanes, ledger ``model_swap`` records, metric
    labels, and ``status.models``. ``model_name`` follows that
    ``Model``'s ``status.latest_image`` (the same closed loop as
    ``spec.model_name``); ``image`` pins an explicit image and wins.
    All pooled models MUST share the service's config shape — a
    params-tree replace cannot change architecture (the pool's swap path
    enforces it; a mismatched ref surfaces as a swap failure, never a
    silent misload).

    ``token_budget`` is a per-model tokens/sec admission budget riding
    the tenant accounting plane (`serve/admission.py` — the model id is
    the tenant key; 0 = unlimited). ``slo`` carries per-MODEL objectives
    the fleet autoscaler evaluates into ``status.models[name].slo``
    beside the service-level ``spec.slo``."""

    name: str = ""
    model_name: str = ""
    image: str = ""
    token_budget: int = 0
    slo: Optional[SLOPolicy] = None

    def normalized(self) -> Optional["ModelRef"]:
        """Defaulted-and-clamped copy, or None for an unkeyable ref
        (empty ``name``) — the same drop-dead-entries posture as
        ``SLOObjective``."""
        if not str(self.name):
            return None
        return ModelRef(
            name=str(self.name),
            model_name=str(self.model_name),
            image=str(self.image),
            token_budget=max(int(self.token_budget), 0),
            slo=self.slo.normalized() if self.slo is not None else None)


@dataclass
class ModelStatus:
    """One pooled model's observed state in ``status.models``: the
    ``image`` the reconciler resolved for it (model-ref indirection
    follows ``Model.status.latest_image`` — pool membership converges by
    WEIGHT HOT-SWAP from here, never a pod rollout), a coarse ``phase``
    (``Pending`` while no image exists to load), and the per-model
    ``slo`` budget states the fleet autoscaler's tick writes (same shape
    as the service-level ``status.slo``)."""

    name: str = ""
    image: str = ""
    phase: str = "Pending"
    slo: Dict[str, SLOObjectiveStatus] = field(default_factory=dict)


@dataclass
class PoolSpec:
    """One pool of a disaggregated service (`tpu_on_k8s_torch/serve/disagg.py`).
    ``replicas`` is that pool's size — hand-set, or owned by the fleet
    autoscaler when ``autoscale`` is present (the per-pool twin of
    ``spec.autoscale``: queue-wait p95 is the natural target for the
    prefill pool, TPOT p95 for the decode pool)."""

    replicas: int = 1
    autoscale: Optional[AutoscalePolicy] = None

    def normalized(self) -> "PoolSpec":
        return PoolSpec(
            replicas=max(int(self.replicas), 1),
            autoscale=(self.autoscale.normalized()
                       if self.autoscale is not None else None))


@dataclass
class PoolsSpec:
    """Opt-in disaggregated prefill/decode serving: present, the service
    splits into a prefill pool (chunked prefill only, KV handoff out)
    and a decode pool (admits only handed-off KV), separately sized and
    separately autoscaled. Absent, the service runs today's monolithic
    replicas bit-for-bit. Engine shaping (slot counts, the handoff
    queue bound) stays with the runtime that builds the ``DisaggFleet``
    — a spec field the reconciler cannot yet honor (it does not mint
    pool-labelled pods) would silently do nothing."""

    prefill: PoolSpec = field(default_factory=PoolSpec)
    decode: PoolSpec = field(default_factory=PoolSpec)

    def normalized(self) -> "PoolsSpec":
        return PoolsSpec(
            prefill=self.prefill.normalized(),
            decode=self.decode.normalized())


@dataclass
class BrokerPolicy:
    """How the service participates in the capacity market
    (`tpu_on_k8s_torch/coordinator/broker.py`). ``priority`` orders the
    broker's victim search — a lane only ever loses chips to a
    STRICTLY higher-priority lane under pressure. ``unit_chips`` is
    the chips one replica occupies (the bid's allocation-unit size);
    ``preemption_cost`` is the tie-breaker among equal-priority
    victims (cheapest eviction first). ``degrade`` gates the rung-1
    pressure valve: allowed, the broker may flip this service onto
    cheaper ``DecodePolicy`` variants (int8 weights, deeper
    speculation) before taking anyone's chips. Absent ⇒ serving
    defaults (top priority, 1 chip per replica, degradable).

    ``priced`` opts the service into OBSERVED-signal bid pricing: the
    fleet autoscaler derives the bid's ``marginal_utility`` from the
    live SLO fast-burn rate plus queue depth per slot instead of the
    static 0.0 every unpriced bid carries — a burning, backed-up
    service becomes strictly more expensive to pick as a victim among
    equal-priority bids. Default off: all-static configs produce
    byte-identical broker decisions to pre-``priced`` builds."""

    priority: int = 100
    unit_chips: int = 1
    preemption_cost: float = 1.0
    degrade: bool = True
    priced: bool = False

    def normalized(self) -> "BrokerPolicy":
        return BrokerPolicy(
            priority=int(self.priority),
            unit_chips=max(int(self.unit_chips), 1),
            preemption_cost=max(float(self.preemption_cost), 0.0),
            degrade=bool(self.degrade),
            priced=bool(self.priced))


@dataclass
class InferenceServiceSpec:
    """``model_name`` follows that Model's ``status.latest_image`` (the
    closed train → image → deploy loop); ``image`` pins an explicit image
    instead (and wins when both are set). ``gpu_policy`` is the slice
    each replica occupies — a replica is one gang of ``hosts_per_slice``
    pods. ``n_slots`` / ``prefix_bucket_len`` parameterize the engine and
    router inside each replica (the serve plane reads them; the
    controller passes them through as env)."""

    model_name: str = ""
    image: str = ""
    replicas: int = 1
    gpu_policy: GPUPolicy = field(default_factory=GPUPolicy)
    rollout: RolloutPolicy = field(default_factory=RolloutPolicy)
    n_slots: int = 8
    prefix_bucket_len: int = 128
    #: present = autoscaled: `controller/fleetautoscaler.py` owns
    #: ``replicas`` (within [min_replicas, max_replicas]) from here on
    autoscale: Optional[AutoscalePolicy] = None
    #: present = disaggregated: replicas split into prefill/decode pools
    #: with KV handoff between them (`serve/disagg.py`); each pool's
    #: ``replicas`` is sized by its own ``PoolSpec`` (and, when that
    #: pool carries an ``autoscale`` block, by the fleet autoscaler's
    #: per-pool loop). Absent ⇒ monolithic serving, unchanged.
    pools: Optional[PoolsSpec] = None
    #: present = decode acceleration (speculative drafts and/or int8
    #: serving weights). Part of the replica-group identity: changing it
    #: rolls the fleet (surge/drain/canary) like a new image would.
    decode: Optional[DecodePolicy] = None
    #: present = mesh-sharded replicas: each engine runs
    #: tensor/expert-parallel over a {data, model, expert} mesh of its
    #: slice's chips. Part of the replica-group identity like
    #: ``decode``: a resharding ROLLS the fleet through the same
    #: surge/canary/drain machinery — never a live relayout.
    sharding: Optional[ShardingPolicy] = None
    #: present = SLO evaluation: the fleet autoscaler's tick runs the
    #: error-budget burn-rate engine (`tpu_on_k8s_torch/obs/slo.py`) over the
    #: scraped signals, writes ``status.slo``, and treats a paging
    #: objective as a scale-up severity hint. Absent ⇒ behavior-neutral.
    slo: Optional[SLOPolicy] = None
    #: present = explicit capacity-market terms for the broker
    #: (`coordinator/broker.py`); absent ⇒ serving defaults. Only
    #: consulted when the operator runs a broker at all — with none,
    #: this block is inert.
    broker: Optional[BrokerPolicy] = None
    #: non-empty = multi-model density: every replica hosts a
    #: ``ModelPool`` over these refs (`serve/modelpool.py`) and the
    #: router multiplexes by model (`serve/router.route_model`).
    #: MEMBERSHIP edits converge by weight hot-swap through
    #: ``status.models`` — they never roll the fleet; only toggling the
    #: block on/off does (the replica runtime must be built
    #: pool-capable, which is part of the replica identity).
    models: List[ModelRef] = field(default_factory=list)

    def models_normalized(self) -> List[ModelRef]:
        """The live model refs: dead entries dropped, duplicate names
        de-duplicated (first wins — a duplicate would make the pool's
        lanes and ``status.models`` ambiguous)."""
        out: List[ModelRef] = []
        seen = set()
        for ref in self.models:
            norm = ref.normalized()
            if norm is None or norm.name in seen:
                continue
            seen.add(norm.name)
            out.append(norm)
        return out


class ServicePhase(str, enum.Enum):
    PENDING = "Pending"            # no image to deploy yet
    PROGRESSING = "Progressing"    # scaling or rolling a new image
    READY = "Ready"                # all desired replicas on current image
    DEGRADED = "Degraded"          # ready count below the rollout floor


@dataclass
class InferenceServiceStatus:
    """``current_image`` is what the fleet is converging FROM,
    ``target_image`` what it is converging TO (equal once a rollout
    completes). ``canary_weight`` is the router share currently granted
    to ``target_image`` — 0 before the first new replica is ready, 1.0
    at completion — the single number the serve plane needs to split
    traffic consistently with the controller's rollout position."""

    phase: Optional[ServicePhase] = None
    message: str = ""
    current_image: str = ""
    target_image: str = ""
    replicas: int = 0              # replica gangs that exist (any version)
    ready_replicas: int = 0        # replica gangs fully Running+Ready
    updated_replicas: int = 0      # replica gangs on target_image
    canary_weight: float = 0.0
    observed_model_version: str = ""
    # --- autoscaler-owned (written by controller/fleetautoscaler.py) ---
    desired_replicas: int = 0      # the autoscaler's last committed target
    autoscale_message: str = ""    # last decision, human-readable
    #: per-pool committed targets for disaggregated services
    #: (``spec.pools.<pool>.autoscale`` loops) — {"prefill": n, ...}
    pool_desired_replicas: Dict[str, int] = field(default_factory=dict)
    #: per-objective error-budget state (``spec.slo`` present), written
    #: by the fleet autoscaler's tick — objective name → burn rates,
    #: budget remaining, typed state, staleness
    slo: Dict[str, SLOObjectiveStatus] = field(default_factory=dict)
    #: per-model observed state (``spec.models`` non-empty): the
    #: reconciler writes each entry's resolved ``image``/``phase`` (pool
    #: membership converges by hot-swap from here), the fleet autoscaler
    #: writes each entry's ``slo`` budget states
    models: Dict[str, ModelStatus] = field(default_factory=dict)


@dataclass
class InferenceService:
    api_version: str = f"{constants.API_GROUP}/{constants.API_VERSION}"
    kind: str = constants.KIND_INFERENCESERVICE
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: InferenceServiceSpec = field(default_factory=InferenceServiceSpec)
    status: InferenceServiceStatus = field(
        default_factory=InferenceServiceStatus)
