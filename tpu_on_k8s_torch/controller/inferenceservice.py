"""InferenceService controller: deploy the model image as a serving fleet
(the counterpart of ``tpu_on_k8s/controller/inferenceservice.py``, in the
GPU flavour).

The ModelVersion controller (`controller/modelversion.py`) ends at
``Model.status.latest_image`` — an OCI image nothing deploys. This
controller closes the loop: an ``InferenceService`` names a ``Model``
(or pins an image) and the reconciler converges a fleet of
**gang-scheduled replica pods** onto it:

* each replica is one GPU slice — a gang of ``hosts_per_slice`` pods
  sharing a podgroup annotation, with the accelerator nodeSelector and the
  ``nvidia.com/gpu`` requests of a whole host that the TorchJob
  reconciler uses (`controller/torchjob.py` set_cluster_spec). A GPU pod
  carries no topology selector and no TPU runtime env (``PJRT_DEVICE``,
  ``TPU_WORKER_ID``): a replica host's index stays in its
  ``task-index`` label, and no rendezvous env is written for a
  multi-host replica (the reference writes none either);
* a new image (a fresh ModelVersion landing on the Model) triggers a
  **rolling rollout**: surge new-version replicas within
  ``rollout.max_surge``, wait for their gangs to come Ready, then
  **drain** old replicas — annotate them with a drain deadline (the
  serve plane's ``stop_accepting()``; in-flight requests finish) and
  only delete the pods once the deadline passes — never letting ready
  capacity dip below ``replicas - max_unavailable``;
* ``status.canary_weight`` is the single number the serve-plane router
  (`serve/router.py`) needs: the traffic share currently granted to
  ``target_image`` — ``rollout.canary_weight`` once the first new
  replica is ready, growing with the replaced fraction, 1.0 at
  completion. Controller rollout position and router traffic split can
  therefore never disagree.
* a ``spec.decode`` change (`DecodePolicy`: int8 serving weights,
  speculative draft) folds into the replica-group identity hash
  (``decode_variant``), so flipping int8 or the draft rides the SAME
  rollout machinery — the int8 variant is canaried under live traffic,
  never hot-swapped into running pods.
* a ``spec.sharding`` change (`ShardingPolicy`: the replica's
  ``{data, model, expert}`` mesh shape + rule preset) folds into the
  same identity hash and threads ``--mesh-*``/``--shard-rules`` args to
  the replica pods — a RESHARDING rolls the fleet exactly like a new
  image (params cannot be relaid out under a live engine's compiled
  programs), and the canary split A/Bs the new mesh under live traffic
  before the fleet commits.

The in-process twin of this state machine — same phases, same
surge/drain ordering, driven per engine step instead of per reconcile —
lives in `serve/fleet.py` and is what the zero-loss rollout test pins.
"""
from __future__ import annotations

import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import (
    Container,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    PodSpec,
)
from tpu_on_k8s_torch.api.inference_types import (
    InferenceService,
    ModelStatus,
    RolloutPolicy,
    ServicePhase,
)
from tpu_on_k8s_torch.obs.trace import ensure as ensure_tracer
from tpu_on_k8s_torch.api.model_types import Model
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    InMemoryCluster,
    NotFoundError,
    WatchEvent,
)
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.runtime import (
    Controller,
    Manager,
    Request,
    Result,
    Workqueue,
)
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("inferenceservice")


def image_hash(image: str) -> str:
    """Label-safe short content hash of an image ref (image refs carry
    '/' and ':', which label values forbid)."""
    return hashlib.sha1(image.encode()).hexdigest()[:8]


def decode_variant(image: str, decode, sharding=None, *,
                   pooled: bool = False) -> str:
    """The rollout identity of (image, DecodePolicy, ShardingPolicy):
    the decode policy and the mesh shape are part of what a replica
    RUNS (int8 weights, a speculative draft, the parallelism its
    compiled programs were laid out for), so flipping either must roll
    the fleet — surge, drain, canary split — exactly like a new image,
    never mutate pods in place. Only knobs that actually change the
    replica's serve args enter the identity: ``None``, an all-defaults
    block, and a ``spec_k`` with no draft all map to the bare image ref
    — applying ``decode: {}`` or ``sharding: {}`` to a running fleet
    must not trigger a full no-op rollout."""
    tags = []
    if decode is not None:
        d = decode.normalized()
        if d.draft_model:
            tags.append(f"draft={d.draft_model},k={d.spec_k}")
        if d.int8_weights:
            tags.append("int8=1")
    if sharding is not None:
        s = sharding.normalized()
        if not s.is_trivial():
            tags.append(f"mesh=d{s.data}m{s.model}e{s.expert}"
                        f",rules={s.rules}")
    if pooled:
        # ONLY the mode bit, never the member list: pool membership
        # converges by weight hot-swap through status.models — folding
        # the refs in would roll the fleet on every membership edit,
        # defeating the hot-swap entirely
        tags.append("pool=1")
    if not tags:
        return image
    return image + "#" + ";".join(tags)


class _ReplicaGroup:
    """One replica gang's observed pods (same image hash + ordinal)."""

    def __init__(self, hash_: str, index: int, hosts: int) -> None:
        self.hash = hash_
        self.index = index
        self.hosts = hosts
        self.pods: List[Pod] = []

    @property
    def ready(self) -> bool:
        """The whole gang is Running and Ready — a partially-up slice
        cannot serve (the gang is one failure domain)."""
        return (len(self.pods) == self.hosts
                and all(p.status.phase == PodPhase.RUNNING
                        and p.status.is_ready() for p in self.pods))

    @property
    def failed(self) -> bool:
        return any(p.status.phase == PodPhase.FAILED for p in self.pods)

    @property
    def draining(self) -> bool:
        return any(constants.ANNOTATION_SERVING_DRAIN_DEADLINE
                   in p.metadata.annotations for p in self.pods)

    def drain_deadline(self) -> Optional[float]:
        vals = [float(p.metadata.annotations[
            constants.ANNOTATION_SERVING_DRAIN_DEADLINE])
            for p in self.pods
            if constants.ANNOTATION_SERVING_DRAIN_DEADLINE
            in p.metadata.annotations]
        return min(vals) if vals else None


class InferenceServiceReconciler:
    """Level-triggered: every pass re-derives the rollout position from
    the observed pods (their image-hash labels), so a controller restart
    mid-rollout resumes exactly where the fleet actually is."""

    def __init__(self, cluster: InMemoryCluster,
                 config: Optional[JobControllerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None) -> None:
        self.cluster = cluster
        self.config = config or JobControllerConfig()
        self.clock = clock
        # one ``reconcile.inferenceservice`` span per pass
        # (`obs/trace.py`) — control-plane convergence on the
        # same timeline as the serve-plane request spans
        self._tracer = ensure_tracer(tracer)

    # ------------------------------------------------------------- reconcile
    def reconcile(self, request: Request) -> Result:
        with self._tracer.span("reconcile.inferenceservice",
                               namespace=request.namespace,
                               name=request.name) as sp:
            res = self._reconcile(request, sp)
            sp.set(requeue_after=res.requeue_after)
            return res

    def _reconcile(self, request: Request, sp) -> Result:
        svc = self.cluster.try_get(InferenceService, request.namespace,
                                   request.name)
        if svc is None:
            return Result()   # owner refs garbage-collect the pods
        image = self._target_image(svc)
        if not image:
            self._set_status(svc, phase=ServicePhase.PENDING,
                             message=f"waiting for model "
                                     f"{svc.spec.model_name!r} to publish "
                                     f"an image")
            return Result(requeue_after=self.config.sync_period_seconds)

        models = svc.spec.models_normalized()
        self._reconcile_models(svc, models)
        policy = svc.spec.rollout.normalized()
        desired = max(int(svc.spec.replicas), 0)
        hosts = topology.hosts_per_slice(svc.spec.gpu_policy.accelerator,
                                         svc.spec.gpu_policy.topology)
        groups = self._observed_groups(svc, hosts)
        sp.set(desired=desired, observed=len(groups))
        target_hash = image_hash(decode_variant(image, svc.spec.decode,
                                                svc.spec.sharding,
                                                pooled=bool(models)))
        new = [g for g in groups if g.hash == target_hash]
        old = [g for g in groups if g.hash != target_hash]

        # failed gangs are torn down whole (slice = one failure domain);
        # the create pass below brings the replica back
        for g in list(new):
            if g.failed:
                self._delete_group(svc, g)
                new.remove(g)

        now = self.clock()
        # 1. reap drained old replicas whose grace elapsed
        for g in list(old):
            dl = g.drain_deadline()
            if dl is not None and now >= dl:
                self._delete_group(svc, g)
                old.remove(g)

        ready_new = sum(g.ready for g in new)
        active_old = [g for g in old if not g.draining]
        ready_active_old = sum(g.ready for g in active_old)
        min_ready = max(desired - policy.max_unavailable, 0)

        # 2. drain old replicas the ready budget can spare — not-ready old
        #    gangs cost nothing to drain; ready ones only down to the floor
        for g in sorted(active_old, key=lambda g: (g.ready, g.index)):
            budget = ready_new + ready_active_old - (1 if g.ready else 0)
            if g.ready and budget < min_ready:
                break
            self._mark_draining(svc, g, now + policy.drain_seconds)
            active_old.remove(g)
            if g.ready:
                ready_active_old -= 1

        # 3. surge new replicas within the total-capacity budget; a gang
        #    that LOST a pod (deleted/evicted, not Failed) self-heals the
        #    same way — _create_group tolerates the pods that still exist
        total = len(new) + len(old)
        by_index = {g.index: g for g in new}
        for i in range(desired):
            g = by_index.get(i)
            if g is not None:
                if len(g.pods) < hosts and not g.draining:
                    self._create_group(svc, image, target_hash, i, hosts)
                continue
            if total >= desired + policy.max_surge:
                break
            self._create_group(svc, image, target_hash, i, hosts)
            total += 1

        # 4. surplus new replicas (scale-down) drain like old ones
        live_new = [g for g in new if not g.draining]
        for g in sorted(live_new, key=lambda g: -g.index):
            if len(live_new) <= desired:
                break
            self._mark_draining(svc, g, now + policy.drain_seconds)
            live_new.remove(g)
        for g in list(new):
            if g.index >= desired:
                dl = g.drain_deadline()
                if dl is not None and now >= dl:
                    self._delete_group(svc, g)
                    new.remove(g)

        res = self._update_status(svc, image, target_hash, desired, policy,
                                  new, old)
        if res.requeue_after is not None:
            # wake exactly when the earliest drain grace elapses, not a
            # full sync period later — a drained replica should be reaped
            # (and its successor surged) the moment its deadline passes
            deadlines = [d for d in (g.drain_deadline()
                                     for g in [*old, *new]) if d is not None]
            if deadlines:
                res.requeue_after = min(res.requeue_after,
                                        max(min(deadlines) - now, 0.01))
        return res

    # ---------------------------------------------------------- model pool
    def _reconcile_models(self, svc: InferenceService, models) -> None:
        """Converge ``status.models`` onto the resolved spec refs: each
        ref's image (explicit pin wins, else the named ``Model``'s
        ``latest_image``) and a coarse phase. The replica pools follow
        THIS map by weight hot-swap — resolving a new image here is the
        whole deployment action for a pooled model; no pod rolls. The
        autoscaler-owned ``slo`` sub-field of each entry is preserved,
        and removed refs drop their entries (stale budget states must
        not outlive their model)."""
        if not models and not svc.status.models:
            return
        want: Dict[str, Tuple[str, str]] = {}
        for ref in models:
            img = ref.image
            if not img and ref.model_name:
                model = self.cluster.try_get(Model, svc.metadata.namespace,
                                             ref.model_name)
                img = model.status.latest_image if model is not None else ""
            want[ref.name] = (img, "Ready" if img else "Pending")
        have = {name: (st.image, st.phase)
                for name, st in svc.status.models.items()}
        if want == have:
            return

        def mutate(s: InferenceService) -> None:
            for name in list(s.status.models):
                if name not in want:
                    del s.status.models[name]
            for name, (img, phase) in want.items():
                entry = s.status.models.get(name)
                if entry is None:
                    entry = s.status.models[name] = ModelStatus(name=name)
                entry.image = img
                entry.phase = phase
        try:
            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace,
                svc.metadata.name, mutate, subresource="status")
        except NotFoundError:
            return
        mutate(svc)   # keep this pass's snapshot coherent
        self.cluster.record_event(
            svc, "Normal", "ModelPoolResolved",
            "model pool: " + ", ".join(
                f"{n}={img or '<pending>'}"
                for n, (img, _) in sorted(want.items())))

    # ------------------------------------------------------------- observed
    def _target_image(self, svc: InferenceService) -> str:
        if svc.spec.image:
            return svc.spec.image
        if not svc.spec.model_name:
            return ""
        model = self.cluster.try_get(Model, svc.metadata.namespace,
                                     svc.spec.model_name)
        return model.status.latest_image if model is not None else ""

    def _selector(self, svc: InferenceService) -> Dict[str, str]:
        return {constants.LABEL_INFERENCESERVICE_NAME: svc.metadata.name}

    def _observed_groups(self, svc: InferenceService,
                         hosts: int) -> List[_ReplicaGroup]:
        by_key: Dict[Tuple[str, int], _ReplicaGroup] = {}
        for pod in self.cluster.list(Pod, svc.metadata.namespace,
                                     self._selector(svc)):
            if pod.metadata.deletion_timestamp is not None:
                continue
            h = pod.metadata.labels.get(constants.LABEL_SERVING_IMAGE_HASH,
                                        "")
            try:
                idx = int(pod.metadata.labels.get(
                    constants.LABEL_SERVING_REPLICA_INDEX, "0"))
            except ValueError:
                continue
            g = by_key.setdefault((h, idx), _ReplicaGroup(h, idx, hosts))
            g.pods.append(pod)
        return sorted(by_key.values(), key=lambda g: (g.hash, g.index))

    # -------------------------------------------------------------- actions
    def _gang_name(self, svc: InferenceService, hash_: str,
                   index: int) -> str:
        return f"{svc.metadata.name}-{hash_[:6]}-r{index}"

    def _create_group(self, svc: InferenceService, image: str, hash_: str,
                      index: int, hosts: int) -> None:
        gpu = svc.spec.gpu_policy
        gpus = topology.chips_per_host(gpu.accelerator)
        gang = self._gang_name(svc, hash_, index)
        serve_args = ["--serve", f"--n-slots={svc.spec.n_slots}",
                      f"--prefix-bucket-len={svc.spec.prefix_bucket_len}"]
        if svc.spec.models_normalized():
            # the mode bit only — the replica runtime builds a
            # ModelPool and follows status.models for the member list
            # (membership converges by hot-swap, never by pod args)
            serve_args.append("--model-pool")
        if svc.spec.decode is not None:
            # thread the decode policy to the replica runtime as args —
            # the serving image's declared contract, like --serve and
            # --n-slots above (the in-process plane consumes the same
            # policy through its engine factory)
            d = svc.spec.decode.normalized()
            if d.int8_weights:
                serve_args.append("--serve-int8")
            if d.draft_model:
                serve_args += [f"--spec-draft={d.draft_model}",
                               f"--spec-k={d.spec_k}"]
        if svc.spec.sharding is not None:
            s = svc.spec.sharding.normalized()
            if not s.is_trivial():
                # the replica runtime builds its serving mesh from these
                # (parallel/mesh.serving_mesh over the gang's GPUs)
                serve_args += [f"--mesh-data={s.data}",
                               f"--mesh-model={s.model}",
                               f"--mesh-expert={s.expert}",
                               f"--shard-rules={s.rules}"]
        for host in range(hosts):
            name = f"{gang}-h{host}" if hosts > 1 else gang
            container = Container(
                name=constants.DEFAULT_CONTAINER_NAME, image=image,
                args=list(serve_args))
            container.resources.requests[constants.RESOURCE_GPU] = gpus
            container.resources.limits[constants.RESOURCE_GPU] = gpus
            container.set_env(constants.ENV_PYTHONUNBUFFERED, "1")
            pod = Pod(
                metadata=ObjectMeta(
                    name=name, namespace=svc.metadata.namespace,
                    labels={**self._selector(svc),
                            constants.LABEL_SERVING_IMAGE_HASH: hash_,
                            constants.LABEL_SERVING_REPLICA_INDEX:
                                str(index),
                            constants.LABEL_TASK_INDEX: str(host)},
                    annotations={
                        constants.ANNOTATION_SERVING_IMAGE: image,
                        # the replica's hosts form one gang: all-or-nothing
                        # placement, exactly the slice failure domain
                        constants.ANNOTATION_GANG_GROUP_NAME: gang},
                    owner_references=[self._owner_ref(svc)]),
                spec=PodSpec(
                    restart_policy="Never",
                    node_selector={
                        constants.NODE_SELECTOR_GPU_ACCELERATOR:
                            gpu.accelerator},
                    containers=[container]))
            try:
                self.cluster.create(pod)
            except AlreadyExistsError:
                pass
        self.cluster.record_event(
            svc, "Normal", "ReplicaCreated",
            f"created replica {gang} ({hosts} host(s)) for image {image}")

    def _mark_draining(self, svc: InferenceService, g: _ReplicaGroup,
                       deadline: float) -> None:
        if g.draining:
            return
        for pod in g.pods:
            def mutate(p: Pod) -> None:
                p.metadata.annotations[
                    constants.ANNOTATION_SERVING_DRAIN_DEADLINE] = \
                    repr(deadline)
            try:
                self.cluster.update_with_retry(
                    Pod, pod.metadata.namespace, pod.metadata.name, mutate)
            except NotFoundError:
                pass
            # keep the local snapshot coherent so later passes over the
            # same group list see the mark this pass just wrote
            mutate(pod)
        self.cluster.record_event(
            svc, "Normal", "ReplicaDraining",
            f"draining replica {self._gang_name(svc, g.hash, g.index)}")

    def _delete_group(self, svc: InferenceService, g: _ReplicaGroup) -> None:
        for pod in g.pods:
            try:
                self.cluster.delete(Pod, pod.metadata.namespace,
                                    pod.metadata.name)
            except NotFoundError:
                pass
        self.cluster.record_event(
            svc, "Normal", "ReplicaRemoved",
            f"removed replica {self._gang_name(svc, g.hash, g.index)}")

    # --------------------------------------------------------------- status
    def _update_status(self, svc: InferenceService, image: str,
                       target_hash: str, desired: int,
                       policy: RolloutPolicy, new: List[_ReplicaGroup],
                       old: List[_ReplicaGroup]) -> Result:
        live_new = [g for g in new if not g.draining]
        ready_new = sum(g.ready for g in live_new)
        ready_total = ready_new + sum(g.ready for g in old)
        # complete only once surplus (draining) replicas are reaped too —
        # declaring READY with drains outstanding would drop the requeue
        # that eventually deletes them
        complete = not old and len(new) == len(live_new) == desired \
            and ready_new >= desired
        if complete:
            phase, msg = ServicePhase.READY, f"serving {image}"
            canary = 1.0
            current = image
        else:
            phase = ServicePhase.PROGRESSING
            msg = (f"{ready_new}/{desired} replicas ready on target image"
                   + (f"; {len(old)} old-version replica(s) remain"
                      if old else ""))
            # Degraded = a fleet that HAD more ready capacity dipping below
            # the floor; an initial deployment still coming up (previous
            # ready count no higher) is just progressing
            if (ready_total < max(desired - policy.max_unavailable, 0)
                    and svc.status.ready_replicas > ready_total):
                phase = ServicePhase.DEGRADED
            canary = 0.0
            if old and ready_new:
                canary = max(policy.canary_weight,
                             min(ready_new / desired, 1.0) if desired
                             else 1.0)
            elif not old:
                # scale-up of a single version: all traffic stays on it
                canary = 1.0
            current = svc.status.current_image or \
                (old[0].pods[0].metadata.annotations.get(
                    constants.ANNOTATION_SERVING_IMAGE, "") if old
                 else image)

        want = dict(
            phase=phase, message=msg,
            current_image=image if complete else current,
            target_image=image, replicas=len(new) + len(old),
            ready_replicas=ready_total, updated_replicas=len(live_new),
            canary_weight=round(canary, 4))
        # write only on change: an unconditional status write would fire a
        # watch event that re-enqueues this very object — a self-sustaining
        # reconcile loop
        if any(getattr(svc.status, k) != v for k, v in want.items()):
            def mutate(s: InferenceService) -> None:
                for k, v in want.items():
                    setattr(s.status, k, v)
            try:
                self.cluster.update_with_retry(
                    InferenceService, svc.metadata.namespace,
                    svc.metadata.name, mutate, subresource="status")
            except NotFoundError:
                return Result()
        if complete:
            return Result()
        return Result(requeue_after=self.config.sync_period_seconds)

    def _set_status(self, svc: InferenceService, *, phase: ServicePhase,
                    message: str) -> None:
        if svc.status.phase == phase and svc.status.message == message:
            return

        def mutate(s: InferenceService) -> None:
            s.status.phase = phase
            s.status.message = message
        try:
            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace, svc.metadata.name,
                mutate, subresource="status")
        except NotFoundError:
            pass

    def _owner_ref(self, svc: InferenceService) -> OwnerReference:
        return OwnerReference(
            api_version=svc.api_version, kind=svc.kind,
            name=svc.metadata.name, uid=svc.metadata.uid, controller=True)


def setup_inferenceservice_controller(
    cluster: InMemoryCluster,
    manager: Manager,
    config: Optional[JobControllerConfig] = None,
    clock: Callable[[], float] = time.monotonic,
    tracer=None,
) -> InferenceServiceReconciler:
    """Wire the controller: watch InferenceServices, their replica pods,
    and Models (a new ``latest_image`` is what starts a rollout)."""
    reconciler = InferenceServiceReconciler(cluster, config=config,
                                            clock=clock, tracer=tracer)
    # the workqueue shares the reconciler's clock so drain deadlines and
    # requeue delays advance together under an injected test clock
    controller = Controller("inferenceservice", reconciler.reconcile,
                            queue=Workqueue(clock=clock))
    manager.add_controller(controller)

    def on_event(event: WatchEvent) -> None:
        if event.kind == constants.KIND_INFERENCESERVICE:
            controller.enqueue(event.obj.metadata.namespace,
                               event.obj.metadata.name)
        elif event.kind == "Pod":
            owner = event.obj.metadata.labels.get(
                constants.LABEL_INFERENCESERVICE_NAME)
            if owner:
                controller.enqueue(event.obj.metadata.namespace, owner)
        elif event.kind == constants.KIND_MODEL:
            for svc in cluster.list(InferenceService,
                                    event.obj.metadata.namespace):
                if svc.spec.model_name == event.obj.metadata.name:
                    controller.enqueue(svc.metadata.namespace,
                                       svc.metadata.name)

    cluster.watch(on_event)
    return reconciler
