"""AIMaster-driven elastic scaling: the generation / 2-phase-checkpoint protocol
(the counterpart of ``tpu_on_k8s/controller/elastic.py``).

Analog of controllers/train/elastic_scale.go (SURVEY §3.3) —
the multi-actor state machine between the controller, an in-cluster AIMaster,
and the training processes, driven entirely by annotations:

1. **Victim detection** — a pod with a deletionTimestamp still carrying the
   ``preempt-protector`` finalizer is being preempted but is held alive
   (elastic_scale.go:737-740).
2. **Checkpoint request** — the controller stamps
   ``ckpt-requested-version = <job generation>``; the AIMaster observes it,
   checkpoints training state to the model volume, then writes
   ``ckpt-completed-version`` (elastic_scale.go:469-488).
3. **Victim cleanup + respec** — on completion the controller drains victim
   finalizers, deletes them, and re-specs the job to the surviving capacity
   (elastic_scale.go:491-546). Slices: the new worker count must land on a
   slice-legal host quantum of 8-GPU hosts, so the respec rewrites
   topology/num_slices too (``apply_host_count`` — free-form replica
   arithmetic would name a slice that does not exist, SURVEY §7).
4. **Scale workflow** — the spec change bumps ``metadata.generation``; pods
   whose generation label lags are *stale* and get the world-size annotation
   patch + in-place restart with the post-scale torch.distributed env
   (master first, then workers — elastic_scale.go:210-297,
   restartPodInKruiseProtocol :342-397), whatever the new slice shape:
   every H100 host of one accelerator is one node pool, so a survivor
   never sits in the wrong one; missing
   indices are created by the engine with the new generation label; the
   ``ready-to-start-worker`` / ``scale-state`` gates sequence it all.

Unlike the reference there is no stale-service refresh step: services select
on task labels only (never generation), so DNS stays valid across restarts by
construction (the refreshStaleService dance at elastic_scale.go:402-424 is
designed out).
"""
from __future__ import annotations

from typing import List, Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod, PodPhase
from tpu_on_k8s_torch.api.types import TaskType, TorchJob
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, NotFoundError
from tpu_on_k8s_torch.controller import failover
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.runtime import Result
from tpu_on_k8s_torch.gang import topology


def apply_host_count(job: TorchJob, desired_hosts: int) -> int:
    """Re-spec the job's worker group to ``desired_hosts``, snapped DOWN to a
    slice-legal quantum, honoring elastic min/max. Mutates spec in place
    (callers persist via the cluster so generation bumps). Returns the host
    count actually applied.

    Multi-slice jobs scale by dropping/adding whole slices; single-slice jobs
    rewrite the topology to the legal shape matching the new host count.
    """
    gpu = job.spec.gpu_policy
    task = job.spec.tasks.get(TaskType.WORKER)
    if task is None:
        return 0
    ep = job.spec.elastic_policy
    lo = ep.min_replicas if ep is not None else 1
    hi = ep.max_replicas if ep is not None else desired_hosts
    desired = max(lo, min(desired_hosts, max(hi, lo)))

    per_slice = topology.hosts_per_slice(gpu.accelerator, gpu.topology)
    legal = topology.legal_host_counts(gpu.accelerator)
    if gpu.num_slices > 1 and desired >= per_slice:
        # Slice-granular: whole slices across the data-center network.
        # Floor division snaps DOWN; the elastic floor may force a snap
        # back up to cover min_replicas.
        new_slices = max(1, desired // per_slice)
        if new_slices * per_slice < lo:
            new_slices = -(-lo // per_slice)  # ceil
        applied = new_slices * per_slice
        gpu.num_slices = new_slices
    elif desired > max(legal):
        # Single slice maxed out: go multi-slice on the current shape.
        new_slices = max(1, desired // per_slice)
        applied = new_slices * per_slice
        gpu.num_slices = new_slices
    else:
        # Within one slice's reach (even if currently multi-slice): prefer a
        # single slice with the legal topology ≤ desired — one slice is
        # one gang on one network fabric. Snapped up to the smallest legal
        # count covering min_replicas when the floor demands it.
        applied = max((c for c in legal if lo <= c <= desired), default=None)
        if applied is None:
            applied = min((c for c in legal if c >= lo), default=legal[-1])
        gpu.topology = topology.topology_for_hosts(gpu.accelerator, applied)
        gpu.num_slices = 1
    task.num_tasks = applied
    return applied


class ElasticController:
    """The engine's elastic seam (ElasticScaling contract,
    controllers/common/interface.go:83-97). ``reconcile`` returns a Result to
    short-circuit the engine (protocol in flight) or None to let the normal
    pod/service reconciliation proceed."""

    def __init__(
        self,
        cluster: InMemoryCluster,
        restarter: Optional[failover.InPlaceRestarter] = None,
        config: Optional[JobControllerConfig] = None,
        hooks=None,  # WorkloadHooks; wired by setup_torchjob_controller
    ) -> None:
        self.cluster = cluster
        self.restarter = restarter
        self.config = config or JobControllerConfig()
        self.hooks = hooks
        # live-reshard hold bookkeeping: ("ns/name", requested generation)
        # -> reconcile passes spent holding for the pod's ack. In-memory
        # (a controller restart restarts the wait, which is safe — the
        # bound is a dead-agent safety valve, not a deadline contract);
        # an annotation-based count would self-trigger reconciles on
        # every increment and burn the budget in one watch storm.
        self._reshard_holds: dict = {}

    # --------------------------------------------------------------- utilities
    @staticmethod
    def victim_pods(pods: List[Pod]) -> List[Pod]:
        """filterVictimPods (elastic_scale.go:594-602,737-740)."""
        return [
            p for p in pods
            if p.metadata.deletion_timestamp is not None
            and constants.FINALIZER_PREEMPT_PROTECTOR in p.metadata.finalizers
        ]

    @staticmethod
    def pod_generation(pod: Pod) -> int:
        try:
            return int(pod.metadata.labels.get(constants.LABEL_JOB_GENERATION, "0"))
        except ValueError:
            return 0

    @staticmethod
    def _ann_int(job: TorchJob, key: str) -> Optional[int]:
        raw = job.metadata.annotations.get(key)
        if raw is None:
            return None
        try:
            return int(raw)
        except ValueError:
            return None

    def _patch_job_annotations(self, job: TorchJob, annotations) -> None:
        try:
            updated = self.cluster.patch_meta(
                TorchJob, job.metadata.namespace, job.metadata.name,
                annotations=annotations)
            job.metadata.annotations = updated.metadata.annotations
            job.metadata.resource_version = updated.metadata.resource_version
        except NotFoundError:
            pass

    # -------------------------------------------------------------- reconcile
    def reconcile(self, job: TorchJob, pods: List[Pod]) -> Optional[Result]:
        victims = self.victim_pods(pods)
        if victims:
            return self._handle_preemption(job, pods, victims)

        stale = [p for p in pods if self.pod_generation(p) < job.metadata.generation]
        if stale:
            return self._scale(job, pods, stale)

        ann = job.metadata.annotations
        if ann.get(constants.ANNOTATION_SCALE_STATE) == constants.SCALE_STATE_INFLIGHT:
            # All pods current → the scale transaction is complete
            # (elastic_scale.go:280-294).
            self._patch_job_annotations(job, {
                constants.ANNOTATION_SCALE_STATE: constants.SCALE_STATE_DONE,
                constants.ANNOTATION_READY_TO_START_WORKER: None,
            })
            self.cluster.record_event(job, "Normal", "ScaleSucceeded",
                                      f"scale to generation {job.metadata.generation} complete")
        return None

    # ----------------------------------------------- preemption → checkpoint
    def _handle_preemption(self, job: TorchJob, pods: List[Pod],
                           victims: List[Pod]) -> Result:
        """Steps 2-3 of the protocol (TriggerCheckpointIfNecessary,
        elastic_scale.go:132-196)."""
        gen = job.metadata.generation
        requested = self._ann_int(job, constants.ANNOTATION_CKPT_REQUESTED_VERSION)
        completed = self._ann_int(job, constants.ANNOTATION_CKPT_COMPLETED_VERSION)

        if requested is None or requested < gen:
            self._patch_job_annotations(
                job, {constants.ANNOTATION_CKPT_REQUESTED_VERSION: str(gen)})
            self.cluster.record_event(
                job, "Normal", "CheckpointRequested",
                f"{len(victims)} pod(s) being preempted; requested checkpoint "
                f"at generation {gen}")
            return Result(requeue_after=self.config.sync_period_seconds)

        if completed is None or completed < requested:
            # AIMaster still checkpointing — hold the world steady.
            return Result(requeue_after=self.config.sync_period_seconds)

        # Checkpoint done: drain victims (cleanupVictimPods :491-515)...
        for pod in victims:
            try:
                self.cluster.patch_meta(
                    Pod, pod.metadata.namespace, pod.metadata.name,
                    remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
            except NotFoundError:
                pass
        # ...and re-spec to surviving capacity, snapped to a legal quantum
        # (increaseGenerationAndMarkAsSucceeded :519-546 — here the generation
        # bump is the honest k8s one: a spec change).
        victim_names = {p.metadata.name for p in victims}
        surviving_workers = sum(
            1 for p in pods
            if p.metadata.labels.get(constants.LABEL_TASK_TYPE) == TaskType.WORKER.value.lower()
            and p.metadata.name not in victim_names)

        def mutate(j: TorchJob) -> None:
            apply_host_count(j, surviving_workers)

        try:
            self.cluster.update_with_retry(
                TorchJob, job.metadata.namespace, job.metadata.name, mutate)
        except NotFoundError:
            return Result()
        self._patch_job_annotations(job, {
            constants.ANNOTATION_READY_TO_START_WORKER: "true",
        })
        self.cluster.record_event(job, "Normal", "VictimsCleaned",
                                  f"cleaned {len(victims)} victim pod(s) after checkpoint")
        return Result(requeue_after=0.0)

    # ------------------------------------------------------------------ scale
    def _scale(self, job: TorchJob, pods: List[Pod], stale: List[Pod]) -> Optional[Result]:
        """Step 4: the scale workflow (scale(), elastic_scale.go:210-297)."""
        ann = job.metadata.annotations
        outcome = self._adopt_live_reshard(job, stale)
        if outcome is not None:
            return outcome
        ready = ann.get(constants.ANNOTATION_READY_TO_START_WORKER) == "true"
        immediate = ann.get(constants.ANNOTATION_IMMEDIATELY_START_WORKER) == "true"
        ckpt_requested = self._ann_int(job, constants.ANNOTATION_CKPT_REQUESTED_VERSION)
        if ckpt_requested is not None and not (ready or immediate):
            # A checkpoint round exists for this job: wait for the AIMaster's
            # go-ahead before restarting the world (elastic_scale.go:222-225).
            return Result(requeue_after=self.config.sync_period_seconds)

        self._patch_job_annotations(job, {
            constants.ANNOTATION_SCALE_STATE: constants.SCALE_STATE_INFLIGHT})

        world = sum(t.num_tasks for tt, t in job.spec.tasks.items()
                    if tt is not TaskType.AIMASTER)

        def order(pod: Pod) -> int:
            # Master restarts before workers (elastic_scale.go:242-277).
            return 0 if pod.metadata.labels.get(
                constants.LABEL_TASK_TYPE) == TaskType.MASTER.value.lower() else 1

        ordered = sorted(stale, key=order)
        masters = [p for p in ordered if order(p) == 0]
        workers = [p for p in ordered if order(p) == 1]
        # Master-first barrier (elastic_scale.go:242-277): workers only
        # restart once every master's restart has SETTLED. With the
        # level-triggered CRR protocol a restart may be pending across
        # passes, so the barrier is a requeue, not an in-pass wait — the
        # reconcile never blocks on a node agent.
        settled = [self._restart_stale_pod(job, p, world) for p in masters]
        if not all(settled):
            return Result(requeue_after=self.config.sync_period_seconds)
        pending = sum(not self._restart_stale_pod(job, p, world)
                      for p in workers)
        if pending:
            return Result(requeue_after=self.config.sync_period_seconds)
        # Fall through to the engine: it creates missing indices with the new
        # generation label and prunes out-of-range ones.
        return None

    def _adopt_live_reshard(self, job: TorchJob,
                            stale: List[Pod]) -> Optional[Result]:
        """The live-rescale seam (`tpu_on_k8s_torch/parallel/reshard.py`): when
        the autoscaler delivered this generation's rescale as a reshard
        REQUEST, the running pods transform their training state in
        place instead of being restarted. While the transform is pending
        the world is held steady (a restart now would race the
        transform); once the pod acks (``reshard-completed-spec`` >= the
        requested generation) the in-range pods are ADOPTED at the new
        generation — no delete, no in-place restart, no recompile — and
        only out-of-range pods (scale-in victims) are removed. A failed
        transform clears the request (``ReshardAgent.on_failed``), which
        releases the hold and lets the cold checkpoint-restart path run.
        Returns None when no live reshard is in play."""
        raw = job.metadata.annotations.get(
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC)
        if raw is None:
            return None
        parsed = topology.parse_reshard_spec(raw)
        if parsed is None or parsed[0] < job.metadata.generation:
            # malformed or stale request (a later spec change superseded
            # it): the cold path is in charge
            return None
        key = (f"{job.metadata.namespace}/{job.metadata.name}", parsed[0])
        completed = self._ann_int(
            job, constants.ANNOTATION_RESHARD_COMPLETED_SPEC)
        if completed is None or completed < parsed[0]:
            # the hold is BOUNDED: an agent that died mid-transform
            # (without reaching on_failed's clear) must not wedge the
            # job forever — count held reconcile passes and past the
            # bound withdraw the request so the cold path runs
            held = self._reshard_holds.get(key, 0)
            if held >= self.config.reshard_hold_max_passes:
                self._reshard_holds.pop(key, None)
                self._patch_job_annotations(job, {
                    constants.ANNOTATION_RESHARD_REQUESTED_SPEC: None})
                self.cluster.record_event(
                    job, "Warning", "LiveReshardTimedOut",
                    f"no reshard ack after {held} held passes; falling "
                    f"back to checkpoint-restart")
                return None
            self._reshard_holds[key] = held + 1
            return Result(requeue_after=self.config.sync_period_seconds)
        self._reshard_holds.pop(key, None)
        gen = str(job.metadata.generation)
        adopted = 0
        for pod in stale:
            if self._in_range(job, pod):
                self._mark_current(pod, gen)
                adopted += 1
            else:
                # scale-in: out-of-range pods still go away — the live
                # transform only saves the SURVIVORS from a restart
                try:
                    self.cluster.patch_meta(
                        Pod, pod.metadata.namespace, pod.metadata.name,
                        remove_finalizers=[
                            constants.FINALIZER_PREEMPT_PROTECTOR])
                    self.cluster.delete(Pod, pod.metadata.namespace,
                                        pod.metadata.name)
                except NotFoundError:
                    pass
        self.cluster.record_event(
            job, "Normal", "LiveReshardAdopted",
            f"adopted {adopted} running pod(s) at generation {gen} after "
            f"live reshard — no restart")
        return Result(requeue_after=0.0)

    def _restart_stale_pod(self, job: TorchJob, pod: Pod, world: int) -> bool:
        """restartStalePod → restartPodInKruiseProtocol
        (elastic_scale.go:303-397): refresh the pod's cluster spec (world-size
        annotation via downward API, RANK / WORLD_SIZE / MASTER_ADDR) FIRST,
        then restart in place. Returns True when the pod has SETTLED
        (restarted, recreated, or vanished) and False while a CRR is still in
        flight — the pod's generation label only advances on settle, so
        staleness itself re-drives the protocol next pass.

        A respec that changes the slice's shape restarts the survivor in
        place too, as the operator this was modelled on does for every
        rescale: the pod carries no topology selector, and the hosts of one
        accelerator are one node pool. Only a pod whose accelerator selector
        differs from the job's sits in the wrong pool, and that one is
        recreated instead."""
        if not self._in_range(job, pod):
            # Out-of-range stale pod (scale-in): delete; engine prunes anyway,
            # but doing it here keeps ordering master-first.
            try:
                self.cluster.patch_meta(
                    Pod, pod.metadata.namespace, pod.metadata.name,
                    remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
                self.cluster.delete(Pod, pod.metadata.namespace, pod.metadata.name)
            except NotFoundError:
                pass
            return True

        live = self.cluster.try_get(Pod, pod.metadata.namespace, pod.metadata.name)
        if live is None:
            return True
        pod_acc = live.spec.node_selector.get(
            constants.NODE_SELECTOR_GPU_ACCELERATOR)
        if pod_acc is not None and pod_acc != job.spec.gpu_policy.accelerator:
            # Accelerator changed: the node pool is wrong — recreate.
            failover.failover_recreate(self.cluster, live)
            return True

        task_type, index = self._task_identity(live)
        gen = str(job.metadata.generation)

        def mutate(p: Pod) -> None:
            p.metadata.annotations[constants.ANNOTATION_WORLD_SIZE] = str(world)
            p.metadata.annotations[constants.ANNOTATION_RESPEC_GENERATION] = gen
            if self.hooks is not None and task_type is not None:
                # Recompute the torch.distributed env (RANK, WORLD_SIZE,
                # MASTER_ADDR) for the post-scale world — an in-place
                # restart with the pre-scale env would join a world of the
                # wrong size, or a master the respec just deleted.
                self.hooks.set_cluster_spec(job, p, task_type, index)

        if live.metadata.annotations.get(
                constants.ANNOTATION_RESPEC_GENERATION) != gen:
            try:
                self.cluster.update_with_retry(
                    Pod, pod.metadata.namespace, pod.metadata.name, mutate)
            except NotFoundError:
                return True
            live = self.cluster.try_get(
                Pod, pod.metadata.namespace, pod.metadata.name)
            if live is None:
                return True
        if live.status.phase != PodPhase.RUNNING:
            # Not running ⇒ nothing to restart in place: the refreshed spec
            # takes effect when the pod (re)starts. Mark it current.
            self._mark_current(pod, gen)
            return True
        outcome = failover.failover_inplace_restart(
            self.cluster, live, self.restarter)
        if outcome is failover.RestartOutcome.PENDING:
            return False
        if outcome is failover.RestartOutcome.RESTARTED:
            # Count the healthy restart ONLY once it actually happened —
            # stamping it earlier would mask a later genuine failure from
            # the backoff limit. The generation label advances with it: the
            # pod is only "current" once it runs the post-scale world.
            prev = int(live.metadata.annotations.get(
                constants.ANNOTATION_ELASTIC_RESTARTS, "0") or 0)
            self._mark_current(
                pod, gen,
                annotations={
                    constants.ANNOTATION_ELASTIC_RESTARTS: str(prev + 1)})
        # FAILED ⇒ the fallback recreate already deleted the pod; the engine
        # recreates it with the new generation label.
        return True

    def _mark_current(self, pod: Pod, gen: str, annotations=None) -> None:
        try:
            self.cluster.patch_meta(
                Pod, pod.metadata.namespace, pod.metadata.name,
                labels={constants.LABEL_JOB_GENERATION: gen},
                annotations=annotations)
        except NotFoundError:
            pass

    @staticmethod
    def _task_identity(pod: Pod):
        try:
            task_type = TaskType.normalize(
                pod.metadata.labels.get(constants.LABEL_TASK_TYPE, ""))
            index = int(pod.metadata.labels.get(constants.LABEL_TASK_INDEX, "-1"))
        except ValueError:
            return None, -1
        return task_type, index

    @staticmethod
    def _in_range(job: TorchJob, pod: Pod) -> bool:
        raw_type = pod.metadata.labels.get(constants.LABEL_TASK_TYPE, "")
        try:
            task_type = TaskType.normalize(raw_type)
        except ValueError:
            return False
        task = job.spec.tasks.get(task_type)
        if task is None:
            return False
        try:
            index = int(pod.metadata.labels.get(constants.LABEL_TASK_INDEX, "-1"))
        except ValueError:
            return False
        return 0 <= index < task.num_tasks
