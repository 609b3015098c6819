"""TorchJob concrete reconciler: the torch.distributed cluster-spec wiring and
the job status FSM.

The GPU flavour of ``tpu_on_k8s/controller/tpujob.py``, after the reference
operator's controllers/train/ — most importantly ``SetClusterSpec``
(torchjob_controller.go:314-449), whose rendezvous env this writes as the
reference operator does and as ``train/distributed.py`` reads it:

* ``MASTER_ADDR`` (master-0's service DNS, or worker-0's for a worker-only
  job; ``localhost`` on master-0 under ``TorchLocalMasterAddr``),
  ``MASTER_PORT`` (the lead task's container port), ``RANK`` (masters
  first, then workers) and ``WORLD_SIZE`` (hosts in the world);
* ``nvidia.com/gpu`` requests of the host's GPU count and the GKE
  accelerator nodeSelector;
* elastic rendezvous CLI args (``--rdzv_backend=c10d ...``) and the world-size
  downward-API annotation trick (torchjob_controller.go:419-439) so an in-place
  restarted container observes the post-scale world size.

A job of several slices is one world whose ``RANK`` runs over every slice's
hosts; no per-slice env is written. Nothing of the TPU wiring is (no PJRT,
TPU_WORKER_*, Megascale or libtpu env, no topology selector, no XLA
compile-cache volume: the port runs no XLA).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Container, EnvVarSource, Pod, utcnow
from tpu_on_k8s_torch.api.defaults import set_defaults_torchjob
from tpu_on_k8s_torch.api.types import (
    JobConditionType,
    ReplicaStatus,
    TaskType,
    TorchJob,
)
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, WatchEvent
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.engine import JobEngine
from tpu_on_k8s_torch.controller.runtime import Controller, Manager
from tpu_on_k8s_torch.features import FeatureGates, features
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.metrics import JobMetrics
from tpu_on_k8s_torch.utils import conditions


class TorchJobHooks:
    """WorkloadHooks implementation for TorchJob (the ControllerInterface impl,
    torchjob_controller.go:117-210 + train/{job,pod,service}.go)."""

    def __init__(self, config: JobControllerConfig, gates: FeatureGates,
                 metrics: JobMetrics, restarter=None) -> None:
        self.config = config
        self.gates = gates
        self.metrics = metrics
        self.restarter = restarter

    # ---- identity / ordering --------------------------------------------------
    def task_order(self, job: TorchJob) -> List[TaskType]:
        """AIMaster first, then Master, then Worker
        (GetTaskReconcilerOrders, torchjob_controller.go:464-471)."""
        return [t for t in (TaskType.AIMASTER, TaskType.MASTER, TaskType.WORKER)
                if t in job.spec.tasks]

    def is_master(self, task_type: TaskType, index: int) -> bool:
        return task_type == TaskType.MASTER and index == 0

    def needs_service(self, job: TorchJob, task_type: TaskType) -> bool:
        # Every slice host gets stable DNS (worker-0's is MASTER_ADDR of a
        # worker-only job); AIMaster is reached via the job API only.
        return task_type in (TaskType.MASTER, TaskType.WORKER)

    def enable_elastic_scaling(self, job: TorchJob) -> bool:
        """Annotation-gated (reference elastic_scale.go:81-83) — and native
        elastic jobs (elastic_policy set) get the same machinery: generation
        labels, preempt protection, and the scale workflow execute their
        autoscaler-driven spec changes."""
        if job.spec.elastic_policy is not None:
            return True
        return (
            job.metadata.annotations.get(constants.ANNOTATION_ENABLE_ELASTIC, "")
            .lower() == "true"
        )

    def failover_action(self, job: TorchJob, pod: Pod) -> str:
        # In-place restart preserves the slice binding (no re-schedule), so
        # elastic jobs prefer it when a CRR executor exists (SURVEY §5.3).
        if self.enable_elastic_scaling(job) and self.restarter is not None:
            return "inplace"
        return "recreate"

    # ---- the torch.distributed cluster-spec wiring ----------------------------
    @staticmethod
    def _world(job: TorchJob) -> Dict[TaskType, int]:
        """Host counts by type, excluding AIMaster (not part of the world —
        reference excludes it from WORLD_SIZE, torchjob_controller.go:441-444)."""
        return {
            tt: spec.num_tasks
            for tt, spec in job.spec.tasks.items()
            if tt is not TaskType.AIMASTER
        }

    def _rank(self, job: TorchJob, task_type: TaskType, index: int) -> int:
        """Master is rank 0; workers shift by the master count
        (torchjob_controller.go:347)."""
        if task_type == TaskType.MASTER:
            return index
        masters = job.spec.tasks.get(TaskType.MASTER)
        return index + (masters.num_tasks if masters else 0)

    @staticmethod
    def _master_addr(job: TorchJob) -> str:
        """master-0's service DNS name, or worker-0's when the job has no
        master (the reference's ``_coordinator_address`` without the port)."""
        lead = (TaskType.MASTER if TaskType.MASTER in job.spec.tasks else TaskType.WORKER)
        name = conditions.gen_general_name(job.metadata.name, lead, 0)
        return f"{name}.{job.metadata.namespace}"

    def set_cluster_spec(self, job: TorchJob, pod: Pod, task_type: TaskType, index: int) -> None:
        port = self._port_from_job(job)
        elastic = self.enable_elastic_scaling(job)
        world = sum(self._world(job).values())
        rank = self._rank(job, task_type, index)
        gpu = job.spec.gpu_policy

        if task_type is not TaskType.AIMASTER:
            # GKE GPU scheduling surface: the accelerator nodeSelector + GPU
            # requests. Overwrite, not setdefault: elastic respec re-applies
            # this to live pods and the selector must track the current slice.
            pod.spec.node_selector[constants.NODE_SELECTOR_GPU_ACCELERATOR] = gpu.accelerator
            gpus = topology.chips_per_host(gpu.accelerator)
            for c in pod.spec.containers:
                c.resources.requests.setdefault(constants.RESOURCE_GPU, gpus)
                c.resources.limits.setdefault(constants.RESOURCE_GPU, gpus)
            self._inject_profiling_env(pod)

        master_addr = self._master_addr(job)
        if (task_type == TaskType.MASTER and index == 0
                and self.gates.enabled(features.LOCAL_MASTER_ADDR)):
            # Master talks to itself without a DNS round-trip
            # (TorchLocalMasterAddr, torchjob_controller.go:338-345).
            master_addr = "localhost"
        coordinator = f"{master_addr}:{port}"

        for container in pod.spec.containers:
            env = container.set_env
            env(constants.ENV_MASTER_ADDR, master_addr)
            env(constants.ENV_MASTER_PORT, str(port))
            env(constants.ENV_PROCESS_ID, str(rank))
            env(constants.ENV_PYTHONUNBUFFERED, "1")
            if elastic:
                # World size flows through an annotation + downward API so an
                # in-place restart picks up the new value without re-creating
                # the pod (torchjob_controller.go:419-439).
                pod.metadata.annotations.setdefault(
                    constants.ANNOTATION_WORLD_SIZE, str(world))
                # set_env (replace-in-place) keeps re-application idempotent —
                # elastic respec re-runs this on live pods.
                container.set_env(
                    constants.ENV_NUM_PROCESSES, "",
                    EnvVarSource(
                        field_path=f"metadata.annotations['{constants.ANNOTATION_WORLD_SIZE}']"))
            else:
                env(constants.ENV_NUM_PROCESSES, str(world))

        ep = job.spec.elastic_policy
        if ep is not None and task_type in (TaskType.MASTER, TaskType.WORKER):
            # Elastic rendezvous CLI args prepended to user args
            # (torchjob_controller.go:385-417).
            main = pod.spec.default_container()
            if main is not None:
                endpoint = ep.rendezvous_endpoint or coordinator
                rdzv = [
                    f"{constants.ARG_RDZV_BACKEND}={ep.rendezvous_backend}",
                    f"{constants.ARG_RDZV_ENDPOINT}={endpoint}",
                    f"{constants.ARG_RDZV_ID}={job.metadata.name}",
                    f"{constants.ARG_NPROC_PER_NODE}={ep.nproc_per_node}",
                    f"{constants.ARG_NNODES}={ep.min_replicas}:{ep.max_replicas}",
                ]
                existing = set(a.split("=")[0] for a in main.args)
                main.args = [a for a in rdzv if a.split("=")[0] not in existing] + main.args
            if task_type == TaskType.WORKER:
                self._add_elastic_init_containers(job, pod, coordinator)

    def _inject_profiling_env(self, pod: Pod) -> None:
        """Profiling hooks (``utils/profiling.py`` via ``train/loop.py``):
        only when the operator asked — both default off — and with
        setdefault semantics, so values the user set in the pod template
        win and re-application during elastic respec stays idempotent."""
        for container in pod.spec.containers:
            env = container.env_map()
            if (self.config.profile_dir
                    and constants.ENV_PROFILE_DIR not in env):
                container.set_env(constants.ENV_PROFILE_DIR,
                                  self.config.profile_dir)
            if (self.config.profiler_port
                    and constants.ENV_PROFILER_PORT not in env):
                container.set_env(constants.ENV_PROFILER_PORT,
                                  str(self.config.profiler_port))

    def _add_elastic_init_containers(self, job: TorchJob, pod: Pod, coordinator: str) -> None:
        """Image-warmup + master-waiter init containers for elastic workers
        (reference elastic_scale.go:549-654)."""
        have = {c.name for c in pod.spec.init_containers}
        main = pod.spec.containers[0] if pod.spec.containers else None
        if "image-warmup" not in have and main is not None:
            pod.spec.init_containers.append(Container(
                name="image-warmup", image=main.image, command=["sh", "-c", "true"]))
        if "master-waiter" not in have:
            host = coordinator.rsplit(":", 1)[0]
            pod.spec.init_containers.append(Container(
                name="master-waiter", image="busybox:1.36",
                command=["sh", "-c",
                         f"until nslookup {host}; do sleep 1; done"]))

    @staticmethod
    def _port_from_job(job: TorchJob) -> int:
        """Coordinator port from the lead task's declared container port
        (getPortFromJob, torchjob_controller.go:508-521)."""
        for tt in (TaskType.MASTER, TaskType.WORKER):
            task = job.spec.tasks.get(tt)
            if task is not None:
                return task.template.spec.coordinator_port()
        return constants.DEFAULT_COORDINATOR_PORT

    # ---- status FSM -----------------------------------------------------------
    def update_job_status(self, job: TorchJob, pods_by_type: Dict[TaskType, List[Pod]]) -> None:
        """Reference updateGeneralJobStatus (train/job.go:100-207): Running when
        the master runs; Succeeded when master succeeded and workers drained;
        Failed on permanent pod failures (restartable failures were already
        failed-over by reconcile_one_pod and marked Restarting)."""
        statuses = job.status.task_statuses
        world_types = [tt for tt in (TaskType.MASTER, TaskType.WORKER) if tt in job.spec.tasks]
        if not world_types:
            return

        total_failed = sum((statuses.get(tt) or ReplicaStatus()).failed
                           for tt in world_types)
        if total_failed > 0:
            conditions.update_job_conditions(
                job.status, JobConditionType.FAILED, "PodFailed",
                f"{total_failed} task pod(s) failed permanently")
            job.status.completion_time = job.status.completion_time or utcnow()
            self.metrics.failure()
            return

        # While a failover is in flight, Restarting holds until the job is
        # fully re-assembled (all world replicas ready) — only then does
        # Running demote it (Running/Restarting mutual exclusion, reference
        # pkg/utils/utils.go:201-223).
        restarting = conditions.has_condition(job.status, JobConditionType.RESTARTING)
        total_expected = sum(job.spec.tasks[tt].num_tasks for tt in world_types)
        total_ready = sum((statuses.get(tt) or ReplicaStatus()).ready for tt in world_types)
        can_mark_running = (not restarting) or total_ready >= total_expected

        if TaskType.MASTER in job.spec.tasks:
            master = statuses.get(TaskType.MASTER)
            n_master = job.spec.tasks[TaskType.MASTER].num_tasks
            if master is None:
                return
            if master.succeeded >= n_master:
                workers = statuses.get(TaskType.WORKER)
                workers_active = workers.active if workers else 0
                if workers_active == 0:
                    conditions.update_job_conditions(
                        job.status, JobConditionType.SUCCEEDED, "JobSucceeded",
                        "master completed and workers drained")
                    job.status.completion_time = job.status.completion_time or utcnow()
                    self.metrics.success()
                    return
            if master.active > 0 and can_mark_running:
                conditions.update_job_conditions(
                    job.status, JobConditionType.RUNNING, "JobRunning", "")
            return

        # Worker-only job.
        workers = statuses.get(TaskType.WORKER)
        if workers is None:
            return
        n_workers = job.spec.tasks[TaskType.WORKER].num_tasks
        if workers.succeeded >= n_workers:
            conditions.update_job_conditions(
                job.status, JobConditionType.SUCCEEDED, "JobSucceeded",
                "all workers succeeded")
            job.status.completion_time = job.status.completion_time or utcnow()
            self.metrics.success()
        elif workers.active > 0 and can_mark_running:
            conditions.update_job_conditions(
                job.status, JobConditionType.RUNNING, "JobRunning", "")


def submit_job(cluster: InMemoryCluster, job: TorchJob) -> TorchJob:
    """Admission path: defaulting + slice validation before the object lands in
    the store (the reference runs scheme defaulters in its create handler,
    eventhandler.go:38-64; slice validation is the slice-specific admission)."""
    set_defaults_torchjob(job)
    topology.validate_slice(job.spec.gpu_policy.accelerator, job.spec.gpu_policy.topology)
    conditions.mark_created(job)
    return cluster.create(job)


def setup_torchjob_controller(
    cluster: InMemoryCluster,
    manager: Manager,
    config: Optional[JobControllerConfig] = None,
    gates: Optional[FeatureGates] = None,
    gang_scheduler=None,
    restarter=None,
    metrics: Optional[JobMetrics] = None,
    coordinator=None,
    elastic_controller=None,
) -> JobEngine:
    """Wire the TorchJob controller into a manager: engine, watches, event
    handlers (reference SetupWithManager, torchjob_controller.go:60-115, and
    OnOwnerCreate/Update/Delete, controllers/common/eventhandler.go)."""
    config = config or JobControllerConfig()
    gates = gates or FeatureGates()
    metrics = metrics or JobMetrics()
    hooks = TorchJobHooks(config, gates, metrics, restarter=restarter)
    if elastic_controller is not None and getattr(elastic_controller, "hooks", None) is None:
        # The elastic respec path re-applies the cluster-spec wiring to live
        # pods before in-place restarts.
        elastic_controller.hooks = hooks
    engine = JobEngine(
        cluster, hooks, config=config, gang_scheduler=gang_scheduler,
        restarter=restarter, metrics=metrics, gates=gates,
        elastic_controller=elastic_controller,
    )
    controller = Controller("torchjob", engine.reconcile)
    manager.add_controller(controller)

    use_coordinator = coordinator is not None and gates.enabled(features.JOB_COORDINATOR)

    def on_event(event: WatchEvent) -> None:
        if event.kind == constants.KIND_TORCHJOB:
            ns, name = event.obj.metadata.namespace, event.obj.metadata.name
            if event.type == "ADDED":
                metrics.created()
                if use_coordinator and conditions.needs_coordinator_enqueue(event.obj.status):
                    coordinator.enqueue_or_update(event.obj, controller)
                    return
                controller.enqueue(ns, name)
            elif event.type == "MODIFIED":
                if use_coordinator and coordinator.is_queuing(event.obj.metadata.uid):
                    coordinator.enqueue_or_update(event.obj, controller)
                    return
                if use_coordinator:
                    # Quota reservations drop once the job's usage is real
                    # (reference quota.go:256-277 assumed-quota expiry).
                    coordinator.observe_job_left_queued_state(event.obj)
                controller.enqueue(ns, name)
            elif event.type == "DELETED":
                engine.forget_job(f"{ns}/{name}")
                engine.release_preempt_finalizers(event.obj)
                if use_coordinator:
                    coordinator.dequeue(event.obj, reason="deleted")
                metrics.deleted()
        elif event.kind in ("Pod", "Service"):
            engine.observe_event(controller.enqueue, event)
        elif event.kind == "ContainerRecreateRequest":
            # The node agent's phase updates advance the level-triggered
            # in-place-restart protocol: requeue the owning job (the
            # restarter stamps the job label when posting) so settlement is
            # event-driven, not resync-bound.
            job_name = event.obj.metadata.labels.get(
                constants.LABEL_JOB_NAME, "")
            if job_name:
                controller.enqueue(event.obj.metadata.namespace, job_name)

    cluster.watch(on_event)
    return engine
