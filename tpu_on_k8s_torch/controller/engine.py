"""The generic job engine: ReconcileJobs / ReconcilePods / ReconcileServices.

The counterpart of ``tpu_on_k8s/controller/engine.py``, after the reference
operator's controllers/common/{job,pod,service}.go — the shared reconcile
algorithm a concrete workload reconciler (``tpu_on_k8s_torch.controller.
torchjob``) plugs into via ``WorkloadHooks`` (the ControllerInterface
contract, interface.go:28-97).

Reconcile flow (job.go:55-342):
  termination checks (backoff limit, active deadline, finished → cleanup + TTL +
  ModelVersion emit) → gang podgroup creation → elastic checkpoint/scale gate →
  model-path env injection → per-task DAG-gated pod+service reconciliation →
  status FSM update (conflict-retried).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import (
    ObjectMeta,
    OwnerReference,
    Pod,
    PodPhase,
    Service,
    ServicePort,
    ServiceSpec,
    VolumeMount,
    utcnow,
)
from tpu_on_k8s_torch.api.model_types import ModelVersion
from tpu_on_k8s_torch.api.types import (
    CleanPodPolicy,
    JobConditionType,
    ReplicaStatus,
    RestartPolicy,
    TaskSpec,
    TaskType,
    TorchJob,
)
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    InMemoryCluster,
    NotFoundError,
)
from tpu_on_k8s_torch.controller import dag, failover, hostnetwork
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.expectations import Expectations, expectation_key
from tpu_on_k8s_torch.controller.runtime import Request, Result
from tpu_on_k8s_torch.features import FeatureGates
from tpu_on_k8s_torch.metrics import JobMetrics
from tpu_on_k8s_torch.utils import conditions, serde


class GangSchedulerProtocol(Protocol):
    """Gang scheduler seam (reference pkg/gangscheduler/interface.go:31-48)."""

    def name(self) -> str: ...
    def create_podgroups(self, job: TorchJob) -> None: ...
    def bind_pod(self, job: TorchJob, pod: Pod, task_type: TaskType) -> None: ...
    def delete_podgroups(self, job: TorchJob) -> None: ...


class WorkloadHooks(Protocol):
    """What a concrete workload reconciler supplies to the engine
    (ControllerInterface, interface.go:28-79)."""

    def task_order(self, job: TorchJob) -> List[TaskType]: ...
    def is_master(self, task_type: TaskType, index: int) -> bool: ...
    def needs_service(self, job: TorchJob, task_type: TaskType) -> bool: ...
    def set_cluster_spec(self, job: TorchJob, pod: Pod, task_type: TaskType, index: int) -> None: ...
    def update_job_status(self, job: TorchJob, pods_by_type: Dict[TaskType, List[Pod]]) -> None: ...
    def failover_action(self, job: TorchJob, pod: Pod) -> str: ...  # "recreate"|"inplace"
    def enable_elastic_scaling(self, job: TorchJob) -> bool: ...


@dataclass
class _LaunchMeter:
    first_observed: bool = False
    all_observed: bool = False


class JobEngine:
    """Shared engine embedded by concrete reconcilers
    (reference JobController struct, controllers/common/controller.go:81-119)."""

    def __init__(
        self,
        cluster: InMemoryCluster,
        hooks: WorkloadHooks,
        config: Optional[JobControllerConfig] = None,
        gang_scheduler: Optional[GangSchedulerProtocol] = None,
        restarter: Optional[failover.InPlaceRestarter] = None,
        metrics: Optional[JobMetrics] = None,
        gates: Optional[FeatureGates] = None,
        elastic_controller=None,  # set by controller.elastic when enabled
    ) -> None:
        self.cluster = cluster
        self.hooks = hooks
        self.config = config or JobControllerConfig()
        self.gang = gang_scheduler
        self.restarter = restarter
        self.metrics = metrics or JobMetrics()
        self.gates = gates or FeatureGates()
        self.elastic = elastic_controller
        self.expectations = Expectations(self.config.expectation_ttl_seconds)
        self._lock = threading.Lock()
        # In-memory failover counters feeding the backoff-limit termination
        # check (the reference derives this from its BackoffStatesQueue +
        # container restart counts, job.go:385-419).
        self._failover_counts: Dict[str, int] = {}
        self._launch_meters: Dict[str, _LaunchMeter] = {}
        # In-flight level-triggered CRR restarts: (ns, pod) → job_key. Keys
        # are re-driven by _collect_slice_restarts each pass until the CRR
        # settles — O(active restarts) GETs, never a collection LIST. Lost
        # on operator restart, like the reference's in-memory expectations;
        # the node agent's TTL reaper then clears any orphaned CRR.
        self._inflight_inplace: Dict[Tuple[str, str], str] = {}
        self.port_allocator = hostnetwork.PortAllocator(
            self.config.hostnetwork_port_range)

    # ------------------------------------------------------------------ helpers
    @staticmethod
    def job_key(job: TorchJob) -> str:
        return f"{job.metadata.namespace}/{job.metadata.name}"

    def job_selector(self, job: TorchJob) -> Dict[str, str]:
        return {constants.LABEL_JOB_NAME: job.metadata.name}

    def task_labels(self, job: TorchJob, task_type: TaskType, index: int) -> Dict[str, str]:
        """Reference GenerateLabels (controller.go:141-151) — with its nil-map
        panic fixed by construction."""
        return {
            constants.LABEL_JOB_NAME: job.metadata.name,
            constants.LABEL_GROUP_NAME: constants.API_GROUP,
            constants.LABEL_TASK_TYPE: task_type.value.lower(),
            constants.LABEL_TASK_INDEX: str(index),
        }

    def owner_ref(self, job: TorchJob) -> OwnerReference:
        return OwnerReference(
            api_version=job.api_version,
            kind=job.kind,
            name=job.metadata.name,
            uid=job.metadata.uid,
            controller=True,
            block_owner_deletion=True,
        )

    def record_failover(self, job: TorchJob) -> int:
        with self._lock:
            key = self.job_key(job)
            self._failover_counts[key] = self._failover_counts.get(key, 0) + 1
            return self._failover_counts[key]

    def restart_count(self, job: TorchJob, pods: List[Pod]) -> int:
        """Failure-attributable restarts feeding the backoff-limit check.
        Healthy elastic-rescale restarts are excluded (they bump container
        restart counts too, but a successful scale event must never fail the
        job as BackoffLimitExceeded)."""
        with self._lock:
            n = self._failover_counts.get(self.job_key(job), 0)
        for pod in pods:
            for cs in pod.status.container_statuses:
                n += cs.restart_count
            try:
                n -= int(pod.metadata.annotations.get(
                    constants.ANNOTATION_ELASTIC_RESTARTS, "0"))
            except ValueError:
                pass
        return max(n, 0)

    def forget_job(self, key: str) -> None:
        with self._lock:
            self._failover_counts.pop(key, None)
            self._launch_meters.pop(key, None)
        self.expectations.delete_expectations(key)

    # ---------------------------------------------------------------- reconcile
    def reconcile(self, request: Request) -> Result:
        job = self.cluster.try_get(TorchJob, request.namespace, request.name)
        if job is None:
            self.forget_job(f"{request.namespace}/{request.name}")
            return Result()

        if job.metadata.deletion_timestamp is not None:
            # Job is being deleted: release preempt-protector finalizers so
            # cascade GC can finish (reference cleanUpPreemptFinalizers,
            # torchjob_controller.go:480-505).
            self._cleanup_preempt_finalizers(job)
            return Result()

        key = self.job_key(job)
        fault = chaos.fire(chaos.SITE_RECONCILE, job=key)
        if fault is not None:
            # injected BEFORE expectations/pod listing so the very pass that
            # carries the fault also observes and classifies it — the same
            # ordering a kubelet status write racing a reconcile produces
            self._apply_chaos_fault(job, fault)
        if not self._expectations_satisfied(job):
            return Result(requeue_after=self.config.sync_period_seconds)

        pods = self._get_pods_for_job(job)
        services = self._get_services_for_job(job)
        pods_by_type = self._slice_by_type(pods)

        # --- termination path (job.go:105-200) --------------------------------
        if conditions.is_finished(job.status):
            return self._finish_cleanup(job, pods, services)

        try:
            # Reject un-schedulable slice shapes up front: letting an unknown
            # accelerator/topology reach set_cluster_spec would crash-loop the
            # reconciler behind raised expectations.
            from tpu_on_k8s_torch.gang import topology as gpu_topology

            gpu_topology.validate_slice(job.spec.gpu_policy.accelerator,
                                        job.spec.gpu_policy.topology)
            if self.gang is not None and self.config.enable_gang_scheduling:
                # A worker group smaller than the slice quorum could never be
                # gang-admitted — fail loudly instead of pending forever.
                from tpu_on_k8s_torch.gang.scheduler import validate_gang_feasibility

                validate_gang_feasibility(job)
        except (KeyError, ValueError) as e:
            return self._fail_job(job, pods, services, "InvalidGPUPolicy", str(e))

        backoff_limit = job.spec.run_policy.backoff_limit
        if backoff_limit is not None and self.restart_count(job, pods) > backoff_limit:
            return self._fail_job(job, pods, services, "BackoffLimitExceeded",
                                  f"restart count exceeded backoff limit {backoff_limit}")
        if self._past_active_deadline(job):
            return self._fail_job(job, pods, services, "DeadlineExceeded",
                                  "job active deadline exceeded")

        # --- running path -----------------------------------------------------
        if self.gang is not None and self.config.enable_gang_scheduling:
            self.gang.create_podgroups(job)

        if self.elastic is not None and self.hooks.enable_elastic_scaling(job):
            # Checkpoint-gated generation scaling (job.go:225-248, SURVEY §3.3).
            requeue = self.elastic.reconcile(job, pods)
            if requeue is not None:
                return requeue

        self._inject_model_path(job)

        ctx: Dict[str, object] = {}
        for task_type in self.hooks.task_order(job):
            task = job.spec.tasks.get(task_type)
            if task is None:
                continue
            if self.gates.enabled("DAGScheduling") and not dag.dag_conditions_ready(
                job, task_type, pods_by_type
            ):
                continue
            self.reconcile_pods(job, task_type, task, pods_by_type.get(task_type, []), ctx)
            if self.hooks.needs_service(job, task_type):
                self.reconcile_services(job, task_type, task, services, ctx)

        self._update_status(job, pods_by_type)
        self._meter_launch_delays(job, pods)
        return Result(requeue_after=self.config.sync_period_seconds)

    # ------------------------------------------------------------ pods/services
    def _get_pods_for_job(self, job: TorchJob) -> List[Pod]:
        """Label-select + adopt orphans (reference AdoptAndClaimPods,
        pod.go:717-745)."""
        pods = self.cluster.list(Pod, job.metadata.namespace, self.job_selector(job))
        claimed = []
        for pod in pods:
            ref = pod.metadata.controller_ref()
            if ref is None:
                try:
                    pod = self.cluster.update_with_retry(
                        Pod, pod.metadata.namespace, pod.metadata.name,
                        lambda p: p.metadata.owner_references.append(self.owner_ref(job)))
                except NotFoundError:
                    continue
            elif ref.uid != job.metadata.uid:
                continue  # owned by someone else
            claimed.append(pod)
        return claimed

    def _get_services_for_job(self, job: TorchJob) -> List[Service]:
        svcs = self.cluster.list(Service, job.metadata.namespace, self.job_selector(job))
        out = []
        for svc in svcs:
            ref = svc.metadata.controller_ref()
            if ref is None:
                try:
                    svc = self.cluster.update_with_retry(
                        Service, svc.metadata.namespace, svc.metadata.name,
                        lambda s: s.metadata.owner_references.append(self.owner_ref(job)))
                except NotFoundError:
                    continue
            elif ref.uid != job.metadata.uid:
                continue
            out.append(svc)
        return out

    @staticmethod
    def _slice_by_type(pods: List[Pod]) -> Dict[TaskType, List[Pod]]:
        by_type: Dict[TaskType, List[Pod]] = {}
        for pod in pods:
            raw = pod.metadata.labels.get(constants.LABEL_TASK_TYPE, "")
            try:
                tt = TaskType.normalize(raw)
            except ValueError:
                continue
            by_type.setdefault(tt, []).append(pod)
        return by_type

    @staticmethod
    def pod_index(pod: Pod) -> int:
        try:
            return int(pod.metadata.labels.get(constants.LABEL_TASK_INDEX, "-1"))
        except ValueError:
            return -1

    def reconcile_pods(
        self,
        job: TorchJob,
        task_type: TaskType,
        task: TaskSpec,
        existing: List[Pod],
        ctx: Dict[str, object],
    ) -> None:
        """Reference ReconcilePods (pod.go:361-687): create missing indices,
        delete out-of-range, classify failures."""
        by_index: Dict[int, List[Pod]] = {}
        for pod in existing:
            by_index.setdefault(self.pod_index(pod), []).append(pod)

        self._collect_slice_restarts(job)
        exp_key = expectation_key(self.job_key(job), task_type.value, "pods")
        to_create = [i for i in range(task.num_tasks) if not by_index.get(i)]
        if to_create:
            self.expectations.expect_creations(exp_key, len(to_create))
            for i in to_create:
                self._create_new_pod(job, task_type, task, i, ctx)

        for index, pods in by_index.items():
            for pod in pods:
                if index < 0 or index >= task.num_tasks:
                    self._delete_pod(job, pod, exp_key)
                    continue
                self._reconcile_one_pod(job, task_type, task, pod, exp_key)

    def _create_new_pod(
        self, job: TorchJob, task_type: TaskType, task: TaskSpec, index: int,
        ctx: Dict[str, object],
    ) -> None:
        """Reference createNewPod (pod.go:503-637)."""
        name = conditions.gen_general_name(job.metadata.name, task_type, index)
        pod = Pod(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={**task.template.metadata.labels,
                        **self.task_labels(job, task_type, index)},
                annotations=dict(task.template.metadata.annotations),
                owner_references=[self.owner_ref(job)],
            ),
            spec=serde.deep_copy(task.template.spec),
        )
        elastic = self.hooks.enable_elastic_scaling(job)
        if elastic:
            # Generation label + preempt-protector finalizer (pod.go:525-528).
            pod.metadata.labels[constants.LABEL_JOB_GENERATION] = str(job.metadata.generation)
            pod.metadata.finalizers.append(constants.FINALIZER_PREEMPT_PROTECTOR)

        if hostnetwork.enabled(job.metadata.annotations):
            ports: hostnetwork.PortMap = ctx.setdefault(constants.CONTEXT_HOSTNETWORK_PORTS, {})  # type: ignore[assignment]
            port = self.port_allocator.allocate(
                f"{job.metadata.namespace}/{name}")
            ports[name] = port
            hostnetwork.setup_pod_hostnetwork(pod, port)

        # Restart-policy mapping: OnExitCode is controller-managed, so the pod
        # itself never restarts (pod.go:556-561).
        policy = task.restart_policy or RestartPolicy.NEVER
        pod.spec.restart_policy = (
            "Never" if policy == RestartPolicy.ON_EXIT_CODE else policy.value
        )

        self.hooks.set_cluster_spec(job, pod, task_type, index)

        if self.gang is not None and self.config.enable_gang_scheduling:
            self.gang.bind_pod(job, pod, task_type)

        spot = task.spot_task_spec
        if spot and spot.num_spot_tasks > 0 and index >= task.num_tasks - spot.num_spot_tasks:
            # Trailing replicas run at spot priority (pod.go:592-603).
            if spot.priority_class_name:
                pod.spec.priority_class_name = spot.priority_class_name
            pod.metadata.labels[constants.LABEL_SPOT_TASK] = "true"
            pod.metadata.labels.update(spot.labels)

        try:
            self.cluster.create(pod)
            self.cluster.record_event(job, "Normal", "SuccessfulCreatePod", f"Created pod {pod.metadata.name}")
        except AlreadyExistsError:
            exp_key = expectation_key(self.job_key(job), task_type.value, "pods")
            self.expectations.creation_observed(exp_key)

    def _delete_pod(self, job: TorchJob, pod: Pod, exp_key: str) -> None:
        self.expectations.expect_deletions(exp_key, 1)
        try:
            self.cluster.patch_meta(
                Pod, pod.metadata.namespace, pod.metadata.name,
                remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
            self.cluster.delete(Pod, pod.metadata.namespace, pod.metadata.name)
            self.cluster.record_event(job, "Normal", "SuccessfulDeletePod", f"Deleted pod {pod.metadata.name}")
        except NotFoundError:
            self.expectations.deletion_observed(exp_key)

    def _reconcile_one_pod(
        self, job: TorchJob, task_type: TaskType, task: TaskSpec, pod: Pod, exp_key: str
    ) -> None:
        """Reference reconcileOnePod (pod.go:640-687): failed pods either fail
        over (recreate / in-place restart) or stand as permanent failures for
        the status FSM to judge."""
        if pod.status.phase != PodPhase.FAILED:
            return
        policy = task.restart_policy or RestartPolicy.NEVER
        if not failover.should_pod_failover(pod, policy):
            return
        if not conditions.has_condition(job.status, JobConditionType.RESTARTING):
            # Stamp once per failover episode: re-stamping each pod/pass
            # would churn the condition's message+timestamp and turn the
            # level-triggered pending protocol into a status-write busy loop.
            conditions.update_job_conditions(
                job.status, JobConditionType.RESTARTING, "PodFailover",
                f"pod {pod.metadata.name} failed (exit {failover.pod_exit_code(pod)}, "
                f"reason {pod.status.reason or 'n/a'}); restarting")
        if self.hooks.failover_action(job, pod) == "inplace":
            outcome = failover.failover_inplace_restart(
                self.cluster, pod, self.restarter)
            # The slice restarts TOGETHER: siblings' CRRs are posted on the
            # same pass as the failed pod's (not after it recovers), so the
            # whole slice re-enters rendezvous at once. Re-driven every pass
            # while pending — a no-op once each sibling settled.
            self._failover_slice_siblings(job, task_type, pod)
            key = (pod.metadata.namespace, pod.metadata.name)
            if outcome is failover.RestartOutcome.PENDING:
                # CRR in flight; the protocol advances level-triggered across
                # reconciles (reference failover.go is level-triggered the
                # same way) — the pass NEVER blocks on a node agent. Track it
                # so _collect_slice_restarts settles the CRR even if the pod
                # recovers before this path sees the Succeeded phase.
                self._inflight_inplace[key] = self.job_key(job)
                return
            self._inflight_inplace.pop(key, None)
            self.metrics.restarted()
            if outcome is failover.RestartOutcome.RESTARTED:
                # In-place restarts surface in container restart_count, which
                # restart_count() already sums — recording a failover too would
                # double-count toward the backoff limit.
                return
            self.record_failover(job)  # fell back to delete+recreate
            return
        self.metrics.restarted()
        self.record_failover(job)
        self.expectations.expect_deletions(exp_key, 1)
        if not failover.failover_recreate(self.cluster, pod):
            # Pod vanished under us: drain the expectation we just raised
            # or the job wedges until the expectation TTL.
            self.expectations.deletion_observed(exp_key)
        self._failover_slice_siblings(job, task_type, pod)

    def _failover_slice_siblings(self, job: TorchJob, task_type: TaskType,
                                 failed: Pod) -> None:
        """Slice-atomic failover (SURVEY §5.3): a slice runs one collective
        program, so one dead host kills every host's step loop in that
        slice — in-place-restart the slice's surviving workers so they
        re-enter rendezvous together instead of hanging on a dead collective.
        The reference operator restarts only the failed pod; here, as in the
        JAX package, the slice is the failure domain (an NCCL collective
        hangs on a dead rank)."""
        from tpu_on_k8s_torch.gang import topology as gpu_topology

        if not self.config.slice_atomic_failover:
            return
        if task_type is not TaskType.WORKER:
            return
        gpu = job.spec.gpu_policy
        try:
            hosts_per = gpu_topology.hosts_per_slice(gpu.accelerator, gpu.topology)
        except (KeyError, ValueError):
            return
        if hosts_per <= 1:
            return
        try:
            failed_idx = int(failed.metadata.labels.get(
                constants.LABEL_TASK_INDEX, "-1"))
        except ValueError:
            return
        if failed_idx < 0:
            return
        slice_id = failed_idx // hosts_per
        selector = {constants.LABEL_JOB_NAME: job.metadata.name,
                    constants.LABEL_TASK_TYPE: TaskType.WORKER.value.lower()}
        # (uid, restart epoch) identifies the failover incident — uid alone
        # would miss a second failure of the same in-place-restarted pod.
        # Each sibling is restarted AT MOST ONCE per incident: the annotation
        # marker (stable across passes — the failed pod's status is frozen
        # while it stays Failed) records the incident a sibling was last
        # restarted for, and in-flight sibling CRRs are only COLLECTED by
        # ``_collect_slice_restarts`` on later passes — never re-posted,
        # which would loop restarts while the primary is pending.
        epoch = sum(cs.restart_count for cs in failed.status.container_statuses)
        incident = f"{failed.metadata.uid}:{epoch}"
        initiated = 0
        for sibling in self.cluster.list(Pod, job.metadata.namespace, selector):
            if sibling.metadata.name == failed.metadata.name:
                continue
            try:
                idx = int(sibling.metadata.labels.get(
                    constants.LABEL_TASK_INDEX, "-1"))
            except ValueError:
                continue
            if idx // hosts_per != slice_id:
                continue
            if sibling.status.phase != PodPhase.RUNNING:
                continue
            if sibling.metadata.annotations.get(
                    constants.ANNOTATION_SLICE_RESTART_FOR) == incident:
                continue  # already restarted (or restarting) for this one
            initiated += 1
            out = failover.failover_inplace_restart(self.cluster, sibling,
                                                    self.restarter)
            skey = (sibling.metadata.namespace, sibling.metadata.name)
            if out is failover.RestartOutcome.PENDING:
                self._inflight_inplace[skey] = self.job_key(job)
            elif out is failover.RestartOutcome.RESTARTED:
                self.metrics.restarted()
            else:
                self.record_failover(job)  # recreated by the fallback
            try:
                # Stamp AFTER initiating, so a crash in between re-initiates
                # (restart() adopts the already-posted CRR — no duplicate)
                # instead of leaving a never-restarted sibling behind.
                self.cluster.patch_meta(
                    Pod, sibling.metadata.namespace, sibling.metadata.name,
                    annotations={
                        constants.ANNOTATION_SLICE_RESTART_FOR: incident})
            except NotFoundError:
                pass
        if initiated:
            self.cluster.record_event(
                job, "Normal", "SliceFailover",
                f"slice {slice_id}: restarting {initiated} surviving host(s) "
                f"after {failed.metadata.name} failed")

    def _apply_chaos_fault(self, job: TorchJob, fault) -> None:
        """Materialize an injected ``PodFail`` / ``SlicePreempt`` as the pod
        status a kubelet would report (phase Failed, terminated exit code,
        kill reason), so the ordinary failover classification path — not a
        test backdoor — performs the recovery. Unknown fault types are
        ignored: a schedule aimed at another layer must not break reconciles."""
        from tpu_on_k8s_torch.client.testing import KubeletSim  # the kubelet seam

        sim = KubeletSim(self.cluster)
        if isinstance(fault, chaos.PodFail):
            try:
                tt = TaskType.normalize(fault.task_type)
            except ValueError:
                return
            name = conditions.gen_general_name(job.metadata.name, tt,
                                               fault.index)
            try:
                sim.terminate_pod(job.metadata.namespace, name,
                                  fault.exit_code, reason=fault.reason,
                                  phase=PodPhase.FAILED)
            except NotFoundError:
                pass
            return
        if isinstance(fault, chaos.SlicePreempt):
            from tpu_on_k8s_torch.gang import topology as gpu_topology

            gpu = job.spec.gpu_policy
            try:
                hosts_per = gpu_topology.hosts_per_slice(gpu.accelerator,
                                                         gpu.topology)
            except (KeyError, ValueError):
                hosts_per = 1
            selector = {constants.LABEL_JOB_NAME: job.metadata.name,
                        constants.LABEL_TASK_TYPE:
                            TaskType.WORKER.value.lower()}
            for pod in self.cluster.list(Pod, job.metadata.namespace,
                                         selector):
                idx = self.pod_index(pod)
                if idx < 0 or idx // hosts_per != fault.slice_index:
                    continue
                if pod.status.phase not in (PodPhase.PENDING,
                                            PodPhase.RUNNING):
                    continue
                try:
                    sim.terminate_pod(pod.metadata.namespace,
                                      pod.metadata.name, fault.exit_code,
                                      reason=fault.reason,
                                      phase=PodPhase.FAILED)
                except NotFoundError:
                    pass

    def _collect_slice_restarts(self, job: TorchJob) -> None:
        """Settle the job's in-flight CRRs: both fire-and-forget slice-
        sibling restarts and a primary pod whose in-place restart completed
        after the engine's last look at it (the pod is Running, so the
        failed-pod path no longer drives its protocol). Iterates the TRACKED
        keys only — O(active restarts) GETs per pass, never a collection
        LIST. Observe-only (never posts); a restart that settled FAILED
        falls back to recreate so a dead-runtime sibling can't keep running
        against a re-rendezvoused slice."""
        collect = getattr(self.restarter, "collect", None)
        if collect is None:
            return
        jkey = self.job_key(job)
        for key, owner in list(self._inflight_inplace.items()):
            if owner != jkey:
                continue
            pod = self.cluster.try_get(Pod, key[0], key[1])
            if pod is None:
                self._inflight_inplace.pop(key, None)
                continue
            if pod.status.phase == PodPhase.FAILED:
                # The failed-pod reconcile path owns it again (a fresh
                # failover episode); that path re-tracks on PENDING.
                self._inflight_inplace.pop(key, None)
                continue
            out = collect(pod)  # uid-checked inside; deletes when settled
            if out is failover.RestartOutcome.PENDING:
                continue
            self._inflight_inplace.pop(key, None)
            if out is failover.RestartOutcome.RESTARTED:
                self.metrics.restarted()
            elif out is failover.RestartOutcome.FAILED:
                # Runtime failure / deadline after the pod left the failed
                # path (slice sibling, or a recovered-then-wedged primary):
                # recreate so the slice re-enters rendezvous together.
                self.record_failover(job)
                failover.failover_recreate(self.cluster, pod)

    def reconcile_services(
        self,
        job: TorchJob,
        task_type: TaskType,
        task: TaskSpec,
        existing: List[Service],
        ctx: Dict[str, object],
    ) -> None:
        """Reference ReconcileServices (service.go:251-308): one headless service
        per task replica (name == pod name) so every host has stable DNS; in
        hostnetwork mode the target port is patched to the allocated host port
        (service.go:288-303)."""
        mine = [s for s in existing
                if s.metadata.labels.get(constants.LABEL_TASK_TYPE) == task_type.value.lower()]
        have = {s.metadata.name for s in mine}
        port = task.template.spec.coordinator_port()
        ports_ctx: hostnetwork.PortMap = ctx.get(constants.CONTEXT_HOSTNETWORK_PORTS, {})  # type: ignore[assignment]
        exp_key = expectation_key(self.job_key(job), task_type.value, "services")

        # Scale-down: prune services whose replica index no longer exists
        # (the pods reconciler does the same for pods).
        valid = {conditions.gen_general_name(job.metadata.name, task_type, i)
                 for i in range(task.num_tasks)}
        for svc in mine:
            if svc.metadata.name not in valid:
                try:
                    self.cluster.delete(Service, svc.metadata.namespace, svc.metadata.name)
                except NotFoundError:
                    pass

        by_name = {s.metadata.name: s for s in mine}
        for index in range(task.num_tasks):
            name = conditions.gen_general_name(job.metadata.name, task_type, index)
            target = ports_ctx.get(name) or self._live_pod_port(job, name) or port
            svc = by_name.get(name)
            if svc is not None:
                current = next((p.target_port for p in svc.spec.ports
                                if p.name == constants.DEFAULT_PORT_NAME), None)
                if current is not None and current != target:
                    self._patch_service_target_port(job, name, target)
                continue
            svc = Service(
                metadata=ObjectMeta(
                    name=name,
                    namespace=job.metadata.namespace,
                    labels=self.task_labels(job, task_type, index),
                    owner_references=[self.owner_ref(job)],
                ),
                spec=ServiceSpec(
                    cluster_ip="None",
                    selector=self.task_labels(job, task_type, index),
                    ports=[ServicePort(name=constants.DEFAULT_PORT_NAME, port=port,
                                       target_port=target)],
                ),
            )
            self.expectations.expect_creations(exp_key, 1)
            try:
                self.cluster.create(svc)
            except AlreadyExistsError:
                self.expectations.creation_observed(exp_key)

    def _patch_service_target_port(self, job: TorchJob, name: str, target: int) -> None:
        def mutate(svc: Service) -> None:
            for p in svc.spec.ports:
                if p.name == constants.DEFAULT_PORT_NAME:
                    p.target_port = target

        try:
            self.cluster.update_with_retry(Service, job.metadata.namespace, name, mutate)
        except NotFoundError:
            pass

    def _live_pod_port(self, job: TorchJob, pod_name: str) -> Optional[int]:
        """Actual coordinator port of a live pod — for hostnetwork pods this is
        the allocated host port, which survives in the pod spec while the
        per-reconcile port context does not."""
        pod = self.cluster.try_get(Pod, job.metadata.namespace, pod_name)
        if pod is None:
            return None
        return pod.spec.coordinator_port()

    # ------------------------------------------------------------------- status
    def _update_status(self, job: TorchJob, pods_by_type: Dict[TaskType, List[Pod]]) -> None:
        if job.status.start_time is None:
            job.status.start_time = utcnow()
        self._count_task_statuses(job, pods_by_type)
        self.hooks.update_job_status(job, pods_by_type)
        self._write_status(job)

    def _count_task_statuses(self, job: TorchJob, pods_by_type: Dict[TaskType, List[Pod]]) -> None:
        """Reference updateJobTaskStatuses (pod.go:690-703). Failed pods that
        qualify for failover are *restarting*, not failed — they were already
        deleted/restarted by reconcile_one_pod this pass, so counting them as
        failed would flap the job into Failed (the reference distinguishes the
        same way in updateGeneralJobStatus, train/job.go:100-207)."""
        for task_type, task in job.spec.tasks.items():
            policy = task.restart_policy or RestartPolicy.NEVER
            rs = ReplicaStatus()
            for pod in pods_by_type.get(task_type, []):
                if pod.status.phase in (PodPhase.PENDING, PodPhase.RUNNING):
                    rs.active += 1
                    if pod.status.is_ready():
                        rs.ready += 1
                elif pod.status.phase == PodPhase.SUCCEEDED:
                    rs.succeeded += 1
                elif pod.status.phase == PodPhase.FAILED:
                    if pod.status.reason == "Evicted":
                        rs.evicted += 1
                    if not failover.should_pod_failover(pod, policy):
                        rs.failed += 1
            job.status.task_statuses[task_type] = rs

    def _write_status(self, job: TorchJob) -> None:
        desired = serde.deep_copy(job.status)
        desired_dict = serde.to_dict(desired, drop_none=False)

        def mutate(j: TorchJob) -> None:
            j.status = desired

        try:
            current = self.cluster.get(TorchJob, job.metadata.namespace, job.metadata.name)
            # No-op writes must be suppressed: every MODIFIED event re-enqueues
            # the job, so unconditional writes livelock the reconcile loop.
            if serde.to_dict(current.status, drop_none=False) == desired_dict:
                return
            self.cluster.update_with_retry(
                TorchJob, job.metadata.namespace, job.metadata.name, mutate,
                subresource="status")
        except NotFoundError:
            pass

    def _meter_launch_delays(self, job: TorchJob, pods: List[Pod]) -> None:
        """Launch-delay histograms (reference job.go:311-328)."""
        created = job.metadata.creation_timestamp
        if created is None or not pods:
            return
        with self._lock:
            meter = self._launch_meters.setdefault(self.job_key(job), _LaunchMeter())
        ready = [p for p in pods if p.status.is_ready() and p.status.start_time]
        if ready and not meter.first_observed:
            first = min(p.status.start_time for p in ready)
            self.metrics.first_pod_launch_delay(max(0.0, (first - created).total_seconds()))
            meter.first_observed = True
        total = sum(t.num_tasks for t in job.spec.tasks.values())
        if len(ready) >= total and total > 0 and not meter.all_observed:
            last = max(p.status.start_time for p in ready)
            self.metrics.all_pods_launch_delay(max(0.0, (last - created).total_seconds()))
            meter.all_observed = True

    # -------------------------------------------------------------- termination
    def _past_active_deadline(self, job: TorchJob) -> bool:
        deadline = job.spec.run_policy.active_deadline_seconds
        if deadline is None or job.status.start_time is None:
            return False
        return (utcnow() - job.status.start_time).total_seconds() > deadline

    def _fail_job(self, job: TorchJob, pods: List[Pod], services: List[Service],
                  reason: str, message: str) -> Result:
        conditions.update_job_conditions(job.status, JobConditionType.FAILED, reason, message)
        job.status.completion_time = job.status.completion_time or utcnow()
        self.metrics.failure()
        self.cluster.record_event(job, "Warning", reason, message)
        self._write_status(job)
        return self._finish_cleanup(job, pods, services)

    def _finish_cleanup(self, job: TorchJob, pods: List[Pod], services: List[Service]) -> Result:
        """Reference job.go:433-539: delete pods/services per clean-pod policy,
        drop podgroups, emit ModelVersion on success, handle TTL."""
        policy = job.spec.run_policy.clean_pod_policy
        for pod in pods:
            if policy == CleanPodPolicy.NONE:
                break
            if policy == CleanPodPolicy.RUNNING and pod.status.phase not in (
                PodPhase.PENDING, PodPhase.RUNNING
            ):
                continue
            try:
                self.cluster.patch_meta(
                    Pod, pod.metadata.namespace, pod.metadata.name,
                    remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
                self.cluster.delete(Pod, pod.metadata.namespace, pod.metadata.name)
            except NotFoundError:
                pass
        if policy != CleanPodPolicy.NONE:
            for svc in services:
                try:
                    self.cluster.delete(Service, svc.metadata.namespace, svc.metadata.name)
                except NotFoundError:
                    pass
        if self.gang is not None:
            self.gang.delete_podgroups(job)

        if conditions.is_succeeded(job.status):
            self._ensure_model_version(job, pods)

        ttl = job.spec.run_policy.ttl_seconds_after_finished
        if ttl is not None:
            finished_at = job.status.completion_time or utcnow()
            age = (utcnow() - finished_at).total_seconds()
            if age >= ttl:
                # The DELETED watch event increments the deleted metric; doing
                # it here too would double-count TTL-reaped jobs.
                self.cluster.delete(TorchJob, job.metadata.namespace, job.metadata.name)
                return Result()
            return Result(requeue_after=ttl - age)
        return Result()

    # ------------------------------------------------------------ model version
    def _inject_model_path(self, job: TorchJob) -> None:
        """Inject the model output volume + env into every task container before
        pods exist (reference addModelPathEnv, job.go:557-581). Mutates only the
        in-memory job copy used for pod creation this reconcile."""
        mv = job.spec.model_version
        if mv is None:
            return
        from tpu_on_k8s_torch.storage import volume_for_storage  # local import: L4 → storage

        volume = volume_for_storage(mv.storage)
        for task in job.spec.tasks.values():
            spec = task.template.spec
            if volume is not None and not any(v.name == volume.name for v in spec.volumes):
                spec.volumes.append(volume)
            for c in spec.containers:
                if constants.ENV_MODEL_PATH not in c.env_map():
                    c.set_env(constants.ENV_MODEL_PATH, constants.DEFAULT_MODEL_PATH)
                if volume is not None and not any(
                    m.name == volume.name for m in c.volume_mounts
                ):
                    c.volume_mounts.append(
                        VolumeMount(name=volume.name, mount_path=constants.DEFAULT_MODEL_PATH))

    def _ensure_model_version(self, job: TorchJob, pods: List[Pod]) -> None:
        """Emit a ModelVersion on success (reference creteModelVersion,
        job.go:465-508): name ``mv-{job}-{uid5}``, local storage pinned to
        master-0's node."""
        mv_spec = job.spec.model_version
        if mv_spec is None:
            return
        name = f"mv-{job.metadata.name}-{job.metadata.uid[:5]}"
        if job.status.model_version_name == name:
            if self.cluster.try_get(ModelVersion, job.metadata.namespace, name) is not None:
                return
        spec = serde.deep_copy(mv_spec)
        spec.created_by = job.metadata.name
        if spec.storage.local_storage is not None and not spec.storage.local_storage.node_name:
            spec.storage.local_storage.node_name = self._master_node(job, pods)
        mv = ModelVersion(
            metadata=ObjectMeta(
                name=name,
                namespace=job.metadata.namespace,
                labels={constants.LABEL_MODEL_NAME: spec.model_name},
                owner_references=[self.owner_ref(job)],
            ),
            spec=spec,
        )
        try:
            self.cluster.create(mv)
        except AlreadyExistsError:
            pass
        job.status.model_version_name = name
        self._write_status(job)

    @staticmethod
    def _master_node(job: TorchJob, pods: List[Pod]) -> str:
        """Node of master-0 (reference GetNodeForModelOutput,
        torchjob_controller.go:230-244)."""
        master_name = conditions.gen_general_name(job.metadata.name, TaskType.MASTER, 0)
        for pod in pods:
            if pod.metadata.name == master_name:
                return pod.spec.node_name
        return pods[0].spec.node_name if pods else ""

    # ------------------------------------------------------------- expectations
    def _expectations_satisfied(self, job: TorchJob) -> bool:
        """Gate the whole reconcile on drained expectations
        (torchjob_controller.go:190-197)."""
        key = self.job_key(job)
        for task_type in job.spec.tasks:
            for resource in ("pods", "services"):
                if not self.expectations.satisfied(
                    expectation_key(key, task_type.value, resource)
                ):
                    return False
        return True

    def release_preempt_finalizers(self, job: TorchJob) -> None:
        """Public for the DELETED event path: when the job object is already
        gone, cascade GC stamps owned pods but cannot drain the
        preempt-protector finalizer — this does."""
        self._cleanup_preempt_finalizers(job)

    def _cleanup_preempt_finalizers(self, job: TorchJob) -> None:
        for pod in self.cluster.list(Pod, job.metadata.namespace, self.job_selector(job)):
            if constants.FINALIZER_PREEMPT_PROTECTOR in pod.metadata.finalizers:
                try:
                    self.cluster.patch_meta(
                        Pod, pod.metadata.namespace, pod.metadata.name,
                        remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
                except NotFoundError:
                    pass

    # --------------------------------------------------------------- watch glue
    def observe_event(self, controller_enqueue: Callable[[str, str], None], event) -> None:
        """Pod/Service watch handler: maintain expectations and requeue the
        owning job (reference OnPodCreateFunc/OnPodUpdateFunc/OnPodDeleteFunc,
        pod.go:229-358)."""
        obj = event.obj
        ref = obj.metadata.controller_ref()
        if ref is not None and ref.kind != constants.KIND_TORCHJOB:
            return
        owner_name = ref.name if ref is not None else obj.metadata.labels.get(
            constants.LABEL_JOB_NAME, "")
        if not owner_name:
            return  # orphan with no job label: not ours (pod.go:248-252)
        raw_type = obj.metadata.labels.get(constants.LABEL_TASK_TYPE, "")
        try:
            task_type = TaskType.normalize(raw_type).value
        except ValueError:
            task_type = raw_type
        resource = "pods" if obj.kind == "Pod" else "services"
        key = expectation_key(f"{obj.metadata.namespace}/{owner_name}", task_type, resource)
        if event.type == "ADDED":
            self.expectations.creation_observed(key)
        elif event.type == "DELETED":
            self.expectations.deletion_observed(key)
            if obj.kind == "Pod":
                # Release only when no live pod holds the name: under an async
                # (REST) watch, a failover recreate can land before the old
                # pod's DELETED event arrives, and the replacement inherits
                # the allocation (allocate() is idempotent per key) — freeing
                # it here would hand its port to a neighbor.
                pod_key = f"{obj.metadata.namespace}/{obj.metadata.name}"
                if self.cluster.try_get(Pod, obj.metadata.namespace,
                                        obj.metadata.name) is None:
                    self.port_allocator.release(pod_key)
        controller_enqueue(obj.metadata.namespace, owner_name)
