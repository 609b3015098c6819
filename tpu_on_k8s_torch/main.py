"""Manager entry point: flag surface + controller wiring (reference main.go;
the counterpart of ``tpu_on_k8s/main.py``).

Mirrors the reference operator's process wiring (main.go:50-120): parse
flags and feature gates, construct the cluster client, register the gang
scheduler, wire every controller (TorchJob, elastic, autoscaler, ModelVersion,
InferenceService, the serving fleet autoscaler), start the coordinator loop
and the metrics server, then run the manager.

The cluster backend is pluggable: the in-process `InMemoryCluster` is the
default (tests / local driver — the analog of envtest); a real GKE backend
implements the same create/get/list/update/patch/watch surface against the
API server. Leader election belongs to that backend (a k8s Lease), not to
this wiring.

Run: ``python -m tpu_on_k8s_torch.main --help``.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Tuple

import tpu_on_k8s_torch.api  # noqa: F401  — anchor the api→gang→client import cycle
from tpu_on_k8s_torch.client import InMemoryCluster
from tpu_on_k8s_torch.controller.autoscaler import setup_elastic_autoscaler
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.elastic import ElasticController
from tpu_on_k8s_torch.controller.failover import CRRRestarter, InMemoryRestarter
from tpu_on_k8s_torch.controller.fleetautoscaler import setup_fleet_autoscaler
from tpu_on_k8s_torch.controller.inferenceservice import (
    setup_inferenceservice_controller,
)
from tpu_on_k8s_torch.controller.modelversion import setup_modelversion_controller
from tpu_on_k8s_torch.controller.runtime import Manager
from tpu_on_k8s_torch.controller.torchjob import setup_torchjob_controller
from tpu_on_k8s_torch.coordinator.broker import CapacityBroker
from tpu_on_k8s_torch.coordinator.core import Coordinator
from tpu_on_k8s_torch.features import features
from tpu_on_k8s_torch.gang.scheduler import GANG_SCHEDULER_NAME, default_registry
from tpu_on_k8s_torch.metrics import (
    AutoscaleMetrics,
    BrokerMetrics,
    JobMetrics,
    LedgerMetrics,
    SLOMetrics,
    serve,
)
from tpu_on_k8s_torch.obs.ledger import DecisionLedger


def parse_port_range(spec: str) -> Tuple[int, int]:
    lo, _, hi = spec.partition("-")
    return int(lo), int(hi)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-on-k8s-manager",
        description="GPU-native distributed training operator")
    # the reference's pflag surface (main.go:58-66)
    p.add_argument("--metrics-port", type=int, default=8443)
    p.add_argument("--enable-gang-scheduling", default=True,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--max-concurrent-reconciles", type=int, default=1)
    p.add_argument("--hostnetwork-port-range", default="20000-30000")
    p.add_argument("--model-image-builder",
                   default="gcr.io/kaniko-project/executor:latest")
    p.add_argument("--feature-gates", default="",
                   help="Comma-separated Name=bool overrides, e.g. "
                        "GangScheduling=true,JobCoordinator=false")
    # tunables the reference hard-coded (SURVEY §5.6)
    p.add_argument("--coordinator-period-seconds", type=float, default=0.1)
    p.add_argument("--elastic-loop-period-seconds", type=float, default=30.0)
    p.add_argument("--profile-dir", default="",
                   help="inject TPU_ON_K8S_PROFILE_DIR into slice pods: "
                        "train loops capture a torch.profiler trace there "
                        "(utils/profiling.py; empty = off)")
    p.add_argument("--profiler-port", type=int, default=0,
                   help="inject TPU_ON_K8S_PROFILER_PORT into slice pods: "
                        "train loops ask for a live profiler server on it, "
                        "which PyTorch has not: a counted warning "
                        "(0 = off)")
    p.add_argument("--serving-autoscale-period-seconds", type=float,
                   default=15.0,
                   help="Tick period of the serving SLO autoscaler "
                        "(InferenceServices with spec.autoscale set)")
    p.add_argument("--broker-capacity-chips", type=int, default=0,
                   help="Total chip capacity of the capacity broker's "
                        "slice market (coordinator/broker.py): serving "
                        "fleets, elastic training, and the batch lane "
                        "bid for one shared pool, with degrade-before-"
                        "take pressure valves and graceful preemption "
                        "(0 = no broker, market-free operation)")
    p.add_argument("--broker-period-seconds", type=float, default=10.0,
                   help="Tick period of the capacity broker's market "
                        "clearing loop")
    p.add_argument("--once", action="store_true",
                   help="Pump controllers to quiescence and exit (smoke mode)")
    p.add_argument("--leader-elect", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="Run controllers only while holding the election "
                        "lease (reference main.go:77-83)")
    p.add_argument("--leader-identity", default="",
                   help="Election identity (default: hostname-pid)")
    p.add_argument("--cluster-backend", default="auto",
                   choices=["auto", "memory", "rest"],
                   help="auto: REST when a kubeconfig/in-cluster config "
                        "resolves, else in-memory (tests/smoke)")
    p.add_argument("--api-server", default="",
                   help="API server URL for the REST backend (overrides "
                        "kubeconfig resolution)")
    # the slice gang-admission actor (our Volcano-role deliverable)
    p.add_argument("--enable-slice-scheduler", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="Run the GPU slice gang-admission loop in-process "
                        "with the manager (single-binary deployments)")
    p.add_argument("--scheduler-only", action="store_true",
                   help="Run ONLY the slice gang-admission loop (the "
                        "dedicated scheduler Deployment, config/scheduler/)")
    p.add_argument("--node-pools", default="",
                   help="Comma-separated finite slice inventory: "
                        "name=accelerator:topology:num_slices[:cpu=C][:mem=M]")
    p.add_argument("--node-pools-file", default="",
                   help="YAML list of node pools (the mounted ConfigMap form)")
    p.add_argument("--scheduler-period-seconds", type=float, default=0.1)
    # in-place restart executor (the OpenKruise CRR protocol)
    p.add_argument("--restart-executor", default="auto",
                   choices=["auto", "crr", "memory"],
                   help="In-place restart executor: crr posts "
                        "ContainerRecreateRequests for the node agent to "
                        "honor (any real cluster); memory forges pod status "
                        "in-process (in-memory backend ONLY); auto picks by "
                        "backend")
    p.add_argument("--crr-wait-seconds", type=float, default=60.0,
                   help="Deadline (measured from the CRR's creation, across "
                        "reconcile passes — never an in-pass wait) for a "
                        "node agent to complete a CRR before the operator "
                        "falls back to recreate; covers a real CRI "
                        "stop+kubelet-recreate cycle")
    # the node-agent actor (our OpenKruise-daemon-role deliverable)
    p.add_argument("--node-agent-only", action="store_true",
                   help="Run ONLY the CRR node agent (the DaemonSet role, "
                        "config/nodeagent/)")
    p.add_argument("--node-name", default="",
                   help="Node this agent serves (downward-API injected in "
                        "the DaemonSet); empty serves every node")
    p.add_argument("--node-agent-resync-seconds", type=float, default=300.0,
                   help="Slow-resync period of the node agent's CRR "
                        "informer (the agent is watch-driven; this is the "
                        "belt-and-braces re-list, not a poll)")
    p.add_argument("--runtime", default="auto", choices=["auto", "cri", "sim"],
                   help="Container runtime behind the node agent: cri stops "
                        "containers through the node's CRI socket and lets "
                        "the kubelet recreate them (real nodes; pod status "
                        "never written); sim writes pod status through the "
                        "API server (tests/simulated clusters ONLY); auto "
                        "picks cri when the CRI socket exists")
    p.add_argument("--cri-endpoint",
                   default="unix:///run/containerd/containerd.sock",
                   help="CRI runtime socket (the DaemonSet hostPath-mounts "
                        "it)")
    p.add_argument("--crictl-path", default="crictl",
                   help="crictl binary the CRI runtime shells out to")
    p.add_argument("--cri-wait-seconds", type=float, default=60.0,
                   help="How long the node agent waits for the kubelet to "
                        "recreate stopped containers before failing the CRR")
    return p


def build_node_pools(args: argparse.Namespace):
    from tpu_on_k8s_torch.gang.scheduler import load_node_pools_file, parse_node_pools

    pools = []
    if getattr(args, "node_pools", ""):
        pools.extend(parse_node_pools(args.node_pools))
    if getattr(args, "node_pools_file", ""):
        pools.extend(load_node_pools_file(args.node_pools_file))
    return pools


def build_restarter(args: argparse.Namespace, cluster):
    """Select the in-place restart executor by backend : the
    operator may forge pod status ONLY against the in-memory cluster, where
    no kubelet owns that state. Any real (REST) API server gets the CRR
    protocol — post a ContainerRecreateRequest, let the node agent restart
    the containers (reference failover.go:210-307)."""
    mode = getattr(args, "restart_executor", "auto")
    if mode == "auto":
        from tpu_on_k8s_torch.client.rest import RestCluster

        mode = "crr" if isinstance(cluster, RestCluster) else "memory"
    if mode == "crr":
        return CRRRestarter(
            cluster, wait_seconds=getattr(args, "crr_wait_seconds", 5.0))
    if isinstance(cluster, InMemoryCluster):
        return InMemoryRestarter()
    raise SystemExit(
        "--restart-executor memory forges kubelet-owned pod status and is "
        "only legal against --cluster-backend memory; use crr")


def build_runtime(args: argparse.Namespace, cluster):
    """Select the node agent's container runtime : a real
    node gets the CRI shim — stop containers through the runtime socket and
    let the kubelet recreate them, pod status never written. ``sim`` (the
    KubeletSim status-write surface) is only legal where no kubelet owns pod
    status: tests, local drivers, simulated clusters."""
    import os

    from tpu_on_k8s_torch.client.cri import CriRuntime

    mode = getattr(args, "runtime", "auto")
    endpoint = getattr(args, "cri_endpoint",
                       "unix:///run/containerd/containerd.sock")
    if mode == "auto":
        socket_path = endpoint[len("unix://"):] if endpoint.startswith(
            "unix://") else endpoint
        mode = "cri" if os.path.exists(socket_path) else "sim"
    if mode == "cri":
        return CriRuntime(
            crictl=getattr(args, "crictl_path", "crictl"), endpoint=endpoint,
            wait_seconds=getattr(args, "cri_wait_seconds", 60.0))
    from tpu_on_k8s_torch.client.testing import KubeletSim

    return KubeletSim(cluster)


def build_cluster(args: argparse.Namespace):
    """Select the cluster backend (reference main.go:77-83 — the manager
    always dials a real API server; here `memory` keeps the envtest-style
    in-process mode as an explicit choice)."""
    backend = getattr(args, "cluster_backend", "auto")
    url = getattr(args, "api_server", "")
    creds = None
    if backend in ("auto", "rest") and not url:
        from tpu_on_k8s_torch.client import kubeconfig

        cfg = kubeconfig.resolve()
        url = kubeconfig.server_url(cfg) or ""
        # inline kubeconfig credentials materialize into a private tempdir
        # that credentials() creates lazily and removes at exit
        creds = kubeconfig.credentials(cfg)
    if backend == "rest" or (backend == "auto" and url):
        if not url:
            raise SystemExit(
                "--cluster-backend rest requires --api-server or a "
                "resolvable kubeconfig/in-cluster config")
        from tpu_on_k8s_torch.client.rest import RestCluster

        if creds is None:
            return RestCluster(url)
        return RestCluster(url, token_path=creds.token_path,
                           ca_path=creds.ca_path, token=creds.token,
                           client_cert_path=creds.client_cert_path,
                           client_key_path=creds.client_key_path)
    return InMemoryCluster()


class Operator:
    """All wired components; ``start``/``stop`` or one-shot ``run_once``."""

    def __init__(self, args: argparse.Namespace,
                 cluster: Optional[InMemoryCluster] = None):
        self.cluster = cluster if cluster is not None else build_cluster(args)
        self.manager = Manager()
        self.metrics = JobMetrics()
        # both backends count conflict retries against the operator's own
        # metrics (client/rest.py + client/cluster.py update_with_retry)
        self.cluster.metrics = self.metrics
        self.gates = (features.FeatureGates.parse(args.feature_gates)
                      if args.feature_gates else features.FeatureGates())
        self.config = JobControllerConfig(
            enable_gang_scheduling=args.enable_gang_scheduling,
            max_concurrent_reconciles=args.max_concurrent_reconciles,
            hostnetwork_port_range=parse_port_range(args.hostnetwork_port_range),
            model_image_builder=args.model_image_builder,
            coordinator_period_seconds=args.coordinator_period_seconds,
            elastic_loop_period_seconds=args.elastic_loop_period_seconds,
            serving_autoscale_period_seconds=getattr(
                args, "serving_autoscale_period_seconds", 15.0),
            profile_dir=getattr(args, "profile_dir", ""),
            profiler_port=getattr(args, "profiler_port", 0),
        )

        gang = None
        if (self.config.enable_gang_scheduling
                and self.gates.enabled(features.GANG_SCHEDULING)):
            registry = default_registry(self.cluster)
            gang = registry.get(GANG_SCHEDULER_NAME)
        self.coordinator = None
        if self.gates.enabled(features.JOB_COORDINATOR):
            self.coordinator = Coordinator(
                self.cluster, metrics=self.metrics,
                period_seconds=self.config.coordinator_period_seconds)
        restarter = build_restarter(args, self.cluster)
        self.elastic = ElasticController(self.cluster, restarter=restarter)
        self.engine = setup_torchjob_controller(
            self.cluster, self.manager, config=self.config, gates=self.gates,
            gang_scheduler=gang, restarter=restarter, metrics=self.metrics,
            coordinator=self.coordinator, elastic_controller=self.elastic)
        # decision provenance (obs/ledger.py): ONE ledger shared by the
        # elastic and fleet autoscalers, so the operator's control-plane
        # decisions form one causal record stream; its telemetry rides
        # the operator registry (decisions{loop|outcome}, commit
        # failures, the open-effect-horizons gauge)
        self.ledger_metrics = LedgerMetrics(registry=self.metrics.registry)
        self.ledger = DecisionLedger(metrics=self.ledger_metrics)
        # the capacity broker (coordinator/broker.py): one slice market
        # both autoscalers bid on — scale-ups ask it for chips before
        # they patch, and its escalation ladder (degrade → harvest →
        # preempt → typed refusal) lands every transition on the same
        # ledger. Opt-in by capacity: 0 chips = no broker, and both
        # autoscalers run market-free, byte-identical to before.
        self.broker = None
        self.broker_metrics = None
        capacity = getattr(args, "broker_capacity_chips", 0)
        if capacity > 0:
            self.broker_metrics = BrokerMetrics(
                registry=self.metrics.registry)
            self.broker = CapacityBroker(
                capacity, ledger=self.ledger,
                metrics=self.broker_metrics,
                period_s=getattr(args, "broker_period_seconds", 10.0))
        self.autoscaler = setup_elastic_autoscaler(
            self.cluster, config=self.config, metrics=self.metrics,
            ledger=self.ledger, broker=self.broker)
        self.modelversion = setup_modelversion_controller(
            self.cluster, self.manager, config=self.config)
        self.inferenceservice = setup_inferenceservice_controller(
            self.cluster, self.manager, config=self.config)
        # the serving twin of the elastic autoscaler: fleet load →
        # InferenceService.spec.replicas (controller/fleetautoscaler.py).
        # Shares the operator's registry so --metrics-port scrapes the
        # autoscale series alongside the job series.
        self.autoscale_metrics = AutoscaleMetrics(
            registry=self.metrics.registry)
        # SLO telemetry plane (obs/slo.py, spec.slo services): burn-rate
        # / error-budget gauges + per-tenant accounting counters on the
        # same scrape endpoint
        self.slo_metrics = SLOMetrics(registry=self.metrics.registry)
        self.fleetautoscaler = setup_fleet_autoscaler(
            self.cluster, config=self.config,
            metrics=self.autoscale_metrics,
            slo_metrics=self.slo_metrics,
            ledger=self.ledger, broker=self.broker)
        self.scheduler_loop = None
        if getattr(args, "enable_slice_scheduler", False):
            from tpu_on_k8s_torch.gang.scheduler import (
                SliceGangAdmission,
                SliceSchedulerLoop,
            )
            self.scheduler_loop = SliceSchedulerLoop(
                SliceGangAdmission(self.cluster, pools=build_node_pools(args)),
                period_seconds=getattr(args, "scheduler_period_seconds", 0.1))
        self.elector = None
        if getattr(args, "leader_elect", False):
            import os
            import socket

            from tpu_on_k8s_torch.controller.leaderelection import LeaderElector
            identity = (getattr(args, "leader_identity", "")
                        or f"{socket.gethostname()}-{os.getpid()}")
            self.elector = LeaderElector(self.cluster, identity)
        self._metrics_server = None
        self._workers_lock = threading.Lock()
        self._workers_running = False

    def run_once(self) -> int:
        """Single quiescence pump (smoke/test mode)."""
        if self.coordinator is not None:
            self.coordinator.schedule_once()
        return self.manager.run_until_idle()

    def _start_workers(self) -> None:
        # re-acquiring leadership must not stack a second set of threads on
        # top of a still-running first set (double-reconcile in-process);
        # coordinator.run()/autoscaler.run() manage their own threads
        with self._workers_lock:
            if self._workers_running:
                return
            self._workers_running = True
            self.manager.start(
                workers_per_controller=self.config.max_concurrent_reconciles)
            if self.coordinator is not None:
                self.coordinator.run()
            self.autoscaler.run()
            self.fleetautoscaler.run()
            if self.broker is not None:
                self.broker.run()
            if self.scheduler_loop is not None:
                self.scheduler_loop.run()

    def _stop_workers(self) -> None:
        """Mirror of _start_workers: losing the lease must stop *every*
        reconciling thread, not just the manager — a coordinator or
        autoscaler that keeps running on a non-leader is a split brain."""
        with self._workers_lock:
            if not self._workers_running:
                return
            self._workers_running = False
            if self.coordinator is not None:
                self.coordinator.stop()
            self.autoscaler.stop()
            self.fleetautoscaler.stop()
            if self.broker is not None:
                self.broker.stop()
            if self.scheduler_loop is not None:
                self.scheduler_loop.stop()
            self.manager.stop()

    def start(self, metrics_port: int = 0) -> None:
        if self.elector is not None:
            # controllers run only while we hold the lease; losing it stops
            # them so a split brain cannot double-reconcile
            self.elector.on_started_leading = self._start_workers
            self.elector.on_stopped_leading = self._stop_workers
            self.elector.start()
        else:
            self._start_workers()
        if metrics_port:
            self._metrics_server = serve(self.metrics, metrics_port)

    def stop(self) -> None:
        if self.elector is not None:
            self.elector.stop()
        self._stop_workers()
        # REST backends run informer threads; stop their reconnect loops so a
        # stopped manager doesn't keep dialing the apiserver.
        close = getattr(self.cluster, "close", None)
        if callable(close):
            close()


def _run_forever(loop, cluster) -> int:
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    loop.stop()
    close = getattr(cluster, "close", None)
    if callable(close):
        close()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.node_agent_only:
        # Dedicated node actor (its own DaemonSet): no controllers, just the
        # CRR executor against the cluster backend.
        from tpu_on_k8s_torch.client.nodeagent import NodeAgentLoop

        cluster = build_cluster(args)
        agent = NodeAgentLoop(
            cluster, node_name=args.node_name or None,
            resync_seconds=args.node_agent_resync_seconds,
            runtime=build_runtime(args, cluster))
        agent.start()
        return _run_forever(agent, cluster)
    if args.scheduler_only:
        # Dedicated admission actor (its own Deployment): no controllers,
        # just the slice scheduler loop against the cluster backend.
        from tpu_on_k8s_torch.gang.scheduler import (
            SliceGangAdmission,
            SliceSchedulerLoop,
        )
        pools = build_node_pools(args)
        if not pools:
            # The dedicated admission actor without inventory would fall into
            # the unconstrained test-only path and stamp fabricated node
            # names onto real pods — refuse loudly instead.
            raise SystemExit(
                "--scheduler-only requires a non-empty slice inventory "
                "(--node-pools or --node-pools-file)")
        cluster = build_cluster(args)
        admission = SliceGangAdmission(cluster, pools=pools)
        loop = SliceSchedulerLoop(
            admission, period_seconds=args.scheduler_period_seconds)
        if args.leader_elect:
            # HA admission: replicas contend for the
            # scheduler's OWN lease; only the holder syncs, and a takeover
            # rebuilds the slice inventory from cluster state first — two
            # actors admitting from independent inventories is the
            # double-booking hazard.
            import os
            import socket

            from tpu_on_k8s_torch.controller.leaderelection import LeaderElector

            def lead():
                admission.resync()
                loop.run()

            elector = LeaderElector(
                cluster,
                (args.leader_identity or f"{socket.gethostname()}-{os.getpid()}"),
                lease_name="tpu-on-k8s-scheduler-election",
                on_started_leading=lead, on_stopped_leading=loop.stop)
            elector.start()

            class _Both:
                def stop(self):
                    elector.stop()
                    loop.stop()
            return _run_forever(_Both(), cluster)
        loop.run()
        return _run_forever(loop, cluster)
    operator = Operator(args)
    if args.once:
        processed = operator.run_once()
        print(f"quiescent after {processed} reconciles")
        return 0
    operator.start(metrics_port=args.metrics_port)
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    operator.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
