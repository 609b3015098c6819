"""Well-known labels, annotations, env names and defaults for TorchJob.

The GPU flavour of ``tpu_on_k8s/api/constants.py``, after the reference
operator's apis/train/v1alpha1/constants.go and
apis/model/v1alpha1/constants.go: the API group is ``distributed.torch.io``,
the job kind ``TorchJob``, the default container ``torch``, the chips are
``nvidia.com/gpu``, and each worker gets the ``torch.distributed``
rendezvous env (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE) that
``train/distributed.py`` reads. The TPU-only names (PJRT, TPU_WORKER_*,
Megascale, libtpu flags, the slice-topology node selector) have no GPU
counterpart and are not carried. Every other name and value is the
counterpart's.
"""

API_GROUP = "distributed.torch.io"
API_VERSION = "v1alpha1"

KIND_TORCHJOB = "TorchJob"
KIND_MODEL = "Model"
KIND_MODELVERSION = "ModelVersion"
KIND_INFERENCESERVICE = "InferenceService"

# ---- labels (selector surface) ------------------------------------------------
LABEL_JOB_NAME = "torchjob.distributed.torch.io/job-name"
LABEL_GROUP_NAME = "group-name"
LABEL_TASK_INDEX = "task-index"
LABEL_TASK_TYPE = "task-type"
LABEL_TASK_ROLE = "task-role"
LABEL_JOB_GENERATION = "distributed.torch.io/job-generation"
LABEL_SPOT_TASK = "distributed.torch.io/spot-task"
LABEL_MODEL_NAME = "model.distributed.torch.io/model-name"
# serving fleet (controller/inferenceservice.py): pods of one InferenceService,
# grouped by the image generation they run (label values forbid '/' and ':',
# so the image rides an annotation and a short content hash rides the label)
LABEL_INFERENCESERVICE_NAME = "serving.distributed.torch.io/inference-service-name"
LABEL_SERVING_IMAGE_HASH = "serving.distributed.torch.io/image-hash"
LABEL_SERVING_REPLICA_INDEX = "serving.distributed.torch.io/replica-index"

# ---- annotations (protocol surface) -------------------------------------------
ANNOTATION_NETWORK_MODE = "distributed.torch.io/network-mode"
NETWORK_MODE_HOST = "host"
ANNOTATION_ENABLE_ELASTIC = "distributed.torch.io/enable-elastic-training"
ANNOTATION_SCALE_STATE = "distributed.torch.io/scale-state"
SCALE_STATE_INFLIGHT = "inflight"
SCALE_STATE_DONE = "done"
# 2-phase checkpoint transaction (operator <-> AIMaster), SURVEY §3.3 / §5.4:
ANNOTATION_CKPT_REQUESTED_VERSION = "distributed.torch.io/ckpt-requested-version"
ANNOTATION_CKPT_COMPLETED_VERSION = "distributed.torch.io/ckpt-completed-version"
# live mesh reconfiguration (tpu_on_k8s_torch/parallel/reshard.py): the elastic
# autoscaler's (hosts, mesh shape) decision delivered to the pod as a
# reshard REQUEST ("gen=G;hosts=H;mesh=data=2,fsdp=8") instead of a
# delete; the in-pod ReshardAgent transforms training state live and
# acks with the generation, which lets the elastic controller adopt the
# running pods at the new generation without restarting them.
ANNOTATION_RESHARD_REQUESTED_SPEC = "distributed.torch.io/reshard-requested-spec"
ANNOTATION_RESHARD_COMPLETED_SPEC = "distributed.torch.io/reshard-completed-spec"
ANNOTATION_READY_TO_START_WORKER = "distributed.torch.io/ready-to-start-worker"
ANNOTATION_IMMEDIATELY_START_WORKER = "distributed.torch.io/immediately-start-worker"
ANNOTATION_WORLD_SIZE = "distributed.torch.io/world-size"
ANNOTATION_LAST_FAILOVER_TIMESTAMP = "distributed.torch.io/last-failover-timestamp"
# Count of healthy in-place restarts performed by elastic scaling on this pod —
# subtracted from container restart counts so successful rescales never feed
# the job's failure backoff limit.
ANNOTATION_ELASTIC_RESTARTS = "distributed.torch.io/elastic-restarts"
# The failed-pod incarnation (uid) a surviving slice sibling was last
# restarted for — makes slice-atomic failover idempotent across the
# level-triggered reconcile passes that drive a pending CRR protocol.
ANNOTATION_SLICE_RESTART_FOR = "distributed.torch.io/slice-restart-for"
# The job generation a pod's cluster spec (world size, master address
# env) was last refreshed for during elastic rescale. The pod's generation
# LABEL only advances once its in-place restart completes, so staleness
# keeps re-driving a pending restart; this annotation stops the respec
# write itself from repeating on every pass in between.
ANNOTATION_RESPEC_GENERATION = "distributed.torch.io/respec-generation"
# serving rollout drain protocol (controller/inferenceservice.py): an
# old-version replica pod is marked draining (the serve plane's
# stop_accepting) with an absolute controller-clock deadline; the pod is
# only deleted once the deadline passes, so in-flight requests finish
ANNOTATION_SERVING_DRAIN_DEADLINE = "serving.distributed.torch.io/drain-deadline"
ANNOTATION_SERVING_IMAGE = "serving.distributed.torch.io/image"
# gang scheduler podgroup binding (reference: scheduling.k8s.io/group-name,
# pkg/gangscheduler/volcano/volcano.go:238-287)
ANNOTATION_GANG_GROUP_NAME = "scheduling.k8s.io/group-name"

# ---- finalizers ----------------------------------------------------------------
FINALIZER_PREEMPT_PROTECTOR = "distributed.torch.io/preempt-protector"

# ---- defaults ------------------------------------------------------------------
DEFAULT_CONTAINER_NAME = "torch"
DEFAULT_PORT_NAME = "torchjob-port"
# the rendezvous port of master-0 (MASTER_PORT).
DEFAULT_COORDINATOR_PORT = 8476

# ---- torch.distributed env wiring ----------------------------------------------
ENV_MASTER_ADDR = "MASTER_ADDR"                    # master-0's DNS name
ENV_MASTER_PORT = "MASTER_PORT"                    # its coordinator port
ENV_NUM_PROCESSES = "WORLD_SIZE"                   # processes in the job
ENV_PROCESS_ID = "RANK"                            # this process's index
ENV_PYTHONUNBUFFERED = "PYTHONUNBUFFERED"

# torchelastic-analog rendezvous CLI args (prepended to user args when elastic):
ARG_RDZV_BACKEND = "--rdzv_backend"
ARG_RDZV_ENDPOINT = "--rdzv_endpoint"
ARG_RDZV_ID = "--rdzv_id"
ARG_NPROC_PER_NODE = "--nproc_per_node"
ARG_NNODES = "--nnodes"

# ---- profiling env (single source of truth) ------------------------------------
# The port runs no XLA, so the reference's compile-cache env and hostPath
# volume have no counterpart (the kernels' build cache is keyed under the
# package, ``ops/_build.py``).
# Profiling hooks (`tpu_on_k8s_torch/utils/profiling.py`, consumed by
# `train/loop.py`): the operator's ``--profile-dir``/``--profiler-port``
# flags land in host pods as these env vars, so trace capture and the
# live profiler server need no per-trainer plumbing. Unset (the default)
# keeps both hooks dormant.
ENV_PROFILE_DIR = "TPU_ON_K8S_PROFILE_DIR"
ENV_PROFILER_PORT = "TPU_ON_K8S_PROFILER_PORT"

# ---- GKE GPU scheduling surface ------------------------------------------------
RESOURCE_GPU = "nvidia.com/gpu"                     # GPUs per host
NODE_SELECTOR_GPU_ACCELERATOR = "cloud.google.com/gke-accelerator"

# ---- model pipeline ------------------------------------------------------------
ENV_MODEL_PATH = "TPU_ON_K8S_MODEL_PATH"
DEFAULT_MODEL_PATH = "/tpu-on-k8s-model"
LABEL_FAST_STORAGE_NODE = "distributed.torch.io/fast-model-storage"
REGISTRY_SECRET_NAME = "regcred"

# ---- context keys (hostnetwork port map handed through reconcile context) ------
CONTEXT_HOSTNETWORK_PORTS = "hostnetwork-ports"
CONTEXT_GANG_SCHEDULER = "gang-scheduler"
