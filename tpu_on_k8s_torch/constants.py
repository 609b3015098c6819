"""The protocol constants the training loop and the checkpoint agent read:
copies of their values in ``tpu_on_k8s/api/constants.py``, which the port
may not import. The operator writes the same names, so both packages
speak one protocol."""

# 2-phase checkpoint transaction (operator <-> the job's checkpoint agent):
# the operator requests generation G, the agent saves and acknowledges
ANNOTATION_CKPT_REQUESTED_VERSION = "distributed.tpu.io/ckpt-requested-version"
ANNOTATION_CKPT_COMPLETED_VERSION = "distributed.tpu.io/ckpt-completed-version"

# profiling hooks (``utils/profiling.py``, consumed by ``train/loop.py``):
# the operator's --profile-dir / --profiler-port flags land in pods as these
ENV_PROFILE_DIR = "TPU_ON_K8S_PROFILE_DIR"
ENV_PROFILER_PORT = "TPU_ON_K8S_PROFILER_PORT"

# live mesh reconfiguration (``parallel/reshard.py``): the operator's
# (hosts, mesh shape) decision arrives as a reshard request
# ("gen=G;hosts=H;mesh=data=2,fsdp=8"); the job's ReshardAgent transforms
# the training state live and acknowledges with the generation
ANNOTATION_RESHARD_REQUESTED_SPEC = "distributed.tpu.io/reshard-requested-spec"
ANNOTATION_RESHARD_COMPLETED_SPEC = "distributed.tpu.io/reshard-completed-spec"

# the operator's worker env (``train/distributed.py`` reads it): the
# coordinator's host:port, the process count and this process's index, the
# worker hostnames, the multi-slice layout and the model path
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_COORDINATOR_ADDRESS = "XLA_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "TPU_PROCESS_ID"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_MODEL_PATH = "TPU_ON_K8S_MODEL_PATH"
