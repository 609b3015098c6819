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
