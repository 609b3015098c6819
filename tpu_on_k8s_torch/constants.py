"""The protocol constants the training loop, the checkpoint agent and the
reshard agent read. The operator's job controller writes the same
annotations and env (``controller/torchjob.py``), so both take each name
from its one definition in ``api/constants.py``:

* the 2-phase checkpoint transaction: the operator requests generation G
  (``ANNOTATION_CKPT_REQUESTED_VERSION``), the job's checkpoint agent saves
  and acknowledges (``ANNOTATION_CKPT_COMPLETED_VERSION``);
* live mesh reconfiguration (``parallel/reshard.py``): the operator's
  (hosts, mesh shape) decision arrives as a reshard request
  ("gen=G;hosts=H;mesh=data=2,fsdp=8"); the job's ReshardAgent transforms
  the training state live and acknowledges with the generation;
* the profiling hooks (``utils/profiling.py``, read by ``train/loop.py``):
  the operator's --profile-dir / --profiler-port land in pods as env;
* the worker env that ``train/distributed.py`` reads: the master's address
  and port, the world size, this process's rank, and the model path.
"""
from tpu_on_k8s_torch.api.constants import (  # noqa: F401  (re-exported)
    ANNOTATION_CKPT_COMPLETED_VERSION,
    ANNOTATION_CKPT_REQUESTED_VERSION,
    ANNOTATION_RESHARD_COMPLETED_SPEC,
    ANNOTATION_RESHARD_REQUESTED_SPEC,
    ENV_MASTER_ADDR,
    ENV_MASTER_PORT,
    ENV_MODEL_PATH,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_PROFILE_DIR,
    ENV_PROFILER_PORT,
)
