"""Controller plane: the controller runtime, leader election, the generic
job engine and the TorchJob reconciler.

The part of ``tpu_on_k8s/controller`` ported so far: ``runtime.py``
(workqueue, rate limiting, reconcile pump), ``leaderelection.py``,
``engine.py`` (the shared ``JobEngine``) with ``config``, ``expectations``,
``dag``, ``hostnetwork`` and ``failover``, and ``torchjob.py`` (the
TorchJob reconciler with the torch.distributed env).
"""
