"""Controller plane: the controller runtime, leader election, the generic
job engine, the TorchJob reconciler, elasticity and the serving control
plane.

The part of ``tpu_on_k8s/controller`` ported so far: ``runtime.py``
(workqueue, rate limiting, reconcile pump), ``leaderelection.py``,
``engine.py`` (the shared ``JobEngine``) with ``config``, ``expectations``,
``dag``, ``hostnetwork`` and ``failover``, ``torchjob.py`` (the TorchJob
reconciler with the torch.distributed env), ``elastic.py`` (the
checkpoint/generation protocol that rescales a job), ``autoscaler.py``
(the throughput autoscaler) on ``loopkernel.py`` (the shared
observe→decide→commit loop), ``modelversion.py`` (a finished job's
artifact → image pipeline), ``inferenceservice.py`` (an
``InferenceService``'s replica gangs and their rolling rollout) and
``fleetautoscaler.py`` (serving load → ``InferenceService.replicas``, with
the SLO engine's burn rates in ``status.slo``).
"""
