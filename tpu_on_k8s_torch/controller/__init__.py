"""Controller plane: the controller runtime and leader election.

The part of ``tpu_on_k8s/controller`` that the cluster client's tests and
its registry need (``runtime.py``: workqueue, rate limiting, reconcile pump;
``leaderelection.py``: the Lease kind and its elector). The job engine and
the reconcilers come with the controllers.
"""
