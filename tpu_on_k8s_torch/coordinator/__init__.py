"""The coordinator's policy core that the serving plane reuses (a copy of
``SmoothWRR`` from ``tpu_on_k8s/coordinator/policy.py``)."""
