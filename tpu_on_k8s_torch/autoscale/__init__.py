"""Serving-load signals (a copy of the part of ``tpu_on_k8s/autoscale/`` the
serving plane emits through: ``signals.py``)."""
