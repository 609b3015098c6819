"""Logging and profiling helpers: copies of ``tpu_on_k8s/utils/``'s, the
profiler on ``torch.profiler``."""
