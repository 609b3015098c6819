"""The digital twin's package (the counterpart of ``tpu_on_k8s/sim/``).

So far its seeded traffic generators only (``traffic``): ``Arrival`` and
``build_workload``, the load driver's trace, and the vectorized diurnal
trace (``TenantMix``, ``DiurnalProfile``, ``diurnal_rate``, ``ModelMix``,
``ArrivalTrace``, ``build_diurnal_trace``). The twin itself (its clock,
virtual devices, scenarios and harness) is a later slice.
"""
from tpu_on_k8s_torch.sim.traffic import (
    Arrival,
    ArrivalTrace,
    DiurnalProfile,
    ModelMix,
    TenantMix,
    build_diurnal_trace,
    build_workload,
    diurnal_rate,
)

__all__ = [
    "Arrival",
    "ArrivalTrace",
    "DiurnalProfile",
    "ModelMix",
    "TenantMix",
    "build_diurnal_trace",
    "build_workload",
    "diurnal_rate",
]
