"""The cache layout a KV payload carries across engines.

Counterpart of ``tpu_on_k8s/models/layouts.py``'s ``CacheLayout``. The
parameter-layout conversion beside it there (``fused_qkv``,
``migrate_param_layout``) belongs to mesh sharding, a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class CacheLayout:
    """The sharding layout a KV payload (``models/serving.KVHandoff``, a
    prefix export) carries across engines:

    * **gather-on-export**: every export is copied to the host as the full
      logical array (all positions and heads, whatever mesh computed it),
      so any engine can adopt it;
    * **reshard-on-import**: the adopting engine lays the payload out under
      its own mesh (``submit_kv`` / ``import_prefix``).

    ``mesh_axes`` records the source engine's non-trivial mesh axes ({} =
    one device) and ``gathered_bytes`` the bytes the export moved from the
    device to the host: every leaf of the payload, an int8 cache's scales
    included. Frozen and hashable: safe as a payload field."""

    mesh_axes: Dict[str, int] = field(default_factory=dict)
    gathered_bytes: int = 0

    def __post_init__(self) -> None:
        # a dict field defeats frozen hashing: keep a plain copy, compare
        # and hash on the sorted items
        object.__setattr__(self, "mesh_axes", dict(self.mesh_axes))

    @property
    def sharded(self) -> bool:
        return bool(self.mesh_axes)

    def signature(self) -> str:
        """Stable string form ("" for one device): what unlike-mesh
        detection compares."""
        return ",".join(f"{a}={s}"
                        for a, s in sorted(self.mesh_axes.items()))

    def __hash__(self) -> int:
        return hash((self.signature(), self.gathered_bytes))
