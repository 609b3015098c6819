"""The cache layout a KV payload carries across engines, and the
conversion between the fused and unfused projection layouts.

Counterpart of ``tpu_on_k8s/models/layouts.py``: ``CacheLayout`` and
``migrate_param_layout`` on the port's names.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import torch


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


#: (fused leaf, its parts in row order) of each fusable family
_FAMILIES = {
    "qkv": ("attn.wqkv.weight", ("attn.wq.weight", "attn.wk.weight",
                                 "attn.wv.weight")),
    "gateup": ("mlp.w_gateup.weight", ("mlp.w_gate.weight",
                                       "mlp.w_up.weight")),
}


def migrate_param_layout(params: Mapping[str, torch.Tensor], *,
                         fused_qkv: Optional[bool] = None,
                         fused_gateup: Optional[bool] = None
                         ) -> Dict[str, torch.Tensor]:
    """Convert a state dict (the port's names; any key prefix, so a
    checkpoint's ``params/``, ``mu/`` and ``nu/`` trees convert alike)
    between the fused and unfused projection layouts:

    * ``fused_qkv=True`` packs ``attn.{wq,wk,wv}.weight`` into
      ``attn.wqkv.weight`` (q, then k, then v rows); ``False`` splits it,
      q as wide as ``wo``'s input and k, v halving the rest (GQA);
    * ``fused_gateup=True`` packs ``mlp.{w_gate,w_up}.weight`` into
      ``mlp.w_gateup.weight`` (gate first); ``False`` splits it in halves.

    A port weight is ``[out, in]``, so the reference's concatenation on a
    kernel's last (output) axis is a concatenation on dim 0 here. Exact
    both ways; ``None`` leaves a family as it is. Returns a new dict (the
    tensors it does not touch are the same objects)."""
    out = dict(params)
    for family, want in (("qkv", fused_qkv), ("gateup", fused_gateup)):
        if want is None:
            continue
        fused, parts = _FAMILIES[family]
        if want:
            for key in [k for k in out if k.endswith(parts[0])]:
                prefix = key[:-len(parts[0])]
                if all(prefix + p in out for p in parts):
                    out[prefix + fused] = torch.cat(
                        [out.pop(prefix + p) for p in parts], dim=0)
            continue
        for key in [k for k in out if k.endswith(fused)]:
            prefix = key[:-len(fused)]
            w = out.pop(key)
            if family == "qkv":
                q = out[prefix + "attn.wo.weight"].shape[1]
                kv = (w.shape[0] - q) // 2
                sizes = (q, kv, kv)
            else:
                sizes = (w.shape[0] // 2,) * 2
            for name, piece in zip(parts, torch.split(w, sizes, dim=0)):
                out[prefix + name] = piece.clone()
    return _ordered(out)


def _ordered(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Keys in block order (``blocks.<i>.`` numerically), the rest kept in
    place: what a ``Transformer``'s ``state_dict`` lists."""
    def key(item):
        m = re.search(r"blocks\.(\d+)\.", item[0])
        return (int(m.group(1)) if m else -1)
    return dict(sorted(params.items(), key=key))
