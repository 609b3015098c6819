"""Parameter partitioning: regex rules over leaf paths → sharding specs.
The counterpart of ``tpu_on_k8s/parallel/partition.py``.

A leaf's path is matched against an ordered rule list; the first hit
yields its spec, one entry per tensor dim: ``None``, an axis name or a
tuple of axis names (outer axis first). Paths are the port's names: a
nested dict's keys joined by ``/`` and a module's dotted parameter names,
so a ``TrainState``'s leaves read ``params/blocks.0.attn.wq.weight`` and
``mu/blocks.0.attn.wq.weight``; a rule written for the parameter
(``re.search``) lays its Adam moments out alike. A path no rule matches is
replicated.

``named_sharding`` validates every leaf before it gives any placement: a
spec that names more dims than the leaf has, an axis that does not divide
its dim, or a tuple entry out of mesh order raises
``ShardingValidationError`` naming the leaf, the dim, the axis sizes and
the rule. ``shard_pytree`` then lays each leaf out as a ``DTensor``
(``distribute_tensor``): every rank holds the full value and keeps its own
block, with no communication.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from tpu_on_k8s_torch.parallel.mesh import NamedSharding, _axes, mesh_shape

#: a sharding spec: one entry per tensor dim (None, an axis, or axes)
Spec = Tuple


@dataclasses.dataclass(frozen=True)
class PartitionRule:
    """``pattern`` is an uncompiled regex matched (``re.search``) against a
    leaf's path; ``spec`` applies to the first matching rule."""

    pattern: str
    spec: Spec

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def flatten_tree(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every tensor of a nested dict, in insertion
    order: keys joined by ``/``. A ``TrainState`` flattens to its
    ``state_dict`` (``params/<name>``, ``mu/<name>``, ``nu/<name>``,
    ``count``, ``step``)."""
    if hasattr(tree, "state_dict") and not isinstance(tree, dict):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(flatten_tree(v, f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def map_tree(fn: Callable[[str, Any], Any], tree: dict,
             prefix: str = "") -> dict:
    """A nested dict of ``fn(path, leaf)`` with ``tree``'s structure."""
    return {k: (map_tree(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def rule_for_path(path: str, rules: Sequence[PartitionRule]
                  ) -> Tuple[Optional[PartitionRule], Spec]:
    """The first matching rule (None when the path falls through to the
    replicate-by-default spec) and the spec it yields."""
    for rule in rules:
        if rule.matches(path):
            return rule, tuple(rule.spec)
    return None, ()


def spec_for_path(path: str, rules: Sequence[PartitionRule]) -> Spec:
    return rule_for_path(path, rules)[1]


def specs_for_pytree(tree: dict, rules: Sequence[PartitionRule]) -> dict:
    """A nested dict of specs with ``tree``'s structure."""
    return map_tree(lambda path, _: spec_for_path(path, rules), tree)


class ShardingValidationError(ValueError):
    """A partition rule produced a spec a leaf cannot take on this mesh.
    Raised before any placement, with the leaf's path, the offending dim,
    the mesh axis sizes and the rule that matched."""


def validate(path: str, leaf: Any, spec: Spec, mesh,
             rule: Optional[PartitionRule] = None) -> None:
    """Raise ``ShardingValidationError`` unless ``spec`` fits ``leaf`` on
    ``mesh``: no more dims than the leaf's, each axis a mesh axis, each
    dim divisible by the product of its axes, the axes of a tuple entry in
    mesh order, and no axis twice."""
    shape = tuple(getattr(leaf, "shape", ()))
    sizes = mesh_shape(mesh)
    names = list(mesh.mesh_dim_names)
    src = (f"rule {rule.pattern!r}" if rule is not None
           else "the replicate-by-default fallback")
    if len(spec) > len(shape):
        raise ShardingValidationError(
            f"param {path!r}: spec {spec} (from {src}) names {len(spec)} "
            f"dims but the leaf has shape {shape} ({len(shape)} dims) — the "
            f"rule matched a leaf it was not written for; tighten its regex "
            f"or add a preceding rule for this leaf")
    seen: List[str] = []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ShardingValidationError(
                f"param {path!r}: spec {spec} (from {src}) names mesh "
                f"axis(es) {unknown} the mesh {sizes} does not have")
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes) or set(axes) & set(seen):
            raise ShardingValidationError(
                f"param {path!r}: spec {spec} (from {src}) lists axes out "
                f"of mesh order {tuple(names)} or twice")
        seen.extend(axes)
        total = math.prod(sizes[a] for a in axes)
        if shape[d] % total != 0:
            detail = ", ".join(f"{a}={sizes[a]}" for a in axes)
            raise ShardingValidationError(
                f"param {path!r}: dim {d} (size {shape[d]} of shape "
                f"{shape}) is not divisible by mesh axis(es) {detail} "
                f"(product {total}), from {src} — pick a mesh where "
                f"{'x'.join(axes)} divides {shape[d]}, or change the "
                f"rule's spec for dim {d}")


def named_sharding(tree: Any, mesh, rules: Sequence[PartitionRule]) -> dict:
    """``{path: NamedSharding}`` for every leaf of ``tree`` (a nested dict
    or a ``TrainState``) under ``rules``, every leaf validated first
    (``ShardingValidationError``), so a bad rule fails before anything is
    placed."""
    out = {}
    for path, leaf in flatten_tree(tree):
        rule, spec = rule_for_path(path, rules)
        validate(path, leaf, spec, mesh, rule)
        out[path] = NamedSharding(mesh, spec)
    return out


def shard_pytree(tree: dict, mesh, rules: Sequence[PartitionRule]) -> dict:
    """Every leaf of a nested dict of full tensors as a ``DTensor`` on
    ``mesh`` under its rule. Each rank keeps its block of the value it
    holds (every rank holds the same one), with no communication."""
    shardings = named_sharding(tree, mesh, rules)
    return map_tree(lambda path, leaf: distribute_tensor(
        torch.as_tensor(leaf), mesh, shardings[path].placements,
        src_data_rank=None), tree)
