"""Dataclass <-> plain-dict (de)serialization for API objects.

The reference relies on k8s apimachinery's generated deepcopy/JSON marshalling
(apis/*/v1alpha1/zz_generated.deepcopy.go). Here a single generic
reflective codec replaces all of that: every API dataclass round-trips through
``to_dict`` / ``from_dict`` (used by the in-memory API server for deep-copy
semantics, by YAML manifest loading, and by tests).
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import enum
import typing
from typing import Any, Optional, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _type_hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = get_type_hints(cls)
        _HINTS_CACHE[cls] = hints
    return hints


# k8s JSON tags that break the mechanical snake→camel rule (Go keeps
# initialisms upper-case: PodIP, HostIP, ClusterIP — k8s API conventions).
_CAMEL_OVERRIDES = {"pod_ip": "podIP", "host_ip": "hostIP",
                    "cluster_ip": "clusterIP"}


def _camel(name: str) -> str:
    """snake_case → camelCase for the k8s wire (api_version → apiVersion)."""
    override = _CAMEL_OVERRIDES.get(name)
    if override is not None:
        return override
    head, _, rest = name.partition("_")
    if not rest:
        return name
    return head + "".join(p[:1].upper() + p[1:] for p in rest.split("_"))


def to_dict(obj: Any, *, drop_none: bool = True, wire: bool = False) -> Any:
    """Recursively convert dataclasses/enums/datetimes into plain JSON-able data.

    ``wire=True`` emits camelCase keys for dataclass *fields* (the real
    Kubernetes JSON convention) while leaving plain-dict keys (labels,
    annotations, nodeSelector, resource names) untouched. Wire mode also
    applies the Kubernetes dialect rules a real apiserver enforces (pinned
    by the golden fixtures in tests/test_golden_wire.py):

    * ``metadata.resourceVersion`` is an opaque *string* on the wire, and is
      absent (never ``"0"``) on fresh objects;
    * timestamps serialize RFC 3339 with a ``Z`` suffix (metav1.Time);
    * classes may define ``__wire_out__(dict) -> dict`` /
      ``__wire_in__(dict) -> dict`` staticmethod hooks for shape adaptations
      the generic field walk can't express (e.g. core/v1's
      ``containerStatuses[].state.terminated`` nesting and tagged-union
      volume sources).
    """
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            raw = getattr(obj, f.name)
            if wire and f.name == "resource_version":
                if raw:
                    out["resourceVersion"] = str(raw)
                continue
            v = to_dict(raw, drop_none=drop_none, wire=wire)
            if drop_none and (v is None or v == {} or v == []):
                continue
            out[_camel(f.name) if wire else f.name] = v
        if wire:
            hook = getattr(type(obj), "__wire_out__", None)
            if hook is not None:
                out = hook(out)
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, _dt.datetime):
        if wire:
            # RFC 3339 requires an offset; a real apiserver's strict parse
            # rejects offset-less timestamps, so naive datetimes are treated
            # as UTC on the wire.
            if obj.tzinfo is None:
                obj = obj.replace(tzinfo=_dt.timezone.utc)
            return obj.isoformat().replace("+00:00", "Z")
        return obj.isoformat()
    if isinstance(obj, dict):
        # Keys go through conversion too: task maps are keyed by TaskType
        # enums. Plain string keys are data, never renamed.
        return {to_dict(k, drop_none=drop_none, wire=wire):
                to_dict(v, drop_none=drop_none, wire=wire)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v, drop_none=drop_none, wire=wire) for v in obj]
    return obj


_QUANTITY_SUFFIX = {"m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
                    "P": 1e15, "E": 1e18, "Ki": 2**10, "Mi": 2**20,
                    "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}


def _parse_quantity(s: str) -> float:
    """k8s resource.Quantity string → float ("4"→4, "500m"→0.5, "20Gi"→…).

    Real apiservers serialize quantities (ResourceQuota hard/used, resource
    requests) as strings; internal maps are plain floats, so float-typed
    fields accept the wire form here."""
    s = s.strip()
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei",
                "m", "k", "M", "G", "T", "P", "E"):
        if s.endswith(suf):
            return float(s[:-len(suf)]) * _QUANTITY_SUFFIX[suf]
    return float(s)  # raises ValueError on junk, like any wire type error


def _construct(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    origin = get_origin(tp)
    if origin is typing.Union:  # Optional[X] and unions
        args = [a for a in get_args(tp) if a is not type(None)]
        for a in args:
            try:
                return _construct(a, data)
            except (TypeError, ValueError, KeyError):
                continue
        raise TypeError(f"cannot construct union {tp} from {data!r}")
    if origin in (list, tuple):
        (elem,) = get_args(tp) or (Any,)
        seq = [_construct(elem, v) for v in data]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        kt, vt = get_args(tp) or (Any, Any)
        return {_construct(kt, k): _construct(vt, v) for k, v in data.items()}
    if isinstance(tp, type):
        if dataclasses.is_dataclass(tp):
            return from_dict(tp, data)
        if issubclass(tp, enum.Enum):
            try:
                return tp(data)
            except ValueError:
                # Tolerate case variance in string enum values (e.g. YAML task
                # keys "master" vs "Master"), matching the reference's
                # normalization step (torchjob_defaults.go:33-45).
                if isinstance(data, str):
                    for member in tp:
                        if isinstance(member.value, str) and member.value.lower() == data.lower():
                            return member
                raise
        if tp is _dt.datetime and isinstance(data, str):
            # accept both RFC 3339 "Z" (what a real apiserver emits) and
            # "+00:00" (python isoformat)
            if data.endswith("Z"):
                data = data[:-1] + "+00:00"
            return _dt.datetime.fromisoformat(data)
        if tp is float and isinstance(data, (int, float)):
            return float(data)
        if tp is float and isinstance(data, str):
            return _parse_quantity(data)
        if tp is int and isinstance(data, str):
            # k8s serializes resourceVersion (and quantity-ish ints) as
            # opaque strings; accept numeric strings for int fields.
            s = data.strip()
            if s and s.lstrip("-").isdigit():
                return int(s)
            raise TypeError(f"expected int got non-numeric str {data!r}")
        if tp in (int, str, bool) and not isinstance(data, tp):
            raise TypeError(f"expected {tp} got {type(data)}")
    return data


def from_dict(cls: Type[T], data: Optional[dict]) -> T:
    """Reconstruct a dataclass instance (recursively) from plain data.

    Unknown keys are ignored (forward compatibility, like k8s JSON decoding).
    """
    if data is None:
        data = {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    if not isinstance(data, dict):
        raise TypeError(f"cannot decode {cls.__name__} from {type(data).__name__} {data!r}")
    hook = getattr(cls, "__wire_in__", None)
    if hook is not None:
        data = hook(data)
    hints = _type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        # Accept both snake_case (internal) and camelCase (k8s wire) keys.
        key = f.name if f.name in data else _camel(f.name)
        if key in data:
            kwargs[f.name] = _construct(hints[f.name], data[key])
    return cls(**kwargs)


def deep_copy(obj: T) -> T:
    """Deep-copy an API dataclass via dict round-trip (the analog of
    zz_generated.deepcopy.go)."""
    return from_dict(type(obj), to_dict(obj, drop_none=False))
