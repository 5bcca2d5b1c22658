"""Scheme: kind registry and dataclass <-> JSON-dict round-tripping.

The port's copy of the JAX package's ``machinery/scheme.py`` (the
reference's runtime.Scheme), cut to what a client needs: the object model
is Python dataclasses and the (de)serializer is derived from type hints,
so snake_case attributes round-trip to the camelCase wire form, unknown
wire fields are ignored, and values equal to the field default are left
out (the ``omitempty`` convention).  The same rules as the JAX package's,
so both encode an object to the same dict.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import typing
from typing import Any, Dict, Type

# Fields whose wire name is not the mechanical snake->camel conversion.
_SPECIAL_WIRE_NAMES = {
    "continue_token": "continue",
    "api_version": "apiVersion",
    "downward_api": "downwardAPI",
}


def _camel(name: str) -> str:
    if name in _SPECIAL_WIRE_NAMES:
        return _SPECIAL_WIRE_NAMES[name]
    parts = name.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


@functools.lru_cache(maxsize=None)
def _field_info(cls):
    """Resolved (name, wire_name, type, default) per dataclass field."""
    hints = typing.get_type_hints(cls)
    info = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()  # type: ignore
        else:
            default = dataclasses.MISSING
        info.append((f.name, _camel(f.name), hints[f.name], default))
    return info


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union or str(origin) == "types.UnionType":
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def to_dict(obj: Any) -> Any:
    """Encode a dataclass (or primitive/list/dict) to plain JSON-able data."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for name, wire, _tp, default in _field_info(type(obj)):
            v = getattr(obj, name)
            if v is None:
                continue
            if default is not dataclasses.MISSING and v == default:
                continue
            out[wire] = to_dict(v)
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


# Every watch event and list item crosses the decoder, so each type's
# decode plan is compiled once into a closure.  _DECODERS holds finished
# decoders only (read without the lock); a self-referential dataclass
# resolves through the in-progress map that only the building thread sees.
_DECODERS: Dict[Any, Any] = {}
_DECODERS_BUILDING: Dict[Any, Any] = {}
_DECODERS_LOCK = threading.RLock()


def _decoder(tp):
    dec = _DECODERS.get(tp)
    if dec is not None:
        return dec
    with _DECODERS_LOCK:
        dec = _DECODERS.get(tp)
        if dec is not None:
            return dec
        thunk = _DECODERS_BUILDING.get(tp)
        if thunk is not None:
            return thunk  # recursive self-reference during this build
        cell = []
        _DECODERS_BUILDING[tp] = lambda data: cell[0](data)
        try:
            real = _build_decoder(tp)  # recurses into _decoder (RLock)
            cell.append(real)
            _DECODERS[tp] = real
        finally:
            del _DECODERS_BUILDING[tp]
        return real


def _build_decoder(tp):
    tp = _unwrap_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        (item_tp,) = typing.get_args(tp) or (Any,)
        item_dec = _decoder(item_tp)

        def dec_list(data):
            if data is None:
                return None
            return [item_dec(v) for v in data]
        return dec_list
    if origin is dict:
        args = typing.get_args(tp)
        val_dec = _decoder(args[1] if len(args) == 2 else Any)

        def dec_dict(data):
            if data is None:
                return None
            return {k: val_dec(v) for k, v in data.items()}
        return dec_dict
    if dataclasses.is_dataclass(tp):
        fields = tuple((name, wire, _decoder(f_tp))
                       for name, wire, f_tp, _d in _field_info(tp))

        def dec_dc(data):
            if data is None:
                return None
            if not isinstance(data, dict):
                raise TypeError(f"cannot decode {data!r} into {tp.__name__}")
            kwargs = {}
            for name, wire, dec in fields:
                if wire in data:
                    kwargs[name] = dec(data[wire])
            return tp(**kwargs)
        return dec_dc
    if tp in (int, float, str, bool):
        def dec_prim(data):
            return tp(data) if data is not None else data
        return dec_prim
    # Any, TypeVars, unions with more than one concrete arm: passed through
    return lambda data: data


def from_dict(cls: Type, data: Any) -> Any:
    """Decode plain data into `cls` using its type hints."""
    return _decoder(cls)(data)


class Scheme:
    """Kind registry: maps a resource plural ("pods") and a kind ("Pod")
    to its dataclass, and says whether the resource is namespaced (ref:
    runtime.Scheme and the RESTMapper)."""

    def __init__(self):
        self.by_kind: Dict[str, Type] = {}
        self.by_resource: Dict[str, Type] = {}
        self.resource_of: Dict[str, str] = {}  # kind -> plural
        self.namespaced: Dict[str, bool] = {}  # plural -> bool

    def register(self, cls: Type, plural: str, namespaced: bool = True):
        kind = cls.KIND or cls.__name__
        self.by_kind[kind] = cls
        self.by_resource[plural] = cls
        self.resource_of[kind] = plural
        self.namespaced[plural] = namespaced
        return cls

    def encode(self, obj: Any) -> Dict[str, Any]:
        """The wire dict of a typed object, with its kind and apiVersion."""
        d = to_dict(obj)
        d["kind"] = type(obj).KIND or type(obj).__name__
        d["apiVersion"] = type(obj).API_VERSION
        return d

    def decode(self, data: Dict[str, Any]) -> Any:
        """The typed object of a wire dict, by its kind; None for a kind
        the scheme does not know (the JAX package's scheme answers such a
        dict with an untyped object, which the apiserver then refuses)."""
        cls = self.by_kind.get(data.get("kind", ""))
        return None if cls is None else from_dict(cls, data)

    def decode_as(self, plural: str, data: Dict[str, Any]) -> Any:
        """The typed object for an item of resource ``plural``: list items
        and watch frames need not carry their kind."""
        return from_dict(self.by_resource[plural], data)


global_scheme = Scheme()
