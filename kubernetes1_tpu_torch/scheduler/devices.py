"""Device allocation: pick specific card IDs matching attribute affinity.

The port's copy of the JAX package's ``scheduler/devices.py`` (ref:
plugin/pkg/scheduler/core/extended_resources.go:42-150): for each
PodExtendedResource, filter the node's available devices by the request's
ResourceAffinity (selector ops In/NotIn/Exists/Gt/Lt over vendor-prefixed
attributes), then pick ``quantity`` device IDs.  Where the JAX package
prefers TPU chips of one ICI slice in coordinate order, the port prefers
cards of one NVLink domain (``nvidia.com/gpu/nvlink-domain``) in order of
their minor (``nvidia.com/gpu/minor``), so that a pod's collectives stay
on NVLink, and keeps domains whole for later pods by picking from the
domain with the least room to spare (best fit).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..api import types as t


def device_matches(dev: t.ExtendedResourceDevice, affinity: Optional[t.ResourceAffinity]) -> bool:
    if affinity is None:
        return True
    attrs = dev.attributes or {}
    for req in affinity.required:
        val = attrs.get(req.key)
        if req.operator == "In":
            if val not in req.values:
                return False
        elif req.operator == "NotIn":
            if val is not None and val in req.values:
                return False
        elif req.operator == "Exists":
            if val is None:
                return False
        elif req.operator == "DoesNotExist":
            if val is not None:
                return False
        elif req.operator in ("Gt", "Lt"):
            if val is None or not req.values:
                return False
            try:
                have, want = float(val), float(req.values[0])
            except ValueError:
                return False
            if req.operator == "Gt" and not have > want:
                return False
            if req.operator == "Lt" and not have < want:
                return False
        else:
            return False
    return True


def domain_of(dev: t.ExtendedResourceDevice) -> str:
    """The card's NVLink domain ("" when its plugin publishes none)."""
    return (dev.attributes or {}).get(t.ATTR_GPU_NVLINK_DOMAIN, "")


def _minor_key(dev: t.ExtendedResourceDevice) -> Tuple:
    # memoized: sorting pools would parse the same strings for the
    # scheduler's whole life otherwise
    cached = getattr(dev, "_ktpu_minor", None)
    if cached is not None:
        return cached
    raw = (dev.attributes or {}).get(t.ATTR_GPU_MINOR, "")
    try:
        key = tuple(int(x) for x in raw.split(",")) if raw else ()
    except ValueError:
        key = ()
    dev._ktpu_minor = key
    return key


def pick_devices(
    candidates: List[t.ExtendedResourceDevice], quantity: int
) -> Optional[List[str]]:
    """Choose ``quantity`` cards: best fit by NVLink domain, then minor order."""
    if len(candidates) < quantity:
        return None
    by_domain: Dict[str, List[t.ExtendedResourceDevice]] = defaultdict(list)
    for d in candidates:
        by_domain[domain_of(d)].append(d)
    # best fit: the smallest domain that still satisfies the request
    fitting = [devs for devs in by_domain.values() if len(devs) >= quantity]
    if fitting:
        pool = min(fitting, key=len)
    else:
        # spill across domains deterministically (largest first, to bound
        # the number of domains touched)
        pool = []
        for devs in sorted(by_domain.values(), key=len, reverse=True):
            pool.extend(devs)
    pool = sorted(pool, key=lambda d: (_minor_key(d), d.id))
    return [d.id for d in pool[:quantity]]


def allocate_for_pod(
    pod: t.Pod, node_info
) -> Tuple[Optional[Dict[str, List[str]]], str]:
    """Try to satisfy every PodExtendedResource from node_info's available
    devices.  Returns ({request name: [device ids]}, "") on success or
    (None, reason).  Several requests for one resource are satisfied
    disjointly."""
    if not pod.spec.extended_resources:
        return {}, ""
    assignments: Dict[str, List[str]] = {}
    taken: Dict[str, set] = defaultdict(set)
    for per in pod.spec.extended_resources:
        avail = [
            d
            for d in node_info.available_devices(per.resource)
            if d.id not in taken[per.resource] and device_matches(d, per.affinity)
        ]
        ids = pick_devices(avail, per.quantity)
        if ids is None:
            return None, (
                f"insufficient {per.resource} matching affinity "
                f"(want {per.quantity}, matched {len(avail)})"
            )
        assignments[per.name] = ids
        taken[per.resource].update(ids)
    return assignments, ""


def fits_devices(pod: t.Pod, node_info) -> Tuple[bool, str]:
    """Cheap feasibility check for the filter scan: the full allocation
    (domain best fit, minor sort) runs only on the selected node.  A
    request without affinity (the common case) needs only a count; one
    with affinity runs the real allocator."""
    if not pod.spec.extended_resources:
        return True, ""
    need: Dict[str, int] = defaultdict(int)
    for per in pod.spec.extended_resources:
        if per.affinity is not None:
            ok = allocate_for_pod(pod, node_info)[0] is not None
            return (True, "") if ok else (False, f"insufficient {per.resource} matching affinity")
        need[per.resource] += per.quantity
    for resource, qty in need.items():
        info = node_info.extended.get(resource)
        have = info.available_count() if info else 0
        if have < qty:
            return False, f"insufficient {resource} (want {qty}, available {have})"
    return True, ""
