"""Node-pressure eviction manager.

Ref: pkg/kubelet/eviction/{eviction_manager.go,helpers.go} — observe
memory/disk signals against thresholds, set node pressure conditions, and
evict pods lowest-QoS-first until the signal clears. QoS classes follow the
reference: BestEffort (no requests) < Burstable (requests < limits) <
Guaranteed (requests == limits for every resource). On a GPU node the main
customer is host RAM: a runaway input pipeline must be evicted before it
OOMs the training process beside it.  The port's copy of the JAX
package's ``kubelet/eviction.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

from ..api import types as t
from ..utils.quantity import parse_quantity

QOS_GUARANTEED = "Guaranteed"
QOS_BURSTABLE = "Burstable"
QOS_BESTEFFORT = "BestEffort"

_QOS_EVICTION_ORDER = {QOS_BESTEFFORT: 0, QOS_BURSTABLE: 1, QOS_GUARANTEED: 2}


def qos_class(pod: t.Pod) -> str:
    """ref: pkg/apis/core/v1/helper/qos/qos.go GetPodQOS. Requests default
    to limits when unset (the apiserver's defaulting), so limits-only pods
    are Guaranteed, not Burstable."""
    any_resources = False
    guaranteed = True
    for c in pod.spec.containers:
        req, lim = c.resources.requests or {}, c.resources.limits or {}
        if req or lim:
            any_resources = True
        for res in ("cpu", "memory"):
            limit = lim.get(res)
            request = req.get(res, limit)  # defaulting: request := limit
            if limit is None or request is None:
                guaranteed = False
            elif parse_quantity(request) != parse_quantity(limit):
                guaranteed = False
    if not any_resources:
        return QOS_BESTEFFORT
    return QOS_GUARANTEED if guaranteed else QOS_BURSTABLE


def default_signals() -> Dict[str, float]:
    """Real node signals: fraction available (0..1) per resource."""
    signals = {}
    try:
        total = avail = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
        if total and avail is not None:
            signals["memory.available"] = avail / total
    except OSError:
        pass
    try:
        st = os.statvfs("/")
        signals["nodefs.available"] = st.f_bavail / max(st.f_blocks, 1)
    except OSError:
        pass
    return signals


class EvictionManager:
    """Synchronize loop (ref: eviction_manager.go synchronize): when a signal
    drops under its threshold, evict the best candidate and set the matching
    node condition until pressure clears (with a min-reclaim hysteresis via
    pressure transition period)."""

    PRESSURE_TRANSITION_PERIOD = 10.0  # seconds a condition stays up after pressure

    SIGNAL_CONDITIONS = {
        "memory.available": "MemoryPressure",
        "nodefs.available": "DiskPressure",
    }

    def __init__(
        self,
        thresholds: Optional[Dict[str, float]] = None,  # fraction available
        signals_fn: Callable[[], Dict[str, float]] = default_signals,
        evict_fn: Optional[Callable[[t.Pod, str], None]] = None,
        list_pods: Optional[Callable[[], List[t.Pod]]] = None,
    ):
        self.thresholds = thresholds or {
            "memory.available": 0.05, "nodefs.available": 0.10,
        }
        self.signals_fn = signals_fn
        self.evict_fn = evict_fn
        self.list_pods = list_pods
        self._pressure_until: Dict[str, float] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ conditions

    def node_conditions(self) -> List[t.NodeCondition]:
        """Pressure conditions for the node status (heartbeat merges these)."""
        now = time.monotonic()
        out = []
        with self._lock:
            for signal, cond_type in self.SIGNAL_CONDITIONS.items():
                under = self._pressure_until.get(signal, 0.0) > now
                out.append(
                    t.NodeCondition(
                        type=cond_type,
                        status="True" if under else "False",
                        reason="KubeletHasInsufficient" + cond_type.replace("Pressure", "")
                        if under else "KubeletHasSufficient" + cond_type.replace("Pressure", ""),
                    )
                )
        return out

    # ------------------------------------------------------------- synchronize

    def synchronize(self) -> List[str]:
        """One pass; returns names of evicted pods."""
        signals = self.signals_fn()
        evicted: List[str] = []
        now = time.monotonic()
        for signal, threshold in self.thresholds.items():
            value = signals.get(signal)
            if value is None:
                continue
            if value >= threshold:
                continue
            with self._lock:
                self._pressure_until[signal] = now + self.PRESSURE_TRANSITION_PERIOD
            # exclude this pass's victims: their Failed status hasn't
            # propagated to the lister yet, and double-evicting one pod
            # reclaims nothing for the second signal
            victim = self._pick_victim(exclude=set(evicted))
            if victim is not None and self.evict_fn is not None:
                reason = (
                    f"node pressure: {signal} {value:.1%} below "
                    f"threshold {threshold:.1%}"
                )
                self.evict_fn(victim, reason)
                evicted.append(victim.metadata.name)
        return evicted

    def _pick_victim(self, exclude: Optional[set] = None) -> Optional[t.Pod]:
        """Rank: lowest QoS first, then newest (the reference ranks by usage
        over request; without per-pod usage attribution newest-first bounds
        the blast radius the same way)."""
        if self.list_pods is None:
            return None
        candidates = [
            p for p in self.list_pods()
            if p.status.phase == t.POD_RUNNING
            and not p.metadata.deletion_timestamp
            and p.metadata.name not in (exclude or set())
            # static/mirror control-plane pods are never pressure-evicted
            and p.spec.priority < 1_000_000
        ]
        if not candidates:
            return None
        candidates.sort(
            key=lambda p: (
                _QOS_EVICTION_ORDER[qos_class(p)],
                p.metadata.creation_timestamp,
            ),
        )
        best = candidates[0]
        # newest within the lowest class
        same_class = [
            p for p in candidates if qos_class(p) == qos_class(best)
        ]
        return max(same_class, key=lambda p: p.metadata.creation_timestamp)
