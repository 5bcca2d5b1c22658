"""Flight recorder: bounded per-component rings of structured events.

The port's copy of the JAX package's ``utils/flightrec.py``.  A component
drops one event into its ring with ``note(component, <kind>, **fields)``;
the kinds are the closed enum below (``note`` refuses any other string).
Rings are process-global, keyed by component name.  The port's scorecard
notes ``SLO_BREACH`` when a burn-rate alert fires, and ``dump()`` gives
the rings to a reader; ``reset()`` clears them.

The port's components serve no ``/debug/flightrecorder`` yet: the obs
collector's fan-out and ``obs/timeline.capture`` treat such a target as
one without the endpoint (it contributes nothing).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

# ----------------------------------------------------------- event kinds
#
# The declared enum: one constant per recorded event kind, the JAX
# package's names for those the port notes.

SLO_BREACH = "slo_breach"              # scorecard burn-rate alert fired

KINDS = frozenset({SLO_BREACH})

# Per-component ring bound: forensics wants the recent tail.  512 events
# x ~10 components x ~200 bytes is ~1MB worst case — flat, never grows.
RING_CAPACITY = 512

_rings: Dict[str, deque] = {}
_lock = threading.Lock()


def note(component: str, kind: str, **fields) -> None:
    """Record one event on ``component``'s ring.  ``kind`` must be one of
    the declared constants (programmer error otherwise — the enum is the
    contract the dump consumers grep against)."""
    if kind not in KINDS:
        raise ValueError(f"flightrec kind {kind!r} is not in the declared "
                         f"enum (utils/flightrec.py KINDS)")
    ev = {
        "t_mono": round(time.monotonic(), 6),
        # wall time is for the human reading a dump next to logs; every
        # ordering/lag computation uses the monotonic stamp
        "wall": round(time.time(), 3),
        "kind": kind,
    }
    for k, v in fields.items():
        ev[k] = v if isinstance(v, (int, float, bool, type(None))) else str(v)
    with _lock:
        ring = _rings.get(component)
        if ring is None:
            ring = _rings[component] = deque(maxlen=RING_CAPACITY)
        ring.append(ev)


def dump(component: str = "") -> dict:
    """{"components": {name: [events oldest->newest]}} — one component's
    ring, or every ring."""
    with _lock:
        if component:
            ring = _rings.get(component)
            comps = {component: list(ring)} if ring is not None else {}
        else:
            comps = {name: list(ring) for name, ring in _rings.items()}
    return {"components": comps}


def reset() -> None:
    """Clear every ring (tests: each run's dump must be ITS timeline, not
    the process's history)."""
    with _lock:
        _rings.clear()
