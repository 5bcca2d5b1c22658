"""A seeded fault seam for the port's device plane and serving client.

The port's copy of the part of the JAX package's ``utils/faultline`` that
the port's boundaries use: a boundary calls ``check(<site>)``, and an
injector activated with a seed and a spec decides, from a random stream of
its own per site, whether the fault fires there.  The same seed replays
the same decisions at each site.

    activate(seed, "device.health=drop@0.5;loadgen.request=drop@0.3")
    check("device.health")   # raises FaultInjected where a fault fires
    stats()                  # {site: faults fired}
    deactivate()

Spec grammar: ``rule[;rule...]``, ``rule = <site>=drop[@<prob>]``; ``prob``
defaults to 1.  ``drop`` raises ``FaultInjected`` (a ``ConnectionError``,
as the JAX package's drop is).  The sites:

- ``device.health`` (``deviceplugin/gpu_plugin.py``): a fault on a health
  pass is a card dying, one healthy card turns unhealthy on the
  ListAndWatch stream;
- ``loadgen.request`` (``workloads/loadgen.py``): a fault before a
  request's attempt is a transport error, which ``LoadGen`` retries and
  counts as failed once its retries are spent.

With no injector active every check is one ``is None`` test.
"""

from __future__ import annotations

import random
import threading
import zlib
from typing import Dict, Optional


class FaultInjected(ConnectionError):
    """An injected fault: a ConnectionError, so the recovery paths under
    test are the ones a real transport error takes."""


class FaultSpecError(ValueError):
    """A malformed spec, raised at activation."""


class Injector:
    """The parsed spec and one seeded stream per site, as the JAX
    package's injector seeds them: the same seed and spec give the same
    decisions at each site."""

    def __init__(self, seed: int, spec: str):
        self._prob: Dict[str, float] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._fired: Dict[str, int] = {}
        self._lock = threading.Lock()
        for rule in filter(None, (r.strip() for r in spec.split(";"))):
            site, _, fault = (p.strip() for p in rule.partition("="))
            action, _, prob_s = fault.partition("@")
            if not site or action != "drop":
                raise FaultSpecError(f"rule {rule!r} is not <site>=drop[@<prob>]")
            try:
                prob = float(prob_s) if prob_s else 1.0
            except ValueError as e:
                raise FaultSpecError(f"bad probability in rule {rule!r}: {e}") from e
            if not 0.0 <= prob <= 1.0:
                raise FaultSpecError(f"probability {prob} not in [0,1]")
            self._prob[site] = prob
            self._rngs[site] = random.Random((seed << 32) ^ zlib.crc32(site.encode()))

    def fires(self, site: str) -> bool:
        """Whether the fault at ``site`` fires: one seeded draw below
        probability 1."""
        prob = self._prob.get(site)
        if prob is None:
            return False
        with self._lock:
            fired = prob >= 1.0 or self._rngs[site].random() < prob
            if fired:
                self._fired[site] = self._fired.get(site, 0) + 1
            return fired

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)


_injector: Optional[Injector] = None


def active() -> bool:
    return _injector is not None


def activate(seed: int, spec: str) -> Injector:
    """Install an injector for the process, replacing any active one."""
    global _injector
    _injector = Injector(int(seed), spec)
    return _injector


def deactivate() -> None:
    global _injector
    _injector = None


def stats() -> Dict[str, int]:
    """{site: faults fired} of the active injector (empty when none is):
    the proof that a run exercised its sites."""
    inj = _injector
    return inj.stats() if inj is not None else {}


def check(site: str) -> None:
    """Gate one operation at ``site``: nothing when no injector is active;
    raises FaultInjected where a drop fires."""
    inj = _injector
    if inj is not None and inj.fires(site):
        raise FaultInjected(f"faultline[{site}]: injected drop")
