"""Declarative SLOs and multi-window burn-rate evaluation: the judgment
layer over the obs plane.

The port's copy of the JAX package's ``obs/scorecard.py``.  An ``SLO``
names a metric selector (series name and label subset), a threshold with
a comparison, a compliance objective and burn-rate alert window pairs
(the SRE book's multi-window multi-burn rule).  The ``Scorecard``
evaluates every SLO each tick:

- ``fleet`` SLOs read the collector's targets merged through
  ``obs.aggregate``.  A target whose last scrape is down or older than
  ``stale_after_s`` contributes NOTHING: stale is missing;
- ``pods`` SLOs read PodCustomMetrics through a clientset, skipping a
  collection marked ``stale``;
- ``fed`` SLOs take values the caller pushes (``feed``).

A missing tick counts neither good nor bad (``ktpu_slo_missing_total``).
Burn rate over a window = (bad fraction in the window) / (1 - objective);
an alert pair (long_s, short_s, factor) fires when both windows burn at
>= factor.  A breach drops a ``flightrec.SLO_BREACH`` event and calls the
registered on-breach hooks.  Exported: ``ktpu_slo_good_total``,
``ktpu_slo_bad_total``, ``ktpu_slo_missing_total``, ``ktpu_slo_burn_rate``
and ``ktpu_slo_eval_errors_total``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..utils import flightrec
from ..utils.metrics import MetricsServer, Registry
from . import aggregate
from .appmetrics import sample_value

# Default multi-window multi-burn alert pairs, scaled for runs
# measured in seconds rather than the SRE book's hours: (long_s,
# short_s, burn factor) — the book's (1h, 5m, 14.4x) fast-page and
# (6h, 30m, 6x) slow-burn pairs mapped onto seconds.  Note the factor
# ceiling: burn can never exceed 1/(1-objective), so a 14.4x pair is
# unreachable for objectives below ~0.93 — short-run SLOs with loose
# objectives should pass their own seconds-scale ``burn_alerts``.
DEFAULT_BURN_ALERTS: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 5.0, 14.4),
    (300.0, 30.0, 6.0),
)

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, t: v <= t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    ">": lambda v, t: v > t,
}

_REDUCES = {
    "max": max,
    "min": min,
    "sum": sum,
    "avg": lambda xs: sum(xs) / len(xs),
}


@dataclass
class SLO:
    """One declarative objective.  ``name`` is the ``slo=`` label value
    on every exported series; ``scenario`` groups verdicts in the
    cluster-life scorecard JSON."""

    name: str
    threshold: float
    op: str = "<="                    # value OP threshold  ==  good tick
    metric: str = ""                  # series name (fleet/pods sources)
    labels: Dict[str, str] = field(default_factory=dict)
    source: str = "fleet"             # fleet | pods | fed
    reduce: str = "max"               # fold across matching series
    objective: float = 0.99           # target good-tick ratio
    scenario: str = ""
    namespace: str = "default"        # pods source: where to list
    selector: str = ""                # pods source: label selector
    burn_alerts: Tuple[Tuple[float, float, float], ...] = DEFAULT_BURN_ALERTS

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"SLO {self.name!r}: op {self.op!r} not in "
                             f"{sorted(_OPS)}")
        if self.reduce not in _REDUCES:
            raise ValueError(f"SLO {self.name!r}: reduce {self.reduce!r} "
                             f"not in {sorted(_REDUCES)}")
        if self.source not in ("fleet", "pods", "fed"):
            raise ValueError(f"SLO {self.name!r}: source {self.source!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")


class _SLOState:
    """Mutable evaluation state beside one SLO: tick history for the
    burn windows, totals, breach log."""

    __slots__ = ("ticks", "good", "bad", "missing", "last_value",
                 "breached", "breaches", "fed")

    def __init__(self):
        # (t_mono, bad?) per evaluated (non-missing) tick; pruned to the
        # longest burn window
        self.ticks: Deque[Tuple[float, bool]] = deque()
        self.good = 0
        self.bad = 0
        self.missing = 0
        self.last_value: Optional[float] = None
        self.breached = False
        self.breaches: List[dict] = []
        self.fed: Deque[float] = deque(maxlen=256)


class Scorecard:
    """Evaluates registered SLOs on an interval (or on explicit
    :meth:`tick` calls — tests drive it deterministically) and exports
    the ``ktpu_slo_*`` series.

    ``collector`` feeds ``fleet`` SLOs, ``clientset`` feeds ``pods``
    SLOs; either may be None when no SLO needs it.  ``serve()`` exposes
    /metrics (and /healthz, /readyz via MetricsServer) so the
    scorecard itself registers with the collector like any component.
    """

    COMPONENT = "scorecard"

    def __init__(self, collector=None, clientset=None,
                 interval: float = 0.5, stale_after_s: float = 10.0):
        self.collector = collector
        self.clientset = clientset
        self.interval = interval
        self.stale_after_s = stale_after_s
        self.registry = Registry()
        self.good_total = self.registry.counter(
            "ktpu_slo_good_total", "ticks where the SLO sample met its "
            "threshold (label slo=)")
        self.bad_total = self.registry.counter(
            "ktpu_slo_bad_total", "ticks where the SLO sample violated "
            "its threshold (label slo=)")
        self.missing_total = self.registry.counter(
            "ktpu_slo_missing_total", "ticks with no fresh sample — "
            "stale/absent data counts neither good nor bad (label slo=)")
        self.burn_rate_gauge = self.registry.gauge(
            "ktpu_slo_burn_rate", "error-budget burn rate per alert "
            "window (labels slo=, window=)")
        self.eval_errors = self.registry.counter(
            "ktpu_slo_eval_errors_total", "evaluator/breach-hook "
            "exceptions survived (label stage=)")
        self._slos: Dict[str, SLO] = {}
        self._state: Dict[str, _SLOState] = {}
        self._lock = threading.Lock()
        self._on_breach: List[Callable[[SLO, dict], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.server: Optional[MetricsServer] = None

    # ------------------------------------------------------------ registry

    def add(self, slo: SLO) -> SLO:
        with self._lock:
            if slo.name in self._slos:
                raise ValueError(f"SLO {slo.name!r} already registered")
            self._slos[slo.name] = slo
            self._state[slo.name] = _SLOState()
        return slo

    def extend(self, slos) -> None:
        for s in slos:
            self.add(s)

    def slos(self) -> List[SLO]:
        with self._lock:
            return list(self._slos.values())

    def on_breach(self, cb: Callable[[SLO, dict], None]) -> None:
        """Register a breach hook: called OUTSIDE the scorecard lock with
        (slo, breach-info) on each not-breached -> breached transition."""
        self._on_breach.append(cb)

    def feed(self, name: str, value: float) -> None:
        """Push one observed sample for a ``fed`` SLO; the next tick
        consumes the most recent value."""
        with self._lock:
            st = self._state.get(name)
            if st is None:
                raise KeyError(f"no SLO named {name!r}")
            st.fed.append(float(value))

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Scorecard":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="scorecard", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.server is not None:
            self.server.stop()
            self.server = None

    def serve(self, port: int = 0) -> str:
        """Expose /metrics (+ debug endpoints) and return the URL —
        register it with the collector like any other component."""
        if self.server is None:
            self.server = MetricsServer(self.registry, port=port)
            self.server.start()
        return self.server.url

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — one bad tick must not kill the evaluator
                self.eval_errors.labels(stage="tick").inc()

    # --------------------------------------------------------- evaluation

    def tick(self, now: Optional[float] = None) -> Dict[str, Optional[float]]:
        """Evaluate every SLO once.  Returns {slo: sampled value or None
        (missing)} — tests and callers read it directly."""
        now = time.monotonic() if now is None else now
        fleet = self._fleet_view(now)
        with self._lock:
            slos = list(self._slos.values())
        out: Dict[str, Optional[float]] = {}
        fired: List[Tuple[SLO, dict]] = []
        for slo in slos:
            value = self._sample(slo, fleet)
            out[slo.name] = value
            ev = self._record(slo, value, now)
            if ev is not None:
                fired.append((slo, ev))
        for slo, ev in fired:
            flightrec.note(self.COMPONENT, flightrec.SLO_BREACH,
                           slo=slo.name, scenario=slo.scenario,
                           value=ev.get("value"),
                           burn_rate=ev.get("burn_rate"),
                           window_s=ev.get("window_s"))
            for cb in self._on_breach:
                try:
                    cb(slo, ev)
                except Exception:  # noqa: BLE001 — a hook must not kill evaluation
                    self.eval_errors.labels(stage="breach_hook").inc()
        return out

    def _fleet_view(self, now: float) -> Optional[aggregate.ParsedMetrics]:
        """Merge the collector's FRESH targets into one view; stale or
        down targets are omitted entirely (their samples are missing for
        this tick: stale is missing)."""
        if self.collector is None:
            return None
        fresh = []
        for tgt in self.collector.targets():
            parsed = getattr(tgt, "parsed", None)
            last = getattr(tgt, "last_scrape_mono", None)
            if parsed is None or not getattr(tgt, "up", False):
                continue
            if last is None or now - last > self.stale_after_s:
                continue
            fresh.append(parsed)
        if not fresh:
            return None
        return aggregate.merge_parsed(fresh)

    def _sample(self, slo: SLO, fleet) -> Optional[float]:
        if slo.source == "fed":
            with self._lock:
                st = self._state[slo.name]
                return st.fed[-1] if st.fed else None
        if slo.source == "pods":
            return self._pods_sample(slo)
        if fleet is None:
            return None
        matched = aggregate.select(fleet, slo.metric, **slo.labels)
        vals = [v for v in matched.values() if v == v]  # drop NaN
        if not vals:
            return None
        return float(_REDUCES[slo.reduce](vals))

    def _pods_sample(self, slo: SLO) -> Optional[float]:
        if self.clientset is None:
            return None
        try:
            cols, _ = self.clientset.podcustommetrics.list(
                namespace=slo.namespace, label_selector=slo.selector)
        except Exception:  # noqa: BLE001 — apiserver blip: missing, not bad
            return None
        vals = []
        for pcm in cols:
            if getattr(pcm, "stale", False):
                continue  # stale collection = missing, never good/bad
            v = sample_value(pcm, slo.metric)
            if v is not None:
                vals.append(v)
        if not vals:
            return None
        return float(_REDUCES[slo.reduce](vals))

    def _record(self, slo: SLO, value: Optional[float],
                now: float) -> Optional[dict]:
        """Fold one sample into counters + burn windows.  Returns the
        breach event dict on a not-breached -> breached transition."""
        with self._lock:
            st = self._state[slo.name]
            st.last_value = value
            if value is None:
                st.missing += 1
                self.missing_total.labels(slo=slo.name).inc()
                return None
            bad = not _OPS[slo.op](value, slo.threshold)
            if bad:
                st.bad += 1
                self.bad_total.labels(slo=slo.name).inc()
            else:
                st.good += 1
                self.good_total.labels(slo=slo.name).inc()
            st.ticks.append((now, bad))
            horizon = max(a[0] for a in slo.burn_alerts)
            while st.ticks and st.ticks[0][0] < now - horizon:
                st.ticks.popleft()
            breach = None
            for long_s, short_s, factor in slo.burn_alerts:
                br_long = self._burn(st, slo, now, long_s)
                br_short = self._burn(st, slo, now, short_s)
                self.burn_rate_gauge.labels(
                    slo=slo.name, window=f"{long_s:g}s").set(br_long or 0.0)
                self.burn_rate_gauge.labels(
                    slo=slo.name, window=f"{short_s:g}s").set(br_short or 0.0)
                if (breach is None and br_long is not None
                        and br_short is not None
                        and br_long >= factor and br_short >= factor):
                    breach = {"t_mono": round(now, 6), "value": value,
                              "burn_rate": round(br_long, 3),
                              "window_s": long_s, "factor": factor}
            if breach is not None and not st.breached:
                st.breached = True
                st.breaches.append(breach)
                return breach
            if breach is None:
                st.breached = False  # re-arm: a later burn is a new breach
            return None

    @staticmethod
    def _burn(st: _SLOState, slo: SLO, now: float,
              window_s: float) -> Optional[float]:
        ticks = [bad for t, bad in st.ticks if t >= now - window_s]
        if not ticks:
            return None
        bad_frac = sum(ticks) / len(ticks)
        return bad_frac / (1.0 - slo.objective)

    # ----------------------------------------------------------- readouts

    def verdict(self) -> dict:
        """{slo name: verdict dict} — the scorecard JSON's SLO section."""
        out = {}
        with self._lock:
            for name, slo in self._slos.items():
                st = self._state[name]
                measured = st.good + st.bad
                ratio = (st.good / measured) if measured else None
                out[name] = {
                    "slo": name,
                    "scenario": slo.scenario,
                    "metric": slo.metric or "(fed)",
                    "op": slo.op,
                    "threshold": slo.threshold,
                    "objective": slo.objective,
                    "good": st.good,
                    "bad": st.bad,
                    "missing": st.missing,
                    "good_ratio": round(ratio, 4) if ratio is not None else None,
                    "met": (ratio >= slo.objective) if ratio is not None else None,
                    "last_value": st.last_value,
                    "breaches": list(st.breaches),
                }
        return out

    def breached_slos(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._state.items() if st.breaches)

    def render(self) -> str:
        return self.registry.render()
