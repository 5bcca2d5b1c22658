"""Breach timelines: one time-ordered, cross-component story per verdict.

The port's copy of the JAX package's ``obs/timeline.py``.  ``capture``
pulls ``/debug/flightrecorder`` and ``/debug/traces`` from every endpoint
registered with an ``ObsCollector`` and merges both into one wall-clock
ordered list: flight-recorder events keep their component, kind and
fields (keyed by ``rv`` where they carry one), trace spans become entries
at their start (keyed by trace id, with duration and error).  An endpoint
without one of the two paths (the port's components serve no
``/debug/flightrecorder`` yet) contributes nothing to that half.
``summarize`` gives the first entries as log lines.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def capture(collector, trace_id: str = "", since_wall: float = 0.0,
            max_entries: int = 4000) -> dict:
    """Pull ``/debug/flightrecorder`` + ``/debug/traces`` from every
    registered endpoint and merge into one time-ordered timeline.

    ``since_wall`` drops entries older than the given wall-clock stamp
    (0 keeps everything the rings still hold); ``max_entries`` keeps the
    newest N after the merge, so a long mixer run's breach dump stays a
    bounded artifact.  Returns::

        {"entries": [...], "components": [...], "counts": {...},
         "keys": {key: entry count}}
    """
    flight = collector.flightrecorder()
    traces = collector.traces(trace_id)
    entries: List[dict] = []
    for comp, events in (flight.get("components") or {}).items():
        for ev in events:
            wall = ev.get("wall")
            if wall is None or wall < since_wall:
                continue
            entry = {"t_wall": wall, "component": comp, "type": "event",
                     "what": ev.get("kind", "")}
            key = _event_key(ev)
            if key:
                entry["key"] = key
            detail = {k: v for k, v in ev.items()
                      if k not in ("wall", "t_mono", "kind")}
            if detail:
                entry["detail"] = detail
            entries.append(entry)
    for sp in traces.get("spans") or []:
        wall = sp.get("start")
        if wall is None or wall < since_wall:
            continue
        entry = {"t_wall": wall, "component": sp.get("component") or "",
                 "type": "span", "what": sp.get("name", ""),
                 "duration_ms": sp.get("durationMs")}
        if sp.get("traceId"):
            entry["key"] = f"trace:{sp['traceId']}"
        if sp.get("error"):
            entry["error"] = sp["error"]
        entries.append(entry)
    entries.sort(key=lambda e: e["t_wall"])
    if len(entries) > max_entries:
        entries = entries[-max_entries:]
    components = sorted({e["component"] for e in entries if e["component"]})
    keys: Dict[str, int] = {}
    for e in entries:
        k = e.get("key")
        if k:
            keys[k] = keys.get(k, 0) + 1
    return {
        "entries": entries,
        "components": components,
        "counts": {
            "events": sum(1 for e in entries if e["type"] == "event"),
            "spans": sum(1 for e in entries if e["type"] == "span"),
        },
        "keys": keys,
    }


def _event_key(ev: dict) -> Optional[str]:
    """The correlation key a flight-recorder event carries, if any: a
    resourceVersion field links it to the watch/trace stream."""
    for f in ("rv", "resource_version", "resourceVersion"):
        v = ev.get(f)
        if v not in (None, ""):
            return f"rv:{v}"
    if ev.get("trace"):
        return f"trace:{ev['trace']}"
    return None


def summarize(timeline: dict, head: int = 12) -> List[str]:
    """Human-oriented one-liners for logs: the first ``head`` entries as
    ``+12.345s component kind`` relative to the first entry."""
    entries = timeline.get("entries") or []
    if not entries:
        return []
    t0 = entries[0]["t_wall"]
    out = []
    for e in entries[:head]:
        out.append(f"+{e['t_wall'] - t0:7.3f}s {e['component']:<14} "
                   f"{e['type']}:{e['what']}")
    return out
