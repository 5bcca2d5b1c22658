"""Cross-instance metrics aggregation: the fleet merge rule, once.

The port's copy of the JAX package's ``obs/aggregate.py``.  Every
component renders the Prometheus text format (``utils/metrics.py``):
counters, gauges, and histograms with both reservoir quantiles (exact in
process, NOT mergeable) and cumulative ``_bucket`` counters (mergeable).
Merging N instances' scrapes has one rule set:

- counters (``_total``/``_count``/``_sum`` suffixes, ``_bucket`` lines,
  and what the scrape's ``# TYPE`` declares a counter) SUM;
- histogram quantiles are RECOMPUTED from the summed buckets
  (``bucket_quantile``, Prometheus' ``histogram_quantile``: rank into the
  merged cumulative distribution, linear interpolation in the owning
  bucket); two instances whose bucket boundaries differ refuse to merge;
- the max survives only as the fallback for reservoir-only metrics (no
  ``_bucket`` lines) and for gauges.

``merge_metrics`` is the same merge over flat {series: value} dicts.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_SERIES_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')

# series-key suffixes that are cumulative by the exposition contract and
# therefore always sum across instances
_SUM_SUFFIXES = ("_total", "_count", "_sum", "_bucket")


def parse_series_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``name{a="b",c="d"}`` -> (name, {a: b, c: d}).  Raises ValueError
    on garbage — scrape lines that don't parse are dropped upstream."""
    m = _SERIES_RE.match(key.strip())
    if not m:
        raise ValueError(f"unparsable series key {key!r}")
    name, labelstr = m.group(1), m.group(2)
    labels = dict(_LABEL_RE.findall(labelstr)) if labelstr else {}
    return name, labels


def format_series_key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return name + "{" + inner + "}"


class ParsedMetrics:
    """One scrape, structurally: ``types`` (family -> TYPE declaration)
    and ``samples`` (series key -> float, insertion-ordered).  The series
    keys are kept verbatim so re-rendering a single scrape is lossless."""

    def __init__(self):
        self.types: Dict[str, str] = {}
        self.samples: Dict[str, float] = {}

    def get(self, key: str, default=None):
        return self.samples.get(key, default)


def parse_metrics_text(text: str) -> ParsedMetrics:
    """Prometheus text exposition -> ParsedMetrics.  Unparsable lines are
    skipped (one component's garbage line must not fail a fleet merge)."""
    out = ParsedMetrics()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                out.types[parts[2]] = parts[3]
            continue
        key, _, val = line.rpartition(" ")
        key = key.strip()
        if not key:
            continue
        try:
            out.samples[key] = float(val)
        except ValueError:
            continue
    return out


def _family_of(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """(family, declared type) for a sample name: histogram sub-series
    (``x_bucket``/``x_sum``/``x_count``) resolve to their family's TYPE."""
    if name in types:
        return name, types[name]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            fam = name[: -len(suffix)]
            if fam in types:
                return fam, types[fam]
    return name, ""


def _should_sum(name: str, labels: Dict[str, str],
                types: Dict[str, str]) -> bool:
    if "le" in labels or name.endswith(_SUM_SUFFIXES):
        return True
    _fam, typ = _family_of(name, types)
    return typ == "counter"


def bucket_quantile(buckets: Sequence[Tuple[float, float]],
                    q: float, count: Optional[float] = None
                    ) -> Optional[float]:
    """Estimate quantile q from CUMULATIVE (le, cumulative_count) buckets
    — the prometheus histogram_quantile rule: find the bucket the rank
    falls in, interpolate linearly inside it.  ``count`` defaults to the
    +Inf bucket's cumulative count.  Returns None on an empty histogram.

    The +Inf bucket has no upper bound to interpolate toward, so a rank
    landing there answers the highest finite bound (histogram_quantile's
    behavior) — honest "at least this much" rather than a made-up tail.
    """
    finite = sorted((le, c) for le, c in buckets if le != float("inf"))
    inf_count = max((c for le, c in buckets if le == float("inf")),
                    default=None)
    total = count if count is not None else inf_count
    if total is None and finite:
        total = finite[-1][1]
    if not total:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in finite:
        if cum >= rank:
            if cum <= prev_cum:
                return le
            # linear interpolation inside the owning bucket
            return prev_le + (le - prev_le) * (rank - prev_cum) / (cum - prev_cum)
        prev_le, prev_cum = le, cum
    # rank beyond every finite bucket: the +Inf bucket owns it
    return finite[-1][0] if finite else None


def _bucket_series_of(fam: str, labels: Dict[str, str],
                      samples: Dict[str, float]
                      ) -> List[Tuple[float, float]]:
    """All ``<fam>_bucket`` samples whose non-``le`` labels match."""
    want = {k: v for k, v in labels.items() if k not in ("quantile", "le")}
    out: List[Tuple[float, float]] = []
    bucket_name = fam + "_bucket"
    for key, val in samples.items():
        name, lab = _parse_cached(key)
        if name != bucket_name:
            continue
        le_s = lab.get("le")
        if le_s is None:
            continue
        if {k: v for k, v in lab.items() if k != "le"} != want:
            continue
        le = float("inf") if le_s in ("+Inf", "inf") else float(le_s)
        out.append((le, val))
    return out


_parse_cache: Dict[str, Tuple[str, Dict[str, str]]] = {}


def _parse_cached(key: str) -> Tuple[str, Dict[str, str]]:
    hit = _parse_cache.get(key)
    if hit is None:
        try:
            hit = parse_series_key(key)
        except ValueError:
            hit = (key, {})
        if len(_parse_cache) > 65536:  # scrape-key universe is small; bound anyway
            _parse_cache.clear()
        _parse_cache[key] = hit
    return hit


def _boundaries_of(samples: Dict[str, float]) -> Dict[str, frozenset]:
    """One scrape's histogram bucket boundaries: {series-identity (family
    ``_bucket`` name + non-``le`` labels): frozenset of ``le`` bounds}."""
    bounds: Dict[str, set] = {}
    for key in samples:
        name, labels = _parse_cached(key)
        le_s = labels.get("le")
        if le_s is None or not name.endswith("_bucket"):
            continue
        ident = format_series_key(
            name, {k: v for k, v in labels.items() if k != "le"})
        le = float("inf") if le_s in ("+Inf", "inf") else float(le_s)
        bounds.setdefault(ident, set()).add(le)
    return {k: frozenset(v) for k, v in bounds.items()}


def _check_boundaries(canon: Dict[str, frozenset],
                      bounds: Dict[str, frozenset]) -> None:
    """Instances contributing buckets for the same series identity must
    agree on the ``le`` set EXACTLY.  Summing cumulative counts across
    mismatched boundaries silently invents a distribution neither
    instance observed (the count in ``le=0.5`` means different things),
    so a mismatch RAISES — never re-buckets."""
    for ident, les in bounds.items():
        prev = canon.get(ident)
        if prev is None:
            canon[ident] = les
        elif prev != les:
            raise ValueError(
                f"mismatched histogram bucket boundaries for {ident}: "
                f"{sorted(prev)} vs {sorted(les)} — bucket-wise merge is "
                f"only sound over identical boundaries; refusing to "
                f"re-bucket")


def merge_parsed(scrapes: Iterable[ParsedMetrics]) -> ParsedMetrics:
    """Merge N instances' parsed scrapes under the module's rule set.
    Raises ValueError when two instances disagree on a histogram's
    bucket boundaries (see ``_check_boundaries``)."""
    merged = ParsedMetrics()
    quantile_inputs: Dict[str, List[float]] = {}
    canon_bounds: Dict[str, frozenset] = {}
    for sc in scrapes:
        _check_boundaries(canon_bounds, _boundaries_of(sc.samples))
        for fam, typ in sc.types.items():
            merged.types.setdefault(fam, typ)
        for key, val in sc.samples.items():
            name, labels = _parse_cached(key)
            if "quantile" in labels:
                # deferred: recomputed from merged buckets below, max of
                # the per-instance values only as the reservoir fallback
                quantile_inputs.setdefault(key, []).append(val)
                if key not in merged.samples:
                    merged.samples[key] = val  # placeholder keeps ordering
                continue
            if key not in merged.samples:
                merged.samples[key] = val
            elif _should_sum(name, labels, merged.types):
                merged.samples[key] += val
            else:
                merged.samples[key] = max(merged.samples[key], val)
    for key, vals in quantile_inputs.items():
        name, labels = _parse_cached(key)
        fam = name
        buckets = _bucket_series_of(fam, labels, merged.samples)
        estimate = None
        if buckets:
            count_key = format_series_key(
                fam + "_count",
                {k: v for k, v in labels.items() if k != "quantile"})
            count = merged.samples.get(count_key)
            # count series may render labels in a different order; fall
            # back to the +Inf bucket inside bucket_quantile when absent
            estimate = bucket_quantile(
                buckets, float(labels["quantile"]), count)
        merged.samples[key] = (estimate if estimate is not None
                               else max(vals))
    return merged


def render_metrics(parsed: ParsedMetrics) -> str:
    """ParsedMetrics -> prometheus text: samples GROUPED by family under
    one TYPE header (the exposition format's contiguity rule — merged
    scrapes interleave families in insertion order, and a real
    Prometheus/OpenMetrics parser rejects a family split across two
    blocks), families in first-seen order, samples in first-seen order
    within each family."""
    families: Dict[str, List[Tuple[str, float]]] = {}
    for key, val in parsed.samples.items():
        name, _labels = _parse_cached(key)
        fam, _typ = _family_of(name, parsed.types)
        families.setdefault(fam, []).append((key, val))
    lines: List[str] = []
    for fam, samples in families.items():
        lines.append(f"# TYPE {fam} {parsed.types.get(fam) or 'untyped'}")
        for key, val in samples:
            lines.append(_render_sample(key, val))
    return "\n".join(lines) + ("\n" if lines else "")


def _render_sample(key: str, val: float) -> str:
    if not math.isfinite(val):
        # exposition format spells these +Inf/-Inf/NaN — and int() on
        # them raises, which would turn one target's legitimate +Inf
        # quantile into a permanent fleet-/metrics 500
        return (f"{key} "
                f"{'NaN' if math.isnan(val) else '+Inf' if val > 0 else '-Inf'}")
    if val == int(val) and abs(val) < 1e15:
        return f"{key} {int(val)}"
    return f"{key} {val:.6f}"


def select(parsed: ParsedMetrics, name: str,
           **labels: str) -> Dict[str, float]:
    """Samples of one metric name whose labels contain the given subset:
    {series key: value}.  The structured accessor readers use instead of
    reconstructing label-order-sensitive keys."""
    out: Dict[str, float] = {}
    for key, val in parsed.samples.items():
        n, lab = _parse_cached(key)
        if n != name:
            continue
        if all(lab.get(k) == v for k, v in labels.items()):
            out[key] = val
    return out


def merge_metrics(dicts: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Flat-dict merge with the same rules ({series: value}, no TYPE
    headers).  Counters/buckets sum; quantile series recompute
    from the summed buckets when the family rendered them; gauges and
    reservoir-only quantiles take the max (fallback).  Mismatched bucket
    boundaries across inputs raise (see ``_check_boundaries``)."""
    out: Dict[str, float] = {}
    quantile_inputs: Dict[str, List[float]] = {}
    canon_bounds: Dict[str, frozenset] = {}
    for mx in dicts:
        _check_boundaries(canon_bounds, _boundaries_of(mx))
        for key, val in mx.items():
            name, labels = _parse_cached(key)
            if "quantile" in labels:
                quantile_inputs.setdefault(key, []).append(val)
                if key not in out:
                    out[key] = val
                continue
            if key not in out:
                out[key] = val
            elif _should_sum(name, labels, {}):
                out[key] += val
            else:
                out[key] = max(out[key], val)
    for key, vals in quantile_inputs.items():
        name, labels = _parse_cached(key)
        buckets = _bucket_series_of(name, labels, out)
        estimate = None
        if buckets:
            count_key = format_series_key(
                name + "_count",
                {k: v for k, v in labels.items() if k != "quantile"})
            estimate = bucket_quantile(
                buckets, float(labels["quantile"]), out.get(count_key))
        out[key] = estimate if estimate is not None else max(vals)
    return out
