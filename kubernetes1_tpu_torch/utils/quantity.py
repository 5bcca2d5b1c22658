"""Resource quantity parsing (ref: apimachinery's api/resource/quantity.go):
plain numbers, milli-units ("500m") and binary or decimal suffixes ("1Gi",
"2G"), as the scheduler compares them.  The port's copy of the JAX
package's ``utils/quantity.py``."""

from __future__ import annotations

_SUFFIX = {
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
}


def parse_quantity(q) -> float:
    """Parse to a float in base units (cpu cores, bytes, device count)."""
    if q is None:
        return 0.0
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if not s:
        return 0.0
    if s.endswith("m") and s[:-1].replace(".", "", 1).lstrip("-").isdigit():
        return float(s[:-1]) / 1000.0
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "k", "M", "G", "T", "P"):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * _SUFFIX[suf]
    return float(s)


def parse_milli(q) -> int:
    """Parse to integer milli-units (the scheduler's cpu accounting unit)."""
    return int(round(parse_quantity(q) * 1000))
