"""Label selectors with the reference's matching semantics (ref:
apimachinery's labels/selector.go): the selector string of a LIST or
WATCH (equality ``k=v``, ``k!=v`` and set-based ``k in (a,b)``,
``k notin (a,b)``, ``k``, ``!k`` requirements ANDed together),
``matchLabels``, and the structured LabelSelector (matchLabels +
matchExpressions) that controllers and pod affinity terms carry.  The
port's copy of the JAX package's ``machinery/labels.py``."""

from __future__ import annotations

import re
from typing import Dict, List, Optional


def match_labels(selector: Optional[Dict[str, str]], labels: Dict[str, str]) -> bool:
    """matchLabels: every k=v must be present."""
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


_REQ_RE = re.compile(
    r"\s*(?P<bang>!)?\s*(?P<key>[A-Za-z0-9_./-]+)\s*"
    r"(?:(?P<op>=|==|!=|\s+in\s+|\s+notin\s+)\s*(?P<val>\([^)]*\)|[A-Za-z0-9_.-]*))?\s*$"
)


def parse_selector(s: str) -> List[tuple]:
    """Parse a selector string into requirements [(key, op, values)]."""
    if not s or not s.strip():
        return []
    reqs = []
    for part in _split_top(s):
        m = _REQ_RE.match(part)
        if not m:
            raise ValueError(f"invalid selector: {part!r}")
        key, op, val = m.group("key"), m.group("op"), m.group("val")
        if m.group("bang"):
            reqs.append((key, "!", []))
        elif op is None:
            reqs.append((key, "exists", []))
        else:
            op = op.strip()
            if op in ("=", "=="):
                reqs.append((key, "=", [val]))
            elif op == "!=":
                reqs.append((key, "!=", [val]))
            else:  # in / notin
                vals = [v.strip() for v in val.strip("()").split(",") if v.strip()]
                reqs.append((key, op, vals))
    return reqs


def _split_top(s: str) -> List[str]:
    """Split on commas not inside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


def selector_matches(reqs: List[tuple], labels: Dict[str, str]) -> bool:
    for key, op, values in reqs:
        if op == "=":
            if labels.get(key) != values[0]:
                return False
        elif op == "!=":
            if labels.get(key) == values[0]:
                return False
        elif op == "exists":
            if key not in labels:
                return False
        elif op == "!":
            if key in labels:
                return False
        elif op == "in":
            if labels.get(key) not in values:
                return False
        elif op == "notin":
            if key in labels and labels[key] in values:
                return False
        else:
            raise ValueError(f"unknown op {op!r}")
    return True


def label_selector_matches(selector, labels: Dict[str, str]) -> bool:
    """Structured LabelSelector (matchLabels + matchExpressions) matching.

    `selector` is an api.types.LabelSelector or None (None matches
    nothing, the reference's controller semantics: a nil selector selects
    nothing, so that nothing is adopted by accident).
    """
    if selector is None:
        return False
    if selector.match_labels and not match_labels(selector.match_labels, labels):
        return False
    for expr in selector.match_expressions or []:
        op = expr.operator
        key, values = expr.key, expr.values or []
        if op == "In":
            if labels.get(key) not in values:
                return False
        elif op == "NotIn":
            if key in labels and labels[key] in values:
                return False
        elif op == "Exists":
            if key not in labels:
                return False
        elif op == "DoesNotExist":
            if key in labels:
                return False
        else:
            raise ValueError(f"unknown operator {op}")
    return True
