"""Label selectors with the reference's matching semantics (ref:
apimachinery's labels/selector.go): ``matchLabels`` and the structured
LabelSelector (matchLabels + matchExpressions) that controllers and pod
affinity terms carry.  The port's copy of the JAX package's
``machinery/labels.py`` matchers."""

from __future__ import annotations

from typing import Dict, Optional


def match_labels(selector: Optional[Dict[str, str]], labels: Dict[str, str]) -> bool:
    """matchLabels: every k=v must be present."""
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


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
