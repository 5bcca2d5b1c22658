"""hostPath normalisation for the kubelet's raw-device guard: a path is
judged by what it resolves to, not by how it is spelled
('/tmp/../dev/nvidia0' and '//dev/nvidia0' are /dev paths).  The port's
copy of the JAX package's ``utils/hostpath.py``."""

from __future__ import annotations

import posixpath


def normalize_abs(path: str) -> str:
    """Absolute, '..'-free, single-leading-slash form of `path`.  The
    lstrip matters: POSIX normpath PRESERVES a double leading slash."""
    return posixpath.normpath("/" + (path or "").lstrip("/"))


def is_under(path: str, prefix: str) -> bool:
    """True when normalized `path` equals or lives under normalized
    `prefix` (path-segment aware: /var/database is NOT under /var/data)."""
    p = normalize_abs(path)
    pre = normalize_abs(prefix)
    return p == pre or p.startswith(pre.rstrip("/") + "/")
