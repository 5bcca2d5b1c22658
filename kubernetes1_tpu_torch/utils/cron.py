"""5-field cron schedule parsing (minute hour day-of-month month
day-of-week: "*", numbers, ranges, steps and comma lists), as the
apiserver's CronJob strategy validates a schedule.  The port's copy of
the parser of the JAX package's ``utils/cron.py``; the next-fire
computation stays with the CronJob controller."""

from __future__ import annotations

from typing import List, Set

_FIELDS = [
    ("minute", 0, 59),
    ("hour", 0, 23),
    ("dom", 1, 31),
    ("month", 1, 12),
    ("dow", 0, 6),  # 0 = Sunday; 7 accepted as Sunday too
]


def _parse_field(expr: str, lo: int, hi: int, name: str) -> Set[int]:
    # dow accepts 7 as Sunday, including as a range endpoint ("5-7" = Fri-Sun)
    if name == "dow":
        hi = 7
    out: Set[int] = set()
    for part in expr.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            if not step_s.isdigit() or int(step_s) < 1:
                raise ValueError(f"bad step in {name} field")
            step = int(step_s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            if not (a.isdigit() and b.isdigit()):
                raise ValueError(f"bad range in {name} field")
            start, end = int(a), int(b)
        elif part.isdigit():
            start = end = int(part)
        else:
            raise ValueError(f"bad value {part!r} in {name} field")
        if start < lo or end > hi or start > end:
            raise ValueError(f"{name} value out of range {lo}-{hi}")
        values = range(start, end + 1, step)
        out.update(v % 7 for v in values) if name == "dow" else out.update(values)
    return out


_MONTH_MAX_DAY = {2: 29, 4: 30, 6: 30, 9: 30, 11: 30}


def parse_cron(schedule: str) -> List[Set[int]]:
    parts = schedule.split()
    if len(parts) != 5:
        raise ValueError("schedule must have 5 fields (min hour dom month dow)")
    fields = [
        _parse_field(p, lo, hi, name)
        for p, (name, lo, hi) in zip(parts, _FIELDS)
    ]
    minute, hour, dom, month, dow = fields
    # reject schedules that can never fire (e.g. "0 0 31 2 *"): next_fire
    # would otherwise scan 4 years of minutes before erroring on every sync
    dom_star = dom == set(range(1, 32))
    dow_star = dow == set(range(0, 7))
    if not dom_star and dow_star:
        if all(min(dom) > _MONTH_MAX_DAY.get(m, 31) for m in month):
            raise ValueError("schedule never fires (day-of-month vs month)")
    return fields
