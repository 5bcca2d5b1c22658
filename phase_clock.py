"""Run a tree's ``chip_smoke.py`` with each of its phases timed.

    python3 phase_clock.py [TREE]

Imports ``TREE/chip_smoke.py`` (default: this file's directory), wraps
every module-level function whose name ends in ``_phase`` so that it
prints ``phase_clock: <name> <seconds> s`` (wall clock, when it returns
or raises), then runs the script's ``main()``.  ``main`` calls its phases
through the module's globals, so a tree whose script predates this file
is timed the same way.  The last line is ``phase_clock {"tree": ...,
"phases": {...}, "total_s": ..., "exit": ...}``.

To compare two commits on one card, unpack each into a git-ignored
directory (``git archive``) and run this script on each in turn in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time


def _timed(name, fn, phases):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            phases[name] = round(time.monotonic() - t0, 1)
            print(f"phase_clock: {name} {phases[name]} s", flush=True)
    return run


def main():
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
    os.chdir(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    phases = {}
    for name, fn in list(vars(smoke).items()):
        if name.endswith("_phase") and callable(fn):
            setattr(smoke, name, _timed(name, fn, phases))
    t0, code = time.monotonic(), 0
    try:
        smoke.main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        print("phase_clock " + json.dumps({"tree": tree, "phases": phases,
                                           "total_s": round(time.monotonic() - t0, 1),
                                           "exit": code}), flush=True)
    sys.exit(code)


if __name__ == "__main__":
    main()
