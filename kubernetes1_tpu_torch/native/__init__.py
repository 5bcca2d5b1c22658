"""The port's native node components, built from the C++ sources beside
this file: ``ktpu-gpu-plugin``, the ``nvidia.com/gpu`` device plugin with
the Python ``GPUDevicePlugin``'s semantics, and
``ktpu-gpu-metrics-exporter``, the node's GPU metrics on ``/metrics``.

    bins = build()            # {"ktpu-gpu-plugin": path, ...} in native/bin
    bins = build(some_dir)    # a directory of the caller's own (tests)

``build`` runs ``make -C <this dir> BIN=<dir>``: the flags and rules live
in the Makefile alone.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
PLUGIN = "ktpu-gpu-plugin"
EXPORTER = "ktpu-gpu-metrics-exporter"


def build(bin_dir: Optional[str] = None) -> Dict[str, str]:
    """Build both binaries into ``bin_dir`` (default: ``bin/`` beside the
    sources) and return {binary name: path}; raises RuntimeError with
    make's output when the build fails."""
    bin_dir = os.path.abspath(bin_dir or os.path.join(NATIVE_DIR, "bin"))
    res = subprocess.run(["make", "-s", "-C", NATIVE_DIR, f"BIN={bin_dir}"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed:\n{res.stdout}\n{res.stderr}")
    return {name: os.path.join(bin_dir, name) for name in (PLUGIN, EXPORTER)}
