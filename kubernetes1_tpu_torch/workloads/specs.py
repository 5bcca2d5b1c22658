"""Spec builders for pods that want a card: plain dicts in the wire form.

The port imports none of the orchestrator's API types, so it builds its
objects as the JSON the apiserver takes: the dicts that the JAX package's
``machinery/scheme.to_dict`` gives for the same objects (camelCase keys,
defaults left out).  A card is asked for in the pod-level form,
``spec.extendedResources`` plus each container's
``extendedResourceRequests``, which the apiserver's ResourceV2 admission
passes; an ``nvidia.com/gpu`` container limit is refused there.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import List, Optional

from .. import GPU_RESOURCE

REPO_ROOT = str(Path(__file__).resolve().parents[2])


def pod_ready(pod: dict) -> bool:
    """Running, not terminating, and Ready: what a Service's Endpoints
    list among its ready addresses."""
    st = pod.get("status") or {}
    return (st.get("phase") == "Running"
            and not (pod.get("metadata") or {}).get("deletionTimestamp")
            and any(c.get("type") == "Ready" and c.get("status") == "True"
                    for c in st.get("conditions") or []))


def gpu_request(pod_spec: dict, n: int = 1, name: str = "gpu",
                affinity: Optional[List[dict]] = None) -> dict:
    """Ask for ``n`` cards in the pod-level form: a PodExtendedResource
    named ``name`` in ``pod_spec["extendedResources"]``, referenced from
    every container's ``extendedResourceRequests``.  ``affinity`` is a list
    of requirements on the cards' attributes, each
    ``{"key": ..., "operator": "In" | "NotIn" | "Exists" | "Gt" | "Lt",
    "values": [...]}`` (``nvidia.com/gpu/model``, ``nvidia.com/gpu/memory``
    in MiB, ...).  Returns ``pod_spec``, changed in place."""
    per = {"name": name, "resource": GPU_RESOURCE, "quantity": n}
    if affinity:
        per["affinity"] = {"required": [dict(r) for r in affinity]}
    pod_spec.setdefault("extendedResources", []).append(per)
    for c in pod_spec.get("containers") or []:
        c.setdefault("extendedResourceRequests", []).append(name)
    return pod_spec


def pythonpath_env() -> dict:
    """The PYTHONPATH entry that finds this checkout: the repo root
    prepended to the caller's own, which may carry its own entries."""
    return {"name": "PYTHONPATH",
            "value": os.pathsep.join(p for p in (REPO_ROOT, os.environ.get("PYTHONPATH", ""))
                                     if p)}


def payload_job(name: str, argv: List[str], gpus: int = 1, out: Optional[str] = None) -> dict:
    """A Job of one pod that runs ``python -m <argv...>`` (this
    interpreter) on ``gpus`` cards, with ``--out <out>`` appended when
    given: one completion, ``restartPolicy: Never`` and ``backoffLimit: 0``
    (the first crash is final), the repo root first on PYTHONPATH.  The
    counterpart of the Job the JAX package's ``bench.py`` builds for its
    payloads, with the card in the pod-level form.  With more than one
    card the module runs through the pod launcher (``workloads.launch``),
    one process a card under torchrun."""
    launch = ["kubernetes1_tpu_torch.workloads.launch", "-m"] if gpus > 1 else []
    command = [sys.executable, "-m", *launch, *argv] + (["--out", out] if out else [])
    pod_spec = {"containers": [{"name": "train", "image": "ktpu/torch-workload",
                                "command": command, "env": [pythonpath_env()]}],
                "restartPolicy": "Never"}
    if gpus:
        gpu_request(pod_spec, gpus)
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"parallelism": 1, "completions": 1, "backoffLimit": 0,
                     "template": {"metadata": {"labels": {"app": name}}, "spec": pod_spec}}}
