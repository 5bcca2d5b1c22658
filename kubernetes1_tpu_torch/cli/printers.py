"""Table printers per kind (ref: pkg/printers + pkg/kubectl resource
printers; `kubectl get` column layouts).  The port's copy of the JAX
package's ``cli/printers.py``, over the port's API types: its TPU seam is
ported, so a pod's and a node's cards are the ``nvidia.com/gpu`` ones, in
the GPUS columns."""

from __future__ import annotations

import datetime
import json
from typing import Any, Callable, Dict, List

import yaml

from .. import GPU_RESOURCE
from ..api import types as t


def parse_time(ts: str) -> datetime.datetime:
    return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))


def age(ts: str) -> str:
    if not ts:
        return "<unknown>"
    try:
        delta = datetime.datetime.now(datetime.timezone.utc) - parse_time(ts)
    except ValueError:
        return "<unknown>"
    s = int(delta.total_seconds())
    if s < 0:
        s = 0
    if s < 120:
        return f"{s}s"
    if s < 7200:
        return f"{s // 60}m"
    if s < 172800:
        return f"{s // 3600}h"
    return f"{s // 86400}d"


def _pod_ready(pod: t.Pod) -> str:
    ready = sum(1 for c in pod.status.container_statuses if c.ready)
    return f"{ready}/{len(pod.spec.containers)}"


def _pod_status(pod: t.Pod) -> str:
    if pod.metadata.deletion_timestamp:
        return "Terminating"
    for cs in pod.status.container_statuses:
        if cs.state.waiting and cs.state.waiting.reason:
            return cs.state.waiting.reason
    return pod.status.phase


def _pod_restarts(pod: t.Pod) -> str:
    return str(sum(c.restart_count for c in pod.status.container_statuses))


def _pod_gpus(pod: t.Pod) -> str:
    total = sum(er.quantity for er in pod.spec.extended_resources)
    return str(total) if total else ""


def _node_status(node: t.Node) -> str:
    ready = any(c.type == "Ready" and c.status == "True" for c in node.status.conditions)
    s = "Ready" if ready else "NotReady"
    if node.spec.unschedulable:
        s += ",SchedulingDisabled"
    return s


def _node_gpus(node: t.Node) -> str:
    devs = node.status.extended_resources.get(GPU_RESOURCE, [])
    healthy = sum(1 for d in devs if d.health == t.DEVICE_HEALTHY)
    return f"{healthy}/{len(devs)}" if devs else ""


def _svc_ports(svc: t.Service) -> str:
    return ",".join(
        f"{p.port}:{p.node_port}/{p.protocol}" if p.node_port else f"{p.port}/{p.protocol}"
        for p in svc.spec.ports) or "<none>"


def _job_completions(job: t.Job) -> str:
    comp = job.spec.completions
    if comp is None:
        return f"{job.status.succeeded}/1 of {job.spec.parallelism or 1}"
    return f"{job.status.succeeded}/{comp}"


# kind -> list of (column, fn(obj) -> str)
COLUMNS: Dict[str, List] = {
    "Pod": [
        ("NAME", lambda p: p.metadata.name),
        ("READY", _pod_ready),
        ("STATUS", _pod_status),
        ("RESTARTS", _pod_restarts),
        ("AGE", lambda p: age(p.metadata.creation_timestamp)),
        ("NODE", lambda p: p.spec.node_name or "<none>"),
        ("GPUS", _pod_gpus),
    ],
    "Node": [
        ("NAME", lambda n: n.metadata.name),
        ("STATUS", _node_status),
        ("AGE", lambda n: age(n.metadata.creation_timestamp)),
        ("GPUS(H/T)", _node_gpus),
        ("KUBELET", lambda n: n.status.node_info.kubelet_version or ""),
    ],
    "Deployment": [
        ("NAME", lambda d: d.metadata.name),
        ("READY", lambda d: f"{d.status.ready_replicas}/{d.spec.replicas or 0}"),
        ("UP-TO-DATE", lambda d: str(d.status.updated_replicas)),
        ("AVAILABLE", lambda d: str(d.status.available_replicas)),
        ("AGE", lambda d: age(d.metadata.creation_timestamp)),
    ],
    "ReplicaSet": [
        ("NAME", lambda r: r.metadata.name),
        ("DESIRED", lambda r: str(r.spec.replicas or 0)),
        ("CURRENT", lambda r: str(r.status.replicas)),
        ("READY", lambda r: str(r.status.ready_replicas)),
        ("AGE", lambda r: age(r.metadata.creation_timestamp)),
    ],
    "DaemonSet": [
        ("NAME", lambda d: d.metadata.name),
        ("DESIRED", lambda d: str(d.status.desired_number_scheduled)),
        ("CURRENT", lambda d: str(d.status.current_number_scheduled)),
        ("READY", lambda d: str(d.status.number_ready)),
        ("AGE", lambda d: age(d.metadata.creation_timestamp)),
    ],
    "Job": [
        ("NAME", lambda j: j.metadata.name),
        ("COMPLETIONS", _job_completions),
        ("ACTIVE", lambda j: str(j.status.active)),
        ("AGE", lambda j: age(j.metadata.creation_timestamp)),
    ],
    "Service": [
        ("NAME", lambda s: s.metadata.name),
        ("TYPE", lambda s: s.spec.type),
        ("CLUSTER-IP", lambda s: s.spec.cluster_ip or "<none>"),
        ("PORTS", _svc_ports),
        ("AGE", lambda s: age(s.metadata.creation_timestamp)),
    ],
    "Namespace": [
        ("NAME", lambda n: n.metadata.name),
        ("STATUS", lambda n: n.status.phase),
        ("AGE", lambda n: age(n.metadata.creation_timestamp)),
    ],
    "Event": [
        ("LAST SEEN", lambda e: age(e.last_timestamp or e.metadata.creation_timestamp)),
        ("TYPE", lambda e: e.type),
        ("REASON", lambda e: e.reason),
        ("OBJECT", lambda e: f"{e.involved_object.kind.lower()}/{e.involved_object.name}"),
        ("MESSAGE", lambda e: e.message),
    ],
}

GENERIC = [
    ("NAME", lambda o: o.metadata.name),
    ("AGE", lambda o: age(o.metadata.creation_timestamp)),
]


def print_table(objs: List[Any], out, show_namespace: bool = False):
    if not objs:
        print("No resources found.", file=out)
        return
    kind = getattr(objs[0], "KIND", "")
    cols = list(COLUMNS.get(kind, GENERIC))
    if show_namespace:
        cols.insert(0, ("NAMESPACE", lambda o: o.metadata.namespace))
    rows = [[str(fn(o)) for _, fn in cols] for o in objs]
    widths = [max(len(c[0]), *(len(r[i]) for r in rows)) for i, c in enumerate(cols)]
    print("  ".join(c[0].ljust(w) for (c, w) in zip(cols, widths)).rstrip(), file=out)
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip(), file=out)


def print_objs(objs: List[Any], fmt: str, scheme, out, show_namespace=False):
    if fmt == "json":
        docs = [scheme.encode(o) for o in objs]
        print(json.dumps(docs[0] if len(docs) == 1 else {"items": docs}, indent=2), file=out)
    elif fmt == "yaml":
        docs = [scheme.encode(o) for o in objs]
        print(yaml.safe_dump_all(docs, sort_keys=False).rstrip(), file=out)
    elif fmt == "name":
        for o in objs:
            print(f"{scheme.resource_of[o.KIND]}/{o.metadata.name}", file=out)
    else:
        print_table(objs, out, show_namespace=show_namespace)


def describe(obj: Any, events: List[t.Event], scheme, out):
    data = scheme.encode(obj)
    meta = data.pop("metadata", {})
    print(f"Name:         {meta.get('name')}", file=out)
    if meta.get("namespace"):
        print(f"Namespace:    {meta.get('namespace')}", file=out)
    if meta.get("labels"):
        print(f"Labels:       {meta.get('labels')}", file=out)
    if meta.get("annotations"):
        print(f"Annotations:  {meta.get('annotations')}", file=out)
    print(f"Created:      {meta.get('creationTimestamp')}", file=out)
    for section in ("spec", "status"):
        if section in data:
            print(f"{section.capitalize()}:", file=out)
            body = yaml.safe_dump(data[section], sort_keys=False).rstrip()
            print("\n".join("  " + line for line in body.splitlines()), file=out)
    if events:
        print("Events:", file=out)
        for e in events:
            print(f"  {e.type}\t{e.reason}\t{e.message}", file=out)
