"""ktpu — the kubectl-equivalent CLI (ref: pkg/kubectl/cmd, 60 commands;
the subset that covers daily driving of the cluster).  The port's copy of
the JAX package's ``cli/__init__.py``, over the port's typed clientset.

Usage: python -m kubernetes1_tpu_torch ktpu [--server URL] <command> ...
   or: python -m kubernetes1_tpu_torch.cli [--server URL] <command> ...

Commands: get, describe, apply (3-way), create, delete, scale, cordon,
uncordon, drain, taint, expose, cp, auth can-i, explain, top, rollout,
logs, exec, attach, port-forward, patch, label, annotate, edit, wait,
api-resources, version, cluster-up.

Its TPU seam is ported: ``top`` counts ``nvidia.com/gpu`` cards, and
``cluster-up`` starts the port's ``LocalCluster`` (``--gpus-per-node``;
``--real-gpu`` puts node 0 on the machine's cards and fails without one).
Left out, as the port's apiserver serves every request as the admin over
plain HTTP (ROADMAP item 18): ``init`` and ``join``, the client's
``--kubeconfig``, ``--token``, ``--ca-file``, ``--client-cert-file`` and
``--client-key-file``, and the bearer header on the streams.

Nothing on the path of a verb imports torch: ``cluster-up --real-gpu``
loads only what the device plugin's discovery needs.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

import yaml

from .. import GPU_RESOURCE
from ..api import types as t
from ..client.clientset import Clientset
from ..machinery.errors import ApiError, NotFound, TooManyRequests
from ..machinery.scheme import _camel, global_scheme
from ..utils import streams
from . import printers


def _shq(s: str) -> str:
    import shlex

    return shlex.quote(s)


def _snake_name(camel: str) -> str:
    import re

    return re.sub(r"(?<!^)(?=[A-Z])", "_", camel).lower()


def _unwrap_type(hint):
    """List[X] / Dict[_, X] / Optional[X] -> X (for `explain` descent)."""
    import typing

    origin = typing.get_origin(hint)
    if origin in (list, dict):
        args = typing.get_args(hint)
        return args[-1] if args else None
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return args[0] if args else None
    return hint


def _type_name(hint) -> str:
    if hint is None:
        return "?"
    return getattr(hint, "__name__", None) or str(hint).replace(
        "typing.", "")

DEFAULT_SERVER = "http://127.0.0.1:8001"

ALIASES = {
    "po": "pods", "pod": "pods",
    "no": "nodes", "node": "nodes",
    "ns": "namespaces", "namespace": "namespaces",
    "deploy": "deployments", "deployment": "deployments",
    "rs": "replicasets", "replicaset": "replicasets",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "svc": "services", "service": "services",
    "ep": "endpoints",
    "ev": "events", "event": "events",
    "job": "jobs",
    "sts": "statefulsets", "statefulset": "statefulsets",
    "cj": "cronjobs", "cronjob": "cronjobs",
    "cm": "configmaps", "configmap": "configmaps",
    "pc": "priorityclasses", "priorityclass": "priorityclasses",
}


def resolve_resource(name: str) -> str:
    name = name.lower()
    plural = ALIASES.get(name, name)
    if plural not in global_scheme.by_resource:
        known = ", ".join(sorted(global_scheme.by_resource))
        raise SystemExit(f"error: unknown resource {name!r} (known: {known})")
    return plural


def split_target(args: List[str]):
    """Accept both `kind name` and `kind/name` forms."""
    if len(args) == 1 and "/" in args[0]:
        kind, name = args[0].split("/", 1)
        return resolve_resource(kind), name
    kind = resolve_resource(args[0])
    return kind, (args[1] if len(args) > 1 else "")


def load_manifests(path: str) -> List[dict]:
    raw = sys.stdin.read() if path == "-" else open(path).read()
    if raw.lstrip().startswith("{"):
        doc = json.loads(raw)
        return doc.get("items", [doc]) if isinstance(doc, dict) else doc
    return [d for d in yaml.safe_load_all(raw) if d]


class CLI:
    def __init__(self, server: str, namespace: str, out=None, clientset=None):
        self.cs = clientset or Clientset(server)
        self.ns = namespace
        self.out = out or sys.stdout
        self.scheme = global_scheme

    # ------------------------------------------------------------------ get

    def get(self, args):
        plural = resolve_resource(args.resource)
        client = self.cs.resource(plural)
        show_ns = args.all_namespaces
        if args.name:
            objs = [client.get(args.name, self.ns)]
        else:
            ns = "" if args.all_namespaces or not self.scheme.namespaced[plural] else self.ns
            objs, rv = client.list(namespace=ns, label_selector=args.selector or "")
            if args.watch:
                printers.print_objs(objs, args.output, self.scheme, self.out, show_ns)
                stream = client.rc.watch(namespace=ns, resource_version=rv)
                try:
                    for etype, obj in stream:
                        o = self.scheme.decode_as(plural, obj)
                        print(f"{etype}\t{o.metadata.namespace}/{o.metadata.name}",
                              file=self.out)
                finally:
                    stream.close()
                return
        printers.print_objs(objs, args.output, self.scheme, self.out, show_ns)

    def describe(self, args):
        plural, name = split_target([args.resource] + ([args.name] if args.name else []))
        if not name:
            raise SystemExit("error: describe needs a name")
        obj = self.cs.resource(plural).get(name, self.ns)
        events, _ = self.cs.events.list(namespace=self.ns)
        related = [e for e in events
                   if e.involved_object.name == name
                   and e.involved_object.kind == obj.KIND]
        printers.describe(obj, related, self.scheme, self.out)

    # ---------------------------------------------------------- apply/create

    LAST_APPLIED = "kubectl.kubernetes.io/last-applied-configuration"

    @staticmethod
    def _three_way_patch(last: dict, new: dict) -> dict:
        """3-way apply patch (ref: pkg/kubectl/cmd/apply.go:35-38 +
        last-applied-configuration): re-assert every field the manifest
        specifies, and DELETE (merge-patch null) every field the previous
        apply specified that this manifest dropped.  Server-owned fields
        (status, nodeName, assigned devices) appear in neither manifest
        and therefore survive — the live object is never clobbered
        wholesale."""
        patch: dict = {}
        for k, vnew in new.items():
            vlast = last.get(k) if isinstance(last, dict) else None
            if isinstance(vnew, dict):
                patch[k] = CLI._three_way_patch(
                    vlast if isinstance(vlast, dict) else {}, vnew)
            else:
                patch[k] = vnew
        if isinstance(last, dict):
            for k in last:
                if k not in new:
                    patch[k] = None  # dropped from the manifest: remove live
        return patch

    def _apply_one(self, doc: dict, create_only: bool = False):
        obj = self.scheme.decode(doc)
        plural = self.scheme.resource_of[obj.KIND]
        client = self.cs.resource(plural)
        ns = obj.metadata.namespace or self.ns
        if self.scheme.namespaced[plural]:
            obj.metadata.namespace = ns
        try:
            existing = client.get(obj.metadata.name, ns)
        except NotFound:
            # stamp the applied manifest so the NEXT apply can compute
            # deletions (kubectl's last-applied-configuration annotation)
            if not create_only:
                obj.metadata.annotations = dict(obj.metadata.annotations)
                obj.metadata.annotations[self.LAST_APPLIED] = \
                    json.dumps(doc, sort_keys=True)
            created = client.create(obj)
            print(f"{plural}/{created.metadata.name} created", file=self.out)
            return
        if create_only:
            raise SystemExit(f"error: {plural}/{obj.metadata.name} already exists")
        last = {}
        raw = existing.metadata.annotations.get(self.LAST_APPLIED, "")
        if raw:
            try:
                last = json.loads(raw)
            except ValueError:
                last = {}
        patch = self._three_way_patch(last, doc)
        meta = patch.setdefault("metadata", {})
        ann = meta.get("annotations")
        if not isinstance(ann, dict):
            # the manifest dropped annotations wholesale: null each
            # previously-applied key individually — a bare null would
            # collide with the stamp we are about to add
            prev = (last.get("metadata") or {}).get("annotations") or {}
            ann = {k: None for k in prev}
            meta["annotations"] = ann
        ann[self.LAST_APPLIED] = json.dumps(doc, sort_keys=True)
        updated = client.patch(obj.metadata.name, patch, ns)
        print(f"{plural}/{updated.metadata.name} configured", file=self.out)

    def apply(self, args):
        for doc in load_manifests(args.filename):
            self._apply_one(doc)

    def create(self, args):
        for doc in load_manifests(args.filename):
            self._apply_one(doc, create_only=True)

    def delete(self, args):
        if args.filename:
            for doc in load_manifests(args.filename):
                obj = self.scheme.decode(doc)
                plural = self.scheme.resource_of[obj.KIND]
                ns = obj.metadata.namespace or self.ns
                self.cs.resource(plural).delete(obj.metadata.name, ns,
                                                grace_seconds=args.grace_period)
                print(f"{plural}/{obj.metadata.name} deleted", file=self.out)
            return
        plural, name = split_target([args.resource] + ([args.name] if args.name else []))
        if not name:
            raise SystemExit("error: delete needs a name or -f file")
        self.cs.resource(plural).delete(name, self.ns,
                                        grace_seconds=args.grace_period)
        print(f"{plural}/{name} deleted", file=self.out)

    # ---------------------------------------------------------------- scale

    def scale(self, args):
        plural, name = split_target([args.target])
        client = self.cs.resource(plural)
        # patch, not get+update: controllers write these objects concurrently
        if plural in ("deployments", "replicasets", "statefulsets"):
            client.patch(name, {"spec": {"replicas": args.replicas}}, self.ns)
        elif plural == "jobs":
            client.patch(name, {"spec": {"parallelism": args.replicas}}, self.ns)
        else:
            raise SystemExit(f"error: cannot scale {plural}")
        print(f"{plural}/{name} scaled to {args.replicas}", file=self.out)

    # ----------------------------------------------------------- node admin

    def _set_unschedulable(self, name: str, value: bool):
        # patch, not get+update: the kubelet heartbeat updates the node
        # concurrently and a full replace would 409
        self.cs.nodes.patch(name, {"spec": {"unschedulable": value}}, "")

    def cordon(self, args):
        self._set_unschedulable(args.node, True)
        print(f"node/{args.node} cordoned", file=self.out)

    def uncordon(self, args):
        self._set_unschedulable(args.node, False)
        print(f"node/{args.node} uncordoned", file=self.out)

    def drain(self, args):
        """Cordon + evict through the eviction subresource, so
        PodDisruptionBudgets are honored: pods whose budget is exhausted are
        retried until their peers become healthy elsewhere (ref: kubectl
        drain + eviction.go)."""
        self._set_unschedulable(args.node, True)
        pods, _ = self.cs.pods.list(field_selector=f"spec.nodeName={args.node}")
        pending = []
        for p in pods:
            owners = {o.kind for o in p.metadata.owner_references}
            if "DaemonSet" in owners and not args.force:
                continue
            pending.append(p)
        deadline = time.monotonic() + getattr(args, "timeout", 60)
        blocked: dict = {}
        while pending:
            still = []
            for p in pending:
                try:
                    self.cs.evict(p.metadata.namespace, p.metadata.name,
                                  grace_seconds=0)
                    print(f"pod/{p.metadata.name} evicted", file=self.out)
                except NotFound:
                    continue  # already gone (e.g. its controller was deleted)
                except TooManyRequests as e:
                    still.append(p)
                    blocked[p.metadata.name] = str(e)
            pending = still
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(1.0)  # the re-attempt pace of PDB-blocked evictions, bounded by --timeout
        if pending:
            # every leftover is reported, and the node is NOT declared
            # drained — scripted maintenance must see the failure
            for p in pending:
                print(
                    f"pod/{p.metadata.name} NOT evicted: "
                    f"{blocked.get(p.metadata.name, 'eviction blocked')}",
                    file=self.out,
                )
            print(
                f"node/{args.node} drain INCOMPLETE: {len(pending)} pod(s) "
                f"blocked by disruption budgets",
                file=self.out,
            )
            raise SystemExit(1)
        print(f"node/{args.node} drained", file=self.out)

    def taint(self, args):
        """`ktpu taint [nodes] <node> key=value:Effect ... key:Effect-`
        (ref: kubectl taint + node spec.taints; the toleration admission
        and scheduler predicates consume these)."""
        targets = list(args.targets)
        if targets and targets[0] in ("nodes", "node", "no"):
            targets = targets[1:]
        if len(targets) < 2:
            raise SystemExit("error: taint needs <node> and >=1 taint spec")
        args.node, args.taints = targets[0], targets[1:]
        node = self.cs.nodes.get(args.node, "")
        taints = list(node.spec.taints)
        changed = []
        for spec in args.taints:
            if spec.endswith("-"):
                spec = spec[:-1]
                key, _, effect = spec.partition(":")
                key = key.split("=", 1)[0]
                before = len(taints)
                taints = [tn for tn in taints
                          if not (tn.key == key
                                  and (not effect or tn.effect == effect))]
                if len(taints) == before:
                    raise SystemExit(
                        f"error: taint {key!r} not found on node {args.node}")
                changed.append(f"{key} removed")
                continue
            kv, _, effect = spec.rpartition(":")
            if not effect or effect not in (
                    "NoSchedule", "PreferNoSchedule", "NoExecute"):
                raise SystemExit(
                    f"error: taint {spec!r} needs key[=value]:Effect with "
                    f"Effect one of NoSchedule|PreferNoSchedule|NoExecute")
            key, _, value = kv.partition("=")
            existing = next((tn for tn in taints
                             if tn.key == key and tn.effect == effect), None)
            if existing is not None:
                if not getattr(args, "overwrite", False):
                    raise SystemExit(
                        f"error: node {args.node} already has taint "
                        f"{key}:{effect}; use --overwrite")
                existing.value = value
            else:
                taints.append(t.Taint(key=key, value=value, effect=effect))
            changed.append(f"{key}:{effect}")
        self.cs.nodes.patch(
            args.node,
            {"spec": {"taints": [
                {"key": tn.key, "value": tn.value, "effect": tn.effect}
                for tn in taints]}}, "")
        print(f"node/{args.node} tainted ({', '.join(changed)})",
              file=self.out)

    # ---------------------------------------------------------------- expose

    def expose(self, args):
        """`ktpu expose <resource> <name> --port N` — create a Service
        selecting the workload's pods (ref: kubectl expose)."""
        plural, name = split_target(
            [args.resource] + ([args.name] if args.name else []))
        if not name:
            raise SystemExit("error: expose needs <resource> <name>")
        obj = self.cs.resource(plural).get(name, self.ns)
        if plural in ("deployments", "replicasets", "statefulsets",
                      "daemonsets", "jobs"):
            selector = dict(obj.spec.selector.match_labels or {}) \
                if obj.spec.selector else {}
            if not selector:
                selector = dict(
                    obj.spec.template.metadata.labels or {})
        elif plural == "pods":
            selector = dict(obj.metadata.labels or {})
        elif plural == "services":
            selector = dict(obj.spec.selector or {})
        else:
            raise SystemExit(f"error: cannot expose {plural}")
        if not selector:
            raise SystemExit(
                f"error: {plural}/{name} has no labels/selector to select by")
        svc = t.Service()
        svc.metadata.name = args.name_out or name
        svc.metadata.namespace = self.ns
        svc.spec.selector = selector
        svc.spec.type = args.type
        svc.spec.ports = [t.ServicePort(
            port=args.port,
            target_port=args.target_port or args.port,
            protocol=args.protocol)]
        created = self.cs.services.create(svc, self.ns)
        print(f"service/{created.metadata.name} exposed "
              f"(port {args.port} -> {args.target_port or args.port}, "
              f"selector {selector})", file=self.out)

    # -------------------------------------------------------------------- cp

    def cp(self, args):
        """`ktpu cp <pod>:<path> <local>` / `ktpu cp <local> <pod>:<path>`
        — file copy THROUGH the exec stream (ref: kubectl cp, which runs
        tar over exec; a single file needs only cat)."""
        src, dst = args.src, args.dst

        def parse(spec):
            if ":" in spec and "/" != spec[0]:
                pod, _, path = spec.partition(":")
                return pod, path
            return None, spec

        src_pod, src_path = parse(src)
        dst_pod, dst_path = parse(dst)
        if (src_pod is None) == (dst_pod is None):
            raise SystemExit(
                "error: exactly one of src/dst must be pod:path")
        if src_pod is not None:
            # pod -> local: cat the remote file, stream stdout to a TEMP
            # file — a failed copy must leave any pre-existing destination
            # untouched (no truncate-then-delete of the user's file)
            tmp = dst_path + ".ktpu-cp-tmp"
            sock = self._exec_sock(
                src_pod, ["sh", "-c", f"cat {_shq(src_path)}"],
                container=args.container)
            try:
                with open(tmp, "wb") as out:
                    code = self._pump_stream(sock, out_stream=out)
                if code:
                    raise SystemExit(code)
                os.replace(tmp, dst_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            print(f"{src} -> {dst_path}", file=self.out)
        else:
            # local -> pod: stream the file into `cat > path` via stdin
            with open(src_path, "rb") as f:
                sock = self._exec_sock(
                    dst_pod, ["sh", "-c", f"cat > {_shq(dst_path)}"],
                    container=args.container, stdin=True)
                code = self._pump_stream(sock, stdin=True, stdin_stream=f)
            if code:
                raise SystemExit(code)
            print(f"{src_path} -> {dst}", file=self.out)

    # ------------------------------------------------------------------ auth

    def auth(self, args):
        """`ktpu auth can-i <verb> <resource> [<name>]` — wraps
        SelfSubjectAccessReview (ref: kubectl auth can-i)."""
        if args.subcmd != "can-i":
            raise SystemExit(f"error: unknown auth subcommand {args.subcmd}")
        # resolve aliases/singulars to the registered plural (RBAC rules
        # name plurals), and send a namespace only for namespaced
        # resources — the real request for a cluster-scoped resource is
        # authorized with ns="" and the answer must match it
        plural = resolve_resource(args.resource)
        namespaced = self.scheme.namespaced.get(plural, True)
        body = {
            "kind": "SelfSubjectAccessReview",
            "apiVersion": "authorization.k8s.io/v1",
            "spec": {"resourceAttributes": {
                "verb": args.verb,
                "resource": plural,
                "namespace": self.ns if namespaced else "",
                "name": args.name or "",
            }},
        }
        resp = self.cs.client.request(
            "POST", "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
            body=body)
        allowed = bool((resp.get("status") or {}).get("allowed"))
        print("yes" if allowed else "no", file=self.out)
        if not allowed:
            raise SystemExit(1)

    # --------------------------------------------------------------- explain

    def explain(self, args):
        """`ktpu explain <resource>[.path.to.field]` — field documentation
        straight from the API types (ref: kubectl explain / OpenAPI)."""
        import dataclasses
        import typing

        dotted = args.resource.split(".")
        plural, rest = dotted[0], dotted[1:]
        plural_l = ALIASES.get(plural.lower(), plural.lower())
        cls = None
        for k, c in self.scheme.by_kind.items():
            if self.scheme.resource_of.get(k, "").lower() == plural_l \
                    or k.lower() == plural_l:
                cls = c
                break
        if cls is None:
            raise SystemExit(f"error: unknown resource {plural!r}")
        path = [getattr(cls, "KIND", cls.__name__)]
        for seg in rest:
            hints = typing.get_type_hints(cls)
            fname = _snake_name(seg)
            if fname not in hints:
                raise SystemExit(
                    f"error: field {seg!r} not in {cls.__name__}")
            nxt = _unwrap_type(hints[fname])
            path.append(seg)
            if nxt is None or not dataclasses.is_dataclass(nxt):
                print(f"FIELD: {'.'.join(path)} "
                      f"<{_type_name(hints[fname])}>", file=self.out)
                return
            cls = nxt
        print(f"KIND:     {path[0]}", file=self.out)
        if len(path) > 1:
            print(f"FIELD:    {'.'.join(path[1:])} <{cls.__name__}>",
                  file=self.out)
        if cls.__doc__:
            print(f"\nDESCRIPTION:\n  {cls.__doc__.strip()}", file=self.out)
        print("\nFIELDS:", file=self.out)
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            print(f"  {_camel(f.name)} \t"
                  f"<{_type_name(hints.get(f.name))}>", file=self.out)

    # ------------------------------------------------------------------ top

    def top(self, args):
        """The cards in use against each node's (``nvidia.com/gpu``), or
        each pod's cards."""
        if args.what == "nodes":
            nodes, _ = self.cs.nodes.list()
            pods, _ = self.cs.pods.list()
            used: dict = {}
            for p in pods:
                if p.status.phase in (t.POD_SUCCEEDED, t.POD_FAILED):
                    continue
                n = used.setdefault(p.spec.node_name, 0)
                used[p.spec.node_name] = n + sum(
                    len(er.assigned) or er.quantity for er in p.spec.extended_resources)
            rows = []
            for n in nodes:
                devs = n.status.extended_resources.get(GPU_RESOURCE, [])
                rows.append((n.metadata.name, used.get(n.metadata.name, 0), len(devs)))
            print("NODE            GPU-USED  GPU-TOTAL  UTIL%", file=self.out)
            for name, u, total in rows:
                pct = f"{100 * u / total:.0f}" if total else "-"
                print(f"{name:<15} {u:<9} {total:<10} {pct}", file=self.out)
        else:
            pods, _ = self.cs.pods.list(namespace=self.ns)
            print("POD             PHASE      GPUS", file=self.out)
            for p in pods:
                cards = sum(len(er.assigned) or er.quantity
                            for er in p.spec.extended_resources)
                print(f"{p.metadata.name:<15} {p.status.phase:<10} {cards}", file=self.out)

    # -------------------------------------------------------------- rollout

    def rollout(self, args):
        plural, name = split_target([args.target])
        if plural != "deployments":
            raise SystemExit("error: rollout supports deployments")
        if args.action == "status":
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                d = self.cs.deployments.get(name, self.ns)
                want = d.spec.replicas or 0
                if (d.status.observed_generation >= d.metadata.generation
                        and d.status.updated_replicas == want
                        and d.status.available_replicas == want
                        and d.status.replicas == want):  # old-RS pods gone too
                    print(f'deployment "{name}" successfully rolled out', file=self.out)
                    return
                time.sleep(0.3)
            raise SystemExit(f'error: deployment "{name}" rollout timed out')
        if args.action == "restart":
            stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
            self.cs.deployments.patch(name, {"spec": {"template": {"metadata": {
                "annotations": {"ktpu.io/restartedAt": stamp}}}}}, self.ns)
            print(f"deployment/{name} restarted", file=self.out)
            return
        if args.action == "history":
            for rev, rs in self._revisions(name):
                cause = (rs.spec.template.metadata.annotations or {}).get(
                    "ktpu.io/change-cause", "<none>")
                print(f"{rev}\t{cause}", file=self.out)
            return
        if args.action == "undo":
            # an unstamped RS (rev 0: controller hasn't caught up) is the
            # NEWEST template, not a missing one — order it last so the
            # default "previous" target stays correct, but never offer it
            # as a rollback target itself
            all_revs = self._revisions(name)
            if not all_revs:
                raise SystemExit(f"error: no rollout history for {name}")
            ordered = sorted(
                all_revs,
                key=lambda p: (p[0] if p[0] > 0 else float("inf"),
                               p[1].metadata.creation_timestamp))
            stamped = [(rev, rs) for rev, rs in ordered if rev > 0]
            if args.to_revision:
                match = [rs for rev, rs in stamped
                         if rev == args.to_revision]
                if not match:
                    raise SystemExit(
                        f"error: revision {args.to_revision} not found")
                target = match[0]
            else:
                candidates = [rs for rev, rs in ordered[:-1] if rev > 0]
                if not candidates:
                    raise SystemExit("error: no previous revision to roll "
                                     "back to")
                target = candidates[-1]  # newest stamped below current
            # rollback = wholesale template REPLACE (kubectl semantics: a
            # merge patch would leave post-target keys behind), via
            # read-modify-write with conflict retry
            from ..client.errors import retry_on_conflict
            from ..controllers.deployment import template_hash
            from ..machinery.scheme import from_dict, to_dict

            tmpl_doc = to_dict(target.spec.template)
            labels = (tmpl_doc.get("metadata") or {}).get("labels") or {}
            labels.pop("pod-template-hash", None)
            new_tmpl = from_dict(t.PodTemplateSpec, tmpl_doc)

            outcome = {}

            def attempt():
                dep = self.cs.deployments.get(name, self.ns)
                if template_hash(dep.spec.template) == template_hash(new_tmpl):
                    outcome["skipped"] = True
                    return
                dep.spec.template = new_tmpl
                self.cs.deployments.update(dep)

            retry_on_conflict(attempt)
            if outcome.get("skipped"):
                print(f"deployment/{name} skipped rollback (current "
                      f"template already matches)", file=self.out)
            else:
                print(f"deployment/{name} rolled back", file=self.out)
            return
        raise SystemExit(f"error: unknown rollout action {args.action!r}")

    def _revisions(self, name):
        """Owned ReplicaSets sorted by revision annotation (rollout
        history's data source)."""
        dep = self.cs.deployments.get(name, self.ns)
        rsets, _ = self.cs.replicasets.list(namespace=self.ns)
        owned = [rs for rs in rsets
                 if any(ref.uid == dep.metadata.uid
                        for ref in rs.metadata.owner_references)]
        from ..controllers.deployment import revision_of

        return sorted(((revision_of(rs), rs) for rs in owned),
                      key=lambda p: p[0])

    # ------------------------------------------- patch / label / annotate

    def patch(self, args):
        """`ktpu patch <resource> <name> -p '<json>'` — RFC 7386 merge
        patch through the server's patch+admission path (kubectl patch)."""
        plural = resolve_resource(args.resource)
        try:
            body = json.loads(args.patch)
        except json.JSONDecodeError as e:
            raise SystemExit(f"error: -p is not valid JSON: {e}")
        ns = self.ns if self.scheme.namespaced[plural] else ""
        obj = self.cs.resource(plural).patch(args.name, body, ns)
        print(f"{plural}/{obj.metadata.name} patched", file=self.out)

    def _meta_kv_patch(self, args, field: str):
        plural = resolve_resource(args.resource)
        ns = self.ns if self.scheme.namespaced[plural] else ""
        client = self.cs.resource(plural)
        obj = client.get(args.name, ns)
        current = dict(getattr(obj.metadata, field) or {})
        changes = {}
        for pair in args.pairs:
            if pair.endswith("-") and "=" not in pair:
                changes[pair[:-1]] = None  # merge-patch null deletes
                continue
            if "=" not in pair:
                raise SystemExit(f"error: {pair!r} is not key=value or key-")
            k, v = pair.split("=", 1)
            if k in current and current[k] != v and not args.overwrite:
                raise SystemExit(
                    f"error: {field[:-1]} {k!r} already set to "
                    f"{current[k]!r}; use --overwrite")
            changes[k] = v
        patched = client.patch(args.name, {"metadata": {field: changes}}, ns)
        verb = "labeled" if field == "labels" else "annotated"
        print(f"{plural}/{patched.metadata.name} {verb}", file=self.out)

    def label(self, args):
        self._meta_kv_patch(args, "labels")

    def annotate(self, args):
        self._meta_kv_patch(args, "annotations")

    def edit(self, args):
        """`ktpu edit <resource> <name>` — fetch, open $EDITOR on the YAML,
        PUT the result back (kubectl edit; replace-on-save semantics)."""
        import subprocess
        import tempfile

        plural = resolve_resource(args.resource)
        ns = self.ns if self.scheme.namespaced[plural] else ""
        client = self.cs.resource(plural)
        obj = client.get(args.name, ns)
        doc = self.scheme.encode(obj)
        with tempfile.NamedTemporaryFile("w+", suffix=".yaml",
                                         delete=False) as f:
            yaml.safe_dump(doc, f, sort_keys=False)
            path = f.name
        try:
            import shlex

            # EDITOR may carry arguments ("code --wait"): shell-split like
            # kubectl/git do
            editor = shlex.split(os.environ.get("EDITOR", "vi"))
            subprocess.run(editor + [path], check=True)
            with open(path) as f:
                edited = yaml.safe_load(f)
            if edited == doc:
                print("no changes", file=self.out)
            else:
                updated = client.update(self.scheme.decode(edited))
                print(f"{plural}/{updated.metadata.name} edited", file=self.out)
        except Exception as e:  # noqa: BLE001
            # NEVER discard the user's edits: keep the file and say where
            print(f"error: {e}\nedits preserved in {path}", file=sys.stderr)
            raise SystemExit(1)
        os.unlink(path)

    def attach(self, args):
        """`ktpu attach <pod>` — live stream of the running container's
        output through the apiserver pods/attach subresource (honest for a
        process runtime: attach to stdout, no terminal takeover)."""
        from urllib.parse import urlencode

        pod = self.cs.pods.get(args.pod, self.ns)
        if not pod.spec.node_name:
            raise SystemExit("error: pod not scheduled yet")
        params = [("container", args.container or pod.spec.containers[0].name)]
        sock = streams.upgrade_request(
            self.cs.client.host, self.cs.client.port,
            f"/api/v1/namespaces/{self.ns}/pods/{args.pod}/attach?" + urlencode(params), {})
        code = self._pump_stream(sock)
        if code:
            raise SystemExit(code)

    def logs(self, args):
        """GET pods/<name>/log through the apiserver (ref: kubectl logs →
        registry/core/pod/rest/log.go; the kubelet credential stays between
        apiserver and kubelet)."""
        from urllib.parse import urlencode

        pod = self.cs.pods.get(args.pod, self.ns)
        params = {"container": args.container or pod.spec.containers[0].name}
        if getattr(args, "tail", 0):
            params["tailLines"] = str(args.tail)
        data = self.cs.client.request(
            "GET", f"/api/v1/namespaces/{self.ns}/pods/{args.pod}/log?{urlencode(params)}",
            raw=True)
        self.out.write(data.decode(errors="replace"))

    def _exec_sock(self, pod_name: str, command, container: str = "",
                   stdin: bool = False, tty: bool = False):
        """Dial the pods/exec subresource and return the upgraded stream
        socket (the one transport exec_ and cp share)."""
        from urllib.parse import urlencode

        pod = self.cs.pods.get(pod_name, self.ns)
        if not pod.spec.node_name:
            raise SystemExit("error: pod not scheduled yet")
        params = [("container", container or pod.spec.containers[0].name)]
        params += [("command", c) for c in command]
        if tty:
            params.append(("tty", "1"))
        if stdin:
            params.append(("stdin", "1"))
        return streams.upgrade_request(
            self.cs.client.host, self.cs.client.port,
            f"/api/v1/namespaces/{self.ns}/pods/{pod_name}/exec?{urlencode(params)}", {})

    def exec_(self, args):
        """Streaming exec via the apiserver pods/exec subresource —
        bidirectional, interactive with -i/-t (ref: kubectl exec +
        client-go/tools/remotecommand)."""
        tty = bool(getattr(args, "tty", False))
        stdin = bool(getattr(args, "stdin", False))
        sock = self._exec_sock(args.pod, args.command, container=args.container,
                               stdin=stdin, tty=tty)
        code = self._pump_stream(sock, tty=tty, stdin=stdin,
                                 stdin_stream=getattr(args, "stdin_stream", None))
        if code:
            raise SystemExit(code)

    def _pump_stream(self, sock, tty=False, stdin=False, stdin_stream=None,
                     out_stream=None) -> int:
        """Frame pump for an exec/attach stream.  out_stream=None renders
        text to self.out (interactive exec); a binary out_stream receives
        raw STDOUT payloads (cp's transport) with STDERR still rendered."""
        import threading

        status = {"exitCode": 0}
        if stdin:
            src = stdin_stream or getattr(sys.stdin, "buffer", sys.stdin)
            if tty and sys.stdin.isatty():
                import atexit
                import termios
                import tty as _tty

                old = termios.tcgetattr(sys.stdin.fileno())
                _tty.setraw(sys.stdin.fileno())
                atexit.register(termios.tcsetattr, sys.stdin.fileno(), termios.TCSADRAIN, old)

            def feed():
                try:
                    while True:
                        if tty:
                            data = src.read(1)
                        elif hasattr(src, "read1"):
                            data = src.read1(64 * 1024)
                        else:
                            data = src.readline()
                        if not data:
                            streams.write_frame(sock, streams.STDIN, b"")  # EOF
                            break
                        if isinstance(data, str):
                            data = data.encode()
                        streams.write_frame(sock, streams.STDIN, data)
                except (OSError, ValueError):
                    pass

            threading.Thread(target=feed, daemon=True).start()
        try:
            while True:
                frame = streams.read_frame(sock)
                if frame is None:
                    break
                ch, payload = frame
                if ch == streams.STDOUT and out_stream is not None:
                    out_stream.write(payload)
                elif ch in (streams.STDOUT, streams.STDERR):
                    self.out.write(payload.decode(errors="replace"))
                    try:
                        self.out.flush()
                    except (OSError, ValueError):
                        pass
                elif ch == streams.ERROR:
                    try:
                        status = json.loads(payload or b"{}")
                    except ValueError:
                        pass
                    break
        finally:
            sock.close()
        if status.get("error"):
            print(f"error: {status['error']}", file=self.out)
        return int(status.get("exitCode", 0) or 0)

    def port_forward(self, args):
        """Local TCP listener relaying each connection through the
        apiserver's pods/portForward subresource (ref: kubectl
        port-forward)."""
        import socket
        import threading

        local, _, remote = args.ports.partition(":")
        remote = remote or local
        try:
            local, remote = int(local), int(remote)
        except ValueError:
            raise SystemExit(
                f"error: ports must be numeric LOCAL:REMOTE, got {args.ports!r}")
        pod = self.cs.pods.get(args.pod, self.ns)
        if not pod.spec.node_name:
            raise SystemExit("error: pod not scheduled yet")
        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", int(local)))
        listener.listen(8)
        bound_port = listener.getsockname()[1]
        print(f"Forwarding from 127.0.0.1:{bound_port} -> {remote}", file=self.out)
        try:
            self.out.flush()
        except (OSError, ValueError):
            pass

        def serve(conn):
            try:
                upstream = streams.upgrade_request(
                    self.cs.client.host, self.cs.client.port,
                    f"/api/v1/namespaces/{self.ns}/pods/{args.pod}/portForward?port={remote}",
                    {})
            except OSError:  # UpgradeRefused is a ConnectionError
                conn.close()
                return
            try:
                streams.splice(conn, upstream)
            finally:
                conn.close()
                upstream.close()

        self._pf_listener = listener  # tests close this to stop
        count = getattr(args, "connections", 0)  # 0 = forever
        served = 0
        while True:
            try:
                conn, _addr = listener.accept()
            except OSError:
                break
            threading.Thread(target=serve, args=(conn,), daemon=True).start()
            served += 1
            if count and served >= count:
                break

    # ----------------------------------------------------------------- wait

    def wait(self, args):
        plural, name = split_target([args.target])
        cond = args.condition.removeprefix("condition=").lower()
        deadline = time.monotonic() + args.timeout
        client = self.cs.resource(plural)
        while time.monotonic() < deadline:
            try:
                obj = client.get(name, self.ns)
            except NotFound:
                if cond == "delete":
                    print(f"{plural}/{name} condition met", file=self.out)
                    return
                time.sleep(0.3)  # the condition's poll, bounded by --timeout
                continue
            ok = False
            if cond == "ready" and obj.KIND == "Pod":
                ok = any(c.type == "Ready" and c.status == "True"
                         for c in obj.status.conditions)
            elif cond == "complete" and obj.KIND == "Job":
                ok = any(c.type == "Complete" and c.status == "True"
                         for c in obj.status.conditions)
            elif cond.startswith("phase="):
                ok = obj.status.phase.lower() == cond.split("=", 1)[1]
            if ok:
                print(f"{plural}/{name} condition met", file=self.out)
                return
            time.sleep(0.3)
        raise SystemExit(f"error: timed out waiting for {args.condition} on {plural}/{name}")

    # ------------------------------------------------------------- misc

    def api_resources(self, args):
        print("NAME                 NAMESPACED  KIND", file=self.out)
        for plural, cls in sorted(global_scheme.by_resource.items()):
            print(f"{plural:<20} {str(global_scheme.namespaced[plural]):<11} {cls.KIND}",
                  file=self.out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ktpu", description=__doc__)
    p.add_argument("--server", "-s", default=None,
                   help=f"apiserver URL (default $KTPU_SERVER or {DEFAULT_SERVER})")
    p.add_argument("--namespace", "-n", default="default")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?", default="")
    g.add_argument("-o", "--output", default="table",
                   choices=["table", "json", "yaml", "name", "wide"])
    g.add_argument("-l", "--selector", default="")
    g.add_argument("-A", "--all-namespaces", action="store_true")
    g.add_argument("-w", "--watch", action="store_true")

    d = sub.add_parser("describe")
    d.add_argument("resource")
    d.add_argument("name", nargs="?", default="")

    for verb in ("apply", "create"):
        a = sub.add_parser(verb)
        a.add_argument("-f", "--filename", required=True)

    de = sub.add_parser("delete")
    de.add_argument("resource", nargs="?", default="")
    de.add_argument("name", nargs="?", default="")
    de.add_argument("-f", "--filename", default="")
    de.add_argument("--grace-period", type=int, default=None)

    sc = sub.add_parser("scale")
    sc.add_argument("target")
    sc.add_argument("--replicas", type=int, required=True)

    for verb in ("cordon", "uncordon", "drain"):
        c = sub.add_parser(verb)
        c.add_argument("node")
        if verb == "drain":
            c.add_argument("--force", action="store_true")
            c.add_argument("--timeout", type=int, default=60,
                           help="seconds to keep retrying PDB-blocked evictions")

    tn = sub.add_parser("taint")
    tn.add_argument("targets", nargs="+",
                    help="[nodes] <node> key=value:Effect... "
                         "(key[:Effect]- removes)")
    tn.add_argument("--overwrite", action="store_true")

    ex = sub.add_parser("expose")
    ex.add_argument("resource")
    ex.add_argument("name", nargs="?", default="")
    ex.add_argument("--port", type=int, required=True)
    ex.add_argument("--target-port", type=int, default=0)
    ex.add_argument("--protocol", default="TCP")
    ex.add_argument("--type", default="ClusterIP",
                    choices=["ClusterIP", "NodePort"])
    ex.add_argument("--name", dest="name_out", default="",
                    help="service name (defaults to the workload's)")

    cp = sub.add_parser("cp")
    cp.add_argument("src", help="pod:path or local path")
    cp.add_argument("dst", help="pod:path or local path")
    cp.add_argument("-c", "--container", default="")

    au = sub.add_parser("auth")
    au.add_argument("subcmd", choices=["can-i"])
    au.add_argument("verb")
    au.add_argument("resource")
    au.add_argument("name", nargs="?", default="")

    xp = sub.add_parser("explain")
    xp.add_argument("resource", help="resource[.field.path]")

    tp = sub.add_parser("top")
    tp.add_argument("what", choices=["nodes", "pods"])

    pa = sub.add_parser("patch")
    pa.add_argument("resource")
    pa.add_argument("name")
    pa.add_argument("-p", "--patch", required=True,
                    help="JSON merge patch (RFC 7386)")

    for verb in ("label", "annotate"):
        lb = sub.add_parser(verb)
        lb.add_argument("resource")
        lb.add_argument("name")
        lb.add_argument("pairs", nargs="+",
                        help="key=value to set, key- to remove")
        lb.add_argument("--overwrite", action="store_true")

    ed = sub.add_parser("edit")
    ed.add_argument("resource")
    ed.add_argument("name")

    at = sub.add_parser("attach")
    at.add_argument("pod")
    at.add_argument("-c", "--container", default="")

    ro = sub.add_parser("rollout")
    ro.add_argument("action", choices=["status", "restart", "history", "undo"])
    ro.add_argument("target")
    ro.add_argument("--timeout", type=float, default=60)
    ro.add_argument("--to-revision", type=int, default=0,
                    help="undo: target revision (default: previous)")

    lg = sub.add_parser("logs")
    lg.add_argument("pod")
    lg.add_argument("-c", "--container", default="")
    lg.add_argument("--tail", type=int, default=0)

    ex = sub.add_parser("exec")
    ex.add_argument("pod")
    ex.add_argument("-c", "--container", default="")
    ex.add_argument("-i", "--stdin", action="store_true")
    ex.add_argument("-t", "--tty", action="store_true")
    ex.add_argument("command", nargs="+")

    pf = sub.add_parser("port-forward")
    pf.add_argument("pod")
    pf.add_argument("ports", help="LOCAL:REMOTE (or PORT for both)")

    w = sub.add_parser("wait")
    w.add_argument("target")
    w.add_argument("--for", dest="condition", required=True)
    w.add_argument("--timeout", type=float, default=60)

    sub.add_parser("api-resources")
    sub.add_parser("version")

    cu = sub.add_parser("cluster-up")
    cu.add_argument("--nodes", type=int, default=1)
    cu.add_argument("--gpus-per-node", type=int, default=4,
                    help="fake H100s on each node but a --real-gpu node 0")
    cu.add_argument("--port", type=int, default=8001)
    cu.add_argument("--hollow", action="store_true",
                    help="FakeRuntime nodes (default: real process runtime)")
    cu.add_argument("--real-gpu", action="store_true",
                    help="node 0 advertises the machine's real cards (fails without one)")
    return p


def cluster_up(args) -> int:
    """Run the port's LocalCluster in this process until SIGINT or SIGTERM;
    then stop it, with no pod process left (exit 1 if one survived)."""
    from ..localcluster import LocalCluster

    stop = []
    signal.signal(signal.SIGINT, lambda *a: stop.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
    cluster = LocalCluster(nodes=args.nodes, gpus_per_node=args.gpus_per_node,
                           hollow=args.hollow, real_gpu=args.real_gpu, port=args.port)
    cluster.start()
    if args.real_gpu and cluster.nodes[0].plugin is None:
        cluster.stop()
        print("error: --real-gpu: this machine has no NVIDIA card to put on node-0",
              file=sys.stderr)
        return 1
    print(f"cluster up: apiserver {cluster.url}", flush=True)
    print(f"  python -m kubernetes1_tpu_torch ktpu --server {cluster.url} get nodes", flush=True)
    while not stop:
        time.sleep(0.5)
    survivors = cluster.stop()
    if survivors:
        print(f"error: pod processes {survivors} survived the cluster's stop", file=sys.stderr)
        return 1
    print("cluster down", flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "version":
        print("ktpu v0.1 (kubernetes1_tpu_torch)")
        return 0
    if args.cmd == "cluster-up":
        return cluster_up(args)
    server = args.server or os.environ.get("KTPU_SERVER", DEFAULT_SERVER)
    cli = CLI(server, args.namespace)
    try:
        dispatch(cli, args)
        return 0
    except (ApiError, OSError) as e:
        # OSError: the apiserver unreachable, or a stream it or the kubelet
        # refused (streams.UpgradeRefused); the JAX CLI dies with a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        cli.cs.close()


def dispatch(cli: CLI, args) -> None:
    handler = {
        "get": cli.get, "describe": cli.describe, "apply": cli.apply,
        "create": cli.create, "delete": cli.delete, "scale": cli.scale,
        "cordon": cli.cordon, "uncordon": cli.uncordon, "drain": cli.drain,
        "top": cli.top, "rollout": cli.rollout, "logs": cli.logs,
        "exec": cli.exec_, "port-forward": cli.port_forward,
        "wait": cli.wait, "api-resources": cli.api_resources,
        "patch": cli.patch, "label": cli.label, "annotate": cli.annotate,
        "edit": cli.edit, "attach": cli.attach, "taint": cli.taint,
        "expose": cli.expose, "cp": cli.cp, "auth": cli.auth,
        "explain": cli.explain,
    }[args.cmd]
    handler(args)
