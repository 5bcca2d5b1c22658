"""A typed layer over the port's ``Client``: objects go in and come out as
the API types (``api/types.py``), encoded and decoded by the port's scheme
(ref: client-go's kubernetes.Clientset; the JAX package's
``client/clientset.py``).

``Clientset(url)`` holds one ``rest.Client``, whose keep-alive connections
and Status errors it shares; ``clientset.pods``, ``clientset.jobs`` and
the others of ``TYPED`` (``resource(plural)`` for any resource of
``rest.RESOURCES``) are
``TypedResource``s with the verbs the scheduler, the controller manager
and the event recorder call, over typed objects: list, get, create,
update, update_status, patch and delete with a grace period.  Besides:
``delete_batch`` (the pods' ``delete:batch``, whose items may carry a
resourceVersion precondition), the binding subresource
(``bind``), the bulk bind
``pods/bindings:batch`` (``bind_batch``), the eviction subresource
(``evict``), and ``informers()``, an ``InformerFactory`` whose caches hold
typed objects.  The JAX clientset's persistent bind stream and its
``pybin1`` bind codec are not here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from .. import api  # registers the API types with the scheme
from ..api import types as t
from ..machinery.scheme import global_scheme
from .errors import ApiError
from .informer import InformerFactory, SharedInformer
from .rest import Client, ResourceClient


# The resources with a typed client: those the port's scheduler,
# controller manager, kubelet and ``ktpu init`` read or write.
TYPED = ("pods", "events", "nodes", "namespaces", "jobs", "replicasets", "deployments",
         "daemonsets", "statefulsets", "cronjobs", "services", "endpoints",
         "poddisruptionbudgets", "serviceaccounts", "secrets", "configmaps",
         "persistentvolumeclaims", "persistentvolumes", "podmetrics", "nodemetrics",
         "podcustommetrics", "certificatesigningrequests", "roles", "clusterroles",
         "rolebindings", "clusterrolebindings")


class TypedResource:
    """One resource's verbs over typed objects."""

    def __init__(self, rc: ResourceClient):
        self.rc = rc

    def _decode(self, data: dict):
        return global_scheme.decode_as(self.rc.resource, data)

    def list(self, namespace: str = "", label_selector: str = "",
             field_selector: str = "") -> Tuple[List[Any], str]:
        """(the typed items, the list's resourceVersion)."""
        items, rv = self.rc.list(namespace, label_selector, field_selector)
        return [self._decode(d) for d in items], rv

    def create(self, obj, namespace: str = ""):
        ns = namespace or obj.metadata.namespace or "default"
        return self._decode(self.rc.create(global_scheme.encode(obj), ns))

    def get(self, name: str, namespace: str = "default"):
        return self._decode(self.rc.get(name, namespace))

    def update(self, obj):
        return self._decode(self.rc.update(global_scheme.encode(obj)))

    def update_status(self, obj):
        """PUT the status subresource: only ``obj.status`` is written."""
        return self._decode(self.rc.update_status(global_scheme.encode(obj)))

    def patch(self, name: str, patch: Dict[str, Any], namespace: str = "default"):
        return self._decode(self.rc.patch(name, patch, namespace))

    def delete(self, name: str, namespace: str = "default",
               grace_seconds: Optional[int] = None) -> dict:
        """The apiserver's answer: the deleted object, or a Status."""
        return self.rc.delete(name, namespace, grace_seconds)


class Clientset:
    def __init__(self, url: str, token: str = "", ca_file: str = "", cert_file: str = "",
                 key_file: str = "", insecure: bool = False):
        self.client = Client(url, token=token, ca_file=ca_file, cert_file=cert_file,
                             key_file=key_file, insecure=insecure)
        self._typed = {plural: TypedResource(self.client.resource(plural)) for plural in TYPED}
        for plural, typed in self._typed.items():
            setattr(self, plural, typed)

    @classmethod
    def from_config(cls, path: str) -> "Clientset":
        """From a ktpu config file (the kubeconfig that ``ktpu init`` and
        ``join`` write): JSON ``{"server", "token"?, "ca"?, "cert"?,
        "key"?}``, the paths relative to the file's directory."""
        with open(path) as f:
            cfg = json.load(f)
        base = os.path.dirname(os.path.abspath(path))

        def rel(p: str) -> str:
            return p if not p or os.path.isabs(p) else os.path.join(base, p)

        return cls(cfg["server"], token=cfg.get("token", ""), ca_file=rel(cfg.get("ca", "")),
                   cert_file=rel(cfg.get("cert", "")), key_file=rel(cfg.get("key", "")))

    def resource(self, plural: str) -> TypedResource:
        """The typed verbs of any resource the client knows (the CLI's
        generic verbs reach beyond ``TYPED``)."""
        if plural not in self._typed:
            self._typed[plural] = TypedResource(self.client.resource(plural))
        return self._typed[plural]

    def informer(self, plural: str, field_selector: str = "") -> SharedInformer:
        """A typed informer of its own over one resource, narrowed by
        ``field_selector`` on the apiserver's side."""
        return SharedInformer(self.client.resource(plural), field_selector=field_selector,
                              decode=lambda obj: global_scheme.decode_as(plural, obj))

    def informers(self) -> InformerFactory:
        """An informer factory whose caches hold typed objects."""
        return InformerFactory(self.client, decode=global_scheme.decode_as)

    def bind(self, namespace: str, pod_name: str, binding: t.Binding) -> dict:
        """POST the binding subresource; the answer is the server's Status."""
        return self.client.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{pod_name}/binding",
            global_scheme.encode(binding))

    def bind_batch(self, namespace: str, bindings: List[t.Binding]) -> list:
        """POST the bindings as one ``pods/bindings:batch`` request, which
        the apiserver commits together.  One outcome a binding, in order:
        None, or the ApiError that sank that binding."""
        data = self.client.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/bindings:batch",
            {"kind": "BindingList", "apiVersion": "v1",
             "items": [global_scheme.encode(b) for b in bindings]})
        return [None if r.get("status") == "Success" else ApiError.from_status(r)
                for r in data.get("results", [])]

    def delete_batch(self, namespace: str, items, grace_seconds: Optional[int] = None) -> list:
        """Delete pods in one ``pods/delete:batch`` call (``rest.Client``'s):
        ``items`` are names or ``{"name", "resourceVersion"?,
        "gracePeriodSeconds"?}``, the resourceVersion a precondition.  One
        outcome an item, in order: None, or the ApiError that sank it."""
        return self.client.delete_batch(namespace, items, grace_seconds=grace_seconds)

    def evict(self, namespace: str, pod_name: str,
              grace_seconds: Optional[int] = None):
        """The eviction subresource: a pod's removal that respects its
        disruption budget.  Raises TooManyRequests (429) when the budget
        is spent."""
        ev = t.Eviction(grace_period_seconds=grace_seconds)
        ev.metadata.name = pod_name
        ev.metadata.namespace = namespace
        return self.client.request(
            "POST", f"/api/v1/namespaces/{namespace}/pods/{pod_name}/eviction",
            global_scheme.encode(ev))

    def close(self):
        self.client.close()
