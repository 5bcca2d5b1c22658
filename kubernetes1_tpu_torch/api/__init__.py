"""The API types the port's control-plane components decode, registered
with the port's scheme under the resource names the apiserver serves."""

from ..machinery.scheme import global_scheme
from . import types as t

_REGISTRY = [
    (t.Pod, "pods"),
    (t.Node, "nodes"),
    (t.Event, "events"),
    (t.PodDisruptionBudget, "poddisruptionbudgets"),
]

for cls, plural in _REGISTRY:
    global_scheme.register(cls, plural)
