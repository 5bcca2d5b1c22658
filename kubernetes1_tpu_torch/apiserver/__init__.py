"""The apiserver: the in-memory store behind the cluster's REST and watch
surface, with the registry's strategies and the admission chain."""

from .admission import AdmissionChain, ResourceV2  # noqa: F401
from .registry import Registry  # noqa: F401
from .server import Master  # noqa: F401
