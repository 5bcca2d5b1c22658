"""The node-local cluster DNS that the port's kubelet starts (``server.py``)."""

from .server import ClusterDNS, encode_query, parse_response  # noqa: F401
