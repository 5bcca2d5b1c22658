"""The Service data plane: the userspace proxier (``proxier``), the
rule-table (``rules``) and IPVS (``ipvs``) modes, and the L7
least-inflight balancer with its Endpoints feed (``balancer``); the
same exports as the JAX package's ``proxy``."""

from .balancer import EndpointsBalancerSync, LeastInflightBalancer
from .proxier import Proxier
from .rules import RuleTableProxier

__all__ = ["EndpointsBalancerSync", "LeastInflightBalancer", "Proxier",
           "RuleTableProxier"]
