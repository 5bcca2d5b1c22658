"""Fit predicates (ref: plugin/pkg/scheduler/algorithm/predicates/
predicates.go — PodFitsResources:630, GeneralPredicates:965, node selector,
taints, host ports; defaults registered in algorithmprovider/defaults).
The port's copy of the JAX package's ``scheduler/predicates.py``; its
device-derived topology key is a node's NVLink domain.

Each predicate returns (fits: bool, reason: str).  Device fit is separate
(devices.allocate_for_pod) because it also produces the assignment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..machinery import labels as labelutil
from .cache import NodeInfo, pod_request_memory, pod_request_milli_cpu


def pod_fits_resources(pod: t.Pod, ni: NodeInfo) -> Tuple[bool, str]:
    if len(ni.pods) + 1 > ni.allocatable_pods:
        return False, f"too many pods ({len(ni.pods)}/{ni.allocatable_pods})"
    cpu = pod_request_milli_cpu(pod)
    if cpu and ni.requested_milli_cpu + cpu > ni.allocatable_milli_cpu:
        return False, (
            f"insufficient cpu (requested {ni.requested_milli_cpu}m + {cpu}m > "
            f"allocatable {ni.allocatable_milli_cpu}m)"
        )
    mem = pod_request_memory(pod)
    if mem and ni.requested_memory + mem > ni.allocatable_memory:
        return False, "insufficient memory"
    return True, ""


def pod_matches_node_selector(pod: t.Pod, ni: NodeInfo) -> Tuple[bool, str]:
    node = ni.node
    if node is None:
        return False, "node unknown"
    if pod.spec.node_selector and not labelutil.match_labels(
        pod.spec.node_selector, node.metadata.labels
    ):
        return False, "node selector mismatch"
    aff = pod.spec.affinity
    if aff and aff.node_affinity_required:
        # terms are ORed; expressions within a term ANDed
        for term in aff.node_affinity_required:
            if _term_matches(term, node.metadata.labels):
                break
        else:
            return False, "node affinity mismatch"
    return True, ""


def _term_matches(term: t.NodeAffinityTerm, node_labels) -> bool:
    for expr in term.match_expressions:
        val = node_labels.get(expr.key)
        if expr.operator == "In":
            if val not in expr.values:
                return False
        elif expr.operator == "NotIn":
            if val is not None and val in expr.values:
                return False
        elif expr.operator == "Exists":
            if val is None:
                return False
        elif expr.operator == "DoesNotExist":
            if val is not None:
                return False
        elif expr.operator in ("Gt", "Lt"):
            if val is None:
                return False
            try:
                have, want = float(val), float(expr.values[0])
            except (ValueError, IndexError):
                return False
            if expr.operator == "Gt" and not have > want:
                return False
            if expr.operator == "Lt" and not have < want:
                return False
        else:
            return False
    return True


def pod_tolerates_node_taints(pod: t.Pod, ni: NodeInfo) -> Tuple[bool, str]:
    node = ni.node
    if node is None:
        return False, "node unknown"
    for taint in node.spec.taints:
        if taint.effect not in ("NoSchedule", "NoExecute"):
            continue  # PreferNoSchedule is a priority concern
        if not any(_tolerates(tol, taint) for tol in pod.spec.tolerations):
            return False, f"untolerated taint {taint.key}={taint.value}:{taint.effect}"
    return True, ""


def _tolerates(tol: t.Toleration, taint: t.Taint) -> bool:
    if tol.effect and tol.effect != taint.effect:
        return False
    if tol.operator == "Exists":
        return tol.key == "" or tol.key == taint.key
    return tol.key == taint.key and tol.value == taint.value


def pod_fits_host_ports(pod: t.Pod, ni: NodeInfo) -> Tuple[bool, str]:
    wanted = {
        (p.host_port, p.protocol)
        for c in pod.spec.containers
        for p in c.ports
        if p.host_port
    }
    if not wanted:
        return True, ""
    used = {
        (p.host_port, p.protocol)
        for existing in ni.pods.values()
        for c in existing.spec.containers
        for p in c.ports
        if p.host_port
    }
    clash = wanted & used
    if clash:
        return False, f"host port(s) in use: {sorted(clash)}"
    return True, ""


def node_schedulable(pod: t.Pod, ni: NodeInfo) -> Tuple[bool, str]:
    node = ni.node
    if node is None:
        return False, "node unknown"
    if node.spec.unschedulable:
        return False, "node unschedulable (cordoned)"
    for cond in node.status.conditions:
        if cond.type == t.NODE_READY and cond.status != "True":
            return False, "node not ready"
    return True, ""


# Static predicates read only (pod spec placement fields, node OBJECT) —
# their result is identical for equivalent pods until the node object
# changes, so it is cacheable (ref: core/equivalence_cache.go). Dynamic
# predicates read the node's pod-derived accounting and must run live.
STATIC_PREDICATES = [
    ("NodeSchedulable", node_schedulable),
    ("MatchNodeSelector", pod_matches_node_selector),
    ("PodToleratesNodeTaints", pod_tolerates_node_taints),
]
DYNAMIC_PREDICATES = [
    ("PodFitsHostPorts", pod_fits_host_ports),
    ("PodFitsResources", pod_fits_resources),
]
DEFAULT_PREDICATES = STATIC_PREDICATES + DYNAMIC_PREDICATES


# ------------------------------------------------- inter-pod (anti)affinity

TOPOLOGY_HOSTNAME = "kubernetes.io/hostname"
TOPOLOGY_NVLINK_DOMAIN = "nvidia.com/gpu-nvlink-domain"


def node_topology_value(ni: NodeInfo, key: str) -> Optional[str]:
    """A node's value for a topology key.  Hostname falls back to the node
    name; the NVLink domain key resolves from device attributes, so
    co-location on one NVLink fabric needs no manual node labeling."""
    if ni.node is None:
        return None
    if key == TOPOLOGY_HOSTNAME:
        return ni.node.metadata.labels.get(key) or ni.node.metadata.name
    if key == TOPOLOGY_NVLINK_DOMAIN:
        # a node belongs to ONE domain only when all its cards agree: a
        # node of several domains has no single value (an arbitrary first
        # card's answer would co-locate onto the wrong fabric)
        domains = set()
        for info in ni.extended.values():
            for d in info.devices.values():
                s = (d.attributes or {}).get(t.ATTR_GPU_NVLINK_DOMAIN)
                if s:
                    domains.add(s)
        return domains.pop() if len(domains) == 1 else None
    return ni.node.metadata.labels.get(key)


def _term_namespaces(term: t.PodAffinityTerm, owner: t.Pod) -> List[str]:
    return term.namespaces or [owner.metadata.namespace]


class PodAffinityChecker:
    """Precomputed inter-pod (anti)affinity verdict for ONE scheduling
    attempt (ref: predicates.go:1036 InterPodAffinityMatches).

    The classic scalability killer is re-scanning every pod per candidate
    node; instead ONE O(pods) pass over the snapshot computes, per term,
    the set of topology values that satisfy (affinity) or block
    (anti-affinity, including the SYMMETRY direction: an existing pod's
    required anti-affinity blocks the incoming pod), and the per-node check
    is O(terms) dict lookups."""

    def __init__(self, pod: t.Pod, snapshot: Dict[str, NodeInfo]):
        self.pod = pod
        aff = pod.spec.affinity
        self.affinity_terms = list(aff.pod_affinity_required) if aff else []
        self.anti_terms = list(aff.pod_anti_affinity_required) if aff else []
        # (topology_key -> satisfied values) per affinity term, aligned by index
        self._affinity_values: List[set] = [set() for _ in self.affinity_terms]
        # topology_key -> blocked values (own anti terms + symmetry)
        self._blocked: Dict[str, set] = {}
        self._topo_cache: Dict[Tuple[str, str], Optional[str]] = {}
        # first-replica carve-out (upstream InterPodAffinityMatches): a term
        # the pod's OWN labels satisfy is allowed when nothing matches yet —
        # otherwise a self-co-locating ReplicaSet can never place replica 1
        self._self_match: List[bool] = [
            pod.metadata.namespace in _term_namespaces(term, pod)
            and labelutil.label_selector_matches(
                term.label_selector, pod.metadata.labels)
            for term in self.affinity_terms
        ]
        for name, ni in snapshot.items():
            if ni.node is None:
                continue
            for p in ni.pods.values():
                self.note_added_pod(p, ni)

    def note_added_pod(self, p: t.Pod, ni: NodeInfo):
        """Fold one (existing or simulated) pod into the context — gang
        placement reuses a checker across members by feeding each shadow
        member back instead of rebuilding the O(pods) pass."""
        if p.metadata.deletion_timestamp or ni.node is None:
            return
        pod = self.pod
        name = ni.node.metadata.name
        for i, term in enumerate(self.affinity_terms):
            if p.metadata.namespace in _term_namespaces(term, pod) \
                    and labelutil.label_selector_matches(
                        term.label_selector, p.metadata.labels):
                v = self._topo(name, ni, term.topology_key)
                if v is not None:
                    self._affinity_values[i].add(v)
        for term in self.anti_terms:
            if p.metadata.namespace in _term_namespaces(term, pod) \
                    and labelutil.label_selector_matches(
                        term.label_selector, p.metadata.labels):
                v = self._topo(name, ni, term.topology_key)
                if v is not None:
                    self._blocked.setdefault(term.topology_key, set()).add(v)
        # symmetry: the EXISTING pod's required anti-affinity forbids the
        # incoming pod in its topology domain
        p_aff = p.spec.affinity
        if p_aff is not None:
            for term in p_aff.pod_anti_affinity_required:
                if pod.metadata.namespace in _term_namespaces(term, p) \
                        and labelutil.label_selector_matches(
                            term.label_selector, pod.metadata.labels):
                    v = self._topo(name, ni, term.topology_key)
                    if v is not None:
                        self._blocked.setdefault(term.topology_key, set()).add(v)

    def _topo(self, name: str, ni: NodeInfo, key: str) -> Optional[str]:
        ck = (name, key)
        if ck not in self._topo_cache:
            self._topo_cache[ck] = node_topology_value(ni, key)
        return self._topo_cache[ck]

    def check(self, ni: NodeInfo) -> Tuple[bool, str]:
        name = ni.node.metadata.name
        for i, term in enumerate(self.affinity_terms):
            v = self._topo(name, ni, term.topology_key)
            if v is None:
                return False, (
                    f"pod affinity: node has no {term.topology_key} domain")
            if v not in self._affinity_values[i]:
                if self._self_match[i] and not self._affinity_values[i]:
                    continue  # first replica of a self-co-locating workload
                return False, (
                    f"pod affinity: no matching pod in this node's "
                    f"{term.topology_key} domain"
                )
        for key, blocked in self._blocked.items():
            v = self._topo(name, ni, key)
            if v is not None and v in blocked:
                return False, f"pod anti-affinity: {key} domain already hosts a conflicting pod"
        return True, ""


def pod_equivalence_key(pod: t.Pod) -> tuple:
    """Canonical serialization of exactly the pod fields the static
    predicates read. Pods from one controller share it, so a ReplicaSet's
    3000th pod skips the selector/affinity/taint checks on unchanged nodes.
    The key is the serialized tuple itself — not its hash — so two distinct
    pod classes can never collide into the same cache entry (dict keys
    compare by content on hash collision). Memoized on the pod object
    (informer updates replace objects, invalidating the memo)."""
    cached = getattr(pod, "_ktpu_equiv", None)
    if cached is not None:
        return cached
    import json as _json

    from ..machinery.scheme import to_dict

    key = (
        _json.dumps(pod.spec.node_selector, sort_keys=True),
        _json.dumps(to_dict(pod.spec.affinity), sort_keys=True)
        if pod.spec.affinity else "",
        _json.dumps([to_dict(tol) for tol in pod.spec.tolerations], sort_keys=True),
    )
    pod._ktpu_equiv = key
    return key


class EquivalenceCache:
    """(pod equiv key, node name) -> cached static-predicate verdict, valid
    while the node's generation is unchanged. Single-writer (the scheduling
    loop), so a plain dict with a size cap suffices."""

    MAX_ENTRIES = 200_000

    def __init__(self):
        self._cache: dict = {}

    def lookup(self, equiv: tuple, node_name: str, generation: int):
        entry = self._cache.get((equiv, node_name))
        if entry is not None and entry[0] == generation:
            return entry[1], entry[2]
        return None

    def store(self, equiv: tuple, node_name: str, generation: int, ok: bool, reason: str):
        if len(self._cache) >= self.MAX_ENTRIES:
            self._cache.clear()
        self._cache[(equiv, node_name)] = (generation, ok, reason)


def run_predicates(
    pod: t.Pod, ni: NodeInfo, equiv_cache: "EquivalenceCache" = None
) -> Tuple[bool, List[str]]:
    if equiv_cache is not None and ni.node is not None:
        equiv = pod_equivalence_key(pod)
        name = ni.node.metadata.name
        hit = equiv_cache.lookup(equiv, name, ni.generation)
        if hit is not None:
            ok, reason = hit
            if not ok:
                return False, [reason]
        else:
            ok, reason = True, ""
            for _name, pred in STATIC_PREDICATES:
                ok, reason = pred(pod, ni)
                if not ok:
                    break
            equiv_cache.store(equiv, name, ni.generation, ok, reason)
            if not ok:
                return False, [reason]
        for _name, pred in DYNAMIC_PREDICATES:
            ok, reason = pred(pod, ni)
            if not ok:
                return False, [reason]
        return True, []
    reasons = []
    for _name, pred in DEFAULT_PREDICATES:
        ok, reason = pred(pod, ni)
        if not ok:
            reasons.append(reason)
            return False, reasons
    return True, reasons
