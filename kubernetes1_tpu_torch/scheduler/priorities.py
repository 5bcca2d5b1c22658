"""Scoring priorities (ref: plugin/pkg/scheduler/algorithm/priorities/ —
LeastRequested, BalancedAllocation, TaintToleration, NodeAffinity; defaults
at algorithmprovider/defaults/defaults.go:220-255).

The port's copy of the JAX package's ``scheduler/priorities.py``.  Where
the JAX package's ``slice_packing`` scores how a pod's TPU request packs
into ICI slices, ``domain_packing`` scores how its card request packs into
NVLink domains: nodes whose free cards fill a domain score above nodes
where the pod would cut into a larger one.  The single-pod analogue of a
gang's placement on one domain.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

from ..api import types as t
from .cache import NodeInfo, pod_request_memory, pod_request_milli_cpu
from .devices import device_matches, domain_of

MAX_SCORE = 10.0


def least_requested(pod: t.Pod, ni: NodeInfo) -> float:
    """Favor nodes with more free cpu+memory fraction."""
    score = 0.0
    if ni.allocatable_milli_cpu > 0:
        free = max(0.0, 1 - (ni.requested_milli_cpu + pod_request_milli_cpu(pod)) / ni.allocatable_milli_cpu)
        score += free * MAX_SCORE
    if ni.allocatable_memory > 0:
        free = max(0.0, 1 - (ni.requested_memory + pod_request_memory(pod)) / ni.allocatable_memory)
        score += free * MAX_SCORE
    return score / 2


def balanced_allocation(pod: t.Pod, ni: NodeInfo) -> float:
    """Favor nodes where cpu and memory utilization stay close."""
    if ni.allocatable_milli_cpu <= 0 or ni.allocatable_memory <= 0:
        return 0.0
    cpu_frac = min(1.0, (ni.requested_milli_cpu + pod_request_milli_cpu(pod)) / ni.allocatable_milli_cpu)
    mem_frac = min(1.0, (ni.requested_memory + pod_request_memory(pod)) / ni.allocatable_memory)
    return (1 - abs(cpu_frac - mem_frac)) * MAX_SCORE


def taint_toleration(pod: t.Pod, ni: NodeInfo) -> float:
    """Penalize PreferNoSchedule taints the pod doesn't tolerate."""
    if ni.node is None:
        return 0.0
    from .predicates import _tolerates

    bad = 0
    for taint in ni.node.spec.taints:
        if taint.effect == "PreferNoSchedule" and not any(
            _tolerates(tol, taint) for tol in pod.spec.tolerations
        ):
            bad += 1
    return max(0.0, MAX_SCORE - 2.0 * bad)


def domain_packing(pod: t.Pod, ni: NodeInfo) -> float:
    """Best fit over NVLink domains: for each device request, score high
    when a domain can satisfy it exactly or with little left over, low when
    the request must cut into a large domain or span domains."""
    if not pod.spec.extended_resources:
        return MAX_SCORE / 2  # neutral
    total = 0.0
    for per in pod.spec.extended_resources:
        info = ni.extended.get(per.resource)
        if per.affinity is None:
            # common case rides the cache's incremental per-domain counters:
            # O(domains) instead of walking every device per scored node
            by_domain = dict(info.domain_available()) if info else {}
            if sum(by_domain.values()) < per.quantity:
                continue  # predicate will have filtered; defensive
        else:
            avail = [
                d
                for d in ni.available_devices(per.resource)
                if device_matches(d, per.affinity)
            ]
            if len(avail) < per.quantity:
                continue
            by_domain = defaultdict(int)
            for d in avail:
                by_domain[domain_of(d)] += 1
        fitting = [n for n in by_domain.values() if n >= per.quantity]
        if not fitting:
            total += 1.0  # must span domains: worst
            continue
        best = min(fitting)
        leftover = best - per.quantity
        total += MAX_SCORE * (1.0 / (1.0 + leftover))
    return total / max(1, len(pod.spec.extended_resources))


def selector_spreading(pod: t.Pod, ni: NodeInfo) -> float:
    """Spread a controller's replicas across nodes (ref:
    priorities/selector_spreading.go:43 — there by service/RC selector;
    here by shared controller owner, which is what replicas actually
    share).  Fewer siblings on the node = higher score."""
    owners = {ref.uid for ref in pod.metadata.owner_references if ref.uid}
    if not owners:
        return MAX_SCORE / 2  # standalone pod: neutral
    siblings = 0
    for p in ni.pods.values():
        if p.metadata.uid == pod.metadata.uid or p.metadata.deletion_timestamp:
            continue
        if owners & {ref.uid for ref in p.metadata.owner_references if ref.uid}:
            siblings += 1
    return MAX_SCORE / (1.0 + siblings)


def node_affinity(pod: t.Pod, ni: NodeInfo) -> float:
    """Soft node-affinity preferences (ref: priorities/node_affinity.go):
    the score is the satisfied fraction of the preferred terms' weights."""
    aff = pod.spec.affinity
    terms = aff.node_affinity_preferred if aff else []
    if not terms:
        return MAX_SCORE / 2  # neutral when the pod expresses no preference
    from .predicates import _term_matches

    labels = ni.node.metadata.labels or {}
    total = sum(max(1, term.weight) for term in terms)
    got = sum(max(1, term.weight) for term in terms
              if _term_matches(term.preference, labels))
    return MAX_SCORE * got / total


def image_locality(pod: t.Pod, ni: NodeInfo) -> float:
    """Favor nodes that already hold the pod's images (ref:
    priorities/image_locality.go; node.status.images is the inventory the
    kubelet publishes)."""
    images = set(ni.node.status.images or [])
    wanted = [c.image for c in pod.spec.containers if c.image]
    if not images or not wanted:
        return 0.0
    present = sum(1 for img in wanted if img in images)
    return MAX_SCORE * present / len(wanted)


PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.ktpu.io/preferAvoidPods"


def node_prefer_avoid_pods(pod: t.Pod, ni: NodeInfo) -> float:
    """Ref: priorities/node_prefer_avoid_pods.go — a node may carry an
    annotation listing controller UIDs whose pods should land elsewhere
    (used when draining a node softly); upstream weights this priority so
    heavily it effectively overrides the others.

    Annotation value: {"preferAvoidPods": [{"podSignature":
    {"podController": {"uid": "..."}}}]}."""
    ann = (ni.node.metadata.annotations or {}).get(PREFER_AVOID_PODS_ANNOTATION)
    if not ann:
        return MAX_SCORE
    avoided = _parse_avoided_uids(ann)
    if not avoided:
        return MAX_SCORE
    owners = {ref.uid for ref in pod.metadata.owner_references if ref.uid}
    return 0.0 if owners & avoided else MAX_SCORE


# annotation string -> frozenset of avoided controller UIDs; the string
# rarely changes and this runs per (pod, node) in the scoring hot loop
_avoid_memo: Dict[str, frozenset] = {}


def _parse_avoided_uids(ann: str) -> frozenset:
    hit = _avoid_memo.get(ann)
    if hit is not None:
        return hit
    import json as _json

    avoided: set = set()
    try:
        doc = _json.loads(ann)
        entries = doc.get("preferAvoidPods") if isinstance(doc, dict) else []
        for e in entries or []:
            if not isinstance(e, dict):
                continue
            sig = e.get("podSignature")
            ctl = sig.get("podController") if isinstance(sig, dict) else None
            uid = ctl.get("uid") if isinstance(ctl, dict) else None
            if uid:
                avoided.add(uid)
    except (ValueError, TypeError, AttributeError):
        pass  # a malformed annotation must never take down scheduling
    out = frozenset(avoided)
    if len(_avoid_memo) > 1000:
        _avoid_memo.clear()
    _avoid_memo[ann] = out
    return out


DEFAULT_PRIORITIES: List[Tuple[str, Callable[[t.Pod, NodeInfo], float], float]] = [
    ("LeastRequested", least_requested, 1.0),
    ("BalancedAllocation", balanced_allocation, 1.0),
    ("TaintToleration", taint_toleration, 1.0),
    ("NodeAffinity", node_affinity, 1.0),
    ("ImageLocality", image_locality, 0.5),
    ("SelectorSpreading", selector_spreading, 1.5),
    ("DomainPacking", domain_packing, 2.0),  # device placement dominates
    # upstream weight 10000: an avoid-marked node loses to any alternative
    ("NodePreferAvoidPods", node_prefer_avoid_pods, 100.0),
]


def prioritize(pod: t.Pod, nodes: List[NodeInfo]) -> Dict[str, float]:
    """Fused scoring loop: the weighted sum of DEFAULT_PRIORITIES for each
    node, in the JAX package's arithmetic (``tests/test_torch_scheduler.py``
    holds the scores equal to its ``prioritize``), restructured for the hot
    path: per-pod invariants (resource requests, tolerations,
    owner set, image list, affinity terms) are computed ONCE instead of
    per node, and priorities whose answer is a constant for this pod
    (no affinity terms, no owners, no device request, untainted node)
    skip their function call entirely.  At 1000-node density this loop
    runs ~100 node scorings per pod at 30k pods — it IS the scheduler's
    saturation throughput."""
    from .predicates import _term_matches, _tolerates

    req_cpu = pod_request_milli_cpu(pod)
    req_mem = pod_request_memory(pod)
    owners = frozenset(
        ref.uid for ref in pod.metadata.owner_references if ref.uid)
    pod_uid = pod.metadata.uid
    wanted = [c.image for c in pod.spec.containers if c.image]
    n_wanted = len(wanted)
    tolerations = pod.spec.tolerations
    aff = pod.spec.affinity
    terms = (aff.node_affinity_preferred if aff else None) or []
    terms_total = sum(max(1, term.weight) for term in terms)
    ext_res = pod.spec.extended_resources

    base = 0.0
    if not terms:
        base += _W_NODE_AFFINITY * (MAX_SCORE / 2)      # neutral
    if not owners:
        base += _W_SELECTOR_SPREADING * (MAX_SCORE / 2)  # neutral
    if not ext_res:
        base += _W_DOMAIN_PACKING * (MAX_SCORE / 2)      # neutral

    scores: Dict[str, float] = {}
    for ni in nodes:
        node = ni.node
        s = base
        # LeastRequested
        ac, am = ni.allocatable_milli_cpu, ni.allocatable_memory
        lr = 0.0
        if ac > 0:
            lr += max(0.0, 1 - (ni.requested_milli_cpu + req_cpu) / ac) \
                * MAX_SCORE
        if am > 0:
            lr += max(0.0, 1 - (ni.requested_memory + req_mem) / am) \
                * MAX_SCORE
        s += _W_LEAST_REQUESTED * (lr / 2)
        # BalancedAllocation
        if ac > 0 and am > 0:
            cpu_frac = min(1.0, (ni.requested_milli_cpu + req_cpu) / ac)
            mem_frac = min(1.0, (ni.requested_memory + req_mem) / am)
            s += _W_BALANCED * (1 - abs(cpu_frac - mem_frac)) * MAX_SCORE
        # TaintToleration: untainted node = full score (the common case)
        taints = node.spec.taints
        if taints:
            bad = 0
            for taint in taints:
                if taint.effect == "PreferNoSchedule" and not any(
                        _tolerates(tol, taint) for tol in tolerations):
                    bad += 1
            s += _W_TAINT * max(0.0, MAX_SCORE - 2.0 * bad)
        else:
            s += _W_TAINT * MAX_SCORE
        # NodeAffinity (terms hoisted; total weight precomputed)
        if terms:
            labels = node.metadata.labels or {}
            got = sum(max(1, term.weight) for term in terms
                      if _term_matches(term.preference, labels))
            s += _W_NODE_AFFINITY * MAX_SCORE * got / terms_total
        # ImageLocality (wanted hoisted)
        if wanted:
            images = node.status.images
            if images:
                iset = set(images)
                present = sum(1 for img in wanted if img in iset)
                s += _W_IMAGE * MAX_SCORE * present / n_wanted
        # SelectorSpreading (owner set hoisted)
        if owners:
            siblings = 0
            for p in ni.pods.values():
                if p.metadata.uid == pod_uid or p.metadata.deletion_timestamp:
                    continue
                for ref in p.metadata.owner_references:
                    if ref.uid and ref.uid in owners:
                        siblings += 1
                        break
            s += _W_SELECTOR_SPREADING * MAX_SCORE / (1.0 + siblings)
        if ext_res:
            s += _W_DOMAIN_PACKING * domain_packing(pod, ni)
        # NodePreferAvoidPods: no annotation = full score
        if (node.metadata.annotations or {}).get(
                PREFER_AVOID_PODS_ANNOTATION):
            s += _W_AVOID * node_prefer_avoid_pods(pod, ni)
        else:
            s += _W_AVOID * MAX_SCORE
        scores[node.metadata.name] = s
    return scores


# The fused loop's weights MUST be the registry's weights: a tuned
# DEFAULT_PRIORITIES entry that the fused loop ignored would silently
# not affect real scheduling.  Bound at import; editing one side without
# the other fails fast here.
_BY_NAME = {name: weight for name, _fn, weight in DEFAULT_PRIORITIES}
_W_LEAST_REQUESTED = _BY_NAME["LeastRequested"]
_W_BALANCED = _BY_NAME["BalancedAllocation"]
_W_TAINT = _BY_NAME["TaintToleration"]
_W_NODE_AFFINITY = _BY_NAME["NodeAffinity"]
_W_IMAGE = _BY_NAME["ImageLocality"]
_W_SELECTOR_SPREADING = _BY_NAME["SelectorSpreading"]
_W_DOMAIN_PACKING = _BY_NAME["DomainPacking"]
_W_AVOID = _BY_NAME["NodePreferAvoidPods"]
assert len(_BY_NAME) == 8, (
    "a priority was added to DEFAULT_PRIORITIES without teaching the "
    "fused prioritize() loop about it: update both")
