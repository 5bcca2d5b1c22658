"""The port's scheduler (``kubernetes1_tpu_torch/scheduler``) held to the
JAX package's (``kubernetes1_tpu/scheduler``) on the same inputs.

Each case is made from a seed with numpy as wire dicts: nodes of 1 to 12
cards in NVLink domains of 1, 2, 4 or 8 cards, minors out of order, some
cards unhealthy, node labels, taints, cordons; pods already bound to
cards; and a pod to place, with attribute affinity on its cards
(In/NotIn/Exists/Gt/Lt), a node selector, required and preferred node
affinity, tolerations, pod affinity and anti-affinity (by host and by
NVLink domain), host ports, a priority and an owner.  Each package decodes
the dicts with its own ``from_dict``: the port's carry the cards' domain
and minor under ``nvidia.com/gpu/nvlink-domain`` and
``nvidia.com/gpu/minor`` (and the domain topology key
``nvidia.com/gpu-nvlink-domain``), the JAX package's the same values
under ``google.com/tpu/slice``, ``google.com/tpu/coords`` and
``google.com/tpu-slice``.  ``device_matches``, ``pick_devices``,
``allocate_for_pod``, ``fits_devices``, ``run_predicates``, the inter-pod
affinity check, ``prioritize`` (and each priority alone) and
``node_topology_value``, then the
scheduler's ``schedule`` and its gang placement, must give the same IDs,
reasons and scores: tolerance 0.

With only the GPU keys present, the port keeps a 2-card pod on one NVLink
pair of the bridged-pairs board (minors 4, 1, 2, 7), where the JAX
scheduler, which reads only the TPU keys, takes a card of each pair.
"""

import json

import numpy as np
import pytest

from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.machinery.scheme import from_dict as jax_from_dict
from kubernetes1_tpu.scheduler import cache as jcache
from kubernetes1_tpu.scheduler import devices as jdevices
from kubernetes1_tpu.scheduler import predicates as jpredicates
from kubernetes1_tpu.scheduler import priorities as jpriorities
from kubernetes1_tpu.scheduler.scheduler import Scheduler as JaxScheduler
from kubernetes1_tpu_torch import GPU_RESOURCE
from kubernetes1_tpu_torch.api import types as tt
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.deviceplugin import gpu_plugin as gp
from kubernetes1_tpu_torch.machinery.scheme import from_dict as torch_from_dict
from kubernetes1_tpu_torch.scheduler import cache as tcache
from kubernetes1_tpu_torch.scheduler import devices as tdevices
from kubernetes1_tpu_torch.scheduler import predicates as tpredicates
from kubernetes1_tpu_torch.scheduler import priorities as tpriorities
from kubernetes1_tpu_torch.scheduler.scheduler import Scheduler as TorchScheduler
from tests.test_torch_deviceplugin import board_devices

N_CASES = 210
DOMAIN_KEY = "nvidia.com/gpu-nvlink-domain"
# the port's keys -> the JAX package's, for the same values
TO_JAX = {tt.ATTR_GPU_NVLINK_DOMAIN: jt.ATTR_TPU_SLICE,
          tt.ATTR_GPU_MINOR: jt.ATTR_TPU_CHIP_COORDS,
          DOMAIN_KEY: jpredicates.TOPOLOGY_TPU_SLICE}
MODELS = [("NVIDIA H100 80GB HBM3", "81559"), ("NVIDIA A100-SXM4-40GB", "40960")]
ZONES = ["a", "b", "c"]
APPS = ["web", "db", "cache"]
URL = "http://127.0.0.1:9"  # never dialed: the schedulers here run no loop


def test_key_translation_names_the_jax_packages_keys():
    assert TO_JAX == {"nvidia.com/gpu/nvlink-domain": "google.com/tpu/slice",
                      "nvidia.com/gpu/minor": "google.com/tpu/coords",
                      "nvidia.com/gpu-nvlink-domain": "google.com/tpu-slice"}
    assert tpredicates.TOPOLOGY_NVLINK_DOMAIN == DOMAIN_KEY


def to_jax_wire(doc):
    """The same wire dict with the port's GPU keys renamed to the TPU keys
    the JAX scheduler reads (values untouched)."""
    raw = json.dumps(doc)
    for port_key, jax_key in TO_JAX.items():
        raw = raw.replace(json.dumps(port_key), json.dumps(jax_key))
    return json.loads(raw)


def as_jax(view):
    """A port-side answer as JSON data with the key names in its reasons
    (a topology key a pod-affinity refusal names) renamed as the inputs
    were: what the JAX side must answer, to the character."""
    raw = json.dumps(view)
    for port_key, jax_key in TO_JAX.items():
        raw = raw.replace(port_key, jax_key)
    return json.loads(raw)


def as_json(view):
    return json.loads(json.dumps(view))


# ------------------------------------------------------------ the cases


def _pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def _requirement(rng, key_values):
    """One matchExpression / ResourceSelector over ``key_values``
    ({key: [candidate values]}), numeric keys taking Gt/Lt too."""
    key = _pick(rng, sorted(key_values))
    values = key_values[key]
    ops = ["In", "NotIn", "Exists", "DoesNotExist"]
    if all(v.lstrip("-").isdigit() for v in values):
        ops += ["Gt", "Lt"]
    op = _pick(rng, ops)
    if op in ("Gt", "Lt"):
        vals = [_pick(rng, values)]
    elif op in ("In", "NotIn"):
        vals = sorted({_pick(rng, values) for _ in range(1 + int(rng.integers(2)))})
    else:
        vals = []
    return {"key": key, "operator": op, "values": vals}


def make_node(rng, i):
    name = f"node-{i}"
    n_cards = int(rng.integers(1, 13))
    size = _pick(rng, [1, 2, 4, 8])
    minors = [int(m) for m in rng.permutation(16)[:n_cards]]
    model, memory = _pick(rng, MODELS)
    cards = []
    for k, minor in enumerate(minors):
        cards.append({
            "id": f"{name}-nvidia{minor}",
            "health": "Unhealthy" if rng.random() < 0.1 else "Healthy",
            "attributes": {gp.ATTR_GPU_MODEL: model, gp.ATTR_GPU_MEMORY: memory,
                           tt.ATTR_GPU_NVLINK_DOMAIN: f"{name}-nvl{k // size}",
                           tt.ATTR_GPU_MINOR: str(minor)}})
    if rng.random() < 0.2:  # a node whose cards all sit in one shared domain
        for c in cards:
            c["attributes"][tt.ATTR_GPU_NVLINK_DOMAIN] = "fabric-0"
    taints = []
    if rng.random() < 0.3:
        taints.append({"key": "dedicated", "value": _pick(rng, APPS),
                       "effect": _pick(rng, ["NoSchedule", "PreferNoSchedule", "NoExecute"])})
    cpu, mem = str(int(rng.integers(2, 33))), f"{int(rng.integers(4, 129))}Gi"
    return {
        "metadata": {"name": name, "labels": {"zone": _pick(rng, ZONES),
                                              "rank": str(int(rng.integers(10)))}},
        "spec": {"taints": taints, "unschedulable": bool(rng.random() < 0.05)},
        "status": {
            "capacity": {"cpu": cpu, "memory": mem, "pods": "110"},
            "allocatable": {"cpu": cpu, "memory": mem, "pods": "110"},
            "conditions": [{"type": "Ready",
                            "status": "False" if rng.random() < 0.05 else "True"}],
            "extendedResources": {GPU_RESOURCE: cards},
            "images": ["ktpu/torch-workload"] if rng.random() < 0.5 else [],
        },
    }


def _affinity_terms(rng, n):
    return [{"labelSelector": {"matchLabels": {"app": _pick(rng, APPS)}},
             "topologyKey": _pick(rng, ["kubernetes.io/hostname", DOMAIN_KEY, "zone"])}
            for _ in range(n)]


def make_pod(rng, name, node_keys, device_keys, bound_to=None, cards=()):
    """A pod dict; ``bound_to`` a node name makes it bound there with
    ``cards`` assigned."""
    container = {"name": "main", "image": "ktpu/torch-workload",
                 "resources": {"requests": {"cpu": f"{int(rng.integers(1, 9)) * 250}m",
                                            "memory": f"{int(rng.integers(1, 9))}Gi"}}}
    if rng.random() < 0.15:
        container["ports"] = [{"containerPort": 80, "hostPort": 8080}]
    spec = {"containers": [container], "priority": int(rng.integers(0, 3)) * 50}
    meta = {"name": name, "namespace": "default", "uid": f"uid-{name}",
            "labels": {"app": _pick(rng, APPS)}}
    if rng.random() < 0.5:
        meta["ownerReferences"] = [{"kind": "ReplicaSet", "name": "rs",
                                    "uid": f"rs-{_pick(rng, APPS)}"}]
    aff = {}
    if rng.random() < 0.3:
        aff["podAntiAffinityRequired"] = _affinity_terms(rng, 1)
    if bound_to is None:
        if rng.random() < 0.3:
            spec["nodeSelector"] = {"zone": _pick(rng, ZONES)}
        if rng.random() < 0.3:
            aff["nodeAffinityRequired"] = [
                {"matchExpressions": [_requirement(rng, node_keys)
                                      for _ in range(1 + int(rng.integers(2)))]}
                for _ in range(1 + int(rng.integers(2)))]
        if rng.random() < 0.3:
            aff["nodeAffinityPreferred"] = [
                {"weight": int(rng.integers(1, 101)),
                 "preference": {"matchExpressions": [_requirement(rng, node_keys)]}}
                for _ in range(1 + int(rng.integers(2)))]
        if rng.random() < 0.25:
            aff["podAffinityRequired"] = _affinity_terms(rng, 1)
        if rng.random() < 0.4:
            spec["tolerations"] = [{"key": "dedicated",
                                    "operator": _pick(rng, ["Equal", "Exists"]),
                                    "value": _pick(rng, APPS),
                                    "effect": _pick(rng, ["", "NoSchedule", "PreferNoSchedule"])}]
        if rng.random() < 0.1:
            meta["annotations"] = {jt.NOMINATED_NODE_ANNOTATION: "node-0"}
    if aff:
        spec["affinity"] = aff
    per_list = []
    if bound_to is not None:
        if cards:
            per_list.append({"name": "gpu", "resource": GPU_RESOURCE,
                             "quantity": len(cards), "assigned": list(cards)})
        spec["nodeName"] = bound_to
    else:
        for req in range(int(rng.choice([0, 1, 1, 1, 2]))):
            per = {"name": f"gpu{req}", "resource": GPU_RESOURCE,
                   "quantity": int(rng.integers(1, 5))}
            if rng.random() < 0.5:
                per["affinity"] = {"required": [_requirement(rng, device_keys)
                                                for _ in range(1 + int(rng.integers(2)))]}
            per_list.append(per)
    if per_list:
        spec["extendedResources"] = per_list
        container["extendedResourceRequests"] = [p["name"] for p in per_list]
    return {"metadata": meta, "spec": spec,
            "status": {"phase": "Running" if bound_to else "Pending"}}


def make_case(seed):
    """(nodes, bound pods, the pod to place, a gang of 2 or 3) as wire dicts."""
    rng = np.random.default_rng(seed)
    nodes = [make_node(rng, i) for i in range(int(rng.integers(1, 5)))]
    node_keys = {"zone": ZONES, "rank": [str(r) for r in range(10)],
                 "gpu-class": ["h100"]}
    domains = sorted({c["attributes"][tt.ATTR_GPU_NVLINK_DOMAIN] for n in nodes
                      for c in n["status"]["extendedResources"][GPU_RESOURCE]})
    device_keys = {gp.ATTR_GPU_MODEL: [m for m, _ in MODELS],
                   gp.ATTR_GPU_MEMORY: ["40000", "50000", "81559", "90000"],
                   tt.ATTR_GPU_MINOR: [str(m) for m in range(16)],
                   tt.ATTR_GPU_NVLINK_DOMAIN: domains}
    bound = []
    for node in nodes:
        healthy = [c["id"] for c in node["status"]["extendedResources"][GPU_RESOURCE]
                   if c["health"] == "Healthy"]
        rng.shuffle(healthy)
        for j in range(int(rng.integers(0, 4))):
            take = int(rng.integers(0, 3))
            cards, healthy = healthy[:take], healthy[take:]
            bound.append(make_pod(rng, f"{node['metadata']['name']}-b{j}", node_keys,
                                  device_keys, bound_to=node["metadata"]["name"],
                                  cards=cards))
    pod = make_pod(rng, "incoming", node_keys, device_keys)
    gang_size = int(rng.integers(2, 4))
    gang = []
    for g in range(gang_size):
        member = make_pod(rng, f"gang-{g}", node_keys, device_keys)
        member["spec"].update(schedulingGang="g", gangSize=gang_size,
                              extendedResources=[{"name": "gpu", "resource": GPU_RESOURCE,
                                                  "quantity": int(rng.integers(1, 5))}])
        member["spec"]["containers"][0]["extendedResourceRequests"] = ["gpu"]
        gang.append(member)
    return nodes, bound, pod, gang


class Side:
    """One package's view of a case: its types, modules and decoded objects."""

    def __init__(self, case, jax: bool):
        nodes, bound, pod, gang = case
        self.t = jt if jax else tt
        self.cache = jcache if jax else tcache
        self.devices = jdevices if jax else tdevices
        self.predicates = jpredicates if jax else tpredicates
        self.priorities = jpriorities if jax else tpriorities
        from_dict = jax_from_dict if jax else torch_from_dict
        wire = to_jax_wire if jax else (lambda d: d)
        self.domain_key = TO_JAX[DOMAIN_KEY] if jax else DOMAIN_KEY
        self.nodes = [from_dict(self.t.Node, wire(n)) for n in nodes]
        self.bound = [from_dict(self.t.Pod, wire(p)) for p in bound]
        self.pod = from_dict(self.t.Pod, wire(pod))
        self.gang = [from_dict(self.t.Pod, wire(p)) for p in gang]

    def snapshot(self):
        """{node name: NodeInfo} with the bound pods added."""
        infos = {n.metadata.name: self.cache.NodeInfo(n) for n in self.nodes}
        for p in self.bound:
            infos[p.spec.node_name].add_pod(p)
        return infos

    def scheduler(self):
        if self.t is jt:
            return JaxScheduler(JaxClientset(URL))
        return TorchScheduler(TorchClientset(URL))


def placement(result):
    res, why = result
    return (res.node, res.assignments, "") if res is not None else (None, None, why)


def device_view(side):
    """Every device-level answer for the case's pod on every node."""
    out = []
    for ni in side.snapshot().values():
        avail = ni.available_devices(GPU_RESOURCE)
        for per in side.pod.spec.extended_resources:
            out.append(("matches", per.name,
                        [side.devices.device_matches(d, per.affinity) for d in avail]))
            matched = [d for d in avail if side.devices.device_matches(d, per.affinity)]
            for q in (1, 2, 3, per.quantity, len(matched)):
                out.append(("pick", per.name, q, side.devices.pick_devices(matched, q)))
        out.append(("allocate", side.devices.allocate_for_pod(side.pod, ni)))
        out.append(("fits", side.devices.fits_devices(side.pod, ni)))
    return out


def predicate_view(side):
    snap = side.snapshot()
    checker = side.predicates.PodAffinityChecker(side.pod, snap)
    equiv = side.predicates.EquivalenceCache()
    out = []
    for name, ni in snap.items():
        out.append((name, side.predicates.run_predicates(side.pod, ni),
                    side.predicates.run_predicates(side.pod, ni, equiv),
                    checker.check(ni),
                    [side.predicates.node_topology_value(ni, key) for key in
                     ("kubernetes.io/hostname", side.domain_key, "zone", "missing")]))
    return out


def score_view(side):
    """The fused scores, and each priority's weight and score on each node
    (the port's DomainPacking under the JAX name, SlicePacking)."""
    nodes = list(side.snapshot().values())
    each = [(name.replace("DomainPacking", "SlicePacking"), weight,
             [fn(side.pod, ni) for ni in nodes])
            for name, fn, weight in side.priorities.DEFAULT_PRIORITIES]
    return side.priorities.prioritize(side.pod, nodes), each


def schedule_view(side):
    """The scheduler's placement of the pod, then of the gang, and the
    same gang on a world without the bound pods (its preemption's sim)."""
    sched = side.scheduler()
    try:
        sched._anti_affinity_uids.update(
            p.metadata.uid for p in side.bound
            if p.spec.affinity and p.spec.affinity.pod_anti_affinity_required)
        one = placement(sched.schedule(side.pod, nodes=side.snapshot()))
        gang = sched._place_gang(side.gang, base=side.snapshot())
        empty = {n.metadata.name: side.cache.NodeInfo(n) for n in side.nodes}
        gang_empty = sched._place_gang(side.gang, base=empty)
        fmt = lambda ps: None if ps is None else [  # noqa: E731
            (m.metadata.name, r.node, r.assignments) for m, r in ps]
        return one, fmt(gang), fmt(gang_empty)
    finally:
        sched.cs.close()


@pytest.mark.parametrize("seed", range(N_CASES))
def test_device_predicate_and_score_functions_equal_the_jax_packages(seed):
    case = make_case(seed)
    port, ref = Side(case, jax=False), Side(case, jax=True)
    assert device_view(port) == device_view(ref)
    assert as_jax(predicate_view(port)) == as_json(predicate_view(ref))
    assert score_view(port) == score_view(ref)


@pytest.mark.parametrize("seed", range(N_CASES))
def test_schedule_and_gang_placement_equal_the_jax_schedulers(seed):
    case = make_case(seed)
    assert as_jax(schedule_view(Side(case, jax=False))) == as_json(
        schedule_view(Side(case, jax=True)))


def test_the_cases_reach_every_branch():
    """Across the seeds the pod places and fails (on cards among other
    reasons), a gang places whole and is refused, and the NVLink domain
    key gives a node a topology value."""
    placed, failures, gangs, refused, domains = 0, [], 0, 0, 0
    for seed in range(N_CASES):
        side = Side(make_case(seed), jax=False)
        one, gang, _ = schedule_view(side)
        placed += one[0] is not None
        if one[0] is None:
            failures.append(one[2])
        gangs += gang is not None
        refused += gang is None
        domains += any(v[4][1] is not None for v in predicate_view(side))
    assert min(placed, len(failures), gangs, refused, domains) >= 10, (
        placed, len(failures), gangs, refused, domains)
    assert any("insufficient nvidia.com/gpu" in why for why in failures)
    assert any("insufficient nvidia.com/gpu" not in why for why in failures)


# ----------------------------------------------- the GPU keys alone


def _gpu_keys_only(devices):
    return [{**d, "attributes": {k: v for k, v in d["attributes"].items()
                                 if not k.startswith("google.com/")}} for d in devices]


def _node_info(side_types, side_cache, from_dict, devices):
    node = side_types.Node()
    node.metadata.name = "gpu-node"
    node.status.capacity = {"cpu": "8", "memory": "32Gi", "pods": "110"}
    node.status.allocatable = dict(node.status.capacity)
    node.status.extended_resources = {
        GPU_RESOURCE: [from_dict(side_types.ExtendedResourceDevice, d) for d in devices]}
    return side_cache.NodeInfo(node)


def _place(side_types, side_devices, info, name, quantity):
    pod = side_types.Pod()
    pod.metadata.name, pod.metadata.namespace, pod.metadata.uid = name, "default", f"u-{name}"
    pod.spec.extended_resources = [side_types.PodExtendedResource(
        name="gpu", resource=GPU_RESOURCE, quantity=quantity)]
    assignments, reason = side_devices.allocate_for_pod(pod, info)
    assert assignments is not None, reason
    pod.spec.extended_resources[0].assigned = assignments["gpu"]
    info.add_pod(pod)
    return assignments["gpu"]


def test_port_keeps_a_two_card_pod_on_one_nvlink_pair_with_only_the_gpu_keys(
        tmp_path, monkeypatch):
    """The bridged-pairs board (minors 4, 1, 2, 7; NVLink pairs {4, 1} and
    {2, 7}) as the Python plugin discovers it, without the google.com/tpu
    keys: the port's scheduler gives a 2-card pod the pair {1, 4}, and
    after a 1-card pod took nvidia1, the intact pair {2, 7}.  The JAX
    scheduler, which reads only the TPU keys, sees every card in one
    domain with no position and takes them in the IDs' string order: a
    card of each pair."""
    devices = _gpu_keys_only(board_devices(tmp_path, monkeypatch, "bridged-pairs"))
    assert all(not k.startswith("google.com/") for d in devices for k in d["attributes"])
    host = __import__("os").uname().nodename
    ids = lambda *ms: [f"{host}-nvidia{m}" for m in ms]  # noqa: E731
    port = lambda: _node_info(tt, tcache, torch_from_dict, devices)  # noqa: E731
    assert _place(tt, tdevices, port(), "two", 2) == ids(1, 4)
    info = port()
    assert _place(tt, tdevices, info, "one", 1) == ids(1)
    assert _place(tt, tdevices, info, "two-after", 2) == ids(2, 7)
    jax_info = _node_info(jt, jcache, jax_from_dict, devices)
    assert _place(jt, jdevices, jax_info, "two", 2) == ids(1, 2)


def _histogram_counts(text):
    """``name -> _count`` for every histogram in a /metrics page."""
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name.endswith("_count"):
            out[name[:-len("_count")]] = float(value)
    return out


def test_the_ports_scheduler_serves_its_metrics_health_and_traces():
    """The port's scheduler with an ephemeral metrics port, against the
    JAX apiserver: once it binds a pod, /healthz and /readyz answer 200,
    /metrics holds the attempt, algorithm and bind histograms each with a
    count of at least 1, and /debug/traces under the trace id the
    apiserver stamped on the pod holds the attempt's and the bind's spans."""
    import urllib.request

    from kubernetes1_tpu.apiserver import Master
    from kubernetes1_tpu.utils.waitutil import must_poll_until
    from tests.helpers import make_node, make_tpu_pod

    def get(url):
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()

    master = Master().start()
    jcs = JaxClientset(master.url)
    tcs = TorchClientset(master.url)
    sched = TorchScheduler(tcs, metrics_port=0).start()
    try:
        base = sched.metrics_server.url
        jcs.nodes.create(make_node("n1"))
        jcs.pods.create(make_tpu_pod("traced", tpus=0))
        must_poll_until(lambda: jcs.pods.get("traced").spec.node_name == "n1",
                        timeout=10.0, desc="the pod bound to n1")
        assert get(base + "/healthz") == (200, json.dumps({"status": "ok"}))
        assert get(base + "/readyz")[0] == 200
        counts = _histogram_counts(get(base + "/metrics")[1])
        for name in ("scheduler_e2e_scheduling_seconds",
                     "scheduler_scheduling_algorithm_seconds",
                     "scheduler_binding_seconds"):
            assert counts.get(name, 0) >= 1, (name, counts)
        tid = jcs.pods.get("traced").metadata.annotations[jt.TRACE_ID_ANNOTATION]
        assert tid
        status, body = get(f"{base}/debug/traces?trace={tid}")
        doc = json.loads(body)
        assert status == 200 and doc["component"] == "scheduler"
        spans = {s["name"]: s for s in doc["spans"]}
        assert {"scheduler.schedule", "scheduler.bind"} <= set(spans), doc
        assert all(s["traceId"] == tid for s in doc["spans"])
        assert spans["scheduler.schedule"]["fields"]["pod"] == "default/traced"
    finally:
        sched.stop()
        tcs.close()
        jcs.close()
        master.stop()
