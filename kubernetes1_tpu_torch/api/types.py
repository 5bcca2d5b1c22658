"""The orchestrator's API types that the port's control-plane components
decode: pods, nodes, bindings, events, disruption budgets and evictions,
with the device model of pod-level extended resources.

The port's copy of the JAX package's ``api/types.py``, cut to the kinds
the scheduler reads and writes.  The wire form is the same: the same
dataclasses, field names and defaults, so ``machinery.scheme`` encodes
and decodes exactly what the JAX apiserver stores and serves.

A device's attributes are free-form strings under a vendor prefix.  The
port's scheduler reads the ``nvidia.com/gpu/`` keys that both GPU plugins
publish: a card's NVLink domain (``ATTR_GPU_NVLINK_DOMAIN``) and its
minor (``ATTR_GPU_MINOR``), where the JAX scheduler reads a TPU chip's
slice and coordinates.  The ``google.com/tpu/`` keys stay beside them,
since the JAX control plane still serves the same objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..machinery.meta import KObject, ObjectMeta

# ----------------------------------------------------------------- constants

POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
POD_UNKNOWN = "Unknown"

DEVICE_HEALTHY = "Healthy"
DEVICE_UNHEALTHY = "Unhealthy"

NODE_READY = "Ready"

# Well-known GPU attribute keys, as the port's plugins publish them.
ATTR_GPU_MODEL = "nvidia.com/gpu/model"                  # e.g. NVIDIA H100 80GB HBM3
ATTR_GPU_MEMORY = "nvidia.com/gpu/memory"                # MiB
ATTR_GPU_UUID = "nvidia.com/gpu/uuid"
ATTR_GPU_NVLINK_DOMAIN = "nvidia.com/gpu/nvlink-domain"  # the cards one NVLink fabric joins
ATTR_GPU_MINOR = "nvidia.com/gpu/minor"                  # the card's minor (its index when fake)

# Well-known TPU attribute keys (the JAX package's device plane).
ATTR_TPU_TYPE = "google.com/tpu/type"            # e.g. v5e, v5p
ATTR_TPU_TOPOLOGY = "google.com/tpu/topology"    # e.g. 2x2x1, 4x4x8
ATTR_TPU_SLICE = "google.com/tpu/slice"          # slice/ICI-domain id
ATTR_TPU_HOST_INDEX = "google.com/tpu/host-index"
ATTR_TPU_CHIP_COORDS = "google.com/tpu/coords"   # x,y,z within slice
ATTR_TPU_CORES_PER_CHIP = "google.com/tpu/cores-per-chip"

# Annotation carrying the scheduler's nominated node during preemption
# (ref: scheduler.go NominatedNodeAnnotationKey).
NOMINATED_NODE_ANNOTATION = "scheduler.ktpu.io/nominated-node"
# Marker on the Conflict message the apiserver answers when a bind would
# give a device to two pods: the scheduler re-queues the pod on it instead
# of treating the Conflict as "already bound".
DEVICE_CLAIM_CONFLICT = "device claim conflict"
# The trace id the apiserver stamps on a pod from its creating request, so
# the scheduler's spans join the pod's trace.
TRACE_ID_ANNOTATION = "trace.ktpu.io/trace-id"
# The wall-clock second (as "%.6f") at which the scheduler picked the
# pod's node and devices, carried on the Binding and merged into the pod.
SCHEDULED_AT_ANNOTATION = "slo.ktpu.io/scheduled-at"

# --------------------------------------------------------------- shared bits



@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = ""  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None


# ----------------------------------------------------- extended resources v2


@dataclass
class ResourceSelectorRequirement:
    """One attribute-affinity term (ref: types.go ResourceSelector)."""

    key: str = ""  # e.g. nvidia.com/gpu/model
    operator: str = "In"  # In | NotIn | Exists | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class ResourceAffinity:
    required: List[ResourceSelectorRequirement] = field(default_factory=list)


@dataclass
class PodExtendedResource:
    """A pod-level device request (ref: types.go PodExtendedResource).

    `assigned` is filled by the scheduler at bind time and is the durable
    record of which chip IDs the pod owns — the fork's restart-safe
    "checkpoint in the API object" design (storage.go:186).
    """

    name: str = ""  # unique within pod; containers reference it
    resource: str = ""  # e.g. nvidia.com/gpu
    quantity: int = 0
    affinity: Optional[ResourceAffinity] = None
    assigned: List[str] = field(default_factory=list)


@dataclass
class ExtendedResourceDevice:
    id: str = ""
    health: str = DEVICE_HEALTHY
    attributes: Dict[str, str] = field(default_factory=dict)


# NodeStatus.extended_resources: {resource name: [devices]}
ExtendedResourceMap = Dict[str, List[ExtendedResourceDevice]]


# ------------------------------------------------------------------ pod spec


@dataclass
class ConfigMapKeySelector:
    name: str = ""
    key: str = ""
    optional: bool = False


@dataclass
class SecretKeySelector:
    name: str = ""
    key: str = ""
    optional: bool = False


@dataclass
class ObjectFieldSelector:
    """Downward API (ref: pkg/fieldpath/fieldpath.go) — supported paths:
    metadata.name, metadata.namespace, metadata.uid, metadata.labels['k'],
    metadata.annotations['k'], spec.nodeName, spec.serviceAccountName,
    status.podIP, status.hostIP."""

    field_path: str = ""


@dataclass
class EnvVarSource:
    config_map_key_ref: Optional[ConfigMapKeySelector] = None
    secret_key_ref: Optional[SecretKeySelector] = None
    field_ref: Optional[ObjectFieldSelector] = None


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""
    value_from: Optional[EnvVarSource] = None


@dataclass
class ConfigMapEnvSource:
    name: str = ""
    optional: bool = False


@dataclass
class SecretEnvSource:
    name: str = ""
    optional: bool = False


@dataclass
class EnvFromSource:
    """envFrom: import a whole ConfigMap/Secret as env vars
    (ref: kubelet_pods.go:591 makeEnvironmentVariables)."""

    prefix: str = ""
    config_map_ref: Optional[ConfigMapEnvSource] = None
    secret_ref: Optional[SecretEnvSource] = None


@dataclass
class ContainerPort:
    name: str = ""
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    read_only: bool = False
    sub_path: str = ""


@dataclass
class HostPathVolumeSource:
    path: str = ""


@dataclass
class EmptyDirVolumeSource:
    medium: str = ""


@dataclass
class KeyToPath:
    key: str = ""
    path: str = ""


@dataclass
class ConfigMapVolumeSource:
    name: str = ""
    items: List[KeyToPath] = field(default_factory=list)  # empty = all keys
    optional: bool = False


@dataclass
class SecretVolumeSource:
    secret_name: str = ""
    items: List[KeyToPath] = field(default_factory=list)
    optional: bool = False


@dataclass
class PersistentVolumeClaimVolumeSource:
    claim_name: str = ""


@dataclass
class DownwardAPIVolumeFile:
    path: str = ""
    field_ref: Optional[ObjectFieldSelector] = None


@dataclass
class DownwardAPIVolumeSource:
    items: List[DownwardAPIVolumeFile] = field(default_factory=list)


@dataclass
class Volume:
    name: str = ""
    host_path: Optional[HostPathVolumeSource] = None
    empty_dir: Optional[EmptyDirVolumeSource] = None
    config_map: Optional[ConfigMapVolumeSource] = None
    secret: Optional[SecretVolumeSource] = None
    persistent_volume_claim: Optional[PersistentVolumeClaimVolumeSource] = None
    downward_api: Optional[DownwardAPIVolumeSource] = None


@dataclass
class ResourceRequirements:
    limits: Dict[str, Any] = field(default_factory=dict)
    requests: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExecAction:
    command: List[str] = field(default_factory=list)


@dataclass
class HTTPGetAction:
    path: str = "/"
    port: int = 0
    host: str = ""


@dataclass
class TCPSocketAction:
    port: int = 0
    host: str = ""


@dataclass
class Probe:
    exec_action: Optional[ExecAction] = None
    http_get: Optional[HTTPGetAction] = None
    tcp_socket: Optional[TCPSocketAction] = None
    initial_delay_seconds: int = 0
    period_seconds: int = 10
    timeout_seconds: int = 1
    failure_threshold: int = 3
    success_threshold: int = 1


@dataclass
class SecurityContext:
    """Per-container security settings (ref: core/v1 SecurityContext +
    pkg/securitycontext): who the process runs as and whether it may touch
    privileged host resources (/dev/nvidia* hostPaths on a GPU host)."""

    run_as_user: Optional[int] = None
    run_as_group: Optional[int] = None
    run_as_non_root: Optional[bool] = None
    privileged: Optional[bool] = None


@dataclass
class PodSecurityContext:
    """Pod-level defaults every container inherits unless it overrides
    (ref: core/v1 PodSecurityContext; DetermineEffectiveSecurityContext)."""

    run_as_user: Optional[int] = None
    run_as_group: Optional[int] = None
    run_as_non_root: Optional[bool] = None


@dataclass
class Container:
    name: str = ""
    image: str = ""
    image_pull_policy: str = ""  # "" = IfNotPresent default | Always | Never
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    working_dir: str = ""
    env: List[EnvVar] = field(default_factory=list)
    env_from: List[EnvFromSource] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    security_context: Optional[SecurityContext] = None
    # Names of PodSpec.extended_resources entries this container consumes
    # (ref: types.go:2202-2204).
    extended_resource_requests: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"
    values: List[str] = field(default_factory=list)


@dataclass
class NodeAffinityTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    """Ref: core/v1 PodAffinityTerm (types.go) — co-locate (or anti-) with
    pods matching `label_selector` within one `topology_key` domain.

    Topology keys beyond node labels:
    - kubernetes.io/hostname        -> the node itself
    - nvidia.com/gpu-nvlink-domain  -> the NVLink domain the node's cards
      belong to (resolved from device attributes, so a trainer can require
      co-location with its parameter server on one NVLink fabric)."""

    label_selector: Optional[LabelSelector] = None
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)  # empty = pod's own


@dataclass
class PreferredSchedulingTerm:
    """Ref: core/v1 PreferredSchedulingTerm — a weighted soft node-affinity
    preference (preferredDuringSchedulingIgnoredDuringExecution)."""

    weight: int = 1  # 1-100
    preference: NodeAffinityTerm = field(default_factory=NodeAffinityTerm)


@dataclass
class Affinity:
    # required node affinity terms are ORed; expressions within a term ANDed
    node_affinity_required: List[NodeAffinityTerm] = field(default_factory=list)
    # soft preferences scored by the NodeAffinity priority
    # (priorities/node_affinity.go)
    node_affinity_preferred: List[PreferredSchedulingTerm] = field(default_factory=list)
    # requiredDuringSchedulingIgnoredDuringExecution pod (anti-)affinity:
    # every term must be satisfied (ref predicates.go:1036-1044)
    pod_affinity_required: List[PodAffinityTerm] = field(default_factory=list)
    pod_anti_affinity_required: List[PodAffinityTerm] = field(default_factory=list)


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    volumes: List[Volume] = field(default_factory=list)
    restart_policy: str = "Always"  # Always | OnFailure | Never
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    priority: int = 0
    priority_class_name: str = ""
    scheduler_name: str = "default-scheduler"
    termination_grace_period_seconds: int = 30
    active_deadline_seconds: Optional[int] = None
    host_network: bool = False
    service_account_name: str = ""
    security_context: Optional[PodSecurityContext] = None
    # fork v2: pod-level device requests with attribute affinity
    extended_resources: List[PodExtendedResource] = field(default_factory=list)
    # gang scheduling (multi-host Jobs): pods sharing
    # (namespace, scheduling_gang) bind all-or-nothing over gang_size pods.
    scheduling_gang: str = ""
    gang_size: int = 0


@dataclass
class ContainerStateRunning:
    started_at: str = ""


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    message: str = ""
    started_at: str = ""
    finished_at: str = ""


@dataclass
class ContainerStateWaiting:
    reason: str = ""
    message: str = ""


@dataclass
class ContainerState:
    waiting: Optional[ContainerStateWaiting] = None
    running: Optional[ContainerStateRunning] = None
    terminated: Optional[ContainerStateTerminated] = None


@dataclass
class ContainerStatus:
    name: str = ""
    state: ContainerState = field(default_factory=ContainerState)
    ready: bool = False
    restart_count: int = 0
    image: str = ""
    container_id: str = ""


@dataclass
class PodCondition:
    type: str = ""  # PodScheduled | Ready | Initialized | ContainersReady
    status: str = ""  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: str = ""


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    conditions: List[PodCondition] = field(default_factory=list)
    message: str = ""
    reason: str = ""
    host_ip: str = ""
    pod_ip: str = ""
    start_time: str = ""
    container_statuses: List[ContainerStatus] = field(default_factory=list)


@dataclass
class Pod(KObject):
    KIND = "Pod"
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


# --------------------------------------------------------------------- node


@dataclass
class NodeSystemInfo:
    machine_id: str = ""
    kernel_version: str = ""
    os_image: str = ""
    container_runtime_version: str = ""
    kubelet_version: str = ""
    architecture: str = ""


@dataclass
class NodeCondition:
    type: str = ""  # Ready | MemoryPressure | DiskPressure
    status: str = ""
    reason: str = ""
    message: str = ""
    last_heartbeat_time: str = ""
    last_transition_time: str = ""


@dataclass
class NodeAddress:
    type: str = ""  # InternalIP | Hostname
    address: str = ""


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)
    pod_cidr: str = ""
    provider_id: str = ""


@dataclass
class NodeStatus:
    capacity: Dict[str, Any] = field(default_factory=dict)
    allocatable: Dict[str, Any] = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)
    addresses: List[NodeAddress] = field(default_factory=list)
    node_info: NodeSystemInfo = field(default_factory=NodeSystemInfo)
    # fork: per-device inventory with attributes (types.go:3848-3850),
    # published by kubelet from the device manager's store
    # (kubelet_node_status.go:552-621)
    extended_resources: Dict[str, List[ExtendedResourceDevice]] = field(default_factory=dict)
    images: List[str] = field(default_factory=list)


@dataclass
class Node(KObject):
    KIND = "Node"
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)


# ------------------------------------------------------------------- binding


@dataclass
class Binding(KObject):
    """Scheduler -> apiserver: bind pod to node + carry assigned device IDs
    (ref: types.go:4493-4495, registry/core/pod/storage/storage.go:138-195).

    `extended_resource_assignments` maps PodExtendedResource.name -> chip IDs.
    """

    KIND = "Binding"
    target_node: str = ""
    extended_resource_assignments: Dict[str, List[str]] = field(default_factory=dict)





@dataclass
class ObjectReference:
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event(KObject):
    KIND = "Event"
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    count: int = 1
    source_component: str = ""
    first_timestamp: str = ""
    last_timestamp: str = ""


# -------------------------------------------------------------------- lease





@dataclass
class PodDisruptionBudgetSpec:
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0
    observed_generation: int = 0


@dataclass
class PodDisruptionBudget(KObject):
    """Ref: policy/v1beta1 PDB + pkg/controller/disruption; consulted by the
    eviction subresource and `ktpu drain`."""

    KIND = "PodDisruptionBudget"
    API_VERSION = "policy/v1"
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)


@dataclass
class Eviction(KObject):
    """Eviction subresource payload (ref: policy/v1beta1 Eviction,
    pkg/registry/core/pod/storage/eviction.go:57): POST to
    /pods/<name>/eviction deletes the pod only if no matching
    PodDisruptionBudget would be violated; 429 otherwise."""

    KIND = "Eviction"
    API_VERSION = "policy/v1"
    grace_period_seconds: Optional[int] = None


