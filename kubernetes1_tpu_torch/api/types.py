"""The orchestrator's API types: pods, nodes, bindings, events, disruption
budgets and evictions, with the device model of pod-level extended
resources, and the other kinds the port's apiserver stores and serves
(namespaces, the workload controllers' kinds, services and endpoints,
config, quota, volumes, CSRs, autoscalers and the metrics kinds).

The port's copy of the JAX package's ``api/types.py``, cut to the kinds
the port's scheduler and apiserver read and write.  The wire form is the
same: the same dataclasses, field names and defaults, so
``machinery.scheme`` encodes and decodes exactly what the JAX apiserver
stores and serves.

A device's attributes are free-form strings under a vendor prefix.  The
port's scheduler reads the ``nvidia.com/gpu/`` keys that both GPU plugins
publish: a card's NVLink domain (``ATTR_GPU_NVLINK_DOMAIN``) and its
minor (``ATTR_GPU_MINOR``), where the JAX scheduler reads a TPU chip's
slice and coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..machinery.meta import KObject, ObjectMeta, OwnerReference  # noqa: F401 - re-exported

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
# Server-set wall-clock stamps (as "%.6f") of the pod's create and bind.
CREATED_AT_ANNOTATION = "slo.ktpu.io/created-at"
BOUND_AT_ANNOTATION = "slo.ktpu.io/bound-at"
# The wall-clock second (as "%.6f") at which the kubelet's device admission
# (the plugin's AdmitPod included) accepted the pod on its node.
ADMITTED_AT_ANNOTATION = "slo.ktpu.io/admitted-at"
# The monotonic commit stamps a lag-stamp BOOKMARK frame carries.
COMMITTED_AT_ANNOTATION = "obs.ktpu.io/committed-at"
# The label the Job strategy puts on a Job's selector and pod template.
JOB_NAME_LABEL = "batch.ktpu.io/job-name"
# An Indexed Job's pod carries its completion index under this annotation.
COMPLETION_INDEX_ANNOTATION = "batch.ktpu.io/completion-index"
# A gang Job's current attempt: an annotation on the Job, a label on each
# member pod, so a restarted controller reads attempt membership off the API.
GANG_ATTEMPT_LABEL = "batch.ktpu.io/gang-attempt"
# Marks a kubelet's mirror pod of a static pod.
STATIC_POD_ANNOTATION = "kubelet.ktpu.io/static"

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


# ------------------------------------------- the apiserver's other kinds


@dataclass
class NamespaceStatus:
    phase: str = "Active"  # Active | Terminating


@dataclass
class Namespace(KObject):
    KIND = "Namespace"
    status: NamespaceStatus = field(default_factory=NamespaceStatus)


@dataclass
class JobSpec:
    parallelism: Optional[int] = None
    completions: Optional[int] = None
    backoff_limit: int = 6
    active_deadline_seconds: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    # Indexed completion mode (reference gap — SURVEY.md §2.1 job row):
    # each pod gets a stable completion index 0..completions-1, exposed as
    # annotation + the worker-id env; required for multi-host workers.
    completion_mode: str = "NonIndexed"  # NonIndexed | Indexed
    # Gang scheduling: all pods of the job bind atomically.
    gang_scheduling: bool = False
    # Cleanup of finished jobs (upstream ttlafterfinished design; absent in
    # the 1.9 reference where finished Jobs accumulate forever).
    ttl_seconds_after_finished: Optional[int] = None


@dataclass
class JobCondition:
    type: str = ""  # Complete | Failed
    status: str = ""
    reason: str = ""
    message: str = ""
    last_transition_time: str = ""


@dataclass
class JobStatus:
    active: int = 0
    succeeded: int = 0
    failed: int = 0
    start_time: str = ""
    completion_time: str = ""
    conditions: List[JobCondition] = field(default_factory=list)
    # Indexed mode: which indexes have succeeded, as a compact string "0-3,7"
    completed_indexes: str = ""


@dataclass
class Job(KObject):
    KIND = "Job"
    API_VERSION = "batch/v1"
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)


@dataclass
class ReplicaSetSpec:
    replicas: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    min_ready_seconds: int = 0


@dataclass
class ReplicaSetStatus:
    replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    fully_labeled_replicas: int = 0
    observed_generation: int = 0


@dataclass
class ReplicaSet(KObject):
    KIND = "ReplicaSet"
    API_VERSION = "apps/v1"
    spec: ReplicaSetSpec = field(default_factory=ReplicaSetSpec)
    status: ReplicaSetStatus = field(default_factory=ReplicaSetStatus)


@dataclass
class RollingUpdateDeployment:
    max_unavailable: Any = 1  # int or "25%"
    max_surge: Any = 1


@dataclass
class DeploymentStrategy:
    type: str = "RollingUpdate"  # RollingUpdate | Recreate
    rolling_update: RollingUpdateDeployment = field(default_factory=RollingUpdateDeployment)


@dataclass
class DeploymentSpec:
    replicas: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    strategy: DeploymentStrategy = field(default_factory=DeploymentStrategy)
    revision_history_limit: int = 10
    paused: bool = False


@dataclass
class DeploymentStatus:
    observed_generation: int = 0
    replicas: int = 0
    updated_replicas: int = 0
    ready_replicas: int = 0
    available_replicas: int = 0
    unavailable_replicas: int = 0


@dataclass
class Deployment(KObject):
    KIND = "Deployment"
    API_VERSION = "apps/v1"
    spec: DeploymentSpec = field(default_factory=DeploymentSpec)
    status: DeploymentStatus = field(default_factory=DeploymentStatus)


@dataclass
class DaemonSetSpec:
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class DaemonSetStatus:
    current_number_scheduled: int = 0
    desired_number_scheduled: int = 0
    number_ready: int = 0
    number_misscheduled: int = 0
    observed_generation: int = 0


@dataclass
class DaemonSet(KObject):
    KIND = "DaemonSet"
    API_VERSION = "apps/v1"
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)
    status: DaemonSetStatus = field(default_factory=DaemonSetStatus)


@dataclass
class RollingUpdateStatefulSetStrategy:
    partition: int = 0


@dataclass
class StatefulSetUpdateStrategy:
    type: str = "RollingUpdate"  # RollingUpdate | OnDelete
    rolling_update: Optional[RollingUpdateStatefulSetStrategy] = None


@dataclass
class StatefulSetSpec:
    replicas: Optional[int] = None
    selector: Optional[LabelSelector] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    service_name: str = ""
    # OrderedReady: create/delete one ordinal at a time; Parallel: all at once.
    pod_management_policy: str = "OrderedReady"  # OrderedReady | Parallel
    update_strategy: StatefulSetUpdateStrategy = field(
        default_factory=StatefulSetUpdateStrategy
    )


@dataclass
class StatefulSetStatus:
    observed_generation: int = 0
    replicas: int = 0
    ready_replicas: int = 0
    current_replicas: int = 0
    updated_replicas: int = 0
    current_revision: str = ""
    update_revision: str = ""


@dataclass
class StatefulSet(KObject):
    """Stable-identity workload (ref: pkg/apis/apps/types.go StatefulSet;
    controller at pkg/controller/statefulset/stateful_set.go)."""

    KIND = "StatefulSet"
    API_VERSION = "apps/v1"
    spec: StatefulSetSpec = field(default_factory=StatefulSetSpec)
    status: StatefulSetStatus = field(default_factory=StatefulSetStatus)


@dataclass
class JobTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)


@dataclass
class CronJobSpec:
    schedule: str = ""  # 5-field cron, local time
    suspend: bool = False
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    starting_deadline_seconds: Optional[int] = None
    job_template: JobTemplateSpec = field(default_factory=JobTemplateSpec)
    successful_jobs_history_limit: int = 3
    failed_jobs_history_limit: int = 1


@dataclass
class CronJobStatus:
    active: List["ObjectReference"] = field(default_factory=list)
    last_schedule_time: str = ""


@dataclass
class CronJob(KObject):
    """Scheduled Jobs (ref: pkg/apis/batch/types.go CronJob; controller at
    pkg/controller/cronjob/cronjob_controller.go)."""

    KIND = "CronJob"
    API_VERSION = "batch/v1"
    spec: CronJobSpec = field(default_factory=CronJobSpec)
    status: CronJobStatus = field(default_factory=CronJobStatus)


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    target_port: int = 0
    node_port: int = 0
    protocol: str = "TCP"


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: str = ""  # allocated from 10.96/16; "None" = headless
    type: str = "ClusterIP"  # ClusterIP | NodePort
    session_affinity: str = ""  # "" | ClientIP


@dataclass
class Service(KObject):
    KIND = "Service"
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class EndpointAddress:
    ip: str = ""
    node_name: str = ""
    # the pod this address IS (real k8s: a full ObjectReference; the
    # name suffices here).  In-process clusters assign every pod the
    # loopback ip, so pod IDENTITY — not ip — is what an L7 resolver
    # keys its backend registry on.
    target_ref: str = ""


@dataclass
class EndpointPort:
    name: str = ""
    port: int = 0
    protocol: str = "TCP"


@dataclass
class EndpointSubset:
    addresses: List[EndpointAddress] = field(default_factory=list)
    # matching pods that must NOT receive new traffic but may still be
    # finishing in-flight work: terminating (deletion_timestamp set) or
    # Running-but-not-Ready.  The explicit drain signal: an L7 balancer
    # keeps their open responses alive while picking only `addresses`.
    not_ready_addresses: List[EndpointAddress] = field(default_factory=list)
    ports: List[EndpointPort] = field(default_factory=list)


@dataclass
class Endpoints(KObject):
    KIND = "Endpoints"
    subsets: List[EndpointSubset] = field(default_factory=list)


@dataclass
class ConfigMap(KObject):
    KIND = "ConfigMap"
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class PriorityClass(KObject):
    KIND = "PriorityClass"
    API_VERSION = "scheduling/v1"
    value: int = 0
    global_default: bool = False
    description: str = ""


@dataclass
class Secret(KObject):
    """Ref: core/v1 Secret (types.go). Values are stored as plain strings
    (`stringData` semantics) — there is no base64 layer to shed."""

    KIND = "Secret"
    type: str = "Opaque"  # Opaque | kubernetes.io/service-account-token | bootstrap.kubernetes.io/token
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class ServiceAccount(KObject):
    """Ref: core/v1 ServiceAccount; token secrets minted by the token
    controller (pkg/controller/serviceaccount)."""

    KIND = "ServiceAccount"
    secrets: List[ObjectReference] = field(default_factory=list)
    automount_service_account_token: bool = True


@dataclass
class ResourceQuotaSpec:
    hard: Dict[str, str] = field(default_factory=dict)  # "pods", "requests.cpu", "nvidia.com/gpu", ...


@dataclass
class ResourceQuotaStatus:
    hard: Dict[str, str] = field(default_factory=dict)
    used: Dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceQuota(KObject):
    """Ref: core/v1 ResourceQuota; enforced by admission, recalculated by the
    resourcequota controller (pkg/controller/resourcequota)."""

    KIND = "ResourceQuota"
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)


@dataclass
class LimitRangeItem:
    type: str = "Container"  # Container | Pod
    max: Dict[str, str] = field(default_factory=dict)
    min: Dict[str, str] = field(default_factory=dict)
    default: Dict[str, str] = field(default_factory=dict)          # default limits
    default_request: Dict[str, str] = field(default_factory=dict)  # default requests


@dataclass
class LimitRangeSpec:
    limits: List[LimitRangeItem] = field(default_factory=list)


@dataclass
class LimitRange(KObject):
    """Ref: core/v1 LimitRange, applied by the LimitRanger admission plugin
    (plugin/pkg/admission/limitranger)."""

    KIND = "LimitRange"
    spec: LimitRangeSpec = field(default_factory=LimitRangeSpec)


@dataclass
class CrossVersionObjectReference:
    kind: str = ""  # Deployment | ReplicaSet | StatefulSet
    name: str = ""
    api_version: str = ""


@dataclass
class ResourceMetricSource:
    """autoscaling/v2 Resource metric: utilization of a container-requested
    resource (PodMetrics ÷ requests), percent."""

    name: str = "cpu"
    target_average_utilization: Optional[int] = None


@dataclass
class PodsMetricSource:
    """autoscaling/v2 Pods metric: a named sample scraped off each pod's
    /metrics endpoint (PodCustomMetrics), averaged across the target's
    pods and compared against `target_average_value`."""

    metric_name: str = ""
    target_average_value: float = 0.0


@dataclass
class MetricSpec:
    """One scaling signal (ref: autoscaling/v2 MetricSpec).  The HPA
    computes a desired replica count per entry and takes the MAX."""

    type: str = ""  # Resource | Pods
    resource: Optional[ResourceMetricSource] = None
    pods: Optional[PodsMetricSource] = None


@dataclass
class HorizontalPodAutoscalerSpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference
    )
    min_replicas: int = 1
    max_replicas: int = 1
    target_cpu_utilization_percentage: Optional[int] = None
    # v2-style metric specs; when non-empty they are the scaling signals
    # (target_cpu_utilization_percentage above is the v1 shorthand and
    # keeps working unchanged when `metrics` is empty)
    metrics: List[MetricSpec] = field(default_factory=list)
    # behavior stabilization windows (ref: autoscaling/v2
    # HPAScalingRules.stabilizationWindowSeconds): a scale-up takes the
    # MIN recommendation of the up-window, a scale-down the MAX of the
    # down-window — 0 (default) reacts instantly, exactly the v1 behavior
    scale_up_stabilization_seconds: float = 0.0
    scale_down_stabilization_seconds: float = 0.0


@dataclass
class HorizontalPodAutoscalerStatus:
    observed_generation: int = 0
    last_scale_time: str = ""
    current_replicas: int = 0
    desired_replicas: int = 0
    current_cpu_utilization_percentage: Optional[int] = None
    # observed per-metric averages last cycle (metric name -> value);
    # free-form map — metric names are workload-defined
    current_metric_values: Dict[str, float] = field(default_factory=dict)


@dataclass
class HorizontalPodAutoscaler(KObject):
    """Ref: autoscaling/v1 HPA; reconciled by pkg/controller/podautoscaler
    against the resource-metrics pipeline (Summary API here)."""

    KIND = "HorizontalPodAutoscaler"
    API_VERSION = "autoscaling/v1"
    spec: HorizontalPodAutoscalerSpec = field(default_factory=HorizontalPodAutoscalerSpec)
    status: HorizontalPodAutoscalerStatus = field(
        default_factory=HorizontalPodAutoscalerStatus
    )


@dataclass
class PersistentVolumeSpec:
    capacity: Dict[str, str] = field(default_factory=dict)  # {"storage": "10Gi"}
    access_modes: List[str] = field(default_factory=list)  # ReadWriteOnce | ReadOnlyMany | ReadWriteMany
    host_path: Optional[HostPathVolumeSource] = None
    storage_class_name: str = ""
    persistent_volume_reclaim_policy: str = "Retain"  # Retain | Delete | Recycle
    claim_ref: Optional[ObjectReference] = None


@dataclass
class PersistentVolumeStatus:
    phase: str = "Available"  # Available | Bound | Released | Failed


@dataclass
class PersistentVolume(KObject):
    """Ref: core/v1 PV + pkg/controller/volume/persistentvolume binder."""

    KIND = "PersistentVolume"
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(default_factory=PersistentVolumeStatus)


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: List[str] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_name: str = ""
    storage_class_name: str = ""


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = "Pending"  # Pending | Bound | Lost
    capacity: Dict[str, str] = field(default_factory=dict)
    access_modes: List[str] = field(default_factory=list)


@dataclass
class PersistentVolumeClaim(KObject):
    KIND = "PersistentVolumeClaim"
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )


@dataclass
class StorageClass(KObject):
    """Ref: pkg/apis/storage/types.go:28 — names a provisioner so PVCs can
    ask for storage that doesn't exist yet (dynamic provisioning) instead
    of binding only to pre-created PVs.

    volumeBindingMode (storage/types.go VolumeBindingMode):
      Immediate            — provision/bind as soon as the PVC appears
      WaitForFirstConsumer — hold the PVC Pending until a pod consuming it
                             is scheduled; this keeps a
                             checkpoint volume's hostPath on the node the
                             gang actually landed on."""

    KIND = "StorageClass"
    API_VERSION = "storage.k8s.io/v1"
    provisioner: str = ""
    reclaim_policy: str = "Delete"   # Delete | Retain
    volume_binding_mode: str = "Immediate"
    parameters: Dict[str, str] = field(default_factory=dict)


@dataclass
class CertificateSigningRequestSpec:
    request: str = ""  # CSR payload (PEM in the reference; opaque string here)
    usages: List[str] = field(default_factory=list)
    username: str = ""
    groups: List[str] = field(default_factory=list)


@dataclass
class CSRCondition:
    type: str = ""  # Approved | Denied
    reason: str = ""
    message: str = ""
    last_update_time: str = ""


@dataclass
class CertificateSigningRequestStatus:
    conditions: List[CSRCondition] = field(default_factory=list)
    certificate: str = ""


@dataclass
class CertificateSigningRequest(KObject):
    """Ref: certificates/v1beta1 CSR + pkg/controller/certificates (signer
    issues on Approved condition; kubelet TLS bootstrap client flow)."""

    KIND = "CertificateSigningRequest"
    API_VERSION = "certificates/v1"
    spec: CertificateSigningRequestSpec = field(
        default_factory=CertificateSigningRequestSpec
    )
    status: CertificateSigningRequestStatus = field(
        default_factory=CertificateSigningRequestStatus
    )


# --------------------------------------------------------------------- rbac


@dataclass
class PolicyRule:
    """Ref: rbac/v1 PolicyRule.  No api_groups: the flat registry has no
    group dimension."""

    verbs: List[str] = field(default_factory=list)       # get|list|watch|create|update|patch|delete|*
    resources: List[str] = field(default_factory=list)   # plural names (or "<plural>/<sub>") or *
    resource_names: List[str] = field(default_factory=list)


@dataclass
class Subject:
    kind: str = "User"  # User | Group | ServiceAccount
    name: str = ""
    namespace: str = ""


@dataclass
class RoleRef:
    kind: str = "Role"  # Role | ClusterRole
    name: str = ""


@dataclass
class Role(KObject):
    KIND = "Role"
    API_VERSION = "rbac/v1"
    rules: List[PolicyRule] = field(default_factory=list)


@dataclass
class ClusterRole(KObject):
    KIND = "ClusterRole"
    API_VERSION = "rbac/v1"
    rules: List[PolicyRule] = field(default_factory=list)


@dataclass
class RoleBinding(KObject):
    KIND = "RoleBinding"
    API_VERSION = "rbac/v1"
    subjects: List[Subject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)


@dataclass
class ClusterRoleBinding(KObject):
    KIND = "ClusterRoleBinding"
    API_VERSION = "rbac/v1"
    subjects: List[Subject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)


@dataclass
class ContainerMetrics:
    name: str = ""
    usage: Dict[str, str] = field(default_factory=dict)  # {"cpu": "250m", "memory": "64Mi"}


@dataclass
class PodMetrics(KObject):
    """Ref: staging/src/k8s.io/metrics pod metrics, fed here by each kubelet
    directly (the cadvisor → Summary API → metrics-server pipeline collapsed
    into one hop; HPA reads these)."""

    KIND = "PodMetrics"
    API_VERSION = "metrics.k8s.io/v1"
    timestamp: str = ""
    containers: List[ContainerMetrics] = field(default_factory=list)


@dataclass
class NodeMetrics(KObject):
    KIND = "NodeMetrics"
    API_VERSION = "metrics.k8s.io/v1"
    timestamp: str = ""
    usage: Dict[str, str] = field(default_factory=dict)


@dataclass
class MetricSample:
    """One named sample scraped off a pod /metrics endpoint.  `labels`
    carries the sample's own label set (a labeled child series); HPA
    Pods-metric matching is by bare `name`."""

    name: str = ""
    value: float = 0.0
    type: str = ""  # counter | gauge | rate (scrape-derived counter rate)
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class PodCustomMetrics(KObject):
    """Workload SLIs scraped off an annotated pod's /metrics endpoint by
    its node's kubelet (the custom.metrics.k8s.io pipeline collapsed into
    one hop, exactly like PodMetrics above).  `stale=True` means the last
    scrape failed and `samples` is the LAST-GOOD snapshot — consumers
    (the HPA) must treat stale samples as missing, never as fresh truth.
    The kubelet copies the pod's labels onto this object so selector
    reads work on the metrics collection directly."""

    KIND = "PodCustomMetrics"
    API_VERSION = "custom.metrics.k8s.io/v1"
    timestamp: str = ""
    stale: bool = False
    samples: List[MetricSample] = field(default_factory=list)


def effective_security_context(pod: "Pod", container: "Container") -> SecurityContext:
    """The container's settings over the pod's (ref pkg/securitycontext
    DetermineEffectiveSecurityContext)."""
    psc = pod.spec.security_context
    csc = container.security_context
    out = SecurityContext()
    if psc is not None:
        out.run_as_user = psc.run_as_user
        out.run_as_group = psc.run_as_group
        out.run_as_non_root = psc.run_as_non_root
    if csc is not None:
        if csc.run_as_user is not None:
            out.run_as_user = csc.run_as_user
        if csc.run_as_group is not None:
            out.run_as_group = csc.run_as_group
        if csc.run_as_non_root is not None:
            out.run_as_non_root = csc.run_as_non_root
        out.privileged = csc.privileged
    return out
