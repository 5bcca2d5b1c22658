"""The API types, registered with the port's scheme under the resource
names the apiserver serves, each namespaced or not as the JAX package's
``api/__init__.py`` registers it."""

from ..machinery.scheme import global_scheme
from . import types as t

_REGISTRY = [
    # (class, plural, namespaced)
    (t.Pod, "pods", True),
    (t.Node, "nodes", False),
    (t.Binding, "bindings", True),
    (t.Namespace, "namespaces", False),
    (t.Event, "events", True),
    (t.Job, "jobs", True),
    (t.ReplicaSet, "replicasets", True),
    (t.Deployment, "deployments", True),
    (t.DaemonSet, "daemonsets", True),
    (t.StatefulSet, "statefulsets", True),
    (t.CronJob, "cronjobs", True),
    (t.Service, "services", True),
    (t.Endpoints, "endpoints", True),
    (t.ConfigMap, "configmaps", True),
    (t.PriorityClass, "priorityclasses", False),
    (t.Secret, "secrets", True),
    (t.ServiceAccount, "serviceaccounts", True),
    (t.ResourceQuota, "resourcequotas", True),
    (t.LimitRange, "limitranges", True),
    (t.HorizontalPodAutoscaler, "horizontalpodautoscalers", True),
    (t.PodDisruptionBudget, "poddisruptionbudgets", True),
    (t.Eviction, "evictions", True),
    (t.PersistentVolume, "persistentvolumes", False),
    (t.PersistentVolumeClaim, "persistentvolumeclaims", True),
    (t.StorageClass, "storageclasses", False),
    (t.CertificateSigningRequest, "certificatesigningrequests", False),
    (t.PodMetrics, "podmetrics", True),
    (t.NodeMetrics, "nodemetrics", False),
    (t.PodCustomMetrics, "podcustommetrics", True),
    (t.Role, "roles", True),
    (t.ClusterRole, "clusterroles", False),
    (t.RoleBinding, "rolebindings", True),
    (t.ClusterRoleBinding, "clusterrolebindings", False),
]

for cls, plural, namespaced in _REGISTRY:
    global_scheme.register(cls, plural, namespaced)
