"""The port's controller manager: the JAX package's control loops over the
port's typed client (``client/clientset.py``) and informers.

Job (Indexed and gang Jobs, whose pods carry the ``gpu.ktpu.io`` rank
stamps), ReplicaSet (with creation and deletion expectations and the
reference's scale-down order), Deployment, Endpoints, Namespace, the
garbage collector, ServiceAccount tokens, PodDisruptionBudget status, pod
GC, TTL-after-finished and node lifecycle.  Run them as ``python -m
kubernetes1_tpu_torch controller-manager --server URL``.
"""

from .deployment import DeploymentController  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
from .endpoints import EndpointsController  # noqa: F401
from .job import JobController  # noqa: F401
from .manager import ControllerManager  # noqa: F401
from .namespace import GarbageCollector, NamespaceController  # noqa: F401
from .nodelifecycle import NodeLifecycleController  # noqa: F401
from .podgc import PodGCController  # noqa: F401
from .replicaset import ReplicaSetController  # noqa: F401
from .serviceaccount import ServiceAccountController  # noqa: F401
from .ttl import TTLAfterFinishedController  # noqa: F401
