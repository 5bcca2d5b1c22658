"""The port's scheduler: the JAX package's scheduler (queue, cache,
predicates, priorities, gang placement, preemption) over the port's typed
client, picking a pod's cards by NVLink domain and minor
(``nvidia.com/gpu/nvlink-domain``, ``nvidia.com/gpu/minor``).  Run it as
``python -m kubernetes1_tpu_torch scheduler --server URL``."""

from .cache import NodeInfo, SchedulerCache  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
