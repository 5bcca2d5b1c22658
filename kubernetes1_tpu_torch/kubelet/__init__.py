"""The port's kubelet: the node agent that admits each bound pod against
the node's cards (``devicemanager``), starts its containers with the
device plugin's injection (``runtime``), and reports its status
(``kubelet``), with its volumes, probes, eviction and HTTP server.  Run it as ``python -m kubernetes1_tpu_torch kubelet``."""

from .devicemanager import DeviceManager  # noqa: F401
from .kubelet import Kubelet  # noqa: F401
from .runtime import ContainerConfig, FakeRuntime, ProcessRuntime, RuntimeService  # noqa: F401
