"""Controller manager (ref: cmd/kube-controller-manager/app/
controllermanager.go:334-363): runs every control loop of the port over
one shared informer factory.  The port's copy of the JAX package's
``controllers/manager.py``, with the loops the port has (see
``controllers/__init__.py``) and no leader election."""

from __future__ import annotations

import threading

from ..client.clientset import Clientset
from .certificates import CertificateController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .endpoints import EndpointsController
from .job import JobController
from .namespace import GarbageCollector, NamespaceController
from .nodelifecycle import NodeLifecycleController
from .podgc import PodGCController
from .replicaset import ReplicaSetController
from .serviceaccount import ServiceAccountController
from .ttl import TTLAfterFinishedController


class ControllerManager:
    def __init__(
        self,
        clientset: Clientset,
        monitor_grace: float = 40.0,
        eviction_timeout: float = 300.0,
        sa_signing_key: str = "ktpu-sa-key",
        ca_cert_pem: str = "",
        ca_key: str = "",
        endpoints_coalesce_window: float = 0.0,  # s; 0 = write per event
    ):
        self.cs = clientset
        self.factory = clientset.informers()
        self.controllers = [
            JobController(clientset, self.factory),
            ReplicaSetController(clientset, self.factory),
            DeploymentController(clientset, self.factory),
            NamespaceController(clientset, self.factory),
            GarbageCollector(clientset, self.factory),
            EndpointsController(clientset, self.factory,
                                coalesce_window=endpoints_coalesce_window),
            ServiceAccountController(clientset, self.factory,
                                     signing_key=sa_signing_key),
            DisruptionController(clientset, self.factory),
            PodGCController(clientset, self.factory),
            TTLAfterFinishedController(clientset, self.factory),
        ]
        if ca_cert_pem:  # the CSR signer, with the cluster CA
            self.controllers.append(CertificateController(clientset, self.factory,
                                                          ca_cert_pem, ca_key))
        self.node_lifecycle = NodeLifecycleController(
            clientset,
            self.factory,
            monitor_grace=monitor_grace,
            eviction_timeout=eviction_timeout,
        )
        self._started = threading.Event()

    def start(self):
        if self._started.is_set():
            return self
        self._started.set()
        for c in self.controllers:
            c.setup()
        self.factory.start_all()
        self.factory.wait_for_sync()
        for c in self.controllers:
            c.start_workers()
        self.node_lifecycle.start()
        return self

    def stop(self):
        for c in self.controllers:
            c.stop()
        self.node_lifecycle.stop()
        self.factory.stop_all()
