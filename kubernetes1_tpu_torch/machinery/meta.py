"""Object metadata (ref: apimachinery's meta/v1 types: ObjectMeta,
OwnerReference).  Every persisted object carries ObjectMeta; the store
stamps uid, resourceVersion and creationTimestamp on create.

The port's copy of the JAX package's ``machinery/meta.py``, with the
fields and helpers that the port's components read.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    creation_timestamp: str = ""
    deletion_timestamp: Optional[str] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)
    # generateName: the server appends a random suffix on create when name == "".
    generate_name: str = ""


@dataclass
class KObject:
    """Base of every API object.  Subclasses set the class attributes KIND
    and API_VERSION and are registered with the Scheme."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND = ""
    API_VERSION = "v1"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        if self.metadata.namespace:
            return f"{self.metadata.namespace}/{self.metadata.name}"
        return self.metadata.name

    def clone(self) -> "KObject":
        """A deep copy.  Objects an informer hands out are shared with its
        other readers: clone one, then change the copy."""
        return copy.deepcopy(self)
