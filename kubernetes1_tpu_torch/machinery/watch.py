"""Watch event types, as the apiserver's line-delimited watch frames
(``{"type": ..., "object": ...}``) name them (ref: apimachinery's
watch.Interface), and the event a store or watch cache delivers."""

from dataclasses import dataclass
from typing import Any

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"
ERROR = "ERROR"


@dataclass
class WatchEvent:
    type: str
    object: Any  # the committed wire dict, or a Status dict for ERROR
