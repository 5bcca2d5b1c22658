"""Watch event types, as the apiserver's line-delimited watch frames
(``{"type": ..., "object": ...}``) name them (ref: apimachinery's
watch.Interface)."""

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"
ERROR = "ERROR"
