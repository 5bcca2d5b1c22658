"""API machinery: the typed object model and its wire form, label
selectors, the Status errors and the watch event types.

The port's copy of what the JAX package's ``machinery`` gives its
control-plane components (``meta``, ``scheme``, ``labels``, ``errors``,
``watch``): the same dataclass-based objects, round-tripped to the same
camelCase JSON.
"""

from .errors import (  # noqa: F401
    AlreadyExists,
    ApiError,
    BadRequest,
    Conflict,
    Forbidden,
    Gone,
    Invalid,
    NotFound,
    TooManyRequests,
    TooOldResourceVersion,
    Unauthorized,
)
from .labels import label_selector_matches, match_labels  # noqa: F401
from .meta import KObject, ObjectMeta, OwnerReference, now_iso  # noqa: F401
from .scheme import Scheme, from_dict, global_scheme, to_dict  # noqa: F401
