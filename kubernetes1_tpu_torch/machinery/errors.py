"""The apiserver's Status errors, under the name the JAX package's
control-plane code imports them by.  One hierarchy: the classes live in
the port's client (``client/errors.py``), which raises them from a Status
body, and are re-exported here."""

from ..client.errors import (  # noqa: F401
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
