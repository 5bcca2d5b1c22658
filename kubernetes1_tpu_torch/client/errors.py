"""The apiserver's errors, as the port's apiserver answers them and its
client raises them.

A failed call answers with a Status body (``{"kind": "Status", "code",
"reason", "message"}``); ``ApiError.from_status`` turns it into the class
named by its reason, as the JAX package's ``machinery.ApiError`` does, and
keeps the body; ``to_status`` is the body the apiserver answers.  The port's ``machinery.errors`` re-exports these classes:
they are its one error hierarchy.  ``is_transient`` says which failures a
retry may cure, and ``retry_on_conflict`` reruns a read-modify-write that
lost a race.
"""

from __future__ import annotations

from typing import Callable, Optional, TypeVar

from ..utils.retry import Backoff

T = TypeVar("T")

# The HTTP codes of a momentarily unhappy server (an overload shed, server
# errors): the request itself was fine.
TRANSIENT_CODES = frozenset({429, 500, 502, 503, 504})
# client-go's DefaultRetry: 5 steps from a 10 ms base.
CONFLICT_STEPS = 5
CONFLICT_SLEEP = 0.01


class ApiError(Exception):
    """A failed apiserver call: ``code`` (HTTP), ``reason`` (the Status
    reason) and ``status`` (the Status body, or None)."""

    code = 500
    reason = "InternalError"

    def __init__(self, message: str = "", code: Optional[int] = None,
                 status: Optional[dict] = None):
        super().__init__(message or self.reason)
        self.message = message or self.reason
        if code is not None:
            self.code = code
        self.status = status

    def to_status(self) -> dict:
        """The Status body the apiserver answers this error with."""
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "code": self.code,
            "reason": self.reason,
            "message": self.message,
        }

    @staticmethod
    def from_status(status: dict) -> "ApiError":
        cls = _BY_REASON.get(status.get("reason", ""), ApiError)
        return cls(status.get("message", ""), code=status.get("code", cls.code),
                   status=status)


class NotFound(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExists(ApiError):
    code = 409
    reason = "AlreadyExists"


class Conflict(ApiError):
    """A stale resourceVersion on a write: re-read the object and retry."""

    code = 409
    reason = "Conflict"


class Gone(ApiError):
    """A list or watch from a compacted resourceVersion: relist."""

    code = 410
    reason = "Expired"


# The JAX package's name for the same answer.
TooOldResourceVersion = Gone


class Invalid(ApiError):
    code = 422
    reason = "Invalid"


class BadRequest(ApiError):
    code = 400
    reason = "BadRequest"


class Unauthorized(ApiError):
    code = 401
    reason = "Unauthorized"


class Forbidden(ApiError):
    code = 403
    reason = "Forbidden"


class TooManyRequests(ApiError):
    """The eviction of a pod whose disruption budget is spent, or an
    overload shed: retry later."""

    code = 429
    reason = "TooManyRequests"


_BY_REASON = {c.reason: c for c in (NotFound, AlreadyExists, Conflict, Gone, Invalid,
                                     BadRequest, Unauthorized, Forbidden, TooManyRequests)}


def is_transient(exc: BaseException) -> bool:
    """True for a failure that a retry may cure: a connection-level error,
    or a Status whose code is an overload shed or a server error.  A 410
    asks for a relist and a Conflict for a re-read, so neither is."""
    if isinstance(exc, (Gone, Conflict)):
        return False
    if isinstance(exc, ApiError):
        return exc.code in TRANSIENT_CODES
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


def retry_on_conflict(fn: Callable[[], T], steps: int = CONFLICT_STEPS,
                      sleep: float = CONFLICT_SLEEP) -> T:
    """Run ``fn``, a whole read-modify-write that reads the object afresh
    each time, retrying on Conflict with jittered backoff; the last
    attempt's Conflict surfaces."""
    backoff = Backoff(base=sleep, cap=sleep * 16)
    for i in range(steps):
        try:
            return fn()
        except Conflict:
            if i == steps - 1:
                raise
            backoff.sleep()
    raise AssertionError("unreachable")  # pragma: no cover
