"""The apiserver's storage: the in-memory MVCC store and its watch cache."""

from .cacher import Cacher  # noqa: F401
from .store import StopUpdate, Store, Watcher  # noqa: F401
