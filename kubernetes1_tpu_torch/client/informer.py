"""A list+watch cache of one resource, with handlers, over the port's client.

``SharedInformer`` lists, then watches from the list's resourceVersion.
When the watch ends, or the apiserver answers 410 (a compacted version),
it lists again and dispatches the difference against its cache: an object
new to the cache as an add, a changed one as an update, and one that went
while it was away as a delete, so no handler misses a delete.  Handlers
run on the informer's own thread, one event at a time, in order.
``InformerFactory`` keeps one informer per resource.

An informer caches the wire-form dicts, or, given ``decode`` (a function
of a wire dict, as ``clientset.Clientset.informers`` passes the scheme's
decoder), the typed objects it makes of them: the typed layer the port's
scheduler reads, over the same list and watch.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from ..machinery import watch
from ..utils.retry import Backoff
from .errors import ApiError
from .rest import Client, ResourceClient


def object_key(obj) -> str:
    """``namespace/name`` (``name`` alone for a cluster-scoped object) of a
    wire dict or a typed object."""
    if not isinstance(obj, dict):
        return obj.key()
    meta = obj.get("metadata") or {}
    ns = meta.get("namespace")
    return f"{ns}/{meta.get('name')}" if ns else meta.get("name", "")


class SharedInformer:
    def __init__(self, client: ResourceClient, namespace: str = "",
                 label_selector: str = "",
                 decode: Optional[Callable[[dict], Any]] = None):
        self.client = client
        self.namespace = namespace
        self.label_selector = label_selector
        self._decode = decode or (lambda obj: obj)
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._handlers: List[Dict[str, Optional[Callable]]] = []
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self._backoff = Backoff(base=0.2, cap=2.0)
        self.relists = 0

    def add_handler(self, on_add: Optional[Callable[[dict], None]] = None,
                    on_update: Optional[Callable[[dict, dict], None]] = None,
                    on_delete: Optional[Callable[[dict], None]] = None):
        self._handlers.append({"add": on_add, "update": on_update, "delete": on_delete})

    def start(self) -> "SharedInformer":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"informer-{self.client.resource}")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        stream = self._stream
        if stream is not None:
            stream.close()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def has_synced(self) -> bool:
        return self._synced.is_set()

    def list(self) -> List[Any]:
        """The cached objects, shared with every handler: read, do not change."""
        with self._lock:
            return list(self._cache.values())

    def get(self, key: str) -> Any:
        """The cached object under ``namespace/name``, or None."""
        with self._lock:
            return self._cache.get(key)

    # ---------------------------------------------------------------- loop

    def _dispatch(self, kind: str, *args):
        for h in self._handlers:
            fn = h[kind]
            if fn is not None:
                try:
                    fn(*args)
                except Exception:  # noqa: BLE001 - a handler's fault must not end the informer
                    traceback.print_exc()

    def _relist(self) -> str:
        items, rv = self.client.list(self.namespace, self.label_selector)
        fresh = {object_key(o): self._decode(o) for o in items}
        with self._lock:
            old, self._cache = self._cache, fresh
        self.relists += 1
        for key, obj in fresh.items():
            if key in old:
                self._dispatch("update", old[key], obj)
            else:
                self._dispatch("add", obj)
        for key, obj in old.items():
            if key not in fresh:
                self._dispatch("delete", obj)
        self._synced.set()
        return rv

    def _watch(self, rv: str):
        """Apply one watch stream from ``rv`` until it ends."""
        stream = self._stream = self.client.watch(self.namespace, self.label_selector, rv)
        try:
            if self._stop.is_set():
                return
            for kind, obj in stream:
                if self._stop.is_set():
                    return
                if kind == watch.ERROR:
                    return  # 410 in the stream: relist
                if kind == watch.BOOKMARK:
                    continue
                obj = self._decode(obj)
                key = object_key(obj)
                with self._lock:
                    old = self._cache.pop(key, None) if kind == watch.DELETED else \
                        self._cache.get(key)
                    if kind != watch.DELETED:
                        self._cache[key] = obj
                if kind == watch.DELETED:
                    self._dispatch("delete", obj if old is None else old)
                elif old is None:
                    self._dispatch("add", obj)
                else:
                    self._dispatch("update", old, obj)
        finally:
            self._stream = None
            stream.close()

    def _run(self):
        while not self._stop.is_set():
            try:
                rv = self._relist()
                self._backoff.reset()
                self._watch(rv)
            except (ApiError, OSError):
                pass  # relist after a backoff: the apiserver is away, or refused (410 too)
            except Exception:  # noqa: BLE001 - keep the informer alive, loudly
                traceback.print_exc()
            self._stop.wait(self._backoff.next())


class InformerFactory:
    """One shared informer per resource (all namespaces, no selector).
    ``decode(plural, wire_dict)``, when given, makes every informer's
    cache typed."""

    def __init__(self, client: Client,
                 decode: Optional[Callable[[str, dict], Any]] = None):
        self.client = client
        self._decode = decode
        self._informers: Dict[str, SharedInformer] = {}
        self._lock = threading.Lock()

    def informer(self, plural: str) -> SharedInformer:
        with self._lock:
            if plural not in self._informers:
                decode = None if self._decode is None else \
                    (lambda obj, _p=plural: self._decode(_p, obj))
                self._informers[plural] = SharedInformer(self.client.resource(plural),
                                                         decode=decode)
            return self._informers[plural]

    def _all(self) -> List[SharedInformer]:
        with self._lock:
            return list(self._informers.values())

    def start_all(self):
        for inf in self._all():
            inf.start()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return all(inf.wait_for_sync(timeout) for inf in self._all())

    def stop_all(self):
        for inf in self._all():
            inf.stop()
