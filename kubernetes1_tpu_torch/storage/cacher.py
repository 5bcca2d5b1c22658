"""Watch cache: the apiserver's in-memory read layer over the store, the
port's copy of the JAX package's ``storage/cacher.py`` (ref:
staging/src/k8s.io/apiserver/pkg/storage/cacher/cacher.go).

Every GET, LIST and WATCH of the apiserver is answered here, from a
revision-ordered view of the committed wire dicts, so the store sees one
commit hook instead of a watch per client:

- the store feeds the cache from its commit path (``add_commit_hook``),
  one call per commit under the store's lock, seeded before the
  apiserver serves, so the cache is never behind the store;
- selector indexes (``spec.nodeName`` of pods) answer an equality field
  selector's LIST in O(matches), and bucket the watchers that present one
  so a commit's fan-out touches only the interested ones;
- watches resume from the cache's own history window; resuming below its
  floor raises TooOldResourceVersion (410) and the client relists.  Slow
  consumers are evicted through the bounded Watcher queue.

The JAX cacher's pump mode over a remote store is left out (ROADMAP).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..machinery.errors import TooOldResourceVersion
from ..machinery.watch import DELETED, WatchEvent
from .store import Watcher, collection_of, history_index

PREFIX = "/registry/"

# Declared field-selector indexes, per resource: field (dotted wire path)
# -> the bucket value of an object that lacks it (the registry's field
# selector default for the same field).  Every cacher keeps the same set.
# An index only narrows the candidates: readers re-check the whole
# selector, so it can never drop an object the scan would return.
_SELECTOR_INDEXES: Dict[str, Dict[str, str]] = {"pods": {"spec.nodeName": ""}}


def selector_indexes(resource: str) -> Dict[str, str]:
    """field -> missing-value default for the resource ({}: unindexed)."""
    return _SELECTOR_INDEXES.get(resource, {})


def index_value(d: Dict[str, Any], field: str, default: str = "") -> str:
    """The indexed field's bucket value in an encoded wire dict."""
    cur: Any = d
    for part in field.split("."):
        if not isinstance(cur, dict):
            cur = None
            break
        cur = cur.get(part)
    return default if cur is None else str(cur)


class Cacher:
    """In-memory, revision-ordered view of one store."""

    # the cache's resume window; an evicted watcher relists against the cache
    HISTORY_LIMIT = 16384

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()  # guards the whole view
        self._data: Dict[str, Tuple[int, Dict[str, Any]]] = {}
        self._by_collection: Dict[str, set] = {}
        # collection -> field -> value -> keys, updated with the data map
        self._indexes: Dict[str, Dict[str, Dict[str, set]]] = {}
        self._history: List[Tuple[int, str, str, Dict[str, Any]]] = []
        self._rev = 0
        self._compacted_rev = 0
        self._watchers: List[Watcher] = []
        # watch dispatch: watchers with an equality hint on a declared
        # index sit in a bucket, (collection, field) -> value -> watchers;
        # the rest on the scan list
        self._watch_index: Dict[Tuple[str, str], Dict[str, List[Watcher]]] = {}
        self._scan_watchers: List[Watcher] = []
        # commits between the hook's registration and the seed list
        self._pending_records: Optional[List[tuple]] = []
        self.watch_evictions = 0
        self._evict_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Cacher":
        # hook first, so that no commit is missed; the seed then applies
        # the records that raced in between
        self._store.add_commit_hook(self._on_commit_batch)
        entries, rev = self._store.list_raw(PREFIX)
        self._seed(entries, rev)
        return self

    def stop(self):
        self._store.remove_commit_hook(self._on_commit_batch)
        with self._lock:
            watchers, self._watchers = self._watchers, []
            self._watch_index = {}
            self._scan_watchers = []
        for w in watchers:
            w.stop()

    def _note_watch_eviction(self):
        with self._evict_lock:
            self.watch_evictions += 1

    def _remove_watcher(self, w: Watcher):
        with self._lock:
            self._unregister_watcher_locked(w)

    def _unregister_watcher_locked(self, w: Watcher):
        """Must hold _lock: drop the watcher and its dispatch route."""
        if w not in self._watchers:
            return
        self._watchers.remove(w)
        hint = w.dispatch_hint
        if hint is None:
            if w in self._scan_watchers:
                self._scan_watchers.remove(w)
            return
        coll, field, value = hint
        buckets = self._watch_index.get((coll, field)) or {}
        bucket = buckets.get(value) or []
        if w in bucket:
            bucket.remove(w)
            if not bucket:
                del buckets[value]
            if not buckets:
                del self._watch_index[(coll, field)]

    # -------------------------------------------------------------- feeding

    def _seed(self, entries, rev: int):
        with self._lock:
            self._data = {key: (r, obj) for key, r, obj in entries}
            self._by_collection = {}
            self._indexes = {}
            for key, (_r, obj) in self._data.items():
                coll = collection_of(key)
                self._by_collection.setdefault(coll, set()).add(key)
                self._index_update_locked(coll, key, None, obj)
            self._history = []
            self._rev = rev
            self._compacted_rev = rev
            pending, self._pending_records = self._pending_records, None
            raced = [r for r in (pending or ()) if r[0] > rev]
            if raced:
                self._apply_batch_locked(raced)

    def _on_commit_batch(self, records: List[tuple]):
        """The store's commit hook: one commit's records, under its lock."""
        records = [r for r in records if r[2].startswith(PREFIX)]
        if not records:
            return
        with self._lock:
            if self._pending_records is not None:  # the hook beat the seed
                self._pending_records.extend(records)
                return
            self._apply_batch_locked(records)

    def _apply_batch_locked(self, records: List[tuple]):
        """Must hold _lock: fold one commit into the view and push each
        interested watcher its events once.  An event reaches the buckets
        of its old and its new indexed value (an update that moves the
        value is a transition both sides' streams must see) and the scan
        list."""
        deliveries: Dict[Watcher, List[WatchEvent]] = {}
        scan = self._scan_watchers
        for rev, typ, key, obj in records:
            coll = collection_of(key)
            old = self._data.get(key)
            old_obj = None if old is None else old[1]
            if typ == DELETED:
                self._data.pop(key, None)
                keys = self._by_collection.get(coll)
                if keys is not None:
                    keys.discard(key)
                if old_obj is not None:
                    self._index_update_locked(coll, key, old_obj, None)
            else:
                self._data[key] = (rev, obj)
                self._by_collection.setdefault(coll, set()).add(key)
                self._index_update_locked(coll, key, old_obj, obj)
            self._history.append((rev, typ, key, obj))
            self._rev = max(self._rev, rev)
            ev = WatchEvent(typ, obj)
            for w in scan:
                if key.startswith(w.prefix):
                    deliveries.setdefault(w, []).append(ev)
            for field, default in _SELECTOR_INDEXES.get(coll, {}).items():
                buckets = self._watch_index.get((coll, field))
                if not buckets:
                    continue
                vals = {index_value(obj, field, default)}
                if old_obj is not None:
                    vals.add(index_value(old_obj, field, default))
                for v in vals:
                    for w in buckets.get(v, ()):
                        if key.startswith(w.prefix):
                            deliveries.setdefault(w, []).append(ev)
        if len(self._history) > self.HISTORY_LIMIT:
            drop = len(self._history) - self.HISTORY_LIMIT
            self._compacted_rev = self._history[drop - 1][0]
            del self._history[:drop]
        evicted = False
        for w, evs in deliveries.items():
            w._push_batch(evs)
            evicted = evicted or w.evicted
        if evicted:
            for w in [x for x in self._watchers if x.evicted]:
                self._unregister_watcher_locked(w)

    def _index_update_locked(self, coll: str, key: str,
                             old: Optional[Dict[str, Any]], new: Optional[Dict[str, Any]]):
        """Move ``key`` from its old bucket to its new one (either None)."""
        specs = _SELECTOR_INDEXES.get(coll)
        if not specs:
            return
        fields = self._indexes.setdefault(coll, {})
        for field, default in specs.items():
            buckets = fields.setdefault(field, {})
            oldv = None if old is None else index_value(old, field, default)
            newv = None if new is None else index_value(new, field, default)
            if oldv == newv:
                continue
            if oldv is not None:
                bucket = buckets.get(oldv)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del buckets[oldv]
            if newv is not None:
                buckets.setdefault(newv, set()).add(key)

    # ----------------------------------------------------------------- reads

    def list_raw(self, prefix: str) -> Tuple[List[Tuple[str, int, Dict[str, Any]]], int]:
        """(key, rev, encoded obj) entries under prefix, key-sorted, and the
        cache's revision."""
        with self._lock:
            keys = self._by_collection.get(collection_of(prefix))
            entries = [(key,) + self._data[key] for key in sorted(keys or ())
                       if key.startswith(prefix) and key in self._data]
            return entries, self._rev

    def list_raw_indexed(self, prefix: str, field: str, value: str):
        """The entries under prefix whose indexed ``field`` is ``value``, and
        the cache's revision; None when the collection declares no such
        index (the caller scans)."""
        coll = collection_of(prefix)
        if field not in _SELECTOR_INDEXES.get(coll, {}):
            return None
        with self._lock:
            bucket = self._indexes.get(coll, {}).get(field, {}).get(value)
            entries = [(key,) + self._data[key] for key in sorted(bucket or ())
                       if key.startswith(prefix) and key in self._data]
            return entries, self._rev

    def get_raw(self, key: str) -> Optional[Dict[str, Any]]:
        """The encoded wire dict of one key; None when absent."""
        with self._lock:
            ent = self._data.get(key)
            return None if ent is None else ent[1]

    def compacted_revision(self) -> int:
        """The floor of the history window: a list continue token anchored
        below it can no longer promise a gap-free relist."""
        with self._lock:
            return self._compacted_rev

    def current_cached_revision(self) -> int:
        with self._lock:
            return self._rev

    # ----------------------------------------------------------------- watch

    def watch(self, prefix: str, since_rev: int = 0,
              index_hint: Optional[Tuple[str, str]] = None) -> Watcher:
        """Watch prefix from the cache's history window: exactly the events
        with rev > since_rev (0: from now); below the window's floor,
        TooOldResourceVersion.  ``index_hint=(field, value)``, an equality
        requirement of the watcher's field selector on a declared index,
        buckets the watcher (undeclared fields go to the scan list)."""
        w = Watcher(self, prefix, buffering=bool(since_rev))
        with self._lock:
            if since_rev and since_rev < self._compacted_rev:
                raise TooOldResourceVersion(
                    f"revision {since_rev} compacted (floor {self._compacted_rev})")
            replay = (self._history[history_index(self._history, since_rev):]
                      if since_rev else [])
            self._watchers.append(w)
            coll = collection_of(prefix)
            w.dispatch_hint = None
            if index_hint and index_hint[0] in _SELECTOR_INDEXES.get(coll, {}):
                field, value = index_hint[0], str(index_hint[1])
                w.dispatch_hint = (coll, field, value)
                self._watch_index.setdefault((coll, field), {}).setdefault(value, []).append(w)
            else:
                self._scan_watchers.append(w)
        if since_rev:
            w._replay_and_go_live(replay)
        return w
