"""MVCC object store with CAS updates and resumable watch: the port's
copy of the JAX package's ``storage/store.py``, in memory.

The stand-in for the reference's etcd3 store (staging/src/k8s.io/
apiserver/pkg/storage/etcd3/store.go:152 Create, :263 GuaranteedUpdate,
:661 Watch):

- resourceVersion is one global, monotonically increasing revision (the
  contract of etcd's mod_revision): a list returns the store's revision,
  a watch resumes from any revision still in the history ring, and one
  below the compaction floor raises TooOldResourceVersion (HTTP 410), so
  the client relists (client-go tools/cache/reflector.go:239).
- GuaranteedUpdate is the only transaction: read, apply the caller's
  function, compare-and-swap on resourceVersion, retry on conflict.
- Every mutation commits under one lock.  ``commit_batch`` commits N
  independent operations as one run of revisions with one fan-out (the
  registry's bulk bind and batched delete), and the commit hooks (the
  watch cache) get each commit's records in one call, in revision order.

Where the JAX store queues writers for a group commit, this one takes the
lock: the revisions and the order of events are the same, only
concurrent singleton writes are never merged into one fan-out.

With ``wal_path`` every commit is appended to a write-ahead log before
its writers are answered, in the JAX store's frames byte for byte
(``<crc32 hex8>:<json>\n`` a record), and the log is replayed when the
store opens: a torn tail (a record a crash cut) is truncated away, a bad
run of lines followed by good records is skipped, and watches cannot
resume below the replayed revision.  Each commit is written, flushed and
fsynced once before its writers are answered (the JAX store's "batch"
mode; its "always" and "none" have no caller here, ROADMAP item 18), and
a line without the CRC frame is damage (the JAX store still replays bare
JSON lines from before the frames; neither package writes them).  A
commit whose log write fails is rolled out of the file, and its writers
get an error although the memory holds it (as the JAX store's).
No replication feed or snapshot (ROADMAP).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..machinery.errors import AlreadyExists, ApiError, Conflict, NotFound, TooOldResourceVersion
from ..machinery.meta import new_uid, now_iso
from ..machinery.scheme import Scheme
from ..machinery.watch import ADDED, DELETED, MODIFIED, WatchEvent

# Commit-stamp ring bound (the watch-lag SLI): revision -> monotonic
# commit stamp of the newest commits.
DEFAULT_COMMIT_TS_LIMIT = 8192


class StopUpdate(Exception):
    """Raised by a GuaranteedUpdate callback to abort without error."""


def collection_of(key: str) -> str:
    """"/registry/<resource>/..." -> "<resource>": the key-layout parser
    shared by the store's per-collection index and the watch cache."""
    parts = key.split("/", 3)
    return parts[2] if len(parts) > 2 else ""


def history_index(history, since_rev: int) -> int:
    """First index in a revision-ordered history list whose rev is
    > since_rev (binary search)."""
    lo, hi = 0, len(history)
    while lo < hi:
        mid = (lo + hi) // 2
        if history[mid][0] <= since_rev:
            lo = mid + 1
        else:
            hi = mid
    return lo


class Watcher:
    """One watch stream: ``next_timeout`` / ``next_batch_timeout`` for its
    WatchEvents, ``stop()`` to end it.

    Delivery is bounded (``QUEUE_LIMIT`` events): a
    consumer that stops draining is evicted, the stream ends with
    ``evicted`` set, and the serving layer answers 410 so the client
    relists (the reference cacher's slow-watcher contract,
    storage/cacher.go terminateAllWatchers).

    With ``buffering=True`` the watcher starts in replay mode: live pushes
    are buffered while the owner replays history outside its lock, then
    flushed in order.  The queue carries one list of events per commit;
    ``next_batch_timeout`` hands out everything deliverable at once."""

    # per-watcher delivery bound: a consumer this far behind the commit
    # stream is wedged, not slow; it is evicted (and relists) instead of
    # growing the queue without limit
    QUEUE_LIMIT = 4096

    def __init__(self, owner, prefix: str, buffering: bool = False):
        self._owner = owner
        self.prefix = prefix
        self._q: "queue.Queue[Optional[List[WatchEvent]]]" = queue.Queue()
        self._qlen = 0  # queued events (not batches), guarded by _plock
        self._buf: "deque[WatchEvent]" = deque()  # consumer thread only
        self._stopped = threading.Event()
        self.evicted = False
        self._pending: Optional[List[WatchEvent]] = [] if buffering else None
        self._plock = threading.Lock()

    def _push_batch(self, evs: List[WatchEvent]):
        """Owner side: enqueue one commit's events as one wakeup."""
        with self._plock:
            if self._pending is not None:
                self._pending.extend(evs)
                return
            self._deliver_locked(evs)

    def _deliver_locked(self, evs: List[WatchEvent]):
        """Must hold _plock: queue the batch, or evict on overflow."""
        if self._stopped.is_set():
            return
        if self._qlen >= self.QUEUE_LIMIT:
            self._evict_locked()
            return
        self._qlen += len(evs)
        self._q.put(evs)

    def _evict_locked(self, note: bool = True):
        if self._stopped.is_set():
            return
        self.evicted = True
        self._stopped.set()
        self._q.put(None)
        if note:
            self._owner._note_watch_eviction()

    def _replay_and_go_live(self, entries):
        """Deliver one history slice (taken under the owner's lock,
        filtered and delivered outside it), then flush the live events
        buffered meanwhile, in arrival order."""
        for _rev, typ, key, obj in entries:
            if self._stopped.is_set():
                break
            if key.startswith(self.prefix):
                with self._plock:
                    self._deliver_locked([WatchEvent(typ, obj)])
        with self._plock:
            for ev in self._pending:
                self._deliver_locked([ev])
            self._pending = None

    def stop(self):
        if not self._stopped.is_set():
            self._stopped.set()
            self._q.put(None)
            self._owner._remove_watcher(self)

    def _take_batch(self, batch: List[WatchEvent]):
        with self._plock:
            self._qlen -= len(batch)
        self._buf.extend(batch)

    def next_timeout(self, timeout: Optional[float]) -> Optional[WatchEvent]:
        """The next event, or None on timeout or at the stream's end."""
        if self._buf:
            return self._buf.popleft()
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is None:
            return None
        self._take_batch(item)
        return self._buf.popleft()

    def next_batch_timeout(self, timeout: float) -> Optional[List[WatchEvent]]:
        """Everything deliverable right now as one list (at least one
        event), or None on timeout or at the stream's end."""
        if not self._buf:
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                return None
            if item is None:
                return None
            self._take_batch(item)
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # the end sentinel stays for the next call
                break
            self._take_batch(nxt)
        out = list(self._buf)
        self._buf.clear()
        return out

    def progress_rv(self) -> Optional[int]:
        """Consumer thread only: a resume revision safe to hand the client
        as a progress bookmark, or None when events are queued but not yet
        delivered (a bookmark would leap past them).  The owner's revision
        is read first, under its lock; every event up to it was pushed in
        the critical section that published it, so an empty queue after
        that read means all of them reached this consumer."""
        owner = self._owner
        fn = (getattr(owner, "current_cached_revision", None)
              or getattr(owner, "current_revision", None))
        rev = fn() if fn is not None else 0
        if not rev:
            return None
        with self._plock:
            if self._qlen or self._pending is not None:
                return None
        if self._buf or not self._q.empty():
            return None
        return rev


class Store:
    """The in-memory MVCC store (see the module docstring)."""

    # keep this many events for watch resume before compaction kicks in
    HISTORY_LIMIT = 100_000

    def __init__(self, scheme: Scheme, wal_path: Optional[str] = None):
        self._scheme = scheme
        self._lock = threading.RLock()
        self._data: Dict[str, Tuple[int, Dict[str, Any]]] = {}  # key -> (rev, encoded obj)
        # first path segment after /registry/ -> keys: a list of one
        # collection scans only that collection
        self._by_collection: Dict[str, set] = {}
        self._rev = 0
        # the ring for watch resume: (rev, type, key, encoded obj)
        self._history: List[Tuple[int, str, str, Dict[str, Any]]] = []
        self._compacted_rev = 0  # watches must start above this
        self._watchers: List[Watcher] = []
        self.watch_evictions = 0
        self._stats_lock = threading.Lock()
        # synchronous commit sinks (the watch cache): fn(records), one call
        # per commit with its [(rev, typ, key, obj), ...], under the lock
        self._commit_hooks: List[Callable] = []
        self._batch_records: Optional[List[tuple]] = None  # the commit in progress
        # the watch-lag SLI: one monotonic stamp per commit, shared by its
        # records, shipped on lag-stamp bookmark frames
        self._commit_ts: Dict[int, float] = {}
        self._commit_ts_order: deque = deque()
        self._wal = None
        self.wal_torn_tail_repairs = 0  # a crash's cut record, truncated on open
        self.wal_corrupt_records_skipped = 0  # bad lines with good records after them
        self.wal_write_rollbacks = 0  # failed appends rolled out of the file
        if wal_path:
            self._replay_wal(wal_path)
            # binary and block-buffered: one write and flush a commit
            self._wal = open(wal_path, "ab")

    # ------------------------------------------------------------------- WAL

    @staticmethod
    def _wal_frame(rec: dict) -> bytes:
        """One record: ``<crc32 hex8>:<json>\n``, the CRC over the JSON, so
        replay tells a torn record from a whole one."""
        payload = json.dumps(rec).encode()
        return b"%08x:" % zlib.crc32(payload) + payload + b"\n"

    @staticmethod
    def _parse_wal_frame(line: bytes) -> Optional[dict]:
        """One log line's record, or None when it is torn or corrupt."""
        crc, sep, payload = line.strip().partition(b":")
        try:
            if not sep or len(crc) != 8 or int(crc, 16) != zlib.crc32(payload):
                return None
            rec = json.loads(payload)
            rec["rev"], rec["type"], rec["key"], rec["obj"]  # all four or torn
            return rec
        except (ValueError, KeyError, TypeError):
            return None

    def _replay_wal(self, path: str):
        """Rebuild the data and the revision from the log, before any
        other thread sees the store.  A run of bad lines still open at the
        end is the torn tail and is truncated (its writers were never
        answered); a run with good records after it is skipped, since
        truncating there would drop acknowledged writes."""
        if not os.path.exists(path):
            return
        bad_start: Optional[int] = None
        bad_lines = 0
        with open(path, "rb") as f:
            while True:
                start = f.tell()
                line = f.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                rec = self._parse_wal_frame(line)
                if rec is None:
                    if bad_start is None:
                        bad_start = start
                    bad_lines += 1
                    continue
                if bad_start is not None:
                    self.wal_corrupt_records_skipped += bad_lines
                    print(f"store: WAL corruption mid-file: skipped {bad_lines} unreadable "
                          f"line(s) at offset {bad_start} of {path}; the later records "
                          f"were replayed", flush=True)
                    bad_start, bad_lines = None, 0
                rev, typ, key = rec["rev"], rec["type"], rec["key"]
                self._rev = max(self._rev, rev)
                if typ == "NOP":  # a revision pin, no data
                    continue
                coll = collection_of(key)
                if typ == DELETED:
                    self._data.pop(key, None)
                    keys = self._by_collection.get(coll)
                    if keys is not None:
                        keys.discard(key)
                else:
                    self._data[key] = (rev, rec["obj"])
                    self._by_collection.setdefault(coll, set()).add(key)
        if bad_start is not None:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(bad_start)
            self.wal_torn_tail_repairs += 1
            print(f"store: WAL torn tail repaired: truncated {size - bad_start} byte(s) at "
                  f"offset {bad_start} of {path} (replayed to rev {self._rev})", flush=True)
        # a crash after a record's bytes but before its newline: the record
        # replays, and the next append must not weld onto its line
        if os.path.getsize(path) > 0:
            with open(path, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        self._compacted_rev = self._rev  # no watch resumes across a restart

    def _wal_emit(self, data: bytes):
        """Append and flush; on a failure (ENOSPC, EIO) roll the file back
        to where the write began, so that later records never follow
        garbage, and raise."""
        pre = self._wal.tell()
        try:
            self._wal.write(data)
            self._wal.flush()
        except OSError:
            self._rollback_wal(pre)
            raise

    def _rollback_wal(self, pre: int):
        try:
            try:
                self._wal.flush()
            except OSError:
                pass  # the buffered rest may be what failed; truncate anyway
            os.ftruncate(self._wal.fileno(), pre)
            self._wal.seek(pre)
            self.wal_write_rollbacks += 1
        except OSError as e:
            print(f"store: WAL rollback after a failed write failed too ({e}); the "
                  f"replay on open skips or truncates the damage", flush=True)

    def _write_wal_locked(self, records: List[tuple]):
        """Must hold the lock: the commit's records, one write, flush and
        fsync."""
        self._wal_emit(b"".join(self._wal_frame({"rev": rev, "type": typ, "key": key, "obj": obj})
                                for rev, typ, key, obj in records))
        os.fsync(self._wal.fileno())

    # ---------------------------------------------------------------- commit

    def current_revision(self) -> int:
        with self._lock:
            return self._rev

    def _run_commit(self, fn: Callable):
        """Run one mutation under the lock: ``fn`` checks preconditions and
        calls _commit_locked; its records go to the log and fan out once,
        after it.  The fan-out runs even when the log write failed (the
        memory holds the commit, and the watch cache must agree with it),
        but then the writer gets an error: the write is not durable."""
        wal_exc: Optional[OSError] = None
        with self._lock:
            records: List[tuple] = []
            self._batch_records = records
            try:
                result = fn()
            finally:
                self._batch_records = None
                if records:
                    if self._wal is not None:
                        try:
                            self._write_wal_locked(records)
                        except OSError as e:
                            wal_exc = e
                    self._stamp_commit_ts_locked(records)
                    self._fanout_batch_locked(records)
        if wal_exc is not None:
            raise ApiError(f"write applied but WAL persistence failed: {wal_exc}")
        return result

    def _commit_locked(self, typ: str, key: str, obj: Dict[str, Any]):
        """Must hold the lock, inside _run_commit: assigns the next
        revision and applies it to the data and the history."""
        self._rev += 1
        rev = self._rev
        # two-level copy: never re-stamp a dict already committed to the
        # history or handed to a watcher (delete passes the stored dict in)
        obj = {**obj, "metadata": dict(obj.get("metadata") or {})}
        obj["metadata"]["resourceVersion"] = str(rev)
        coll = collection_of(key)
        if typ == DELETED:
            self._data.pop(key, None)
            keys = self._by_collection.get(coll)
            if keys is not None:
                keys.discard(key)
        else:
            self._data[key] = (rev, obj)
            self._by_collection.setdefault(coll, set()).add(key)
        self._history.append((rev, typ, key, obj))
        if len(self._history) > self.HISTORY_LIMIT:
            drop = len(self._history) - self.HISTORY_LIMIT
            self._compacted_rev = self._history[drop - 1][0]
            del self._history[:drop]
        self._batch_records.append((rev, typ, key, obj))
        return rev, obj

    def _stamp_commit_ts_locked(self, records: List[tuple]):
        ts = time.monotonic()
        for rev, _typ, _key, _obj in records:
            self._commit_ts[rev] = ts
            self._commit_ts_order.append(rev)
        while len(self._commit_ts_order) > DEFAULT_COMMIT_TS_LIMIT:
            self._commit_ts.pop(self._commit_ts_order.popleft(), None)

    def commit_ts_of(self, rev: int) -> Optional[float]:
        """The monotonic commit stamp of a recent revision, or None."""
        return self._commit_ts.get(rev)

    def _fanout_batch_locked(self, records: List[tuple]):
        """Must hold the lock: one push per matching watcher and one call
        per hook for the whole commit."""
        events = [(key, WatchEvent(typ, obj)) for _rev, typ, key, obj in records]
        evicted = False
        for w in self._watchers:
            evs = [ev for key, ev in events if key.startswith(w.prefix)]
            if evs:
                w._push_batch(evs)
            evicted = evicted or w.evicted
        if evicted:
            self._watchers = [w for w in self._watchers if not w.evicted]
        for hook in self._commit_hooks:
            hook(records)

    def add_commit_hook(self, fn: Callable):
        with self._lock:
            self._commit_hooks.append(fn)

    def remove_commit_hook(self, fn: Callable):
        with self._lock:
            if fn in self._commit_hooks:
                self._commit_hooks.remove(fn)

    def _note_watch_eviction(self):
        with self._stats_lock:
            self.watch_evictions += 1

    def _decode(self, obj: Dict[str, Any]):
        return self._scheme.decode(obj)

    # ------------------------------------------------------------ operations

    def create(self, key: str, obj) -> Any:
        """Create; fails with AlreadyExists.  Stamps uid and creationTimestamp."""
        meta = obj.metadata
        if not meta.uid:
            meta.uid = new_uid()
        if not meta.creation_timestamp:
            meta.creation_timestamp = now_iso()
        encoded = self._scheme.encode(obj)

        def commit():
            if key in self._data:
                raise AlreadyExists(f"{key} already exists")
            return self._commit_locked(ADDED, key, encoded)[1]

        # committed dicts are immutable: decode outside the lock
        return self._decode(self._run_commit(commit))

    def get(self, key: str) -> Any:
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                raise NotFound(f"{key} not found")
            raw = ent[1]
        return self._decode(raw)

    def get_or_none(self, key: str):
        try:
            return self.get(key)
        except NotFound:
            return None

    def list_raw(self, prefix: str) -> Tuple[List[Tuple[str, int, Dict[str, Any]]], int]:
        """Raw (key, rev, encoded obj) entries under prefix, key-sorted,
        and the store's revision."""
        with self._lock:
            coll = collection_of(prefix)
            if coll:
                keys = sorted(self._by_collection.get(coll) or ())
            else:
                keys = sorted(self._data)  # "/registry/": the watch cache's seed
            entries = [(key,) + self._data[key] for key in keys
                       if key.startswith(prefix) and key in self._data]
            return entries, self._rev

    def list(self, prefix: str) -> Tuple[List[Any], int]:
        """All objects under prefix and the store's revision."""
        entries, rev = self.list_raw(prefix)
        return [self._decode(obj) for _key, _rev, obj in entries], rev

    def update_cas(self, key: str, obj) -> Any:
        """One compare-and-swap on obj.metadata.resource_version (none = any)."""
        encoded = self._scheme.encode(obj)
        expect = obj.metadata.resource_version

        def commit():
            ent = self._data.get(key)
            if ent is None:
                raise NotFound(f"{key} not found")
            cur_rev = ent[0]
            if expect and str(cur_rev) != expect:
                raise Conflict(f"{key}: resourceVersion mismatch (have {cur_rev}, want {expect})")
            return self._commit_locked(MODIFIED, key, encoded)[1]

        return self._decode(self._run_commit(commit))

    def guaranteed_update(self, key: str, update_fn: Callable[[Any], Any]) -> Any:
        """Read-modify-CAS retry loop (ref: etcd3 store.go:263).
        ``update_fn`` gets a fresh decoded copy and returns the new object
        (or None to keep the mutated copy); StopUpdate aborts cleanly."""
        while True:
            cur = self.get(key)
            updated = update_fn(cur)
            if updated is None:
                updated = cur
            try:
                return self.update_cas(key, updated)
            except Conflict:
                continue

    def delete(self, key: str, expect_rv: str = "") -> Any:
        def commit():
            ent = self._data.get(key)
            if ent is None:
                raise NotFound(f"{key} not found")
            cur_rev, obj = ent
            if expect_rv and str(cur_rev) != expect_rv:
                raise Conflict(f"{key}: resourceVersion mismatch")
            return self._commit_locked(DELETED, key, obj)[1]

        return self._decode(self._run_commit(commit))

    # ---------------------------------------------------------------- batches

    def get_raw_many(self, keys: List[str]) -> List[Optional[Dict[str, Any]]]:
        """Encoded wire dicts for N keys (None where absent) under one lock."""
        with self._lock:
            return [None if self._data.get(key) is None else self._data[key][1]
                    for key in keys]

    def commit_batch(self, ops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Commit N independent mutations as one run of revisions with one
        fan-out.  Each op is {"op": "create"|"update_cas"|"delete", "key",
        "obj": the encoded wire dict (create, update_cas), "expect_rv":
        an optional CAS guard}.  Returns one {"obj": the committed dict}
        or {"error": ApiError} per op, in order: ops fail independently
        and the others commit (amortization, not a transaction)."""
        def commit():
            out: List[Dict[str, Any]] = []
            for op in ops:
                try:
                    out.append({"obj": self._apply_op_locked(op)})
                except ApiError as e:
                    out.append({"error": e})
            return out

        return self._run_commit(commit)

    def _apply_op_locked(self, op: Dict[str, Any]) -> Dict[str, Any]:
        kind, key = op.get("op"), op["key"]
        if kind == "create":
            if key in self._data:
                raise AlreadyExists(f"{key} already exists")
            obj = op["obj"]
            meta = obj.get("metadata") or {}
            # the same stamping as create(): the batch path commits the
            # same state and watch frames
            if not meta.get("uid") or not meta.get("creationTimestamp"):
                obj = {**obj, "metadata": dict(meta)}
                if not obj["metadata"].get("uid"):
                    obj["metadata"]["uid"] = new_uid()
                if not obj["metadata"].get("creationTimestamp"):
                    obj["metadata"]["creationTimestamp"] = now_iso()
            return self._commit_locked(ADDED, key, obj)[1]
        if kind in ("update_cas", "delete"):
            ent = self._data.get(key)
            if ent is None:
                raise NotFound(f"{key} not found")
            cur_rev, cur = ent
            expect = op.get("expect_rv", "")
            if expect and str(cur_rev) != expect:
                if kind == "delete":
                    raise Conflict(f"{key}: resourceVersion mismatch")
                raise Conflict(f"{key}: resourceVersion mismatch (have {cur_rev}, want {expect})")
            if kind == "delete":
                return self._commit_locked(DELETED, key, cur)[1]
            return self._commit_locked(MODIFIED, key, op["obj"])[1]
        raise ApiError(f"unknown batch op {kind!r}")

    # ------------------------------------------------------------------ watch

    def watch(self, prefix: str, since_rev: int = 0) -> Watcher:
        """Events for keys under prefix with rev > since_rev (0: from now).
        Resuming below the compaction floor raises TooOldResourceVersion;
        the replay slice is found by binary search and delivered outside
        the lock."""
        w = Watcher(self, prefix, buffering=bool(since_rev))
        with self._lock:
            if since_rev and since_rev < self._compacted_rev:
                raise TooOldResourceVersion(
                    f"revision {since_rev} compacted (floor {self._compacted_rev})")
            replay = (self._history[history_index(self._history, since_rev):]
                      if since_rev else [])
            self._watchers.append(w)
        if since_rev:
            w._replay_and_go_live(replay)
        return w

    def _remove_watcher(self, w: Watcher):
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def compact(self, keep_last: int = 1000):
        with self._lock:
            if len(self._history) > keep_last:
                drop = len(self._history) - keep_last
                self._compacted_rev = self._history[drop - 1][0]
                del self._history[:drop]

    def close(self):
        with self._lock:
            watchers = list(self._watchers)
            wal, self._wal = self._wal, None
        for w in watchers:
            w.stop()
        if wal is not None:
            wal.close()
