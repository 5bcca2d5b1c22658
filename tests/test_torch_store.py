"""The port's MVCC store and watch cache (``kubernetes1_tpu_torch.storage``)
held to the JAX package's, at tolerance 0.

One seeded script of store operations (numpy) goes through the JAX
``Store`` and the port's: creates, CAS updates with the current and with a
stale resourceVersion, guaranteed updates, batch commits of mixed
operations, deletes with and without a precondition, compactions, and
watches opened from old revisions (from below the floor too).  After
every operation both stores must agree on the outcome (the committed
object, or the error's class and message), the revision and the whole
listing; at the end, on every watcher's event sequence.  A ``Cacher`` over
each store is held to the other's the same way: lists, the indexed
``spec.nodeName`` list, gets, the compaction floor, and watches from its
own history window, with and without an index hint.  Only uids and
creation timestamps, which both mint at random, are masked.
"""

import numpy as np
import pytest

from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.machinery import ApiError as JaxApiError
from kubernetes1_tpu.machinery.scheme import from_dict as jfrom_dict
from kubernetes1_tpu.machinery.scheme import global_scheme as jscheme
from kubernetes1_tpu.storage import Cacher as JaxCacher
from kubernetes1_tpu.storage import StopUpdate as JaxStopUpdate
from kubernetes1_tpu.storage import Store as JaxStore
from kubernetes1_tpu_torch.api import types as pt
from kubernetes1_tpu_torch.machinery.errors import ApiError
from kubernetes1_tpu_torch.machinery.scheme import from_dict as pfrom_dict
from kubernetes1_tpu_torch.machinery.scheme import global_scheme as pscheme
from kubernetes1_tpu_torch.storage import Cacher, StopUpdate, Store

NAMES = [f"o{i}" for i in range(6)]
NODES = ["", "n1", "n2"]
STEPS = 160


def _mask(x):
    if isinstance(x, dict):
        return {k: "<masked>" if k in ("uid", "creationTimestamp") else _mask(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_mask(v) for v in x]
    return x


class Side:
    """One implementation: its store, types and errors, in the same calls."""

    def __init__(self, jax: bool, history_limit: int):
        self.jax = jax
        if jax:
            self.store = JaxStore(jscheme, history_limit=history_limit)
        else:
            self.store = Store(pscheme)
            self.store.HISTORY_LIMIT = history_limit  # the JAX store's knob, by hand
        self.types = jt if jax else pt
        self.from_dict = jfrom_dict if jax else pfrom_dict
        self.scheme = jscheme if jax else pscheme
        self.error = JaxApiError if jax else ApiError
        self.stop_update = JaxStopUpdate if jax else StopUpdate
        self.watchers = []  # (watcher, events seen)
        self.cacher = None

    def obj(self, d):
        cls = self.types.Pod if d["kind"] == "Pod" else self.types.ConfigMap
        return self.from_dict(cls, d)

    def run(self, fn):
        """(outcome, revision, listing) of one operation."""
        try:
            out = ("ok", _mask(fn()))
        except self.error as e:
            out = ("error", e.reason, e.code, str(e))
        self.drain()
        entries, rev = self.store.list_raw("/registry/")
        return _mask([out, rev, entries, self.store.current_revision()])

    def drain(self):
        for w, seen in self.watchers:
            while True:
                ev = w.next_timeout(0)
                if ev is None:
                    break
                seen.append((ev.type, _mask(ev.object)))


def _encode(side, obj):
    if obj is None:
        return None
    return side.scheme.encode(obj)


def _random_obj(rng, kind, name):
    if kind == "Pod":
        return {"kind": "Pod", "apiVersion": "v1",
                "metadata": {"name": name, "namespace": "default",
                             "labels": {"v": str(rng.randint(3))}},
                "spec": {"nodeName": NODES[rng.randint(len(NODES))],
                         "containers": [{"name": "c", "image": f"i{rng.randint(9)}"}]}}
    return {"kind": "ConfigMap", "apiVersion": "v1",
            "metadata": {"name": name, "namespace": "default"},
            "data": {"k": str(rng.randint(1000))}}


def _key(kind, name):
    return f"/registry/{'pods' if kind == 'Pod' else 'configmaps'}/default/{name}"


def _step(rng, sides, watch_all=False):
    """One random operation, applied to both sides; returns both outcomes."""
    kind = ["Pod", "ConfigMap"][rng.randint(2)]
    name = NAMES[rng.randint(len(NAMES))]
    key = _key(kind, name)
    d = _random_obj(rng, kind, name)
    op = rng.randint(9)
    stale = bool(rng.randint(2))
    keep = int(rng.randint(1, 6))
    since = int(rng.randint(0, 40))
    batch = [(["create", "update_cas", "delete"][rng.randint(3)],
              ["Pod", "ConfigMap"][rng.randint(2)], NAMES[rng.randint(len(NAMES))],
              bool(rng.randint(2))) for _ in range(int(rng.randint(1, 5)))]
    batch_objs = [_random_obj(rng, k, n) for _op, k, n, _s in batch]
    outs = []
    for s in sides:
        st = s.store
        if op == 0 or op == 1:
            fn = (lambda s=s: _encode(s, st.create(key, s.obj(d))))
        elif op == 2:
            def fn(s=s):
                cur = st.get(key)
                new = s.obj(d)
                new.metadata.resource_version = "1" if stale else cur.metadata.resource_version
                return _encode(s, st.update_cas(key, new))
        elif op == 3:
            def fn(s=s):
                def mutate(cur):
                    if stale:
                        raise s.stop_update()
                    cur.metadata.labels["g"] = d["metadata"].get("labels", {}).get("v", "x")
                    return cur
                try:
                    return _encode(s, st.guaranteed_update(key, mutate))
                except s.stop_update:
                    return "stopped"
        elif op == 4:
            def fn(s=s):
                raw = st.get_raw_many([key])[0]
                rv = "" if raw is None else raw["metadata"]["resourceVersion"]
                return _encode(s, st.delete(key, expect_rv="99999" if stale else rv))
        elif op == 5:
            def fn(s=s):
                ops = []
                for (bop, bk, bn, bstale), bd in zip(batch, batch_objs):
                    bkey = _key(bk, bn)
                    raw = st.get_raw_many([bkey])[0]
                    rv = "" if raw is None else raw["metadata"]["resourceVersion"]
                    o = {"op": bop, "key": bkey, "expect_rv": "99999" if bstale else rv}
                    if bop != "delete":
                        o["obj"] = s.scheme.encode(s.obj(bd))
                    ops.append(o)
                return [{"obj": r["obj"]} if "obj" in r else
                        {"error": (r["error"].reason, str(r["error"]))}
                        for r in st.commit_batch(ops)]
        elif op == 6:
            def fn(s=s):
                st.compact(keep_last=keep)
                return "compacted"
        elif op == 7:
            def fn(s=s):
                w = st.watch("/registry/pods/" if watch_all else "/registry/", since_rev=since)
                s.watchers.append((w, []))
                return "watching"
        else:
            def fn(s=s):
                return [e[0] for e in st.list_raw("/registry/configmaps/")[0]], \
                    st.get_or_none(key) is None
        outs.append(s.run(fn))
    return outs


@pytest.mark.parametrize("seed", range(4))
def test_a_seeded_script_of_store_operations_matches_the_jax_store(seed):
    rng = np.random.RandomState(seed)
    sides = [Side(True, history_limit=24), Side(False, history_limit=24)]
    for i in range(STEPS):
        want, got = _step(rng, sides, watch_all=bool(seed % 2))
        assert got == want, f"step {i}"
    for (jw, jseen), (pw, pseen) in zip(sides[0].watchers, sides[1].watchers):
        assert pseen == jseen
        jw.stop()
        pw.stop()
    assert len(sides[0].watchers) > 3 and sides[0].store.current_revision() > 30
    for s in sides:
        s.store.close()


def _cacher_view(s, since_revs):
    c = s.cacher
    view = {"list": c.list_raw("/registry/pods/"),
            "ns list": c.list_raw("/registry/configmaps/default/"),
            "indexed": [c.list_raw_indexed("/registry/pods/", "spec.nodeName", n) for n in NODES],
            "unindexed": c.list_raw_indexed("/registry/pods/", "metadata.name", "o1"),
            "get": [c.get_raw(_key("Pod", n)) for n in NAMES],
            "rev": c.current_cached_revision(),
            "floor": (c.compacted_revisions()[0] if s.jax else c.compacted_revision())}
    watches = []
    for since, hint in since_revs:
        try:
            w = c.watch("/registry/pods/", since_rev=since, index_hint=hint)
        except s.error as e:
            watches.append(("error", e.reason, str(e)))
            continue
        watches.append(w)
    return view, watches


@pytest.mark.parametrize("seed", range(3))
def test_the_watch_caches_list_and_watch_as_the_jax_cacher(seed):
    rng = np.random.RandomState(100 + seed)
    sides = [Side(True, history_limit=1000), Side(False, history_limit=1000)]
    for s in sides:
        if s.jax:
            s.cacher = JaxCacher(s.store, jscheme, history_limit=30)
        else:
            s.cacher = Cacher(s.store)
            s.cacher.HISTORY_LIMIT = 30  # the JAX cacher's knob, by hand
        s.cacher.start()
    opened = []
    for i in range(STEPS):
        want, got = _step(rng, sides)
        assert got == want, f"step {i}"
        if i % 20 == 10:
            hints = [(int(rng.randint(0, sides[0].store.current_revision() + 1)),
                      [None, ("spec.nodeName", NODES[rng.randint(3)])][rng.randint(2)])
                     for _ in range(3)]
            views = [_cacher_view(s, hints) for s in sides]
            assert _mask(views[1][0]) == _mask(views[0][0]), f"step {i}"
            opened.append([w for _v, w in views])
    for jws, pws in opened:
        assert len(jws) == len(pws)
        for jw, pw in zip(jws, pws):
            if isinstance(jw, tuple):
                assert pw == jw
                continue
            seen = []
            for w in (jw, pw):
                evs = []
                while True:
                    ev = w.next_timeout(0)
                    if ev is None:
                        break
                    evs.append((ev.type, _mask(ev.object)))
                seen.append(evs)
                w.stop()
            assert seen[1] == seen[0]
    assert any(isinstance(w, tuple) for jws, _ in opened for w in jws) or seed != 0
    for s in sides:
        s.cacher.stop()
        s.store.close()
