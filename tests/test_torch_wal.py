"""The port's write-ahead log (``kubernetes1_tpu_torch.storage.Store``'s
``wal_path``) held to the JAX store's, at tolerance 0.

One seeded script of writes (creates, CAS updates, deletes and batch
commits of pods and configmaps, objects carrying the same uids and
timestamps on both sides) goes to a JAX ``Store`` and to the port's, each
with a WAL.  The two logs are the same bytes.  Each package then replays
the other's log: the objects (uids and timestamps included) and the
revision equal what the writing store held.  A log cut mid-record (the
torn tail of a crash), one with a damaged line before good records, and
one whose last record lost its newline replay to the same prefix in both
packages, which repair the file alike.  Each commit is one write and one
fsync, and a write whose log append fails is answered with an error
while the memory and the watch cache keep it, as in the JAX store.
Deviation, with both answers: a bare JSON line (the JAX log format from
before the CRC frames) replays in the JAX store and is damage in the
port's.
"""

import os

import numpy as np
import pytest

import kubernetes1_tpu.api  # noqa: F401  (registers the JAX kinds)
from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.machinery.scheme import from_dict as jfrom_dict
from kubernetes1_tpu.machinery.scheme import global_scheme as jscheme
from kubernetes1_tpu.storage import Store as JaxStore
from kubernetes1_tpu_torch.api import types as pt
from kubernetes1_tpu_torch.machinery.errors import ApiError
from kubernetes1_tpu_torch.machinery.scheme import from_dict as pfrom_dict
from kubernetes1_tpu_torch.machinery.scheme import global_scheme as pscheme
from kubernetes1_tpu_torch.storage import Store

SEEDS = range(6)
STEPS = 60
NAMES = [f"o{i}" for i in range(5)]


def _obj(side: str, kind: str, name: str, i: int):
    d = {"kind": kind, "apiVersion": "v1",
         "metadata": {"name": name, "namespace": "default", "uid": f"uid-{name}-{i}",
                      "creationTimestamp": "2026-01-01T00:00:00Z", "labels": {"step": str(i)}}}
    if kind == "Pod":
        d["spec"] = {"containers": [{"name": "c", "image": "busybox"}], "nodeName": f"n{i % 3}"}
        cls = jt.Pod if side == "jax" else pt.Pod
    else:
        d["data"] = {"k": str(i)}
        cls = jt.ConfigMap if side == "jax" else pt.ConfigMap
    return (jfrom_dict if side == "jax" else pfrom_dict)(cls, d)


def _key(kind: str, name: str) -> str:
    return f"/registry/{'pods' if kind == 'Pod' else 'configmaps'}/default/{name}"


def _store(side: str, path: str, **kw):
    return JaxStore(jscheme, wal_path=path, **kw) if side == "jax" \
        else Store(pscheme, wal_path=path, **kw)


def _state(store) -> tuple:
    """(revision, {key: (rev, the committed dict)}) of a store."""
    return store.current_revision(), {k: v for k, v in sorted(store._data.items())}


def _script(seed: int):
    """[(op, kind, name, step)] of the seed."""
    rng = np.random.default_rng(seed)
    return [(["create", "update", "delete", "batch"][rng.integers(4)],
             ["Pod", "ConfigMap"][rng.integers(2)], NAMES[rng.integers(len(NAMES))], i)
            for i in range(STEPS)]


def _apply(side: str, store, script):
    outcomes = []
    for op, kind, name, i in script:
        key = _key(kind, name)
        try:
            if op == "create":
                store.create(key, _obj(side, kind, name, i))
            elif op == "update":
                cur = store.get(key)
                cur.metadata.labels["step"] = str(i)
                store.update_cas(key, cur)
            elif op == "delete":
                store.delete(key)
            else:
                other = _key(kind, NAMES[(NAMES.index(name) + 1) % len(NAMES)])
                enc = (jscheme if side == "jax" else pscheme).encode(_obj(side, kind, name, i))
                res = store.commit_batch([{"op": "create", "key": key, "obj": enc},
                                          {"op": "delete", "key": other}])
                outcomes.append(["error" in r for r in res])
                continue
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001 — each side's NotFound/AlreadyExists
            outcomes.append(type(e).__name__)
    return outcomes


@pytest.fixture(params=SEEDS, ids=[f"seed{s}" for s in SEEDS])
def written(request, tmp_path):
    """Both stores after the seed's script, closed; their logs' paths."""
    script = _script(request.param)
    out = {}
    for side in ("jax", "torch"):
        path = str(tmp_path / f"{side}.wal")
        store = _store(side, path)
        outcomes = _apply(side, store, script)
        out[side] = (path, _state(store), outcomes)
        store.close()
    return out


def test_both_stores_write_the_same_log(written):
    assert written["torch"][2] == written["jax"][2]
    with open(written["jax"][0], "rb") as a, open(written["torch"][0], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_each_package_replays_the_others_log(written, reader):
    writer = "torch" if reader == "jax" else "jax"
    path, held, _ = written[writer]
    store = _store(reader, path)
    try:
        assert _state(store) == held
        # no watch resumes across a restart
        assert store._compacted_rev == held[0]
    finally:
        store.close()


def _damage(path: str, how: str) -> int:
    """Damage the log; the byte length a replay must keep."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.splitlines(keepends=True)
    if how == "torn tail":
        keep = len(data) - len(lines[-1])
        data = data[:keep] + lines[-1][:len(lines[-1]) // 2]
    elif how == "mid-file damage":
        mid = len(lines) // 2
        lines[mid] = b"0badc0de:" + lines[mid][9:]
        data = b"".join(lines)
        keep = len(data)
    else:  # the last record's newline lost
        data = data[:-1]
        keep = len(data) + 1
    with open(path, "wb") as f:
        f.write(data)
    return keep


@pytest.mark.parametrize("how", ["torn tail", "mid-file damage", "no final newline"])
def test_a_damaged_log_replays_to_the_same_prefix_in_both(written, how, tmp_path):
    states, files = {}, {}
    for reader in ("jax", "torch"):
        path = str(tmp_path / f"damaged-{reader}.wal")
        with open(written["jax"][0], "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        keep = _damage(path, how)
        store = _store(reader, path)
        states[reader] = _state(store)
        store.close()
        with open(path, "rb") as f:
            files[reader] = f.read()
        assert len(files[reader]) == keep
    assert states["torch"] == states["jax"]
    assert files["torch"] == files["jax"]
    if how == "torn tail":
        assert states["torch"][0] < written["jax"][1][0]


@pytest.mark.parametrize("op", ["create", "update", "delete", "batch"])
def test_every_commit_is_written_and_fsynced_once(tmp_path, monkeypatch, op):
    """A commit, of one record or of a batch's two, is one write, one flush
    and one fsync before its writer is answered (the JAX store's "batch"
    mode, the only one the port has)."""
    path = str(tmp_path / "w")
    store = Store(pscheme, wal_path=path)
    store.create(_key("Pod", "o0"), _obj("torch", "Pod", "o0", 0))
    calls = []
    real_fsync, real_write = os.fsync, store._wal.write
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(store._wal, "write", lambda b: (calls.append("write"), real_write(b))[1])
    # the batch creates o4 and deletes o0, the next of NAMES
    name = {"create": "o1", "batch": "o4"}.get(op, "o0")
    outcome = _apply("torch", store, [(op, "Pod", name, 1)])
    monkeypatch.undo()
    assert outcome in (["ok"], [[False, False]]) and calls == ["write", "fsync"]
    with open(path, "rb") as f:
        records = [Store._parse_wal_frame(line) for line in f]
    assert all(records) and len(records) == (3 if op == "batch" else 2)
    store.close()


def test_a_bare_json_line_is_damage_where_jax_replays_it(written, tmp_path):
    """Deviation: a last line of bare JSON (the JAX store's log format from
    before the CRC frames, which neither package writes).  The JAX store
    replays it as a record; the port's takes it for a torn tail and cuts
    it away."""
    import json

    path, (rev, data), _ = written["jax"]
    with open(path, "rb") as f:
        framed = f.read()
    rec = {"rev": rev + 1, "type": "ADDED", "key": _key("ConfigMap", "bare"),
           "obj": {"kind": "ConfigMap", "apiVersion": "v1",
                   "metadata": {"name": "bare", "namespace": "default"}}}
    got = {}
    for reader in ("jax", "torch"):
        copy = str(tmp_path / f"bare-{reader}.wal")
        with open(copy, "wb") as f:
            f.write(framed + json.dumps(rec).encode() + b"\n")
        store = _store(reader, copy)
        got[reader] = (store.current_revision(), rec["key"] in store._data,
                       os.path.getsize(copy))
        store.close()
    assert got["jax"][:2] == (rev + 1, True) and got["jax"][2] > len(framed)
    assert got["torch"] == (rev, False, len(framed))


def test_a_failed_append_errors_the_writer_and_is_rolled_out(tmp_path, monkeypatch):
    """The append fails (ENOSPC): the writer gets an error, the file is cut
    back to where the write began, and the memory and its watchers keep
    the commit, as the JAX store does."""
    path = str(tmp_path / "w")
    store = Store(pscheme, wal_path=path)
    store.create(_key("Pod", "a"), _obj("torch", "Pod", "a", 0))
    size = os.path.getsize(path)
    w = store.watch("/registry/", since_rev=0)
    real_write = store._wal.write

    def full(data):
        real_write(data[:10])
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store._wal, "write", full)
    with pytest.raises(ApiError, match="WAL persistence failed"):
        store.create(_key("Pod", "b"), _obj("torch", "Pod", "b", 1))
    monkeypatch.undo()
    assert os.path.getsize(path) == size and store.wal_write_rollbacks == 1
    assert store.get(_key("Pod", "b")).metadata.name == "b"
    assert [ev.type for ev in w.next_batch_timeout(1.0)] == ["ADDED"]
    w.stop()
    store.create(_key("Pod", "c"), _obj("torch", "Pod", "c", 2))
    store.close()
    again = Store(pscheme, wal_path=path)
    assert sorted(again._data) == [_key("Pod", "a"), _key("Pod", "c")]
    again.close()
