"""The PyTorch port's decode server against the JAX package's, on the CPU.

Greedy tokens must equal the JAX DecodeServer's on the same weights
(carried by ``params_from_jax``), batched and sequential.  The tiny
config runs in float32 here, where near-ties between logits cannot flip
an argmax.  Then the analogs of tests/test_serving.py's batching tests,
an HTTP round trip, and the metric surface the HPA scrapes.
"""

import dataclasses
import functools
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes1_tpu.utils import metrics as jmetrics
from kubernetes1_tpu.workloads import llama as jllama
from kubernetes1_tpu_torch.obs.appmetrics import AppMetrics
from kubernetes1_tpu_torch.utils import metrics as tmetrics
from kubernetes1_tpu_torch.workloads import llama as tllama

PROMPTS = ([1, 2, 3], [9, 8], [42, 7, 100, 3, 250])


def _tcfg():
    return dataclasses.replace(tllama.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module")
def servers():
    jcfg = dataclasses.replace(jllama.tiny(), dtype=jnp.float32)
    jb = jllama.DecodeServer(cfg=jcfg, seed=7, batching=True, slots=4)
    js = jllama.DecodeServer(cfg=jcfg, seed=7, batching=False)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jb.params), _tcfg(), "cpu")
    tb = tllama.DecodeServer(cfg=_tcfg(), batching=True, slots=4, device="cpu",
                             params=tparams)
    ts = tllama.DecodeServer(cfg=_tcfg(), batching=False, device="cpu", params=tparams)
    try:
        yield {"jax_batched": jb, "jax_sequential": js,
               "batched": tb, "sequential": ts, "params": tparams}
    finally:
        for s in (jb, js, tb, ts):
            s.stop()


class TestGreedyParityWithJax:
    def test_batched_tokens_equal_jax(self, servers):
        for prompt in PROMPTS:
            assert servers["batched"].generate(list(prompt), max_new=4) == \
                servers["jax_batched"].generate(list(prompt), max_new=4)

    def test_sequential_tokens_equal_jax(self, servers):
        for prompt in PROMPTS:
            assert servers["sequential"].generate(list(prompt), max_new=4) == \
                servers["jax_sequential"].generate(list(prompt), max_new=4)


class TestContinuousBatching:
    def test_batched_matches_sequential(self, servers):
        for prompt in PROMPTS:
            assert servers["batched"].generate(list(prompt), max_new=4) == \
                servers["sequential"].generate(list(prompt), max_new=4)

    def test_concurrent_requests_match_sequential(self, servers):
        batched, sequential = servers["batched"], servers["sequential"]
        prompts = [[i + 1, i + 2] for i in range(6)]  # 6 requests, 4 slots
        want = [sequential.generate(list(p), max_new=4) for p in prompts]
        got = [None] * len(prompts)

        def one(i):
            got[i] = batched.generate(list(prompts[i]), max_new=4)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert got == want

    def test_slot_admission_bounds_concurrency(self, servers):
        engine = servers["batched"].engine
        leases = [engine.submit([5, i], max_new=4) for i in range(7)]
        peak = 0
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            with engine._cond:
                peak = max(peak, len(engine._active))
                pending = len(engine._pending) + len(engine._active)
            if pending == 0:
                break
            time.sleep(0.01)
        outs = [lease.result(timeout=60) for lease in leases]
        assert all(len(o) == 4 for o in outs)
        assert peak <= engine.slots

    def test_streaming_delivers_per_token(self, servers):
        batched = servers["batched"]
        toks = list(batched.generate_stream([3, 1], max_new=4).stream())
        assert len(toks) == 4
        assert toks == batched.generate([3, 1], max_new=4)

    def test_sequential_server_refuses_streaming(self, servers):
        with pytest.raises(RuntimeError):
            servers["sequential"].generate_stream([1], max_new=2)

    def test_slot_gauges_rendered(self, servers):
        text = servers["batched"].metrics.render()
        assert "ktpu_llama_slots_total 4.0" in text.splitlines()
        assert "ktpu_llama_slots_used" in text
        assert "ktpu_llama_batch_occupancy_count" in text
        assert "ktpu_llama_requests_total" in text

    def test_greedy_decode_matches_jax(self, servers):
        """The sequential arm's function, called directly."""
        want = servers["jax_sequential"].generate([4, 4, 4], max_new=3)
        step = functools.partial(tllama.forward, _tcfg())
        assert tllama.greedy_decode(_tcfg(), servers["params"], step, [4, 4, 4],
                                    max_new=3) == want


# ------------------------------------------------------------------ HTTP


def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url + "/generate", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


@pytest.fixture
def http_server():
    srv = tllama.DecodeServer(cfg=tllama.tiny(), seed=3, slots=2, device="cpu").start()
    try:
        yield srv
    finally:
        srv.stop()


class TestHttpContract:
    def test_generate_plain_and_streamed(self, http_server):
        url = http_server.url
        status, ctype, body = _post(url, {"tokens": [5, 6, 7], "max_new": 3})
        assert status == 200 and ctype == "application/json"
        plain = json.loads(body)["tokens"]
        assert len(plain) == 3 and all(0 <= t < 256 for t in plain)
        status, ctype, body = _post(url, {"tokens": [5, 6, 7], "max_new": 3, "stream": True})
        assert status == 200 and ctype == "application/x-ndjson"
        lines = [json.loads(x) for x in body.decode().splitlines()]
        assert lines[-1] == {"done": True}
        assert [x["token"] for x in lines[:-1]] == plain

    def test_max_new_is_clamped_to_64(self, http_server):
        _s, _c, body = _post(http_server.url, {"tokens": [1], "max_new": 500})
        assert len(json.loads(body)["tokens"]) == 64

    @pytest.mark.parametrize("raw", [b"not json", b"[1, 2]", b'{"tokens": ["x"]}',
                                     b'{"tokens": [1], "max_new": "many"}'])
    def test_malformed_body_is_400(self, http_server, raw):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(http_server.url, None, raw=raw)
        assert err.value.code == 400
        err.value.close()
        assert http_server.errors_total.value == 1.0

    def test_healthz_metrics_and_404(self, http_server):
        with urllib.request.urlopen(http_server.url + "/healthz", timeout=10) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        _post(http_server.url, {"tokens": [2], "max_new": 1})
        with urllib.request.urlopen(http_server.url + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "ktpu_llama_slots_total 2.0" in text.splitlines()
        assert "ktpu_llama_requests_total 1.0" in text.splitlines()
        assert "ktpu_llama_qps" in text and "ktpu_llama_request_latency_seconds_count 1" in text
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(http_server.url + "/nope", timeout=10)
        assert err.value.code == 404
        err.value.close()


def test_batching_switch_from_environment(monkeypatch):
    monkeypatch.setenv("KTPU_LLAMA_BATCHING", "0")
    srv = tllama.DecodeServer(cfg=tllama.tiny(), device="cpu")
    try:
        assert srv.engine is None and not srv.batching
        assert len(srv.generate([1, 2], max_new=2)) == 2
    finally:
        srv.stop()


def test_failed_step_ends_every_stream(monkeypatch):
    """A step that raises (a kernel error, say) ends the streams of the
    admitted and the later requests instead of leaving them blocked."""
    def broken_step(params, tokens):
        raise RuntimeError("step failed")

    hook = []
    monkeypatch.setattr(threading, "excepthook", lambda args: hook.append(args.exc_value))
    cfg = tllama.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0))
    engine = tllama.BatchEngine(cfg, params, broken_step, slots=2)
    try:
        assert engine.submit([1, 2], max_new=4).result(timeout=10) == []
        engine._thread.join(timeout=10)
        assert not engine._thread.is_alive()
        assert [str(e) for e in hook] == ["step failed"]
        assert engine.submit([3], max_new=4).result(timeout=10) == []
    finally:
        engine.stop()


def test_decode_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tllama.DecodeServer(cfg=tllama.tiny())


# --------------------------------------------------------------- metrics


def _exercise(mod):
    reg = mod.Registry()
    c = reg.counter("ktpu_x_total", "x")
    c.inc()
    c.inc(2.5)
    c.labels(phase="bind").inc()
    g = reg.gauge("ktpu_g")
    g.set(3.0)
    h = reg.histogram("ktpu_h_seconds")
    for v in (0.001, 0.02, 0.3, 7.0, 100.0):
        h.observe(v)
    h.labels(node="a").observe(0.5)
    with pytest.raises(ValueError):
        reg.gauge("ktpu_x_total")
    return reg.render()


def test_metrics_text_equals_jax_package():
    assert _exercise(tmetrics) == _exercise(jmetrics)


def test_appmetrics_rates_and_endpoint():
    app = AppMetrics(rate_window_s=2.0)
    app.mark("ktpu_llama_qps", 4)
    assert app.window_rate("ktpu_llama_qps") == 2.0
    assert app.window_rate("ktpu_unmarked") == 0.0
    app.serve()
    try:
        with urllib.request.urlopen(app.url + "/metrics", timeout=10) as resp:
            text = resp.read().decode()
        assert "ktpu_llama_qps 2.0" in text.splitlines()
    finally:
        app.stop()
    with pytest.raises(RuntimeError):
        _ = app.port
