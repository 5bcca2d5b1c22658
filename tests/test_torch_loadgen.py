"""The port's open-loop load generator held to the JAX package's.

``kubernetes1_tpu_torch.workloads.loadgen.LoadGen`` must draw the same
arrival stream from the same seed, report the same summary keys against
one backend, drive the port's ``DecodeServer`` (streamed and buffered),
and retry through the port's ``loadgen.request`` fault seam; the port's
``utils/retry`` must back off as the JAX package's ``client/retry`` does.
"""

import random

import pytest

from kubernetes1_tpu.client import retry as jax_retry
from kubernetes1_tpu.workloads.loadgen import LoadGen as JaxLoadGen
from kubernetes1_tpu.workloads.servefleet import SyntheticBackend
from kubernetes1_tpu_torch.utils import faultline, retry
from kubernetes1_tpu_torch.workloads import llama
from kubernetes1_tpu_torch.workloads.loadgen import LoadGen, _pctl

# No 10 consecutive draws of this seed's loadgen.request stream at
# p = 0.3 hold more than 3 faults among the first 60, so no request of the
# drop@0.3 test below can meet 5 (its attempts with retries=4).
FAULT_SEED = 9


@pytest.fixture()
def backend():
    srv = SyntheticBackend(token_delay_s=0.001).start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("arrival", ["poisson", "constant"])
def test_same_seed_gives_the_same_interarrivals(arrival):
    ours = LoadGen("http://127.0.0.1:1", qps=37.5, arrival=arrival, seed=11)
    jax_ = JaxLoadGen("http://127.0.0.1:1", qps=37.5, arrival=arrival, seed=11)
    got = [ours._interarrival() for _ in range(1000)]
    assert got == [jax_._interarrival() for _ in range(1000)]
    assert len(set(got)) == (1000 if arrival == "poisson" else 1)


def test_unknown_arrival_is_refused():
    with pytest.raises(ValueError, match="unknown arrival process"):
        LoadGen("http://127.0.0.1:1", qps=1, arrival="bursty")


def test_pctl_matches_the_jax_one():
    from kubernetes1_tpu.workloads.loadgen import _pctl as jax_pctl

    xs = [0.5, 0.1, 0.9, 0.3, 0.7, 0.2]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert _pctl(xs, q) == jax_pctl(xs, q)
    assert _pctl([], 0.5) is None


def test_summary_keys_and_counts_match_the_jax_loadgen(backend):
    ours = LoadGen(backend.url, qps=40, arrival="constant", seed=3).run(1.0).summary()
    theirs = JaxLoadGen(backend.url, qps=40, arrival="constant", seed=3).run(1.0).summary()
    assert list(ours) == list(theirs)
    for s in (ours, theirs):
        assert s["failed"] == 0 and s["shed"] == 0, s
        assert s["acked"] == s["issued"] >= 30, s
        assert s["token_p50_s"] is not None and s["ttft_p99_s"] is not None


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "buffered"])
def test_drives_the_ports_decode_server(stream):
    srv = llama.DecodeServer(cfg=llama.tiny(), device="cpu", seed=0).start()
    try:
        lg = LoadGen(srv.url, qps=10, arrival="constant", seed=0, max_new=4,
                     stream=stream).run(1.0)
    finally:
        srv.stop()
    s = lg.summary()
    assert s["failed"] == 0 and s["shed"] == 0, s
    assert s["acked"] == s["issued"] >= 5, s
    assert len(lg.ttft_s) == s["acked"] and all(x > 0 for x in lg.ttft_s)
    # a stream records a gap between each of its 4 tokens; a body, none
    assert len(lg.token_gap_s) == (3 * s["acked"] if stream else 0)


def test_injected_drops_are_retried_until_acked(backend):
    faultline.activate(FAULT_SEED, "loadgen.request=drop@0.3")
    try:
        s = LoadGen(backend.url, qps=10, arrival="constant", seed=0,
                    retries=4).run(1.0).summary()
        fired = faultline.stats().get("loadgen.request", 0)
    finally:
        faultline.deactivate()
    assert fired > 0
    assert s["failed"] == 0 and s["acked"] == s["issued"] >= 5, s


def test_a_request_that_always_drops_is_counted_failed(backend):
    faultline.activate(FAULT_SEED, "loadgen.request=drop@1")
    try:
        s = LoadGen(backend.url, qps=10, arrival="constant", seed=0,
                    retries=2).run(1.0).summary()
        fired = faultline.stats()["loadgen.request"]
    finally:
        faultline.deactivate()
    assert s["acked"] == 0 and s["failed"] == s["issued"] >= 5, s
    assert fired == 3 * s["issued"]  # each attempt: the first and its 2 retries
    assert s["ttft_p50_s"] is None and s["request_p99_s"] is None


@pytest.mark.parametrize("base, factor, cap", [(0.02, 2.0, 1.0), (0.01, 2.0, 0.2)])
def test_backoff_draws_the_jax_backoffs_sleeps(base, factor, cap):
    ours, theirs = retry.Backoff(base, factor, cap), jax_retry.Backoff(base, factor, cap)
    random.seed(7)
    got = [ours.next() for _ in range(12)]
    random.seed(7)
    assert got == [theirs.next() for _ in range(12)]
    assert all(0.0 <= d <= cap for d in got)


def test_call_with_retries_retries_only_what_classify_calls_transient():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient")
        return "done"

    fast = retry.Backoff(base=1e-4, cap=1e-3)
    assert retry.call_with_retries(flaky, lambda e: isinstance(e, ConnectionError), steps=3,
                                   backoff=fast) == "done"
    assert len(calls) == 3
    calls.clear()
    with pytest.raises(ConnectionError):  # the last attempt's error surfaces
        retry.call_with_retries(flaky, lambda e: True, steps=2, backoff=fast)
    assert len(calls) == 2
    calls.clear()
    with pytest.raises(ConnectionError):  # a terminal error is not retried
        retry.call_with_retries(flaky, lambda e: False, steps=5, backoff=fast)
    assert len(calls) == 1
