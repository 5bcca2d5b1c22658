"""The port's observability plane (``kubernetes1_tpu_torch/obs``,
``utils/slo.py``, ``utils/flightrec.py``, ``utils/eventloop.py``) held to
the JAX package's, tolerance 0.

- ``aggregate``: seeded metric texts made with numpy (counters, gauges,
  histograms, labeled and not, instances whose bucket boundaries agree
  and some that clash): ``parse_metrics_text``, ``merge_parsed`` (or the
  refusal of a clash, message and all), ``render_metrics``,
  ``bucket_quantile``, ``select`` and ``merge_metrics`` give equal output.
- ``ObsCollector``: each package's collector over the same fake HTTP
  endpoints serving fixed texts (one without ``/debug/flightrecorder``,
  one dead), each target scraped once by hand: the fleet ``/metrics``,
  ``topology()``, ``traces()`` and ``flightrecorder()`` equal, masking
  only URLs, staleness and durations; the port's started collector
  serving the same over HTTP.
- ``Scorecard``: fleet, pods and fed SLOs fed at fixed ``now``s through
  a fake collector and a fake clientset (a stale target and a stale pod
  collection count as missing): the ticks, ``verdict()``, the burn rates
  and ``render()`` equal, the breach hooks and ``SLO_BREACH`` events too.
- ``timeline.capture`` and ``summarize`` over two fake endpoints.
- ``StartupSLITracker.record`` on seeded pods with stamps: ``report()``
  and the histograms' text equal.
- The port's ``EventLoop``: timers in order, ``call_soon`` from another
  thread, a cancelled timer skipped, a raising callback survived.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from kubernetes1_tpu.api import types as jt
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.machinery.scheme import from_dict as jax_from_dict
from kubernetes1_tpu.obs import aggregate as jagg
from kubernetes1_tpu.obs import collector as jcollector
from kubernetes1_tpu.obs import scorecard as jscorecard
from kubernetes1_tpu.obs import timeline as jtimeline
from kubernetes1_tpu.utils import flightrec as jflightrec
from kubernetes1_tpu.utils import slo as jslo
from kubernetes1_tpu_torch.api import types as tt
from kubernetes1_tpu_torch.client.clientset import Clientset as TorchClientset
from kubernetes1_tpu_torch.machinery.scheme import from_dict as torch_from_dict
from kubernetes1_tpu_torch.obs import aggregate as tagg
from kubernetes1_tpu_torch.obs import collector as tcollector
from kubernetes1_tpu_torch.obs import scorecard as tscorecard
from kubernetes1_tpu_torch.obs import timeline as ttimeline
from kubernetes1_tpu_torch.utils import eventloop as teventloop
from kubernetes1_tpu_torch.utils import flightrec as tflightrec
from kubernetes1_tpu_torch.utils import slo as tslo

SEED = 2201
N_TEXTS = 12
BOUNDS = [(0.005, 0.05, 0.5, 5.0), (0.001, 0.01, 0.1, 1.0, 10.0)]


# ---------------------------------------------------------------- aggregate


def _histogram_lines(rng, name, labels, bounds):
    lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
    sep = "," if lab else ""
    counts = np.cumsum(rng.integers(0, 20, size=len(bounds) + 1))
    out = [f'{name}_bucket{{{lab}{sep}le="{b}"}} {int(c)}'
           for b, c in zip(bounds, counts[:-1])]
    out.append(f'{name}_bucket{{{lab}{sep}le="+Inf"}} {int(counts[-1])}')
    total = float(rng.uniform(0, 50))
    tail = f"{{{lab}}}" if lab else ""
    out.append(f"{name}_sum{tail} {total:.6f}")
    out.append(f"{name}_count{tail} {int(counts[-1])}")
    for q in (0.5, 0.99):
        out.insert(0, f'{name}{{{lab}{sep}quantile="{q}"}} {rng.uniform(0, 5):.6f}')
    return out


def make_texts(seed: int):
    """Three instances' exposition texts; every third seed's last instance
    renders one histogram on other bucket boundaries."""
    rng = np.random.default_rng(SEED + seed)
    texts = []
    for inst in range(3):
        lines = ["# TYPE ktpu_requests_total counter"]
        for verb in ("GET", "PUT")[:int(rng.integers(1, 3))]:
            lines.append(f'ktpu_requests_total{{verb="{verb}"}} {int(rng.integers(0, 1000))}')
        lines += ["# TYPE ktpu_queue_depth gauge",
                  f"ktpu_queue_depth {int(rng.integers(0, 50))}",
                  "# TYPE ktpu_hit_ratio gauge",
                  f"ktpu_hit_ratio {rng.uniform(0, 1):.6f}",
                  "# TYPE ktpu_latency_seconds histogram"]
        clash = seed % 3 == 2 and inst == 2
        lines += _histogram_lines(rng, "ktpu_latency_seconds", {},
                                  BOUNDS[1] if clash else BOUNDS[0])
        lines.append("# TYPE ktpu_phase_seconds histogram")
        for phase in ("bind", "run"):
            lines += _histogram_lines(rng, "ktpu_phase_seconds", {"phase": phase}, BOUNDS[1])
        lines.append("# TYPE ktpu_reservoir_only summary")
        lines.append(f'ktpu_reservoir_only{{quantile="0.5"}} {rng.uniform(0, 9):.6f}')
        if rng.integers(2):
            lines.append("garbage line without a value")
            lines.append(f"ktpu_untyped_thing {int(rng.integers(0, 9))}")
        if rng.integers(3) == 0:
            lines.append("ktpu_inf_gauge +Inf")
        texts.append("\n".join(lines) + "\n")
    return texts


def _agg_record(agg, texts):
    parsed = [agg.parse_metrics_text(x) for x in texts]
    out = {"parsed": [(p.types, p.samples) for p in parsed]}
    try:
        merged = agg.merge_parsed(parsed)
    except ValueError as e:
        out["merge_error"] = str(e)
        merged = agg.merge_parsed(parsed[:2])
    out["merged"] = (merged.types, merged.samples)
    out["render"] = agg.render_metrics(merged)
    out["select"] = [agg.select(merged, "ktpu_phase_seconds_bucket", phase="run"),
                     agg.select(merged, "ktpu_requests_total"),
                     agg.select(merged, "ktpu_latency_seconds", quantile="0.99")]
    buckets = [(float("inf") if k.endswith('"+Inf"}') else float(k.split('le="')[1][:-2]), v)
               for k, v in agg.select(merged, "ktpu_phase_seconds_bucket", phase="bind").items()]
    out["quantiles"] = [agg.bucket_quantile(buckets, q) for q in (0.0, 0.3, 0.5, 0.9, 0.99, 1.0)]
    out["quantiles_count"] = agg.bucket_quantile(buckets, 0.5, count=buckets[-1][1] * 2)
    out["empty"] = agg.bucket_quantile([], 0.5)
    try:
        out["flat"] = agg.merge_metrics([p.samples for p in parsed])
    except ValueError as e:
        out["flat_error"] = str(e)
    return out


@pytest.mark.parametrize("seed", range(N_TEXTS))
def test_aggregate_merges_as_jax(seed):
    texts = make_texts(seed)
    jax, torch = _agg_record(jagg, texts), _agg_record(tagg, texts)
    assert torch == jax
    assert ("merge_error" in jax) == (seed % 3 == 2)
    if "merge_error" in jax:
        assert "mismatched histogram bucket boundaries" in jax["merge_error"]


# ---------------------------------------------------------------- endpoints


class _Endpoint:
    """A fake component: fixed bodies by path, 404 for anything else."""

    def __init__(self, bodies):
        bodies = dict(bodies)

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                body = bodies.get(path)
                code = 200 if body is not None else 404
                data = (body if isinstance(body, str) else json.dumps(body or {})).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self.httpd.daemon_threads = True
        self.url = "http://127.0.0.1:%d" % self.httpd.server_address[1]
        self._th = threading.Thread(target=self.httpd.serve_forever,
                                    kwargs={"poll_interval": 0.05}, daemon=True)
        self._th.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._th.join(timeout=5)


def _span(comp, sid, start, trace="t1", dur=1.5, err=""):
    sp = {"component": comp, "spanId": sid, "traceId": trace, "name": f"{comp}.op{sid}",
          "start": start, "durationMs": dur}
    if err:
        sp["error"] = err
    return sp


def _events(comp, base):
    return {"components": {comp: [
        {"t_mono": base + 0.1, "wall": 1000.0 + base, "kind": "shed_429", "rv": 7},
        {"t_mono": base + 0.2, "wall": 1001.5 + base, "kind": "gang_attempt",
         "trace": "t1", "gang": "g"},
        {"t_mono": base + 0.3, "wall": 1002.0 + base, "kind": "slo_breach"}],
        "shared": [{"t_mono": 1.0, "wall": 999.0, "kind": "wal_repair"}]}}


@pytest.fixture()
def endpoints():
    texts = make_texts(0)
    eps = {
        "api": _Endpoint({"/metrics": texts[0],
                          "/debug/traces": {"component": "apiserver", "spans": [
                              _span("apiserver", "a1", 1000.5), _span("apiserver", "a2", 1003.0,
                                                                      err="boom")]},
                          "/debug/flightrecorder": _events("apiserver", 0.0)}),
        "sched": _Endpoint({"/metrics": texts[1] + (
            "# TYPE ktpu_podscrape_up gauge\nktpu_podscrape_up{pod=\"p\"} 1\n"
            "ktpu_podscrape_staleness_seconds{pod=\"p\"} 0.5\n"
            "ktpu_hpa_desired_replicas{hpa=\"h\"} 3\nktpu_hpa_current_replicas{hpa=\"h\"} 2\n"
            "ktpu_hpa_observed_value{hpa=\"h\",metric=\"qps\"} 12.5\n"),
                            "/debug/traces": {"component": "scheduler", "spans": [
                                _span("scheduler", "s1", 1001.0), _span("apiserver", "a1",
                                                                        1000.5)]},
                            "/debug/flightrecorder": _events("scheduler", 5.0)}),
        # a component of the port: /metrics and traces, no flight recorder
        "kubelet": _Endpoint({"/metrics": texts[2].replace("ktpu_latency_seconds",
                                                            "ktpu_kubelet_latency_seconds"),
                              "/debug/traces": {"component": "kubelet", "spans": []}}),
    }
    yield eps
    for e in eps.values():
        e.stop()


def _dead_url():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def _collector(mod, eps, dead):
    c = mod.ObsCollector(interval=60.0, fetch_timeout=1.0)
    c.register("apiserver", eps["api"].url, instance="apiserver-0")
    c.register("scheduler", eps["sched"].url, shard=1)
    c.register("kubelet", eps["kubelet"].url, instance="node-0")
    c.register("kubelet", dead, instance="node-gone")
    c.register("scheduler", eps["sched"].url)  # scheduler-1
    c.unregister("scheduler-1")
    c.register("scheduler", eps["sched"].url)  # scheduler-1 again
    for tgt in c.targets():
        tgt.ok = c.scrape_once(tgt)
    return c


def _masked_metrics(text):
    out = []
    for line in text.splitlines():
        if line.startswith(("ktpu_obs_scrape_staleness_seconds", "ktpu_obs_scrape_duration",
                            "ktpu_obs_scrape_seconds_total", "ktpu_obs_scrape_error_seconds")):
            line = line.rsplit(" ", 1)[0] + " <t>"
        out.append(line)
    return out


def _masked_topology(topo, urls):
    for inst in topo["instances"]:
        inst["url"] = urls.get(inst["url"], inst["url"])
        if inst["staleness_s"] is not None:
            inst["staleness_s"] = "<t>"
    return topo


def test_collector_views_as_jax(endpoints):
    dead = _dead_url()
    urls = {e.url: name for name, e in endpoints.items()}
    urls[dead] = "dead"
    got = {}
    for side, mod in (("jax", jcollector), ("torch", tcollector)):
        c = _collector(mod, endpoints, dead)
        try:
            got[side] = {
                "ok": [(t.instance, t.ok, t.up, t.scrapes, t.errors) for t in c.targets()],
                "metrics": _masked_metrics(c.render_fleet_metrics()),
                "topology": _masked_topology(c.topology(), urls),
                "traces": c.traces(), "trace": c.traces("t1"),
                "flight": c.flightrecorder(),
                "counters": (c.scrapes_total, c.scrape_errors_total)}
        finally:
            c.stop()
    assert got["torch"] == got["jax"]
    rec = got["jax"]
    assert [o[:3] for o in rec["ok"]] == [("apiserver-0", True, True), ("scheduler-0", True, True),
                                          ("node-0", True, True), ("node-gone", False, False),
                                          ("scheduler-1", True, True)]
    assert rec["topology"]["scaling"]["hpas"] == {"h": {"desired": 3.0, "current": 2.0,
                                                        "observed": {"qps": 12.5}}}
    # the target without /debug/flightrecorder adds nothing, as a dead one
    assert sorted(rec["flight"]["components"]) == ["apiserver", "scheduler", "shared"]
    assert [s["spanId"] for s in rec["traces"]["spans"]] == ["a1", "s1", "a2"]
    assert rec["traces"]["components"] == ["apiserver", "kubelet", "scheduler"]


def test_port_collector_serves_its_views_over_http(endpoints):
    import urllib.request

    c = tcollector.ObsCollector(interval=0.05)
    c.register("apiserver", endpoints["api"].url)
    c.register("kubelet", endpoints["kubelet"].url)
    c.start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not all(t.up for t in c.targets()):
            time.sleep(0.02)
        assert all(t.up for t in c.targets())

        def get(path):
            with urllib.request.urlopen(c.url + path, timeout=5) as r:
                return r.status, r.read().decode()

        code, text = get("/metrics")
        assert code == 200 and 'ktpu_obs_scrape_up{instance="kubelet-0"} 1' in text
        assert "ktpu_phase_seconds_bucket" in text
        code, body = get("/debug/topology")
        assert [i["instance"] for i in json.loads(body)["instances"]] == ["apiserver-0",
                                                                          "kubelet-0"]
        code, body = get("/debug/flightrecorder")
        assert sorted(json.loads(body)["components"]) == ["apiserver", "shared"]
        code, body = get("/debug/traces?trace=t1")
        assert json.loads(body)["trace"] == "t1"
        assert get("/healthz") == (200, '{"status":"ok"}')
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        c.stop()


# ---------------------------------------------------------------- timeline


def test_timeline_capture_as_jax(endpoints):
    got = {}
    for side, mod, tl in (("jax", jcollector, jtimeline), ("torch", tcollector, ttimeline)):
        c = mod.ObsCollector(interval=60.0)
        c.register("apiserver", endpoints["api"].url)
        c.register("scheduler", endpoints["sched"].url)
        c.register("kubelet", endpoints["kubelet"].url)
        try:
            full = tl.capture(c)
            got[side] = {"full": full, "since": tl.capture(c, since_wall=1001.2, max_entries=5),
                         "trace": tl.capture(c, trace_id="t1"),
                         "summary": tl.summarize(full, head=6), "none": tl.summarize({})}
        finally:
            c.stop()
    assert got["torch"] == got["jax"]
    full = got["jax"]["full"]
    assert full["counts"] == {"events": 7, "spans": 3}
    assert full["keys"]["rv:7"] == 2 and len(got["jax"]["since"]["entries"]) == 5


# ---------------------------------------------------------------- scorecard


class _Target:
    def __init__(self, parsed, up, last):
        self.parsed, self.up, self.last_scrape_mono = parsed, up, last


class _FakeCollector:
    def __init__(self):
        self.tgts = []

    def targets(self):
        return list(self.tgts)


class _PCMs:
    def __init__(self, side):
        self.side, self.rows = side, []

    def list(self, namespace="", label_selector=None):
        if self.rows == "boom":
            raise ConnectionError("apiserver blip")
        t_, fd = (jt, jax_from_dict) if self.side == "jax" else (tt, torch_from_dict)
        return [fd(t_.PodCustomMetrics, r) for r in self.rows], "1"


class _PodsClientset:
    def __init__(self, side):
        self.podcustommetrics = _PCMs(side)


def _fleet_text(rng):
    lat = _histogram_lines(rng, "ktpu_req_seconds", {}, BOUNDS[0])
    return "\n".join(["# TYPE ktpu_req_seconds histogram", *lat,
                      "# TYPE ktpu_queue gauge", f"ktpu_queue{{q=\"a\"}} {int(rng.integers(0, 9))}",
                      f"ktpu_queue{{q=\"b\"}} {int(rng.integers(0, 9))}"]) + "\n"


def test_scorecard_judges_as_jax():
    rng_texts = np.random.default_rng(SEED)
    texts = [[_fleet_text(rng_texts) for _ in range(2)] for _ in range(12)]
    rng_fed = np.random.default_rng(SEED + 1).uniform(0, 2, size=12)
    got = {}
    for side, mod, agg, fr in (("jax", jscorecard, jagg, jflightrec),
                               ("torch", tscorecard, tagg, tflightrec)):
        fr.reset()
        col, cs = _FakeCollector(), _PodsClientset(side)
        sc = mod.Scorecard(collector=col, clientset=cs, stale_after_s=5.0)
        alerts = ((6.0, 2.0, 2.0), (12.0, 4.0, 1.5))
        sc.extend([
            mod.SLO("p99", 0.5, metric="ktpu_req_seconds", labels={"quantile": "0.99"},
                    objective=0.8, burn_alerts=alerts, scenario="serve"),
            mod.SLO("queue", 6.0, op="<", metric="ktpu_queue", reduce="sum",
                    objective=0.5, burn_alerts=alerts),
            mod.SLO("queue-avg", 2.0, op=">=", metric="ktpu_queue", reduce="avg",
                    labels={"q": "a"}, objective=0.6),
            mod.SLO("fed", 1.0, source="fed", op=">", objective=0.9, burn_alerts=alerts),
            mod.SLO("qps", 10.0, source="pods", metric="ktpu_llama_qps", op=">=",
                    reduce="min", objective=0.7, burn_alerts=alerts),
        ])
        hooks = []
        sc.on_breach(lambda slo, ev: hooks.append((slo.name, ev)))
        sc.on_breach(lambda slo, ev: 1 / 0)  # a raising hook is survived
        ticks = []
        for k in range(12):
            now = 100.0 + 1.5 * k
            col.tgts = [_Target(agg.parse_metrics_text(texts[k][0]), True, now - 1.0),
                        _Target(agg.parse_metrics_text(texts[k][1]), k % 4 != 3,
                                now - (9.0 if k % 5 == 4 else 0.5))]
            if k == 7:
                col.tgts = []
            if k % 3 == 0:
                sc.feed("fed", float(rng_fed[k]))
            cs.podcustommetrics.rows = "boom" if k == 5 else [
                {"metadata": {"name": f"p{j}", "namespace": "default"},
                 "stale": j == 1 and k % 2 == 0,
                 "samples": [{"name": "ktpu_llama_qps", "value": 5.0 + k + 3 * j},
                             {"name": "other", "value": 1.0}]} for j in range(2)]
            ticks.append(sc.tick(now=now))
        events = [{k: v for k, v in ev.items() if k not in ("t_mono", "wall")}
                  for ev in fr.dump()["components"].get("scorecard", [])]
        got[side] = {"ticks": ticks, "verdict": sc.verdict(), "render": sc.render(),
                     "hooks": hooks, "breached": sc.breached_slos(), "events": events,
                     "slos": [s.name for s in sc.slos()]}
        with pytest.raises(ValueError):
            sc.add(mod.SLO("p99", 1.0, metric="x"))
        with pytest.raises(KeyError):
            sc.feed("nope", 1.0)
        for bad in ({"op": "=="}, {"reduce": "median"}, {"source": "x"}, {"objective": 1.0}):
            with pytest.raises(ValueError):
                mod.SLO("bad", 1.0, **bad)
        fr.reset()
    assert got["torch"] == got["jax"]
    rec = got["jax"]
    assert rec["breached"] and rec["hooks"] and rec["events"]
    assert any(v["missing"] for v in rec["verdict"].values())
    assert "ktpu_slo_burn_rate" in rec["render"] and "ktpu_slo_eval_errors_total" in rec["render"]


def test_scorecard_serves_its_metrics():
    import urllib.request

    sc = tscorecard.Scorecard()
    sc.add(tscorecard.SLO("fed", 1.0, source="fed"))
    sc.feed("fed", 0.5)
    sc.tick()
    url = sc.serve()
    try:
        with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
            assert 'ktpu_slo_good_total{slo="fed"} 1' in r.read().decode()
        sc.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and sc.verdict()["fed"]["good"] < 2:
            time.sleep(0.05)
        assert sc.verdict()["fed"]["good"] >= 2
    finally:
        sc.stop()


# ---------------------------------------------------------- startup SLIs


def make_pods(seed: int):
    """Seeded pod wire dicts and the (index, now) events a tracker sees."""
    rng = np.random.default_rng(SEED + 100 + seed)
    pods, events = [], []
    for i in range(24):
        t0 = 1000.0 + float(rng.uniform(0, 10))
        stamps = {}
        chain = t0
        for key in ("created-at", "scheduled-at", "bound-at", "admitted-at"):
            if rng.integers(8) == 0:
                continue  # a stamp missing: the decomposition is incomplete
            stamps[f"slo.ktpu.io/{key}"] = f"{chain:.6f}"
            chain += float(rng.exponential(0.2))
        if rng.integers(10) == 0:
            stamps["slo.ktpu.io/bound-at"] = "garbage"
        spec = {"nodeName": "n0" if rng.integers(2) else "", "containers": [{"name": "c"}]}
        if rng.integers(3) == 0:
            spec["extendedResources"] = [{"name": "cards", "resource": "nvidia.com/gpu",
                                          "quantity": 1}]
        base = {"metadata": {"name": f"p{i}", "namespace": "default", "uid": f"u{i}",
                             "annotations": stamps}, "spec": spec}
        first = "Running" if rng.integers(6) == 0 else "Pending"
        pods.append([dict(base, status={"phase": first}),
                     dict(base, status={"phase": "Running"})])
        events += [(i, 0, chain), (i, 1, chain + float(rng.uniform(0, 0.5))),
                   (i, 1, chain + 1.0)]
    order = rng.permutation(len(events))
    return pods, [events[k] for k in order]


def _sli_record(side, pods, events):
    if side == "jax":
        cs, mod, t_, fd = JaxClientset("http://127.0.0.1:9"), jslo, jt, jax_from_dict
    else:
        cs, mod, t_, fd = TorchClientset("http://127.0.0.1:9"), tslo, tt, torch_from_dict
    try:
        tr = mod.StartupSLITracker(cs)
        typed = [[fd(t_.Pod, p) for p in pair] for pair in pods]
        seen = set()
        for i, k, now in events:
            if k == 1 and (i, 0) not in seen:
                k = 0  # a pod's first event is its first state
            seen.add((i, k))
            tr.record(typed[i][k], now=now)
        tr._on_delete(typed[0][1])
        return {"report": tr.report(), "render": tr.registry.render()}
    finally:
        cs.close()


@pytest.mark.parametrize("seed", range(4))
def test_startup_sli_tracker_records_as_jax(seed):
    pods, events = make_pods(seed)
    jax, torch = _sli_record("jax", pods, events), _sli_record("torch", pods, events)
    assert torch == jax
    assert jax["report"]["total"]["count"] >= 5
    assert "device_allocation" in jax["report"]


# ---------------------------------------------------------------- event loop


def test_event_loop_runs_timers_and_callbacks_in_order():
    loop = teventloop.EventLoop(name="test-loop").start()
    try:
        ran, done = [], threading.Event()
        loop.call_later(0.05, lambda: ran.append("late"))
        t = loop.call_later(0.02, lambda: ran.append("cancelled"))
        t.cancel()
        loop.call_later(0.01, lambda: ran.append("early"))
        loop.call_soon(lambda: 1 / 0)  # a raising callback does not stop the loop
        loop.call_soon(lambda: ran.append("soon"))
        loop.call_later(0.08, done.set)
        assert done.wait(5)
        assert ran == ["soon", "early", "late"]
        assert teventloop.loop_lag_seconds.count >= 3
    finally:
        loop.stop()
    assert not loop.is_alive()
    assert teventloop.shared_loop() is teventloop.shared_loop()
    pool_ran = threading.Event()
    teventloop.shared_pool().submit(pool_ran.set)
    assert pool_ran.wait(5)
