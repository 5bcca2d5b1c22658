"""ObsCollector: the fleet's one observability endpoint.

The port's copy of the JAX package's ``obs/collector.py``.  Every
component endpoint is REGISTERED (``LocalCluster`` registers its
apiserver, scheduler, startup SLI tracker and kubelets); each target is a
timer on the shared event loop (``utils/eventloop``) whose tick submits
the blocking fetch to the shared worker pool and re-arms only after it
completes, so at most one scrape per target is in flight and a dead
target wedges one pool slot, never the collector.  A fetch goes through
the port's retry policy (``utils/retry.call_with_retries``).  From its
last-good snapshots (serving never waits on a scrape) the collector
serves:

  ``/metrics``              the fleet-merged series (``obs/aggregate``:
                            counters sum, histograms bucket by bucket,
                            quantiles recomputed) plus per-instance
                            scrape gauges (up, staleness, duration) and
                            its own counters;
  ``/debug/traces``         the union of every target's ``/debug/traces``
                            (fetched concurrently, spans deduped on
                            component and span id);
  ``/debug/topology``       the instances with their scrape staleness;
  ``/debug/flightrecorder`` the union of the targets' flight-recorder
                            rings.  A target without the endpoint (the
                            port's components serve none yet) is skipped,
                            as a target whose fetch fails.

The JAX package's ``obs.scrape`` faultline site is not here.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from ..client.errors import is_transient
from ..utils import eventloop
from ..utils import retry as _retry
from ..utils.logutil import RateLimitedReporter
from . import aggregate

# Per-request timeout for one scrape/fan-out fetch: a slow target is cut
# off here, not waited out — the collector's freshness contract is "best
# view within ~interval", never "block until every target answers".
DEFAULT_FETCH_TIMEOUT = 1.0
DEFAULT_INTERVAL = 1.0


class _Target:
    """One registered component endpoint + its scrape state.  Scrape
    state fields are written by the target's scrape jobs (shared worker
    pool) and read by the serving path under the collector lock —
    last-good snapshot semantics (a failing scrape keeps the previous
    parse, marked stale).
    """

    def __init__(self, component: str, instance: str, url: str,
                 shard: Optional[int]):
        self.component = component
        self.instance = instance
        self.url = url.rstrip("/")
        self.shard = shard
        self.parsed: Optional[aggregate.ParsedMetrics] = None
        self.last_scrape_mono: Optional[float] = None
        self.last_fetch_start = 0.0  # newest committed fetch's start time
        self.last_duration_s = 0.0
        self.up = False
        self.scrapes = 0
        self.errors = 0
        self.timer: Optional[eventloop.Timer] = None  # next interval tick
        self.stop = threading.Event()


class ObsCollector:
    """See module docstring.  start() boots the HTTP surface and one
    scrape timer per registered target; register() after start() kicks
    the new target's first scrape immediately."""

    def __init__(self, interval: float = DEFAULT_INTERVAL,
                 host: str = "127.0.0.1", port: int = 0,
                 fetch_timeout: float = DEFAULT_FETCH_TIMEOUT):
        self.interval = interval
        self.fetch_timeout = fetch_timeout
        self._loop = eventloop.shared_loop()
        self._pool = eventloop.shared_pool()
        self._targets: Dict[str, _Target] = {}
        self._lock = threading.Lock()
        self._started = False
        self._stopping = threading.Event()
        # collector economics, exported on the fleet /metrics:
        # scrape_seconds_total counts SUCCESSFUL scrape wall-time only (the
        # collector's overhead); a dead target's blocked socket waits are
        # idle time, not work, and land in scrape_error_seconds_total
        self.scrape_seconds_total = 0.0
        self.scrape_error_seconds_total = 0.0
        self.scrapes_total = 0
        self.scrape_errors_total = 0
        self._err_reporter = RateLimitedReporter("obs-collector", window=30.0)
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self.host = host
        self.port = port
        self.url = ""

    # ------------------------------------------------------------ registry

    def register(self, component: str, url: str, instance: str = "",
                 shard: Optional[int] = None) -> str:
        """Register one component endpoint; returns the instance name
        (generated ``<component>-<n>`` when not given).  Idempotent on
        instance: re-registering moves the URL (a restarted component
        keeps its identity in the topology)."""
        with self._lock:
            if not instance:
                # first unused suffix, not the live count: after an
                # unregister, count-based naming collides with a LIVE
                # target and the idempotent branch would hijack its URL
                n = 0
                while f"{component}-{n}" in self._targets:
                    n += 1
                instance = f"{component}-{n}"
            old = self._targets.get(instance)
            if old is not None:
                # re-registration is a full identity refresh: a restarted
                # or re-sharded component keeps its instance name but its
                # URL/component/shard must reflect the NEW reality — and
                # a MOVED endpoint drops the dead process's last-good
                # snapshot, or the fleet view would keep merging the old
                # process's counters until the new URL first answers
                new_url = url.rstrip("/")
                if old.url != new_url:
                    old.parsed = None
                    old.last_scrape_mono = None
                    old.up = False
                    # an in-flight fetch of the OLD url must not commit
                    # after the move: it started before now
                    old.last_fetch_start = time.monotonic()
                old.url = new_url
                old.component = component
                old.shard = shard
                return instance
            tgt = _Target(component, instance, url, shard)
            self._targets[instance] = tgt
            started = self._started
        if started:
            self._schedule_scrape(tgt)
        return instance

    def unregister(self, instance: str):
        with self._lock:
            tgt = self._targets.pop(instance, None)
        if tgt is not None:
            tgt.stop.set()
            if tgt.timer is not None:
                tgt.timer.cancel()

    def targets(self) -> List[_Target]:
        with self._lock:
            return list(self._targets.values())

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "ObsCollector":
        self._start_http()
        with self._lock:
            self._started = True
            tgts = list(self._targets.values())
        for t in tgts:
            self._schedule_scrape(t)
        return self

    def stop(self):
        self._stopping.set()
        with self._lock:
            tgts = list(self._targets.values())
            self._started = False
        for t in tgts:
            t.stop.set()
            if t.timer is not None:
                # an in-flight pool job checks the stop flags before it
                # scrapes and never re-arms past them — nothing to join
                t.timer.cancel()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._http_thread is not None:
                self._http_thread.join(timeout=3.0)

    # --------------------------------------------------------------- scraping

    def _schedule_scrape(self, tgt: _Target):
        """Submit one scrape of ``tgt`` to the shared pool; the job
        re-arms the target's interval timer AFTER it completes, so at
        most one scrape per target is ever queued or running (the old
        per-target thread's ``scrape_once(); wait(interval)`` pacing)."""
        def job():
            if tgt.stop.is_set() or self._stopping.is_set():
                return
            self.scrape_once(tgt)
            if tgt.stop.is_set() or self._stopping.is_set():
                return
            tgt.timer = self._loop.call_later(
                self.interval, lambda: self._pool.submit(job))

        self._pool.submit(job)

    def _fetch(self, url: str) -> str:
        """One HTTP GET, cut off at the fetch timeout (it runs in a pool
        slot: a wedged target can only wedge itself)."""
        with urllib.request.urlopen(url, timeout=self.fetch_timeout) as r:
            return r.read().decode()

    def scrape_once(self, tgt: _Target) -> bool:
        """One scrape of one target through the shared retry policy.
        Updates the target's last-good snapshot; never raises."""
        t0 = time.monotonic()
        try:
            text = _retry.call_with_retries(
                lambda: self._fetch(tgt.url + "/metrics"), is_transient,
                steps=2, reason="obs_scrape",
                backoff=_retry.Backoff(base=0.02, cap=0.1))
        except Exception as e:  # noqa: BLE001 — a dead target is a data point, not a crash
            with self._lock:
                tgt.up = False
                tgt.errors += 1
                self.scrape_errors_total += 1
                self.scrape_error_seconds_total += time.monotonic() - t0
            self._err_reporter.report(f"scrape {tgt.instance}: {e}")
            return False
        parsed = aggregate.parse_metrics_text(text)
        dur = time.monotonic() - t0
        with self._lock:
            if t0 > tgt.last_fetch_start:
                # a slow in-flight periodic fetch finishing AFTER a
                # forced final round must not overwrite the newer parse
                # with its older counters
                tgt.last_fetch_start = t0
                tgt.parsed = parsed
                tgt.last_scrape_mono = time.monotonic()
                tgt.last_duration_s = dur
                tgt.up = True
            tgt.scrapes += 1
            self.scrapes_total += 1
            self.scrape_seconds_total += dur
        return True

    # -------------------------------------------------------------- rendering

    def render_fleet_metrics(self) -> str:
        """Fleet-merged series + per-instance scrape gauges, from the
        last-good snapshots only (never blocks on a scrape)."""
        with self._lock:
            tgts = list(self._targets.values())
            snaps = [t.parsed for t in tgts if t.parsed is not None]
            scrape_lines = self._scrape_gauge_lines_locked(tgts)
        merged = aggregate.merge_parsed(snaps)
        return aggregate.render_metrics(merged) + "\n".join(scrape_lines) \
            + ("\n" if scrape_lines else "")

    def _scrape_gauge_lines_locked(self, tgts: List[_Target]) -> List[str]:
        now = time.monotonic()
        lines = ["# TYPE ktpu_obs_scrape_up gauge"]
        for t in tgts:
            lines.append(
                f'ktpu_obs_scrape_up{{instance="{t.instance}"}} '
                f"{1 if t.up else 0}")
        lines.append("# TYPE ktpu_obs_scrape_staleness_seconds gauge")
        for t in tgts:
            stale = (now - t.last_scrape_mono
                     if t.last_scrape_mono is not None else -1.0)
            lines.append(
                f'ktpu_obs_scrape_staleness_seconds'
                f'{{instance="{t.instance}"}} {stale:.3f}')
        lines.append("# TYPE ktpu_obs_scrape_duration_seconds gauge")
        for t in tgts:
            lines.append(
                f'ktpu_obs_scrape_duration_seconds'
                f'{{instance="{t.instance}"}} {t.last_duration_s:.4f}')
        lines += [
            "# TYPE ktpu_obs_scrapes_total counter",
            f"ktpu_obs_scrapes_total {self.scrapes_total}",
            "# TYPE ktpu_obs_scrape_errors_total counter",
            f"ktpu_obs_scrape_errors_total {self.scrape_errors_total}",
            "# TYPE ktpu_obs_scrape_seconds_total counter",
            f"ktpu_obs_scrape_seconds_total {self.scrape_seconds_total:.4f}",
            "# TYPE ktpu_obs_scrape_error_seconds_total counter",
            f"ktpu_obs_scrape_error_seconds_total "
            f"{self.scrape_error_seconds_total:.4f}",
        ]
        return lines

    def topology(self) -> dict:
        with self._lock:
            tgts = list(self._targets.values())
            now = time.monotonic()
            return {
                "scrape_interval_s": self.interval,
                "instances": [{
                    "instance": t.instance,
                    "component": t.component,
                    "url": t.url,
                    "shard": t.shard,
                    "up": t.up,
                    "scrapes": t.scrapes,
                    "errors": t.errors,
                    "staleness_s": (round(now - t.last_scrape_mono, 3)
                                    if t.last_scrape_mono is not None
                                    else None),
                } for t in tgts],
                "scaling": self._scaling_view_locked(tgts),
            }

    def _scaling_view_locked(self, tgts: List[_Target]) -> dict:
        """The custom-metrics scaling loop, federated from last-good
        snapshots: per-kubelet pod-scrape health (how fresh the workload
        SLIs feeding the HPAs are) and every HPA's current decision —
        one place that answers 'why is this Deployment at N replicas'."""
        pod_scrape: Dict[str, dict] = {}
        hpas: Dict[str, dict] = {}
        for t in tgts:
            parsed = t.parsed
            if parsed is None:
                continue
            targets_n = up_n = 0
            stale_max = None
            for key, value in parsed.samples.items():
                if key.startswith("ktpu_podscrape_up{"):
                    targets_n += 1
                    up_n += 1 if value else 0
                elif key.startswith("ktpu_podscrape_staleness_seconds{"):
                    if stale_max is None or value > stale_max:
                        stale_max = value
                elif key.startswith("ktpu_hpa_"):
                    try:
                        name, labels = aggregate.parse_series_key(key)
                    except ValueError:
                        continue
                    hpa = labels.get("hpa")
                    if not hpa:
                        continue
                    entry = hpas.setdefault(hpa, {})
                    if name == "ktpu_hpa_desired_replicas":
                        entry["desired"] = value
                    elif name == "ktpu_hpa_current_replicas":
                        entry["current"] = value
                    elif name == "ktpu_hpa_observed_value":
                        entry.setdefault("observed", {})[
                            labels.get("metric", "")] = value
            if targets_n:
                pod_scrape[t.instance] = {
                    "targets": targets_n,
                    "up": up_n,
                    "staleness_max_s": (round(stale_max, 3)
                                        if stale_max is not None else None),
                }
        return {"pod_scrape": pod_scrape, "hpas": hpas}

    # ------------------------------------------------------------- fan-outs

    def _fan_out_json(self, path: str) -> Dict[str, dict]:
        """GET ``path`` from every target CONCURRENTLY (per-fetch timeout,
        404/refused tolerated) -> {instance: parsed json}.  Bounded wall:
        one round trip, not N — the join waits the fetch timeout once."""
        tgts = self.targets()
        results: Dict[str, dict] = {}
        res_lock = threading.Lock()

        def fetch_one(t: _Target):
            try:
                body = self._fetch(t.url + path)
                data = json.loads(body)
            except Exception:  # noqa: BLE001 — absent endpoint/dead target: skip it
                return
            with res_lock:
                results[t.instance] = data

        threads = [threading.Thread(
                       target=fetch_one, args=(t,), daemon=True,
                       name="obs-fanout")
                   for t in tgts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=self.fetch_timeout + 2.0)
        return results

    def traces(self, trace_id: str = "") -> dict:
        """Trace-id union across every component's /debug/traces."""
        path = "/debug/traces"
        if trace_id:
            path += f"?trace={trace_id}"
        per_instance = self._fan_out_json(path)
        seen = set()
        spans: List[dict] = []
        components: List[str] = []
        for instance in sorted(per_instance):
            data = per_instance[instance]
            comp = data.get("component") or instance
            if comp not in components:
                components.append(comp)
            for sp in data.get("spans", []):
                key = (sp.get("component"), sp.get("spanId"))
                if key in seen:
                    continue  # two apiservers sharing a process dedup here
                seen.add(key)
                spans.append(sp)
        spans.sort(key=lambda s: s.get("start") or 0)
        return {"trace": trace_id, "components": components, "spans": spans}

    def flightrecorder(self) -> dict:
        """Union of per-component flight-recorder rings across targets:
        events are CONCATENATED per component and time-ordered (two
        scheduler processes both contribute their timelines).  Targets
        sharing one process serve identical rings, so exact-duplicate
        events dedup — never drop a distinct process's events."""
        per_instance = self._fan_out_json("/debug/flightrecorder")
        merged: Dict[str, Dict[tuple, dict]] = {}
        for instance in sorted(per_instance):
            for comp, events in (per_instance[instance]
                                 .get("components") or {}).items():
                bucket = merged.setdefault(comp, {})
                for ev in events:
                    try:
                        key = tuple(sorted(
                            (k, str(v)) for k, v in ev.items()))
                    except AttributeError:
                        continue  # malformed event from a foreign target
                    bucket.setdefault(key, ev)
        return {"components": {
            comp: sorted(evs.values(),
                         key=lambda e: e.get("t_mono") or 0)
            for comp, evs in merged.items()}}

    # ------------------------------------------------------------------ http

    def _start_http(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        collector = self

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                parts = urlsplit(self.path)
                try:
                    if parts.path.startswith("/metrics"):
                        body = collector.render_fleet_metrics().encode()
                        ctype = "text/plain; version=0.0.4"
                    elif parts.path == "/debug/topology":
                        body = json.dumps(
                            collector.topology(),
                            separators=(",", ":")).encode()
                        ctype = "application/json"
                    elif parts.path == "/debug/traces":
                        q = parse_qs(parts.query)
                        body = json.dumps(
                            collector.traces((q.get("trace") or [""])[0]),
                            separators=(",", ":")).encode()
                        ctype = "application/json"
                    elif parts.path == "/debug/flightrecorder":
                        body = json.dumps(
                            collector.flightrecorder(),
                            separators=(",", ":")).encode()
                        ctype = "application/json"
                    elif parts.path == "/healthz":
                        body, ctype = b'{"status":"ok"}', "application/json"
                    else:
                        self.send_response(404)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                except Exception as e:  # noqa: BLE001 — one bad render must not kill the endpoint
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self.port), _H)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="obs-collector-http")
        self._http_thread.start()
