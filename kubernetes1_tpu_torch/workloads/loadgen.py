"""Open-loop synthetic load for the serving data plane.

The port's copy of the JAX package's ``workloads/loadgen.py``, with plain
``threading`` locks and the port's own retry policy and fault seam: the
same constructor, arrival stream, token accounting and summary.

The millions-of-users stand-in: arrivals fire on a clock schedule
(Poisson or constant interarrival at a configured QPS) and NEVER wait
on completions — a slow server meets the same offered load as a fast
one, which is the only load model under which tail latency and
saturation behavior mean anything (a closed loop self-throttles into
flattering numbers).  Per-request accounting is token-granular: time to
first token and every inter-token gap land in the recorder, so the
bench's token p50/p99 comes from the CLIENT side of the stream, proxy
hops included.

Mechanics:
- one arrival thread computes the schedule; each due request is handed
  to a bounded worker pool (in-flight cap => a wedged server degrades
  to counted SHEDS, not a thread explosion — the arrivals stay open-loop
  either way);
- each request passes the ``loadgen.request`` faultline gate, then
  rides ``utils/retry.call_with_retries`` for transient failures;
- an ACKED request is one whose complete response was delivered; the
  zero-lost-acked chaos verdict counts these against server-side
  ledgers.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import faultline
from ..utils import retry as _retry


def _pctl(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


class LoadGen:
    """Open-loop generator against one base URL (a DecodeServer or a
    balancer fronting many).  ``arrival`` is ``poisson`` (exponential
    interarrivals) or ``constant``; ``stream=True`` consumes the
    per-token ndjson stream (token-gap recording), ``False`` posts for
    the buffered JSON body."""

    def __init__(self, url: str, qps: float, arrival: str = "poisson",
                 seed: int = 0, tokens: Tuple[int, ...] = (1, 2, 3),
                 max_new: int = 8, stream: bool = True,
                 max_inflight: int = 64, retries: int = 2,
                 timeout: float = 30.0):
        if arrival not in ("poisson", "constant"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        host, _, port = url.split("//", 1)[-1].partition(":")
        self.host, self.port = host, int(port or 80)
        self.qps = qps
        self.arrival = arrival
        self.tokens = list(tokens)
        self.max_new = max_new
        self.stream = stream
        self.max_inflight = max_inflight
        self.retries = retries
        self.timeout = timeout
        self._rng = random.Random(seed)
        self.offered = 0
        self.issued = 0
        self.acked = 0
        self.failed = 0
        self.shed = 0
        self.ttft_s: List[float] = []
        self.token_gap_s: List[float] = []
        self.request_s: List[float] = []
        self._inflight = 0
        self._lock = threading.Lock()
        self._stopev = threading.Event()
        self._threads: List[threading.Thread] = []
        self._t0 = 0.0
        self._t1 = 0.0

    # ----------------------------------------------------------- control

    def start(self) -> "LoadGen":
        self._t0 = time.monotonic()
        th = threading.Thread(target=self._arrivals, name="loadgen-arrivals",
                              daemon=True)
        th.start()
        self._threads.append(th)
        return self

    def stop(self, drain_s: float = 5.0):
        """Stop arrivals, then give in-flight requests ``drain_s`` to
        finish (their outcomes still count)."""
        self._stopev.set()
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self._t1 = time.monotonic()

    def run(self, duration: float) -> "LoadGen":
        self.start()
        time.sleep(duration)
        self.stop()
        return self

    # ---------------------------------------------------------- arrivals

    def _interarrival(self) -> float:
        rate = max(self.qps, 1e-3)
        if self.arrival == "poisson":
            return self._rng.expovariate(rate)
        return 1.0 / rate

    def _arrivals(self):
        next_t = time.monotonic() + self._interarrival()
        while not self._stopev.is_set():
            now = time.monotonic()
            if now < next_t:
                self._stopev.wait(min(next_t - now, 0.05))
                continue
            next_t += self._interarrival()
            self.offered += 1
            with self._lock:
                if self._inflight >= self.max_inflight:
                    self.shed += 1
                    continue
                self._inflight += 1
                self.issued += 1
            th = threading.Thread(target=self._one, name="loadgen-req",
                                  daemon=True)
            th.start()

    # ----------------------------------------------------------- request

    def _one(self):
        t_start = time.monotonic()
        try:
            gaps: List[float] = []
            ttft: List[float] = []

            def attempt():
                # a retry is a fresh request: wipe any partial recording
                gaps.clear()
                ttft.clear()
                faultline.check("loadgen.request")
                self._request(t_start, ttft, gaps)

            _retry.call_with_retries(
                attempt, steps=self.retries + 1,
                backoff=_retry.Backoff(base=0.01, cap=0.2),
                classify=lambda e: isinstance(
                    e, (OSError, http.client.HTTPException,
                        faultline.FaultInjected)))
            with self._lock:
                self.acked += 1
                self.ttft_s.extend(ttft)
                self.token_gap_s.extend(gaps)
                self.request_s.append(time.monotonic() - t_start)
        except Exception:  # noqa: BLE001 - counted: open-loop errors are data
            with self._lock:
                self.failed += 1
        finally:
            with self._lock:
                self._inflight -= 1

    def _request(self, t_start: float, ttft: List[float],
                 gaps: List[float]):
        body = json.dumps({"tokens": self.tokens, "max_new": self.max_new,
                           "stream": self.stream}).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                raise http.client.HTTPException(f"status {resp.status}")
            if not self.stream:
                out = json.loads(resp.read() or b"{}")
                if "tokens" not in out:
                    raise http.client.HTTPException("no tokens in response")
                ttft.append(time.monotonic() - t_start)
                return
            # ndjson token stream: one line per decode step
            t_prev = t_start
            first = True
            done = False
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                msg = json.loads(line)
                now = time.monotonic()
                if msg.get("done"):
                    done = True
                    break
                if "token" in msg:
                    if first:
                        ttft.append(now - t_start)
                        first = False
                    else:
                        gaps.append(now - t_prev)
                    t_prev = now
            if not done:
                raise http.client.HTTPException("stream truncated")
        finally:
            conn.close()

    # ----------------------------------------------------------- results

    def summary(self) -> Dict[str, object]:
        wall = max((self._t1 or time.monotonic()) - self._t0, 1e-6)
        return {
            "arrival": self.arrival,
            "offered_qps": round(self.offered / wall, 3),
            "achieved_qps": round(self.acked / wall, 3),
            "offered": self.offered,
            "issued": self.issued,
            "acked": self.acked,
            "failed": self.failed,
            "shed": self.shed,
            "ttft_p50_s": _pctl(self.ttft_s, 0.50),
            "ttft_p99_s": _pctl(self.ttft_s, 0.99),
            "token_p50_s": _pctl(self.token_gap_s, 0.50),
            "token_p99_s": _pctl(self.token_gap_s, 0.99),
            "request_p50_s": _pctl(self.request_s, 0.50),
            "request_p99_s": _pctl(self.request_s, 0.99),
        }
