"""Llama-3-style decoder-only transformer and its decode server, in PyTorch.

The port of the JAX package's ``workloads/llama.py`` serving path: the
model (``forward`` over a plain parameter dict) and the continuous-
batching decode server (``BatchEngine``, ``DecodeServer``) with the same
HTTP contract and the same ``ktpu_llama_*`` metrics.  Attention, RMSNorm
and RoPE run as hand-written CUDA kernels on the card
(``kubernetes1_tpu_torch.kernels``); the matrix products stay
``torch.matmul`` and the sampling ``torch.argmax``, as the JAX package
left them to XLA.

Weights keep JAX's ``(d_in, d_out)`` layout and the forward computes
``h @ W``, so weights carried over from the JAX pytree
(``params_from_jax``) need no transpose.  Layers are a list of per-layer
dicts (JAX stacks them on a leading axis for ``lax.scan``).  The training
half (``loss_fn``, the train step, remat, sharding) and
``serving_deployment`` come with later slices.

Llama-3-8B = LlamaConfig(d_model=4096, n_layers=32, n_heads=32,
n_kv_heads=8, d_ff=14336, vocab=128256, rope_theta=500000).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import threading
import time
from functools import partial
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import attention as _attention
from ..kernels import rmsnorm as _rmsnorm
from ..kernels import rope as _rope
from ..obs.appmetrics import AppMetrics
from .sharding import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def llama_3_8b() -> LlamaConfig:
    return LlamaConfig(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                       n_kv_heads=8, d_ff=14336)


def tiny(vocab: int = 256, d_model: int = 64, n_layers: int = 2, n_heads: int = 4,
         n_kv_heads: int = 2, d_ff: int = 128, max_seq: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab=vocab, d_model=d_model, n_layers=n_layers,
                       n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff,
                       max_seq=max_seq)


# ------------------------------------------------------------------- params
#
# Every weight is stored already cast to cfg.dtype, once, at creation or
# load.  The JAX forward keeps f32 weights and casts each to bf16 right
# before its product with the same round-to-nearest-even, so the numbers
# are the same; storing bf16 halves the memory (16 GB for Llama-3-8B
# instead of 32 GB of f32) and drops a cast per weight per step.

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> Dict[str, Any]:
    """Random weights on ``generator``'s device, with the JAX package's
    distributions: normal / sqrt(fan_in) for matrices, ones for norms.
    (The draws differ from ``jax.random``'s; carry JAX weights over with
    ``params_from_jax`` where the numbers must match.)"""
    dev = generator.device
    d, hd = cfg.d_model, cfg.head_dim

    def w(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return x.div_(math.sqrt(fan_in)).to(cfg.dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=cfg.dtype)

    return {
        "embed": w((cfg.vocab, d), d),
        "layers": [{
            "attn_norm": ones(d),
            "wq": w((d, cfg.n_heads * hd), d),
            "wk": w((d, cfg.n_kv_heads * hd), d),
            "wv": w((d, cfg.n_kv_heads * hd), d),
            "wo": w((cfg.n_heads * hd, d), cfg.n_heads * hd),
            "mlp_norm": ones(d),
            "w_gate": w((d, cfg.d_ff), d),
            "w_up": w((d, cfg.d_ff), d),
            "w_down": w((cfg.d_ff, d), cfg.d_ff),
        } for _ in range(cfg.n_layers)],
        "final_norm": ones(d),
        "unembed": w((d, cfg.vocab), d),
    }


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig,
                    device: torch.device | str) -> Dict[str, Any]:
    """The JAX package's parameter pytree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this module's parameter
    dict on ``device``: the stacked leading layer axis is split into one
    dict per layer, and every weight keeps its (d_in, d_out) layout."""
    def tensor(a) -> torch.Tensor:
        # a fresh copy: the port must not alias (or write into) JAX's buffers
        arr = np.array(a, dtype=np.float32, order="C")
        return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)

    layers = tree["layers"]
    if set(layers) != set(LAYER_KEYS):
        raise ValueError(f"layer keys {sorted(layers)} != {sorted(LAYER_KEYS)}")
    n = {np.shape(a)[0] for a in layers.values()}
    if n != {cfg.n_layers}:
        raise ValueError(f"stacked layer axis {n} != n_layers {cfg.n_layers}")
    return {
        "embed": tensor(tree["embed"]),
        "layers": [{key: tensor(layers[key][i]) for key in LAYER_KEYS}
                   for i in range(cfg.n_layers)],
        "final_norm": tensor(tree["final_norm"]),
        "unembed": tensor(tree["unembed"]),
    }


# ------------------------------------------------------------------ modules

class Ops(NamedTuple):
    """The three kernel-backed ops of the forward."""

    rmsnorm: Callable
    rope: Callable
    attention: Callable


# The wrappers: the kernels on CUDA tensors, the plain versions on CPU ones.
KERNELS = Ops(_rmsnorm.rmsnorm, _rope.rope, _attention.attention)
# The plain versions on every device: the reference a card run compares with.
PLAIN = Ops(_rmsnorm.rmsnorm_plain, _rope.rope_plain, _attention.attention_plain)


def layer_fn(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
             ops: Ops = KERNELS) -> torch.Tensor:
    B, S, d = x.shape
    hd = cfg.head_dim
    h = ops.rmsnorm(x, lp["attn_norm"])
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q, k = ops.rope(q, k, cfg.rope_theta)
    attn = ops.attention(q, k, v).reshape(B, S, cfg.n_heads * hd)
    x = x + attn @ lp["wo"]
    h = ops.rmsnorm(x, lp["mlp_norm"])
    x = x + (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return x


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            ops: Ops = KERNELS) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) float32; positions
    are arange(S) on every row."""
    x = params["embed"][tokens]
    for lp in params["layers"]:
        x = layer_fn(cfg, x, lp, ops)
    x = ops.rmsnorm(x, params["final_norm"])
    return (x @ params["unembed"]).float()


# ------------------------------------------------------------ decode serving

def greedy_decode(cfg: LlamaConfig, params: Dict[str, Any], step_fn,
                  tokens, max_new: int = 8) -> list:
    """Greedy continuation of a prompt, one full forward per new token
    (no KV cache, as in the JAX package); returns the new token ids."""
    toks = [int(x) % cfg.vocab for x in tokens] or [1]
    device = params["embed"].device
    out = []
    with torch.inference_mode():
        for _ in range(max_new):
            window = torch.tensor([toks[-cfg.max_seq:]], dtype=torch.long, device=device)
            logits = step_fn(params, window)
            nxt = int(torch.argmax(logits[0, -1]))
            toks.append(nxt)
            out.append(nxt)
    return out


# Sequence-length buckets for the batched forward: every step pads to the
# next power of two (at least 8, at most max_seq), so the batch shape
# space is |buckets|, as in the JAX engine (where it bounds retraces).
def _seq_bucket(n: int, max_seq: int) -> int:
    b = 8
    while b < n and b < max_seq:
        b *= 2
    return min(b, max_seq)


class SlotLease:
    """One admitted request's handle: a per-request token stream.  The
    engine pushes each decoded token as its step completes; ``None``
    terminates the stream (max_new reached or engine shutdown)."""

    def __init__(self, tokens, max_new: int):
        self.prompt = list(tokens)
        self.max_new = max_new
        self.out: "queue.Queue[Optional[int]]" = queue.Queue()
        self.produced = 0
        self.slot: Optional[int] = None  # assigned at admission
        self.t_submit = 0.0
        self.t_last = 0.0

    def stream(self):
        """Yield tokens as the engine produces them (blocks between
        steps; ends at max_new)."""
        while True:
            tok = self.out.get()
            if tok is None:
                return
            yield tok

    def result(self, timeout: float = 60.0) -> list:
        """Drain the stream to a list (the non-streaming callers)."""
        deadline = time.monotonic() + timeout
        toks = []
        for tok in self.stream():
            toks.append(tok)
            if time.monotonic() > deadline:
                break
        return toks


class BatchEngine:
    """Continuous batching: ONE decode loop folds every in-flight request
    into a single forward per step, admitting new requests at step
    boundaries.  Capacity is the fixed slot pool, so saturation shows as
    ``ktpu_llama_slots_used`` against ``ktpu_llama_slots_total`` before
    it shows as latency.

    Rows are RIGHT-padded (real tokens first), positions are arange and
    attention is causal, so row i's logits at index len_i - 1 do not
    depend on the padding: batched greedy decode gives the tokens of
    sequential greedy decode.  Empty slots run as all-zero rows and read
    index 0, as in the JAX engine."""

    def __init__(self, cfg: LlamaConfig, params, step_fn,
                 slots: int = 8, metrics: Optional[AppMetrics] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self._step = step_fn
        self.slots = slots
        self._pending: List[SlotLease] = []
        self._active: Dict[int, SlotLease] = {}
        self._cond = threading.Condition()
        self._stopping = False
        self.steps = 0
        self.tokens_out = 0
        self.metrics = metrics
        if metrics is not None:
            self.slots_total = metrics.gauge(
                "ktpu_llama_slots_total", "decode batch slot pool size")
            self.slots_used = metrics.gauge(
                "ktpu_llama_slots_used", "decode batch slots leased")
            self.occupancy = metrics.histogram(
                "ktpu_llama_batch_occupancy",
                "active requests per decode step")
            self.token_latency = metrics.histogram(
                "ktpu_llama_token_latency_seconds",
                "per-token latency (inter-token gap; first = from admit)")
            self.slots_total.set(float(slots))
            self.slots_used.set(0.0)
        # one engine thread per server, not per connection/request: the
        # whole point is that N requests share this single decode loop
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="llama-batch-engine")
        self._thread.start()

    # ---------------------------------------------------------- intake

    def submit(self, tokens, max_new: int = 8) -> SlotLease:
        lease = SlotLease([int(x) % self.cfg.vocab for x in tokens] or [1],
                          max_new)
        lease.t_submit = lease.t_last = time.monotonic()
        with self._cond:
            if self._stopping:  # stopped, or the engine failed: end at once
                lease.out.put(None)
                return lease
            self._pending.append(lease)
            self._cond.notify()
        return lease

    def stop(self):
        with self._cond:
            self._stopping = True
            self._cond.notify()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------ loop

    def _admit_locked(self):
        """Step-boundary admission: lease free slots to waiting
        requests, FIFO."""
        free = [s for s in range(self.slots) if s not in self._active]
        while free and self._pending:
            lease = self._pending.pop(0)
            lease.slot = free.pop(0)
            self._active[lease.slot] = lease

    def _end_all_locked(self):
        """Terminate every admitted and waiting request's stream."""
        for lease in list(self._active.values()) + self._pending:
            lease.out.put(None)
        self._active.clear()
        self._pending.clear()

    def _run(self):
        # inference mode is thread-local: enter it on the engine thread
        try:
            with torch.inference_mode():
                while self._step_once():
                    pass
        except BaseException:
            # a failed step (a kernel error, say) must not leave callers
            # blocked on streams nothing will ever feed
            with self._cond:
                self._stopping = True
                self._end_all_locked()
            raise

    def _step_once(self) -> bool:
        """One decode step over every active row; False once stopping."""
        with self._cond:
            self._admit_locked()
            while not self._active and not self._stopping:
                self._cond.wait(timeout=0.5)
                self._admit_locked()
            if self._stopping:
                self._end_all_locked()
                return False
            batch = dict(self._active)
        if self.metrics is not None:
            self.slots_used.set(float(len(batch)))
            self.occupancy.observe(float(len(batch)))
        # one forward per step over every active row, right-padded
        rows = {slot: lease.prompt[-self.cfg.max_seq:] for slot, lease in batch.items()}
        bucket = _seq_bucket(max([1] + [len(r) for r in rows.values()]), self.cfg.max_seq)
        arr = np.zeros((self.slots, bucket), np.int64)
        last = np.zeros((self.slots,), np.int64)
        for slot, toks in rows.items():
            arr[slot, :len(toks)] = toks
            last[slot] = len(toks) - 1
        logits = self._step(self.params, torch.from_numpy(arr).to(self.device))
        picks = torch.argmax(
            logits[torch.arange(self.slots, device=self.device),
                   torch.from_numpy(last).to(self.device)], dim=-1).tolist()
        now = time.monotonic()
        self.steps += 1
        done = []
        for slot, lease in batch.items():
            nxt = int(picks[slot])
            lease.prompt.append(nxt)
            lease.produced += 1
            self.tokens_out += 1
            if self.metrics is not None:
                self.token_latency.observe(now - lease.t_last)
                self.metrics.mark("ktpu_llama_tokens_per_s")
            lease.t_last = now
            lease.out.put(nxt)
            if lease.produced >= lease.max_new:
                lease.out.put(None)
                done.append(slot)
        if done:
            with self._cond:
                for slot in done:
                    self._active.pop(slot, None)
                self._cond.notify()
        return True


class DecodeServer:
    """The llama serving half: an HTTP decode endpoint plus the pod
    /metrics surface the kubelet's scrape agent lifts into
    PodCustomMetrics: QPS, in-flight requests, request-latency
    histograms and (with batching) the slot-pool saturation gauges.

        POST /generate  {"tokens": [...], "max_new": N} -> {"tokens": [...]}
                        {"stream": true} streams ndjson token lines
                        ({"token": t} per decode step) over chunked
                        transfer encoding instead
        GET  /metrics   prometheus text (appmetrics registry)
        GET  /healthz

    ``batching=True`` (default; env KTPU_LLAMA_BATCHING=0 disables)
    routes requests through the continuous-batching engine.
    ``batching=False`` keeps the sequential one-request-per-forward
    baseline.  ``device`` defaults to the card and raises when there is
    none; ``params`` (e.g. from ``params_from_jax``) replaces the random
    weights drawn from ``seed``.
    """

    def __init__(self, cfg: Optional[LlamaConfig] = None, port: int = 0,
                 seed: int = 0, batching: Optional[bool] = None,
                 slots: int = 8, device: Optional[torch.device | str] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.cfg = cfg or tiny()
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen)
        self.params = params
        self._step = partial(forward, self.cfg)
        self.metrics = AppMetrics()
        self.requests_total = self.metrics.counter(
            "ktpu_llama_requests_total", "decode requests served")
        self.errors_total = self.metrics.counter(
            "ktpu_llama_request_errors_total", "malformed decode requests")
        self.inflight = self.metrics.gauge(
            "ktpu_llama_inflight", "decode requests currently in flight")
        self.latency = self.metrics.histogram(
            "ktpu_llama_request_latency_seconds", "decode request latency")
        if batching is None:
            batching = os.environ.get("KTPU_LLAMA_BATCHING", "1") != "0"
        self.batching = batching
        self.engine: Optional[BatchEngine] = None
        if batching:
            self.engine = BatchEngine(self.cfg, self.params, self._step,
                                      slots=slots, metrics=self.metrics)
        self._port = port
        self._srv: Optional[ThreadingHTTPServer] = None

    def generate(self, tokens, max_new: int = 8) -> list:
        t0 = time.monotonic()
        self.inflight.inc()
        try:
            if self.engine is not None:
                return self.engine.submit(tokens, max_new).result()
            return greedy_decode(self.cfg, self.params, self._step,
                                 tokens, max_new=max_new)
        finally:
            self.inflight.inc(-1)
            self.requests_total.inc()
            self.metrics.mark("ktpu_llama_qps")
            self.latency.observe(time.monotonic() - t0)

    def generate_stream(self, tokens, max_new: int = 8) -> SlotLease:
        """Streaming entry: returns the lease whose .stream() yields
        tokens at step cadence (batching only — the sequential arm has
        no step boundary to stream at)."""
        if self.engine is None:
            raise RuntimeError("streaming requires batching=True")
        return self.engine.submit(tokens, max_new)

    def warmup(self, tokens=(1, 2, 3), max_new: int = 4):
        """Serve one request outside the SLI histograms, so first-use
        costs (kernel build and load, allocator growth) never sit in the
        cumulative latency histogram."""
        if self.engine is not None:
            self.engine.submit(list(tokens), max_new).result()
            return
        greedy_decode(self.cfg, self.params, self._step, list(tokens),
                      max_new=max_new)

    # ------------------------------------------------------------- server

    def start(self) -> "DecodeServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/metrics"):
                    self._send(200, server.metrics.render().encode(),
                               ctype="text/plain; version=0.0.4")
                elif self.path.startswith("/healthz"):
                    self._send(200, b'{"status":"ok"}')
                else:
                    self._send(404, b'{"error":"unknown path"}')

            def do_POST(self):
                if not self.path.startswith("/generate"):
                    self._send(404, b'{"error":"unknown path"}')
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise TypeError("body must be a JSON object")
                    toks = [int(x) for x in (req.get("tokens") or [])]
                    max_new = min(64, int(req.get("max_new") or 8))
                    stream = bool(req.get("stream"))
                except (ValueError, TypeError):
                    server.errors_total.inc()
                    self._send(400, b'{"error":"bad request"}')
                    return
                if stream and server.engine is not None:
                    self._stream(toks, max_new)
                    return
                out = server.generate(toks, max_new=max_new)
                self._send(200, json.dumps({"tokens": out}).encode())

            def _stream(self, toks, max_new: int):
                """Per-token streaming: one ndjson line per decode step
                over chunked transfer encoding."""
                t0 = time.monotonic()
                server.inflight.inc()
                try:
                    lease = server.generate_stream(toks, max_new=max_new)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(payload: bytes):
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))

                    for tok in lease.stream():
                        chunk(b'{"token":%d}\n' % tok)
                    chunk(b'{"done":true}\n')
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    server.inflight.inc(-1)
                    server.requests_total.inc()
                    server.metrics.mark("ktpu_llama_qps")
                    server.latency.observe(time.monotonic() - t0)

        self._srv = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True,
                         name="llama-decode").start()
        return self

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self):
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        if self.engine is not None:
            self.engine.stop()
        self.metrics.stop()


def _serve_main():
    srv = DecodeServer().start()
    print(f"decode server on {srv.url}", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    import sys

    if "--serve" not in sys.argv[1:]:
        sys.exit("usage: python -m kubernetes1_tpu_torch.workloads.llama --serve "
                 "(training comes with a later slice)")
    _serve_main()
