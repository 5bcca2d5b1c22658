"""The port's exec/attach/logs/port-forward/cp path against the JAX one.

Two planes side by side, each an apiserver, a scheduler and one kubelet
with a ``ProcessRuntime`` in this process: ``jax`` is the JAX package's
(as ``tests/test_streaming.py`` builds it), ``torch`` the port's
(``apiserver.Master``, ``scheduler.Scheduler``, ``kubelet.Kubelet``,
``utils/streams``, driven by the port's ``cli.CLI``).  Every scenario of
``tests/test_streaming.py`` (exec's output and exit code, ``-i``, ``-t``
and the container's env, logs, attach, port-forward, cp, the kubelet's
token) runs on both, and the outputs and exit codes must be equal.  Two
cross cases show the frame protocol is shared: the JAX CLI against the
port's apiserver and kubelet, and the port's CLI against the JAX ones.
A frame case holds ``utils/streams`` to the JAX copy byte for byte.

The JAX copy's ``upgrade_request`` reads the 101 head 4 KiB at a time and
drops whatever frames came with it, so a command that ends at once can
lose its output or its status frame, and a stream then waits forever (a
deviation, its own case below).  The parity cases give the JAX module an
exact head read written here, one byte at a time and independent of the
port's (the refusal's body appended, which the JAX code splits off for
its message), so that race does not decide them.

The JAX suite's RBAC case (``test_rbac_denies_exec_without_subresource_grant``)
waits for the port's authorization (ROADMAP item 18): the port's
apiserver serves every request as the admin.
"""

import io
import json
import os
import random
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from urllib.parse import urlencode, urlparse

import pytest

from kubernetes1_tpu.apiserver import Master as JaxMaster
from kubernetes1_tpu.cli import CLI as JaxCLI
from kubernetes1_tpu.client import Clientset as JaxClientset
from kubernetes1_tpu.kubelet import Kubelet as JaxKubelet
from kubernetes1_tpu.kubelet import ProcessRuntime as JaxProcessRuntime
from kubernetes1_tpu.scheduler import Scheduler as JaxScheduler
from kubernetes1_tpu.utils import streams as jstreams
from kubernetes1_tpu_torch.apiserver import Master
from kubernetes1_tpu_torch.cli import CLI
from kubernetes1_tpu_torch.client.clientset import Clientset
from kubernetes1_tpu_torch.kubelet import Kubelet, ProcessRuntime
from kubernetes1_tpu_torch.scheduler import Scheduler
from kubernetes1_tpu_torch.utils import streams

JAX_READ_HTTP_HEAD = jstreams._read_http_head
PLANES = ("jax", "torch")
NODE = "stream-node"
TIMING = dict(heartbeat_interval=0.5, sync_interval=0.3, pleg_interval=0.3,
              eviction_signals_fn=lambda: {})
SLEEPER = "import time; time.sleep(120)"


class Plane:
    """One control plane with its CLI class and clientset."""

    def __init__(self, kind: str, root: str):
        self.kind = kind
        jax = kind == "jax"
        self.master = (JaxMaster() if jax else Master()).start()
        self.cs = (JaxClientset if jax else Clientset)(self.master.url)
        self._sched_cs = (JaxClientset if jax else Clientset)(self.master.url)
        self.scheduler = (JaxScheduler if jax else Scheduler)(self._sched_cs)
        self.scheduler.start()
        self.runtime = (JaxProcessRuntime if jax else ProcessRuntime)(
            root_dir=os.path.join(root, "run"))
        self._kubelet_cs = (JaxClientset if jax else Clientset)(self.master.url)
        self.kubelet = (JaxKubelet if jax else Kubelet)(
            self._kubelet_cs, node_name=NODE, runtime=self.runtime,
            plugin_dir=os.path.join(root, "plugins"), **TIMING)
        self.kubelet.start()
        self.cli_class = JaxCLI if jax else CLI

    @property
    def url(self) -> str:
        return self.master.url

    def create_pod(self, name: str, code: str, env=None, restart="Never", args=()):
        c = {"name": "main", "image": "python",
             "command": [sys.executable, "-u", "-c", code, *args]}
        if env:
            c["env"] = [{"name": k, "value": v} for k, v in env.items()]
        body = {"kind": "Pod", "apiVersion": "v1",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"restartPolicy": restart, "containers": [c]}}
        api = self.cs.api if self.kind == "jax" else self.cs.client
        api.request("POST", "/api/v1/namespaces/default/pods", body=body)

    def phase(self, name: str) -> str:
        return self.cs.pods.get(name, "default").status.phase

    def wait_phase(self, name: str, phase: str = "Running", timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.phase(name) == phase:
                return
            time.sleep(0.05)
        raise AssertionError(f"{self.kind}: pod {name} not {phase} in {timeout} s")

    def run_pod(self, name: str, code: str = SLEEPER, env=None):
        self.create_pod(name, code, env=env)
        self.wait_phase(name)

    def delete_pod(self, name: str):
        self.cs.pods.delete(name, "default", grace_seconds=0)

    def stop(self):
        self.kubelet.stop()
        self.runtime.kill_all()  # no container outlives the module
        self.scheduler.stop()
        for cs in (self.cs, self._sched_cs, self._kubelet_cs):
            cs.close()
        self.master.stop()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    made = {}
    try:
        for kind in PLANES:
            made[kind] = Plane(kind, str(tmp_path_factory.mktemp(f"streams-{kind}")))
        yield made
    finally:
        for p in made.values():
            p.stop()


def _exact_head(sock) -> str:
    """The HTTP head read one byte at a time up to its blank line, so no
    frame after a 101 is taken; after any other status its Content-Length
    body follows, as the JAX ``upgrade_request`` expects to find it."""
    data = b""
    while not data.endswith(b"\r\n\r\n") and len(data) <= 65536:
        byte = sock.recv(1)
        if not byte:
            break
        data += byte
    head = data.decode(errors="replace")
    if " 101 " not in head.split("\r\n", 1)[0] + " ":
        for line in head.split("\r\n")[1:]:
            key, _, value = line.partition(":")
            if key.strip().lower() == "content-length":
                want, body = int(value), b""
                while len(body) < want:
                    chunk = sock.recv(want - len(body))
                    if not chunk:
                        break
                    body += chunk
                head += body.decode(errors="replace")
    return head


@pytest.fixture(autouse=True)
def _jax_reads_the_head_exactly(monkeypatch):
    monkeypatch.setattr(jstreams, "_read_http_head", _exact_head)


def cli_call(plane_or_url, cli_class, verb: str, **fields):
    """Run one CLI verb on an in-process CLI object: (its output, its exit
    code), a SystemExit's code read as the process's would be."""
    out = io.StringIO()
    cli = cli_class(plane_or_url, "default", out=out)
    fn = {"exec": cli.exec_, "logs": cli.logs, "attach": cli.attach, "cp": cli.cp}[verb]
    fields.setdefault("container", "")
    try:
        fn(SimpleNamespace(**fields))
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        cli.cs.close()
    return out.getvalue(), code


def on_both(planes, fn):
    """fn(plane) on each plane: {kind: result}."""
    return {kind: fn(p) for kind, p in planes.items()}


def _pod_name(base: str) -> str:
    return f"{base}-{random.randrange(1 << 30):x}"


# --------------------------------------------------------------------- exec

EXEC_CASES = {
    "output": ([sys.executable, "-c", "print('from-exec')"], {}),
    "exit-code": ([sys.executable, "-c", "raise SystemExit(7)"], {}),
    "stderr": ([sys.executable, "-c", "import sys; sys.stderr.write('to-stderr\\n')"], {}),
    "stdin": ([sys.executable, "-c", "import sys; sys.stdout.write(sys.stdin.readline())"],
              {"stdin": True, "stdin_stream": b"hello-stdin\n"}),
    "tty": ([sys.executable, "-c", "import sys; print('tty?', sys.stdout.isatty())"],
            {"tty": True}),
    "no-command": ([sys.executable, "-c", "import os; os.execvp('no-such-binary-x', ['x'])"],
                   {}),
}


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_exec_output_and_exit_code_match(planes, case):
    command, extra = EXEC_CASES[case]
    name = _pod_name("exec")

    def run(p):
        p.run_pod(name)
        try:
            fields = dict(pod=name, command=command, stdin=False, tty=False)
            fields.update(extra)
            if "stdin_stream" in fields:
                fields["stdin_stream"] = io.BytesIO(fields["stdin_stream"])
            return cli_call(p.url, p.cli_class, "exec", **fields)
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"]
    want = {"output": ("from-exec\n", 0), "exit-code": ("", 7),
            "stderr": ("to-stderr\n", 0), "stdin": ("hello-stdin\n", 0),
            "tty": ("tty? True\r\n", 0)}.get(case)
    if want is not None:
        assert got["torch"] == want
    else:
        assert got["torch"][1] == 1 and "FileNotFoundError" in got["torch"][0]


def test_exec_sees_the_containers_env(planes):
    name = _pod_name("envpod")

    def run(p):
        p.run_pod(name, env={"MARKER": "xyz42"})
        try:
            return cli_call(p.url, p.cli_class, "exec", pod=name, command=[
                sys.executable, "-c", "import os; print(os.environ['MARKER'], os.getcwd())"])
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == (f"xyz42 {os.getcwd()}\n", 0)


def test_exec_into_a_pod_with_no_running_container_fails_the_verb(planes):
    """A stream the kubelet cannot open fails the verb: the kubelet answers
    400, the apiserver passes the refusal on, the CLI raises."""
    name = _pod_name("done")

    def run(p):
        p.create_pod(name, "pass")
        p.wait_phase(name, "Succeeded")
        try:
            with pytest.raises(ConnectionError) as e:
                cli_call(p.url, p.cli_class, "exec", pod=name, command=["true"])
            return e.value.status, "kubelet connection failed: upgrade refused: HTTP/1.1 400" \
                in str(e.value)
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == (400, True)


def test_exec_without_the_upgrade_header_runs_nothing(planes):
    """A plain POST (and GET) to ``pods/<n>/exec`` is refused with 400
    before the apiserver dials the kubelet, so the command never runs.
    The JAX apiserver dials first: its kubelet spawns the command, then
    the apiserver answers 400 (a deviation, both answers asserted)."""
    name = _pod_name("noupgrade")

    def run(p):
        p.run_pod(name)
        try:
            marker = os.path.join(p.runtime.root, f"{name}.ran")
            query = urlencode([("command", "touch"), ("command", marker)])
            codes = [_status_of(f"{p.url}/api/v1/namespaces/default/pods/{name}/exec?{query}",
                               method) for method in ("POST", "GET")]
            deadline = time.monotonic() + 3.0  # a spawned touch is done well within
            while not os.path.exists(marker) and time.monotonic() < deadline:
                time.sleep(0.05)
            ran = os.path.exists(marker)
            if ran:
                os.unlink(marker)
            return codes, ran
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == ([400, 400], False)
    assert got["jax"] == ([400, 400], True)


def test_exec_d_process_stops_with_its_container(planes):
    """The port's exec'd processes carry the container's KTPU_CONTAINER_ID,
    so deleting the pod stops one left behind; the JAX process runtime
    leaves it running (a deviation, both answers asserted)."""
    name = _pod_name("linger")

    def run(p):
        p.run_pod(name)
        out, code = cli_call(p.url, p.cli_class, "exec", pod=name, command=[
            "sh", "-c", "sleep 300 >/dev/null 2>&1 & echo $!"])
        pid = int(out.strip())
        p.delete_pod(name)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and _alive(pid):
            time.sleep(0.1)
        alive = _alive(pid)
        if alive:
            os.kill(pid, 9)
        return code, alive

    got = on_both(planes, run)
    assert got["torch"] == (0, False)
    assert got["jax"] == (0, True)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# ------------------------------------------------------------ logs, attach

def test_logs_through_the_apiserver_match(planes):
    name = _pod_name("logger")
    code = "print('log-line-1'); print('log-line-2'); import time; time.sleep(120)"

    def run(p):
        p.run_pod(name, code)
        try:
            deadline = time.monotonic() + 20
            while True:
                out = cli_call(p.url, p.cli_class, "logs", pod=name, tail=0)
                if "log-line-2" in out[0] or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            tail = cli_call(p.url, p.cli_class, "logs", pod=name, tail=1)
            return out, tail
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == (("log-line-1\nlog-line-2\n", 0),
                                          ("log-line-2\n", 0))


def test_attach_streams_until_the_container_exits_with_its_code(planes):
    """attach replays the log's tail, follows it, and ends with the exit
    code: the whole output and the code match."""
    name = _pod_name("chatty")
    code = ("import time, sys\nfor i in range(8):\n print('tick', i, flush=True)\n"
            " time.sleep(0.2)\nsys.exit(3)")

    def run(p):
        p.run_pod(name, code)
        try:
            return cli_call(p.url, p.cli_class, "attach", pod=name)
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == ("".join(f"tick {i}\n" for i in range(8)), 3)


def test_attach_frames_on_the_raw_stream(planes):
    """The raw subresource (no CLI): STDOUT frames carry the ticks."""
    name = _pod_name("rawattach")
    code = "import time\nfor i in range(100):\n print('tick', i, flush=True)\n time.sleep(0.2)"

    def run(p):
        p.run_pod(name, code)
        base = urlparse(p.url)
        mod = jstreams if p.kind == "jax" else streams
        sock = mod.upgrade_request(base.hostname, base.port,
                                   f"/api/v1/namespaces/default/pods/{name}/attach", {})
        got = b""
        try:
            while b"tick 1\n" not in got:
                frame = mod.read_frame(sock)
                if frame is None:
                    break
                if frame[0] == mod.STDOUT:
                    got += frame[1]
        finally:
            sock.close()
            p.delete_pod(name)
        return got.startswith(b"tick 0\n") and b"tick 1\n" in got

    assert on_both(planes, run) == {"jax": True, "torch": True}


# ------------------------------------------------------------- port-forward

POD_SERVER = ("import http.server, sys\n"
              "class H(http.server.BaseHTTPRequestHandler):\n"
              "    def log_message(self, *a):\n        pass\n"
              "    def do_GET(self):\n"
              "        body = ('pod says ' + self.path).encode()\n"
              "        self.send_response(200)\n"
              "        self.send_header('Content-Length', str(len(body)))\n"
              "        self.end_headers()\n"
              "        self.wfile.write(body)\n"
              "http.server.HTTPServer(('127.0.0.1', int(sys.argv[1])), H).serve_forever()\n")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, timeout: float = 20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
            return
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"nothing listens on {port}")


def _server_pod(p, name: str) -> int:
    """A pod serving POD_SERVER on a free port; the port."""
    port = _free_port()
    p.create_pod(name, POD_SERVER, args=[str(port)])
    p.wait_phase(name)
    _wait_listening(port)
    return port


def port_forward(url: str, cli_class, pod: str, remote: int, paths) -> list:
    """``port-forward 0:<remote>`` for len(paths) connections; each GET's
    (status, body) and the forward's first line."""
    out = io.StringIO()
    cli = cli_class(url, "default", out=out)
    th = threading.Thread(target=cli.port_forward, args=(SimpleNamespace(
        pod=pod, ports=f"0:{remote}", connections=len(paths)),), daemon=True)
    th.start()
    deadline = time.monotonic() + 10
    while not hasattr(cli, "_pf_listener") and time.monotonic() < deadline:
        time.sleep(0.02)
    port = cli._pf_listener.getsockname()[1]
    got = []
    try:
        for path in paths:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                got.append((r.status, r.read().decode()))
    finally:
        th.join(timeout=10)
        cli._pf_listener.close()
        cli.cs.close()
    first = out.getvalue().splitlines()[0]
    return got + [first.replace(str(port), "<local>")]


def test_port_forward_relays_tcp(planes):
    name = _pod_name("server")

    def run(p):
        remote = _server_pod(p, name)
        try:
            got = port_forward(p.url, p.cli_class, name, remote, ["/a", "/b/c"])
            return [x.replace(str(remote), "<remote>") if isinstance(x, str) else x for x in got]
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == [
        (200, "pod says /a"), (200, "pod says /b/c"),
        "Forwarding from 127.0.0.1:<local> -> <remote>"]


# --------------------------------------------------------------------- cp

def test_cp_both_directions(planes, tmp_path):
    """`ktpu cp` rides the exec stream: local -> pod through `cat > path`,
    pod -> local through `cat path`, binary-safe; seeded bytes."""
    payload = random.Random(23).randbytes(300_000) + bytes(range(256))
    src = tmp_path / "in.bin"
    src.write_bytes(payload)
    name = _pod_name("cp")

    def run(p):
        p.run_pod(name)
        try:
            remote = str(tmp_path / f"remote-{p.kind}.bin")
            up = cli_call(p.url, p.cli_class, "cp", src=str(src), dst=f"{name}:{remote}")
            back = tmp_path / f"back-{p.kind}.bin"
            down = cli_call(p.url, p.cli_class, "cp", src=f"{name}:{remote}", dst=str(back))
            return (up[0].replace(p.kind, "<plane>"), up[1],
                    down[0].replace(p.kind, "<plane>"), down[1], back.read_bytes() == payload)
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == got["torch"][3] == 0 and got["torch"][4]


def test_cp_of_a_missing_file_leaves_no_destination(planes, tmp_path):
    name = _pod_name("cpmiss")

    def run(p):
        p.run_pod(name)
        dst = tmp_path / f"never-{p.kind}.bin"
        try:
            out, code = cli_call(p.url, p.cli_class, "cp", src=f"{name}:/no/such/file",
                                 dst=str(dst))
            return code, "No such file" in out, dst.exists(), \
                os.path.exists(str(dst) + ".ktpu-cp-tmp")
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == (1, True, False, False)


# --------------------------------------------------------- the kubelet's door

def _status_of(url: str, method: str = "GET", headers=None, body=None) -> int:
    req = urllib.request.Request(url, method=method, headers=headers or {},
                                 data=None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        e.close()
        return e.code


def test_kubelet_endpoints_require_the_token(planes):
    """Direct kubelet access without the token is refused; healthz and
    metrics stay open.  The token lives in a kube-system Secret, not in
    the node's annotations."""
    def run(p):
        base = p.kubelet.server.url
        codes = [_status_of(base + path) for path in
                 ("/pods", "/stats/summary", "/containerLogs/default/x/y")]
        codes.append(_status_of(base + "/exec/default/x/y", "POST",
                                body={"command": ["true"]}))
        host, port = urlparse(base).hostname, urlparse(base).port
        mod = jstreams if p.kind == "jax" else streams
        for kind in ("exec/default/x/main?command=true", "attach/default/x/main",
                     "portForward/default/x?port=1"):
            try:
                mod.upgrade_request(host, port, f"/{kind}", {}).close()
                codes.append(101)
            except mod.UpgradeRefused as e:
                codes.append(e.status)
        codes += [_status_of(base + "/healthz"), _status_of(base + "/metrics")]
        node = p.cs.nodes.get(NODE, "")
        secret = p.cs.secrets.get(f"kubelet-token-{NODE}", "kube-system")
        return codes, "kubelet.ktpu.io/exec-token" in node.metadata.annotations, \
            secret.data["token"] == p.kubelet.server_token

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == ([401] * 7 + [200, 200], False, True)


def test_kubelet_execsync_with_the_token(planes):
    """``POST /exec`` (ExecSync, the probe seam): the output and the code."""
    name = _pod_name("execsync")

    def run(p):
        p.run_pod(name)
        try:
            pod = p.cs.pods.get(name, "default")
            req = urllib.request.Request(
                f"{p.kubelet.server.url}/exec/default/{name}/main", method="POST",
                headers={"Authorization": f"Bearer {p.kubelet.server_token}"},
                data=json.dumps({"command": ["sh", "-c", "echo hi; exit 4"]}).encode())
            with urllib.request.urlopen(req, timeout=15) as r:
                answer = json.loads(r.read())
            return answer, pod.spec.node_name
        finally:
            p.delete_pod(name)

    got = on_both(planes, run)
    assert got["torch"] == got["jax"] == ({"exitCode": 4, "output": "hi\n"}, NODE)


# ------------------------------------------------------------ cross planes

@pytest.mark.parametrize("cli_kind,plane_kind", [("jax", "torch"), ("torch", "jax")])
def test_one_packages_cli_drives_the_others_streams(planes, cli_kind, plane_kind):
    """The frame protocol is shared: exec (with stdin) and port-forward of
    one package's CLI through the other's apiserver and kubelet."""
    p = planes[plane_kind]
    cli_class = JaxCLI if cli_kind == "jax" else CLI
    name = _pod_name("cross")
    remote = _server_pod(p, name)
    try:
        out = cli_call(p.url, cli_class, "exec", pod=name, stdin=True, tty=False,
                       stdin_stream=io.BytesIO(b"over the wire\n"),
                       command=[sys.executable, "-c",
                                "import sys; print(sys.stdin.read().upper(), end='')"])
        code = cli_call(p.url, cli_class, "exec", pod=name, command=["sh", "-c", "exit 5"])
        fwd = port_forward(p.url, cli_class, name, remote, ["/cross"])
    finally:
        p.delete_pod(name)
    assert out == ("OVER THE WIRE\n", 0)
    assert code == ("", 5)
    assert fwd == [(200, "pod says /cross"), f"Forwarding from 127.0.0.1:<local> -> {remote}"]


# ------------------------------------------------------------------ frames

def _frames_bytes(mod, frames) -> bytes:
    a, b = socket.socketpair()
    got = bytearray()
    try:
        def drain():
            while True:
                chunk = b.recv(1 << 20)
                if not chunk:
                    return
                got.extend(chunk)

        th = threading.Thread(target=drain)
        th.start()
        for ch, payload in frames:
            if ch == "status":
                mod.send_status(a, *payload)
            else:
                mod.write_frame(a, ch, payload)
        a.shutdown(socket.SHUT_WR)
        th.join()
    finally:
        a.close()
        b.close()
    return bytes(got)


def _read_all(mod, data: bytes) -> list:
    a, b = socket.socketpair()
    out = []
    try:
        th = threading.Thread(target=lambda: (a.sendall(data), a.shutdown(socket.SHUT_WR)))
        th.start()
        while True:
            f = mod.read_frame(b)
            if f is None:
                break
            out.append(f)
        th.join()
    finally:
        a.close()
        b.close()
    return out


@pytest.mark.parametrize("seed", range(4))
def test_frames_are_byte_for_byte_the_jax_packages(seed):
    rng = random.Random(seed)
    frames = [(rng.choice((streams.STDIN, streams.STDOUT, streams.STDERR, streams.RESIZE)),
               rng.randbytes(rng.choice((0, 1, 17, 4096, 70_000)))) for _ in range(12)]
    frames += [(streams.STDIN, b""), (streams.STDOUT, rng.randbytes(streams.MAX_FRAME)),
               ("status", (rng.randrange(-1, 256), rng.choice(("", "boom", "é")))),
               ("status", (0,))]
    assert (streams.UPGRADE_PROTO, streams.MAX_FRAME, streams._HEADER.format) == \
        (jstreams.UPGRADE_PROTO, jstreams.MAX_FRAME, jstreams._HEADER.format)
    assert (streams.STDIN, streams.STDOUT, streams.STDERR, streams.ERROR, streams.RESIZE) == \
        (jstreams.STDIN, jstreams.STDOUT, jstreams.STDERR, jstreams.ERROR, jstreams.RESIZE)
    wire = _frames_bytes(streams, frames)
    assert wire == _frames_bytes(jstreams, frames)
    assert _read_all(streams, wire) == _read_all(jstreams, wire)
    # an oversize frame ends the stream in both, as a cut one does
    over = streams._HEADER.pack(streams.STDOUT, streams.MAX_FRAME + 1) + b"x" * 64
    cut = wire[:len(wire) - 3]
    for data in (over, cut):
        assert _read_all(streams, data) == _read_all(jstreams, data)
    assert _read_all(streams, over) == []


def test_frames_sent_with_the_101_stay_in_the_stream(monkeypatch):
    """Deviation: a server whose 101 head and first frame reach the client
    together (a command that ends at once).  The port's upgrade_request
    reads the head and no byte more, so the frame is read next; the JAX
    copy reads 4 KiB and drops what follows the head, and the stream then
    waits for a frame that was already sent."""
    monkeypatch.setattr(jstreams, "_read_http_head", JAX_READ_HTTP_HEAD)
    frame = streams._HEADER.pack(streams.ERROR, 15) + b'{"exitCode": 3}'
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(2)
    port = listener.getsockname()[1]
    held = []

    def serve():
        for _ in range(2):
            conn, _ = listener.accept()
            while b"\r\n\r\n" not in conn.recv(4096):
                pass
            conn.sendall(b"HTTP/1.1 101 Switching Protocols\r\nUpgrade: ktpu-stream\r\n"
                         b"Connection: Upgrade\r\n\r\n" + frame)
            held.append(conn)  # open, as a kubelet blocked on its reader left it

    th = threading.Thread(target=serve)
    th.start()
    got = {}
    try:
        for kind, mod in (("torch", streams), ("jax", jstreams)):
            sock = mod.upgrade_request("127.0.0.1", port, "/exec/x", {})
            sock.settimeout(1.0)
            try:
                got[kind] = mod.read_frame(sock)
            except socket.timeout:
                got[kind] = "waits"
            finally:
                sock.close()
    finally:
        th.join(timeout=10)
        for c in held:
            c.close()
        listener.close()
    assert got == {"torch": (streams.ERROR, b'{"exitCode": 3}'), "jax": "waits"}
