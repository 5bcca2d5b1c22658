"""Container runtime: the CRI seam (ref: pkg/kubelet/apis/cri/v1alpha1/
runtime/api.proto RuntimeService/ImageService, dockershim server,
pkg/kubelet/remote client).  The port's copy of the JAX package's
``kubelet/runtime.py``.

Two implementations, both behind the same interface the kubelet consumes:

- ProcessRuntime — containers are host subprocesses, each the leader of
  a process group of its own (no dockerd on the node): the "image" is
  advisory, the command runs directly with the device plugin's injected
  env (CUDA_VISIBLE_DEVICES etc.), logs go to a file a container.  A
  PyTorch process on the card runs this way, torchrun's workers
  included: stopping a container signals every process of it.
- FakeRuntime — the kubemark hollow runtime (ref: pkg/kubemark/
  hollow_kubelet.go + libdocker/fake_client.go): containers are in-memory
  records with scriptable exit behavior, for scale tests with no process.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

SANDBOX_READY = "SANDBOX_READY"
SANDBOX_NOTREADY = "SANDBOX_NOTREADY"

CONTAINER_CREATED = "CREATED"
CONTAINER_RUNNING = "RUNNING"
CONTAINER_EXITED = "EXITED"


@dataclass
class SandboxRecord:
    id: str
    pod_name: str
    pod_namespace: str
    pod_uid: str
    state: str = SANDBOX_READY
    created_at: float = field(default_factory=time.time)
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class ContainerConfig:
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: Dict[str, str] = field(default_factory=dict)
    working_dir: str = ""
    devices: List[dict] = field(default_factory=list)
    mounts: List[dict] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)
    # effective security context (ref pkg/securitycontext): the runtime
    # drops to this uid/gid before exec; None = run as the kubelet's user
    run_as_user: Optional[int] = None
    run_as_group: Optional[int] = None
    privileged: bool = False


@dataclass
class ContainerRecord:
    id: str
    sandbox_id: str
    name: str
    image: str
    state: str = CONTAINER_CREATED
    exit_code: Optional[int] = None
    started_at: float = 0.0
    finished_at: float = 0.0
    restart_count: int = 0
    log_path: str = ""


class RuntimeService:
    """The interface the kubelet drives (20-RPC RuntimeService condensed to
    the calls the sync loop actually needs)."""

    # identity a container with no runAsUser execs as; None = unknown
    # (the kubelet's runAsNonRoot verification fails closed on None)
    default_uid: "Optional[int]" = None

    def version(self) -> str:
        raise NotImplementedError

    def run_pod_sandbox(self, pod_name, pod_namespace, pod_uid, labels=None) -> str:
        raise NotImplementedError

    def stop_pod_sandbox(self, sandbox_id: str):
        raise NotImplementedError

    def remove_pod_sandbox(self, sandbox_id: str):
        raise NotImplementedError

    def list_pod_sandboxes(self) -> List[SandboxRecord]:
        raise NotImplementedError

    def create_container(self, sandbox_id: str, config: ContainerConfig) -> str:
        raise NotImplementedError

    def start_container(self, container_id: str):
        raise NotImplementedError

    def stop_container(self, container_id: str, timeout: float = 10.0):
        raise NotImplementedError

    def remove_container(self, container_id: str):
        raise NotImplementedError

    def list_containers(self) -> List[ContainerRecord]:
        raise NotImplementedError

    def container_status(self, container_id: str) -> Optional[ContainerRecord]:
        raise NotImplementedError

    def read_log(self, container_id: str, tail: int = 0) -> str:
        return ""

    def container_stats(self, container_id: str) -> Dict[str, float]:
        """Point-in-time usage {"cpu": cores, "memory": bytes} for the stats
        pipeline (ref: cadvisor ContainerStats → kubelet Summary API)."""
        return {"cpu": 0.0, "memory": 0.0}

    def exec_in_container(self, container_id: str, command) -> int:
        """Run a command in the container's context; returns its exit code
        (exec probes ride this)."""
        return -1

    def exec_capture(self, container_id: str, command) -> tuple:
        """ExecSync analog: (exit code, combined output) — the kubelet
        server's ``POST /exec`` (ref: CRI api.proto ExecSync)."""
        return self.exec_in_container(container_id, command), ""

    def exec_stream(self, container_id: str, command, tty: bool = False,
                    stdin: bool = False):
        """Streaming Exec (ref: CRI api.proto Exec): start the command in
        the container's context and return (popen, pty_master_fd or None).
        The caller owns the pumping.  None when unsupported."""
        return None


class ImageService:
    """ref: api.proto ImageService (5 RPCs) — advisory here."""

    def __init__(self):
        self._images: set = set()

    def pull_image(self, image: str) -> str:
        self._images.add(image)
        return image

    def list_images(self) -> List[str]:
        return sorted(self._images)

    def image_present(self, image: str) -> bool:
        return image in self._images


# ------------------------------------------------------------ fake runtime


class FakeRuntime(RuntimeService):
    """Hollow runtime.  Containers run forever unless the config's command
    is ["sleep", "N"]-shaped or env KTPU_FAKE_EXIT_AFTER/_CODE is set, in
    which case they exit after N seconds with the given code."""

    def __init__(self):
        self._lock = threading.RLock()
        self._sandboxes: Dict[str, SandboxRecord] = {}
        self._containers: Dict[str, ContainerRecord] = {}
        self._exit_plans: Dict[str, tuple] = {}  # cid -> (deadline, code)
        self.images = ImageService()
        # hollow containers "run" as nobody: non-root, so runAsNonRoot
        # pods with image-declared users are exercisable in e2e tests
        self.default_uid = 65534
        # synthetic usage of a running container, for the stats pipeline
        self.default_usage: Dict[str, float] = {"cpu": 0.001, "memory": 1 << 20}
        self.configs: Dict[str, ContainerConfig] = {}  # cid -> config, kept for assertions

    def container_stats(self, container_id: str) -> Dict[str, float]:
        with self._lock:
            c = self._containers.get(container_id)
        if c is None or c.state != CONTAINER_RUNNING:
            return {"cpu": 0.0, "memory": 0.0}
        return dict(self.default_usage)

    def exec_in_container(self, container_id: str, command) -> int:
        """An exec probe of a running hollow container succeeds."""
        with self._lock:
            c = self._containers.get(container_id)
        return 0 if c is not None and c.state == CONTAINER_RUNNING else -1

    def version(self) -> str:
        return "fake://0.1"

    def run_pod_sandbox(self, pod_name, pod_namespace, pod_uid, labels=None) -> str:
        sid = f"sbx-{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._sandboxes[sid] = SandboxRecord(
                id=sid, pod_name=pod_name, pod_namespace=pod_namespace,
                pod_uid=pod_uid, labels=labels or {},
            )
        return sid

    def stop_pod_sandbox(self, sandbox_id: str):
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb:
                sb.state = SANDBOX_NOTREADY
            for c in self._containers.values():
                if c.sandbox_id == sandbox_id and c.state == CONTAINER_RUNNING:
                    self._finish(c, 137)

    def remove_pod_sandbox(self, sandbox_id: str):
        with self._lock:
            self._sandboxes.pop(sandbox_id, None)
            for cid in [c.id for c in self._containers.values() if c.sandbox_id == sandbox_id]:
                self._containers.pop(cid, None)

    def list_pod_sandboxes(self) -> List[SandboxRecord]:
        with self._lock:
            return list(self._sandboxes.values())

    def create_container(self, sandbox_id: str, config: ContainerConfig) -> str:
        cid = f"ctr-{uuid.uuid4().hex[:12]}"
        with self._lock:
            if sandbox_id not in self._sandboxes:
                raise KeyError(f"sandbox {sandbox_id} not found")
            self._containers[cid] = ContainerRecord(
                id=cid, sandbox_id=sandbox_id, name=config.name, image=config.image
            )
            self.configs[cid] = config  # tests assert on env/mount injection
            plan = self._plan_exit(config)
            if plan:
                self._exit_plans[cid] = plan
        return cid

    @staticmethod
    def _plan_exit(config: ContainerConfig):
        if "KTPU_FAKE_EXIT_AFTER" in config.env:
            return (
                float(config.env["KTPU_FAKE_EXIT_AFTER"]),
                int(config.env.get("KTPU_FAKE_EXIT_CODE", "0")),
            )
        cmd = (config.command or []) + (config.args or [])
        if len(cmd) == 2 and cmd[0] == "sleep":
            try:
                return (float(cmd[1]), 0)
            except ValueError:
                return None
        return None

    def start_container(self, container_id: str):
        with self._lock:
            c = self._containers[container_id]
            c.state = CONTAINER_RUNNING
            c.started_at = time.time()
            plan = self._exit_plans.get(container_id)
        if plan:
            delay, code = plan
            timer = threading.Timer(delay, self._timed_exit, args=(container_id, code))
            timer.daemon = True
            timer.start()

    def _timed_exit(self, container_id: str, code: int):
        with self._lock:
            c = self._containers.get(container_id)
            if c and c.state == CONTAINER_RUNNING:
                self._finish(c, code)

    def _finish(self, c: ContainerRecord, code: int):
        c.state = CONTAINER_EXITED
        c.exit_code = code
        c.finished_at = time.time()

    def stop_container(self, container_id: str, timeout: float = 10.0):
        with self._lock:
            c = self._containers.get(container_id)
            if c and c.state == CONTAINER_RUNNING:
                self._finish(c, 137)

    def remove_container(self, container_id: str):
        with self._lock:
            self._containers.pop(container_id, None)
            self._exit_plans.pop(container_id, None)
            self.configs.pop(container_id, None)

    def list_containers(self) -> List[ContainerRecord]:
        with self._lock:
            return list(self._containers.values())

    def container_status(self, container_id: str) -> Optional[ContainerRecord]:
        with self._lock:
            return self._containers.get(container_id)


# --------------------------------------------------------- process runtime


# Every process of a container carries this in its environment (the
# container's id), inherited by whatever it forks: torchrun's workers start
# sessions of their own, and outlive their parent when it is SIGKILLed, so
# neither the process group nor the parent links find all of them.
CONTAINER_ENV = "KTPU_CONTAINER_ID"


def _container_pids(container_id: str) -> Set[int]:
    """The live processes whose environment names the container: its
    leader and whatever that forked.  No remembered pid is signalled: once
    reaped, the kernel may have handed it to a process of somebody else."""
    marker = f"{CONTAINER_ENV}={container_id}".encode()
    out: Set[int] = set()
    try:
        entries = os.listdir("/proc")
    except OSError:
        return out
    for name in entries:
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if marker in f.read().split(b"\0"):
                    out.add(int(name))
        except OSError:
            continue  # gone, or a zombie: its environment reads empty
    return out


def _signal(pids, sig) -> None:
    for pid in pids:
        try:
            os.kill(pid, sig)
        except (ProcessLookupError, PermissionError):
            pass


_SETPRIV = shutil.which("setpriv")


def _wrap_with_user(cmd: List[str], uid: Optional[int],
                    gid: Optional[int]) -> List[str]:
    """Prefix `cmd` with a setpriv exec dropping to uid/gid before the
    container command runs (ref: runc's process.user; pkg/securitycontext).
    Either may be None (gid defaults to uid; a gid-only request keeps the
    uid).  setpriv execs in place — same pid, privileges irrevocably
    dropped.  Raises when the host cannot honor the request: silently
    running a workload as the wrong identity is a security lie."""
    g = gid if gid is not None else uid
    need_uid = uid is not None and uid != os.geteuid()
    need_gid = g is not None and g != os.getegid()
    if not need_uid and not need_gid:
        return list(cmd)  # already the requested identity
    if os.geteuid() != 0:
        raise PermissionError(
            f"runAsUser/runAsGroup ({uid}/{g}) requires a root kubelet "
            f"(running as {os.geteuid()})")
    if not _SETPRIV:
        raise PermissionError("runAsUser/runAsGroup requested but setpriv "
                              "is not available on this host")
    args = [_SETPRIV]
    if uid is not None:
        args.append(f"--reuid={uid}")
    if g is not None:
        args += [f"--regid={g}", "--clear-groups"]
    return args + ["--"] + list(cmd)


class ProcessRuntime(RuntimeService):
    """Containers as host subprocesses (the node's local runtime).

    Sandbox = a log/working directory; container = a subprocess whose env is
    the merged pod env + device-plugin injection, the leader of a process
    group of its own.  Stop sends SIGTERM to every process of the container
    (``_container_pids``), then SIGKILL after the grace timeout.  The host's
    cgroups and mounts stay as they are: no pod cgroup, no private mount
    namespace (a volume reaches its process as KTPU_VOLUME_<NAME>).
    """

    real_pids = True  # containers are real processes: the node runs cluster DNS

    def __init__(self, root_dir: str = "/tmp/ktpu"):
        self.root = root_dir
        os.makedirs(os.path.join(self.root, "logs"), exist_ok=True)
        self._lock = threading.RLock()
        self._sandboxes: Dict[str, SandboxRecord] = {}
        self._containers: Dict[str, ContainerRecord] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._configs: Dict[str, ContainerConfig] = {}
        self._stat_samples: Dict[str, tuple] = {}  # cid -> (cpu_ticks, mono_ts)
        self.images = ImageService()
        # identity a container with no runAsUser execs as (children are
        # forks of this process) — the kubelet's runAsNonRoot check reads it
        self.default_uid = os.geteuid()

    def version(self) -> str:
        return "process://0.1"

    def run_pod_sandbox(self, pod_name, pod_namespace, pod_uid, labels=None) -> str:
        sid = f"sbx-{uuid.uuid4().hex[:12]}"
        os.makedirs(os.path.join(self.root, "logs", sid), exist_ok=True)
        with self._lock:
            self._sandboxes[sid] = SandboxRecord(
                id=sid, pod_name=pod_name, pod_namespace=pod_namespace,
                pod_uid=pod_uid, labels=labels or {},
            )
        return sid

    def stop_pod_sandbox(self, sandbox_id: str):
        with self._lock:
            sb = self._sandboxes.get(sandbox_id)
            if sb:
                sb.state = SANDBOX_NOTREADY
            cids = [c.id for c in self._containers.values() if c.sandbox_id == sandbox_id]
        for cid in cids:
            self.stop_container(cid, timeout=2.0)

    def remove_pod_sandbox(self, sandbox_id: str):
        self.stop_pod_sandbox(sandbox_id)
        with self._lock:
            self._sandboxes.pop(sandbox_id, None)
            for cid in [c.id for c in self._containers.values() if c.sandbox_id == sandbox_id]:
                self._containers.pop(cid, None)
                self._procs.pop(cid, None)
                self._configs.pop(cid, None)

    def list_pod_sandboxes(self) -> List[SandboxRecord]:
        with self._lock:
            return list(self._sandboxes.values())

    def create_container(self, sandbox_id: str, config: ContainerConfig) -> str:
        cid = f"ctr-{uuid.uuid4().hex[:12]}"
        log_path = os.path.join(self.root, "logs", sandbox_id, f"{config.name}-{cid}.log")
        with self._lock:
            if sandbox_id not in self._sandboxes:
                raise KeyError(f"sandbox {sandbox_id} not found")
            self._containers[cid] = ContainerRecord(
                id=cid, sandbox_id=sandbox_id, name=config.name,
                image=config.image, log_path=log_path,
            )
            self._configs[cid] = config
        return cid

    def start_container(self, container_id: str):
        with self._lock:
            c = self._containers[container_id]
            config = self._configs[container_id]
        cmd = list(config.command or [])
        if not cmd:
            raise ValueError(f"container {config.name}: command required for process runtime")
        cmd += list(config.args or [])
        env = dict(os.environ)
        env.update(config.env)
        env[CONTAINER_ENV] = container_id
        # Volume mounts: each is exported as KTPU_VOLUME_<NAME>, the host
        # path the process reads (path-agnostic consumption).
        for m in config.mounts:
            name = (m.get("name") or "").replace("-", "_").replace(".", "_").upper()
            if name:
                env[f"KTPU_VOLUME_{name}"] = m.get("host_path", "")
        if config.run_as_user is not None or config.run_as_group is not None:
            # setpriv drops to the container's uid/gid and execs the workload
            cmd = _wrap_with_user(cmd, config.run_as_user,
                                  config.run_as_group)
        logf = open(c.log_path, "ab")
        proc = subprocess.Popen(
            cmd,
            env=env,
            cwd=config.working_dir or None,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # isolate signals from the kubelet
        )
        with self._lock:
            self._procs[container_id] = proc
            c.state = CONTAINER_RUNNING
            c.started_at = time.time()

    def _reap(self, c: ContainerRecord):
        proc = self._procs.get(c.id)
        if proc is None:
            return
        code = proc.poll()
        if code is not None and c.state == CONTAINER_RUNNING:
            c.state = CONTAINER_EXITED
            c.exit_code = code
            c.finished_at = time.time()

    def stop_container(self, container_id: str, timeout: float = 10.0):
        """SIGTERM to every process of the container, SIGKILL to those
        still alive ``timeout`` seconds later, until none is left."""
        with self._lock:
            c = self._containers.get(container_id)
            proc = self._procs.get(container_id)
        if c is None or proc is None:
            return
        pids = self._live(container_id, proc)
        if pids:
            _signal(pids, signal.SIGTERM)
            deadline = time.monotonic() + timeout
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                pass
            # the rest (torchrun's workers in sessions of their own) have
            # what is left of the same grace
            while time.monotonic() < deadline and self._live(container_id, proc):
                time.sleep(0.1)
            self._kill(container_id, proc)
        proc.wait()
        with self._lock:
            self._reap(c)
            if c.state == CONTAINER_RUNNING:  # defensive
                c.state = CONTAINER_EXITED
                c.exit_code = proc.returncode
                c.finished_at = time.time()

    @staticmethod
    def _live(container_id: str, proc: subprocess.Popen) -> Set[int]:
        """The container's processes, and its leader while that is our
        unreaped child (no other process can hold its pid until we reap
        it), whose environment may be unreadable."""
        pids = _container_pids(container_id)
        if proc.poll() is None:
            pids.add(proc.pid)
        return pids

    @classmethod
    def _kill(cls, container_id: str, proc: subprocess.Popen, rounds: int = 5) -> Set[int]:
        """SIGKILL the container's processes until a pass finds none (a
        process may fork between one pass and the next); returns those
        still alive after the last pass."""
        for _ in range(rounds):
            left = cls._live(container_id, proc)
            if not left:
                break
            _signal(left, signal.SIGKILL)
            time.sleep(0.05)
        return cls._live(container_id, proc)

    def remove_container(self, container_id: str):
        self.stop_container(container_id, timeout=2.0)
        with self._lock:
            self._containers.pop(container_id, None)
            self._procs.pop(container_id, None)
            self._configs.pop(container_id, None)

    def kill_all(self) -> List[int]:
        """SIGKILL every process of every tracked container and collect
        the exits; returns the pids that SURVIVED (always [] in practice).
        A torn-down cluster must never leave a pod process running: a
        wedged payload would hold the node's card."""
        with self._lock:
            procs = list(self._procs.items())
        survivors: Set[int] = set()
        for cid, proc in procs:
            survivors |= self._kill(cid, proc)
        for _cid, proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                survivors.add(proc.pid)
        return sorted(survivors)

    def list_containers(self) -> List[ContainerRecord]:
        with self._lock:
            for c in self._containers.values():
                self._reap(c)
            return list(self._containers.values())

    def container_status(self, container_id: str) -> Optional[ContainerRecord]:
        with self._lock:
            c = self._containers.get(container_id)
            if c:
                self._reap(c)
            return c

    def read_log(self, container_id: str, tail: int = 0) -> str:
        with self._lock:
            c = self._containers.get(container_id)
        if c is None or not os.path.exists(c.log_path):
            return ""
        with open(c.log_path, "r", errors="replace") as f:
            lines = f.readlines()
        if tail:
            lines = lines[-tail:]
        return "".join(lines)

    def exec_in_container(self, container_id: str, command) -> int:
        """Exec probes for process containers: run the command with the
        container's env (process analog of CRI ExecSync); -1 when the
        container is not running or the command cannot run."""
        return self.exec_capture(container_id, command)[0]

    def _exec_context(self, container_id: str):
        """(env, cwd) an exec into a running container gets: the
        container's env, with its KTPU_CONTAINER_ID, so the container's
        stop stops the exec'd processes too; None when it is not running."""
        with self._lock:
            proc = self._procs.get(container_id)
            config = self._configs.get(container_id)
        if proc is None or proc.poll() is not None:
            return None
        env = dict(os.environ)
        env.update(config.env)
        env[CONTAINER_ENV] = container_id
        return env, config.working_dir or None

    def exec_capture(self, container_id: str, command) -> tuple:
        ctx = self._exec_context(container_id)
        if ctx is None:
            return -1, "container not running"
        env, cwd = ctx
        try:
            res = subprocess.run(list(command), env=env, capture_output=True, timeout=10,
                                 cwd=cwd)
        except (OSError, subprocess.TimeoutExpired, ValueError) as e:
            return -1, str(e)
        return res.returncode, (res.stdout.decode(errors="replace")
                                + res.stderr.decode(errors="replace"))

    def exec_stream(self, container_id: str, command, tty: bool = False,
                    stdin: bool = False):
        """Streaming exec with the container's env; tty=True allocates a
        pty, the exec'd process's controlling terminal, so interactive
        shells behave (line editing, SIGINT).  The caller owns the
        returned master fd."""
        ctx = self._exec_context(container_id)
        if ctx is None:
            return None
        env, cwd = ctx
        if tty:
            import fcntl
            import pty
            import termios

            master, slave = pty.openpty()

            def acquire_ctty():
                # the new session's controlling terminal, so ^C reaches its
                # foreground group (one ioctl: no allocation between fork and exec)
                fcntl.ioctl(0, termios.TIOCSCTTY, 0)

            try:
                p = subprocess.Popen(list(command), env=env, cwd=cwd, stdin=slave,
                                     stdout=slave, stderr=slave, start_new_session=True,
                                     close_fds=True, preexec_fn=acquire_ctty)
            except BaseException:
                os.close(master)
                raise
            finally:
                os.close(slave)
            return p, master
        p = subprocess.Popen(list(command), env=env, cwd=cwd,
                             stdin=subprocess.PIPE if stdin else subprocess.DEVNULL,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             start_new_session=True)
        return p, None

    def container_stats(self, container_id: str) -> Dict[str, float]:
        """CPU from /proc/<pid>/stat utime+stime deltas between calls, RSS
        from statm — per-process cadvisor-lite."""
        with self._lock:
            proc = self._procs.get(container_id)
        if proc is None or proc.poll() is not None:
            return {"cpu": 0.0, "memory": 0.0}
        try:
            with open(f"/proc/{proc.pid}/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            ticks = int(parts[11]) + int(parts[12])  # utime, stime after comm
            with open(f"/proc/{proc.pid}/statm") as f:
                rss_pages = int(f.read().split()[1])
        except (OSError, IndexError, ValueError):
            return {"cpu": 0.0, "memory": 0.0}
        now = time.monotonic()
        hz = os.sysconf("SC_CLK_TCK")
        mem = float(rss_pages * os.sysconf("SC_PAGE_SIZE"))
        with self._lock:
            last = self._stat_samples.get(container_id)
            self._stat_samples[container_id] = (ticks, now)
        if last is None or now <= last[1]:
            return {"cpu": 0.0, "memory": mem}
        cpu = (ticks - last[0]) / hz / (now - last[1])
        return {"cpu": max(0.0, cpu), "memory": mem}
