"""Process serving replicas and the supervisor that keeps them alive.

Port of ``spark_languagedetector_tpu.scale.replica``. A
:class:`ProcessReplica` is an OS process of its own: it loads its model from
a saved path (or its baked artifact), owns its card through
``CUDA_VISIBLE_DEVICES`` in its environment (an empty value for a CPU
replica, which can then never reach a card), runs a
:class:`~..serve.server.ServingServer` on its port, and reports readiness
over ``/healthz/ready``; to the router it is one more HTTP endpoint.

Wire protocol between coordinator and child:

  * The child prints exactly one ``READY {json}`` line on stdout once the
    server is bound and the model warm (keys ``name``, ``host``, ``port``,
    ``pid``, ``version``, ``platform`` (``"gpu"`` for a CUDA child),
    ``ts``, ``warmup_s``, ``prewarm_mode``); everything else on the merged
    stdout/stderr pipe is diagnostics, kept in a bounded tail for
    spawn-failure messages. A ``--device cuda`` child with no card raises
    before READY: it never serves on the CPU.
  * The child then blocks on stdin. EOF is the **pipe sentinel**: the
    coordinator closing stdin (graceful stop), or dying, even by SIGKILL,
    which closes the pipe's write end, makes the child drain its accepted
    work and exit. SIGTERM takes the same graceful path. Its last act is a
    ``telemetry.snapshot`` to its ``--metrics-jsonl`` capture, whose gauge
    ``langdetect_kernel_launches{kernel, stage}`` holds each kernel's
    launches as its wrapper counted them, ``prewarm`` (before READY) and
    ``serve``; a child killed by a signal writes none.

The :class:`ReplicaSupervisor` owns the other half: spawn with a readiness
timeout, death detection (``proc.poll()`` and the stdout-EOF sentinel),
bounded restart with backoff through :class:`~..resilience.policy.
RetryPolicy`, and **orphan reaping**: every spawn writes a pidfile, an
``atexit`` hook kills surviving children on coordinator exit, and a new
supervisor on the same pidfile directory reaps children a SIGKILLed
coordinator stranded, after checking ``/proc/<pid>/cmdline`` names this
module (a recycled pid is never signalled).

Chaos: the ``scale/spawn`` fault site fires inside each spawn attempt.

Several children may build the same kernel library at once in a shared
compile cache; ``ops._kernels.build_all`` writes ``*.tmp<pid>.so`` and
renames it into place, so none loads a half-written file. A coordinator
that can should build first (``build_all`` into the cache directory) and
spawn after.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque

from ..exec import config as exec_config
from ..resilience import faults
from ..resilience.policy import RetryPolicy
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("scale.replica")

READY_PREFIX = "READY "
_WORKER_MODULE = "spark_languagedetector_tpu_torch.scale.replica"
DEVICES = ("cuda", "cpu")


class SpawnError(RuntimeError):
    """A replica process failed to reach readiness (spawn timeout, early
    exit). RuntimeError-shaped, so the retry classifier treats it as
    transient: the supervisor's bounded backoff is the recovery."""


def _check_device(device: str) -> str:
    if device not in DEVICES:
        raise ValueError(f"unknown replica device {device!r}; expected one of {DEVICES}")
    return device


def pinnable_port(host: str) -> int:
    """A free TCP port below the kernel's ephemeral range, or 0 (the child
    binds an ephemeral one) where the range cannot be read.

    A replica's port is pinned for its restarts, and a pinned port inside
    the ephemeral range can be taken between a death and its restart by the
    local end of any outgoing connection (or its TIME_WAIT), of the router's
    probes and dispatches included: the restart then cannot bind it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range", encoding="ascii") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0
    rng = random.SystemRandom()
    for _ in range(64):
        port = rng.randrange(max(1024, low // 2), low)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as probe:
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                probe.bind((host, port))
            except OSError:
                continue
        return port
    return 0


class ProcessReplica:
    """One serving replica in its own OS process.

    ``device`` is ``"cuda"`` (the default: the coordinator's first visible
    card, unless ``env`` sets ``CUDA_VISIBLE_DEVICES``) or ``"cpu"``.
    ``port=0`` takes a free port below the ephemeral range
    (:func:`pinnable_port`), reported on the READY line and **pinned** from
    then on: a restart puts the replica back at the address the router
    knows, so the breaker's half-open probe re-admits it without a
    membership change.
    """

    def __init__(
        self,
        name: str,
        model_path: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        device: str = "cuda",
        env: dict | None = None,
        prewarm: bool = True,
        spawn_timeout_s: float | None = None,
        tail_lines: int = 40,
        metrics_jsonl: str | None = None,
        compile_cache_dir: str | None = None,
        artifact: str | None = None,
    ):
        self.name = name
        self.model_path = str(model_path)
        self._host = host
        self._port = int(port) or pinnable_port(host)
        self._device = _check_device(device)
        self._env = dict(env or {})
        self._prewarm = prewarm
        self._metrics_jsonl = metrics_jsonl
        # The cold-start handshake: the compile-cache dir and the baked
        # artifact ride the child's argv, so it reaches READY with its
        # tables mapped and its kernels loaded from the shared cache.
        self._compile_cache_dir = compile_cache_dir
        self._artifact = artifact
        # Coordinator wall time of the last spawn (Popen to READY) and the
        # child's own warmup span (model load + lattice prewarm).
        self.last_spawn_ready_s: float | None = None
        self.last_warmup_s: float | None = None
        # "full" | "sentinel" | None: how the child's lattice prewarm ran.
        self.last_prewarm_mode: str | None = None
        # The last READY line's JSON object.
        self.last_ready: dict | None = None
        # Coordinator clock minus child clock at the READY handshake.
        self.clock_offset_s: float | None = None
        self.spawn_timeout_s = float(exec_config.resolve(
            "scale_spawn_timeout_s", spawn_timeout_s
        ))
        self.proc: subprocess.Popen | None = None
        self._eof = threading.Event()
        self._ready_line: list[str] = []
        self._ready_evt = threading.Event()
        self._tail: deque[str] = deque(maxlen=tail_lines)
        self._reader: threading.Thread | None = None

    # ---------------------------------------------------------- properties --
    @property
    def address(self) -> tuple[str, int]:
        return (self._host, self._port)

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    @property
    def alive(self) -> bool:
        """The process exists and has not exited (the supervisor also
        watches the stdout-EOF sentinel, so a death between polls is seen
        the moment the pipe closes)."""
        return self.proc is not None and self.proc.poll() is None

    def output_tail(self) -> list[str]:
        """Last diagnostics lines from the child (spawn-failure detail)."""
        return list(self._tail)

    # ----------------------------------------------------------- lifecycle --
    def _child_env(self) -> dict:
        env = dict(os.environ)
        # Per-process device ownership: a CUDA child sees its one card, a
        # CPU child sees none.
        if self._device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        else:
            env["CUDA_VISIBLE_DEVICES"] = ""
        env.update(self._env)
        return env

    def spawn(self) -> "ProcessReplica":
        """Start the child and block until its READY line (bounded).

        Raises :class:`SpawnError` on timeout or early exit, and the
        injected fault of a ``scale/spawn`` plan; the supervisor wraps this
        in the bounded backoff."""
        if self.alive:
            if not self._eof.is_set():
                return self
            # Alive but its pipe is gone: no longer supervisable, and a
            # respawn over it would fight it for the pinned port.
            self.kill()
        faults.inject("scale/spawn")
        t0 = time.monotonic()
        argv = [
            sys.executable, "-m", _WORKER_MODULE, self.model_path,
            "--name", self.name,
            "--host", self._host,
            "--port", str(self._port),
            "--device", self._device,
        ]
        if not self._prewarm:
            argv.append("--no-prewarm")
        if self._metrics_jsonl:
            argv += ["--metrics-jsonl", self._metrics_jsonl]
        if self._compile_cache_dir:
            argv += ["--compile-cache-dir", self._compile_cache_dir]
        # Resolved per attempt: an artifact baked between two spawns of one
        # member is picked up by the next restart.
        artifact = self._artifact
        if artifact is None:
            from ..artifacts.bake import artifact_path_for

            candidate = artifact_path_for(self.model_path)
            if candidate.exists():
                artifact = str(candidate)
        if artifact:
            argv += ["--artifact", str(artifact)]
        # Fresh per-spawn state, captured by this spawn's reader thread: a
        # stale reader of the previous incarnation holds the old events and
        # can neither flag the new one dead nor hand it a dead READY line.
        self._eof = eof = threading.Event()
        self._ready_evt = ready_evt = threading.Event()
        self._ready_line = ready_line = []
        self.proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=self._child_env(),
        )
        self._reader = threading.Thread(
            target=self._drain_stdout,
            args=(self.proc, eof, ready_evt, ready_line),
            name=f"scale-{self.name}-out", daemon=True,
        )
        self._reader.start()
        deadline = time.monotonic() + self.spawn_timeout_s
        while not ready_evt.wait(timeout=0.02):
            if self.proc.poll() is not None:
                eof.wait(timeout=5.0)  # the last lines of a dead child
                raise SpawnError(
                    f"replica {self.name!r} exited rc={self.proc.returncode} "
                    f"before READY; tail={self.output_tail()[-3:]}"
                )
            if time.monotonic() >= deadline:
                self.kill()
                raise SpawnError(
                    f"replica {self.name!r} spawn timed out after "
                    f"{self.spawn_timeout_s}s; tail={self.output_tail()[-3:]}"
                )
        info = json.loads(ready_line[0][len(READY_PREFIX):])
        self.last_ready = info
        self._port = int(info["port"])
        self.last_spawn_ready_s = time.monotonic() - t0
        REGISTRY.observe("scale/spawn_ready_s", self.last_spawn_ready_s)
        warmup = info.get("warmup_s")
        self.last_warmup_s = (
            float(warmup) if isinstance(warmup, (int, float)) else None
        )
        self.last_prewarm_mode = info.get("prewarm_mode")
        # Clock sync at the handshake: the child stamped its wall clock on
        # the READY line just before it was read; the stitch CLI aligns the
        # per-process captures with this event.
        child_ts = info.get("ts")
        if isinstance(child_ts, (int, float)):
            self.clock_offset_s = time.time() - float(child_ts)
            REGISTRY.emit({
                "event": "telemetry.clock_sync", "ts": time.time(),
                "replica": self.name, "pid": info.get("pid"),
                "platform": info.get("platform"),
                "offset_s": self.clock_offset_s,
            })
        log_event(
            _log, "scale.replica.ready", replica=self.name, pid=self.pid,
            port=self._port, version=info.get("version"),
            spawn_ready_s=round(self.last_spawn_ready_s, 4),
            warmup_s=info.get("warmup_s"),
        )
        return self

    def _drain_stdout(self, proc, eof, ready_evt, ready_line) -> None:
        # Keeps the pipe from filling (a blocked child is a fake hang) and
        # is the death sentinel: EOF sets the event before any poll().
        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                if line.startswith(READY_PREFIX) and not ready_line:
                    ready_line.append(line)
                    ready_evt.set()
                else:
                    self._tail.append(line)
        finally:
            eof.set()

    def kill(self) -> None:
        """Abrupt death (the chaos drill, a spawn timeout)."""
        if self.proc is None:
            return
        try:
            self.proc.kill()
        except OSError:
            pass
        self.proc.wait(timeout=10.0)
        self._close_pipes()
        log_event(_log, "scale.replica.killed", replica=self.name, pid=self.proc.pid)

    def stop(self, *, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Graceful stop: close stdin (the pipe sentinel) so the child
        drains its accepted work and exits; SIGTERM, then SIGKILL, if it
        overruns. ``drain=False`` goes straight to :meth:`kill`."""
        if self.proc is None:
            return
        if not drain:
            self.kill()
            return
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10.0)
        self._close_pipes()
        log_event(_log, "scale.replica.stop", replica=self.name, rc=self.proc.returncode)

    def _close_pipes(self) -> None:
        for pipe in (self.proc.stdin, self.proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except OSError:
                pass


# --------------------------------------------------------------- pidfiles ---
def _pidfile(dirpath: str, name: str) -> str:
    return os.path.join(dirpath, f"{name}.pid")


def _pid_is_replica_worker(pid: int) -> bool:
    """Is ``pid`` alive and a replica worker of this package? Without a
    readable ``/proc/<pid>/cmdline`` the answer is no: an orphan left for a
    human beats a signal to an innocent process that inherited the pid."""
    try:
        os.kill(pid, 0)
    except (OSError, ProcessLookupError):
        return False
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmdline = f.read().decode("utf-8", "replace")
    except OSError:
        return False
    return _WORKER_MODULE in cmdline.split("\0")


class ReplicaSupervisor:
    """Spawns, watches, restarts and reaps :class:`ProcessReplica`\\ s.

    One supervisor per coordinator process. Construction reaps orphans
    first: a pidfile in ``pidfile_dir`` whose pid is still a live replica
    worker belongs to a coordinator that died without cleanup, so it is
    terminated and counted (``scale/orphans_reaped``) before this fleet
    binds ports. Two concurrent coordinators therefore use distinct pidfile
    directories (the default is keyed by fleet name under the tempdir).
    ``device`` is every member's (``"cuda"`` unless the caller asks for
    ``"cpu"``).
    """

    def __init__(
        self,
        model_path: str,
        *,
        host: str = "127.0.0.1",
        device: str = "cuda",
        fleet_name: str = "fleet",
        pidfile_dir: str | None = None,
        spawn_timeout_s: float | None = None,
        max_restarts: int | None = None,
        prewarm: bool = True,
        retry_policy: RetryPolicy | None = None,
        child_env: dict | None = None,
        metrics_dir: str | None = None,
        compile_cache_dir: str | None = None,
        artifact: str | None = None,
        tuning_profile: str | None = None,
    ):
        self.model_path = str(model_path)
        self._host = host
        self.device = _check_device(device)
        self._child_env = dict(child_env or {})
        # Every member boots against the shared compile cache and the baked
        # artifact; the tuning profile rides its environment.
        self._compile_cache_dir = exec_config.resolve(
            "compile_cache_dir", compile_cache_dir
        )
        self._artifact = artifact
        profile_path = exec_config.resolve("tuning_profile", tuning_profile)
        if profile_path:
            self._child_env.setdefault(exec_config.PROFILE_ENV, str(profile_path))
        self.fleet_name = fleet_name
        # Each member appends its telemetry JSONL to
        # metrics_dir/replica-<name>.jsonl (restart generations share the
        # file, told apart by pid).
        self.metrics_dir = None if metrics_dir is None else str(metrics_dir)
        if self.metrics_dir:
            os.makedirs(self.metrics_dir, exist_ok=True)
        dirpath = exec_config.resolve("scale_pidfile_dir", pidfile_dir)
        if dirpath is None:
            import tempfile

            dirpath = os.path.join(tempfile.gettempdir(), "langdetect_scale", fleet_name)
        self.pidfile_dir = str(dirpath)
        os.makedirs(self.pidfile_dir, exist_ok=True)
        self._spawn_timeout_s = spawn_timeout_s
        self.max_restarts = int(exec_config.resolve("scale_max_restarts", max_restarts))
        self._prewarm = prewarm
        # The spawn backoff starts at 250 ms: a respawn on the pinned port
        # races the kernel reclaiming the dead child's socket.
        self.retry_policy = retry_policy or RetryPolicy.from_env(
            max_attempts=max(1, self.max_restarts),
            base_delay_s=0.25, max_delay_s=5.0,
        )
        self._lock = threading.Lock()
        self.members: dict[str, ProcessReplica] = {}
        # Members stopped on purpose (scale-down): their absence is no
        # incident. Members past their restart budget.
        self._retired: set[str] = set()
        self._failed: set[str] = set()
        # Crash-loop guard: consecutive death -> restart cycles per member
        # (reset when a later poll sees it alive).
        self._restart_streak: dict[str, int] = {}
        self.reap_orphans()
        atexit.register(self._atexit_kill)

    # ------------------------------------------------------------- orphans --
    def reap_orphans(self) -> int:
        """Kill replica workers a dead coordinator stranded; returns the
        count. SIGTERM first (the worker's graceful drain), SIGKILL on
        overrun."""
        reaped = 0
        try:
            entries = sorted(os.listdir(self.pidfile_dir))
        except OSError:
            return 0
        for fname in entries:
            if not fname.endswith(".pid"):
                continue
            path = os.path.join(self.pidfile_dir, fname)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    info = json.load(f)
                pid = int(info["pid"])
            except (OSError, ValueError, KeyError, TypeError):
                self._unlink(path)
                continue
            if _pid_is_replica_worker(pid):
                try:
                    os.kill(pid, signal.SIGTERM)
                    for _ in range(100):
                        if not _pid_is_replica_worker(pid):
                            break
                        time.sleep(0.05)
                    else:
                        os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
                reaped += 1
                REGISTRY.incr("scale/orphans_reaped")
                log_event(
                    _log, "scale.orphan_reaped", pid=pid,
                    replica=info.get("name"), port=info.get("port"),
                )
            self._unlink(path)
        return reaped

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _write_pidfile(self, rep: ProcessReplica) -> None:
        path = _pidfile(self.pidfile_dir, rep.name)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({
                "pid": rep.pid, "name": rep.name,
                "host": rep.address[0], "port": rep.address[1],
                "coordinator": os.getpid(),
            }, f)
        os.replace(tmp, path)

    # ------------------------------------------------------------ lifecycle --
    def spawn(
        self, name: str, *, port: int = 0, prewarm: bool | None = None
    ) -> ProcessReplica:
        """Spawn one replica to readiness under the bounded backoff. Every
        failed attempt counts ``scale/spawn_failures``; exhaustion raises
        the last error. ``prewarm`` overrides the supervisor default for
        this member, across its restarts."""
        with self._lock:
            existing = self.members.get(name)
        if existing is not None and existing.alive:
            raise ValueError(
                f"replica {name!r} is already a live member; stop it "
                "first or pick a fresh name"
            )
        rep = ProcessReplica(
            name, self.model_path, host=self._host, port=port,
            device=self.device,
            prewarm=self._prewarm if prewarm is None else prewarm,
            spawn_timeout_s=self._spawn_timeout_s, env=self._child_env,
            metrics_jsonl=(
                os.path.join(self.metrics_dir, f"replica-{name}.jsonl")
                if self.metrics_dir else None
            ),
            compile_cache_dir=self._compile_cache_dir,
            artifact=self._artifact,
        )
        self._spawn_with_backoff(rep)
        with self._lock:
            self.members[name] = rep
            self._retired.discard(name)
            self._failed.discard(name)
        return rep

    def _spawn_with_backoff(self, rep: ProcessReplica) -> None:
        def attempt():
            try:
                return rep.spawn()
            except Exception:
                REGISTRY.incr("scale/spawn_failures")
                raise

        self.retry_policy.run(attempt, site="scale/spawn")
        self._write_pidfile(rep)

    def stop(self, name: str, *, drain: bool = True) -> None:
        """Planned stop (scale-down): no restart follows."""
        with self._lock:
            rep = self.members.get(name)
            self._retired.add(name)
        if rep is not None:
            rep.stop(drain=drain)
            self._unlink(_pidfile(self.pidfile_dir, name))
        with self._lock:
            self.members.pop(name, None)

    def poll_once(self) -> list[str]:
        """One supervision round: detect deaths (poll and pipe sentinel),
        restart each within its backoff budget, give up loudly past it.
        Returns events such as ``"r1:restarted"`` and ``"r1:gave_up"``."""
        events: list[str] = []
        with self._lock:
            snapshot = [
                (name, rep) for name, rep in self.members.items()
                if name not in self._retired and name not in self._failed
            ]
        for name, rep in snapshot:
            if rep.alive and not rep._eof.is_set():
                self._restart_streak[name] = 0
                continue
            streak = self._restart_streak.get(name, 0) + 1
            self._restart_streak[name] = streak
            log_event(
                _log, "scale.replica.death_detected", replica=name,
                rc=rep.proc.returncode if rep.proc else None, streak=streak,
            )
            if streak > self.max_restarts:
                with self._lock:
                    self._failed.add(name)
                log_event(
                    _log, "scale.replica.gave_up", replica=name,
                    reason="crash_loop", budget=self.max_restarts,
                )
                events.append(f"{name}:gave_up")
                continue
            try:
                self._spawn_with_backoff(rep)
            except Exception as e:
                with self._lock:
                    self._failed.add(name)
                log_event(
                    _log, "scale.replica.gave_up", replica=name,
                    error=repr(e), budget=self.max_restarts,
                )
                events.append(f"{name}:gave_up")
                continue
            # Counted when the restart happened: a respawn that gave up
            # shows as scale/spawn_failures and the gave_up event.
            REGISTRY.incr("scale/restarts")
            events.append(f"{name}:restarted")
        return events

    def forget(self, name: str) -> None:
        """Drop a member entirely (after its router handle was detached):
        no restart, no pidfile, never a scale-down victim; a process still
        running is killed."""
        with self._lock:
            rep = self.members.pop(name, None)
            self._retired.discard(name)
            self._failed.discard(name)
            self._restart_streak.pop(name, None)
        if rep is not None and rep.alive:
            try:
                rep.kill()
            except Exception:
                pass
        self._unlink(_pidfile(self.pidfile_dir, name))

    def live_count(self) -> int:
        with self._lock:
            return sum(
                1 for name, rep in self.members.items()
                if rep.alive and name not in self._retired
            )

    def close(self, *, drain: bool = True) -> None:
        with self._lock:
            names = list(self.members)
        for name in names:
            self.stop(name, drain=drain)
        atexit.unregister(self._atexit_kill)

    def abandon(self) -> None:
        """Forget every child without killing it: the in-process stand-in
        for a SIGKILLed coordinator (tests). Pidfiles stay, atexit disarms;
        the next supervisor on this pidfile directory must reap."""
        with self._lock:
            self.members.clear()
            self._retired.clear()
            self._failed.clear()
        atexit.unregister(self._atexit_kill)

    def _atexit_kill(self) -> None:
        # Last resort for a coordinator exiting without close(): kill, not
        # drain (daemon threads may be gone this late).
        with self._lock:
            reps = list(self.members.values())
            self.members.clear()
        for rep in reps:
            try:
                rep.kill()
            except Exception:
                pass
            self._unlink(_pidfile(self.pidfile_dir, rep.name))

    def __enter__(self) -> "ReplicaSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------ worker main ---
def main(argv: list[str] | None = None) -> int:
    """``python -m spark_languagedetector_tpu_torch.scale.replica <model_dir>
    --name r0 --host H --port P --device {cuda,cpu} [--no-prewarm]
    [--metrics-jsonl F] [--compile-cache-dir D] [--artifact A]``: the child
    half of :class:`ProcessReplica`, speaking the module docstring's
    READY-line and stdin-EOF protocol."""
    import argparse

    parser = argparse.ArgumentParser(prog=_WORKER_MODULE)
    parser.add_argument("model_dir")
    parser.add_argument("--name", default="replica")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--device", choices=DEVICES, default="cuda")
    parser.add_argument("--no-prewarm", action="store_true")
    parser.add_argument("--metrics-jsonl", default=None)
    parser.add_argument("--compile-cache-dir", default=None)
    parser.add_argument("--artifact", default=None)
    args = parser.parse_args(argv)

    from ..artifacts.compile_cache import enable_compile_cache, prewarm_lattice
    from ..ops import _kernels
    from ..serve.registry import ModelRegistry
    from ..serve.server import ServingServer
    from ..telemetry.aggregate import install_process_identity
    from ..utils.device import resolve_device

    # The device first: a CUDA replica without a card raises here, before
    # anything could serve.
    device = str(resolve_device(args.device))
    # Identity before any span fires: every record this process exports
    # names its replica, pid and platform.
    identity = install_process_identity(replica=args.name, device=device)
    if args.metrics_jsonl:
        from ..telemetry.export import JsonlSink

        REGISTRY.add_sink(JsonlSink(args.metrics_jsonl))

    # The cold start: the build cache first, then the model (mapped from
    # the baked artifact when one was handed over), then the lattice. The
    # warmup span (load + prewarm, imports excluded) rides the READY line,
    # measured alike for cold and warm spawns.
    cache_dir = enable_compile_cache(args.compile_cache_dir)
    t_warm = time.perf_counter()
    registry = ModelRegistry(device=device)
    # The lattice prewarm covers every geometry the registry's own prewarm
    # would run, so that one is skipped.
    registry.load(args.model_dir, artifact=args.artifact, prewarm=False)
    runner = registry.peek().runner
    prewarm_mode = None
    if not args.no_prewarm:
        # The cost gauges are deferred until after READY (below).
        runner._cost_recorded = True
        prewarm_mode = prewarm_lattice(runner, cache_dir=cache_dir)["mode"]
    warmup_s = time.perf_counter() - t_warm
    prewarm_launches = {k.name: k.launches for k in _kernels.KERNELS}
    server = ServingServer(registry, host=args.host, port=args.port).start()
    ready = {
        "name": args.name,
        "host": server.address[0],
        "port": server.address[1],
        "pid": os.getpid(),
        "version": registry.current_version(),
        "platform": identity.get("platform"),
        "ts": time.time(),
        "warmup_s": warmup_s,
        "prewarm_mode": prewarm_mode,
    }
    print(READY_PREFIX + json.dumps(ready), flush=True)

    if not args.no_prewarm:
        def _deferred_cost():
            try:
                from ..telemetry import cost as cost_mod

                # Shielded: an env-armed chaos plan spends its call budget
                # on serving attempts, not on diagnostics.
                with faults.shield():
                    cost_mod.record_runner_cost(runner, 1, runner.length_buckets[0])
            except Exception:
                pass

        # Non-daemon: a worker told to stop right after READY joins this
        # (short) thread instead of tearing down under it.
        threading.Thread(
            target=_deferred_cost, name="replica-cost-gauges", daemon=False
        ).start()

    def _sigterm(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        # The pipe sentinel: block until the coordinator closes stdin, on
        # purpose or by dying. Either way: drain and leave.
        sys.stdin.buffer.read()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.stop(drain=True)
        # The terminal flush after the drain: the capture's last snapshot
        # counts every answered request, and each kernel's launches as its
        # wrapper counted them, before READY (the prewarm) and after.
        try:
            for k in _kernels.KERNELS:
                for stage, n in (("prewarm", prewarm_launches[k.name]),
                                 ("serve", k.launches - prewarm_launches[k.name])):
                    REGISTRY.set_gauge("langdetect_kernel_launches", n,
                                       kernel=k.name, stage=stage)
            REGISTRY.flush()
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
