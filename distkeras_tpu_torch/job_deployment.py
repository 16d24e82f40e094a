"""Multi-process launching over ``torch.distributed``. Port of
``distkeras_tpu/job_deployment.py``.

- :func:`initialize_cluster` joins this process to the training cluster:
  ``torch.distributed.init_process_group`` over a TCP rendezvous at the
  coordinator's address, one rank a device. Rank r uses ``cuda:{local
  rank}`` with NCCL, or the CPU with gloo when the caller asks for it
  (``device="cpu"``). After it returns, a ``parallel.mesh.Mesh`` spans the
  world and ``MeshTrainer`` trains over it.
- :class:`Job` renders the per-host launch commands from a
  :class:`Punchcard` manifest, with the coordinator's environment
  (``DISTKERAS_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``, which
  :func:`cluster_args_from_env` reads back), and executes them through a
  runner: :class:`LocalRunner` (local subprocesses: how a gloo world of
  several ranks comes up on one machine) or :class:`SSHRunner` (one ssh
  client a host; injectable, its commands can be rendered without being
  run). With no runner the commands are only returned.
"""

from __future__ import annotations

import datetime
import json
import os
import shlex
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Sequence


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
    device: str = "cuda",
    timeout: float = 300.0,
) -> dict:
    """Join this process to the training cluster: ``coordinator_address``
    (``host:port`` of rank 0's rendezvous), ``num_processes`` ranks, this
    one ``process_id``; missing arguments come from the ``DISTKERAS_*``
    environment :class:`Job` sets. ``device="cuda"`` (the default) binds
    the rank to ``cuda:{local_device_ids[0]}`` (default: the process id
    modulo the visible cards) and joins over NCCL; ``device="cpu"`` joins
    over gloo. Returns a summary of the world."""
    import torch
    import torch.distributed as dist

    env = cluster_args_from_env()
    coordinator_address = coordinator_address or env.get(
        "coordinator_address")
    num_processes = int(num_processes if num_processes is not None
                        else env.get("num_processes", 1))
    process_id = int(process_id if process_id is not None
                     else env.get("process_id", 0))
    if coordinator_address is None:
        raise ValueError("initialize_cluster needs coordinator_address (or "
                         "DISTKERAS_COORDINATOR in the environment)")
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_cluster(device='cuda') found no "
                               "CUDA device; pass device='cpu' for gloo")
        local = (int(local_device_ids[0]) if local_device_ids
                 else process_id % torch.cuda.device_count())
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "global_devices": dist.get_world_size(),
        "local_devices": 1,
        "backend": dist.get_backend(),
        "device": str(dev),
    }


@dataclass
class Punchcard:
    """Job manifest: the script, its hosts, the coordinator port, extra
    environment and arguments."""

    script: str
    hosts: list[str] = field(default_factory=list)
    coordinator_port: int = 8476
    env: dict = field(default_factory=dict)
    args: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, path) -> "Punchcard":
        return cls(**json.loads(Path(path).read_text()))

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(self.__dict__, indent=2))


class Job:
    """Render/execute the per-host launch fan-out for a Punchcard.

    The runner is a callable ``(host, command) -> None``; with none the
    commands are only rendered.
    """

    def __init__(self, punchcard: Punchcard,
                 runner: Callable[[str, str], None] | None = None):
        self.punchcard = punchcard
        self.runner = runner
        self.commands: list[tuple[str, str]] = []

    def render_commands(self) -> list[tuple[str, str]]:
        pc = self.punchcard
        hosts = pc.hosts or ["localhost"]
        coordinator = f"{hosts[0]}:{pc.coordinator_port}"
        cmds = []
        for i, host in enumerate(hosts):
            env = {
                "DISTKERAS_COORDINATOR": coordinator,
                "DISTKERAS_NUM_PROCESSES": str(len(hosts)),
                "DISTKERAS_PROCESS_ID": str(i),
                **pc.env,
            }
            env_str = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())
            )
            argv = " ".join(shlex.quote(a) for a in [pc.script, *pc.args])
            cmds.append((host, f"{env_str} python {argv}"))
        return cmds

    def run(self) -> list[tuple[str, str]]:
        self.commands = self.render_commands()
        if self.runner is not None:
            # validate the whole host list BEFORE launching anything: a
            # rejection mid-launch would leak already-started cluster
            # processes blocking in initialize_cluster
            validate = getattr(self.runner, "validate", None)
            if validate is not None:
                for host, _ in self.commands:
                    validate(host)
            for host, cmd in self.commands:
                self.runner(host, cmd)
        return self.commands


class _SubprocessRunner:
    """Shared wait/poll/capture machinery for runners that launch real
    subprocesses (:class:`LocalRunner` locally, :class:`SSHRunner` through
    an ``ssh`` client process per host)."""

    def __init__(self):
        self.procs: list = []

    def _launch(self, argv_or_cmd, shell: bool) -> None:
        # temp files, not pipes: cluster processes block on each other at
        # collectives, so a sequential pipe drain could deadlock against a
        # full pipe buffer. New session so a timeout can kill the whole
        # process GROUP (the `sh -c` shell plus anything it spawned).
        out = tempfile.TemporaryFile(mode="w+")
        err = tempfile.TemporaryFile(mode="w+")
        p = subprocess.Popen(argv_or_cmd, shell=shell, stdout=out,
                             stderr=err, text=True, start_new_session=True)
        p._out_file, p._err_file = out, err
        self.procs.append(p)

    def poll(self) -> list[int | None]:
        """Non-blocking status of every launched process (None = running) —
        a Job's poll loop."""
        return [p.poll() for p in self.procs]

    def wait(self, timeout: float | None = None) -> list[int]:
        """Wait for every launched process (one overall deadline, not
        per-process); returns their return codes. On timeout every child is
        killed before TimeoutExpired propagates — a hung cluster must not
        leak processes holding the coordinator port."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            for p in self.procs:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            import signal

            for p in self.procs:
                if p.poll() is None:
                    try:  # whole group: the shell AND its descendants
                        os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        p.kill()
            for p in self.procs:
                p.wait()
            self._capture_outputs()
            raise
        self._capture_outputs()
        return [p.returncode for p in self.procs]

    def _capture_outputs(self) -> None:
        for p in self.procs:
            if hasattr(p, "captured_stdout"):
                continue
            for attr, f in (("captured_stdout", p._out_file),
                            ("captured_stderr", p._err_file)):
                f.seek(0)
                setattr(p, attr, f.read())
                f.close()


class LocalRunner(_SubprocessRunner):
    """Execute rendered commands as local subprocesses: every host of the
    Punchcard maps to one local process, which is how a world of several
    ranks (gloo on the CPU) comes up on one machine."""

    def validate(self, host: str) -> None:
        """Called by :meth:`Job.run` for every host before any launch."""
        if host not in ("localhost", "127.0.0.1"):
            raise ValueError(
                f"LocalRunner only launches on localhost, got {host!r}; "
                f"use an SSH runner for remote hosts"
            )

    def __call__(self, host: str, command: str) -> None:
        self.validate(host)
        self._launch(command, shell=True)


class SSHRunner(_SubprocessRunner):
    """Execute rendered commands on remote hosts over SSH: each host of the
    Punchcard gets one ``ssh host 'ENV=... python script.py ...'`` client
    process; ``wait``/``poll`` then track the remote jobs through their ssh
    exit codes, and each process's remote output lands in
    ``captured_stdout``/``stderr``.

    The ssh invocation is injectable for tests and for operators with a
    non-standard client: ``transport(argv) -> None`` receives the full
    argv list (default: launch it as a subprocess). ``BatchMode=yes``
    makes a missing key fail fast instead of prompting. The argv is
    rendered for the OpenSSH client; :meth:`ssh_argv` shows it without
    running anything.
    """

    def __init__(self, user: str | None = None, port: int = 22,
                 identity_file: str | None = None,
                 ssh_options: Sequence[str] = (),
                 connect_timeout: float = 10.0,
                 transport: Callable[[list[str]], None] | None = None):
        super().__init__()
        self.user = user
        self.port = int(port)
        self.identity_file = identity_file
        self.ssh_options = list(ssh_options)
        self.connect_timeout = float(connect_timeout)
        self._transport = transport
        self.launched: list[tuple[str, list[str]]] = []

    def validate(self, host: str) -> None:
        """Called by :meth:`Job.run` for every host before any launch."""
        if not host or host != host.strip() or " " in host:
            raise ValueError(f"invalid ssh host {host!r}")
        if host.startswith("-"):
            raise ValueError(
                f"ssh host {host!r} would be parsed as an option"
            )

    def ssh_argv(self, host: str, command: str) -> list[str]:
        """The exact client argv for one host (also what tests assert)."""
        argv = ["ssh", "-o", "BatchMode=yes",
                "-o", f"ConnectTimeout={int(self.connect_timeout)}"]
        if self.port != 22:
            argv += ["-p", str(self.port)]
        if self.identity_file:
            argv += ["-i", self.identity_file]
        argv += self.ssh_options
        target = f"{self.user}@{host}" if self.user else host
        # one argument: the remote shell re-parses it
        argv += [target, command]
        return argv

    def __call__(self, host: str, command: str) -> None:
        self.validate(host)
        argv = self.ssh_argv(host, command)
        self.launched.append((host, argv))
        if self._transport is not None:
            self._transport(argv)
        else:
            self._launch(argv, shell=False)


def cluster_args_from_env() -> dict:
    """Read the DISTKERAS_* coordinator env set by :class:`Job`."""
    out = {}
    if addr := os.environ.get("DISTKERAS_COORDINATOR"):
        out["coordinator_address"] = addr
    if n := os.environ.get("DISTKERAS_NUM_PROCESSES"):
        out["num_processes"] = int(n)
    if i := os.environ.get("DISTKERAS_PROCESS_ID"):
        out["process_id"] = int(i)
    return out
