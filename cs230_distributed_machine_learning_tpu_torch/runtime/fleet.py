"""Shard-fleet process launcher: N coordinator shards + M front ends.

Port of the JAX package's ``runtime/fleet.py``: every shard is a process
of the port's server (``runtime.server --shard-index k --num-shards N
--peers ...``) with its own interpreter and its own journal under
``<storage_root>/journal/shard-<k>``; the front ends are processes of
``runtime.frontend``. The shards run on the card unless ``device="cpu"``
(then every child also sees no card). ``restart_shard(k)`` relaunches a
killed shard on the same port and journal: the journal replay and
``resume_inflight`` finish the dead process's jobs.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..utils import http

_PKG = "cs230_distributed_machine_learning_tpu_torch"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class ShardFleet:
    def __init__(
        self,
        n_shards: int,
        *,
        storage_root: str,
        n_frontends: int = 1,
        local_executors: int = 1,
        journal: bool = True,
        env: Optional[Dict[str, str]] = None,
        log_dir: Optional[str] = None,
        host: str = "127.0.0.1",
        device: Optional[str] = None,
    ):
        from .sharding import MAX_SHARDS

        self.n_shards = int(n_shards)
        if not 1 <= self.n_shards <= MAX_SHARDS:
            raise ValueError(f"n_shards must be in [1, {MAX_SHARDS}] (id stamp grammar)")
        self.host = host
        self.local_executors = int(local_executors)
        self.journal = journal
        self.device = device
        self.storage_root = storage_root
        self.log_dir = log_dir or storage_root
        os.makedirs(self.log_dir, exist_ok=True)
        # the children import the package wherever the parent runs from
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self.env = {
            **os.environ,
            "TPUML_STORAGE__ROOT": storage_root,
            "PYTHONPATH": pkg_root + (os.pathsep + os.environ["PYTHONPATH"]
                                      if os.environ.get("PYTHONPATH") else ""),
            **({"CUDA_VISIBLE_DEVICES": ""} if device == "cpu" else {}),
            **(env or {}),
        }
        self.shard_ports = [free_port() for _ in range(self.n_shards)]
        self.frontend_ports = [free_port() for _ in range(int(n_frontends))]
        self.shard_procs: List[Optional[subprocess.Popen]] = [None] * self.n_shards
        self.frontend_procs: List[subprocess.Popen] = []

    @property
    def shard_urls(self) -> List[str]:
        return [f"http://{self.host}:{p}" for p in self.shard_ports]

    @property
    def frontend_urls(self) -> List[str]:
        return [f"http://{self.host}:{p}" for p in self.frontend_ports]

    def _log(self, name: str):
        return open(os.path.join(self.log_dir, f"{name}.log"), "ab")

    def start_shard(self, k: int) -> subprocess.Popen:
        cmd = [
            sys.executable, "-m", f"{_PKG}.runtime.server",
            "--host", self.host, "--port", str(self.shard_ports[k]),
            "--shard-index", str(k), "--num-shards", str(self.n_shards),
            "--local-executors", str(self.local_executors),
            # the ports are fixed in __init__ (stable across restart_shard);
            # rebalancing acts only with service.rebalance_enabled
            "--peers", ",".join(self.shard_urls),
        ]
        if self.device is not None:
            cmd += ["--device", self.device]
        if self.journal:
            cmd.append("--journal")
        proc = subprocess.Popen(cmd, env=self.env, stdout=self._log(f"shard-{k}"),
                                stderr=subprocess.STDOUT)
        self.shard_procs[k] = proc
        return proc

    def start(self, timeout_s: float = 300.0) -> "ShardFleet":
        for k in range(self.n_shards):
            self.start_shard(k)
        shard_list = ",".join(self.shard_urls)
        for i, port in enumerate(self.frontend_ports):
            self.frontend_procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{_PKG}.runtime.frontend", "--host", self.host,
                 "--port", str(port), "--shards", shard_list],
                env=self.env, stdout=self._log(f"frontend-{i}"), stderr=subprocess.STDOUT))
        try:
            self.wait_ready(timeout_s)
        except Exception:
            self.stop()
            raise
        return self

    def _wait_url(self, url: str, deadline: float) -> None:
        while True:
            try:
                if http.request("GET", f"{url}/readyz", timeout=2).status == 200:
                    return
            except http.TransportError:
                pass
            if time.time() > deadline:
                raise TimeoutError(f"fleet at {url} never became ready")
            dead = [p.args for p in self.shard_procs + self.frontend_procs
                    if p is not None and p.poll() is not None]
            if dead:
                raise RuntimeError(f"a fleet process exited during start: {dead[0]}")
            time.sleep(0.3)

    def wait_ready(self, timeout_s: float = 300.0) -> None:
        """Until every front end's /readyz (which needs every shard's) is
        200; without front ends, every shard's."""
        deadline = time.time() + timeout_s
        for url in self.frontend_urls or self.shard_urls:
            self._wait_url(url, deadline)

    def kill_shard(self, k: int, sig: int = signal.SIGKILL) -> None:
        proc = self.shard_procs[k]
        if proc is not None:
            proc.send_signal(sig)
            proc.wait(timeout=30)

    def restart_shard(self, k: int, timeout_s: float = 300.0) -> None:
        """A fresh process on the dead shard's port and journal; returns
        once its /readyz (journal replayed, jobs requeued) answers 200."""
        self.start_shard(k)
        self._wait_url(self.shard_urls[k], time.time() + timeout_s)

    def stop(self) -> None:
        procs = [p for p in self.shard_procs if p is not None] + self.frontend_procs
        for p in procs:
            try:
                p.send_signal(signal.SIGKILL)
            except Exception:  # noqa: BLE001 — already gone
                pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "ShardFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
