"""Child-process supervision for executor agents.

A copy of the JAX package's ``runtime/supervisor.py``, with per-slot
arguments: a CUDA context poisoned by a sticky error cannot be reset inside
its process, so running the executors as child agents confines the fault
to the child.

The reference leans on Docker/EC2 restart policies to bring dead workers
back (``aws-prod/docker-compose.yml`` service restarts; ``scripts/setup.sh``
EC2 boot). This is the framework-native equivalent for a single host: the
coordinator can run its executors as *supervised child agent processes*
(``tpuml-coordinator --agent-executors N``) instead of in-process threads,
so a fatal CUDA error (executor.DeviceLostError) kills only the
child — the scheduler's dead-worker sweep requeues its tasks, and the
supervisor respawns a fresh process with a fresh CUDA context. This closes the
local-mode containment gap: an in-process executor shares the coordinator's
backend, so a poisoned device would otherwise take the whole service down.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

from ..utils.logging import get_logger

logger = get_logger("tpuml.supervisor")


class AgentSupervisor:
    """Spawn and keep-alive N child processes.

    Restart policy: exponential backoff per slot starting at
    ``backoff_s`` (doubling to ``max_backoff_s``), reset after a child
    stays up ``healthy_after_s``. ``max_restarts`` (per slot)
    guards against crash *loops*: the counter is windowed — it resets (with
    the backoff) once a child stays up ``healthy_after_s`` — so routine
    device-fault exits over a long deployment never exhaust it; only
    back-to-back failures do. A slot that exhausts it stays down and is
    reported via ``status()`` (``restarts_total`` keeps the lifetime count).

    ``slot_envs`` (optional, one dict per slot) overlays environment
    variables onto a slot's children (a ``None`` value unsets the variable),
    and ``slot_args`` (optional, one argv list per slot) extends the
    command: the server runs slot 0 on the card and every other slot on the
    CPU (``--device cpu`` and ``CUDA_VISIBLE_DEVICES=""``).
    """

    def __init__(
        self,
        command: Sequence[str],
        n: int = 1,
        *,
        backoff_s: float = 1.0,
        max_backoff_s: float = 30.0,
        healthy_after_s: float = 60.0,
        max_restarts: int = 50,
        poll_interval_s: float = 0.5,
        slot_envs: Optional[Sequence[Optional[dict]]] = None,
        slot_args: Optional[Sequence[Sequence[str]]] = None,
    ):
        self.command = list(command)
        self.n = n
        self.slot_envs = list(slot_envs) if slot_envs else None
        if self.slot_envs is not None and len(self.slot_envs) != n:
            raise ValueError("slot_envs must have one entry per slot")
        self.slot_args = [list(a) for a in slot_args] if slot_args else None
        if self.slot_args is not None and len(self.slot_args) != n:
            raise ValueError("slot_args must have one entry per slot")
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.healthy_after_s = healthy_after_s
        self.max_restarts = max_restarts
        self.poll_interval_s = poll_interval_s
        self._procs: List[Optional[subprocess.Popen]] = [None] * n
        self._started_at: List[float] = [0.0] * n
        self._backoff: List[float] = [backoff_s] * n
        self._next_spawn: List[float] = [0.0] * n
        self._restarts: List[int] = [0] * n  # consecutive, reset on healthy
        self._restarts_total: List[int] = [0] * n
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        for i in range(self.n):
            self._spawn(i)
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def _spawn(self, i: int) -> None:
        try:
            import os

            # the children import this package from the same checkout,
            # whatever their working directory
            root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            env = {**os.environ,
                   "PYTHONPATH": os.pathsep.join(
                       p for p in (root, os.environ.get("PYTHONPATH")) if p)}
            if self.slot_envs and self.slot_envs[i] is not None:
                for k, v in self.slot_envs[i].items():
                    if v is None:  # overlay None = unset in the child
                        env.pop(k, None)
                    else:
                        env[k] = v
            argv = self.command + (self.slot_args[i] if self.slot_args else [])
            self._procs[i] = subprocess.Popen(argv, env=env)
            self._started_at[i] = time.time()
            logger.info(
                "Spawned agent slot %d (pid %s)", i, self._procs[i].pid
            )
        except OSError:
            # count a failed spawn like a crash: backoff + restart budget,
            # otherwise a persistently failing Popen retries every poll tick
            # forever and the crash-loop guard never triggers
            logger.exception("Spawn failed for slot %d", i)
            self._procs[i] = None
            self._restarts[i] += 1
            self._restarts_total[i] += 1
            self._next_spawn[i] = time.time() + self._backoff[i]
            self._backoff[i] = min(self._backoff[i] * 2, self.max_backoff_s)

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            now = time.time()
            for i, proc in enumerate(self._procs):
                if proc is not None:
                    rc = proc.poll()
                    if rc is None:
                        if now - self._started_at[i] > self.healthy_after_s:
                            self._backoff[i] = self.backoff_s
                            self._restarts[i] = 0
                        continue
                    uptime = now - self._started_at[i]
                    logger.warning(
                        "Agent slot %d (pid %s) exited rc=%s after %.1fs",
                        i, proc.pid, rc, uptime,
                    )
                    self._procs[i] = None
                    self._restarts[i] += 1
                    self._restarts_total[i] += 1
                    self._next_spawn[i] = now + self._backoff[i]
                    self._backoff[i] = min(self._backoff[i] * 2, self.max_backoff_s)
                if self._procs[i] is None and self._restarts[i] <= self.max_restarts:
                    if now >= self._next_spawn[i]:
                        self._spawn(i)

    def status(self) -> List[dict]:
        out = []
        for i, proc in enumerate(self._procs):
            out.append({
                "slot": i,
                "pid": proc.pid if proc is not None else None,
                "alive": proc is not None and proc.poll() is None,
                "restarts": self._restarts[i],
                "restarts_total": self._restarts_total[i],
                "gave_up": self._restarts[i] > self.max_restarts,
            })
        return out

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        deadline = time.time() + timeout_s
        # terminate in a loop until the monitor thread is confirmed dead:
        # a join timeout can leave it mid-iteration, able to _spawn a fresh
        # child AFTER a single terminate pass — which would leak an
        # unsupervised agent process (ADVICE r2)
        while True:
            for proc in self._procs:
                if proc is not None and proc.poll() is None:
                    proc.terminate()
            if self._thread is None or not self._thread.is_alive():
                break
            self._thread.join(timeout=max(0.1, min(2.0, deadline - time.time())))
            if time.time() >= deadline:
                # monitor wedged past the budget: sweep once more and move on
                for proc in self._procs:
                    if proc is not None and proc.poll() is None:
                        proc.terminate()
                break
        for proc in self._procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()


def agent_command(url: str, *, mem_mb: Optional[float] = None,
                  max_batch: Optional[int] = None) -> List[str]:
    """argv for one child agent process pointing at ``url``."""
    cmd = [
        sys.executable,
        "-m",
        "cs230_distributed_machine_learning_tpu_torch.runtime.agent",
        "--url",
        url,
    ]
    if mem_mb is not None:
        cmd += ["--mem-mb", str(mem_mb)]
    if max_batch is not None:
        cmd += ["--max-batch", str(max_batch)]
    return cmd
