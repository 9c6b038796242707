"""Task executors (reference include/srsran/support/executors/*).

- TaskWorker: one named thread draining an MPSC queue
  (task_worker.h:34-73).
- TaskWorkerPool: N workers sharing one queue (task_worker_pool.h).
- ManualTaskWorker: deterministic inline executor for tests
  (manual_task_worker.h) — tasks queue until run_pending_tasks().
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class TaskExecutor:
    """Abstract executor interface (task_executor.h)."""

    def execute(self, task: Callable[[], None]) -> bool:
        raise NotImplementedError

    def defer(self, task: Callable[[], None]) -> bool:
        return self.execute(task)


class TaskWorker(TaskExecutor):
    """Single thread + blocking MPSC queue; FIFO execution order."""

    def __init__(self, name: str = "worker", qsize: int = 2048) -> None:
        self.name = name
        self._q: queue.Queue = queue.Queue(maxsize=qsize)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                break
            try:
                task()
            except Exception:  # noqa: BLE001 - log-and-continue semantics
                import traceback
                traceback.print_exc()

    def execute(self, task: Callable[[], None]) -> bool:
        if self._stop.is_set():
            return False
        try:
            self._q.put_nowait(task)
            return True
        except queue.Full:
            return False

    def wait_idle(self) -> None:
        """Block until every task queued so far has run."""
        done = threading.Event()
        self._q.put(done.set)
        done.wait()

    def stop(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._q.put(None)
            self._thread.join(timeout=5)


class TaskWorkerPool(TaskExecutor):
    """N threads sharing a queue (unordered completion)."""

    def __init__(self, nof_workers: int, name: str = "pool",
                 qsize: int = 4096) -> None:
        self.name = name
        self._q: queue.Queue = queue.Queue(maxsize=qsize)
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}#{i}",
                             daemon=True)
            for i in range(nof_workers)]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                self._q.put(None)     # propagate shutdown to siblings
                break
            try:
                task()
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()

    def execute(self, task: Callable[[], None]) -> bool:
        if self._stop:
            return False
        try:
            self._q.put_nowait(task)
            return True
        except queue.Full:
            return False

    def wait_idle(self) -> None:
        barrier = threading.Barrier(len(self._threads) + 1)

        def wait() -> None:
            barrier.wait()

        for _ in self._threads:
            self._q.put(wait)
        barrier.wait()

    def stop(self) -> None:
        if not self._stop:
            self._stop = True
            self._q.put(None)
            for t in self._threads:
                t.join(timeout=5)


class ManualTaskWorker(TaskExecutor):
    """Run-inline-on-demand executor making async code deterministic in
    tests (manual_task_worker.h)."""

    def __init__(self) -> None:
        self._pending: list[Callable[[], None]] = []

    def execute(self, task: Callable[[], None]) -> bool:
        self._pending.append(task)
        return True

    def run_pending_tasks(self) -> int:
        n = 0
        while self._pending:
            task = self._pending.pop(0)
            task()
            n += 1
        return n

    def has_pending_tasks(self) -> bool:
        return bool(self._pending)


class SyncExecutor(TaskExecutor):
    """Immediate inline execution."""

    def execute(self, task: Callable[[], None]) -> bool:
        task()
        return True
