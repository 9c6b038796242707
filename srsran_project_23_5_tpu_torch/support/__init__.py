"""Host runtime support: executors, timers, logging, IO (reference lib/support).

The TPU owns compute; these are the host-side orchestration primitives the
reference builds from raw threads (task_worker.h:34-73, io_broker,
unique_timer) — re-expressed on Python threads. They drive the slot
pipeline, L2 procedures, and gateways.
"""
from .executors import (ManualTaskWorker, TaskExecutor, TaskWorker,
                        TaskWorkerPool)
from .timers import TimerManager
from .srslog import LogChannel, get_logger, init_logging, flush_logs

__all__ = [
    "ManualTaskWorker", "TaskExecutor", "TaskWorker", "TaskWorkerPool",
    "TimerManager", "LogChannel", "get_logger", "init_logging", "flush_logs",
]
