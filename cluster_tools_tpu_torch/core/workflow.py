"""Minimal workflow DAG engine (luigi replacement).

The reference drives everything through luigi (`luigi.build([task],
local_scheduler=True)`, example/multicut.py:95-106) with filesystem log files
as completion targets (cluster_tasks.py:247-248) — giving free workflow-level
resume.  This module keeps exactly those semantics — tasks declare
``requires()`` and ``output()`` targets; ``build()`` topologically executes
incomplete tasks; completed targets are skipped — without the luigi dependency
or its worker-scheduler machinery, which the block-task runtime replaces.
"""

from __future__ import annotations

import logging
import os
import traceback
from typing import Dict, Iterable, List, Union

logger = logging.getLogger("cluster_tools_tpu_torch")


class Target:
    def exists(self) -> bool:
        raise NotImplementedError


class FileTarget(Target):
    def __init__(self, path: str):
        self.path = path

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def touch(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "a"):
            pass

    def __repr__(self):
        return f"FileTarget({self.path})"


class DummyTarget(Target):
    """Always complete (reference: utils/task_utils.py:11-15 DummyTarget)."""

    def exists(self) -> bool:
        return True


class Task:
    """A node of the workflow DAG.

    Subclasses implement ``requires()`` (upstream tasks), ``output()``
    (completion target) and ``run()``.  Identity for deduplication is
    ``task_id`` which defaults to the class name plus the output path.
    """

    task_name: str = ""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        if not self.task_name:
            self.task_name = type(self).__name__

    def requires(self) -> Union["Task", Iterable["Task"], None]:
        return None

    def output(self) -> Target:
        return DummyTarget()

    def run(self) -> None:
        pass

    def complete(self) -> bool:
        return self.output().exists()

    @property
    def task_id(self) -> str:
        out = self.output()
        # non-FileTarget outputs get identity-based ids so two distinct task
        # instances are never silently deduplicated
        suffix = out.path if isinstance(out, FileTarget) else hex(id(self))
        return f"{type(self).__name__}:{suffix}"

    def _deps(self) -> List["Task"]:
        req = self.requires()
        if req is None:
            return []
        if isinstance(req, Task):
            return [req]
        return [t for t in req if t is not None]


class DummyTask(Task):
    """Always-complete dependency root (reference: utils/task_utils.py:11-15)."""

    task_id = "DummyTask"  # all instances interchangeable

    def output(self) -> Target:
        return DummyTarget()


class BuildError(RuntimeError):
    def __init__(self, task: Task, cause: BaseException):
        super().__init__(f"task {task.task_id} failed: {cause}")
        self.task = task
        self.cause = cause


def build(tasks: Iterable[Task], raise_on_failure: bool = False) -> bool:
    """Execute the DAG rooted at ``tasks`` depth-first, skipping complete tasks.

    Returns True on success — matching `luigi.build`'s boolean contract used
    throughout the reference tests.
    """
    done: Dict[str, bool] = {}
    order: List[Task] = []

    def visit(task: Task, stack: List[str]):
        tid = task.task_id
        if tid in done:
            if not done[tid] and tid in stack:
                raise RuntimeError(f"dependency cycle at {tid}")
            return
        if tid in stack:
            raise RuntimeError(f"dependency cycle at {tid}")
        done[tid] = False
        for dep in task._deps():
            visit(dep, stack + [tid])
        done[tid] = True
        order.append(task)

    for t in tasks:
        visit(t, [])

    for task in order:
        if task.complete():
            logger.info("skipping complete task %s", task.task_id)
            continue
        logger.info("running task %s", task.task_id)
        try:
            task.run()
        except Exception as e:
            logger.error("task %s failed:\n%s", task.task_id, traceback.format_exc())
            if raise_on_failure:
                raise BuildError(task, e) from e
            return False
        if not task.complete():
            logger.error("task %s ran but target %s missing", task.task_id, task.output())
            if raise_on_failure:
                raise BuildError(task, RuntimeError("output target missing after run"))
            return False
    return True
