"""Generic worker entrypoint for subprocess jobs.

Replaces the reference's script-copy + shebang-rewrite job materialization
(cluster_tasks.py:352-372): instead of copying each task's source file into
tmp and executing it, workers re-import the task class from the installed
package and run its ``process_job``.  Invoked as::

    python -m cluster_tools_tpu_torch.core.worker <module> <class> <job_config.json>

stdout is the job log; success is signalled by the final "processed job %i"
line (reference protocol, utils/function_utils.py:11-16).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys


def main(argv) -> int:
    module_name, class_name, config_path = argv[:3]
    from .runtime import log, log_job_success

    with open(config_path) as f:
        job_config = json.load(f)
    job_id = job_config["job_id"]

    try:
        if module_name == "__main__":
            # the driver defined the task in its entry script; "__main__" here
            # is the worker itself, so force the source-file load below
            raise ModuleNotFoundError("__main__")
        module = importlib.import_module(module_name)
    except ModuleNotFoundError:
        # task class defined outside an importable package (e.g. a test file
        # or the user's driver script): load it from its source file, the
        # moral equivalent of the reference's copy-script-into-tmp job
        # materialization.  The module is loaded under a PRIVATE name —
        # loading a driver script as "__main__" would satisfy its
        # ``if __name__ == "__main__"`` guard and re-run the whole driver
        # (destructive setup included) inside every worker.
        src_file = job_config.get("src_file")
        if not src_file:
            raise
        load_name = ("_ctt_worker_driver" if module_name == "__main__"
                     else module_name)
        spec = importlib.util.spec_from_file_location(load_name, src_file)
        module = importlib.util.module_from_spec(spec)
        sys.modules[load_name] = module
        spec.loader.exec_module(module)
    task_cls = getattr(module, class_name)

    def log_fn(msg: str) -> None:
        log(msg)

    task_cls.process_job(job_id, job_config, log_fn)
    from .runtime import log_stage_times

    log_stage_times()
    log_job_success(job_id)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
