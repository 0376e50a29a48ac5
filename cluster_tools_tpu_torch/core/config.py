"""Three-tier JSON config system.

Mirrors the reference's config tiers (SURVEY.md §5.6; cluster_tasks.py:198-238):

1. **Global config** ``config_dir/global.config`` — block_shape, roi_begin/
   roi_end, block_list_path, max_num_retries, plus runtime globals
   (``device``: the torch device the fused device tasks run on, default
   ``"cuda"``) replacing the reference's scheduler/shebang fields.  The
   keys and defaults are those of the JAX package's global config, so a
   config directory written by either package is read unchanged by the
   other.
2. **Per-task config** ``config_dir/<task_name>.config`` — merged over the
   task's ``default_task_config()``; always includes executor resources
   (threads_per_job, time_limit, mem_limit) plus task tunables.
3. **Structural parameters** — constructor kwargs on tasks (paths, keys, flags).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

GLOBAL_CONFIG_NAME = "global.config"


def default_global_config() -> Dict[str, Any]:
    return {
        "block_shape": [64, 256, 256],
        "roi_begin": None,
        "roi_end": None,
        "block_list_path": None,
        "max_num_retries": 0,
        # torch device of the fused device tasks: the card unless the
        # caller asks for the CPU ("cpu"); a missing card raises
        "device": "cuda",
        # shards of a device mesh (parallel/mesh.py): 0 = one per visible
        # device; n > 0 places n shards round-robin over the visible
        # devices (several shards on one card, or on the CPU)
        "mesh_devices": 0,
        # span recording (core.telemetry): off by default; the ring size
        # bounds the in-memory span ring (None = recorder default)
        "telemetry_enabled": False,
        "telemetry_ring_size": None,
        # keys of the JAX package's global config that only its device
        # mesh, executable cache, metrics, server and multihost paths read:
        # kept so its config directories read unchanged, unused here
        "mesh_shape": None,
        "mesh_axis_names": None,
        "precision": "bfloat16",
        "exec_cache_dir": None,
        "exec_cache_max_bytes": None,
        "metrics_path": None,
        "slo_objectives": None,
        "barrier_timeout": None,
    }


#: global-config keys that are read via ``.get()`` but deliberately NOT
#: part of :func:`default_global_config` (written by tasks at runtime,
#: not user-tunable).  The ``config-key`` lint pass accepts these too.
EXTRA_GLOBAL_CONFIG_KEYS = frozenset({
    # recorded by FusedProblemWorkflow so downstream solver tasks
    # iterate the same slab grid
    "sub_graph_block_shape",
})


def declared_global_config_keys() -> frozenset:
    """Every key a ``global_config.get("...")`` access may legally use —
    the schema the ``config-key`` static-analysis pass checks against."""
    return frozenset(default_global_config()) \
        | frozenset(default_task_resources()) \
        | EXTRA_GLOBAL_CONFIG_KEYS


def default_task_resources() -> Dict[str, Any]:
    """Executor resources every task config carries (reference:
    cluster_tasks.py:172-196 always includes threads_per_job/time_limit/
    mem_limit/qos)."""
    return {
        "threads_per_job": 1,
        "time_limit": 60,
        "mem_limit": 2.0,
        "devices_per_job": 0,
    }


def read_config(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def write_config(path: str, config: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(config, f, indent=2, sort_keys=True, default=_json_default)
    os.replace(tmp, path)


def _json_default(obj):
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON serializable: {type(obj)}")


class ConfigDir:
    """Accessor for a config directory holding the global + per-task configs."""

    def __init__(self, config_dir: str):
        self.config_dir = config_dir
        os.makedirs(config_dir, exist_ok=True)

    def global_config(self) -> Dict[str, Any]:
        cfg = default_global_config()
        cfg.update(read_config(os.path.join(self.config_dir, GLOBAL_CONFIG_NAME)))
        return cfg

    def task_config(self, task_name: str, defaults: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        cfg = dict(defaults) if defaults else {}
        cfg.update(read_config(os.path.join(self.config_dir, task_name + ".config")))
        return cfg

    def write_global_config(self, config: Dict[str, Any]) -> None:
        full = default_global_config()
        full.update(config)
        write_config(os.path.join(self.config_dir, GLOBAL_CONFIG_NAME), full)

    def write_task_config(self, task_name: str, config: Dict[str, Any]) -> None:
        write_config(os.path.join(self.config_dir, task_name + ".config"), config)
