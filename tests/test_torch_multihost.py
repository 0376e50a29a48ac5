"""Multi-process runs of the port (``parallel/multihost.py`` and the
runtime's ``_run_jobs_multiprocess``) on the CPU, mirroring
``tests/test_multihost.py``: two cooperating processes complete a
blockwise workflow over the shared store equal to the single-process
run (and to the JAX package's), in-run block retry across processes, a
cross-process ``all_reduce`` over ``torch.distributed`` (gloo on
127.0.0.1, a free port) with ``make_multihost_mesh``, and the trace
shards' merge."""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np

from cluster_tools_tpu_torch.core.config import ConfigDir
from cluster_tools_tpu_torch.core.storage import file_reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(script, n=2, args=None, env_extra=None, per_process_env=True):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CTT_PROCESS_COUNT", "CTT_PROCESS_ID")}
    env.update(env_extra or {})
    procs = []
    for pid in range(n):
        e = dict(env)
        if per_process_env:
            e["CTT_PROCESS_COUNT"] = str(n)
            e["CTT_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, script] + ([str(pid)] if args else []), env=e,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


DRIVER = """
import sys
sys.path.insert(0, {repo!r})

if __name__ == "__main__":
    import cluster_tools_tpu_torch as ctp

    wf = ctp.ThresholdedComponentsWorkflow(
        input_path={path!r}, input_key="vol", output_path={path!r},
        output_key="cc_multi", threshold=0.5, tmp_folder={tmp!r},
        config_dir={cfg!r}, max_jobs=4, target="inline")
    assert ctp.build([wf], raise_on_failure=True)
"""


def _volume(shape=(16, 16, 32), seed=0):
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, "float32")
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for _ in range(30):
        c = rng.rand(3) * np.array(shape)
        d2 = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        vol = np.maximum(vol, np.exp(-d2 / 3.0).astype("float32"))
    return vol


def test_two_process_blockwise_cooperation(tmp_path):
    import cluster_tools_tpu_torch as ctp
    from cluster_tools_tpu.core.config import ConfigDir as JConfigDir
    from cluster_tools_tpu.core.storage import file_reader as jreader
    from cluster_tools_tpu.core.workflow import build as jbuild
    from cluster_tools_tpu.workflows.thresholded_components import \
        ThresholdedComponentsWorkflow as JTC

    vol = _volume()
    path = str(tmp_path / "d.n5")
    with file_reader(path) as f:
        f.require_dataset("vol", shape=vol.shape, chunks=(8, 8, 8),
                          dtype="float32")[:] = vol
    cfg = str(tmp_path / "cfg")
    ConfigDir(cfg).write_global_config({"block_shape": [8, 8, 8],
                                        "device": "cpu"})
    wf = ctp.ThresholdedComponentsWorkflow(
        input_path=path, input_key="vol", output_path=path,
        output_key="cc_single", threshold=0.5,
        tmp_folder=str(tmp_path / "single"), config_dir=cfg, max_jobs=2,
        target="inline")
    assert ctp.build([wf], raise_on_failure=True)
    jcfg = str(tmp_path / "jcfg")
    JConfigDir(jcfg).write_global_config({"block_shape": [8, 8, 8]})
    assert jbuild([JTC(input_path=path, input_key="vol", output_path=path,
                       output_key="cc_jax", threshold=0.5,
                       tmp_folder=str(tmp_path / "jax"), config_dir=jcfg,
                       max_jobs=2, target="inline")], raise_on_failure=True)

    script = str(tmp_path / "driver.py")
    multi_tmp = str(tmp_path / "multi")
    with open(script, "w") as f:
        f.write(DRIVER.format(repo=REPO, path=path, tmp=multi_tmp, cfg=cfg))
    _spawn(script)

    with file_reader(path, "r") as f:
        single, multi = f["cc_single"][:], f["cc_multi"][:]
    with jreader(path, "r") as f:
        jax_single = f["cc_jax"][:]
    np.testing.assert_array_equal(multi, single)
    np.testing.assert_array_equal(multi, jax_single)
    # both processes processed blocks (job 0 and job 1 logs)
    logs = os.listdir(os.path.join(multi_tmp, "logs"))
    counts = []
    for job in (0, 1):
        with open(os.path.join(multi_tmp, "logs",
                               f"block_components_{job}.log")) as f:
            counts.append(len(re.findall("processed block", f.read())))
    assert all(c > 0 for c in counts) and sum(counts) == 16, counts
    # the lead wrote the status, naming itself and the process count
    with open(os.path.join(multi_tmp, "block_components.status")) as f:
        st = json.load(f)
    assert st["process_count"] == 2 and st["process_index"] == 0
    assert len(logs) >= 2


RETRY_DRIVER = """
import os, sys
sys.path.insert(0, {repo!r})

from cluster_tools_tpu_torch.core.blocking import Blocking
from cluster_tools_tpu_torch.core.runtime import BlockTask
from cluster_tools_tpu_torch.core.storage import file_reader


class FlakyFillTask(BlockTask):
    '''Writes block_id+1 into each block; ODD blocks fail on the first
    attempt (marker files track attempts).'''

    task_name = "flaky_fill"

    def __init__(self, path, **kw):
        self.path = path
        super().__init__(**kw)

    def run_impl(self):
        with file_reader(self.path, "r") as f:
            shape = list(f["vol"].shape)
        bs = self.global_block_shape()
        with file_reader(self.path) as f:
            f.require_dataset("filled", shape=shape, chunks=bs,
                              dtype="uint32")
        self.run_jobs(self.blocks_in_volume(shape, bs),
                      {{"path": self.path, "shape": shape,
                        "block_shape": bs,
                        "marker_dir": self.tmp_folder}})

    @classmethod
    def process_job(cls, job_id, job_config, log_fn):
        cfg = job_config["config"]
        blocking = Blocking(cfg["shape"], cfg["block_shape"])
        ds = file_reader(cfg["path"])["filled"]
        injected = []
        for bid in job_config["block_list"]:
            marker = os.path.join(cfg["marker_dir"], f"attempt_{{bid}}")
            first = not os.path.exists(marker)
            open(marker, "a").close()
            if bid % 2 == 1 and first:
                injected.append(bid)
                continue
            ds[blocking.get_block(bid).bb] = bid + 1
            log_fn(f"processed block {{bid}}")
        if injected:
            raise RuntimeError(f"injected failures for blocks {{injected}}")


if __name__ == "__main__":
    from cluster_tools_tpu_torch.core.config import ConfigDir
    from cluster_tools_tpu_torch.core.workflow import build

    cfg = ConfigDir({cfg!r})
    cfg.write_global_config({{"block_shape": [8, 8, 8],
                              "max_num_retries": 1, "device": "cpu"}})
    task = FlakyFillTask(path={path!r}, tmp_folder={tmp!r},
                         config_dir={cfg!r}, max_jobs=2, target="inline")
    assert build([task], raise_on_failure=True)
"""


def test_two_process_in_run_block_retry(tmp_path):
    """Injected per-block failures recover IN-RUN across two processes
    from the shared logs, with no driver rerun."""
    from cluster_tools_tpu_torch.core.blocking import Blocking

    path = str(tmp_path / "d.n5")
    shape = (16, 16, 16)
    with file_reader(path) as f:
        f.require_dataset("vol", shape=shape, chunks=(8, 8, 8),
                          dtype="float32")[:] = 0.0
    script = str(tmp_path / "driver.py")
    tmp = str(tmp_path / "retry")
    with open(script, "w") as f:
        f.write(RETRY_DRIVER.format(repo=REPO, path=path, tmp=tmp,
                                    cfg=str(tmp_path / "cfg")))
    outs = _spawn(script)
    with file_reader(path, "r") as f:
        filled = f["filled"][:]
    blocking = Blocking(list(shape), [8, 8, 8])
    for bid in range(8):
        assert (filled[blocking.get_block(bid).bb] == bid + 1).all(), bid
    assert all(os.path.exists(os.path.join(tmp, f"attempt_{b}"))
               for b in range(8))
    assert any("multiprocess retry" in o for o in outs), outs[0][-500:]


COLLECTIVE_DRIVER = """
import os, sys
sys.path.insert(0, {repo!r})

if __name__ == "__main__":
    import torch
    import torch.distributed as dist
    from cluster_tools_tpu_torch.parallel import multihost as mh

    pid = int(sys.argv[1])
    mh.init_distributed(coordinator_address="127.0.0.1:{port}",
                        num_processes=2, process_id=pid)
    assert mh.process_count() == 2 and mh.process_index() == pid
    group, mesh = mh.make_multihost_mesh(("data", "model"), dcn_axis=0,
                                         device="cpu", mesh_devices=4)
    assert group is not None and mesh.shape == {{"data": 1, "model": 4}}
    x = torch.arange(4, dtype=torch.float32) + 10 * pid
    dist.all_reduce(x, group=group)
    assert x.tolist() == [10.0, 12.0, 14.0, 16.0], x.tolist()
    # a second init is a no-op
    mh.init_distributed(coordinator_address="127.0.0.1:{port}",
                        num_processes=2, process_id=pid)
    dist.barrier()
    dist.destroy_process_group()
    print(f"p{{pid}} cross-process all_reduce ok")
"""


def test_two_process_cross_process_all_reduce(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = str(tmp_path / "collective.py")
    with open(script, "w") as f:
        f.write(COLLECTIVE_DRIVER.format(repo=REPO, port=port))
    outs = _spawn(script, args=True, per_process_env=False)
    assert all("all_reduce ok" in o for o in outs), outs


SHARD_DRIVER = """
import json, os, sys, time
sys.path.insert(0, {repo!r})

if __name__ == "__main__":
    from cluster_tools_tpu_torch.core import telemetry
    from cluster_tools_tpu_torch.parallel import multihost as mh

    pid = mh.process_index()
    telemetry.configure(enabled=True)
    with telemetry.span(f"job:p{{pid}}", cat="job", process_index=pid,
                        process_count=mh.process_count()):
        with telemetry.span("sync-execute", cat="stage") as sp:
            time.sleep(0.05 * (pid + 1))
            telemetry.annotate_memory(sp)
    anchor = mh.clock_anchor({tmp!r})
    mh.export_trace_shard({tmp!r}, anchor=anchor)
    mh.fs_barrier({tmp!r}, "shards-done")
    if mh.is_lead():
        m = mh.merge_trace_shards(
            {tmp!r}, os.path.join({tmp!r}, "merged_trace.json"))
        with open(os.path.join({tmp!r}, "merge_summary.json"), "w") as f:
            json.dump(m, f)
    rec = telemetry.flight_record(os.path.join({tmp!r}, f"fr{{pid}}"),
                                  reason="probe")
    with open(rec) as f:
        fr = json.load(f)
    assert (fr["process_index"], fr["process_count"]) == (pid, 2), fr
    print("shard ok")
"""


def test_two_process_trace_shards_merge(tmp_path):
    tmp = str(tmp_path / "shared")
    os.makedirs(tmp)
    script = str(tmp_path / "driver.py")
    with open(script, "w") as f:
        f.write(SHARD_DRIVER.format(repo=REPO, tmp=tmp))
    _spawn(script)
    for pid in range(2):
        with open(os.path.join(tmp, f"trace_shard_p{pid}.json")) as f:
            sh = json.load(f)
        assert sh["process_index"] == pid and sh["process_count"] == 2
        assert sh["spans"]
    with open(os.path.join(tmp, "merge_summary.json")) as f:
        m = json.load(f)
    assert m["n_processes"] == 2
    assert [p["pid"] for p in m["processes"]] == [1, 2]
    busy = {p["process_index"]: p["device_busy_s"] for p in m["processes"]}
    assert busy[0] >= 0.04 and busy[1] >= 0.09, busy
    assert abs(m["rollups"]["device_busy_s"] - (busy[0] + busy[1])) < 2e-4
    offs = [p["clock_offset_s"] for p in m["processes"]]
    assert min(offs) == 0.0 and max(offs) < 30.0, offs
    with open(os.path.join(tmp, "merged_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert {e["pid"] for e in events} == {1, 2}
    assert any(e["ph"] == "X" and e["name"] == "sync-execute"
               and e["pid"] == 2 for e in events)


def test_single_process_defaults(monkeypatch, tmp_path):
    """One process: count 1, index 0, lead, every block owned, barriers
    and ``init_distributed`` no-ops; the env pair overrides."""
    from cluster_tools_tpu_torch.parallel import multihost as mh

    monkeypatch.delenv("CTT_PROCESS_COUNT", raising=False)
    monkeypatch.delenv("CTT_PROCESS_ID", raising=False)
    assert mh.process_count() == 1 and mh.process_index() == 0
    assert mh.is_lead() and mh.owned_blocks(range(5)) == list(range(5))
    mh.fs_barrier(str(tmp_path), "noop", timeout=0.1)
    mh.init_distributed()
    monkeypatch.setenv("CTT_PROCESS_COUNT", "3")
    monkeypatch.setenv("CTT_PROCESS_ID", "1")
    assert mh.owned_blocks(range(7)) == [1, 4]
    assert not mh.is_lead()
