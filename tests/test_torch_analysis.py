"""The port's lint (``python -m cluster_tools_tpu_torch.analysis``): a
known-bad fixture per rule (rule id and line), the idioms each rule must
not flag, the pragma with its mandatory reason, the CLI's exit codes and
JSON, and the gate: the port and ``chip_smoke.py`` lint clean."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from cluster_tools_tpu_torch.analysis import ALL_RULES, run_analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(tmp_path, relname, src):
    """A fixture source; a directory component (``core/x.py``) triggers
    the directory-scoped rules as in the real tree."""
    path = tmp_path / relname
    path.parent.mkdir(parents=True, exist_ok=True)
    src = textwrap.dedent(src).lstrip("\n")
    path.write_text(src)
    return str(path), src


def _line(src, needle):
    return next(i for i, ln in enumerate(src.splitlines(), 1)
                if needle in ln)


def _found(path, rule):
    report = run_analysis(files=[path], rules=[rule])
    return sorted((f.rule, f.line) for f in report["findings"])


def test_rule_ids():
    assert len(ALL_RULES) == 10
    assert "port-boundary" in ALL_RULES and "device-fallback" in ALL_RULES
    assert "trace-purity" not in ALL_RULES and "dtype-f64" not in ALL_RULES


def test_port_boundary_fixture(tmp_path):
    path, src = _fixture(tmp_path, "bad_imports.py", """
        import jax.numpy as jnp
        from cluster_tools_tpu.core import storage
        import sklearn.ensemble
        import imageio
        import numpy as np


        def f():
            import h5py
            from tensorstore import open as ts_open
            import importlib
            importlib.import_module("numcodecs.blosc")
            from sklearn.ensemble import RandomForestClassifier
            import imageio.v2 as imageio2
            return np
    """)
    # ``_line`` finds the first line with a needle: the module-level
    # imageio import; the function-local sklearn and imageio are allowed
    want = sorted(("port-boundary", _line(src, needle)) for needle in (
        "import jax.numpy", "from cluster_tools_tpu", "import sklearn",
        "import imageio", "import h5py",
        "from tensorstore", "numcodecs.blosc"))
    assert _found(path, "port-boundary") == want


def test_port_boundary_allows_the_port_and_relative_imports(tmp_path):
    path, _ = _fixture(tmp_path, "good_imports.py", """
        import torch
        import cluster_tools_tpu_torch.core.storage
        from cluster_tools_tpu_torch import kernels
        from . import sibling
        from ..core import hdf5


        def fit():
            from sklearn.ensemble import RandomForestClassifier
            return RandomForestClassifier
    """)
    assert _found(path, "port-boundary") == []


def test_device_fallback_fixture(tmp_path):
    path, src = _fixture(tmp_path, "bad_fallback.py", """
        import torch
        from .edt import minplus_cuda, minplus_plain


        def run(x):
            try:
                return minplus_cuda(x)
            except RuntimeError:
                return minplus_plain(x)


        def pick():
            return "cuda" if torch.cuda.is_available() else "cpu"


        def move(x):
            if not torch.cuda.is_available():
                x = x.cpu()
            return x
    """)
    want = sorted(("device-fallback", _line(src, needle)) for needle in (
        "except RuntimeError", "return \"cuda\" if",
        "if not torch.cuda.is_available()"))
    assert _found(path, "device-fallback") == want


def test_device_fallback_allows_raising_and_cpu_tensors(tmp_path):
    path, _ = _fixture(tmp_path, "good_fallback.py", """
        import torch
        from .edt import minplus_cuda, minplus_plain


        def run(x):
            if x.device.type == "cpu":
                return minplus_plain(x)
            try:
                return minplus_cuda(x)
            except RuntimeError as e:
                raise RuntimeError("the kernel failed") from e


        def need_card():
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device")
    """)
    assert _found(path, "device-fallback") == []


@pytest.mark.parametrize("rule,rel,src,needle", [
    ("blocking-under-lock", "core/bad_lock.py", """
        import threading
        _lock = threading.Lock()


        def f(path):
            with _lock:
                open(path).read()
    """, "open(path)"),
    ("atomic-write", "bad_write.py", """
        import json


        def f(path, d):
            with open(path, "w") as fh:
                json.dump(d, fh)
    """, "json.dump"),
    ("config-key", "bad_config.py", """
        def f(self):
            return self.global_config.get("max_num_retires", 0)
    """, "max_num_retires"),
    ("stage-registry", "bad_stage.py", """
        from .runtime import stage_add


        def f(kind):
            stage_add(f"sync-{kind}", 1.0)
    """, "sync-"),
    ("metric-registry", "bad_metric.py", """
        NAME = "ctt_not_a_registered_metric"
    """, "ctt_not"),
    ("dtype-int32", "ops/bad_ids.py", """
        def f(seed_ids):
            return seed_ids.astype("int32")
    """, "astype"),
])
def test_ported_rule_fixtures(tmp_path, rule, rel, src, needle):
    """The rules the port's lint keeps from the JAX package's, each on a
    known-bad fixture: exactly one finding, on its line."""
    path, text = _fixture(tmp_path, rel, src)
    assert _found(path, rule) == [(rule, _line(text, needle))]


def test_pragma_needs_a_reason(tmp_path):
    path, src = _fixture(tmp_path, "pragmas.py", """
        import h5py  # ctt-lint: disable=port-boundary (fixture: reasoned)
        import tensorstore  # ctt-lint: disable=port-boundary
        # ctt-lint: disable=port-boundary (the line above counts too)
        import numcodecs
    """)
    report = run_analysis(files=[path])
    got = sorted((f.rule, f.line) for f in report["findings"])
    assert got == sorted([("port-boundary", _line(src, "import tensorstore")),
                          ("pragma-reason", _line(src, "import tensorstore"))])
    sup = sorted((f.line, f.reason) for f in report["suppressed"])
    assert sup == [(1, "fixture: reasoned"),
                   (4, "the line above counts too")]


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m",
                           "cluster_tools_tpu_torch.analysis", *args],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=ROOT)


def test_cli_exit_codes_and_json(tmp_path, capsys):
    """The CLI's ``main``: 1 with a finding (printed, and in the JSON
    report), 0 without or when the rule is filtered out, 2 (argparse) for
    an unknown rule id."""
    from cluster_tools_tpu_torch.analysis import main

    bad, _ = _fixture(tmp_path, "bad.py", "import jax\n")
    good, _ = _fixture(tmp_path, "good.py", "import torch\n")
    out = str(tmp_path / "report.json")
    assert main([bad, "--json", out]) == 1
    assert "port-boundary" in capsys.readouterr().out
    with open(out) as f:
        report = json.load(f)
    assert report["n_findings"] == 1 and report["cmd"] == "lint"
    assert report["counts"] == {"port-boundary": 1}
    assert main([good, "--quiet"]) == 0
    assert main([bad, "--rules", "device-fallback"]) == 0
    with pytest.raises(SystemExit) as exc:
        main(["--rules", "trace-purity"])
    assert exc.value.code == 2


def test_port_is_lint_clean(tmp_path):
    """The gate: ``python -m cluster_tools_tpu_torch.analysis`` exits 0 on
    the port and ``chip_smoke.py``, every suppression with its reason."""
    out = str(tmp_path / "lint.json")
    res = _cli("--json", out)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(out) as f:
        report = json.load(f)
    assert report["n_findings"] == 0
    assert all(s["reason"] for s in report["suppressed"])
    scanned = report["files_scanned"]
    n_py = sum(name.endswith(".py") for _, _, names in os.walk(
        os.path.join(ROOT, "cluster_tools_tpu_torch")) for name in names)
    assert scanned == n_py + 1  # the package and chip_smoke.py
