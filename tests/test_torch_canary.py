"""The port's integration canary (python -m dinox_torch.integration_canary)
on the CPU: its three gates (determinism, resume fidelity, the sampling
audit) pass at the default tolerance. The whole canary runs the trainer and
the synthetic-data CLI as subprocesses (six trainer runs, ~36 s on one
machine: marked slow); the in-process test runs the same gates with each
``python -m`` command dispatched to that module's ``main`` in this process."""

import contextlib
import importlib
import io
import json
import subprocess
import sys
import types

import pytest
import torch

from dinox_torch import integration_canary


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_report(path):
    report = json.loads(path.read_text())
    assert report["all_passed"], report
    assert report["determinism"]["max_rel_diff"] == 0.0 and report["determinism"]["tolerance"] == 1e-5
    assert report["resume_fidelity"]["steps_resumed"] == 4 and not report["resume_fidelity"]["any_nan"]
    samp = report["sampling_distribution"]
    assert samp["total_written"] == 96 and samp["smoke_train_ok"] and samp["max_abs_err"] <= 0.02


def _in_process(cmd, check=False, **_):
    """subprocess.run for ``python -m <module> args``: the module's main here."""
    assert cmd[:2] == [sys.executable, "-m"], cmd
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = importlib.import_module(cmd[2]).main(cmd[3:])
    if check and rc:
        raise subprocess.CalledProcessError(rc, cmd)
    return subprocess.CompletedProcess(cmd, rc, out.getvalue(), "")


def test_canary_gates_in_process(tmp_path, monkeypatch):
    monkeypatch.setattr(integration_canary, "subprocess",
                        types.SimpleNamespace(run=_in_process, CalledProcessError=subprocess.CalledProcessError))
    rc = integration_canary.main(["--steps", "2", "--device", "cpu", "--workdir", str(tmp_path / "work"),
                                  "--report", str(tmp_path / "report.json")])
    assert rc == 0
    _check_report(tmp_path / "report.json")


@pytest.mark.slow
def test_canary_passes_on_the_cpu(tmp_path):
    rc = integration_canary.main(["--steps", "2", "--device", "cpu", "--workdir", str(tmp_path / "work"),
                                  "--report", str(tmp_path / "report.json")])
    assert rc == 0
    _check_report(tmp_path / "report.json")
