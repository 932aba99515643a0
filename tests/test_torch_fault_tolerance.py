"""The reference's crash-and-restart test (``tests/test_fault_tolerance.py::
test_crash_restart_supervisor``) on the port's CLIs, on the CPU: the
port's supervisor restarts the port's trainer after an injected crash at
step 30, which resumes from the step-20 checkpoint and finishes all 50
steps; and the trainer's entry point needs a card unless given a
device."""
import os
import subprocess
import sys

import pytest

from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_crash_restart_supervisor(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
           "--max-restarts", "2", "--",
           sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "qwen3-0.6b", "--reduced", "--steps", "50",
           "--batch", "2", "--seq", "32", "--device", "cpu",
           "--ckpt-dir", str(tmp_path), "--ckpt-every", "20",
           "--crash-at-step", "30"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "injected crash at step 30" in out.stdout
    assert "[train] resumed from step 20" in out.stdout
    assert "[supervisor] exit code 17" in out.stdout
    assert "[train] done" in out.stdout
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_")) == \
        ["step_00000020", "step_00000040", "step_00000050"]


def test_train_without_a_device_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-0.6b", "--reduced", "--steps", "1"])
