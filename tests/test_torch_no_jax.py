"""The port stands alone: importing every module of ``uuo_mocap_tpu_torch``
(and ``chip_smoke.py``) loads neither ``jax`` nor ``uuo_mocap_tpu``, and its
entry points refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import uuo_mocap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(uuo_mocap_tpu_torch.__path__, "uuo_mocap_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "uuo_mocap_tpu" or k.startswith("uuo_mocap_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence
    from uuo_mocap_tpu_torch.device import resolve_device
    from uuo_mocap_tpu_torch.pipeline.multimodal import multimodal_video_mocap

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        synthetic_body_model()
    with pytest.raises(RuntimeError):
        random_pose_sequence(4)
    model = synthetic_body_model(device="cpu")
    with pytest.raises(RuntimeError):
        multimodal_video_mocap(None, None, {}, model)
    assert resolve_device("cpu").type == "cpu"
