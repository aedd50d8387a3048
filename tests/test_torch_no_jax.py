"""The port stands alone: importing every module of ``uuo_mocap_tpu_torch``
(and ``chip_smoke.py``) loads none of ``jax``, ``uuo_mocap_tpu``, ``joblib``,
``flax``, ``msgpack`` and ``optax`` (absent on the GPU machine), and its entry
points refuse to run on the CPU unless asked to."""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import glob
import re
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
             if k.split(".")[0] in ("jax", "uuo_mocap_tpu", "joblib", "flax", "msgpack", "optax"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported
    # imports inside functions too (the probe sees only those that run on import)
    banned = re.compile(r"^\s*(from|import)\s+(jax|joblib|flax|msgpack|optax|uuo_mocap_tpu)\b",
                        re.M)
    sources = glob.glob(os.path.join(REPO, "uuo_mocap_tpu_torch", "**", "*.py"), recursive=True)
    offenders = [p for p in sources + [os.path.join(REPO, "chip_smoke.py")]
                 if banned.search(open(p).read())]
    assert len(sources) >= 20 and not offenders, offenders


_PROBE_NO_HOST_LIBS = r"""
import sys
HOST_ONLY = ("matplotlib", "mpl_toolkits", "PIL", "cv2", "pyrender", "trimesh")
for name in HOST_ONLY:
    sys.modules[name] = None  # import raises ImportError, as where they are not installed
import importlib, pkgutil
import uuo_mocap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(uuo_mocap_tpu_torch.__path__, "uuo_mocap_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from uuo_mocap_tpu_torch.vis import plots, viewer_pyrender
assert not viewer_pyrender.pyrender_available()
try:
    plots.plot_label_histogram("x.png", [0, 1])
except ImportError:
    pass
else:
    raise SystemExit("matplotlib was not blocked")
print(len(names), sorted(n for n in names if n.split(".")[1] == "vis"))
"""


def test_port_imports_without_the_host_only_libraries():
    """The card's machine has no matplotlib, PIL, cv2 or pyrender: every
    module of the port (and ``chip_smoke.py``) imports without them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE_NO_HOST_LIBS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20
    assert "uuo_mocap_tpu_torch.vis.renderer" in out.stdout


def test_entry_points_raise_without_a_gpu_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model
    from uuo_mocap_tpu_torch.cli import train as cli_train
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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--models", "foot_contact", "--steps", "1", "--checkpoints",
                        str(tmp_path / "ck")])
    assert not os.path.exists(tmp_path / "ck")
    assert resolve_device("cpu").type == "cpu"
