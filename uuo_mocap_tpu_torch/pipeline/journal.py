"""The iteration journal (counterpart of ``uuo_mocap_tpu/pipeline/
journal.py``): per-stage parameter snapshots, scores and times, and the
L-BFGS parameters at the end of every segment of ``SEGMENT_SIZE``
iterations, saved as a pickle of numpy arrays and Python scalars only, so
that the JAX package's visualizers (``vis/visualize_iterations.py``) read it
without torch.

The paper's pipeline dumps every optimizer iteration (its ``iter_fn``).  At
the port's rate of one host round per iteration that would copy every
lane's parameters each iteration (a 450-frame chamfer lane's ``pose6d``
alone is 250 KB), so the journal keeps the reference's segment rate.
"""
from __future__ import annotations

import pickle
import time
from typing import Any, Dict

import numpy as np


def _numpy(value):
    """A tensor (on any device) or array as numpy; anything else as it is."""
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value) if hasattr(value, "shape") else value


class IterationJournal:
    def __init__(self):
        self.entries: Dict[str, Any] = {}
        self._t0 = time.time()

    def record(self, stage: str, **data) -> None:
        """One entry under ``stage``: NamedTuples (``SmplParams``) become
        dicts of their fields, tensors numpy arrays (``journal.py:27-36``)."""
        entry: Dict[str, Any] = {"t": time.time() - self._t0}
        for key, value in data.items():
            if hasattr(value, "_fields"):
                entry[key] = {f: _numpy(getattr(value, f)) for f in value._fields}
            else:
                entry[key] = _numpy(value)
        self.entries.setdefault(stage, []).append(entry)

    def record_curve(self, stage: str, iteration: int, loss: float) -> None:
        self.entries.setdefault(f"{stage}__curve", []).append(
            {"iteration": int(iteration), "loss": float(loss)})

    def segment_hook(self, stage: str, convert=None):
        """An observer for ``BatchedLbfgs.snapshot``: every segment's lanes,
        iterations and parameters land under ``<stage>__segments``
        (``journal.py:41-62``).  ``convert(params, lanes)`` may turn the
        optimizer's parameters (6d rotations, yaw offsets) into render-ready
        arrays per lane."""

        def hook(lanes: np.ndarray, iters: np.ndarray, params) -> None:
            params = params if convert is None else convert(params, lanes)
            self.entries.setdefault(f"{stage}__segments", []).append(
                {"t": time.time() - self._t0, "lanes": lanes, "iters": iters,
                 "params": params})

        return hook

    def save(self, filename: str) -> str:
        with open(filename, "wb") as f:
            pickle.dump(self.entries, f)
        return filename

    @staticmethod
    def load(filename: str) -> Dict[str, Any]:
        """Read a journal this program wrote (pickle runs code: trust only
        such files)."""
        with open(filename, "rb") as f:
            return pickle.load(f)
