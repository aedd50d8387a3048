"""Surface-sample datasets for Pos2BC and PosDiff (counterpart of
``uuo_mocap_tpu/data/smplh_datasets.py``): random barycentric points on the
template's faces (area-weighted, optionally only the faces of some parts)
with their soft one-hot over the vertices, and uniform points in the
template's padded box with their displacement to the nearest surface point
(``ops/point_mesh.py``).  The draws use numpy ``RandomState`` in the
reference's order."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel


class SMPLHDataset:
    """On-surface samples and their barycentric one-hot targets."""

    def __init__(self, body: BodyModel, parts: Optional[Sequence[int]] = None, seed: int = 0):
        self.body = body
        self.rng = np.random.RandomState(seed)
        self.vertices = body.v_template.detach().cpu().numpy()
        self.faces = body.faces
        vertex_labels = body.vertex_part_labels().cpu().numpy()
        if parts is not None:  # a face belongs to the part of its highest-labelled vertex
            keep = np.isin(vertex_labels[self.faces].max(axis=1), np.asarray(list(parts)))
            self.face_ids = np.where(keep)[0]
        else:
            self.face_ids = np.arange(self.faces.shape[0])
        tri = self.vertices[self.faces[self.face_ids]]
        areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                                     axis=-1)
        self.face_probs = areas / areas.sum()

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        fidx = self.face_ids[self.rng.choice(len(self.face_ids), n, p=self.face_probs)]
        bary = self.rng.dirichlet((1.0, 1.0, 1.0), size=n).astype(np.float32)
        tri = self.vertices[self.faces[fidx]]
        pos = np.einsum("nk,nkd->nd", bary, tri).astype(np.float32)
        one_hot = np.zeros((n, self.body.num_vertices), np.float32)
        np.add.at(one_hot, (np.arange(n)[:, None].repeat(3, 1), self.faces[fidx]), bary)
        return {"pos": pos, "barycentric_one_hot": one_hot, "face_ids": fidx, "barycentric": bary}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {k: v[0] for k, v in self.sample(1).items()}

    def __len__(self) -> int:
        return 1 << 20


class SMPLHDiffDataset:
    """Uniform samples in the template's box padded by ``pad`` metres, and
    their displacements to the nearest surface point."""

    def __init__(self, body: BodyModel, pad: float = 0.1, seed: int = 0):
        self.body = body
        self.rng = np.random.RandomState(seed)
        v = body.v_template.detach().cpu().numpy()
        self.lower = v.min(0) - pad
        self.upper = v.max(0) + pad

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance

        pos = self.rng.uniform(self.lower, self.upper, (n, 3)).astype(np.float32)
        with torch.no_grad():
            closest = point_mesh_distance(torch.as_tensor(pos, device=self.body.device),
                                          self.body.v_template, self.body.faces)["closest_point"]
        closest = closest.cpu().numpy()
        return {"pos": pos, "pos_diff": closest - pos, "closest": closest}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {k: v[0] for k, v in self.sample(1).items()}

    def __len__(self) -> int:
        return 1 << 20
