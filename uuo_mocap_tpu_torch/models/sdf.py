"""The learned marker -> surface attachment of the ``use_sdf`` marker stage
(counterpart of ``uuo_mocap_tpu/models/sdf.py``): ``PosDiff`` projects a
point onto the template's surface, ``Pos2BC`` turns the projected point
into a soft assignment over the template's vertices, and the inverse maps
an assignment back to a point on the template.  ``build_sdf_grid``
precomputes an unsigned-distance grid around the template."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel

POS2BC_CHECKPOINT = "barycentric_coords/pos2bc"
POS_DIFF_CHECKPOINT = "barycentric_coords/pos_diff"


class SDF:
    """The two nets, loaded from ``checkpoint_root`` onto the body model's
    device (``FileNotFoundError`` if a file is missing)."""

    def __init__(self, body: BodyModel, checkpoint_root: str):
        from uuo_mocap_tpu_torch.convert import pos2bc_from_flax, pos_diff_from_flax
        from uuo_mocap_tpu_torch.models.checkpoints import load_params

        self.body = body
        dev = body.device
        self.pos2bc = pos2bc_from_flax(load_params(checkpoint_root, POS2BC_CHECKPOINT), dev)
        self.pos_diff = pos_diff_from_flax(load_params(checkpoint_root, POS_DIFF_CHECKPOINT), dev)

    def points_to_barycentric_one_hot(self, points: torch.Tensor) -> torch.Tensor:
        """[..., M, 3] -> [..., M, V]: the PosDiff projection, then Pos2BC's
        softmax."""
        return torch.softmax(self.pos2bc(points + self.pos_diff(points)), dim=-1)

    def barycentric_one_hot_to_points(self, one_hot: torch.Tensor) -> torch.Tensor:
        """[..., M, V] -> [..., M, 3] on the template."""
        return one_hot @ self.body.v_template


def build_sdf_grid(body: BodyModel, resolution: Tuple[int, int, int] = (64, 64, 32),
                   pad: float = 0.1) -> Dict[str, np.ndarray]:
    """An unsigned-distance grid around the template body, ``pad`` metres
    beyond its bounds: {"sdf" [*resolution], "lower" [3], "upper" [3],
    "resolution" [3]}, 2048 grid points at a time."""
    from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance

    v = body.v_template.detach().cpu().numpy()
    lo, hi = v.min(0) - pad, v.max(0) + pad
    axes = [np.linspace(lo[d], hi[d], resolution[d], dtype=np.float32) for d in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    verts = body.v_template[None]
    dists, chunk = [], 2048
    with torch.no_grad():
        for i in range(0, grid.shape[0], chunk):
            pts = torch.as_tensor(grid[i:i + chunk], device=body.device)[None]
            dists.append(point_mesh_distance(pts, verts, body.faces)["distance"][0].cpu().numpy())
    d = np.concatenate(dists).reshape(resolution)
    return {"sdf": d, "lower": lo, "upper": hi, "resolution": np.asarray(resolution)}
