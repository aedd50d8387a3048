"""SMPL inference wrappers (counterpart of ``uuo_mocap_tpu/body/smpl.py``):
``SmplInference`` runs one model on rotation-matrix poses;
``SmplInferenceGender`` runs the male and the female model on a batch of
sequences and blends them by each sequence's gender one-hot."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward, load_body_model
from uuo_mocap_tpu_torch.ops import rotations as rot


def _model(model: Optional[BodyModel | str], gender: str, device) -> BodyModel:
    """A ``BodyModel`` as given, loaded from a path, or (None) the
    synthetic model of ``gender`` on ``device``."""
    if model is None:
        from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

        return synthetic_body_model(device=device, gender=gender)
    if isinstance(model, str):
        return load_body_model(model, gender, device=device)
    return model


class SmplInference:
    """One gender's SMPL forward on rotation matrices."""

    def __init__(self, model: Optional[BodyModel | str] = None, gender: str = "neutral",
                 device=None):
        self.model = _model(model, gender, device)
        self.gender = gender

    def __call__(self, poses: torch.Tensor, betas: torch.Tensor, root_orient: torch.Tensor,
                 trans: torch.Tensor) -> Dict[str, torch.Tensor]:
        """poses [..., 23, 3, 3], betas [..., 10], root_orient [..., 1, 3, 3],
        trans [..., 3] -> {"joints" [..., 45, 3], "vertices" [..., V, 3]}."""
        if betas.shape[-1] != 10:
            raise ValueError("Betas array must have 10 beta values")
        return lbs_forward(self.model, poses, betas, root_orient, trans)

    @property
    def faces(self) -> np.ndarray:
        return self.model.faces

    @property
    def parents(self) -> np.ndarray:
        return self.model.parents

    def get_lbs_weights(self) -> torch.Tensor:
        return self.model.lbs_weights


class SmplInferenceGender:
    """The male and female models on [N, F, ...] batches, their outputs
    blended by a per-sequence (male, female) one-hot: both models run on
    every sequence, so the blend is differentiable in the one-hot."""

    def __init__(self, male: Optional[BodyModel | str] = None,
                 female: Optional[BodyModel | str] = None, device=None):
        self.models = {"male": _model(male, "male", device),
                       "female": _model(female, "female", device)}

    def __call__(self, poses: torch.Tensor, betas: torch.Tensor, root_orient: torch.Tensor,
                 trans: torch.Tensor, gender_one_hot: torch.Tensor, pose2rot: bool = True,
                 compute_part_labels: bool = False) -> Dict[str, torch.Tensor]:
        """poses [N, F, 69] axis-angle (or [N, F, 23, 3, 3] with
        ``pose2rot=False``), betas [N, 10], root_orient [N, F, 3] (or
        [N, F, 3, 3]), trans [N, F, 3], gender_one_hot [N, 2] ->
        {"joints" [N, F, 24, 3], "vertices" [N, F, V, 3]} and, with
        ``compute_part_labels``, "vertex_part_labels" [N, V, 24]: the LBS
        weights blended by the first sequence's one-hot."""
        if betas.shape[-1] != 10:
            raise ValueError("Betas array must have 10 beta values")
        if gender_one_hot.ndim != 2:
            raise ValueError("Gender one-hot vector must have 2 dimensions")
        N, F = trans.shape[:2]
        if pose2rot:
            pose_body = rot.axis_angle_to_matrix(poses.reshape(N, F, 23, 3))
            root_mat = rot.axis_angle_to_matrix(root_orient.reshape(N, F, 1, 3))
        else:
            pose_body = poses.reshape(N, F, 23, 3, 3)
            root_mat = root_orient.reshape(N, F, 1, 3, 3)
        betas_bf = betas[:, None, :].expand(N, F, 10)
        out_m = lbs_forward(self.models["male"], pose_body, betas_bf, root_mat, trans)
        out_f = lbs_forward(self.models["female"], pose_body, betas_bf, root_mat, trans)
        wm = gender_one_hot[:, None, None, None, 0]
        wf = gender_one_hot[:, None, None, None, 1]
        output = {
            "joints": out_m["joints"][..., :24, :] * wm + out_f["joints"][..., :24, :] * wf,
            "vertices": out_m["vertices"] * wm + out_f["vertices"] * wf,
        }
        if compute_part_labels:
            lbs = (self.models["male"].lbs_weights * gender_one_hot[0, 0]
                   + self.models["female"].lbs_weights * gender_one_hot[0, 1])
            output["vertex_part_labels"] = lbs[None].expand((N,) + lbs.shape)
        return output
