"""Evaluation metrics (counterpart of ``uuo_mocap_tpu/eval/metrics.py``):
m2s (marker to surface), MPJPE / PA-MPJPE (Procrustes-aligned), MPJVE /
PA-MPJVE (velocities at the sequence rate), V2V, and per-part variants.
Inputs are tensors in meters on one device; the dict builders return floats
in mm (``in_mm``)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from uuo_mocap_tpu_torch.body.joints import SMPL_LIMBS
from uuo_mocap_tpu_torch.ops.point_mesh import marker_to_surface_distance
from uuo_mocap_tpu_torch.ops.procrustes import similarity_transform

# joint subsets of the per-part metrics
PARTS_MAP: Dict[str, List[int]] = {"full": list(range(22)), **SMPL_LIMBS}


def _select(x: torch.Tensor, joint_ids: Sequence[int] | None) -> torch.Tensor:
    return x if joint_ids is None else x[:, list(joint_ids)]


def compute_m2s(markers: torch.Tensor, vertices: torch.Tensor, faces) -> torch.Tensor:
    """Mean |marker -> surface| distance."""
    return marker_to_surface_distance(markers, vertices, faces)


def compute_mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
                  joint_ids: Sequence[int] | None = None) -> torch.Tensor:
    return torch.linalg.norm(_select(pred_joints, joint_ids) - _select(gt_joints, joint_ids),
                             dim=-1).mean()


def compute_mpjve(pred_joints: torch.Tensor, gt_joints: torch.Tensor, freq: float,
                  joint_ids: Sequence[int] | None = None) -> torch.Tensor:
    pred_vel = (pred_joints[1:] - pred_joints[:-1]) * freq
    gt_vel = (gt_joints[1:] - gt_joints[:-1]) * freq
    return torch.linalg.norm(_select(pred_vel, joint_ids) - _select(gt_vel, joint_ids),
                             dim=-1).mean()


def compute_pa_mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
                     joint_ids: Sequence[int] | None = None) -> torch.Tensor:
    return compute_mpjpe(similarity_transform(pred_joints, gt_joints), gt_joints, joint_ids)


def compute_pa_mpjve(pred_joints: torch.Tensor, gt_joints: torch.Tensor, freq: float,
                     joint_ids: Sequence[int] | None = None) -> torch.Tensor:
    return compute_mpjve(similarity_transform(pred_joints, gt_joints), gt_joints, freq, joint_ids)


def compute_v2v(pred_vertices: torch.Tensor, gt_vertices: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(pred_vertices - gt_vertices, dim=-1).mean()


def compute_all_metrics(pred_joints: torch.Tensor, gt_joints: torch.Tensor,
                        pred_vertices: torch.Tensor, gt_vertices: torch.Tensor,
                        markers: torch.Tensor, faces, freq: float,
                        in_mm: bool = True) -> Dict[str, float]:
    """Every metric of one sequence; joints restricted to the first 22
    (hands excluded).  joints [F, >=22, 3], vertices [F, V, 3], markers
    [F, M, 3]."""
    scale = 1000.0 if in_mm else 1.0
    pj, gj = pred_joints[:, :22], gt_joints[:, :22]
    return {
        "m2s": float(compute_m2s(markers, pred_vertices, faces)) * scale,
        "mpjpe": float(compute_mpjpe(pj, gj)) * scale,
        "pa_mpjpe": float(compute_pa_mpjpe(pj, gj)) * scale,
        "mpjve": float(compute_mpjve(pj, gj, freq)) * scale,
        "pa_mpjve": float(compute_pa_mpjve(pj, gj, freq)) * scale,
        "v2v": float(compute_v2v(pred_vertices, gt_vertices)) * scale,
    }


def compute_part_metrics(pred_joints: torch.Tensor, gt_joints: torch.Tensor, freq: float,
                         in_mm: bool = True) -> Dict[str, Dict[str, float]]:
    """MPJPE, PA-MPJPE and MPJVE of each joint subset of ``PARTS_MAP``."""
    scale = 1000.0 if in_mm else 1.0
    out = {}
    for part, ids in PARTS_MAP.items():
        out[part] = {
            "mpjpe": float(compute_mpjpe(pred_joints, gt_joints, ids)) * scale,
            "pa_mpjpe": float(compute_pa_mpjpe(pred_joints[:, :22], gt_joints[:, :22],
                                               [i for i in ids if i < 22])) * scale,
            "mpjve": float(compute_mpjve(pred_joints, gt_joints, freq, ids)) * scale,
        }
    return out
