"""Transfer observed marker positions onto the template body and export .ply
(counterpart of ``uuo_mocap_tpu/cli/export_marker_layout.py``).

For one frame of a solved sequence: attach each marker to its closest point
on the posed surface (``ops/point_mesh.py``, on the card unless
``--cpu_only``), carry the barycentric attachment over to the template
body, and write a .ply of the template with a small octahedron per marker,
colored by the part of the face it landed on.

Usage:
    python -m uuo_mocap_tpu_torch.cli.export_marker_layout --markers seq.c3d \
        --smpl seq_stageii.npz [--frame 0] [--output marker_layout.ply] [--cpu_only]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

# marker spheres: octahedra of 12 mm around each transferred position
SPHERE_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]) * 0.012
SPHERE_F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5],
                     [0, 3, 5]])


def write_ply(filename: str, vertices: np.ndarray, faces: np.ndarray,
              colors: np.ndarray | None = None) -> str:
    """Minimal ASCII PLY writer."""
    V, T = len(vertices), len(faces)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {V}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {T}\nproperty list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(vertices):
            line = f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
    return filename


def main(argv=None) -> Dict[str, np.ndarray]:
    """Writes the .ply; returns the attachment of ``--frame``'s markers to the
    posed surface: {"path", "face_index" [M], "barycentric" [M, 3],
    "distance" [M] and "closest_point" [M, 3] on the posed surface,
    "template_position" [M, 3] (m)}."""
    from uuo_mocap_tpu_torch.cli.test import device_from_args
    from uuo_mocap_tpu_torch.data.markers import Markers
    from uuo_mocap_tpu_torch.eval.comparisons import load_smpl_npz, smpl_forward_zeroed_hands
    from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance
    from uuo_mocap_tpu_torch.utils.colors import colors_for_labels

    parser = argparse.ArgumentParser()
    parser.add_argument("--markers", required=True, help=".c3d file")
    parser.add_argument("--smpl", required=True, help="solved *_stageii.npz for the same sequence")
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--output", type=str, default="marker_layout.ply")
    parser.add_argument("--body_models", type=str, default="./body_models")
    parser.add_argument("--cpu_only", action="store_true", help="run on the CPU")
    parser.add_argument("--gpu", type=int, default=None, help="CUDA device index (default 0)")
    args = parser.parse_args(argv)

    device = device_from_args(args)
    if os.path.exists(args.body_models):
        from uuo_mocap_tpu_torch.body.model import load_body_model

        model = load_body_model(args.body_models, "neutral", device=device)
    else:
        from uuo_mocap_tpu_torch.body.synthetic import synthetic_body_model

        model = synthetic_body_model(device=device)

    markers = np.nan_to_num(Markers(args.markers).get_points(), nan=0.0)
    out = smpl_forward_zeroed_hands(model, load_smpl_npz(args.smpl))
    frame = min(args.frame, markers.shape[0] - 1, int(out["vertices"].shape[0]) - 1)

    # attach markers to the posed surface, then transfer to the template
    with torch.no_grad():
        pm = point_mesh_distance(torch.as_tensor(markers[frame], device=device)[None],
                                 out["vertices"][frame][None], model.faces)
    face_idx = pm["face_index"][0].cpu().numpy()
    bary = pm["barycentric"][0].cpu().numpy()
    template = model.v_template.cpu().numpy()
    tmpl_pos = np.einsum("mk,mkd->md", bary, template[model.faces[face_idx]])

    labels = model.vertex_part_labels().cpu().numpy()
    marker_colors = colors_for_labels(labels[model.faces[face_idx][:, 0]])
    verts = [template]
    faces = [model.faces]
    colors = [np.full((template.shape[0], 3), 0.75)]
    offset = template.shape[0]
    for i, pos in enumerate(tmpl_pos):
        verts.append(SPHERE_V + pos)
        faces.append(SPHERE_F + offset)
        colors.append(np.tile(marker_colors[i], (6, 1)))
        offset += 6

    path = write_ply(args.output, np.concatenate(verts), np.concatenate(faces), np.concatenate(colors))
    print("wrote", path)
    return {"path": path, "face_index": face_idx, "barycentric": bary,
            "distance": pm["distance"][0].cpu().numpy(),
            "closest_point": pm["closest_point"][0].cpu().numpy(), "template_position": tmpl_pos}


if __name__ == "__main__":
    main()
