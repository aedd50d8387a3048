"""Interactive pyrender viewer (counterpart of
``uuo_mocap_tpu/vis/viewer_pyrender.py``; optional, needs OpenGL).

A ``pyrender.Viewer`` runs in its own thread while the frame callback fills
the scene under ``viewer.render_lock``.  It renders the same
``VideoMocapScene`` contract as the matplotlib renderer.  pyrender and
trimesh are imported when the viewer runs, never on import.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np

from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene


def pyrender_available() -> bool:
    try:
        import pyrender  # noqa: F401

        return True
    except Exception:
        return False


def run_viewer(
    scene: VideoMocapScene,
    render_frame_fn: Callable[[VideoMocapScene, int], None],
    num_frames: int,
    fps: float = 30.0,
    point_radius: float = 0.01,
) -> None:
    """Interactive loop: replays frames until the viewer window closes."""
    import pyrender
    import trimesh

    py_scene = pyrender.Scene(ambient_light=[0.35, 0.35, 0.35])
    py_scene.add(pyrender.DirectionalLight(color=np.ones(3), intensity=3.0),
                 pose=np.eye(4))

    if scene.floor is not None:
        quads = np.asarray(scene.floor["quads"], np.float32)  # [N, 4, 2]
        colors = np.asarray(scene.floor["colors"], np.float32)
        tris, cols = [], []
        for quad, col in zip(quads, colors):
            p = np.concatenate([quad, np.zeros((4, 1), np.float32)], axis=1)
            tris += [[p[0], p[1], p[2]], [p[0], p[2], p[3]]]
            cols += [col, col]
        floor_mesh = trimesh.Trimesh(
            vertices=np.asarray(tris).reshape(-1, 3),
            faces=np.arange(len(tris) * 3).reshape(-1, 3),
            face_colors=np.repeat(np.asarray(cols), 1, axis=0),
            process=False,
        )
        py_scene.add(pyrender.Mesh.from_trimesh(floor_mesh, smooth=False))

    viewer = pyrender.Viewer(
        py_scene, run_in_thread=True, use_raymond_lighting=True,
        viewport_size=(1024, 768),
    )

    dynamic_nodes = []
    frame = 0
    try:
        while viewer.is_active:
            scene.clear_dynamic()
            render_frame_fn(scene, frame % max(num_frames, 1))

            with viewer.render_lock:
                for node in dynamic_nodes:
                    py_scene.remove_node(node)
                dynamic_nodes.clear()
                for mesh in scene.meshes:
                    tm = trimesh.Trimesh(
                        vertices=np.asarray(mesh["vertices"]),
                        faces=np.asarray(mesh["faces"]),
                        vertex_colors=mesh.get("vertex_colors"),
                        process=False,
                    )
                    if mesh.get("vertex_colors") is None:
                        tm.visual.face_colors = np.asarray(list(mesh["color"]) + [1.0]) * 255
                    dynamic_nodes.append(py_scene.add(pyrender.Mesh.from_trimesh(tm, smooth=True)))
                for pts in scene.points:
                    sphere = trimesh.creation.icosphere(subdivisions=1, radius=point_radius)
                    tfs = np.tile(np.eye(4), (len(pts["points"]), 1, 1))
                    tfs[:, :3, 3] = np.asarray(pts["points"])
                    colors = np.atleast_2d(pts["colors"])
                    sphere.visual.vertex_colors = np.asarray(
                        list(colors[0]) + [1.0]) * 255
                    dynamic_nodes.append(
                        py_scene.add(pyrender.Mesh.from_trimesh(sphere, poses=tfs))
                    )
            frame += 1
            time.sleep(1.0 / fps)
    finally:
        if viewer.is_active:
            viewer.close_external()
