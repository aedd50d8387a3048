"""Offscreen renderer: scene frames -> mp4 / gif / png sequence (counterpart
of ``uuo_mocap_tpu/vis/renderer.py``).

A per-frame callback fills the scene (``vis/scene.py``, numpy arrays) and
the renderer writes the animation with matplotlib 3D (headless; Agg).
matplotlib is imported when a render runs, never on import, so the package
imports on a machine without it.  ``interactive`` opens the pyrender viewer
or a matplotlib window where one can run, else writes files.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from uuo_mocap_tpu_torch.vis.scene import VideoMocapScene


class VideoMocapRenderer:
    def __init__(
        self,
        scene: VideoMocapScene,
        render_frame_fn: Callable[[VideoMocapScene, int], None],
        num_frames: int,
        video_path: Optional[str] = None,
        video_fps: float = 30.0,
        figsize: float = 6.0,
        elev: float = 20.0,
        azim: float = -60.0,
        bounds: float = 1.6,
        quality: str = "normal",  # "ultra" bumps the dpi
    ):
        self.scene = scene
        self.render_frame_fn = render_frame_fn
        self.num_frames = num_frames
        self.video_path = video_path
        self.video_fps = video_fps
        self.figsize = figsize
        self.elev = elev
        self.azim = azim
        self.bounds = bounds
        self.dpi = 180 if quality == "ultra" else 100
        self._auto_limits = None  # fit to first frame's content

    def _fit_limits(self):
        pts = []
        for mesh in self.scene.meshes:
            pts.append(mesh["vertices"])
        for p in self.scene.points:
            pts.append(p["points"])
        for ln in self.scene.lines:
            pts.append(ln["starts"])
            pts.append(ln["ends"])
        if not pts:
            b = self.bounds
            return (-b, b), (-b, b), (-b, b)
        allp = np.concatenate([np.asarray(p).reshape(-1, 3) for p in pts], axis=0)
        center = (allp.min(0) + allp.max(0)) / 2
        half = max(float((allp.max(0) - allp.min(0)).max()) / 2, 0.5) * 1.2
        return (
            (center[0] - half, center[0] + half),
            (center[1] - half, center[1] + half),
            (center[2] - half, center[2] + half),
        )

    def _draw(self, ax, frame: int):
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        self.scene.clear_dynamic()
        self.render_frame_fn(self.scene, frame)

        ax.clear()
        ax.set_axis_off()
        # mplot3d's depth sorting fails across intersecting collections
        # (a large floor plane's mean depth beats the body); order explicitly
        ax.computed_zorder = False
        if self._auto_limits is None:
            self._auto_limits = self._fit_limits()
        xl, yl, zl = self._auto_limits
        ax.set_xlim(*xl)
        ax.set_ylim(*yl)
        ax.set_zlim(*zl)
        ax.view_init(elev=self.elev, azim=self.azim, vertical_axis=self.scene.up_axis)

        if self.scene.floor is not None:
            quads = self.scene.floor["quads"]
            colors = self.scene.floor["colors"]
            up = self.scene.up_axis
            # floor plane perpendicular to the up axis, at the content minimum
            lims = {"x": xl, "y": yl, "z": zl}
            level = lims[up][0]

            def lift(x, y):
                if up == "z":
                    return (x, y, level)
                if up == "y":
                    return (x, level, y)
                return (level, x, y)

            polys = [[lift(x, y) for (x, y) in quad] for quad in quads]
            pc = Poly3DCollection(polys, facecolors=colors, edgecolors="none", zsort="min", zorder=1)
            ax.add_collection3d(pc)

        for mesh in self.scene.meshes:
            v, f = mesh["vertices"], mesh["faces"]
            tri = v[f]
            if mesh.get("vertex_colors") is not None:
                cols = np.asarray(mesh["vertex_colors"])[f[:, 0]]
            else:
                cols = np.broadcast_to(mesh["color"], (tri.shape[0], 3))
            pc = Poly3DCollection(tri, facecolors=cols, edgecolors="none", alpha=0.9,
                                  zsort="average", zorder=2)
            ax.add_collection3d(pc)

        for ln in self.scene.lines:
            for s, e in zip(ln["starts"], ln["ends"]):
                ax.plot([s[0], e[0]], [s[1], e[1]], [s[2], e[2]], color=ln["color"],
                        linewidth=1.0, zorder=3)

        for pts in self.scene.points:
            p = pts["points"]
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=np.atleast_2d(pts["colors"]),
                       s=pts["size"], depthshade=False, zorder=4)

    def run_interactive(self) -> bool:
        """Interactive viewer: a pyrender
        window when OpenGL exists, else an interactive matplotlib animation
        when a display exists.  Returns False on headless machines so callers
        can fall back to ``run()``."""
        from uuo_mocap_tpu_torch.vis.viewer_pyrender import pyrender_available, run_viewer

        if pyrender_available():
            run_viewer(self.scene, self.render_frame_fn, self.num_frames, fps=self.video_fps)
            return True

        import matplotlib

        if not os.environ.get("DISPLAY") and not os.environ.get("WAYLAND_DISPLAY"):
            return False
        try:
            matplotlib.use("TkAgg")
        except Exception:
            return False
        import matplotlib.pyplot as plt
        from matplotlib import animation

        fig = plt.figure(figsize=(self.figsize, self.figsize), dpi=self.dpi)
        ax = fig.add_subplot(111, projection="3d")

        def update(frame):
            self._draw(ax, frame % max(self.num_frames, 1))
            return []

        anim = animation.FuncAnimation(  # noqa: F841 — must stay referenced
            fig, update, frames=self.num_frames, interval=1000.0 / self.video_fps, blit=False
        )
        plt.show()
        return True

    def run(self, interactive: bool = False) -> Optional[str]:
        """Render all frames.  Writes ``video_path`` (mp4/gif/png dir) and
        returns the path; with no path, renders the first frame to a preview
        png.  ``interactive=True`` opens the live viewer first (pyrender or
        an interactive matplotlib window) and only falls back to files when
        the machine is headless."""
        if interactive:
            try:
                if self.run_interactive():
                    return None
            except Exception as e:
                print(f"[viewer] interactive backend failed ({e}); writing files instead")

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(self.figsize, self.figsize), dpi=self.dpi)
        ax = fig.add_subplot(111, projection="3d")

        path = self.video_path
        if path is None:
            path = os.path.join(os.getcwd(), "render_preview.png")
            self._draw(ax, 0)
            fig.savefig(path)
            plt.close(fig)
            return path

        ext = os.path.splitext(path)[1].lower()
        if ext in (".mp4", ".gif"):
            from matplotlib import animation

            def update(frame):
                self._draw(ax, frame)
                return []

            anim = animation.FuncAnimation(fig, update, frames=self.num_frames, blit=False)
            if ext == ".mp4":
                try:
                    writer = animation.FFMpegWriter(fps=self.video_fps)
                    anim.save(path, writer=writer)
                except (FileNotFoundError, RuntimeError):
                    path = path[:-4] + ".gif"
                    anim.save(path, writer=animation.PillowWriter(fps=self.video_fps))
            else:
                anim.save(path, writer=animation.PillowWriter(fps=self.video_fps))
        else:  # directory of pngs
            os.makedirs(path, exist_ok=True)
            for frame in range(self.num_frames):
                self._draw(ax, frame)
                fig.savefig(os.path.join(path, f"{frame:06d}.png"))
        plt.close(fig)
        return path
