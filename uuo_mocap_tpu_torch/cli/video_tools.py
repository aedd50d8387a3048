"""Video utilities: frame dump and marker-dot detection (counterpart of
``uuo_mocap_tpu/cli/video_tools.py``).

``video2images`` (video -> jpg frames) and ``detect_keypoints``
(HoughCircles marker-dot detector, exploratory).  Both need OpenCV, a
host-only optional dependency imported when they run; without it they exit
with a clear message.

Usage:
    python -m uuo_mocap_tpu_torch.cli.video_tools video2images --video V --out_dir D
    python -m uuo_mocap_tpu_torch.cli.video_tools detect_keypoints --image I
"""
from __future__ import annotations

import argparse
import os


def video2images(video_path: str, out_dir: str, stride: int = 1) -> int:
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("video2images requires OpenCV (cv2), which is not installed") from e

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    count = written = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if count % stride == 0:
            cv2.imwrite(os.path.join(out_dir, f"{count:06d}.jpg"), frame)
            written += 1
        count += 1
    cap.release()
    return written


def detect_keypoints(image_path: str, min_radius: int = 2, max_radius: int = 12):
    """HoughCircles white-dot detector -> [N, 3] (x, y, radius)."""
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("detect_keypoints requires OpenCV (cv2), which is not installed") from e
    import numpy as np

    img = cv2.imread(image_path, cv2.IMREAD_GRAYSCALE)
    img = cv2.medianBlur(img, 3)
    circles = cv2.HoughCircles(
        img, cv2.HOUGH_GRADIENT, dp=1, minDist=8, param1=120, param2=12,
        minRadius=min_radius, maxRadius=max_radius,
    )
    return np.asarray(circles[0]) if circles is not None else np.zeros((0, 3))


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("video2images")
    p1.add_argument("--video", required=True)
    p1.add_argument("--out_dir", required=True)
    p1.add_argument("--stride", type=int, default=1)
    p2 = sub.add_parser("detect_keypoints")
    p2.add_argument("--image", required=True)
    args = parser.parse_args(argv)

    if args.cmd == "video2images":
        n = video2images(args.video, args.out_dir, args.stride)
        print(f"wrote {n} frames")
    else:
        pts = detect_keypoints(args.image)
        print(f"detected {len(pts)} circles")
        for x, y, r in pts:
            print(f"  ({x:.1f}, {y:.1f}) r={r:.1f}")


if __name__ == "__main__":
    main()
