"""Marker corruption models for robustness experiments (a copy of the
host-side numpy in ``uuo_mocap_tpu/data/markers_noise.py``; the same
``RandomState`` draws in the same order): distance-gated label swaps,
random tracking-loss blocks, and detached markers falling under gravity
onto the floor (an analytic projectile and ground model).
"""
from __future__ import annotations

import numpy as np


def markers_swap(
    points: np.ndarray,  # [F, M, 3]
    swap_probability: float = 0.01,
    distance_threshold: float = 0.2,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Randomly swap nearby marker pairs from a random frame onward
    (reference ``markers_noise.py:6-36``: swaps gated on inter-marker
    distance)."""
    rng = rng or np.random.RandomState(0)
    out = np.array(points)
    F, M, _ = points.shape
    for m_i in range(M):
        for m_j in range(m_i + 1, M):
            if rng.rand() >= swap_probability:
                continue
            f = rng.randint(0, F)
            if np.linalg.norm(out[f, m_i] - out[f, m_j]) < distance_threshold:
                tmp = out[f:, m_i].copy()
                out[f:, m_i] = out[f:, m_j]
                out[f:, m_j] = tmp
    return out


def markers_tracking_loss(
    points: np.ndarray,  # [F, M, 3]
    probability: float = 0.1,
    max_length: int = 30,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Zero out random per-marker frame blocks (occlusion; zeroed markers are
    masked by ``get_marker_mask`` downstream) — reference
    ``markers_noise.py:39-66``."""
    rng = rng or np.random.RandomState(0)
    out = np.array(points)
    F, M, _ = points.shape
    for m in range(M):
        if rng.rand() < probability:
            start = rng.randint(0, F)
            length = rng.randint(1, max_length + 1)
            out[start : start + length, m] = 0.0
    return out


def markers_tracking_loss_second_block(
    points: np.ndarray,
    probability: float = 0.1,
    max_length: int = 30,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """A second independent loss block per marker (reference
    ``markers_noise.py:69-87``)."""
    rng = rng or np.random.RandomState(1)
    return markers_tracking_loss(points, probability, max_length, rng)


def randomly_drop_markers(
    points: np.ndarray,  # [F, M, 3]
    frequency: float,
    marker_radius: float = 0.01,
    num_drop: int = 0,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Detach ``num_drop`` markers at staggered frames and let them fall
    ballistically onto the z=0 floor (analytic replacement for the
    reference's PyBullet sim, ``markers_utils.py:122-193``; same contract:
    markers keep their release velocity, fall under gravity, rest on the
    floor at their radius)."""
    if num_drop == 0:
        return points
    rng = rng or np.random.RandomState(0)
    F, M, _ = points.shape
    out = np.array(points)
    drop_indices = rng.permutation(M)[:num_drop]
    dt = 1.0 / frequency
    g = 9.8

    for k, m in enumerate(drop_indices):
        f0 = (k + 1) * (F // (num_drop + 1))
        if f0 < 1 or f0 >= F:
            continue
        p = points[f0, m].copy()
        v = (points[f0, m] - points[f0 - 1, m]) / dt
        for f in range(f0, F):
            # ballistic step with floor contact + damping
            v[2] -= g * dt
            p = p + v * dt
            if p[2] < marker_radius:
                p[2] = marker_radius
                v[:] = v * 0.3  # inelastic-ish bounce/friction
                v[2] = abs(v[2]) * 0.2
                if np.linalg.norm(v) < 1e-3:
                    v[:] = 0.0
            out[f, m] = p
    return out
