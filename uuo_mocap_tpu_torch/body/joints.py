"""SMPL joint tables and kinematic-subtree enumeration (a copy of the
host-side tables and algorithms in ``uuo_mocap_tpu/body/joints.py``; the
port keeps its own copy rather than importing the JAX package)."""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

SMPL_JOINT_NAMES: List[str] = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot", "right_foot",
    "neck", "left_collar", "right_collar", "head", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "left_hand", "right_hand",
]


def get_joint_id(name: str) -> int:
    return SMPL_JOINT_NAMES.index(name)


def get_joint_name(joint_id: int) -> str:
    return SMPL_JOINT_NAMES[joint_id]


def get_all_joint_ids() -> List[int]:
    return list(range(len(SMPL_JOINT_NAMES)))


SMPL_LIMBS: Dict[str, List[int]] = {
    "head": [get_joint_id("head")],
    "left_arm": [get_joint_id(n) for n in ("left_shoulder", "left_elbow", "left_wrist", "left_hand")],
    "left_leg": [get_joint_id(n) for n in ("left_hip", "left_knee", "left_foot", "left_ankle")],
    "left_shoulder": [get_joint_id(n) for n in ("left_collar", "left_shoulder", "left_elbow")],
    "right_arm": [get_joint_id(n) for n in ("right_shoulder", "right_elbow", "right_wrist", "right_hand")],
    "right_leg": [get_joint_id(n) for n in ("right_hip", "right_knee", "right_foot", "right_ankle")],
    "right_shoulder": [get_joint_id(n) for n in ("right_collar", "right_shoulder", "right_elbow")],
}


# (left, right) joint pairs, merged by network-mode segmentation
SMPL_JOINT_SYMMETRY: List[List[int]] = [
    [get_joint_id("left_" + n), get_joint_id("right_" + n)]
    for n in ("hip", "knee", "ankle", "foot", "collar", "shoulder", "elbow", "wrist", "hand")
]


def get_sub_hierarchies(parents: Sequence[int], num_bones: int) -> List[List[int]]:
    """All connected subtrees of the kinematic tree with exactly
    ``num_bones`` nodes, each rooted at some node."""
    parents = np.asarray(parents)
    num_bones = min(num_bones, len(parents))

    children: Dict[int, List[int]] = {i: [] for i in range(len(parents))}
    for i in range(1, len(parents)):
        children[int(parents[i])].append(i)

    subtrees_table: Dict[int, List[List[int]]] = {}
    for node in reversed(range(len(parents))):
        subtrees_table[node] = [[]]
        for combo in itertools.product(*[subtrees_table[c] for c in children[node]]):
            cand = [node] + sorted(x for sub in combo for x in sub)
            if cand not in subtrees_table[node]:
                subtrees_table[node].append(cand)

    return [subtree for node in range(len(parents)) for subtree in subtrees_table[node]
            if len(subtree) == num_bones]


def remove_approximately_redundant_hierarchies(
    subtrees: List[List[int]], similarity_threshold: float = 0.9
) -> List[List[int]]:
    """Greedy dedup of subtrees sharing more than ``similarity_threshold``
    of their nodes with an earlier one."""
    output = [subtrees[0]]
    for subtree in subtrees[1:]:
        limit = len(subtree) * similarity_threshold
        if all(len(set(subtree) & set(kept)) <= limit for kept in output):
            output.append(subtree)
    return output
