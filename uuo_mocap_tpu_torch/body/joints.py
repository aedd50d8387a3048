"""Kinematic-subtree enumeration (a copy of the host-side algorithms in
``uuo_mocap_tpu/body/joints.py``; the port keeps its own copy rather than
importing the JAX package)."""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np


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
