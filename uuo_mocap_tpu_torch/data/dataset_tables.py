"""Vendored per-dataset marker tables (the port's own copy of
``uuo_mocap_tpu/data/dataset_tables.py``).

Factual marker-name constants of the public capture datasets (CMU Kitchen,
UMPM, MOYO) in the vendors' own naming: the backpack labels and part lists
of CMU Kitchen, UMPM's label fixes and part lists, MOYO's per-session
valid-marker whitelists and part lists.  ``cli/preprocess_datasets.py``
reads them, so preprocessing a raw dataset needs no other table.
"""
from __future__ import annotations

from typing import Dict, List

# ---- CMU kitchen -----------------------------------------------------------
# markers attached to the subject's backpack rig; removed by --remove_backpack
# (the dataset name then gains the ``_rb`` suffix)
CMU_KITCHEN_BACKPACK_LABELS: List[str] = [
    "LBWT", "NEWLBAC", "NEWRBAC", "RBAC", "RBWT", "T10", "T8",
]

# per-part subsets exported by --parts (the reference ships these four
# active entries; windows rotate through them round-robin)
CMU_KITCHEN_BODY_PARTS: Dict[str, List[str]] = {
    "right_arm": ["RWRA", "RWRB", "RFIN", "RTHMB", "RELB", "RFRM", "NEWRSHO", "RUPA"],
    "left_leg": ["LFWT", "LTHI", "LKNE", "LSHN", "LANK", "LHEE", "LTOE", "LMT5", "LMT1", "LRSTBEEF"],
    "left_shoulder": ["LELB", "LFRM", "NEWLSHO", "LUPA", "LSHO"],
}

# ---- UMPM ------------------------------------------------------------------
def umpm_fix_label(label: str) -> str:
    """Canonicalize a raw UMPM label: uppercase, fix the dataset's known
    LKNSSBK typo, prefix with the vendor namespace."""
    label = label.upper()
    if label == "LKNSSBK":
        label = "LKNEEBK"
    return "UMPM_" + label


UMPM_BODY_PARTS: Dict[str, List[str]] = {
    "left_arm": ["UMPM_LWREXT", "UMPM_LWRTOP", "UMPM_LWRLOW", "UMPM_LELBTOP", "UMPM_LELBEXT", "UMPM_LELBLOW", "UMPM_LSHLD"],
    "right_arm": ["UMPM_RWREXT", "UMPM_RWRTOP", "UMPM_RWRLOW", "UMPM_RELBTOP", "UMPM_RELBEXT", "UMPM_RELBLOW", "UMPM_RSHLD"],
    "left_leg": ["UMPM_LTOPLEG", "UMPM_LKNEEFR", "UMPM_LKNEEBK", "UMPM_LKNEEIS", "UMPM_LANKFR", "UMPM_LANKBK", "UMPM_LANKIS"],
    "right_leg": ["UMPM_RTOPLEG", "UMPM_RKNEEFR", "UMPM_RKNEEBK", "UMPM_RKNEEIS", "UMPM_RANKFR", "UMPM_RANKBK", "UMPM_RANKIS"],
}

# the finer-grained table used by the parts benchmark variant
UMPM_PARTS_BODY_PARTS: Dict[str, List[str]] = {
    **UMPM_BODY_PARTS,
    "left_shoulder": ["UMPM_LSHLD", "UMPM_BNECK", "UMPM_FRNECK", "UMPM_LELBTOP", "UMPM_LELBEXT", "UMPM_LELBLOW"],
    "right_shoulder": ["UMPM_RSHLD", "UMPM_BNECK", "UMPM_FRNECK", "UMPM_RELBTOP", "UMPM_RELBEXT", "UMPM_RELBLOW"],
    "left_forearm": ["UMPM_LWREXT", "UMPM_LWRTOP", "UMPM_LWRLOW", "UMPM_LELBTOP", "UMPM_LELBEXT", "UMPM_LELBLOW"],
    "right_forearm": ["UMPM_RWREXT", "UMPM_RWRTOP", "UMPM_RWRLOW", "UMPM_RELBTOP", "UMPM_RELBEXT", "UMPM_RELBLOW"],
    "left_lower_leg": ["UMPM_LKNEEFR", "UMPM_LKNEEBK", "UMPM_LKNEEIS", "UMPM_LANKFR", "UMPM_LANKBK", "UMPM_LANKIS"],
    "right_lower_leg": ["UMPM_RKNEEFR", "UMPM_RKNEEBK", "UMPM_RKNEEIS", "UMPM_RANKFR", "UMPM_RANKBK", "UMPM_RANKIS"],
    "left_ankle": ["UMPM_LANKFR", "UMPM_LANKBK", "UMPM_LANKIS"],
    "right_ankle": ["UMPM_RANKFR", "UMPM_RANKBK", "UMPM_RANKIS"],
    "head": ["UMPM_FHEAD", "UMPM_RHEAD", "UMPM_LHEAD"],
}

# ---- MOYO ------------------------------------------------------------------
# per-capture-session valid markers (the raw captures contain extra / broken
# channels; only these are trusted per session)
MOYO_VALID_MARKERS: Dict[str, List[str]] = {
    "20220923_20220926_with_hands": [
        "ARIEL", "C7", "CLAV", "LANK", "LBHD", "LBSH", "LBWT", "LELB", "LFHD",
        "LFRM", "LFSH", "LFWT", "LHEL", "LIDX3", "LIDX6", "LIEL", "LIHAND",
        "LIWR", "LKNE", "LKNI", "LMID0", "LMID6", "LMT1", "LMT5", "LOHAND",
        "LOWR", "LPNK3", "LPNK6", "LRNG3", "LRNG6", "LSHN", "LTHI", "LTHM3",
        "LTHM6", "LTOE", "LUPA", "MBWT", "MFWT", "RANK", "RBHD", "RBSH",
        "RBWT", "RELB", "RFHD", "RFRM", "RFSH", "RFWT", "RHEL", "RIDX3",
        "RIDX6", "RIEL", "RIHAND", "RIWR", "RKNE", "RKNI", "RMID0", "RMID6",
        "RMT1", "RMT5", "ROHAND", "ROWR", "RPNK3", "RPNK6", "RRNG3", "RRNG6",
        "RSHN", "RTHI", "RTHM3", "RTHM6", "RTOE", "RUPA", "STRN", "T10",
    ],
    "20221004_with_com": [
        "C7", "CLAV", "LANK", "LASI", "LBHD", "LELB", "LFHD", "LFIN", "LFRM",
        "LHEE", "LKNE", "LPSI", "LSHO", "LTHI", "LTIB", "LTOE", "LUPA",
        "LWRA", "LWRB", "RANK", "RASI", "RBAK", "RBHD", "RELB", "RFHD",
        "RFIN", "RFRM", "RHEE", "RKNE", "RPSI", "RSHO", "RTHI", "RTIB",
        "RTOE", "RUPA", "RWRA", "RWRB", "STRN", "T10",
    ],
}

MOYO_BODY_PARTS: Dict[str, List[str]] = {
    "left_arm": ["LUPA", "LELB", "LIEL", "LFRM", "LIWR", "LOWR", "LOHAND", "LIHAND"],
    "right_arm": ["RUPA", "RELB", "RIEL", "RFRM", "RIWR", "ROWR", "ROHAND", "RIHAND"],
    "left_leg": ["LTOE", "LMT5", "LMT1", "LHEL", "LANK", "LSHN", "LKNI", "LKNE", "LTHI"],
    "right_leg": ["RTOE", "RMT5", "RMT1", "RHEL", "RANK", "RSHN", "RKNI", "RKNE", "RTHI"],
    "left_shoulder": ["LFSH", "LBSH", "LUPA", "LELB", "LIEL"],
    "right_shoulder": ["RFSH", "RBSH", "RUPA", "RELB", "RIEL"],
}

# dataset kind -> (part table, session whitelists, label canonicalizer)
DATASET_PART_TABLES: Dict[str, Dict[str, List[str]]] = {
    "cmu_kitchen": CMU_KITCHEN_BODY_PARTS,
    "umpm": UMPM_BODY_PARTS,
    "umpm_parts": UMPM_PARTS_BODY_PARTS,
    "moyo": MOYO_BODY_PARTS,
}
