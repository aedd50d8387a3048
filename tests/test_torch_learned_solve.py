"""The whole learned slice against the JAX package on the CPU:
``multimodal_video_mocap`` with ``part.mode: network`` and
``marker.use_sdf: true`` on the shipped checkpoints, at F = 24 frames and
M = 12 markers with 5-iteration stages (the size of
``test_torch_ablation_configs.py``), with an iteration journal attached in
both packages.  Tolerances, as in ``test_torch_batch_solver.py``: the same
keys, stages, chain and marker labels; parameters within 1e-2, or within
twice what the reference itself moves when its markers are scaled by
1 + 1e-6 (that solve runs only when a difference passes 1e-2).  The
journals: the same entries, but for one difference by design (below), the
same segment lanes and iterations, and the recorded parameters and scores
under the same rule (the segments' parameters of the losing hypotheses are
not held: see ``test_journal_segments_match_jax``).  The pieces are held in ``test_torch_learned_modes.py``
and ``test_torch_models.py``.

The reference hooks its journal's segment observer on the marker stage's
plain solver (``uuo_mocap_tpu/pipeline/multimodal.py:556-566``), which does
not run under ``use_sdf``: its journal has no marker segments in SDF mode.
The port observes the solver that runs (ROADMAP C.10).
"""
import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")  # before torch loads OpenMP: see test_torch_batch_solver.py

import copy
import functools

import numpy as np
import pytest

from test_torch_cli import SharedReferenceSolvers
from test_torch_learned_modes import learned_config, models, sequence  # noqa: F401  (a fixture)
from uuo_mocap_tpu.data.img_smpl import ImgSmpl as JaxImgSmpl
from uuo_mocap_tpu.data.markers import ArrayMarkers as JaxArrayMarkers
from uuo_mocap_tpu.pipeline import multimodal as jmm
from uuo_mocap_tpu.pipeline.journal import IterationJournal as JaxIterationJournal
from uuo_mocap_tpu_torch.data.img_smpl import ImgSmpl
from uuo_mocap_tpu_torch.data.markers import ArrayMarkers
from uuo_mocap_tpu_torch.pipeline import multimodal as tmm
from uuo_mocap_tpu_torch.pipeline.journal import IterationJournal

PARAM_ATOL = 1e-2
PARAMS = ("trans", "pose_body", "root_orient", "betas")
STAGES = ("part", "chamfer", "marker", "marker_final")
SDF_SEGMENTS = {"marker__segments", "marker_final_0__segments"}


@pytest.fixture(scope="module")
def solves(models):
    """(reference output, its journal's entries), the same for the port, and
    the reference on markers scaled by 1 + 1e-6 (computed when needed)."""
    jm, tm = models
    gt, mk, prior = sequence(jm, 24, 12, seed=3)
    cfg = learned_config()
    shared = SharedReferenceSolvers()  # the scaled solve reuses the first's solvers

    def ref_solve(scale):
        journal = JaxIterationJournal()
        with shared.active():
            out = jmm.multimodal_video_mocap(JaxImgSmpl.from_params(prior),
                                             JaxArrayMarkers(mk * np.float32(scale)), cfg, jm,
                                             save_stages=True, iter_journal=journal,
                                             frame_bucket=None)
        return out, journal.entries

    journal = IterationJournal()
    ours = tmm.multimodal_video_mocap(ImgSmpl.from_params(prior), ArrayMarkers(mk.copy()),
                                      copy.deepcopy(cfg), tm, save_stages=True,
                                      iter_journal=journal, frame_bucket=None, device="cpu")
    return ref_solve(1.0), (ours, journal.entries), functools.lru_cache(None)(
        lambda: ref_solve(1 + 1e-6))


def _assert_close(ours, ref, moved, what):
    """``ours`` within 1e-2 of ``ref``, or within twice what the reference
    moves (``moved()``) under the marker scaling."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all(), what
    diff = float(np.abs(ours - ref).max())
    if diff > PARAM_ATOL:
        assert diff <= 2.0 * float(np.abs(np.asarray(moved()) - ref).max()), (what, diff)


def test_network_sdf_solve_matches_jax(solves):
    """Both packages' single-sequence solve with both learned modes on."""
    (ref, _), (ours, _), moved = solves
    assert set(ours) - {"stage_times_s"} == set(ref) - {"stage_times_s"}
    assert set(ours["stages"]) == set(ref["stages"]) == set(STAGES)
    np.testing.assert_array_equal(ours["chain"], ref["chain"])
    np.testing.assert_array_equal(ours["markers_labels"], ref["markers_labels"])
    for what in ("output",) + STAGES:
        d_o, d_r = (ours, ref) if what == "output" else (ours["stages"][what], ref["stages"][what])
        for k in PARAMS:
            _assert_close(d_o[k], d_r[k], lambda what=what, k=k: (
                moved()[0] if what == "output" else moved()[0]["stages"][what])[k],
                f"{what} {k}")


def test_journal_entries_match_jax(solves):
    (_, ref), (_, ours), _ = solves
    assert set(ours) == set(ref) | SDF_SEGMENTS and not SDF_SEGMENTS & set(ref)
    for key, entries in ref.items():
        assert len(ours[key]) == len(entries), key
        for o, r in zip(ours[key], entries):
            assert set(o) == set(r), key


def test_journal_segments_match_jax(solves):
    """The segment observer: the same lanes and iterations in every segment,
    and its parameters in the render-ready form.  They are not held to the
    reference's: at 5 iterations a losing hypothesis stops mid-descent, and
    one lands 1.3e-2 from the reference's where the reference itself moves by
    2.3e-3 under the scaling; the winners' are held through the records."""
    (_, ref), (_, ours), _ = solves
    for key in (k for k in ref if k.endswith("__segments")):
        for o, r in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(o["lanes"], r["lanes"], err_msg=key)
            np.testing.assert_array_equal(o["iters"], r["iters"], err_msg=key)
            for k in PARAMS:
                assert o["params"][k].shape == r["params"][k].shape, (key, k)
                assert np.isfinite(o["params"][k]).all(), (key, k)
    for key in SDF_SEGMENTS:  # the port's own: the SDF marker stages' segments
        assert ours[key] and all(np.all(e["iters"] <= 5) for e in ours[key]), key


def test_journal_records_match_jax(solves):
    """Each stage's recorded parameters, and the hypothesis scores."""
    (_, ref), (_, ours), moved = solves
    for key in (k for k in ref if not k.endswith("__segments")):
        for i, (o, r) in enumerate(zip(ours[key], ref[key])):
            for name, value in r.items():
                if name == "t":
                    continue
                fields = value if isinstance(value, dict) else {"": value}
                for f, v in fields.items():
                    got = o[name][f] if isinstance(value, dict) else o[name]
                    _assert_close(got, v, lambda key=key, i=i, name=name, f=f: (
                        moved()[1][key][i][name][f] if f else moved()[1][key][i][name]),
                        f"{key} {name} {f}")
