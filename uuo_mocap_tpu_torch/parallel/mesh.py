"""Device-mesh parallelism for the solver (counterpart of
``uuo_mocap_tpu/parallel/mesh.py``).

A ``DeviceMesh`` is a (data, model) grid of ``torch.device``s driven from
one process, as a JAX mesh is driven from one controller; no process group
or launcher is involved.

  * **data axis**: independent work units (sequences x yaw hypotheses x
    subtree candidates, the lanes of every stage's L-BFGS closure) split in
    contiguous blocks, one per grid row; each block runs on its row's first
    device and its losses come back, with their gradients, to the device
    that holds the L-BFGS state (``split_closure``).  A lane count the data
    axis does not divide runs whole on the first row, as
    ``make_lane_resharder`` replicates it.
  * **model axis**: the SMPL vertex dimension.  The per-vertex tensors of
    ``BodyModel`` (``v_template``, ``shapedirs``, ``posedirs``,
    ``j_regressor``'s columns, ``lbs_weights``) are cut into contiguous
    vertex blocks, one per grid column; the joint quantities (the
    pre-contracted ``j_template`` / ``j_shapedirs``) stay whole on every
    row, and every row computes the full 24-joint kinematic chain.  The
    dense forward returns its vertices as an ``ops.sharded.VertexShards``,
    whose min over V runs per block (the port's kernels on CUDA) and
    combines across blocks with a global argmin (``ops/sharded.py``); the
    gathered forward reads each picked vertex's rows from the block that
    owns it.

On one card a grid may name the same device twice (``devices=["cuda:0",
"cuda:0"]``): the arithmetic of the split and the combine runs as it would
across cards, on one.  ``make_mesh`` without ``devices=`` takes the visible
cards and raises without one; a CPU grid is named explicitly
(``devices=["cpu"] * 8``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from uuo_mocap_tpu_torch.body.model import (
    NUM_BETAS, NUM_JOINTS, NUM_POSE_JOINTS, BodyModel, _compose_kinematic_chain, _rot_mats,
    lbs_forward)
from uuo_mocap_tpu_torch.ops import rotations as rot
from uuo_mocap_tpu_torch.ops import sharded
from uuo_mocap_tpu_torch.ops.chamfer import min_sqdist
from uuo_mocap_tpu_torch.utils import tracing


def _norm_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """A (data, model) grid of devices: ``devices[d, m]``; ``shape`` maps the
    axis names to their sizes, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "model": int(devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None, devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over ``devices`` (default: every visible card), axes (data,
    model), the first ``n_devices`` of them.  Defaults as the reference's:
    model axis 2 when the count is even and above 1, the rest data."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; name the devices "
                               "(devices=['cpu'] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_norm_device(d) for d in devices]
    devices = devices[: n_devices or len(devices)]
    n = len(devices)
    if model is None:
        model = 2 if n % 2 == 0 and n > 1 else 1
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, got {n}")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(devices):
        grid[i // model, i % model] = d
    return DeviceMesh(grid)


# -------------------------------------------------------------- model axis

class _Block:
    """One vertex block of the model's per-vertex tensors, on one device."""

    def __init__(self, model: BodyModel, lo: int, hi: int, device: torch.device):
        def put(t):
            return t.to(device).contiguous()

        V = model.num_vertices
        self.device, self.offset, self.size = device, lo, hi - lo
        self.v_template = put(model.v_template[lo:hi])
        self.shapedirs = put(model.shapedirs[lo:hi])
        self.shapedirs_flat = put(model.shapedirs_flat[:, 3 * lo:3 * hi])
        pd = model.posedirs.reshape(NUM_POSE_JOINTS * 9, V, 3)
        self.posedirs = put(pd[:, lo:hi].reshape(NUM_POSE_JOINTS * 9, 3 * (hi - lo)))
        self.posedirs_v = put(model.posedirs_v[lo:hi])
        self.j_regressor = put(model.j_regressor[:, lo:hi])
        self.lbs_weights = put(model.lbs_weights[lo:hi])


class _Row:
    """One grid row's copy of the model: ``whole`` (a ``BodyModel`` on the
    row's device) when the model axis is 1, else its vertex blocks and the
    replicated joint quantities on the row's first device."""

    def __init__(self, model: BodyModel, devices: Sequence[torch.device], bounds: List[int]):
        self.home = devices[0]
        self.whole: Optional[BodyModel] = None
        self.blocks: List[_Block] = []
        if len(devices) == 1:
            self.whole = model if _norm_device(model.device) == self.home else BodyModel(
                model.v_template.to(self.home), model.shapedirs.to(self.home),
                model.posedirs.to(self.home), model.j_regressor.to(self.home),
                model.lbs_weights.to(self.home), model.faces, model.parents, model.gender)
            return
        self.blocks = [_Block(model, lo, hi, d)
                       for lo, hi, d in zip(bounds[:-1], bounds[1:], devices)]
        self.j_template = model.j_template.to(self.home)
        self.j_shapedirs = model.j_shapedirs.to(self.home)


class _RowsView:
    """A per-vertex tensor of the active row, read by global vertex ids
    (``lbs_forward_at``'s gathers): each id from the block that owns it."""

    def __init__(self, owner: "ShardedBodyModel", name: str):
        self._owner, self._name = owner, name

    @property
    def shape(self) -> torch.Size:
        return getattr(self._owner.base, self._name).shape

    def __getitem__(self, ids: torch.Tensor) -> torch.Tensor:
        row = self._owner._row
        if row.whole is not None:
            return getattr(row.whole, self._name)[ids]
        return sharded.take_rows([getattr(b, self._name) for b in row.blocks],
                                 [b.offset for b in row.blocks], ids, ids.device, axis=0)


class ShardedBodyModel:
    """A ``BodyModel`` placed on a mesh: one copy per data row, each cut into
    vertex blocks over the row's model-axis devices.  It answers the
    attributes and forwards the solve reads (``lbs_forward`` dispatches
    here, ``lbs_forward_at`` reads the per-vertex tensors through
    ``_RowsView``) for the active row, which ``on_row`` selects (the data
    axis's closures; row 0 otherwise).  ``base`` is the unsharded model:
    the template of the coarse-to-fine rank table and the SDF nets' body."""

    def __init__(self, model: BodyModel, mesh: DeviceMesh):
        self.base = model
        self.gender, self.faces, self.parents = model.gender, model.faces, model.parents
        self.levels = model.levels
        V, S = model.num_vertices, mesh.shape["model"]
        self.bounds = [int(b) for b in np.cumsum([0] + [len(c) for c in np.array_split(
            np.arange(V), S)])]
        self.rows = [_Row(model, list(mesh.devices[d]), self.bounds)
                     for d in range(mesh.shape["data"])]
        self._active = 0
        self._labels = model.vertex_part_labels().to(self.rows[0].home)
        for name in ("v_template", "shapedirs", "posedirs_v", "lbs_weights"):
            setattr(self, name, _RowsView(self, name))

    @property
    def _row(self) -> _Row:
        return self.rows[self._active]

    @contextlib.contextmanager
    def on_row(self, d: int):
        prev, self._active = self._active, d
        try:
            yield
        finally:
            self._active = prev

    @property
    def device(self) -> torch.device:
        return self.rows[0].home

    @property
    def num_vertices(self) -> int:
        return self.base.num_vertices

    @property
    def j_template(self) -> torch.Tensor:
        row = self._row
        return row.whole.j_template if row.whole is not None else row.j_template

    @property
    def j_shapedirs(self) -> torch.Tensor:
        row = self._row
        return row.whole.j_shapedirs if row.whole is not None else row.j_shapedirs

    def vertex_part_labels(self) -> torch.Tensor:
        return self._labels

    def lbs_forward(self, pose_body: torch.Tensor, betas: torch.Tensor,
                    root_orient: torch.Tensor, trans: torch.Tensor) -> Dict[str, Any]:
        """``body.model.lbs_forward`` on the active row: on a split row the
        vertices come back as a ``VertexShards`` (block s on its device),
        the joints whole on the row's first device.  The rest joints sum
        each block's regressor columns, so they differ from the unsharded
        forward's by float32 rounding."""
        row = self._row
        if row.whole is not None:
            return lbs_forward(row.whole, pose_body, betas, root_orient, trans)
        home = trans.device
        batch = trans.shape[:-1]
        tracing.count_dense_lbs(batch.numel(), False)
        b2 = betas.expand(batch + (NUM_BETAS,)).reshape(-1, NUM_BETAS)
        pose_body, rot_mats = _rot_mats(pose_body, root_orient, batch)
        eye = torch.eye(3, dtype=trans.dtype, device=home)
        pose_feature = (pose_body - eye).reshape(-1, NUM_POSE_JOINTS * 9)
        shaped, joints_rest = [], None
        for b in row.blocks:
            vs = b.v_template + (b2.to(b.device) @ b.shapedirs_flat).reshape(batch + (b.size, 3))
            shaped.append(vs)
            part = (b.j_regressor @ vs).to(home)
            joints_rest = part if joints_rest is None else joints_rest + part
        posed_joints, A = _compose_kinematic_chain(rot_mats, joints_rest, self.parents, self.levels)
        A12 = A.reshape(batch + (NUM_JOINTS, 12))
        parts = []
        for b, vs in zip(row.blocks, shaped):
            v_posed = vs + (pose_feature.to(b.device) @ b.posedirs).reshape(batch + (b.size, 3))
            T = (b.lbs_weights @ A12.to(b.device)).reshape(batch + (b.size, 3, 4))
            vx, vy, vz = v_posed[..., 0:1], v_posed[..., 1:2], v_posed[..., 2:3]
            verts = T[..., 0] * vx + T[..., 1] * vy + T[..., 2] * vz + T[..., 3]
            parts.append(verts + trans.to(b.device)[..., None, :])
        verts = sharded.VertexShards(parts, [b.offset for b in row.blocks], home)
        extra = verts.index_select(-2, self.base.extra_joint_ids.to(home))
        return {"joints": torch.cat([posed_joints + trans[..., None, :], extra], dim=-2),
                "vertices": verts}


def _shard_model_by_vertex(model: BodyModel, mesh: DeviceMesh) -> ShardedBodyModel:
    """Place the body model's per-vertex tensors on the mesh, cut by vertex
    over the model axis, one copy per data row."""
    return ShardedBodyModel(model, mesh)


# --------------------------------------------------------------- data axis

def _tree(fn, t):
    if isinstance(t, torch.Tensor):
        return fn(t)
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(*(_tree(fn, v) for v in t)) if hasattr(t, "_fields") else \
            type(t)(_tree(fn, v) for v in t)
    return t


def _first_leaf(t) -> torch.Tensor:
    while not isinstance(t, torch.Tensor):
        t = next(iter(t.values())) if isinstance(t, dict) else t[0]
    return t


def _row_scope(model, d):
    return model.on_row(d) if isinstance(model, ShardedBodyModel) else contextlib.nullcontext()


def run_blocks(mesh: DeviceMesh, model, fn: Callable, lane_args: Sequence, rest: Sequence = ()):
    """``fn(*lane_args, *rest)`` with the lane trees ``lane_args`` split over
    the data axis in contiguous blocks: block d moved to row d's first
    device and run with row d's model (``rest`` moved whole), its outputs
    brought back to the lanes' device and concatenated.  A lane count the
    axis does not divide runs whole on row 0.  Autograd follows the moves,
    so gradients reach the caller's tensors."""
    D = mesh.shape["data"]
    leaf = _first_leaf(lane_args[0])
    L, home = leaf.shape[0], leaf.device
    if D == 1 or L % D:
        with _row_scope(model, 0):
            return fn(*lane_args, *rest)
    n = L // D
    outs = []
    for d in range(D):
        dev = mesh.devices[d, 0]
        blk = [_tree(lambda t: t[d * n:(d + 1) * n].to(dev), a) for a in lane_args]
        moved = [_tree(lambda t: t.to(dev), a) for a in rest]
        with _row_scope(model, d):
            outs.append(_tree(lambda t: t.to(home), fn(*blk, *moved)))
    return _cat_trees(outs)


def _cat_trees(outs):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    if isinstance(first, dict):
        return {k: _cat_trees([o[k] for o in outs]) for k in first}
    cols = (_cat_trees(list(c)) for c in zip(*outs))
    return type(first)(*cols) if hasattr(first, "_fields") else type(first)(cols)


def split_closure(fun: Callable, mesh: DeviceMesh, model) -> Callable:
    """A ``BatchedLbfgs`` closure ``fun(params, lane, shared, *aux) -> [L]``
    (or its ``prepare`` hook) with its lanes split over the data axis: the
    parameters, the lane data and the aux split by block, ``shared`` moved
    whole (``batch_solver.py:84-97``'s resharder)."""
    def run(params, lane, shared, *aux):
        return run_blocks(mesh, model, lambda p, ln, *rest: fun(p, ln, rest[-1], *rest[:-1]),
                          (params, lane) + tuple(aux), (shared,))

    return run


def sharded_hypothesis_solve(model, mesh: DeviceMesh, loss_and_solve_fn: Callable):
    """Run a hypothesis batch data-parallel over the mesh: the [A_total, ...]
    inputs split over ``data``, each block solved where it lies, the scores
    gathered for the argmin (first on ties).

    ``loss_and_solve_fn(inputs) -> (params, scores)`` takes a block of
    hypotheses as lanes ([A_d, ...] leaves, scores [A_d]): the port's form
    of the reference's ``vmap``.  ``model`` is the model the function reads
    (a ``ShardedBodyModel`` gets the block's row).  Returns ``run(inputs)
    -> (best params, scores [A_total])``."""
    def run(hypothesis_inputs):
        params, scores = run_blocks(mesh, model, loss_and_solve_fn, (hypothesis_inputs,))
        best = int(torch.argmin(scores))
        return _tree(lambda x: x[best], params), scores

    return run


def min_over_vertices(x: torch.Tensor, verts, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """min over V of d^2(x, y) (+ bias), differentiable: ``min_sqdist`` (the
    forward and backward kernels on CUDA) on a whole cloud, per block and
    combined on a ``VertexShards``.  x [..., M, 3] -> [..., M]."""
    if bias is None:
        bias = torch.zeros((), dtype=x.dtype, device=x.device).expand(verts.shape[:-1])
    if isinstance(verts, sharded.VertexShards):
        x = x.expand(verts.shape[:-2] + x.shape[-2:])
        return sharded.min_value(x, verts, bias)
    return min_sqdist(x, verts, bias)


def sharded_train_step(model: BodyModel, mesh: DeviceMesh):
    """A full sharded gradient step of the flagship compute: the chamfer of
    an SMPL batch against markers (whose min over V runs per vertex block
    and combines across the model axis), plus 0.1 x the mean squared betas,
    then SGD.  The batch (sequences) splits over ``data``: each block's
    weighted sums come back to the first device, where the loss is
    assembled.  Returns ``step(params, batch, lr=1e-2) -> (params, loss)``
    over dicts of tensors on the mesh's first device (``make_train_batch``)."""
    sm = model if mesh.size == 1 and _norm_device(model.device) == mesh.devices[0, 0] \
        else _shard_model_by_vertex(model, mesh)

    def block_sums(params, batch):
        pose = rot.rotation_6d_to_matrix(params["pose6d"])  # [B, F, 23, 3, 3]
        root = rot.rotation_6d_to_matrix(params["root6d"])  # [B, F, 1, 3, 3]
        B, F = params["trans"].shape[:2]
        betas = params["betas"][:, None].expand(B, F, NUM_BETAS)
        out = lbs_forward(sm, pose, betas, root, params["trans"])
        d2_min = min_over_vertices(batch["markers"], out["vertices"])  # [B, F, M]
        w = batch["weights"]
        return torch.stack([(d2_min * w).sum(), w.sum(), (params["betas"] ** 2).sum()])[None]

    def step(params, batch, lr: float = 1e-2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            sums = run_blocks(mesh, sm, block_sums, (p, batch)).sum(0)
            cham = sums[0] / torch.clamp_min(sums[1], 1e-12)
            reg = sums[2] / p["betas"].numel()
            loss = cham * 10.0 + reg * 0.1
            grads = torch.autograd.grad(loss, [p[k] for k in p])
        new = {k: (p[k] - lr * g).detach() for k, g in zip(p, grads)}
        return new, loss.detach()

    return step


def make_train_batch(model, batch: int, frames: int, markers: int, seed: int = 0):
    """Tiny example batch for dry runs, the reference's draws
    (``np.random.RandomState(seed)``) on the model's device."""
    rng = np.random.RandomState(seed)
    eye6 = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (batch, frames, 23, 1))
    root6 = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (batch, frames, 1, 1))
    dev = model.device

    def put(a):
        return torch.as_tensor(a, device=dev)

    params = {
        "pose6d": put(eye6 + rng.randn(*eye6.shape).astype(np.float32) * 0.01),
        "root6d": put(root6),
        "trans": put(rng.randn(batch, frames, 3).astype(np.float32) * 0.1),
        "betas": put(rng.randn(batch, 10).astype(np.float32) * 0.1),
    }
    data = {
        "markers": put(rng.randn(batch, frames, markers, 3).astype(np.float32)),
        "weights": put(np.ones((batch, frames, markers), np.float32)),
    }
    return params, data
