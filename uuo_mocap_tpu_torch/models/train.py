"""Training loops for the neural models (counterpart of
``uuo_mocap_tpu/models/train.py``).

Every family trains on synthetic data from the body model: random smooth
motions, markers at surface vertices, their parts as labels.  The recipe is
the reference's: the same pools from the same numpy seeds, the same batch
shapes, losses and step counts, Adam (b1 0.9, b2 0.999, eps 1e-8) on
optax's cosine schedule for the pooled loops and at a constant rate for the
foot-contact loop, and flax's initialisation (LeCun-normal kernels, zero
biases, unit LayerNorm scales).

A pooled step is split in two: its *draws* (sequences, marker columns and
augmentations, from a ``torch.Generator`` on the pool's device) and its
*loss* on those draws, so the loss can be fed any draws.  The loops keep
the reference's count contract: ``inner = max(1, min(50, steps // 4))``,
``max(1, steps // inner)`` chunks of ``inner`` steps, and one history entry
per chunk (its last loss), read from the device once per chunk.  On the
card each pooled step runs as a CUDA graph, replayed once per step.

Every ``train_*`` runs on the body model's device and returns the trained
module(s) and the loss history; ``convert.to_flax`` and
``models.checkpoints.save_params`` write them as flax checkpoints.  Each
takes ``init``, a flax variables tree to start from instead of a fresh
initialisation.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as Fn

from uuo_mocap_tpu_torch import convert
from uuo_mocap_tpu_torch.body.model import BodyModel, lbs_forward
from uuo_mocap_tpu_torch.data.synthetic import random_pose_sequence
from uuo_mocap_tpu_torch.models.foot_contact_model import FootContactModel
from uuo_mocap_tpu_torch.models.marker_segmenter import WINDOW, MarkerSegmenter
from uuo_mocap_tpu_torch.models.marker_segmenter_multimodal import MarkerSegmenterMultimodal
from uuo_mocap_tpu_torch.models.motion_embedding import JointEmbedding, MarkerEmbedding
from uuo_mocap_tpu_torch.models.pos2bc import Pos2BC
from uuo_mocap_tpu_torch.models.pos_diff import PosDiff
from uuo_mocap_tpu_torch.pipeline.stages import SmplParams

Draws = Dict[str, torch.Tensor]
LAYOUT_COLUMNS = 41  # the pool's leading columns: the cmu_41 layout's vertices


# ------------------------------------------------------------------ data
def _lbs_markers(model: BodyModel, gts: Sequence[SmplParams], vid: np.ndarray):
    """The sequences' vertices at ``vid`` [B, M] and first 22 joints:
    -> (points [B, F, M, 3], joints [B, F, 22, 3])."""
    F = gts[0].trans.shape[0]
    with torch.no_grad():
        out = lbs_forward(model, torch.stack([g.pose_body for g in gts]),
                          torch.stack([g.betas.expand(F, 10) for g in gts]),
                          torch.stack([g.root_orient for g in gts]),
                          torch.stack([g.trans for g in gts]))
    ids = torch.as_tensor(vid, device=model.device)
    pts = torch.stack([v[:, i] for v, i in zip(out["vertices"], ids)])
    return pts, out["joints"][..., :22, :]


def _segmentation_batch(model: BodyModel, batch: int, num_markers: int, seed: int,
                        vertex_ids: Optional[np.ndarray] = None):
    """One batch of marker windows and part labels: WINDOW-frame random
    motions, markers at random surface vertices (or at ``vertex_ids``), each
    labelled with its vertex's argmax-LBS part.
    -> (points [B, W, M, 3], labels [B, M], joints [B, W, 22, 3])."""
    dev = model.device
    rng = np.random.RandomState(seed)
    vertex_labels = model.vertex_part_labels().cpu().numpy()
    gts = [random_pose_sequence(WINDOW, seed=seed * 1000 + b, yaw=rng.uniform(0, 6.28),
                                device=dev) for b in range(batch)]
    if vertex_ids is not None:
        vid = np.broadcast_to(np.asarray(vertex_ids), (batch, len(vertex_ids))).copy()
    else:
        vid = np.stack([rng.choice(model.num_vertices, num_markers, replace=False)
                        for _ in range(batch)])
    pts, jts = _lbs_markers(model, gts, vid)
    return pts, torch.as_tensor(vertex_labels[vid], device=dev), jts


class SegmentationPool(NamedTuple):
    points: torch.Tensor  # [P, W, K, 3]
    labels: torch.Tensor  # [P, K] part of each tracked vertex
    joints: torch.Tensor  # [P, W, 22, 3]


def segmentation_pool(model: BodyModel, n_seqs: int, verts_per_seq: int, seed: int,
                      chunk: int = 8) -> SegmentationPool:
    """``n_seqs`` WINDOW-frame motions, each with ``verts_per_seq`` tracked
    surface vertices: the cmu_41 layout's 41, then random ones.  The
    segmenter loops draw their batches from it on the device."""
    from uuo_mocap_tpu_torch.data.marker_layout import resolve_layout_vertex_ids

    dev = model.device
    rng = np.random.RandomState(seed)
    vertex_labels = model.vertex_part_labels().cpu().numpy()
    layout = resolve_layout_vertex_ids("cmu_41", model)
    pts, labels, jts = [], [], []
    for c0 in range(0, n_seqs, chunk):
        B = min(chunk, n_seqs - c0)
        gts = [random_pose_sequence(WINDOW, seed=seed * 100_003 + c0 + b,
                                    yaw=rng.uniform(0, 6.28), device=dev) for b in range(B)]
        vid = np.stack([np.concatenate([layout, rng.choice(
            model.num_vertices, verts_per_seq - len(layout), replace=False)]) for _ in range(B)])
        p, j = _lbs_markers(model, gts, vid)
        pts.append(p)
        jts.append(j)
        labels.append(torch.as_tensor(vertex_labels[vid], device=dev))
    return SegmentationPool(torch.cat(pts), torch.cat(labels), torch.cat(jts))


def _surface_samples(model: BodyModel, n: int, seed: int):
    """Random barycentric points on the template surface -> (points [n, 3],
    face vertex ids [n, 3], barycentric [n, 3]) on the model's device."""
    rng = np.random.RandomState(seed)
    faces = np.asarray(model.faces)
    v = model.v_template.detach().cpu().numpy()
    fidx = rng.randint(0, faces.shape[0], n)
    bary = rng.dirichlet((1.0, 1.0, 1.0), size=n).astype(np.float32)
    pts = np.einsum("nk,nkd->nd", bary, v[faces[fidx]])
    dev = model.device
    return (torch.as_tensor(pts, device=dev), torch.as_tensor(faces[fidx], device=dev),
            torch.as_tensor(bary, device=dev))


def _mesh_distance(model: BodyModel, points: torch.Tensor, key: str, chunk: int = 512):
    """``point_mesh_distance`` on the template, ``chunk`` points at a time."""
    from uuo_mocap_tpu_torch.ops.point_mesh import point_mesh_distance

    with torch.no_grad():
        return torch.cat([point_mesh_distance(points[c:c + chunk], model.v_template,
                                              model.faces)[key]
                          for c in range(0, points.shape[0], chunk)])


def pos_diff_pool(model: BodyModel, n: int, noise: float, seed: int,
                  chunk: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """(queries [n, 3], displacements to the nearest surface point [n, 3])
    for PosDiff: surface samples moved by Gaussian noise of ``noise``
    metres, labelled by the exact point-triangle projection."""
    pts, _, _ = _surface_samples(model, n, seed)
    rng = np.random.RandomState(seed ^ 0xA5A5)
    q = pts.cpu().numpy() + rng.randn(n, 3).astype(np.float32) * noise
    cp = _mesh_distance(model, torch.as_tensor(q, device=model.device), "closest_point", chunk)
    return q, cp.cpu().numpy() - q


def motion_embedding_pool(model: BodyModel, n_seqs: int, window: int, num_markers: int,
                          seed: int, chunk: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """One independent ``window``-frame motion per row (overlapping windows
    of one motion would make the InfoNCE targets ambiguous): markers at
    random vertices [P, W, M, 3] and joints [P, W, 22, 3]."""
    rng = np.random.RandomState(seed * 13 + 1)
    pts, jts = [], []
    for c0 in range(0, n_seqs, chunk):
        B = min(chunk, n_seqs - c0)
        gts = [random_pose_sequence(window, seed=seed * 100003 + c0 + b, device=model.device)
               for b in range(B)]
        vid = np.stack([rng.choice(model.num_vertices, num_markers, replace=False)
                        for _ in range(B)])
        p, j = _lbs_markers(model, gts, vid)
        pts.append(p)
        jts.append(j)
    return torch.cat(pts), torch.cat(jts)


def foot_contact_batch(model: BodyModel, i: int, batch: int, frames: int, seed: int):
    """The foot-contact loop's batch ``i``: joints [B, F, 22, 3] of fresh
    motions and the 3D heuristic's contact labels [B, F, 2], each motion's
    from its own floor height."""
    from uuo_mocap_tpu_torch.utils.foot_contact import compute_foot_contacts

    gts = [random_pose_sequence(frames, seed=seed * 19 + i * batch + b, device=model.device)
           for b in range(batch)]
    _, jts = _lbs_markers(model, gts, np.zeros((batch, 0), np.int64))
    labels = np.stack([compute_foot_contacts(j[None])[0] for j in jts.cpu().numpy()])
    return jts, torch.as_tensor(labels, dtype=torch.float32, device=model.device)


# -------------------------------------------------------- initialisation
_TRUNCATED_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def flax_init_(module: nn.Module, seed: int) -> nn.Module:
    """Initialise ``module``'s layers as flax does: Dense and Conv kernels
    LeCun normal (a normal truncated at 2 sigma, variance 1 / fan-in), zero
    biases, LayerNorm scales 1.  Drawn on the CPU from ``seed``, so the same
    seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    edge = math.erf(2 / math.sqrt(2))  # the truncation's CDF interval, as 2 u - 1
    for layer in module.modules():
        with torch.no_grad():
            if isinstance(layer, (nn.Linear, nn.Conv1d)):
                w = layer.weight
                std = math.sqrt(1.0 / w[0].numel()) / _TRUNCATED_STD
                u = torch.empty(w.shape).uniform_(-edge, edge, generator=gen)
                w.copy_((torch.erfinv(u) * (math.sqrt(2) * std)).clamp(-2 * std, 2 * std))
                layer.bias.zero_()
            elif isinstance(layer, nn.LayerNorm):
                layer.weight.fill_(1.0)
                layer.bias.zero_()
    return module


def _start(module: nn.Module, init: Optional[dict], seed: int, device) -> nn.Module:
    """``module`` with the ``init`` variables tree's weights, or flax's
    initialisation from ``seed``, on ``device``, trainable."""
    if init is not None:
        return convert.from_flax(module, init, device, trainable=True)
    return flax_init_(module, seed).to(device).train()


# -------------------------------------------------------------- optimizer
def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.05) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)``."""
    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


class Adam:
    """``optax.adam`` for ``steps`` steps: moments (1 - b) g + b m,
    bias-corrected by the step count after its increment, update
    m^ / (sqrt(v^) + eps) scaled by minus the rate; the rate is a float or
    a schedule read at the count before the increment, as optax reads it.
    The rates and corrections of every step are a table on the device,
    indexed by a device step counter, so a step launches no host read and
    can be captured in a CUDA graph."""

    def __init__(self, params: Sequence[torch.Tensor], lr, steps: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        rate = np.asarray([lr(c) if callable(lr) else lr for c in range(steps)], np.float32)
        count = np.arange(1, steps + 1, dtype=np.float32)
        # 1 - b^count in float32, as optax computes it (float32's 0.999 is
        # 0.999000013, which moves 1 - b2 by 1.3e-5 relative at count 1)
        table = np.stack([-rate, np.float32(1) - np.float32(b1) ** count,
                          np.float32(1) - np.float32(b2) ** count], axis=1)
        dev = self.params[0].device
        self.table = torch.as_tensor(table, device=dev)  # [steps, 3]
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        neg_lr, bc1, bc2 = self.table.index_select(0, self.t)[0].unbind()
        self.t += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, sq)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(update, neg_lr)
        torch._foreach_add_(self.params, update)


def _backward(params: Sequence[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
    for p in params:
        p.grad = None
    loss.backward()
    return loss.detach()


class _GraphedStep:
    """A training step on the card as a CUDA graph: the first WARMUP calls
    run eagerly on a side stream (as capture requires), the next is captured
    and every call from then on replays the graph, one launch for all the
    kernels that eager PyTorch issues at tens of microseconds of host time
    each (a segmenter step: 8.4-14.6 ms eager, 2.2 ms replayed on an H100).
    ``gen`` is registered with the graph, so each replay draws new numbers.
    Returns the step's output (the graph's own tensor once captured)."""

    WARMUP = 3

    def __init__(self, step: Callable[[], torch.Tensor], gen: torch.Generator):
        self.step, self.gen = step, gen
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None

    def __call__(self) -> torch.Tensor:
        if self.graph is None and self.calls < self.WARMUP:
            self.calls += 1
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self.step()
            torch.cuda.current_stream().wait_stream(side)
            return out
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(self.gen)
            with torch.cuda.graph(self.graph):
                self.out = self.step()
        self.graph.replay()
        return self.out


def chunking(steps: int) -> Tuple[int, int]:
    """(chunks, steps per chunk) of a pooled loop of ``steps`` steps."""
    inner = max(1, min(50, steps // 4))
    return max(1, steps // inner), inner


def _fit_pooled(params: Sequence[torch.Tensor],
                step_loss: Callable[[torch.Generator], torch.Tensor], steps: int, lr: float,
                seed: int, device) -> List[float]:
    """Adam on the cosine schedule over ``chunking(steps)``; ``step_loss``
    draws a batch from the generator and returns its loss.  On the card the
    step runs as a CUDA graph."""
    params = list(params)
    chunks, inner = chunking(steps)
    opt = Adam(params, cosine_decay(lr, max(steps, 1)), chunks * inner)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed * 2 + 1)

    def step() -> torch.Tensor:
        loss = _backward(params, step_loss(gen))
        opt.step()
        return loss

    run = _GraphedStep(step, gen) if device.type == "cuda" else step
    history: List[float] = []
    for _ in range(chunks):
        for _ in range(inner):
            loss = run()
        history.append(float(loss))
    return history


# ------------------------------------------------------ segmenter steps
def yaw_about_y(angle: torch.Tensor) -> torch.Tensor:
    """[...] -> [..., 3, 3] rotations about the model's up axis (y)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def segmenter_draws(gen: torch.Generator, pool: SegmentationPool, batch: int,
                    num_markers: int) -> Draws:
    """One step's draws: sequences [B], marker columns [B, M] (for half the
    batch, when M fits, the layout's first M columns), yaw angles [B] in
    [0, 6.2832), shifts [B, 1, 1, 3] in [-0.5, 0.5) and unit normal jitter
    [B, W, M, 3]."""
    P, W, K, _ = pool.points.shape
    dev = pool.points.device
    cols = torch.randint(K, (batch, num_markers), generator=gen, device=dev)
    draws = {"seq": torch.randint(P, (batch,), generator=gen, device=dev)}
    if num_markers <= min(LAYOUT_COLUMNS, K):
        use_layout = torch.rand((batch, 1), generator=gen, device=dev) < 0.5
        cols = torch.where(use_layout, torch.arange(num_markers, device=dev), cols)
    draws["cols"] = cols
    draws["yaw"] = torch.rand(batch, generator=gen, device=dev) * 6.2832
    draws["shift"] = torch.rand((batch, 1, 1, 3), generator=gen, device=dev) - 0.5
    draws["jitter"] = torch.randn((batch, W, num_markers, 3), generator=gen, device=dev)
    return draws


def segmenter_loss(net: nn.Module, pool: SegmentationPool, draws: Draws, multimodal: bool,
                   marker_noise: float = 0.002) -> torch.Tensor:
    """Mean softmax cross-entropy of the net's part logits on the drawn,
    rotated, shifted and jittered marker windows."""
    seq, cols = draws["seq"], draws["cols"]
    W = pool.points.shape[1]
    frames = torch.arange(W, device=seq.device)
    pts = pool.points[seq[:, None, None], frames[None, :, None], cols[:, None, :]]
    labels = pool.labels[seq[:, None], cols]
    R = yaw_about_y(draws["yaw"])
    pts = torch.einsum("bij,bwmj->bwmi", R, pts) + draws["shift"]
    jts = torch.einsum("bij,bwmj->bwmi", R, pool.joints[seq]) + draws["shift"]
    pts = pts + draws["jitter"] * marker_noise
    logits = net(pts, jts) if multimodal else net(pts)
    return Fn.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _train_segmenter(net: nn.Module, body: BodyModel, steps, batch, num_markers, lr, seed,
                     pool_seqs, verts_per_seq, multimodal):
    pool = segmentation_pool(body, pool_seqs, verts_per_seq, seed=seed + 41)
    hist = _fit_pooled(net.parameters(), lambda gen: segmenter_loss(
        net, pool, segmenter_draws(gen, pool, batch, num_markers), multimodal),
        steps, lr, seed, body.device)
    return net.eval(), hist


def train_marker_segmenter(
    body: BodyModel, steps: int = 200, batch: int = 8, num_markers: int = 41,
    lr: float = 1e-3, seed: int = 0, pool_seqs: int = 192, verts_per_seq: int = 512,
    latent_dim: int = 128, init: Optional[dict] = None,
) -> Tuple[MarkerSegmenter, List[float]]:
    net = _start(MarkerSegmenter(latent_dim), init, seed, body.device)
    return _train_segmenter(net, body, steps, batch, num_markers, lr, seed, pool_seqs,
                            verts_per_seq, multimodal=False)


def train_marker_segmenter_multimodal(
    body: BodyModel, steps: int = 200, batch: int = 8, num_markers: int = 41,
    lr: float = 1e-3, seed: int = 0, pool_seqs: int = 192, verts_per_seq: int = 512,
    latent_dim: int = 128, init: Optional[dict] = None,
) -> Tuple[MarkerSegmenterMultimodal, List[float]]:
    net = _start(MarkerSegmenterMultimodal(latent_dim), init, seed, body.device)
    return _train_segmenter(net, body, steps, batch, num_markers, lr, seed, pool_seqs,
                            verts_per_seq, multimodal=True)


# --------------------------------------------------- surface-map steps
def index_draws(gen: torch.Generator, n: int, batch: int) -> torch.Tensor:
    """``batch`` pool rows drawn with replacement."""
    return torch.randint(n, (batch,), generator=gen, device=gen.device)


def pos2bc_loss(net: nn.Module, pool, idx: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy against the barycentric mass on each sample's
    three face vertices (the soft target's other entries are 0)."""
    pts, face_vids, bary = (t[idx] for t in pool)
    logp = torch.log_softmax(net(pts), dim=-1)
    return -(bary * logp.gather(1, face_vids.long())).sum(dim=-1).mean()


def pos_diff_loss(net: nn.Module, pool, idx: torch.Tensor) -> torch.Tensor:
    q, tgt = pool
    return ((net(q[idx]) - tgt[idx]) ** 2).mean()


def train_pos2bc(body: BodyModel, steps: int = 300, batch: int = 512, lr: float = 1e-3,
                 seed: int = 0, pool_n: int = 65536, init: Optional[dict] = None
                 ) -> Tuple[Pos2BC, List[float]]:
    net = _start(Pos2BC(num_vertices=body.num_vertices), init, seed, body.device)
    pool = _surface_samples(body, pool_n, seed * 104729 + 7)
    hist = _fit_pooled(net.parameters(), lambda gen: pos2bc_loss(
        net, pool, index_draws(gen, pool_n, batch)), steps, lr, seed, body.device)
    return net.eval(), hist


def train_pos_diff(body: BodyModel, steps: int = 300, batch: int = 512, lr: float = 1e-3,
                   noise: float = 0.05, seed: int = 0, pool_n: int = 4096,
                   init: Optional[dict] = None) -> Tuple[PosDiff, List[float]]:
    net = _start(PosDiff(), init, seed, body.device)
    q, tgt = pos_diff_pool(body, pool_n, noise, seed * 15485863 + 7)
    pool = (torch.as_tensor(q, device=body.device), torch.as_tensor(tgt, device=body.device))
    hist = _fit_pooled(net.parameters(), lambda gen: pos_diff_loss(
        net, pool, index_draws(gen, pool_n, batch)), steps, lr, seed, body.device)
    return net.eval(), hist


# ------------------------------------------------ motion embedding steps
def permutation_draws(gen: torch.Generator, n: int, batch: int) -> torch.Tensor:
    """``batch`` distinct pool rows: a duplicated row would be its own
    positive pair twice and poison the InfoNCE labels."""
    return torch.randperm(n, generator=gen, device=gen.device)[:batch]


def info_nce_loss(m_net: nn.Module, j_net: nn.Module, pool, idx: torch.Tensor,
                  temperature: float = 0.1) -> torch.Tensor:
    """Symmetric InfoNCE between the marker and joint windows of the drawn
    rows (row b's pair is the positive of both)."""
    pts, jts = pool
    logits = m_net(pts[idx]) @ j_net(jts[idx]).T / temperature
    labels = torch.arange(idx.shape[0], device=idx.device)
    return (Fn.cross_entropy(logits, labels) + Fn.cross_entropy(logits.T, labels)) / 2


def train_motion_embedding(
    body: BodyModel, steps: int = 200, batch: int = 16, window: int = 16,
    num_markers: int = 41, lr: float = 1e-3, seed: int = 0, temperature: float = 0.1,
    pool_seqs: int = 96, init: Optional[Tuple[dict, dict]] = None,
) -> Tuple[Tuple[MarkerEmbedding, JointEmbedding], List[float]]:
    """InfoNCE between marker windows and joint windows of the same motion.
    ``init``: the (markers, joints) variables trees.  Both nets start from
    the same seed, so from the same weights, as in the reference."""
    pool = motion_embedding_pool(body, pool_seqs, window, num_markers, seed)
    m_net = _start(MarkerEmbedding(), init and init[0], seed, body.device)
    j_net = _start(JointEmbedding(), init and init[1], seed, body.device)
    params = list(m_net.parameters()) + list(j_net.parameters())
    hist = _fit_pooled(params, lambda gen: info_nce_loss(
        m_net, j_net, pool, permutation_draws(gen, pool_seqs, batch), temperature),
        steps, lr, seed, body.device)
    return (m_net.eval(), j_net.eval()), hist


# --------------------------------------------------- foot contact steps
def foot_contact_loss(net: nn.Module, jts: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of the contact logits."""
    return Fn.binary_cross_entropy_with_logits(net(jts), labels)


def train_foot_contact(
    body: BodyModel, steps: int = 200, batch: int = 8, frames: int = 64,
    lr: float = 1e-3, seed: int = 0, init: Optional[dict] = None,
) -> Tuple[FootContactModel, List[float]]:
    """Constant-rate Adam against the 3D heuristic's labels on fresh
    motions each step; one history entry per step, read once at the end."""
    net = _start(FootContactModel(), init, seed, body.device)
    params = list(net.parameters())
    opt = Adam(params, lr, steps)
    losses = []
    for i in range(steps):
        jts, labels = foot_contact_batch(body, i, batch, frames, seed)
        losses.append(_backward(params, foot_contact_loss(net, jts, labels)))
        opt.step()
    return net.eval(), torch.stack(losses).tolist() if losses else []
