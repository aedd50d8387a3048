"""Lane-batched L-BFGS of the PyTorch port against the JAX ``BatchedLbfgs``
and against ``torch.optim.LBFGS(line_search_fn="strong_wolfe")``.

Inputs are made with numpy from a seed and fed to both sides.  Tolerance:
iterates within 1e-4 after 20 iterations — both sides run float32 on the
CPU, and the only difference is the order of the reductions in dot
products and losses, which L-BFGS amplifies only mildly over 20 steps."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uuo_mocap_tpu.solver.lbfgs import BatchedLbfgs as JaxBatchedLbfgs
from uuo_mocap_tpu.solver.lbfgs import LbfgsOptions as JaxLbfgsOptions
from uuo_mocap_tpu_torch.solver.lbfgs import BatchedLbfgs, LbfgsOptions

RNG = np.random.RandomState(21)
ITERS = 20
TOL = 1e-4


def _rosen_jax(p, lane, shared):
    x = p["x"] * lane["scale"]
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_torch(p, lane, shared):
    x = p["x"] * lane["scale"]
    return (100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1 - x[:, :-1]) ** 2).sum(-1)


def _quad_jax(p, lane, shared):
    r = p["x"] - lane["target"]
    return jnp.sum(r * (lane["diag"] * r)) + 0.01 * jnp.sum(p["x"] ** 4) + shared["bias"]


def _quad_torch(p, lane, shared):
    r = p["x"] - lane["target"]
    return (r * (lane["diag"] * r)).sum(-1) + 0.01 * (p["x"] ** 4).sum(-1) + shared["bias"]


def _run_both(fun_jax, fun_torch, x0, lane, shared, lr=1.0):
    jax_solver = JaxBatchedLbfgs(fun_jax, JaxLbfgsOptions(max_iter=ITERS, lr=lr), segment_size=7)
    pj, rj = jax_solver.run({"x": jnp.asarray(x0)}, {k: jnp.asarray(v) for k, v in lane.items()},
                            {k: jnp.asarray(v) for k, v in shared.items()})
    solver = BatchedLbfgs(fun_torch, LbfgsOptions(max_iter=ITERS, lr=lr))
    pt, rt = solver.run({"x": torch.as_tensor(x0)}, {k: torch.as_tensor(v) for k, v in lane.items()},
                        {k: torch.as_tensor(v) for k, v in shared.items()})
    return (np.asarray(pj["x"]), np.asarray(rj.num_evals), np.asarray(rj.num_iters),
            pt["x"].numpy(), rt.num_evals.numpy(), rt.num_iters.numpy(), solver)


def test_rosenbrock_lanes_match_jax():
    L, n = 4, 6
    x0 = (RNG.randn(L, n) * 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * RNG.rand(L, n)).astype(np.float32)
    xj, ej, ij, xt, et, it, solver = _run_both(_rosen_jax, _rosen_torch, x0, {"scale": scale}, {})
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(xt, xj, atol=TOL)
    assert solver.last_run_stats["lane_evals"] == int(ej.sum())


# On a near-quadratic objective the line search's cubic fit cancels
# catastrophically, and the reference's own evaluation counts change when x0
# moves by 1e-6 relative on many instances.  These two instances are ones
# where the reference is stable under that perturbation, so equal counts
# are a fair requirement there.
@pytest.mark.parametrize("n, dmax, lr", [(6, 30.0, 1.0), (12, 5.0, 0.1)])
def test_quadratic_lanes_match_jax(n, dmax, lr):
    rng = np.random.RandomState(1)
    L = 5
    x0 = (0.5 * rng.randn(L, n)).astype(np.float32)
    lane = {"target": rng.randn(L, n).astype(np.float32),
            "diag": (0.5 + dmax * rng.rand(L, n)).astype(np.float32)}
    xj, ej, ij, xt, et, it, _ = _run_both(_quad_jax, _quad_torch, x0, lane,
                                          {"bias": np.float32(0.25)}, lr=lr)
    # (iteration counts may differ by the final zero-step iteration at the
    # float32 floor, where no evaluation happens)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_allclose(xt, xj, atol=TOL)


def test_finished_lanes_freeze():
    """A lane that converges at once keeps its state and its counters."""
    L, n = 3, 4
    lane = {"target": RNG.randn(L, n).astype(np.float32),
            "diag": np.ones((L, n), np.float32)}
    x0 = RNG.randn(L, n).astype(np.float32)
    x0[1] = lane["target"][1] * 0.0  # lane 1 starts at a point with zero gradient
    lane["target"][1] = 0.0
    solver = BatchedLbfgs(lambda p, ln, sh: ((p["x"] - ln["target"]) ** 2).sum(-1),
                          LbfgsOptions(max_iter=ITERS))
    p, res = solver.run({"x": torch.as_tensor(x0)}, {k: torch.as_tensor(v) for k, v in lane.items()}, {})
    assert int(res.num_iters[1]) == 0 and int(res.num_evals[1]) == 1
    np.testing.assert_array_equal(p["x"][1].numpy(), x0[1])
    assert int(res.num_iters[0]) > 0


def test_single_lane_matches_torch_optim_lbfgs():
    n = 5
    x0 = (RNG.randn(n) * 0.5).astype(np.float32)
    x = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.LBFGS([x], max_iter=ITERS, lr=1.0, history_size=10, tolerance_grad=1e-7,
                            tolerance_change=1e-9, line_search_fn="strong_wolfe")
    ones = torch.ones(1, n)

    def closure():
        opt.zero_grad()
        loss = _rosen_torch({"x": x[None]}, {"scale": ones}, {})[0]
        loss.backward()
        return loss

    opt.step(closure)
    solver = BatchedLbfgs(_rosen_torch, LbfgsOptions(max_iter=ITERS))
    p, _ = solver.run({"x": torch.as_tensor(x0)[None]}, {"scale": ones}, {})
    np.testing.assert_allclose(p["x"][0].numpy(), x.detach().numpy(), atol=TOL)
