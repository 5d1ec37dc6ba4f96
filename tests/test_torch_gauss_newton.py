"""Port parity of the single pairing-set Gauss-Newton (``ops/solver.py``'s
``gauss_newton_step`` and ``solve_gauss_newton``), mirroring
``tests/test_icp.py``'s ``TestSolver`` (the Geman-McClure weight, a
transform recovered from exact pairings, a pose pulled to the prior mean
without pairings) on both packages.  The port carries the fleet dimension
B = 2 (the second instance sees the pairings of the first mirrored); the
JAX functions run once per instance.  Tolerance 1e-5 on R and t, as
``test_torch_solver.py``: both solve the same float32 6x6 system with the
Gram sums in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import se3 as jse3, solver as jsol
from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
from mola_lidar_odometry_tpu_torch.ops import se3 as tse3, solver as tsol
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose as TPose

from test_icp import structured_world

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gm_weight():
    w = tsol.geman_mcclure_weight(torch.tensor([0.0, 1.0, 100.0]), 1.0)
    np.testing.assert_allclose(w.numpy(), [1.0, 0.25, (1 / 101) ** 2], rtol=1e-5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jsol.geman_mcclure_weight(jnp.asarray([0.0, 1.0, 100.0]), 1.0)))


@pytest.mark.parametrize("case", ["recovers_transform", "prior_only"])
def test_gauss_newton_matches_jax(case):
    xi = np.array([[0.1, -0.05, 0.02, 0.01, -0.02, 0.03], [-0.2, 0.1, 0.0, 0.0, 0.02, -0.04]], np.float32)
    if case == "recovers_transform":
        pts = structured_world(600)
        j_true = [jse3.se3_exp(jnp.asarray(x)) for x in xi]
        local = np.stack([np.asarray(jse3.transform(jse3.inverse(T), jnp.asarray(pts))) for T in j_true])
        glob = np.stack([pts, pts])
        valid = np.ones(local.shape[:2], bool)
        j_prior = [jsol.PosePrior.none()] * 2
        t_prior = tsol.PosePrior.none(2, "cpu")
        steps, inner, want = 5, 2, j_true
    else:  # no pairings: the pose moves to the prior mean
        xi = np.array([[0.5, 0, 0, 0, 0, 0.1], [-0.3, 0.2, 0, 0, 0, -0.05]], np.float32)
        local = glob = np.zeros((2, 4, 3), np.float32)
        valid = np.zeros((2, 4), bool)
        want = [jse3.se3_exp(jnp.asarray(x)) for x in xi]
        j_prior = [jsol.PosePrior(T, jnp.eye(6, dtype=jnp.float32) * 10.0) for T in want]
        mean = tse3.se3_exp(torch.from_numpy(xi))
        t_prior = tsol.PosePrior(mean, torch.eye(6).expand(2, 6, 6) * 10.0)
        steps, inner = 8, 1

    t_pose = TPose.identity((2,), device="cpu")
    for _ in range(steps):
        t_pose, t_eps = tsol.solve_gauss_newton(t_pose, torch.from_numpy(local), torch.from_numpy(glob),
                                                torch.from_numpy(valid), 1.0, t_prior, inner)
    for b in range(2):
        j_pose = JPose.identity()
        for _ in range(steps):
            j_pose, j_eps = jsol.solve_gauss_newton(j_pose, jnp.asarray(local[b]), jnp.asarray(glob[b]),
                                                    jnp.asarray(valid[b]), 1.0, j_prior[b], inner)
        np.testing.assert_allclose(t_pose.R[b].numpy(), np.asarray(j_pose.R), atol=TOL)
        np.testing.assert_allclose(t_pose.t[b].numpy(), np.asarray(j_pose.t), atol=TOL)
        np.testing.assert_allclose(t_eps[b].numpy(), np.asarray(j_eps), atol=TOL)
        dt, dr = jse3.pose_error_norms(JPose(jnp.asarray(t_pose.R[b].numpy()), jnp.asarray(t_pose.t[b].numpy())),
                                       want[b])
        assert float(dt) < 1e-4 and float(dr) < 1e-4

    # one step, no prior and no pairings: the pose stays (the guard)
    still, eps = tsol.gauss_newton_step(t_pose, torch.zeros((2, 4, 3)), torch.zeros((2, 4, 3)),
                                        torch.zeros((2, 4), dtype=torch.bool), 1.0, tsol.PosePrior.none(2, "cpu"))
    assert torch.equal(eps, torch.zeros((2, 6))) and torch.equal(still.t, t_pose.t)
