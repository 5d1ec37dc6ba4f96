"""Port parity for ``ops/solver.py``: the block Gauss-Newton solver and
Horn's closed form of mola_lidar_odometry_tpu_torch against the JAX package,
on seeded numpy pairings.  The port carries the fleet dimension B; the JAX
functions run once per instance.

Tolerance: 1e-5 on R and t (both solve the same float32 6x6 system; the
Gram sums run in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu.ops import se3 as jse3, solver as jsol
from mola_lidar_odometry_tpu.ops.se3 import Pose as JPose
from mola_lidar_odometry_tpu_torch.ops import solver as tsol
from mola_lidar_odometry_tpu_torch.ops.se3 import Pose as TPose

B, N = 3, 300
TOL = 1e-5


def _pairs(seed):
    """Local points, their images under a per-instance true pose plus noise,
    unit normals, validity, an entry pose off the answer and a prior."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    xi = rng.normal(0, 1, (B, 6)).astype(np.float32) * np.array([0.3, 0.3, 0.1, 0.02, 0.02, 0.05], np.float32)
    true = [jse3.se3_exp(jnp.asarray(x)) for x in xi]
    q = np.stack([np.asarray(jse3.transform(T, jnp.asarray(p[b]))) for b, T in enumerate(true)])
    q = (q + rng.normal(0, 0.02, q.shape)).astype(np.float32)
    q[:, ::7] += 3.0  # outliers for the robust kernel
    nrm = rng.normal(0, 1, (B, N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = rng.random((B, N)) > 0.2
    entry = [jse3.se3_exp(jnp.asarray(x * 0.7)) for x in xi]
    # The prior's mean is rotated well away from the answer: both packages'
    # float32 ``se3_log`` loses digits for relative rotations of 1e-3..3e-2
    # rad (``1 - cos`` cancels), where their results depend on the last bit
    # of ``cos`` and cannot be compared to 1e-5.
    far = np.array([0, 0, 0, 0.2, -0.15, 0.25], np.float32)
    prior = [jse3.se3_exp(jnp.asarray(x * 0.9 + far)) for x in xi]
    info = np.stack([np.diag([50.0, 50, 50, 400, 400, 400]).astype(np.float32)] * B)
    info[1] = 0.0  # instance 1 carries no prior
    return p, q, nrm, valid, entry, prior, info


def _tpose(poses):
    return TPose(
        torch.from_numpy(np.stack([np.asarray(P.R) for P in poses])),
        torch.from_numpy(np.stack([np.asarray(P.t) for P in poses])),
    )


@pytest.mark.parametrize(
    "kinds,with_prior,no_pairs",
    [
        (("p2p",), True, False), (("p2pl",), True, False), (("p2p", "p2pl"), True, False),
        (("p2p", "p2p"), False, False), (("p2p",), True, True), (("p2p", "p2pl"), False, True),
    ],
    ids=["p2p", "p2pl", "mixed", "two-p2p-no-prior", "no-pairs-prior", "no-pairs-no-prior"],
)
def test_gauss_newton_blocks_match_jax(kinds, with_prior, no_pairs):
    p, q, nrm, valid, entry, prior, info = _pairs(len(kinds) + 2 * with_prior)
    if not with_prior:
        info = np.zeros_like(info)
    if no_pairs:
        valid = np.zeros_like(valid)
    weights = (1.0, 0.5)
    kc = np.array([0.5, 1.0, 0.25], np.float32)  # per-instance kernel scale
    T = torch.from_numpy
    tblocks = [
        tsol.PairingBlock(k, T(p), T(np.roll(q, i, axis=1) if i else q), T(nrm), T(valid), weights[i])
        for i, k in enumerate(kinds)
    ]
    tpose, ttotal = tsol.solve_gauss_newton_blocks(
        _tpose(entry), tblocks, T(kc), tsol.PosePrior(_tpose(prior), T(info)), inner_iterations=2
    )

    @jax.jit
    def ref(p_, q_, n_, v_, eR, et, pR, pt, info_, kc_):
        blocks = [
            jsol.PairingBlock(k, p_, jnp.roll(q_, i, axis=0) if i else q_, n_, v_, weights[i])
            for i, k in enumerate(kinds)
        ]
        return jsol.solve_gauss_newton_blocks(
            JPose(eR, et), blocks, kc_, jsol.PosePrior(JPose(pR, pt), info_), inner_iterations=2
        )

    moved = 0.0
    for b in range(B):
        jpose, jtotal = ref(
            p[b], q[b], nrm[b], valid[b], entry[b].R, entry[b].t, prior[b].R, prior[b].t, info[b], kc[b]
        )
        np.testing.assert_allclose(tpose.R[b].numpy(), np.asarray(jpose.R), atol=TOL)
        np.testing.assert_allclose(tpose.t[b].numpy(), np.asarray(jpose.t), atol=TOL)
        np.testing.assert_allclose(ttotal[b].numpy(), np.asarray(jtotal), atol=TOL)
        moved = max(moved, float(np.abs(np.asarray(jtotal)).max()))
    if no_pairs and not with_prior:
        assert float(ttotal.abs().max()) == 0.0  # nothing to solve: the pose stays
    else:
        assert moved > 1e-3


@pytest.mark.parametrize("n_valid", [N, 40, 2, 0], ids=["all", "some", "two-pairs", "none"])
def test_solve_horn_matches_jax(n_valid):
    p, q, _, valid, *_ = _pairs(7)
    valid = valid.copy()
    valid[:, n_valid:] = False
    if n_valid == 2:
        valid[:] = False
        valid[:, [3, 11]] = True
    T = torch.from_numpy
    tpose = tsol.solve_horn(T(p), T(q), T(valid))
    ref = jax.jit(jsol.solve_horn)
    for b in range(B):
        jpose = ref(p[b], q[b], valid[b])
        np.testing.assert_allclose(tpose.R[b].numpy(), np.asarray(jpose.R), atol=TOL)
        np.testing.assert_allclose(tpose.t[b].numpy(), np.asarray(jpose.t), atol=TOL)
    if n_valid < 3:
        np.testing.assert_array_equal(tpose.R.numpy(), np.stack([np.eye(3, dtype=np.float32)] * B))
        assert float(tpose.t.abs().max()) == 0.0
    else:
        assert float(tpose.t.abs().max()) > 0.05
