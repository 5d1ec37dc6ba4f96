"""The fleet generator against the port's numpy simulator (CPU)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from port_bench.gen import raycast, world  # noqa: E402
from mola_lidar_odometry_tpu_torch.utils import sim  # noqa: E402

RINGS, AZIMUTHS = 16, 256


@pytest.fixture(scope="module")
def traffic():
    return json.loads((ROOT / "port_bench" / "traffic" / "fleet64-drive.json").read_text())


@pytest.fixture(scope="module")
def town(traffic):
    return world.fleet(7, dict(traffic, instances=6))


@pytest.mark.parametrize("instance,frame", [(0, 0), (3, 20), (5, 49)])
def test_ray_cast_equals_the_numpy_simulator(traffic, town, instance, frame):
    """16 x 256 rays of one instance's scan, noise off: the torch ray cast
    hits what ``utils/sim.py::simulate_scan`` hits, at the same points."""
    wd, trajs, _ = town
    tr = trajs[instance]
    sensor = dict(traffic["sensor"], rings=RINGS, azimuths=AZIMUTHS)
    ref = sim.simulate_scan(sim.SimWorld(wd.centers, wd.half, wd.yaw, wd.ground_z), tr.R[frame], tr.t[frame],
                            tr.twists[frame], n_rings=RINGS, n_azimuth=AZIMUTHS, fov_up_deg=sensor["fov_up_deg"],
                            fov_down_deg=sensor["fov_down_deg"], spin_period=1.0 / sensor["rate_hz"],
                            max_range=sensor["max_range_m"], noise=0.0)
    got = raycast.cast(raycast.world_tensors(wd, "cpu"), *(torch.as_tensor(a[frame:frame + 1]) for a in
                                                            (tr.R, tr.t, tr.twists)), sensor,
                       raycast.sensor_grid(sensor, "cpu"))
    xyz, tm, ring, valid = (g[0].numpy() for g in got)
    assert valid.sum() > 0.5 * valid.size
    np.testing.assert_array_equal(valid, ref[3])
    np.testing.assert_allclose(xyz[valid], ref[0][valid], atol=1e-5)
    np.testing.assert_array_equal(tm, ref[1])
    np.testing.assert_array_equal(ring, ref[2])


def test_fleet_scans_compact_differ_and_repeat(traffic):
    """Valid points first in ray order; every instance steps its own scans;
    a seed gives the same scans again, another seed the same drives in
    another order, with other sensor noise."""
    small = dict(traffic, instances=3, frames=2)
    sensor = dict(traffic["sensor"], rings=8, azimuths=128)

    def scans(seed):
        wd, trajs, drives = world.fleet(seed, small)
        return raycast.fleet_scans(wd, trajs, sensor, world.noise_seeds(seed, small, drives), "cpu")[0], drives

    (a, da), (b, _), (c, dc) = scans(11), scans(11), scans(12)
    xyz, tm, ring, valid = a[1]
    n = valid.sum(1)
    for i in range(3):
        assert bool(valid[i, :n[i]].all()) and not bool(valid[i, n[i]:].any())
        assert bool((xyz[i, n[i]:] == 0).all())
        assert bool((ring[i, :n[i]][1:] >= ring[i, :n[i]][:-1]).all())  # ray order kept
    assert not torch.equal(xyz[0], xyz[1]) and not torch.equal(xyz[1], xyz[2])
    for u, v in zip(a, b):
        for p, q in zip(u, v):
            assert torch.equal(p, q)
    assert da != dc and sorted(da) == sorted(dc)
    for i, d in enumerate(da):
        j = dc.index(d)
        for k in range(2):
            (xa, ta, ra, va), (xc, tc, rc, vc) = a[k], c[k]
            for p, q in ((ta, tc), (ra, rc), (va, vc)):
                assert torch.equal(p[i], q[j])
            assert not torch.equal(xa[i], xc[j])
            torch.testing.assert_close(xa[i], xc[j], rtol=0.0, atol=0.1)


def test_paths_keep_their_clearances(traffic, town):
    """Every pose of every placed path stays inside the town and keeps the
    simulator's corridor clearances from buildings and clutter."""
    wd, trajs, _ = town
    inner = traffic["world"]["extent_m"] - traffic["world"]["path_margin_m"]
    nb, npl = wd.n_buildings, wd.n_plates
    for tr in trajs:
        xy = tr.t[:, :2]
        assert np.abs(xy).max() <= inner
        for sl, clearance in ((slice(0, nb), world.BUILDING_CLEARANCE), (slice(nb + npl, None),
                                                                         world.CLUTTER_CLEARANCE)):
            d = np.linalg.norm(xy[:, None] - wd.centers[sl, :2][None], axis=-1)
            assert d.min() > clearance - world.GRID_M
        assert np.linalg.norm(tr.t[-1] - tr.t[0]) > 20.0  # the drive covers ground


@pytest.mark.cuda
def test_ray_cast_on_the_card_equals_the_cpu(traffic, town):
    """The same scan cast on the card and on the CPU, noise off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wd, trajs, _ = town
    sensor = dict(traffic["sensor"])
    tr = trajs[0]
    args = [torch.as_tensor(a[10:12]) for a in (tr.R, tr.t, tr.twists)]
    cpu = raycast.cast(raycast.world_tensors(wd, "cpu"), *args, sensor, raycast.sensor_grid(sensor, "cpu"))
    gpu = raycast.cast(raycast.world_tensors(wd, "cuda"), *(a.cuda() for a in args), sensor,
                       raycast.sensor_grid(sensor, "cuda"))
    assert torch.equal(cpu[3], gpu[3].cpu())
    torch.testing.assert_close(cpu[0], gpu[0].cpu(), atol=1e-4, rtol=0)
