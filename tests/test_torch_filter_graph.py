"""Port parity: the filter graphs (``models/filter_graph.py``) of the
lidar3d-intensity, lidar3d-edges and rgbd pipelines against the JAX
package's, compiled by both from the YAML and run on the scans of
``test_torch_filters_other.py``; unknown classes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mola_lidar_odometry_tpu_torch.ops import filters as tf
from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud as TPC
from test_torch_filters_other import CAP, HERE, clouds  # noqa: F401 (the fixture)


@pytest.mark.parametrize("rel", ["extras/lidar3d-intensity.yaml", "extras/lidar3d-edges.yaml", "rgbd.yaml"])
def test_filter_graph_of_the_pipeline_matches_jax(clouds, rel):
    """The pipeline's filter passes and generators, compiled by both
    packages from the YAML, leave the same layers (masks bit for bit)."""
    from mola_lidar_odometry_tpu.models import filter_graph as jfg, spec as jspec
    from mola_lidar_odometry_tpu.utils.config import load_yaml_file as jload
    from mola_lidar_odometry_tpu_torch.models import filter_graph as tfg, spec as tspec
    from mola_lidar_odometry_tpu_torch.utils.config import load_yaml_file as tload

    path = os.path.join(HERE, "..", "pipelines", rel)
    caps = dict(raw_capacity=CAP, layer_capacities={"raw": CAP})
    js = jspec.spec_from_yaml(jload(path, env={}), **caps)
    ts = tspec.spec_from_yaml(tload(path, env={}), **caps)
    ts_pipes = [ts.generator_pipeline, ts.adjust_pipeline, ts.filter1, ts.filter2]
    js_pipes = [js.generator_pipeline, js.adjust_pipeline, js.filter1, js.filter2]
    assert [type(op).__name__ for p in ts_pipes for op in p] == [type(op).__name__ for p in js_pipes for op in p]
    tpc, jpcs = clouds
    env_vals = dict(vx=1.0, vy=0.0, vz=0.0, wx=0.0, wy=0.0, wz=0.1, ESTIMATED_SENSOR_MAX_RANGE=40.0,
                    INSTANTANEOUS_SENSOR_MAX_RANGE=40.0, SENSOR_TIME_OFFSET=0.0, ADAPTIVE_THRESHOLD_SIGMA=1.0)
    tenv = {k: torch.full((2,), v) for k, v in env_vals.items()}
    tl = {"raw": tpc}
    for p in ts_pipes:
        tl = tfg.apply_pipeline(p, tl, tenv)
    for b, jpc in enumerate(jpcs):
        def run(raw):
            layers = {"raw": raw}
            for p in js_pipes:
                layers = jfg.apply_pipeline(p, layers, {k: jnp.float32(v) for k, v in env_vals.items()})
            return layers

        jl = jax.jit(run)(jpc)
        assert sorted(tl) == sorted(jl)
        for name in jl:
            np.testing.assert_array_equal(tl[name].valid[b].numpy(), np.asarray(jl[name].valid), err_msg=name)
            np.testing.assert_allclose(tl[name].xyz[b].numpy(), np.asarray(jl[name].xyz), atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(tl[name].intensity[b].numpy(), np.asarray(jl[name].intensity))
    assert min(int(pc.valid.sum()) for pc in tl.values()) > 0


def test_unknown_filter_and_generator_classes_raise():
    from mola_lidar_odometry_tpu_torch.models import filter_graph as tfg

    with pytest.raises(ValueError, match="Unsupported filter class"):
        tfg.build_pipeline([{"class_name": "mp2p_icp_filters::FilterNope", "params": {}}], {})
    with pytest.raises(ValueError, match="Unsupported generator class"):
        tfg.build_generator_pipeline([{"class_name": "mp2p_icp_filters::GeneratorNope"}])
    with pytest.raises(ValueError, match="Unknown decimate method"):
        tf.decimate_voxels(TPC.empty(8, 1, device="cpu"), 1.0, 8, method="Nope")
