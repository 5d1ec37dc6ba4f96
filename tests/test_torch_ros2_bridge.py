"""The port's BridgeROS2 (``apps/ros2_bridge.py``) executed under a stubbed
rclpy: the cases of ``tests/test_ros2_bridge.py`` (and the runtime's
gated case of ``tests/test_runtime.py``) on the port, with a copy of that
test's fake ROS 2 python stack (rclpy / *_msgs / sensor_msgs_py / tf2_ros
injected into ``sys.modules``).  The map payload comes from a port map
(one instance, on the CPU here) in one host copy, and equals the JAX
bridge's payload for the same points."""

import sys
import types

import numpy as np
import pytest
import torch

POINTS = np.array([[0.2, 0.2, 0.2], [3.4, 1.2, 0.5], [-2.0, 4.0, 1.0]], np.float32)


class _Auto:
    """Attribute-tree message stub: any dotted path materializes."""

    def __getattr__(self, name):
        v = _Auto()
        object.__setattr__(self, name, v)
        return v


class _FakeTimer:
    def __init__(self, period, cb):
        self.period, self.cb = period, cb


class _FakePublisher:
    def __init__(self, msg_type, topic):
        self.msg_type, self.topic, self.published = msg_type, topic, []

    def publish(self, msg):
        self.published.append(msg)


class _FakeClockMsg:
    sec, nanosec = 7, 0


class _FakeNode:
    def __init__(self, name):
        self.name = name
        self.subs = {}  # topic -> (msg_type, cb)
        self.pubs = {}  # topic -> _FakePublisher
        self.timers = []

    def create_subscription(self, msg_type, topic, cb, depth):
        self.subs[topic] = (msg_type, cb)

    def create_publisher(self, msg_type, topic, depth):
        p = _FakePublisher(msg_type, topic)
        self.pubs[topic] = p
        return p

    def create_timer(self, period, cb):
        t = _FakeTimer(period, cb)
        self.timers.append(t)
        return t

    def get_clock(self):
        clk = types.SimpleNamespace()
        clk.now = lambda: types.SimpleNamespace(to_msg=lambda: _FakeClockMsg())
        return clk


class _FakeTFBroadcaster:
    def __init__(self, node):
        self.sent = []

    def sendTransform(self, t):
        self.sent.append(t)


def _install_fake_ros(monkeypatch):
    """Build the minimal module graph the bridge imports."""
    node_holder = {}

    rclpy = types.ModuleType("rclpy")
    rclpy_node = types.ModuleType("rclpy.node")

    def _node_factory(name):
        n = _FakeNode(name)
        node_holder["node"] = n
        return n

    rclpy_node.Node = _node_factory
    rclpy.node = rclpy_node
    rclpy.spin = lambda node: node_holder.setdefault("spun", True)

    geometry = types.ModuleType("geometry_msgs.msg")
    geometry.TransformStamped = _Auto
    geometry_pkg = types.ModuleType("geometry_msgs")
    geometry_pkg.msg = geometry

    nav = types.ModuleType("nav_msgs.msg")
    nav.Odometry = _Auto
    nav_pkg = types.ModuleType("nav_msgs")
    nav_pkg.msg = nav

    sensor = types.ModuleType("sensor_msgs.msg")
    sensor.PointCloud2 = type("PointCloud2", (), {})
    sensor.NavSatFix = type("NavSatFix", (), {})
    sensor_pkg = types.ModuleType("sensor_msgs")
    sensor_pkg.msg = sensor

    std = types.ModuleType("std_msgs.msg")
    std.Header = _Auto
    std_pkg = types.ModuleType("std_msgs")
    std_pkg.msg = std

    pc2 = types.ModuleType("sensor_msgs_py.point_cloud2")
    pc2.read_points_numpy = lambda msg, field_names, skip_nans: msg._xyz

    def create_cloud_xyz32(header, xyz):
        out = types.SimpleNamespace(header=header, xyz=np.asarray(xyz))
        return out

    pc2.create_cloud_xyz32 = create_cloud_xyz32
    smp_pkg = types.ModuleType("sensor_msgs_py")
    smp_pkg.point_cloud2 = pc2

    tf2 = types.ModuleType("tf2_ros")
    tf2.TransformBroadcaster = _FakeTFBroadcaster

    for name, mod in {
        "rclpy": rclpy,
        "rclpy.node": rclpy_node,
        "geometry_msgs": geometry_pkg,
        "geometry_msgs.msg": geometry,
        "nav_msgs": nav_pkg,
        "nav_msgs.msg": nav,
        "sensor_msgs": sensor_pkg,
        "sensor_msgs.msg": sensor,
        "std_msgs": std_pkg,
        "std_msgs.msg": std,
        "sensor_msgs_py": smp_pkg,
        "sensor_msgs_py.point_cloud2": pc2,
        "tf2_ros": tf2,
    }.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return node_holder


class _FakeRuntime:
    """Just enough of AsyncLidarOdometry: records observations, exposes lo."""

    def __init__(self, lo):
        self.lo = lo
        self.observations = []

    def on_new_observation(self, obs):
        self.observations.append(obs)


class _FakeLO:
    """Odometry facade for the publish paths: trajectory + a real port map
    of one instance."""

    def __init__(self):
        from mola_lidar_odometry_tpu_torch.ops import voxel_hash as vh
        from mola_lidar_odometry_tpu_torch.ops.pointcloud import PointCloud

        m = vh.VoxelHashMap.create(1 << 8, 4, 1.0, 1, "cpu")
        m, _ = vh.insert_stats(m, PointCloud.from_xyz(torch.from_numpy(POINTS)[None]))
        self.device = torch.device("cpu")
        self.carry = types.SimpleNamespace(maps={"localmap": m}, pose_t=torch.zeros((1, 3)))
        self.trajectory = [{"stamp": 1.0, "t": np.array([1.0, 2.0, 3.0]), "quat_xyzw": np.array([0.0, 0.0, 0.0, 1.0])}]


class _FakeJaxLO:
    """The JAX package's facade over the same points (for the payload)."""

    def __init__(self):
        import jax.numpy as jnp

        from mola_lidar_odometry_tpu.ops import voxel_hash as vh
        from mola_lidar_odometry_tpu.ops.pointcloud import PointCloud

        m = vh.insert(vh.VoxelHashMap.create(1 << 8, 4, 1.0), PointCloud.from_xyz(jnp.asarray(POINTS)))
        self.carry = types.SimpleNamespace(maps={"localmap": m}, pose_t=jnp.zeros(3, jnp.float32))
        self.trajectory = _FakeLO().trajectory


CFG = {
    "base_link_frame": "base_link",
    "odom_frame": "odom",
    "publish_odometry_msgs_from_slam": True,
    "period_publish_new_localization": 0.1,
    "period_publish_new_map": 3.0,
    "subscribe": [
        {"topic": "/ouster/points", "msg_type": "PointCloud2", "output_sensor_label": "lidar"},
        {"topic": "/gps", "msg_type": "NavSatFix", "output_sensor_label": "gps"},
    ],
}


@pytest.fixture()
def bridge(monkeypatch):
    holder = _install_fake_ros(monkeypatch)
    from mola_lidar_odometry_tpu_torch.apps.ros2_bridge import BridgeROS2

    rt = _FakeRuntime(_FakeLO())
    b = BridgeROS2(rt, CFG, device="cpu")
    return b, rt, holder["node"]


def test_subscriptions_and_publishers_created(bridge):
    b, rt, node = bridge
    assert set(node.subs) == {"/ouster/points", "/gps"}
    assert set(node.pubs) == {"/odometry", "/local_map"}
    assert sorted(t.period for t in node.timers) == [0.1, 3.0]


def test_pointcloud2_subscription_feeds_runtime(bridge):
    b, rt, node = bridge
    _, cb = node.subs["/ouster/points"]
    msg = types.SimpleNamespace(
        _xyz=np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32),
        header=types.SimpleNamespace(stamp=types.SimpleNamespace(sec=12, nanosec=500_000_000)),
    )
    cb(msg)
    assert len(rt.observations) == 1
    obs = rt.observations[0]
    assert obs.kind == "lidar" and obs.label == "lidar"
    assert obs.stamp == pytest.approx(12.5)
    np.testing.assert_allclose(obs.data["xyz"], msg._xyz)


def test_navsatfix_subscription_feeds_runtime(bridge):
    b, rt, node = bridge
    _, cb = node.subs["/gps"]
    msg = types.SimpleNamespace(latitude=40.0, longitude=-3.0, altitude=600.0,
                                header=types.SimpleNamespace(stamp=types.SimpleNamespace(sec=100, nanosec=0)))
    cb(msg)
    obs = rt.observations[0]
    assert obs.kind == "gnss"
    assert obs.data == {"lat": 40.0, "lon": -3.0, "alt": 600.0}


def test_localization_publish_tf_and_odometry(bridge):
    b, rt, node = bridge
    [t for t in node.timers if t.period == 0.1][0].cb()
    assert len(b.tf.sent) == 1  # /tf: odom -> base_link with the trajectory tail pose
    t = b.tf.sent[0]
    assert t.header.frame_id == "odom" and t.child_frame_id == "base_link"
    assert (t.transform.translation.x, t.transform.translation.y, t.transform.translation.z) == (1.0, 2.0, 3.0)
    assert t.transform.rotation.w == 1.0
    om = node.pubs["/odometry"].published[0]  # /odometry mirrors the same pose
    assert (om.pose.pose.position.x, om.pose.pose.position.y, om.pose.pose.position.z) == (1.0, 2.0, 3.0)


def test_map_publish_payload_equals_jax(monkeypatch, bridge):
    b, rt, node = bridge
    [t for t in node.timers if t.period == 3.0][0].cb()
    pubs = node.pubs["/local_map"].published
    assert len(pubs) == 1
    cloud = pubs[0]
    assert cloud.header.frame_id == "odom"
    assert cloud.xyz.shape == (3, 3) and cloud.xyz.dtype == np.float32
    # 3 stored points, dequantized to ~mm of the inserted positions
    np.testing.assert_allclose(np.sort(cloud.xyz, axis=0), np.sort(POINTS, axis=0), atol=2e-3)
    from mola_lidar_odometry_tpu.apps.ros2_bridge import BridgeROS2 as JBridge

    jrt = _FakeRuntime(_FakeJaxLO())
    jb = JBridge(jrt, CFG)
    [t for t in jb.node.timers if t.period == 3.0][0].cb()
    np.testing.assert_array_equal(cloud.xyz, jb.map_pub.published[0].xyz)


def test_empty_trajectory_publish_is_noop(bridge):
    b, rt, node = bridge
    rt.lo.trajectory = []
    [t for t in node.timers if t.period == 0.1][0].cb()
    assert not b.tf.sent
    assert not node.pubs["/odometry"].published


def test_import_error_without_rclpy():
    from mola_lidar_odometry_tpu_torch.apps.ros2_bridge import BridgeROS2

    if "rclpy" in sys.modules:  # pragma: no cover - env guard
        pytest.skip("real rclpy present")
    with pytest.raises(ImportError, match="ROS 2 python stack"):
        BridgeROS2(_FakeRuntime(_FakeLO()), CFG, device="cpu")


def test_bridge_needs_a_card_unless_told_cpu(monkeypatch):
    """The bridge's device defaults to the card: without one it raises; a
    runtime whose odometry runs elsewhere than ``device`` is refused."""
    _install_fake_ros(monkeypatch)
    from mola_lidar_odometry_tpu_torch.apps.ros2_bridge import BridgeROS2

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            BridgeROS2(_FakeRuntime(_FakeLO()), CFG)
    else:
        with pytest.raises(ValueError, match="runs on cpu"):
            BridgeROS2(_FakeRuntime(_FakeLO()), CFG)
