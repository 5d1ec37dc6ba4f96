"""Fixed-capacity masked point buffers, batched over the fleet dimension.

Port of ``mola_lidar_odometry_tpu/ops/pointcloud.py``.  Every channel carries
a leading fleet dimension ``B``: ``xyz (B, N, 3)``, the rest ``(B, N)``.
The JAX package's ``ops/batched_mem.py`` (flat rewrites of vmapped
gathers/scatters) folds into :func:`gather_rows`: with the batch dimension
written out, a per-instance row gather is one advanced-indexing op.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-instance row gather ``data[b, idx[b]]`` with out-of-range rows
    clamped (the JAX gather's default mode).

    data (B, V, ...), idx (B, ...) integer -> (B, ...idx dims, ...data dims).
    """
    B, V = data.shape[0], data.shape[1]
    idx = idx.long().clamp(0, V - 1)
    b = torch.arange(B, device=data.device).view((B,) + (1,) * (idx.dim() - 1))
    return data[b, idx]


class PointCloud(NamedTuple):
    """Padded point buffers with validity masks (capacity = xyz.shape[-2])."""

    xyz: torch.Tensor  # (B, N, 3) f32
    time: torch.Tensor  # (B, N) f32 — per-point relative timestamp [s]
    intensity: torch.Tensor  # (B, N) f32
    ring: torch.Tensor  # (B, N) i32
    valid: torch.Tensor  # (B, N) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)

    @staticmethod
    def empty(capacity: int, batch: int, device="cuda") -> "PointCloud":
        return PointCloud(
            xyz=torch.zeros((batch, capacity, 3), dtype=torch.float32, device=device),
            time=torch.zeros((batch, capacity), dtype=torch.float32, device=device),
            intensity=torch.zeros((batch, capacity), dtype=torch.float32, device=device),
            ring=torch.zeros((batch, capacity), dtype=torch.int32, device=device),
            valid=torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        )

    @staticmethod
    def from_xyz(xyz: torch.Tensor, time=None, intensity=None, ring=None, valid=None) -> "PointCloud":
        xyz = xyz.to(torch.float32)
        shape, dev = xyz.shape[:-1], xyz.device
        return PointCloud(
            xyz=xyz,
            time=torch.zeros(shape, dtype=torch.float32, device=dev) if time is None else time,
            intensity=(
                torch.zeros(shape, dtype=torch.float32, device=dev) if intensity is None else intensity
            ),
            ring=torch.zeros(shape, dtype=torch.int32, device=dev) if ring is None else ring,
            valid=torch.ones(shape, dtype=torch.bool, device=dev) if valid is None else valid,
        )

    def with_mask(self, keep: torch.Tensor) -> "PointCloud":
        return self._replace(valid=self.valid & keep)

    def bounding_radius(self) -> torch.Tensor:
        """(B,) max point norm over valid points (0 if empty)."""
        x, y, z = self.xyz.unbind(-1)
        r = torch.sqrt(x * x + y * y + z * z)
        return torch.amax(torch.where(self.valid, r, 0.0), dim=-1)

    def compact(self, capacity: int) -> "PointCloud":
        """Pack valid points into the prefix of a buffer of ``capacity``,
        keeping input order; points beyond ``capacity`` are dropped."""
        B, n = self.valid.shape
        dev = self.xyz.device
        score = torch.where(
            self.valid, n - torch.arange(n, dtype=torch.int32, device=dev), 0
        ).to(torch.int32)
        vals, idx = torch.topk(score, min(capacity, n), dim=-1, sorted=True)
        if capacity > n:
            pad = capacity - n
            vals = torch.nn.functional.pad(vals, (0, pad))
            idx = torch.nn.functional.pad(idx, (0, pad), value=n)
        in_range = vals > 0
        safe = torch.where(in_range, idx, 0)
        packed = torch.cat(
            [
                self.xyz,
                self.time[..., None],
                self.intensity[..., None],
                self.ring.to(torch.float32)[..., None],
                self.valid.to(torch.float32)[..., None],
            ],
            dim=-1,
        )  # (B, n, 7)
        g = torch.where(in_range[..., None], gather_rows(packed, safe), 0.0)
        return PointCloud(
            xyz=g[..., :3],
            time=g[..., 3],
            intensity=g[..., 4],
            ring=g[..., 5].to(torch.int32),
            valid=in_range & (g[..., 6] > 0),
        )


LayerDict = Dict[str, PointCloud]


def transform_cloud(R: torch.Tensor, t: torch.Tensor, pc: PointCloud) -> PointCloud:
    """Rigidly transform all points (valid mask unchanged); R (B,3,3), t (B,3)."""
    return pc._replace(xyz=torch.einsum("...ij,...nj->...ni", R, pc.xyz) + t[..., None, :])
