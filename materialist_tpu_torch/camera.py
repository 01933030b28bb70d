"""Pinhole camera of the fixed-view G-buffer renderer.

Counterpart of ``materialist_tpu/camera.py``; the convention is the same:

    camera at origin, looking along world -z, +y up;
    pixel (row v, col u) at distance t:
        P(v,u;t) = t * ((u + .5 - cx)/f, -(v + .5 - cy)/f, -1)
    projection of world p (p.z < 0):
        u = cx + f * p.x / (-p.z) - .5,   v = cy - f * p.y / (-p.z) - .5
"""

from __future__ import annotations

import dataclasses
import math

import torch

from materialist_tpu_torch import config


def sqrt(x):
    """Correctly rounded square root, the one rule of the port's roots.

    The card's root rounds correctly, as numpy's and XLA's do, and runs
    as it is. torch's CPU float32 root can miss by one ulp, which GGX
    sampling's ``sqrt(1 - cos²)`` magnifies: there the root is taken in
    float64 and rounded back to ``x``'s dtype. Autograd goes through the
    casts; on the card ``.to`` of the same dtype is the tensor itself.
    """
    return torch.sqrt(x if x.is_cuda else x.double()).to(x.dtype)


def norm(v, keepdim: bool = True):
    """Euclidean norm over the last axis as sqrt(Σ v²)."""
    return sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


@dataclasses.dataclass(frozen=True)
class Camera:
    height: int = config.IMAGE_SIZE
    width: int = config.IMAGE_SIZE
    fov_deg: float = config.FOV_DEG

    @property
    def focal(self) -> float:
        return 0.5 * self.width / math.tan(0.5 * math.radians(self.fov_deg))

    @property
    def cx(self) -> float:
        return 0.5 * self.width

    @property
    def cy(self) -> float:
        return 0.5 * self.height

    def pixel_dirs(self, device=None) -> torch.Tensor:
        """Unnormalized per-pixel view ray directions, (H, W, 3)."""
        v = torch.arange(self.height, dtype=torch.float32, device=device) + 0.5
        u = torch.arange(self.width, dtype=torch.float32, device=device) + 0.5
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        x = (uu - self.cx) / self.focal
        y = -(vv - self.cy) / self.focal
        return torch.stack([x, y, -torch.ones_like(x)], dim=-1)

    def unproject(self, depth: torch.Tensor) -> torch.Tensor:
        """Depth (H, W) or (H, W, 1) → world positions (H, W, 3)."""
        if depth.ndim == 3:
            depth = depth[..., 0]
        return self.pixel_dirs(depth.device) * depth[..., None]

    def project(self, p: torch.Tensor) -> torch.Tensor:
        """World points (..., 3) → continuous pixel coords (..., 2) (u, v)."""
        inv_z = 1.0 / torch.clamp_min(-p[..., 2], 1e-6)
        u = self.cx + self.focal * p[..., 0] * inv_z - 0.5
        v = self.cy - self.focal * p[..., 1] * inv_z - 0.5
        return torch.stack([u, v], dim=-1)


def normals_from_depth(positions: torch.Tensor) -> torch.Tensor:
    """Geometric normals of the position map (H, W, 3): central
    differences with edge padding, cross product, oriented to the camera."""
    p = positions.permute(2, 0, 1)[None]
    ppad = torch.nn.functional.pad(p, (1, 1, 1, 1), mode="replicate")[0]
    ppad = ppad.permute(1, 2, 0)
    dx = ppad[1:-1, 2:] - ppad[1:-1, :-2]
    dy = ppad[2:, 1:-1] - ppad[:-2, 1:-1]
    n = torch.linalg.cross(dy, dx)
    n = n / torch.clamp_min(norm(n), 1e-12)
    flip = torch.sum(n * -positions, dim=-1, keepdim=True) < 0.0
    return torch.where(flip, -n, n)
