"""Traversal helpers shared by every acceleration structure (the
reference's ops/traverse.py; only `hit_normal` is ported so far -- the
octree walk waits in ROADMAP Queue 1 #11)."""

from __future__ import annotations

import torch


def hit_normal(n_major: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """Face normal from the major axis + ray sign (getHitN). n_major:
    int [R] (1: x, 2: y, 0: z), rd: f32 [R, 3] -> f32 [R, 3]."""
    s = torch.where(0.0 < rd, -1.0, 1.0).to(rd.dtype)
    zero = torch.zeros_like(s[:, 0])
    nx = torch.where(n_major == 1, s[:, 0], zero)
    ny = torch.where(n_major == 2, s[:, 1], zero)
    nz = torch.where(n_major == 0, s[:, 2], zero)
    return torch.stack([nx, ny, nz], dim=-1)
