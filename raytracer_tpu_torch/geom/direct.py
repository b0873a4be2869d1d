"""Direct intersection helpers the split scene prep needs (port of the
parts of ``raytracer_tpu/geom/direct.py`` on this path).

Conventions: only INNER counts as a hit; plane-family INNER requires
n.dir > 0 (src/shapes/plane.hpp:51).
"""

from __future__ import annotations

import functools

import torch

# "No hit" distance; a Python float so kernels and plain versions share it.
INF = 1e30


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as CUDA's sqrtf computes it.
    PyTorch's vectorised CPU sqrt is not correctly rounded (about 0.5% of
    inputs land one ulp off), and a near-tangent sphere hit turns one ulp
    into a visible difference. The f64 root of an f32, rounded to f32, is
    correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def div_rn(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b by IEEE division. (On CUDA, PyTorch divides by a Python
    scalar by multiplying with its reciprocal, which can be an ulp off.)"""
    return a / torch.full_like(a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def reflect(incident, normal):
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N."""
    return incident - 2.0 * _dot(normal, incident)[..., None] * normal


@functools.lru_cache(maxsize=None)
def _up(device: torch.device) -> torch.Tensor:
    """(0, 1, 0) on ``device``, made once: a host-to-device copy per call
    would wait for the card (the per-step table refresh calls this)."""
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)


def wall_basis(normal: torch.Tensor, eps: float = 1e-20):
    """In-plane basis of Wall::get_intersection (src/shapes/wall.hpp:52-55):
    u = normalize(cross(n, (0,1,0))), v = normalize(cross(n, u)).

    Reference quirk: for n parallel to (0,1,0) the cross product is zero,
    normalize() gives NaN, every bounds comparison fails and the wall acts
    as an INFINITE plane. Reproduced without NaNs: a ``degenerate`` mask
    plus a zero basis, and callers treat degenerate walls as all-inside
    (scene 1's floor wall relies on this)."""
    up = _up(normal.device)
    u_raw = torch.linalg.cross(normal, torch.broadcast_to(up, normal.shape),
                               dim=-1)
    len2 = _dot(u_raw, u_raw)
    degenerate = len2 < eps
    inv = 1.0 / torch.sqrt(torch.where(degenerate, 1.0, len2))
    u = u_raw * inv[..., None]
    v_raw = torch.linalg.cross(normal, u, dim=-1)
    vlen2 = _dot(v_raw, v_raw)
    vinv = 1.0 / torch.sqrt(torch.where(vlen2 < eps, 1.0, vlen2))
    v = v_raw * vinv[..., None]
    return u, v, degenerate
