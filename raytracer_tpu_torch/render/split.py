"""The split-phase closest-hit query and the production ``render()`` (port
of ``raytracer_tpu/render/pallas_split.py``).

Why the split is exact: a shape CONTAINED in its BVH leaf box (spheres,
triangles, finite walls) renders identically under any acceleration
structure, so triangles run a lean walk over a triangle-only tree whose
shape is a pure performance choice, and the few non-triangles are tested
brute force per ray, with the reference tree's leaf box as the gate of
the plane family (the infinite floor wall is visible only inside it).

``closest_hit`` is the wrapper of the CUDA kernel ``closest_hit_kernel``
(csrc/raytrace.cu), which replaces the TPU kernel ``_split_kernel`` /
``_split_body`` (pallas_split.py:961-964, 343-651). On a CPU tensor it
runs ``closest_hit_plain``, the same function in PyTorch tensor ops.
``closest_pass_plain`` is the plain version of the per-ray walk the CUDA
kernels share (``_closest_pass``, pallas_split.py:654-902).

The per-bounce route (``whitted.trace``) adds two kernels: ``fused_shadow``
wraps ``fused_kernel`` (``_fused_kernel``, pallas_split.py:905-958: the
closest hit and the shadow ray in one launch) and ``resolve`` wraps
``resolve_kernel`` (``_resolve_kernel``, pallas_split.py:978-1033: the
shading attributes of a hit). Their plain versions are ``fused_plain`` and
``resolve_plain``. ``closest_hit_attrs`` wraps ``closest_attrs_kernel``
(``_split_kernel_attrs``, pallas_split.py:967-975: the closest hit with
the 11 shading attributes of the winning shape), which the per-bounce
route takes with ``USE_KERNEL_ATTRS``; its plain version is
``closest_hit_attrs_plain``.

``render(differentiable=True)`` takes the per-bounce route with the
closest hit of ``diff.kernel_vjp.make_differentiable_closest``: kernel 2
decides the hits, and t is re-derived in autograd from the scene.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytracer_tpu_torch.config import TRI_GRAM, TRI_MT, RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom.direct import INF, div_rn, sqrt_rn
from raytracer_tpu_torch.render import kernels, shading, whitted
from raytracer_tpu_torch.render.whitted import (ATTR_PAD_W, PARK_ORIGIN,
                                                _PARK_DIR as PARK_DIR)
from raytracer_tpu_torch.render.split_scene import (
    G_B0X, G_GID, G_MCR, G_MSH, G_RID, T_CV, T_CW, T_E1X, T_E2X, T_EVX,
    T_EWX, T_GID, T_MCR, T_MSH, T_NX, T_P1X, T_PD, T_R00, T_R01, T_R11,
    T_RID, T_S0, T_S1, SplitScene, prepare)

# Rays per pass of the plain walk: bounds its (rays x leaf size) temporaries.
PLAIN_CHUNK = 32768

N_ATTRS = 11   # n(3), color(3), ka, kd, ks, kf, shininess

# Take the closest hit with its shading attributes from
# closest_attrs_kernel on the per-bounce route (no fused and no resolve
# launch; kernel 2 answers the shadow rays), as the JAX package's switch
# of the same name does. Off by default, as there.
USE_KERNEL_ATTRS = False


class Rays(NamedTuple):
    """Ray components, each (R,) f32, with 1/d and d.d precomputed as the
    kernels do at the start of a walk."""
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ix: torch.Tensor
    iy: torch.Tensor
    iz: torch.Tensor
    aa: torch.Tensor

    @staticmethod
    def make(ox, oy, oz, dx, dy, dz) -> "Rays":
        return Rays(ox, oy, oz, dx, dy, dz, 1.0 / dx, 1.0 / dy, 1.0 / dz,
                    dx * dx + dy * dy + dz * dz)

    def take(self, idx) -> "Rays":
        return Rays(*(x[idx] for x in self))

    def col(self) -> "Rays":
        """(R, 1) views, to broadcast against (1, C) table columns."""
        return Rays(*(x[:, None] for x in self))


def _slab(b, r: Rays):
    """Slab test against boxes b[..., 0:6] (min xyz, max xyz); NaN-
    propagating min/max like the kernels."""
    tx0 = (b[..., 0] - r.ox) * r.ix
    tx1 = (b[..., 3] - r.ox) * r.ix
    ty0 = (b[..., 1] - r.oy) * r.iy
    ty1 = (b[..., 4] - r.oy) * r.iy
    tz0 = (b[..., 2] - r.oz) * r.iz
    tz1 = (b[..., 5] - r.oz) * r.iz
    tmin = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                       torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1))
    tmax = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                       torch.maximum(ty0, ty1)),
                         torch.maximum(tz0, tz1))
    return tmin, tmax


def _pre_sphere(p, r: Rays):
    """p: (1, C, PRE_W) sphere rows; r: (L, 1) rays -> t, inner (L, C)."""
    ocx = r.ox - p[..., 1]
    ocy = r.oy - p[..., 2]
    ocz = r.oz - p[..., 3]
    rad = p[..., 4]
    bb = 2.0 * (r.dx * ocx + r.dy * ocy + r.dz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = bb * bb - 4.0 * r.aa * cc
    sq = sqrt_rn(torch.where(disc > 0, disc, 1.0))
    t = (-bb - sq) / (2.0 * r.aa)
    return t, (disc > 0) & (t > 0)


def _pre_planewall(p, r: Rays):
    """p: (1, C, PRE_W) plane/wall rows -> t, inner (L, C); includes the
    reference leaf-box gate."""
    nx, ny, nz = p[..., 5], p[..., 6], p[..., 7]
    d_n = r.dx * nx + r.dy * ny + r.dz * nz
    o_n = r.ox * nx + r.oy * ny + r.oz * nz
    t = -(p[..., 8] + o_n) / torch.where(d_n == 0, 1.0, d_n)
    v_pl = (d_n > 0) & (t > 0)
    tw = torch.where(v_pl, t, 0.0)
    hx = r.ox + tw * r.dx
    hy = r.oy + tw * r.dy
    hz = r.oz + tw * r.dz
    u = hx * p[..., 9] + hy * p[..., 10] + hz * p[..., 11] - p[..., 18]
    v = hx * p[..., 12] + hy * p[..., 13] + hz * p[..., 14] - p[..., 19]
    outside = (u < 0) | (u > p[..., 20]) | (v < 0) | (v > p[..., 21])
    tmin, tmax = _slab(p[..., G_B0X:G_B0X + 6], r)
    gate = (tmax >= tmin) & (tmax > 0)
    return t, v_pl & ((p[..., 23] > 0) | ~outside) & gate


def _tri_test(p, r: Rays, tri_mode: int):
    """p: (1, C, TRI_W) triangle rows -> t, inner (L, C)."""
    if tri_mode == TRI_MT:
        e1x, e1y, e1z = p[..., T_E1X], p[..., T_E1X + 1], p[..., T_E1X + 2]
        e2x, e2y, e2z = p[..., T_E2X], p[..., T_E2X + 1], p[..., T_E2X + 2]
        hcx = r.dy * e2z - r.dz * e2y
        hcy = r.dz * e2x - r.dx * e2z
        hcz = r.dx * e2y - r.dy * e2x
        a = e1x * hcx + e1y * hcy + e1z * hcz
        ok = torch.abs(a) >= 1e-5
        f = 1.0 / torch.where(ok, a, 1.0)
        smx = r.ox - p[..., T_P1X]
        smy = r.oy - p[..., T_P1X + 1]
        smz = r.oz - p[..., T_P1X + 2]
        u = f * (smx * hcx + smy * hcy + smz * hcz)
        ok = ok & (u >= 0) & (u <= 1)
        qx = smy * e1z - smz * e1y
        qy = smz * e1x - smx * e1z
        qz = smx * e1y - smy * e1x
        v = f * (r.dx * qx + r.dy * qy + r.dz * qz)
        ok = ok & (v >= 0) & (u + v <= 1)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        return t, ok & (t > 0)
    nx, ny, nz = p[..., T_NX], p[..., T_NX + 1], p[..., T_NX + 2]
    d_n = r.dx * nx + r.dy * ny + r.dz * nz
    o_n = r.ox * nx + r.oy * ny + r.oz * nz
    t = -(p[..., T_PD] + o_n) / torch.where(d_n == 0, 1.0, d_n)
    inner = (d_n > 0) & (t > 0)
    if tri_mode == TRI_GRAM:
        evx, evy, evz = p[..., T_EVX], p[..., T_EVX + 1], p[..., T_EVX + 2]
        ewx, ewy, ewz = p[..., T_EWX], p[..., T_EWX + 1], p[..., T_EWX + 2]
        d_ev = r.dx * evx + r.dy * evy + r.dz * evz
        o_ev = r.ox * evx + r.oy * evy + r.oz * evz - p[..., T_CV]
        v = o_ev + t * d_ev
        d_ew = r.dx * ewx + r.dy * ewy + r.dz * ewz
        o_ew = r.ox * ewx + r.oy * ewy + r.oz * ewz - p[..., T_CW]
        w = o_ew + t * d_ew
        return t, inner & (v >= 0) & (w >= 0) & ((v + w) <= 1.0)
    tw = torch.where(inner, t, 0.0)
    hx = r.ox + tw * r.dx
    hy = r.oy + tw * r.dy
    hz = r.oz + tw * r.dz
    d20 = (hx * p[..., T_E1X] + hy * p[..., T_E1X + 1]
           + hz * p[..., T_E1X + 2] - p[..., T_S0])
    d21 = (hx * p[..., T_E2X] + hy * p[..., T_E2X + 1]
           + hz * p[..., T_E2X + 2] - p[..., T_S1])
    v = p[..., T_R11] * d20 - p[..., T_R01] * d21
    w = p[..., T_R00] * d21 - p[..., T_R01] * d20
    u = 1.0 - v - w
    return t, inner & ~((u < 0) | (v < 0) | (w < 0))


def _pre_tests(split: SplitScene, r: Rays):
    """All n_other pre-pass tests, (L, n_other) t and inner, rows in
    table order (spheres first)."""
    pre = split.pre_rows[None, :split.n_other]
    rc = r.col()
    parts = []
    if split.n_sph:
        parts.append(_pre_sphere(pre[:, :split.n_sph], rc))
    if split.n_other > split.n_sph:
        parts.append(_pre_planewall(pre[:, split.n_sph:], rc))
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def _tree(split: SplitScene):
    """Host copies of the skip-pointer tree (m is small)."""
    m = split.m
    return (split.leaf_start[:m].tolist(), split.leaf_count[:m].tolist(),
            split.skip[:m].tolist())


def _walk_closest(split, r: Rays, t, gid, nrm, tri_mode, tri_col):
    """The skip-pointer walk for every ray at once. Rays walk the nodes in
    DFS order, so visiting node n = 0..m-1 once, each with the rays whose
    pointer is n, replays every ray's own walk. Within a leaf, the first
    minimum of the candidates against a strict t < t_best equals the
    kernels' sequential strict-< fold."""
    starts, counts, skips = _tree(split)
    nxt = torch.zeros_like(t, dtype=torch.int64)
    for n in range(split.m):
        sel = torch.nonzero(nxt == n).squeeze(1)
        if sel.numel() == 0:
            continue
        rs = r.take(sel)
        tmin, tmax = _slab(split.nodes[n], rs)
        probe = (tmax >= tmin) & (tmax > 0) & (tmin <= t[sel])
        if counts[n] > 0:
            hit_sel = sel[probe]
            if hit_sel.numel():
                rows = split.tri_rows[starts[n]:starts[n] + counts[n]]
                tt, inner = _tri_test(rows[None], r.take(hit_sel).col(),
                                      tri_mode)
                cand = torch.where(inner, tt, INF)
                j = torch.argmin(cand, dim=1)
                cmin = cand.gather(1, j[:, None]).squeeze(1)
                better = cmin < t[hit_sel]
                upd = hit_sel[better]
                row = rows[j[better]]
                t[upd] = cmin[better]
                gid[upd] = row[:, tri_col]
                if nrm is not None:
                    nrm[upd] = row[:, _TRI_ATTR_COLS[:nrm.shape[1]]]
            nxt[sel] = skips[n]
        else:
            nxt[sel] = torch.where(probe, n + 1, skips[n])


# Attribute columns of the winning row: normal, then colour, ka, kd, ks,
# kf, shininess (the first 3 are the normal alone).
_TRI_ATTR_COLS = [T_NX, T_NX + 1, T_NX + 2] + list(range(T_MCR, T_MSH + 1))
_PRE_MAT_COLS = list(range(G_MCR, G_MSH + 1))


def closest_pass_plain(split: SplitScene, o, d, *, tri_mode: int,
                       rid: bool = False, with_normals: bool = False,
                       with_attrs: bool = False,
                       t_init: Optional[torch.Tensor] = None):
    """Plain version of the per-ray walk (``_closest_pass``): o, d are
    tuples of three (R,) tensors. Returns (t, id, normal (R, 3)) with id
    a float shape id (the canonical resolve id with ``rid``), -1 on miss.
    With ``with_attrs`` the third result is (R, N_ATTRS): the normal and
    the material columns of the winning row, zero on a miss. ``t_init``
    (default INF) turns it into the shadow walk."""
    ox, oy, oz = o
    t = torch.full_like(ox, INF) if t_init is None else t_init.clone()
    gid = torch.full_like(ox, -1.0)
    with_normals = with_normals or with_attrs
    nrm = torch.zeros(ox.shape + (N_ATTRS if with_attrs else 3,),
                      dtype=ox.dtype, device=ox.device)
    live = torch.nonzero(ox < 1e30).squeeze(1)   # parked lanes miss
    for c0 in range(0, live.numel(), PLAIN_CHUNK):
        idx = live[c0:c0 + PLAIN_CHUNK]
        r = Rays.make(*(x[idx] for x in (*o, *d)))
        tc, gc, nc = t[idx], gid[idx], nrm[idx]
        if split.n_other:
            tp, inner = _pre_tests(split, r)
            cand = torch.where(inner, tp, INF)
            bi = torch.argmin(cand, dim=1)
            best = cand.gather(1, bi[:, None]).squeeze(1)
            better = best < tc
            rows = split.pre_rows[bi]
            gc = torch.where(better, rows[:, G_RID if rid else G_GID], gc)
            if with_normals:
                px = r.ox + best * r.dx - rows[:, 1]
                py = r.oy + best * r.dy - rows[:, 2]
                pz = r.oz + best * r.dz - rows[:, 3]
                inv = 1.0 / sqrt_rn(px * px + py * py + pz * pz + 1e-30)
                sph = torch.stack([px * inv, py * inv, pz * inv], 1)
                n_pre = torch.where((bi < split.n_sph)[:, None], sph,
                                    rows[:, 5:8])
                if with_attrs:
                    n_pre = torch.cat([n_pre, rows[:, _PRE_MAT_COLS]], 1)
                nc = torch.where(better[:, None], n_pre, nc)
            tc = torch.where(better, best, tc)
        _walk_closest(split, r, tc, gc, nc if with_normals else None,
                      tri_mode, T_RID if rid else T_GID)
        t[idx], gid[idx], nrm[idx] = tc, gc, nc
    return t, gid, nrm


def occluded_plain(split: SplitScene, o, d, limit, *, tri_mode: int):
    """Plain version of the occlusion query (``_split_body`` occlusion
    mode): True where some inner hit has t < limit."""
    ox = o[0]
    occ = torch.zeros_like(ox, dtype=torch.bool)
    live = torch.nonzero(ox < 1e30).squeeze(1)
    starts, counts, skips = _tree(split)
    for c0 in range(0, live.numel(), PLAIN_CHUNK):
        idx = live[c0:c0 + PLAIN_CHUNK]
        r = Rays.make(*(x[idx] for x in (*o, *d)))
        lim = limit[idx]
        oc = torch.zeros_like(lim, dtype=torch.bool)
        if split.n_other:
            tp, inner = _pre_tests(split, r)
            oc = (inner & (tp < lim[:, None])).any(1)
        nxt = torch.where(oc, split.m, 0)
        for n in range(split.m):
            sel = torch.nonzero(nxt == n).squeeze(1)
            if sel.numel() == 0:
                continue
            rs = r.take(sel)
            tmin, tmax = _slab(split.nodes[n], rs)
            probe = (tmax >= tmin) & (tmax > 0) & (tmin <= lim[sel])
            if counts[n] > 0:
                hit_sel = sel[probe]
                if hit_sel.numel():
                    rows = split.tri_rows[starts[n]:starts[n] + counts[n]]
                    tt, inner = _tri_test(rows[None],
                                          r.take(hit_sel).col(), tri_mode)
                    oc[hit_sel] = (inner & (tt < lim[hit_sel, None])).any(1)
                nxt[sel] = torch.where(oc[sel], split.m, skips[n])
            else:
                nxt[sel] = torch.where(probe, n + 1, skips[n])
        occ[idx] = oc
    return occ


def closest_hit_plain(split: SplitScene, o: torch.Tensor, d: torch.Tensor,
                      tri_mode: int, max_t: Optional[torch.Tensor] = None):
    """Plain version of ``closest_hit_kernel``: o, d (R, 3) f32. Closest
    mode returns (t, gid int32, -1 on miss); occlusion mode (``max_t``
    given) returns t = 0 where occluded, else INF, and gid = -1."""
    oc = (o[:, 0], o[:, 1], o[:, 2])
    dc = (d[:, 0], d[:, 1], d[:, 2])
    if max_t is not None:
        occ = occluded_plain(split, oc, dc, max_t, tri_mode=tri_mode)
        t = torch.where(occ, 0.0, INF).to(torch.float32)
        return t, torch.full_like(t, -1, dtype=torch.int32)
    t, gid, _ = closest_pass_plain(split, oc, dc, tri_mode=tri_mode)
    return t, gid.to(torch.int32)


def closest_hit(split: SplitScene, o: torch.Tensor, d: torch.Tensor,
                tri_mode: int, max_t: Optional[torch.Tensor] = None,
                stats: Optional[torch.Tensor] = None):
    """Closest hit (or occlusion, with ``max_t``) of R rays o, d (R, 3) f32.

    On a CUDA tensor this launches ``closest_hit_kernel`` on the current
    stream; on a CPU tensor it runs ``closest_hit_plain``. ``stats``, an
    int64 (5,) tensor on the card, receives the counts of pre-pass, node
    and triangle tests and the warps' node steps and row steps of the
    lockstep walk."""
    dev = o.device
    if dev.type == "cpu":
        return closest_hit_plain(split, o, d, tri_mode, max_t)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {dev}")
    n = o.shape[0]
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    if max_t is not None:
        kernels.check_tensor("max_t", max_t, torch.float32, dev, (n,))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (5,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return t, gid
    args = kernels.table_args(split, dev)
    kernels.launch(
        "closest_hit_kernel", "rt_closest_hit", dev, *args, o.data_ptr(),
        d.data_ptr(), None if max_t is None else max_t.data_ptr(), n,
        t.data_ptr(), gid.data_ptr(), int(max_t is not None), tri_mode,
        None if stats is None else stats.data_ptr())
    closest_hit.launches += 1
    return t, gid


closest_hit.launches = 0


def fused_plain(split: SplitScene, o: torch.Tensor, d: torch.Tensor,
                light_pos: torch.Tensor, tri_mode: int, shadow_eps: float):
    """Plain version of ``fused_kernel``: o, d (R, 3) f32, light_pos (3,).
    Returns (t, gid int32 (-1 on miss), in_shadow bool) with the formulas
    of pallas_split.py:929-958: the shadow ray leaves p + n * shadow_eps
    toward the light and is walked with t_init = limit; a miss parks it
    with limit 0, so it is unshadowed."""
    oc = (o[:, 0], o[:, 1], o[:, 2])
    dc = (d[:, 0], d[:, 1], d[:, 2])
    t, gid, n = closest_pass_plain(split, oc, dc, tri_mode=tri_mode,
                                   with_normals=True)
    hit = t < INF
    ts = torch.where(hit, t, 0.0)
    p = [oi + ts * di for oi, di in zip(oc, dc)]
    ld = [light_pos[k] - p[k] for k in range(3)]
    dist = sqrt_rn(ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2])
    inv = 1.0 / torch.clamp_min(dist, 1e-30)
    so = tuple(torch.where(hit, p[k] + n[:, k] * shadow_eps, PARK_ORIGIN)
               for k in range(3))
    sd = tuple(torch.where(hit, ld[k] * inv, PARK_DIR) for k in range(3))
    limit = torch.where(hit, dist, 0.0)
    st, _, _ = closest_pass_plain(split, so, sd, tri_mode=tri_mode,
                                  t_init=limit)
    return t, gid.to(torch.int32), st < limit


def fused(split: SplitScene, o: torch.Tensor, d: torch.Tensor,
          light_pos: torch.Tensor, tri_mode: int, shadow_eps: float,
          stats: Optional[torch.Tensor] = None):
    """Closest hit and shadow answer of R rays o, d (R, 3) f32 toward the
    light at light_pos (3,): (t, gid int32, in_shadow bool). On a CUDA
    tensor this launches ``fused_kernel``; on a CPU tensor it runs
    ``fused_plain``. ``stats`` as for ``closest_hit``: the tests of both
    legs (the shadow leg's an any-hit walk) and both walks' warp steps."""
    dev = o.device
    if dev.type == "cpu":
        return fused_plain(split, o, d, light_pos, tri_mode, shadow_eps)
    if dev.type != "cuda":
        raise ValueError(f"fused: unsupported device {dev}")
    n = o.shape[0]
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    kernels.check_tensor("light_pos", light_pos, torch.float32, dev, (3,))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (5,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    in_shadow = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return t, gid, in_shadow
    kernels.launch(
        "fused_kernel", "rt_fused", dev, *kernels.table_args(split, dev),
        o.data_ptr(), d.data_ptr(), light_pos.data_ptr(), n, shadow_eps,
        t.data_ptr(), gid.data_ptr(), in_shadow.data_ptr(), tri_mode,
        None if stats is None else stats.data_ptr())
    fused.launches += 1
    return t, gid, in_shadow


fused.launches = 0


def _attrs(out: torch.Tensor):
    """(n, color, ka, kd, ks, kf, shininess) from the (11, R) rows."""
    return (out[0:3].t(), out[3:6].t(), out[6], out[7], out[8], out[9],
            out[10])


def resolve_plain(attr_tab: torch.Tensor, gid: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """Plain version of ``resolve_kernel``: the (11, R) attribute rows of
    row max(gid, 0) of attr_tab (clamped to the table; its first 15
    columns, so the padded copy gives the same) at hit points p (R, 3).
    The sphere normal is rel / sqrt(|rel|^2 + 1e-30), correctly rounded,
    blended with the plane-family normal by is_sphere."""
    si = gid.clamp_min(0.0).to(torch.int64).clamp_max(attr_tab.shape[0] - 1)
    row = attr_tab[si]
    is_s = row[:, 14]
    rel = [p[:, k] - row[:, 11 + k] for k in range(3)]
    inv = 1.0 / sqrt_rn(rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
                        + 1e-30)
    nrm = [is_s * (rel[k] * inv) + (1.0 - is_s) * row[:, k]
           for k in range(3)]
    return torch.stack(nrm + list(row[:, 3:11].unbind(1)))


def resolve(attr_tab: torch.Tensor, gid: torch.Tensor,
            p: torch.Tensor) -> torch.Tensor:
    """The (11, R) shading-attribute rows of R hits: attr_tab the padded
    table (``whitted._attr_table(scene, padded=True)``, (N, 16); on the
    CPU the 15-column table does as well), gid (R,) f32 shape id (-1 on
    miss, resolved as row 0), p (R, 3) f32 hit points. On a CUDA tensor
    this launches ``resolve_kernel``; on a CPU tensor it runs
    ``resolve_plain``."""
    dev = gid.device
    if dev.type == "cpu":
        return resolve_plain(attr_tab, gid, p)
    if dev.type != "cuda":
        raise ValueError(f"resolve: unsupported device {dev}")
    n = gid.shape[0]
    kernels.check_tensor("attr_tab", attr_tab, torch.float32, dev,
                         (None, ATTR_PAD_W))
    kernels.check_tensor("gid", gid, torch.float32, dev, (None,))
    kernels.check_tensor("p", p, torch.float32, dev, (n, 3))
    if attr_tab.shape[0] == 0:
        raise ValueError("attr_tab is empty")
    out = torch.empty((N_ATTRS, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    kernels.launch("resolve_kernel", "rt_resolve", dev, attr_tab.data_ptr(),
                   attr_tab.shape[0], gid.data_ptr(), p.data_ptr(), n,
                   out.data_ptr())
    resolve.launches += 1
    return out


resolve.launches = 0


def closest_hit_attrs_plain(split: SplitScene, o: torch.Tensor,
                            d: torch.Tensor, tri_mode: int):
    """Plain version of ``closest_attrs_kernel``: o, d (R, 3) f32. Returns
    (t, gid int32, attrs (N_ATTRS, R)): the closest hit as
    ``closest_hit_plain`` gives it, and the normal, colour, ka, kd, ks, kf
    and shininess of the winning shape. A sphere's normal is (p - c) /
    sqrt(|p - c|^2 + 1e-30) at the hit point p = o + t d, correctly
    rounded; other shapes carry their row's plane normal. Misses and
    parked rays: t = INF, gid -1, zero attributes."""
    oc = (o[:, 0], o[:, 1], o[:, 2])
    dc = (d[:, 0], d[:, 1], d[:, 2])
    t, gid, a = closest_pass_plain(split, oc, dc, tri_mode=tri_mode,
                                   with_attrs=True)
    return t, gid.to(torch.int32), a.t().contiguous()


def closest_hit_attrs(split: SplitScene, o: torch.Tensor, d: torch.Tensor,
                      tri_mode: int, stats: Optional[torch.Tensor] = None):
    """Closest hit of R rays o, d (R, 3) f32 with the shading attributes
    of the winning shape: (t, gid int32 (-1 on miss), attrs (N_ATTRS, R)
    f32: n(3), color(3), ka, kd, ks, kf, shininess; zero on a miss). On a
    CUDA tensor this launches ``closest_attrs_kernel``; on a CPU tensor it
    runs ``closest_hit_attrs_plain``. ``stats`` as for ``closest_hit``."""
    dev = o.device
    if dev.type == "cpu":
        return closest_hit_attrs_plain(split, o, d, tri_mode)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_attrs: unsupported device {dev}")
    n = o.shape[0]
    kernels.check_tensor("o", o, torch.float32, dev, (None, 3))
    kernels.check_tensor("d", d, torch.float32, dev, (n, 3))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (5,))
    t = torch.empty(n, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    attrs = torch.empty((N_ATTRS, n), dtype=torch.float32, device=dev)
    if n == 0:
        return t, gid, attrs
    kernels.launch(
        "closest_attrs_kernel", "rt_closest_attrs", dev,
        *kernels.table_args(split, dev), o.data_ptr(), d.data_ptr(), n,
        t.data_ptr(), gid.data_ptr(), attrs.data_ptr(), tri_mode,
        None if stats is None else stats.data_ptr())
    closest_hit_attrs.launches += 1
    return t, gid, attrs


closest_hit_attrs.launches = 0


def make_attr_resolver(cfg: RenderConfig):
    """resolve(attr_tab, gid, p) -> (n, color, ka, kd, ks, kf, shininess),
    as ``pallas_split.make_attr_resolver``: attr_tab as ``resolve`` takes
    it, gid (R,) f32 shape id (-1 on miss), p (R, 3) hit points. (The JAX
    version pads to its tiles; the kernel takes any R.)"""

    def resolver(attr_tab, gid, p):
        return _attrs(resolve(attr_tab, gid.contiguous(), p.contiguous()))

    return resolver


def make_closest_hit(split: SplitScene, cfg: RenderConfig):
    """closest_hit(o, d) -> (t, sid, hit) plus .occlusion(o, d, max_t),
    .fused_shadow(o, d, light_pos) -> (t, sid, hit, in_shadow) and
    .with_attrs(o, d) -> (t, sid, hit, (n, color, ka, kd, ks, kf,
    shininess)), as ``pallas_split.make_closest_hit``: o, d (R, 3) f32 on
    the split's device; sid is the int32 shape id (0 on miss), hit = t <
    INF. ``with_attrs`` has ``provides_attrs = True``, ``.base`` (the
    plain closest hit, for shadow rays) and ``.occlusion``."""
    tri_mode = cfg.tri_mode

    def closest(o, d):
        t, gid = closest_hit(split, o, d, tri_mode)
        return t, gid.clamp_min(0), t < INF

    def occlusion(o, d, max_t):
        t, _ = closest_hit(split, o, d, tri_mode, max_t=max_t)
        return t == 0.0

    def fused_shadow(o, d, light_pos):
        t, gid, in_shadow = fused(split, o, d, light_pos, tri_mode,
                                  cfg.shadow_eps)
        return t, gid.clamp_min(0), t < INF, in_shadow

    def with_attrs(o, d):
        t, gid, attrs = closest_hit_attrs(split, o, d, tri_mode)
        return t, gid.clamp_min(0), t < INF, _attrs(attrs)

    with_attrs.provides_attrs = True
    with_attrs.base = closest
    with_attrs.occlusion = occlusion
    closest.occlusion = occlusion
    closest.fused_shadow = fused_shadow
    closest.with_attrs = with_attrs
    return closest


def primary_rays(camera, cfg: RenderConfig):
    """The frame's image-order primary rays and backgrounds: (o, d, bg),
    each (H * W, 3) f32 on the camera's device."""
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    ys = div_rn(torch.arange(h, dtype=torch.float32, device=o.device), h)
    bg = torch.broadcast_to(shading.background(ys)[:, None, :], (h, w, 3))
    return o, d, bg.reshape(-1, 3)


def trace_rays(scene, split: SplitScene, light, o, d, bg,
               cfg: RenderConfig, differentiable: bool = False):
    """The per-bounce route's trace of the rays o, d (R, 3) with
    backgrounds bg: ``whitted.trace``, by default with the fused
    closest+shadow launch (the closest-hit launch when shadows are off)
    and the attribute resolve. With ``USE_KERNEL_ATTRS``: the closest hit
    with its attributes, kernel 2 for the shadow rays. With
    ``differentiable``: kernel 2 for every query, t re-derived in
    autograd, attributes by the row gather. Returns (R, 3)."""
    closest = make_closest_hit(split, cfg)
    fused_fn, resolve_fn = closest.fused_shadow, make_attr_resolver(cfg)
    if differentiable:
        from raytracer_tpu_torch.diff.kernel_vjp import (
            make_differentiable_closest)
        occlusion = closest.occlusion
        closest = make_differentiable_closest(scene, closest, cfg.use_mt)
        closest.occlusion = occlusion
        fused_fn = resolve_fn = None
    elif USE_KERNEL_ATTRS:
        closest = closest.with_attrs
        fused_fn = resolve_fn = None
    return whitted.trace(scene, light, closest, o, d, bg, cfg,
                         fused_fn=fused_fn, resolve_fn=resolve_fn)


def _trace_frame(scene, split: SplitScene, camera, light,
                 cfg: RenderConfig,
                 differentiable: bool = False) -> torch.Tensor:
    """The per-bounce route (``trace_rays``) over image-order primary
    rays: (H, W, 3)."""
    o, d, bg = primary_rays(camera, cfg)
    colors = trace_rays(scene, split, light, o, d, bg, cfg,
                        differentiable=differentiable)
    return colors.reshape(cfg.height, cfg.width, 3)


def _render_impl(scene, split: SplitScene, camera, light,
                 cfg: RenderConfig,
                 differentiable: bool = False) -> torch.Tensor:
    """The routing of ``pallas_split._render_impl`` (1202-1281):

    - ``differentiable``: the per-bounce route with the differentiable
      closest hit (kernel 2 for the hits and the shadow rays, t re-derived
      in autograd, the row gather for the attributes);
    - ``USE_KERNEL_ATTRS``: the per-bounce route with
      ``closest_attrs_kernel`` for the hits and kernel 2 for the shadow
      rays (no fused and no resolve launch);
    - ``wholeframe.USE_WHOLEFRAME`` on with ``sort_bounces`` and
      ``max_bounces >= 2``: the sorted-continuation hybrid
      (``wholeframe._render_blocks``: two launches of ``wholeframe_kernel``,
      three with ``second_sort``);
    - ``USE_WHOLEFRAME`` on and ``sort_bounces`` off: the one-launch frame;
    - otherwise the per-bounce route (``whitted.trace`` with
      ``fused_kernel`` and ``resolve_kernel``).

    The JAX package's ``raygen_ok`` (power-of-two tiles for its f32 pixel
    mapping) and ``hybrid_ret_exact`` (an f32 pixel index below 2^24)
    conditions exist for its TPU tiles; the port has no tiles and carries
    an int32 pixel index, so it drops both, and with them the fed-rays
    whole-frame fallback. Of the JAX package's A/B switches of the
    per-bounce route (pallas_split.py:72-128) the port keeps
    ``USE_KERNEL_ATTRS``; for ``USE_OCCLUSION``, ``USE_FUSED_SHADOW`` and
    ``USE_RESOLVE_KERNEL`` it takes their production settings."""
    from raytracer_tpu_torch.render import wholeframe
    if wholeframe_route_ok(cfg, differentiable):
        return wholeframe._render_blocks(scene, split, camera, light, cfg)
    return _trace_frame(scene, split, camera, light, cfg,
                        differentiable=differentiable)


def wholeframe_route_ok(cfg: RenderConfig, differentiable: bool) -> bool:
    """Whether ``_render_impl`` takes the whole-frame route (the
    one-launch frame or the hybrid) for ``cfg``, rather than the
    per-bounce route."""
    from raytracer_tpu_torch.render import wholeframe
    if differentiable or USE_KERNEL_ATTRS or not wholeframe.USE_WHOLEFRAME:
        return False
    return not cfg.sort_bounces or cfg.max_bounces >= 2


def render(scene, bvh, camera, light, cfg: RenderConfig,
           split: Optional[SplitScene] = None,
           differentiable: bool = False, device=None) -> torch.Tensor:
    """Render (H, W, 3) f32: the one-launch whole-frame kernel, the
    sorted-continuation hybrid (``cfg.sort_bounces``) or the per-bounce
    route, as ``_render_impl`` routes. ``bvh`` is the reference LinearBVH
    (exact leaf-box gates of the plane family); pass a prebuilt ``split``
    to skip host prep. ``device`` None means "cuda"; "cpu" runs the plain
    versions.

    With ``differentiable`` the image carries gradients with respect to
    the scene's, camera's and light's tensors (those with
    ``requires_grad``): the kernel decides the hits, and gradients flow
    through t re-derived per hit (``diff/kernel_vjp.py``), the normals
    and the shading. The split's tables are used as given; when the
    geometry moves, refresh them first (``split_scene.update_dynamic``,
    as ``diff.make_kernel_renderer`` does)."""
    dev = resolve_device(device)
    if split is None:
        split = prepare(scene, bvh, device=dev)
    return _render_impl(scene.to(dev), split.to(dev), camera.to(dev),
                        light.to(dev), cfg, differentiable=differentiable)
