"""The plain reference: a Whitted tracer in PyTorch tensor operations that
follows the upstream's GPU shader (gpu_shader.comp) over the upstream's
own BVH (``bvh.py``), with the quirks of PARITY.md:

- INNER hits only: a plane-family hit needs n.dir > 0, a sphere the
  near root with D > 0 (plane.hpp:51, sphere.hpp:49-57);
- a shape is tested only where the walk reaches its leaf, so scene 1's
  infinite floor (a wall whose basis is degenerate) is clipped to its
  leaf's box; a moved shape grows the boxes over it (updateBVH,
  main.cpp:1068-1077);
- Phong without Blinn, light / distance, specular only where the diffuse
  term is positive, view direction = the ray's direction (comp:331-361);
- shadows x0.3 where the closest hit toward the light is nearer than the
  light, from p + n * 1e-3 (comp:466-491);
- reflection while the specular coefficient is positive, attenuation x=
  ks, from p + n * 1e-3 (comp:495-516); the background gradient on a
  miss, weighted by the attenuation (comp:436, 456).

Every query walks the tree for every live ray: the node boxes hit under
hit ancestors give the leaves visited, their shapes the (ray, shape)
pairs tested, and the closest hit per ray is a segment minimum over the
pairs, ties to the lowest shape index. The work count (``work.py``)
walks the same rays through each tree that it counts (the upstream's,
and the counting tree of ``bvh.build_counting``) and counts each one's
box tests and shape tests by type, per ray.

With ``grad`` the hits are decided without gradients and t is derived
again for each hit in autograd, so gradients reach the geometry, the
materials and the light with the decisions held fixed (as the program's
``kernel_vjp`` holds them). It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import bvh
from .bvh import Tree
from .scene import SPHERE, TRIANGLE, WALL

INF = 1e30
SHADOW_FACTOR = 0.3
BG_DARK = (0.05, 0.07, 0.1)
BG_SKY = (0.5, 0.7, 1.0)
GEOM_FIELDS = ("shape_type", "sphere_center", "sphere_radius",
               "plane_normal", "plane_d", "wall_start", "wall_width",
               "wall_height", "tri_p1", "tri_p2", "tri_p3", "mat_color",
               "mat_ambient", "mat_diffuse", "mat_specular", "mat_shininess")
# work counters, per ray: box tests, then shape tests by type
COUNTS = ("box", "sphere", "plane", "wall", "triangle")
# the counting tree's largest leaf (``bvh.build_counting``)
LEAF_MAX = 2


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def geometry(flat: Dict[str, np.ndarray], device, dtype) -> dict:
    """The shape columns the tracer reads, as tensors."""
    g = {}
    for k in GEOM_FIELDS:
        x = torch.from_numpy(np.ascontiguousarray(flat[k])).to(device)
        g[k] = x if k == "shape_type" else x.to(dtype)
    return g


def tri_planes(g: dict, rows: torch.Tensor) -> dict:
    """The plane of triangles ``rows`` again from their vertices, keeping
    each one's stored orientation (triangle.hpp:84-130)."""
    p1, p2, p3 = (g[k].index_select(0, rows) for k in
                  ("tri_p1", "tri_p2", "tri_p3"))
    n = normalize(cross(p2 - p1, p3 - p1))
    old = g["plane_normal"].index_select(0, rows)
    n = torch.where((dot(n, old) < 0)[:, None], -n, n)
    out = dict(g)
    out["plane_normal"] = g["plane_normal"].index_copy(0, rows, n)
    out["plane_d"] = g["plane_d"].index_copy(0, rows, -dot(n, p1))
    return out


def ref_scene(spec, device, dtype=torch.float32,
              leaf_max: int = LEAF_MAX) -> "RefScene":
    """The upstream's tree of a scene (``bvh.build``) for the hits; the
    work count counts it and the counting tree."""
    counting = RefScene(bvh.build_counting(spec.flat, leaf_max), spec.flat,
                        device, dtype)
    return RefScene(bvh.build(spec.flat, spec.bvh_max_depth), spec.flat,
                    device, dtype, [counting])


def derive(g: dict) -> dict:
    """Per-shape quantities of the tests (differentiable in g)."""
    n = g["plane_normal"]
    up = torch.zeros_like(n)
    up[:, 1] = 1.0
    u_raw = cross(n, up)
    len2 = dot(u_raw, u_raw)
    deg = len2 < 1e-20
    u = u_raw / torch.sqrt(torch.where(deg, torch.ones_like(len2), len2))[:, None]
    v_raw = cross(n, u)
    vl2 = dot(v_raw, v_raw)
    v = v_raw / torch.sqrt(torch.where(vl2 < 1e-20, torch.ones_like(vl2), vl2))[:, None]
    e1 = g["tri_p2"] - g["tri_p1"]
    e2 = g["tri_p3"] - g["tri_p1"]
    d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    st = g["shape_type"]
    return dict(g, wu=u, wv=v, w_deg=deg & (st == WALL), e1=e1, e2=e2,
                d00=d00, d01=d01, d11=d11, denom=d00 * d11 - d01 * d01)


class RefScene:
    """The tree's tensors on a device: node boxes, the parent of each node
    level by level from the root, the leaves' shape lists; and the trees
    whose walks the work count counts (``counted``)."""

    def __init__(self, tree: Tree, flat, device, dtype=torch.float32,
                 also_counted=()):
        self.device, self.dtype = device, dtype
        # the trees whose walks the work count counts: this one first
        self.counted = [self, *also_counted]
        # rays a query takes at once: on the card few large launches
        self.chunk = 65536 if torch.device(device).type == "cuda" else 8192
        m = tree.num_nodes
        parent = np.full(m, -1, np.int64)
        for i in range(m):
            if tree.left[i] >= 0:
                parent[tree.left[i]] = i
                parent[tree.right[i]] = i
        depth = np.zeros(m, np.int64)
        for i in range(m - 1, -1, -1):   # parents come after children
            if parent[i] >= 0:
                depth[i] = depth[parent[i]] + 1
        self.levels = [(torch.from_numpy(np.nonzero(depth == lv)[0]).to(device),
                        torch.from_numpy(parent[depth == lv]).to(device))
                       for lv in range(1, int(depth.max()) + 1)]
        self.root = m - 1
        leaves = np.nonzero(tree.left < 0)[0]
        inner = np.nonzero(tree.left >= 0)[0]
        self.leaves = torch.from_numpy(leaves).to(device)
        self.inner = torch.from_numpy(inner).to(device)
        counts = np.array([len(tree.members[i]) for i in leaves], np.int64)
        perm = np.concatenate([tree.members[i] for i in leaves])
        self.leaf_count = torch.from_numpy(counts).to(device)
        self.leaf_start = torch.from_numpy(
            np.concatenate([[0], np.cumsum(counts)[:-1]])).to(device)
        self.perm = torch.from_numpy(perm).to(device)
        st = flat["shape_type"][perm]
        owner = np.repeat(np.arange(len(leaves)), counts)
        types = np.zeros((len(leaves), 4), np.float64)
        np.add.at(types, (owner, st), 1.0)
        self.leaf_types = torch.from_numpy(types).to(device)
        self.box0 = torch.from_numpy(
            np.concatenate([tree.bmin, tree.bmax], 1)).to(device)
        # (node, member) incidence, for the grow-only refit
        mem = [np.asarray(tree.members[i], np.int64) for i in range(m)]
        self.inc_node = torch.from_numpy(
            np.repeat(np.arange(m), [len(x) for x in mem])).to(device)
        self.inc_shape = torch.from_numpy(np.concatenate(mem)).to(device)
        self.boxes = self.box0.to(dtype)

    @property
    def count_width(self) -> int:
        """The columns of a ``counts`` array: five a counted tree."""
        return 5 * len(self.counted)

    @torch.no_grad()
    def refit(self, g: dict) -> None:
        """updateBVH's grow-only refit to the current geometry: every box
        grows to hold its shapes' current AABBs (contained shapes only;
        a wall's box stays as built)."""
        st = g["shape_type"]
        sph, tri = st == SPHERE, st == TRIANGLE
        c, r = g["sphere_center"].float(), g["sphere_radius"].float()[:, None]
        ps = [g[k].float() for k in ("tri_p1", "tri_p2", "tri_p3")]
        tmin = torch.minimum(torch.minimum(ps[0], ps[1]), ps[2])
        tmax = torch.maximum(torch.maximum(ps[0], ps[1]), ps[2])
        big = torch.full_like(c, math.inf)
        lo = torch.where(sph[:, None], c - r, torch.where(tri[:, None], tmin, big))
        hi = torch.where(sph[:, None], c + r, torch.where(tri[:, None], tmax, -big))
        node = self.inc_node[:, None].expand(-1, 3)
        bmin = self.box0[:, :3].clone().scatter_reduce_(
            0, node, lo[self.inc_shape], "amin")
        bmax = self.box0[:, 3:].clone().scatter_reduce_(
            0, node, hi[self.inc_shape], "amax")
        self.boxes = torch.cat([bmin, bmax], 1).to(self.dtype)
        for other in self.counted[1:]:
            other.refit(g)

    def _visited(self, o, d):
        """(R, nodes) bool: the walk pops the node and hits its box."""
        inv = 1.0 / d
        tmin = tmax = None
        for a in range(3):
            t0 = (self.boxes[None, :, a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            t1 = (self.boxes[None, :, 3 + a] - o[:, a:a + 1]) * inv[:, a:a + 1]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tmin = lo if tmin is None else torch.maximum(tmin, lo)
            tmax = hi if tmax is None else torch.minimum(tmax, hi)
        vis = (tmax >= tmin) & (tmax > 0)
        for nodes, parents in self.levels:
            vis[:, nodes] &= vis[:, parents]
        return vis

    @torch.no_grad()
    def closest(self, dv: dict, o, d, counts: Optional[torch.Tensor] = None):
        """Closest INNER hit of each ray: (t, gid, hit), t = INF on a miss.
        ``counts`` (R, 5 x trees counted) f64, if given, receives the
        tests of each counted tree's walk, five columns a tree."""
        n = o.shape[0]
        t_out = torch.full((n,), INF, dtype=self.dtype, device=o.device)
        g_out = torch.zeros((n,), dtype=torch.int64, device=o.device)
        for c0 in range(0, n, self.chunk):
            oc, dc = o[c0:c0 + self.chunk], d[c0:c0 + self.chunk]
            vis = self._visited(oc, dc)
            vleaf = vis[:, self.leaves]
            if counts is not None:
                rows = slice(c0, c0 + oc.shape[0])
                for j, cs in enumerate(self.counted):
                    cv = vis if cs is self else cs._visited(oc, dc)
                    counts[rows, 5 * j] += 1.0 + 2.0 * cv[:, cs.inner].sum(
                        1, dtype=torch.float64)
                    counts[rows, 5 * j + 1:5 * j + 5] += (
                        cv[:, cs.leaves].to(torch.float64) @ cs.leaf_types)
            t, gid = self._pairs(dv, oc, dc, vleaf)
            t_out[c0:c0 + oc.shape[0]] = t
            g_out[c0:c0 + oc.shape[0]] = gid
        return t_out, g_out, t_out < INF

    def _pairs(self, dv, o, d, vleaf):
        ray, leaf = vleaf.nonzero(as_tuple=True)
        cnt = self.leaf_count[leaf]
        total = int(cnt.sum())
        r = o.shape[0]
        if total == 0:
            return (torch.full((r,), INF, dtype=self.dtype, device=o.device),
                    torch.zeros((r,), dtype=torch.int64, device=o.device))
        first = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(total, device=o.device) - torch.repeat_interleave(
            first, cnt, output_size=total)
        pr = torch.repeat_interleave(ray, cnt, output_size=total)
        ps = self.perm[torch.repeat_interleave(self.leaf_start[leaf], cnt,
                                               output_size=total) + off]
        t = torch.full((total,), INF, dtype=self.dtype, device=o.device)
        st = dv["shape_type"][ps]
        for kind in (SPHERE, WALL, TRIANGLE, 1):
            sel = (st == kind).nonzero(as_tuple=True)[0]
            if sel.numel():
                s, q = ps[sel], pr[sel]
                tk, ok = test(dv, kind, s, o[q], d[q])
                t[sel] = torch.where(ok, tk, torch.full_like(tk, INF))
        best = torch.full((r,), INF, dtype=self.dtype, device=o.device)
        best.scatter_reduce_(0, pr, t, "amin")
        win = (t == best[pr]) & (t < INF)
        gid = torch.full((r,), 1 << 62, dtype=torch.int64, device=o.device)
        gid.scatter_reduce_(0, pr[win], ps[win], "amin")
        return best, torch.where(best < INF, gid, torch.zeros_like(gid))


def test(dv: dict, kind: int, s, o, d):
    """(t, inner) of rays o, d against shapes s, all of type ``kind``."""
    if kind == SPHERE:
        oc = o - dv["sphere_center"][s]
        r = dv["sphere_radius"][s]
        aa = dot(d, d)
        bb = 2.0 * dot(d, oc)
        cc = dot(oc, oc) - r * r
        disc = bb * bb - 4.0 * aa * cc
        sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
        t = (-bb - sq) / (2.0 * aa)
        return t, (disc > 0) & (t > 0)
    n = dv["plane_normal"][s]
    d_n = dot(d, n)
    t = -(dv["plane_d"][s] + dot(o, n)) / torch.where(
        d_n == 0, torch.ones_like(d_n), d_n)
    ok = (d_n > 0) & (t > 0)
    if kind == 1:   # a bare plane
        return t, ok
    h = o + torch.where(ok, t, torch.zeros_like(t))[:, None] * d
    if kind == WALL:
        rel = h - dv["wall_start"][s]
        up, vp = dot(rel, dv["wu"][s]), dot(rel, dv["wv"][s])
        out = (up < 0) | (up > dv["wall_width"][s]) | (vp < 0) | (
            vp > dv["wall_height"][s])
        return t, ok & (dv["w_deg"][s] | ~out)
    tp = h - dv["tri_p1"][s]
    d20, d21 = dot(tp, dv["e1"][s]), dot(tp, dv["e2"][s])
    den = dv["denom"][s]
    deg = den == 0
    safe = torch.where(deg, torch.ones_like(den), den)
    v = (dv["d11"][s] * d20 - dv["d01"][s] * d21) / safe
    w = (dv["d00"][s] * d21 - dv["d01"][s] * d20) / safe
    u = 1.0 - v - w
    return t, ok & (deg | ~((u < 0) | (v < 0) | (w < 0)))


def rederive_t(dv: dict, gid, o, d):
    """t of each ray against its hit shape, in autograd."""
    st = dv["shape_type"][gid]
    ts, _ = test(dv, SPHERE, gid, o, d)
    n = dv["plane_normal"][gid]
    d_n = dot(d, n)
    tp = -(dv["plane_d"][gid] + dot(o, n)) / torch.where(
        d_n == 0, torch.ones_like(d_n), d_n)
    return torch.where(st == SPHERE, ts, tp)


def camera_rays(pose, fov_deg: float, width: int, height: int, pix,
                device, dtype):
    """Primary rays (camera.hpp:124-137) of the pixels ``pix`` (row-major
    indices) for a camera at pose (x, y, z, yaw, pitch), basis from the
    Euler angles (camera.hpp:152-163), and their backgrounds."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(pose[:3], **f32)
    yaw = torch.deg2rad(torch.tensor(pose[3], **f32))
    pitch = torch.deg2rad(torch.tensor(pose[4], **f32))
    front = normalize(torch.stack([torch.cos(yaw) * torch.cos(pitch),
                                   torch.sin(pitch),
                                   torch.sin(yaw) * torch.cos(pitch)]))
    right = normalize(cross(front, torch.tensor([0.0, 1.0, 0.0], **f32)))
    up = normalize(cross(right, front))
    half_h = torch.tan(torch.deg2rad(torch.tensor(fov_deg, **f32) / 2.0))
    half_w = half_h * torch.tensor(width / height, **f32)
    y = (pix // width).to(torch.float32)
    x = (pix % width).to(torch.float32)
    ndc_x = 2.0 * x / torch.full_like(x, width) - 1.0
    ndc_y = 1.0 - 2.0 * y / torch.full_like(y, height)
    plane = (pos + front + (ndc_x * half_w)[:, None] * right
             + (ndc_y * half_h)[:, None] * up)
    d = normalize(plane - pos)
    o = pos.expand_as(d)
    f = (y / torch.full_like(y, height))[:, None]
    dark, sky = torch.tensor(BG_DARK, **f32), torch.tensor(BG_SKY, **f32)
    bg = dark + (sky - dark) * f
    return o.to(dtype), d.to(dtype), bg.to(dtype)


def reflect(i, n):
    return i - 2.0 * dot(n, i)[:, None] * n


def trace(rs: RefScene, g: dict, light: dict, o, d, bg, render: dict,
          grad: bool = False, counts: Optional[torch.Tensor] = None):
    """Colours (R, 3) of rays o, d with backgrounds bg. ``g``: the shape
    columns (tensors, possibly requiring grad); ``light``: position (3,)
    and color (3,) tensors, the colour already scaled by the intensity.
    ``counts`` (R, 5 x trees counted) f64 accumulates each pixel's tests
    (``RefScene.closest``)."""
    dt = rs.dtype
    dv = derive(g)
    dv_nog = derive({k: v.detach() for k, v in g.items()}) if grad else dv
    lp, lc = light["position"], light["color"]
    n_rays = o.shape[0]
    dev = o.device
    accum = torch.zeros((n_rays, 3), dtype=dt, device=dev)
    atten = torch.ones((n_rays, 3), dtype=dt, device=dev)
    alive = torch.ones(n_rays, dtype=torch.bool, device=dev)
    eps_s = 1e-3 if render["use_bvh"] else 1e-5
    for _ in range(int(render["max_bounces"])):
        idx = alive.nonzero(as_tuple=True)[0]
        t = torch.full((n_rays,), INF, dtype=dt, device=dev)
        gid = torch.zeros((n_rays,), dtype=torch.int64, device=dev)
        if idx.numel():
            sub = None if counts is None else torch.zeros(
                (idx.numel(), counts.shape[1]), dtype=torch.float64, device=dev)
            ts, gs, _ = rs.closest(dv_nog, o.detach()[idx], d.detach()[idx],
                                   sub)
            t[idx], gid[idx] = ts, gs
            if counts is not None:
                counts.index_add_(0, idx, sub)
        hit = alive & (t < INF)
        if grad:
            t = torch.where(hit, rederive_t(dv, gid, o, d), t)
        accum = accum + torch.where((alive & ~hit)[:, None], atten * bg, 0.0)
        ts = torch.where(hit, t, torch.zeros_like(t))
        p = o + ts[:, None] * d
        st = dv["shape_type"][gid]
        rel = p - dv["sphere_center"][gid]
        nrm = torch.where((st == SPHERE)[:, None],
                          rel / torch.sqrt(dot(rel, rel) + 1e-30)[:, None],
                          dv["plane_normal"][gid])
        to_l = lp - p
        dist = torch.sqrt(torch.clamp_min(dot(to_l, to_l), 1e-30))
        in_shadow = torch.zeros_like(hit)
        if render["enable_shadows"]:
            sidx = hit.nonzero(as_tuple=True)[0]
            if sidx.numel():
                s_o = (p + nrm * eps_s).detach()[sidx]
                s_d = (to_l / dist[:, None]).detach()[sidx]
                sub = None if counts is None else torch.zeros(
                    (sidx.numel(), counts.shape[1]), dtype=torch.float64, device=dev)
                s_t, _, s_hit = rs.closest(dv_nog, s_o, s_d, sub)
                in_shadow[sidx] = s_hit & (s_t < dist.detach()[sidx])
                if counts is not None:
                    counts.index_add_(0, sidx, sub)
        color = phong(p, nrm, d, lp, lc, dv, gid, to_l, dist)
        color = torch.where(in_shadow[:, None], color * SHADOW_FACTOR, color)
        accum = accum + torch.where(hit[:, None], atten * color, 0.0)
        ks = dv["mat_specular"][gid]
        cont = hit & (ks > 0)
        atten = torch.where(cont[:, None], atten * ks[:, None], atten)
        # rays that end are parked at finite values and never queried
        o = torch.where(cont[:, None], p + nrm * 1e-3, torch.zeros_like(p))
        d = torch.where(cont[:, None], reflect(d, nrm),
                        torch.ones_like(d) * (3.0 ** -0.5))
        alive = cont
    return accum


def phong(p, nrm, view, lp, lc, dv, gid, to_l, dist):
    lcol = lc / dist[:, None]
    ka, kd = dv["mat_ambient"][gid], dv["mat_diffuse"][gid]
    ks, shin = dv["mat_specular"][gid], dv["mat_shininess"][gid]
    ldir = to_l / dist[:, None]
    diff = torch.clamp_min(dot(nrm, ldir), 0.0)
    rdir = reflect(-ldir, nrm)
    spec = torch.pow(torch.clamp_min(dot(view, rdir), 0.0), shin)
    spec = torch.where(diff > 0, ks * spec, torch.zeros_like(spec))
    return (ka[:, None] * lcol + (kd * diff)[:, None] * lcol
            + spec[:, None] * lcol) * dv["mat_color"][gid]
