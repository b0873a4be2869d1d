"""Host-side scene preparation for the closest-hit walk (port of
``raytracer_tpu/render/split_scene.py``): the SplitScene row tables (the
non-triangle pre-pass rows, the triangle rows and the triangle tree) and
the canonical material-resolve id.

The tables are computed in numpy on the host, exactly as the JAX package
computes them, then moved to the target device. Row layout constants
(G_*, T_*) are the contract between this packer, the CUDA kernels
(``csrc/raytrace.cuh``) and the plain versions.

PARITY notes against the JAX package:
- The TPU kernel reads up to TRI_UNROLL rows past a leaf's last triangle,
  so the JAX tables carry zero guard rows after the last triangle and
  round the pre rows and tree nodes up to multiples of 8. The port's
  walks read exactly a leaf's rows, so ``tri_rows`` is (n_tri, TRI_W),
  ``pre_rows`` is (n_other, PRE_W) and ``nodes`` is (m, 8): the JAX
  tables' leading rows, without the padding.
- ``rid_values`` (the distinct canonical ids) is kept for parity; the
  port resolves materials by a plain gather ``attr_tab[rid]``, which is
  what the JAX kernel's static unroll over ``rid_values`` computes.

The per-step refreshers ``update_pre_rows``, ``update_tri_rows`` and
``update_dynamic`` repack the float tables from a changed scene as tensor
code on the tables' device (no host round trip), with the tree's topology
fixed and its boxes refit; ``prepare`` stores the refit metadata they
read. ``update_materials`` (the host-side regrouping after a material
edit) is not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.accel import bvh as bvh_mod
from raytracer_tpu_torch.accel.linearize import (LinearBVH, linearize,
                                                 shape_leaf_boxes)
from raytracer_tpu_torch.accel.sah import build_sah
from raytracer_tpu_torch.core.scene import (SPHERE, TRIANGLE, WALL,
                                            FlatScene, to_numpy)
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.geom.aabb import (shape_aabbs, shape_aabbs_device,
                                           shape_centers)
from raytracer_tpu_torch.geom.direct import INF, wall_basis

# Leaf size of the binned-SAH triangle tree (the JAX package's default
# builder and leaf size, so both build the same tree; any triangle tree is
# exact).
SAH_LEAF_TARGET = 128

# pre-pass row layout: geom pack (24) + gid + leaf box (6) + material (8)
# + rid (canonical resolve id)
G_GID = 24
G_B0X, G_B0Y, G_B0Z, G_B1X, G_B1Y, G_B1Z = 25, 26, 27, 28, 29, 30
G_MCR, G_MCG, G_MCB = 31, 32, 33
G_MKA, G_MKD, G_MKS, G_MKF, G_MSH = 34, 35, 36, 37, 38
G_RID = 39
PRE_W = 40

# triangle row layout: n, pd, e1, e2, p1, p1e1, p1e2, r11, r01, r00, gid,
# material, rid, + Gram-fused constants
T_NX, T_NY, T_NZ, T_PD = 0, 1, 2, 3
T_E1X, T_E1Y, T_E1Z = 4, 5, 6
T_E2X, T_E2Y, T_E2Z = 7, 8, 9
T_P1X, T_P1Y, T_P1Z = 10, 11, 12
T_S0, T_S1, T_R11, T_R01, T_R00 = 13, 14, 15, 16, 17
T_GID = 18
T_MCR, T_MCG, T_MCB = 19, 20, 21
T_MKA, T_MKD, T_MKS, T_MKF, T_MSH = 22, 23, 24, 25, 26
T_RID = 27
# Ev = r11*e1 - r01*e2, cv = r11*s0 - r01*s1 (and Ew, cw symmetric): the
# barycentric v = (o.Ev - cv) + t*(d.Ev) without forming the hit point.
T_EVX, T_EVY, T_EVZ, T_CV = 28, 29, 30, 31
T_EWX, T_EWY, T_EWZ, T_CW = 32, 33, 34, 35
TRI_W = 36


def _canonical_material_ids(mat_cols: dict, n: int) -> np.ndarray:
    """canon[g] = min gid over shapes whose material 8-tuple is bitwise
    identical to shape g's. Resolving the material through it is exact
    (shapes of one group share every material column)."""
    mat = np.stack([
        mat_cols["mat_color"][:, 0], mat_cols["mat_color"][:, 1],
        mat_cols["mat_color"][:, 2], mat_cols["mat_ambient"],
        mat_cols["mat_diffuse"], mat_cols["mat_specular"],
        mat_cols["mat_fresnel"], mat_cols["mat_shininess"],
    ], axis=1)
    _, inv = np.unique(mat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    first = np.full(inv.max() + 1 if inv.size else 1, -1, np.int64)
    for g in range(n - 1, -1, -1):
        first[inv[g]] = g
    return first[inv]


@dataclasses.dataclass
class SplitScene:
    """Device tables of the closest-hit walk (static per scene).

    leaf_start/leaf_count/skip: (m,) int32 skip-pointer triangle tree;
    nodes: (m, 8) f32 box min xyz, max xyz, 2 zero columns;
    pre_rows: (n_other, PRE_W) f32, spheres first, then planes/walls;
    tri_rows: (n_tri, TRI_W) f32 in DFS-leaf order.

    The refit metadata of the ``update_*`` refreshers (None where a
    caller did not give it), as the JAX SplitScene keeps it:
    other_idx (n_other,) int32, the shape id of each pre row; tri_gids
    (max(n_tri, 1),) int32, of each triangle row; tri_leaf_id, the leaf
    ordinal of each triangle row; leaf_lo/leaf_hi (n_leaf,) int32, each
    leaf's row range; node_lo/node_hi (m_pad,) int32, the row range under
    each node (lo = hi for padding); m_pad = m rounded up to 8."""

    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    skip: torch.Tensor
    nodes: torch.Tensor
    pre_rows: torch.Tensor
    tri_rows: torch.Tensor
    m: int
    n_other: int
    n_sph: int
    n_tri: int
    rid_values: Tuple[int, ...]
    other_idx: Optional[torch.Tensor] = None
    tri_gids: Optional[torch.Tensor] = None
    tri_leaf_id: Optional[torch.Tensor] = None
    leaf_lo: Optional[torch.Tensor] = None
    leaf_hi: Optional[torch.Tensor] = None
    node_lo: Optional[torch.Tensor] = None
    node_hi: Optional[torch.Tensor] = None
    n_leaf: Optional[int] = None
    m_pad: Optional[int] = None
    max_id: int = dataclasses.field(init=False)

    def __post_init__(self):
        # The kernels trust these tables: refuse, once and on the host,
        # leaves that run past n_tri rows, skip pointers that do not move
        # forward (the walk would not end) and negative ids. max_id lets
        # the frame's wrapper check the attribute table it indexes.
        m = self.m
        ls = self.leaf_start[:m].cpu().to(torch.int64)
        lc = self.leaf_count[:m].cpu().to(torch.int64)
        sk = self.skip[:m].cpu().to(torch.int64)
        if m and (int((ls + lc).max()) > self.n_tri or int(ls.min()) < 0
                  or int(lc.min()) < 0):
            raise ValueError("leaf ranges run outside the n_tri rows")
        if m and (bool((sk <= torch.arange(m)).any()) or int(sk.max()) > m):
            raise ValueError("skip pointers must point forward, up to m")
        ids = torch.cat([self.pre_rows[:self.n_other, [G_GID, G_RID]]
                         .reshape(-1).cpu(),
                         self.tri_rows[:self.n_tri, [T_GID, T_RID]]
                         .reshape(-1).cpu()])
        self.max_id = int(ids.max()) if ids.numel() else -1
        if ids.numel() and int(ids.min()) < 0:
            raise ValueError("negative shape ids in the row tables")

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def device_args(self):
        return (self.leaf_start, self.leaf_count, self.skip, self.nodes,
                self.pre_rows, self.tri_rows)

    def to(self, device) -> "SplitScene":
        if self.device == resolve_device(device):
            return self
        moved = {f.name: getattr(self, f.name) for f in
                 dataclasses.fields(self) if f.init}
        for k, v in moved.items():
            if isinstance(v, torch.Tensor):
                moved[k] = v.to(device)
        return SplitScene(**moved)

    def replace_tables(self, **tables) -> "SplitScene":
        """A copy with the named float tables (nodes, pre_rows, tri_rows)
        replaced. It skips the host-side validation of ``__post_init__``:
        the refreshers change no tree pointer and no id, and copying the
        int tables to the host each step would wait for the card."""
        bad = set(tables) - {"nodes", "pre_rows", "tri_rows"}
        if bad:
            raise ValueError(f"replace_tables: not a float table: {bad}")
        new = copy.copy(self)
        for k, v in tables.items():
            setattr(new, k, v)
        return new


REFIT_FIELDS = ("other_idx", "tri_gids", "tri_leaf_id", "leaf_lo",
                "leaf_hi", "node_lo", "node_hi", "n_leaf", "m_pad")


def _refit_metadata(lin, gids: np.ndarray, other_ids: np.ndarray,
                   n_tri: int) -> dict:
    """The static refit metadata of the JAX SplitScene (split_scene.py:
    296-317) from the linearized triangle tree: the tree's topology stays
    fixed, so each node's rows are the leaves in its DFS span [n,
    skip[n])."""
    starts = to_numpy(lin.leaf_start).astype(np.int64)
    counts = to_numpy(lin.leaf_count).astype(np.int64)
    skips = to_numpy(lin.skip).astype(np.int64)
    m = starts.shape[0]
    m_pad = max(((m + 7) // 8) * 8, 8)
    leaf_nodes = np.nonzero(counts > 0)[0]
    n_leaf = int(leaf_nodes.shape[0])
    leaf_of_perm = np.zeros(max(n_tri, 1), np.int32)
    for li, nd in enumerate(leaf_nodes):
        leaf_of_perm[starts[nd]:starts[nd] + counts[nd]] = li
    node_lo = np.zeros(m_pad, np.int32)
    node_hi = np.zeros(m_pad, np.int32)
    for nd in range(m):
        in_span = leaf_nodes[(leaf_nodes >= nd) & (leaf_nodes < skips[nd])]
        if in_span.size:
            node_lo[nd] = starts[in_span[0]]
            node_hi[nd] = starts[in_span[-1]] + counts[in_span[-1]]
    return dict(
        other_idx=other_ids.astype(np.int32),
        tri_gids=(gids if n_tri else np.zeros(1)).astype(np.int32),
        tri_leaf_id=leaf_of_perm,
        leaf_lo=(starts[leaf_nodes] if n_leaf
                 else np.zeros(1)).astype(np.int32),
        leaf_hi=(starts[leaf_nodes] + counts[leaf_nodes] if n_leaf
                 else np.ones(1)).astype(np.int32),
        node_lo=node_lo, node_hi=node_hi, n_leaf=n_leaf, m_pad=m_pad)


def _tables(scene: FlatScene, ref_bvh):
    """The JAX package's SplitScene.__init__ packers, in numpy."""
    cols = scene.numpy()
    st = cols["shape_type"]
    n_shapes = st.shape[0]
    canon = _canonical_material_ids(cols, n_shapes)
    rid_values = tuple(int(v) for v in np.unique(canon))
    tri_ids = np.nonzero(st == TRIANGLE)[0].astype(np.int32)
    other_ids = np.nonzero(st != TRIANGLE)[0].astype(np.int32)
    # spheres first, then the plane family; gid order kept within each
    # group (the pre-pass compare is strict, so order matters on ties)
    sph_ids = other_ids[st[other_ids] == SPHERE]
    pw_ids = other_ids[st[other_ids] != SPHERE]
    other_ids = np.concatenate([sph_ids, pw_ids]).astype(np.int32)
    n_sph = int(sph_ids.shape[0])
    n_other = int(other_ids.shape[0])
    n_tri = int(tri_ids.shape[0])

    rows = to_numpy(rowwise.pack_rows(scene))
    if ref_bvh is not None:
        bmin, bmax = (to_numpy(b) for b in
                      shape_leaf_boxes(ref_bvh, n_shapes))
    else:
        bmin = np.full((n_shapes, 3), -INF, np.float32)
        bmax = np.full((n_shapes, 3), INF, np.float32)
    pre = np.zeros((n_other, PRE_W), np.float32)
    if n_other:
        pre[:, :24] = rows[other_ids]
        pre[:, G_GID] = other_ids.astype(np.float32)
        pre[:, G_B0X:G_B0X + 3] = bmin[other_ids]
        pre[:, G_B1X:G_B1X + 3] = bmax[other_ids]
        pre[:, G_MCR:G_MCR + 3] = cols["mat_color"][other_ids]
        pre[:, G_MKA] = cols["mat_ambient"][other_ids]
        pre[:, G_MKD] = cols["mat_diffuse"][other_ids]
        pre[:, G_MKS] = cols["mat_specular"][other_ids]
        pre[:, G_MKF] = cols["mat_fresnel"][other_ids]
        pre[:, G_MSH] = cols["mat_shininess"][other_ids]
        pre[:, G_RID] = canon[other_ids].astype(np.float32)

    mins, maxs = shape_aabbs(scene)
    centers = shape_centers(scene)
    tri_aabbs = (mins[tri_ids], maxs[tri_ids])
    if n_tri:
        tbvh = build_sah(aabbs=tri_aabbs, centers=centers[tri_ids],
                         leaf_target=SAH_LEAF_TARGET)
    else:   # no triangles: the JAX package's one-leaf median tree
        tbvh = bvh_mod.build_bvh(None, 1, aabbs=tri_aabbs,
                                 centers=centers[tri_ids])
    lin = linearize(tbvh)
    m = lin.num_nodes
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:6] = lin.bounds.numpy()

    perm = lin.perm.numpy()
    n_tri = int(perm.shape[0])
    gids = tri_ids[perm]
    p1 = cols["tri_p1"][gids]
    p2 = cols["tri_p2"][gids]
    p3 = cols["tri_p3"][gids]
    e1 = p2 - p1
    e2 = p3 - p1
    d00 = (e1 * e1).sum(-1)
    d01 = (e1 * e2).sum(-1)
    d11 = (e2 * e2).sum(-1)
    denom = d00 * d11 - d01 * d01
    safe = np.where(denom == 0, 1.0, denom)
    z = denom == 0
    tri = np.zeros((n_tri, TRI_W), np.float32)
    if n_tri:
        tri[:, T_NX:T_NX + 3] = cols["plane_normal"][gids]
        tri[:, T_PD] = cols["plane_d"][gids]
        tri[:, T_E1X:T_E1X + 3] = e1
        tri[:, T_E2X:T_E2X + 3] = e2
        tri[:, T_P1X:T_P1X + 3] = p1
        s0 = (p1 * e1).sum(-1)
        s1 = (p1 * e2).sum(-1)
        r11 = np.where(z, 0.0, d11 / safe)
        r01 = np.where(z, 0.0, d01 / safe)
        r00 = np.where(z, 0.0, d00 / safe)
        tri[:, T_S0] = s0
        tri[:, T_S1] = s1
        tri[:, T_R11] = r11
        tri[:, T_R01] = r01
        tri[:, T_R00] = r00
        r11f, r01f, r00f = (x.astype(np.float32) for x in (r11, r01, r00))
        s0f, s1f = s0.astype(np.float32), s1.astype(np.float32)
        e1f, e2f = e1.astype(np.float32), e2.astype(np.float32)
        tri[:, T_EVX:T_EVX + 3] = (r11f[:, None] * e1f
                                   - r01f[:, None] * e2f)
        tri[:, T_CV] = r11f * s0f - r01f * s1f
        tri[:, T_EWX:T_EWX + 3] = (r00f[:, None] * e2f
                                   - r01f[:, None] * e1f)
        tri[:, T_CW] = r00f * s1f - r01f * s0f
        tri[:, T_GID] = gids.astype(np.float32)
        tri[:, T_MCR:T_MCR + 3] = cols["mat_color"][gids]
        tri[:, T_MKA] = cols["mat_ambient"][gids]
        tri[:, T_MKD] = cols["mat_diffuse"][gids]
        tri[:, T_MKS] = cols["mat_specular"][gids]
        tri[:, T_MKF] = cols["mat_fresnel"][gids]
        tri[:, T_MSH] = cols["mat_shininess"][gids]
        tri[:, T_RID] = canon[gids].astype(np.float32)
    return dict(leaf_start=lin.leaf_start.numpy(),
                leaf_count=lin.leaf_count.numpy(), skip=lin.skip.numpy(),
                nodes=nodes, pre_rows=pre, tri_rows=tri, m=m,
                n_other=n_other, n_sph=n_sph, n_tri=n_tri,
                rid_values=rid_values,
                **_refit_metadata(lin, gids, other_ids, n_tri))


def prepare(scene: FlatScene, ref_bvh: LinearBVH, device=None) -> SplitScene:
    """Build the SplitScene tables of ``scene``. ``ref_bvh`` is the
    reference median-split tree, whose leaf boxes gate the pre-pass
    shapes (the BVH-clip quirk). The tables are computed on the host and
    placed on ``device`` (default: the scene's device)."""
    dev = scene.device if device is None else resolve_device(device)
    t = _tables(scene.to("cpu"), ref_bvh)
    for k, v in t.items():
        if isinstance(v, np.ndarray):
            t[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return SplitScene(**t)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row sums of a * b over (R, 3), added left to right (the sums of
    ``prepare``)."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _need_refit(split: SplitScene) -> None:
    if any(getattr(split, k) is None for k in REFIT_FIELDS):
        raise ValueError("this SplitScene has no refit metadata: build it "
                         "with prepare(), or pass refit= to "
                         "interop.from_numpy")


@torch.no_grad()
def update_pre_rows(split: SplitScene, scene: FlatScene) -> SplitScene:
    """Refresh the pre-pass rows from the current scene on the tables'
    device, for moved non-triangle shapes: geometry and material columns
    are repacked; a contained shape's leaf-box gate becomes its own
    current AABB (an exact gate), while a degenerate-basis wall keeps its
    stored reference-tree box (its visibility is that box). The shape ids
    and the canonical resolve id (G_RID) are carried forward: material
    regrouping is ``update_materials``'s work. The result is detached."""
    if split.n_other == 0:
        return split
    _need_refit(split)
    idx = split.other_idx.long()
    rows24 = rowwise.pack_rows(scene)[idx]
    amin, amax = shape_aabbs_device(scene)
    _, _, wdeg = wall_basis(scene.plane_normal)
    deg = (wdeg & (scene.shape_type == WALL))[idx][:, None]
    old = split.pre_rows[:split.n_other]
    new = torch.cat([
        rows24,
        old[:, G_GID:G_GID + 1],
        torch.where(deg, old[:, G_B0X:G_B0X + 3], amin[idx]),
        torch.where(deg, old[:, G_B1X:G_B1X + 3], amax[idx]),
        scene.mat_color[idx],
        scene.mat_ambient[idx, None],
        scene.mat_diffuse[idx, None],
        scene.mat_specular[idx, None],
        scene.mat_fresnel[idx, None],
        scene.mat_shininess[idx, None],
        old[:, G_RID:G_RID + 1],
        ], dim=1)
    new = torch.cat([new, split.pre_rows[split.n_other:]])
    return split.replace_tables(pre_rows=new.contiguous())


@torch.no_grad()
def update_tri_rows(split: SplitScene, scene: FlatScene) -> SplitScene:
    """Refresh the triangle rows from the current scene (same row order)
    and refit the triangle tree's node boxes bottom-up on the tables'
    device: leaf boxes by a segment min/max over the rows, node boxes as
    the union of the leaves under them, so the walk stays exact (any
    containing tree is). The plane columns are whatever the scene
    carries (the stale-plane quirk of an animation that does not refresh
    them). T_RID is carried forward. The result is detached."""
    if split.n_tri == 0:
        return split
    _need_refit(split)
    gids = split.tri_gids.long()
    p1, p2, p3 = scene.tri_p1[gids], scene.tri_p2[gids], scene.tri_p3[gids]
    e1 = p2 - p1
    e2 = p3 - p1
    d00 = _dot3(e1, e1)
    d01 = _dot3(e1, e2)
    d11 = _dot3(e2, e2)
    denom = d00 * d11 - d01 * d01
    z = denom == 0
    safe = torch.where(z, 1.0, denom)
    s0 = _dot3(p1, e1)
    s1 = _dot3(p1, e2)
    r11 = torch.where(z, 0.0, d11 / safe)
    r01 = torch.where(z, 0.0, d01 / safe)
    r00 = torch.where(z, 0.0, d00 / safe)
    col = lambda x: x[:, None]   # noqa: E731
    tri = torch.cat([
        scene.plane_normal[gids], col(scene.plane_d[gids]),
        e1, e2, p1,
        col(s0), col(s1), col(r11), col(r01), col(r00),
        col(split.tri_gids.to(torch.float32)),
        scene.mat_color[gids],
        col(scene.mat_ambient[gids]), col(scene.mat_diffuse[gids]),
        col(scene.mat_specular[gids]), col(scene.mat_fresnel[gids]),
        col(scene.mat_shininess[gids]),
        split.tri_rows[:split.n_tri, T_RID:T_RID + 1],
        col(r11) * e1 - col(r01) * e2, col(r11 * s0 - r01 * s1),
        col(r00) * e2 - col(r01) * e1, col(r00 * s1 - r01 * s0),
        ], dim=1)
    tri = torch.cat([tri, split.tri_rows[split.n_tri:]])

    # leaf boxes: a segment min/max over the rows; node boxes: the union
    # of the leaves whose row range lies in the node's
    tmin = torch.minimum(torch.minimum(p1, p2), p3)
    tmax = torch.maximum(torch.maximum(p1, p2), p3)
    seg = split.tri_leaf_id[:split.n_tri].long()[:, None].expand(-1, 3)
    lmin = torch.full((split.n_leaf, 3), torch.inf, device=tri.device)
    lmax = torch.full((split.n_leaf, 3), -torch.inf, device=tri.device)
    lmin = lmin.scatter_reduce(0, seg, tmin, "amin", include_self=False)
    lmax = lmax.scatter_reduce(0, seg, tmax, "amax", include_self=False)
    rows = split.nodes.shape[0]
    lo, hi = split.node_lo[:rows], split.node_hi[:rows]
    nonempty = (hi > lo)[:, None]
    contained = ((split.leaf_lo[None, :] >= lo[:, None])
                 & (split.leaf_hi[None, :] <= hi[:, None]) & nonempty)
    c3 = contained[:, :, None]
    nmin = torch.where(c3, lmin[None], INF).amin(1)
    nmax = torch.where(c3, lmax[None], -INF).amax(1)
    nodes = torch.cat([torch.where(nonempty, nmin, 0.0),
                       torch.where(nonempty, nmax, 0.0),
                       torch.zeros((rows, 2), device=tri.device)], dim=1)
    return split.replace_tables(tri_rows=tri.contiguous(),
                                nodes=nodes.contiguous())


def update_dynamic(split: SplitScene, scene: FlatScene) -> SplitScene:
    """Refresh both sides for an arbitrary animation or fit step: the
    pre-pass rows, then the triangle rows with the tree's refit."""
    return update_tri_rows(update_pre_rows(split, scene), scene)
