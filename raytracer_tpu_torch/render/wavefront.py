"""The BVH wavefront renderer (port of ``raytracer_tpu/render/wavefront.py``),
the reference's useBVH=true frame (intersectScene2, gpu_shader.comp:380-430).

Every ray lane keeps one DFS pointer into the skip-pointer ``LinearBVH``
plus its progress inside a leaf. One step of ``walk`` advances every lane
by one unit of work (a box test on entering a node, or one shape test
inside a leaf), as tensor ops over the lanes; lanes that finish (pointer
at m) drop out, and the walk ends when none is left. Where every lane is
inside a leaf, the steps up to the first leaf's end are shape tests only
and run as one batch, with the same result per lane. The visited-leaf set
is the reference's stack walk (no ordering, no culling), so the closest
hits agree with the brute-force oracle. The JAX package runs the same
walk in XLA and has no Pallas kernel for it: here it is the independent
oracle that the packet and brute-force kernels are held against on the
card, not a fast path.

``walk`` is also the plain version of the packet renderer's kernels
(render/packet.py): with ``cull`` it skips subtrees whose entry lies
beyond the lane's best hit (nodes flagged cullable only), and with
``max_t`` it is the any-hit shadow query.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.camera import camera_rays
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.geom.direct import INF, div_rn
from raytracer_tpu_torch.render import shading, whitted


# Lane x row pairs of one batched run of shape tests (bounds temporaries).
BATCH_PAIRS = 1 << 20


@dataclasses.dataclass
class Tree:
    """A tree's tables on one device (the reference median tree's, or an
    LBVH rebuilt on the card), as the packet kernels read them:
    leaf_start/leaf_count/skip (m,) int32; nodes (m, 8) f32, box min xyz,
    max xyz, the cull flag (1.0 cullable) and a zero column; rows (K,
    PACK_WIDTH) f32, the packed shape rows in DFS-leaf order."""

    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    skip: torch.Tensor
    nodes: torch.Tensor
    rows: torch.Tensor

    def __post_init__(self):
        # The kernels trust these tables: refuse leaves that run past the
        # rows and skip pointers that do not move forward.
        _check_tables(self.leaf_start, self.leaf_count, self.skip,
                      self.nodes.shape[0], self.rows.shape[0])

    @property
    def m(self) -> int:
        return self.leaf_start.shape[0]

    @staticmethod
    def make(bvh, rows_perm: torch.Tensor, cull_flags=None) -> "Tree":
        """From a LinearBVH and its DFS-ordered rows, on the rows' device;
        ``cull_flags`` (m,) fills node column 6. The tables are assembled
        on that device. A tree built on the host is checked there first."""
        dev = rows_perm.device
        ints = (bvh.leaf_start, bvh.leaf_count, bvh.skip)
        if bvh.leaf_start.device.type == "cpu":
            _check_tables(*ints, bvh.num_nodes, rows_perm.shape[0])
        m = bvh.num_nodes
        flags = (torch.zeros(m, dtype=torch.float32, device=dev)
                 if cull_flags is None else
                 torch.as_tensor(cull_flags, dtype=torch.float32).to(dev))
        nodes = torch.cat([bvh.bounds.to(device=dev, dtype=torch.float32),
                           flags[:, None],
                           torch.zeros((m, 1), dtype=torch.float32,
                                       device=dev)], dim=1)
        return Tree(*(x.to(device=dev, dtype=torch.int32).contiguous()
                      for x in ints),
                    nodes=nodes.contiguous(),
                    rows=rows_perm.to(torch.float32).contiguous())


def _check_tables(leaf_start, leaf_count, skip, m_nodes: int, k: int):
    """Leaf ranges inside the k rows, skip pointers forward and at most m.
    On the host this raises ValueError; on the card it queues
    ``torch._assert_async`` checks, so a tree rebuilt every frame is
    checked without a copy to the host (a failed check stops the card's
    context)."""
    m = leaf_start.shape[0]
    if not (leaf_count.shape[0] == skip.shape[0] == m == m_nodes):
        raise ValueError("tree tables of different lengths")
    if m == 0:
        return
    ls, lc, sk = (x.to(torch.int64) for x in (leaf_start, leaf_count, skip))
    leaves_ok = (((ls + lc).amax() <= k) & (ls.amin() >= 0)
                 & (lc.amin() >= 0))
    skip_ok = ((sk > torch.arange(m, device=sk.device)).all()
               & (sk.amax() <= m))
    if sk.device.type == "cpu":
        if not bool(leaves_ok):
            raise ValueError("leaf ranges run outside the rows")
        if not bool(skip_ok):
            raise ValueError("skip pointers must point forward, up to m")
    else:
        torch._assert_async(leaves_ok, "leaf ranges run outside the rows")
        torch._assert_async(skip_ok,
                            "skip pointers must point forward, up to m")


def walk(tree: Tree, o: torch.Tensor, d: torch.Tensor, use_mt: bool,
         cull: bool = False, max_t: Optional[torch.Tensor] = None):
    """Walk R rays o, d (R, 3) f32 through ``tree``, one unit of work per
    lane and step; a run of steps in which every lane is inside a leaf
    (shape tests only) is evaluated as one. Closest mode returns (t,
    row): t INF and row 0 on a miss, row the local (DFS-leaf order) index
    of the first row that attains the least t (strict t < t_best).
    Any-hit mode (``max_t`` (R,) given) returns the bool mask of rays with
    an inner hit at t < max_t; a lane ends at its first such hit. With
    ``cull``, a node flagged cullable is entered only if its entry tmin <=
    the lane's best t (or max_t)."""
    n, dev = o.shape[0], o.device
    m, k_rows = tree.m, tree.rows.shape[0]
    any_hit = max_t is not None
    t_out = torch.full((n,), INF, dtype=torch.float32, device=dev)
    row_out = torch.zeros(n, dtype=torch.int64, device=dev)
    occ_out = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0 or m == 0:
        return occ_out if any_hit else (t_out, row_out.to(torch.int32))
    ints = torch.stack([tree.leaf_start, tree.leaf_count, tree.skip],
                       1).to(torch.int64)
    # Per-lane state of the lanes still walking. A ray whose direction is
    # exactly zero hits no shape (every n.d, d x e2 and the sphere's b^2 -
    # 4ac are 0 or NaN) but every box (1/0 = inf puts each slab at +-inf):
    # it misses at once instead of walking the whole tree. The whitted
    # loop's shadow rays of ended lanes are such rays.
    lanes = torch.nonzero((d != 0).any(1)).squeeze(1)
    if lanes.numel() == 0:
        return occ_out if any_hit else (t_out, row_out.to(torch.int32))
    lo, ld = o[lanes], d[lanes]
    inv = 1.0 / ld
    lim = max_t[lanes] if any_hit else t_out[lanes]
    row = torch.zeros_like(lanes)
    ptr = torch.zeros_like(lanes)
    k = torch.zeros_like(lanes)
    while True:
        ls, lc, sk = ints[ptr].unbind(1)
        entering = k == 0
        if bool(entering.any()):
            # one unit per lane: the box test where a lane enters a node
            # (and, entering a leaf, its first row), or the next row
            nb = tree.nodes[ptr]
            tmin, tmax = rowwise.slab(nb, lo, inv)
            probe = (tmax >= tmin) & (tmax > 0)
            if cull:
                probe = probe & ((nb[:, 6] == 0) | (tmin <= lim))
            is_leaf = lc > 0
            in_leaf = (k > 0) | (entering & probe & is_leaf)
            ptr = torch.where(in_leaf, ptr, torch.where(probe & ~is_leaf,
                                                        ptr + 1, sk))
            n_rows = in_leaf.to(torch.int64)
        else:
            # every lane is inside a leaf: the next steps, up to the first
            # leaf's end, are all shape tests, and run as one
            in_leaf = ~entering
            n_rows = (lc - k).amin().clamp_max(max(1, BATCH_PAIRS
                                                   // lanes.numel()))
        t, j, hit = _leaf_rows(tree, ls + k, n_rows, lo, ld, lim, use_mt)
        if not any_hit:
            lim = torch.where(hit, t, lim)
            row = torch.where(hit, ls + k + j, row)
        k = torch.where(in_leaf, k + n_rows, k)
        leaf_done = in_leaf & (k >= lc)
        ptr = torch.where(leaf_done, sk, ptr)
        k = torch.where(leaf_done, 0, k)
        if any_hit:
            ptr = torch.where(hit, m, ptr)
        done = ptr >= m
        n_done = int(done.sum())
        if n_done:
            ids = lanes[done]
            if any_hit:
                occ_out[ids] = hit[done]
            else:
                t_out[ids] = lim[done]
                row_out[ids] = row[done]
            if n_done == lanes.numel():
                break
            keep = ~done
            lanes, lo, ld, inv, lim, row, ptr, k = (
                x[keep] for x in (lanes, lo, ld, inv, lim, row, ptr, k))
    return occ_out if any_hit else (t_out, row_out.to(torch.int32))


def _leaf_rows(tree: Tree, first, n_rows, o, d, lim, use_mt: bool):
    """Rows first .. first + n_rows - 1 of each lane (n_rows a lane count
    (L,), 0 or 1, or one count for all), as a run of strict t < lim
    updates: (t, j, hit), the least inner t below lim, the offset of the
    first row that attains it, and whether there is one."""
    width = int(n_rows.max())
    if width == 0:
        return lim, torch.zeros_like(first), torch.zeros_like(first,
                                                             dtype=torch.bool)
    j = torch.arange(width, device=first.device)
    take = j < n_rows.reshape(-1, 1)
    g = (first[:, None] + j).clamp_max(tree.rows.shape[0] - 1)
    t, inner = rowwise.intersect_rows(tree.rows[g], o[:, None], d[:, None],
                                      use_mt)
    ok = take & inner & (t < lim[:, None])
    best, j = torch.min(torch.where(ok, t, INF), dim=1)
    return best, j, ok.any(1)


def make_closest_hit(bvh, rows_perm: torch.Tensor, perm: torch.Tensor,
                     use_mt: bool = False):
    """closest_hit(o, d) -> (t, sid, hit) over the tree, as the JAX
    ``make_closest_hit``: rows_perm (K, PACK_WIDTH) are the packed rows in
    DFS-leaf order, perm (K,) their shape ids; sid is 0 on a miss."""
    tree = Tree.make(bvh, rows_perm)
    perm = perm.to(device=rows_perm.device, dtype=torch.int64)

    def closest_hit(o, d):
        t, row = walk(tree, o, d, use_mt)
        hit = t < INF
        sid = torch.where(hit, perm[row.long()], 0).to(torch.int32)
        return t, sid, hit

    return closest_hit


def render(scene, bvh, camera, light, cfg: RenderConfig,
           device=None) -> torch.Tensor:
    """Render (H, W, 3) f32 with the wavefront BVH walk: the JAX
    renderer's frame. ``bvh`` is the reference LinearBVH. As in the JAX
    ``lax.map``, the rays are traced in chunks of ``cfg.ray_chunk`` (the
    last one padded with o = 0, d = 1); ``device`` None means "cuda",
    "cpu" runs the same tensor ops there."""
    dev = resolve_device(device)
    scene, camera, light = scene.to(dev), camera.to(dev), light.to(dev)
    h, w = cfg.height, cfg.width
    o, d = camera_rays(camera, w, h)
    ys = div_rn(torch.arange(h, dtype=torch.float32, device=dev), h)
    bg = torch.broadcast_to(shading.background(ys)[:, None, :], (h, w, 3))
    rows_perm = rowwise.pack_rows(scene)[bvh.perm.to(dev).long()]
    closest = make_closest_hit(bvh, rows_perm, bvh.perm, cfg.use_mt)

    o, d, bg = (x.reshape(-1, 3) for x in (o, d, bg))
    n_rays = o.shape[0]
    chunk = min(cfg.ray_chunk, n_rays)
    o, d, bg = whitted.pad_rays(chunk, o, d, bg)
    colors = [whitted.trace(scene, light, closest,
                            *(x[c:c + chunk].contiguous() for x in (o, d, bg)),
                            cfg)
              for c in range(0, o.shape[0], chunk)]
    return torch.cat(colors)[:n_rays].reshape(h, w, 3)
