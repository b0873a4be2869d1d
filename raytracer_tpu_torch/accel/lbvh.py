"""Linear BVH built with tensor ops on the shapes' device, for the
per-frame rebuild of animated scenes (port of
``raytracer_tpu/accel/lbvh.py``).

The reference answers animation with updateBVH's grow-only refit
(src/main.cpp:1068-1077); this rebuilds the tree every frame instead:

  1. 30-bit Morton codes of the shape centers, quantized into the scene
     AABB;
  2. one stable sort of the codes (ties keep the shapes' order);
  3. Karras 2012 radix-tree construction: every internal node's leaf
     range from closed-form common-prefix queries, with equal codes told
     apart by their sorted positions;
  4. DFS / skip-pointer linearization without a tree walk: preorder is the
     sort by (range start ascending, range size descending), and a node's
     skip pointer is the first DFS position whose start lies past its end;
  5. node AABBs as range min / max queries over the sorted leaf boxes (a
     log2(n) sparse table).

No step copies to the host, so a frame's rebuild never waits for the
card. The output is the ``LinearBVH`` of ``accel/linearize.py`` on the
inputs' device: 2n - 1 nodes, each leaf one shape. Given the same f32
inputs it equals the JAX package's jitted build table for table.

The JAX build's Morton arithmetic is uint32; here it is carried in int64
and masked to 32 bits (PyTorch has no ``>>`` on uint32 on the CPU). The
JAX build also runs a binary search for each node's split position whose
result it never reads (its comment at lbvh.py:151-154: the ranges imply
the splits); XLA drops that search as dead code, and it is not ported.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.accel.linearize import LinearBVH

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (int64) so there are 2 zeros between
    each (the Morton bit-interleave helper), in uint32 arithmetic."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton_codes(centers: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                 ) -> torch.Tensor:
    """30-bit Morton code (int64) per center (N, 3) f32, quantized into
    [lo, hi]."""
    extent = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((centers - lo) / extent, 0.0, 0.999999)
    xyz = (q * 1024.0).to(torch.int64)   # truncation, as astype(uint32)
    return (_expand_bits(xyz[:, 0]) * 4 + _expand_bits(xyz[:, 1]) * 2
            + _expand_bits(xyz[:, 2])) & _U32


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of x (int64, 0 <= x < 2^32): the
    bits below the highest set bit smeared on, then a SWAR popcount."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & _U32) >> 24
    return 32 - pop


def np_ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


@torch.no_grad()
def build_lbvh(aabb_min: torch.Tensor, aabb_max: torch.Tensor,
               centers: torch.Tensor) -> LinearBVH:
    """Build a LinearBVH over N shapes on the inputs' device; all inputs
    (N, 3) f32. Fixed step counts and no host copy, so a frame can call it
    without waiting for the card."""
    n = centers.shape[0]
    dev = centers.device
    i32 = torch.int32
    if n == 1:
        return LinearBVH(bounds=torch.cat([aabb_min, aabb_max], dim=1),
                         leaf_start=torch.zeros(1, dtype=i32, device=dev),
                         leaf_count=torch.ones(1, dtype=i32, device=dev),
                         skip=torch.ones(1, dtype=i32, device=dev),
                         perm=torch.zeros(1, dtype=i32, device=dev))

    lo = aabb_min.amin(0)
    hi = aabb_max.amax(0)
    codes = morton_codes(centers, lo, hi)
    # a stable sort: equal codes keep the shapes' order, as the JAX
    # package's lax.sort of (code, index)
    codes_s, perm = torch.sort(codes, stable=True)

    lmin = aabb_min.index_select(0, perm)
    lmax = aabb_max.index_select(0, perm)

    def delta(i, j):
        """Common-prefix length of sorted keys i and j (-1 out of range);
        equal codes extend it with their positions' common prefix."""
        ok = (j >= 0) & (j < n)
        jj = j.clamp(0, n - 1)
        x = codes_s[i] ^ codes_s[jj]
        base = torch.where(x == 0, 32 + _clz32(i ^ jj), _clz32(x))
        return torch.where(ok, base, -1)

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # the range length: doubling, then a binary search (fixed 32 + 34
    # steps, the JAX package's counts; the extra steps change nothing)
    lmax_len = torch.full_like(i, 2)
    for _ in range(32):
        more = delta(i, i + lmax_len * d) > delta_min
        lmax_len = torch.where(more, lmax_len * 2, lmax_len)
    ln = torch.zeros_like(i)
    t = lmax_len // 2
    for _ in range(34):
        ok = delta(i, i + (ln + t) * d) > delta_min
        ln = torch.where(ok, ln + t, ln)
        t = torch.clamp_min(t // 2, 1)
    j = i + ln * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # 2n - 1 nodes: internal node i covers [first, last], leaf k [k, k]
    leaves = torch.arange(n, dtype=torch.int64, device=dev)
    starts = torch.cat([first, leaves])
    ends = torch.cat([last, leaves])
    sizes = ends - starts
    # preorder: by start ascending, then size descending ((start, size) is
    # unique per node, so one int64 key orders them)
    _, dfs = torch.sort(starts * (2 * n) + (n - sizes - 1), stable=True)
    d_start = starts[dfs]
    d_end = ends[dfs]
    d_size = sizes[dfs]

    # skip = the first DFS position whose start > end (starts ascend)
    skip = torch.searchsorted(d_start, d_end + 1, right=False)

    # node AABBs: range min / max over the sorted leaf boxes
    levels = max(np_ceil_log2(n), 1)
    st_min, st_max = [lmin], [lmax]
    for k in range(levels):
        half = 1 << k
        prev_min, prev_max = st_min[-1], st_max[-1]
        st_min.append(torch.minimum(prev_min, torch.cat(
            [prev_min[half:], prev_min.new_full((half, 3), torch.inf)])))
        st_max.append(torch.maximum(prev_max, torch.cat(
            [prev_max[half:], prev_max.new_full((half, 3), -torch.inf)])))
    st_min = torch.stack(st_min)   # (levels + 1, n, 3)
    st_max = torch.stack(st_max)

    # the level of a span: floor(log2) of its f32 value, as the JAX build
    # takes it (exact for every span up to 2^20)
    span = (d_size + 1).to(torch.float32)
    k = torch.floor(torch.log2(span)).to(torch.int64).clamp(0, levels)
    right = torch.clamp_min(d_end - (1 << k) + 1, 0)
    bmin = torch.minimum(st_min[k, d_start], st_min[k, right])
    bmax = torch.maximum(st_max[k, d_start], st_max[k, right])

    is_leaf = d_size == 0
    return LinearBVH(bounds=torch.cat([bmin, bmax], dim=1),
                     leaf_start=torch.where(is_leaf, d_start, 0).to(i32),
                     leaf_count=is_leaf.to(i32), skip=skip.to(i32),
                     perm=perm.to(i32))


def node_cullable_flags_device(lin: LinearBVH, w_deg_mask: torch.Tensor
                               ) -> torch.Tensor:
    """(m,) f32 on the tree's device: 1.0 where a node's DFS subtree holds
    no degenerate (infinite-plane) wall. ``w_deg_mask``: (N,) bool per
    shape. Tensor code, for the per-frame rebuild: the subtree of node i is
    the DFS range [i, skip[i]), so a prefix sum over the leaves' counts
    answers it. On one-shape leaves (the LBVH's) this is the JAX function;
    it also counts every shape of a larger leaf."""
    deg = w_deg_mask.to(device=lin.perm.device,
                        dtype=torch.int64)[lin.perm.long()]
    zero = deg.new_zeros(1)
    cum = torch.cat([zero, torch.cumsum(deg, 0)])
    start, count = lin.leaf_start.long(), lin.leaf_count.long()
    leaf_deg = cum[start + count] - cum[start]
    pref = torch.cat([zero, torch.cumsum(leaf_deg, 0)])
    m = lin.bounds.shape[0]
    sub = pref[lin.skip.long()] - pref[:m]
    return (sub == 0).to(torch.float32)
