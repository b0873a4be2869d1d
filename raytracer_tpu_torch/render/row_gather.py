"""The inverse step's per-ray row gather and its backward: ``gather``
returns the column groups of table[sid] as separate tensors.

Where autograd records the gather on the card (``engages``: a CUDA table
that requires grad, grad mode on), it runs through an autograd function:
the forward launches ``gather_rows_kernel`` (a copy, bit for bit
``index_select``, into one (W, R) array whose rows are the groups) and the
backward ``row_grads_kernel`` (the rays' gradients summed by shape id
within a warp, one atomic add a distinct id and column, rays whose
gradients are all zero left out). Elsewhere (the CPU, no-grad renders,
the packet, brute-force and wavefront renderers, the plain versions the
kernels are held against) the groups are views of an ``index_select``
row, as before. The autograd function runs the plain versions,
``index_select`` and ``index_add_``, on a CPU tensor.

Groups are given by their widths, in column order: the attribute table's
``ATTR_GROUPS`` (n, color, ka, kd, ks, kf, shininess, center, is_sphere)
and the packed rows' ``PACK_GROUPS`` (each of the 24 columns). A group of
width 1 is an (R,) tensor, a wider one (R, w).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from raytracer_tpu_torch.geom.rowwise import PACK_WIDTH
from raytracer_tpu_torch.render import kernels

ATTR_GROUPS = (3, 3, 1, 1, 1, 1, 1, 3, 1)
PACK_GROUPS = (1,) * PACK_WIDTH
KERNEL_WIDTHS = (15, 24)   # the tables the kernels are built for


def engages(table: torch.Tensor) -> bool:
    """Whether a gather from ``table`` takes the kernels: on the card, with
    grad mode on and a table that requires grad."""
    return table.is_cuda and table.requires_grad and torch.is_grad_enabled()


def _shape(n: int, w: int):
    return (n,) if w == 1 else (n, w)


def _groups(x: torch.Tensor, widths: Sequence[int]):
    """The column groups of x (n, W), views of it."""
    if all(w == 1 for w in widths):
        return x.unbind(1)
    out, c = [], 0
    for w in widths:
        out.append(x[:, c] if w == 1 else x[:, c:c + w])
        c += w
    return tuple(out)


def gather_rows_plain(table: torch.Tensor, sid: torch.Tensor,
                      widths: Sequence[int]):
    """Plain version of ``gather_rows_kernel``: the groups of
    table.index_select(0, sid), views of that row."""
    return _groups(table.index_select(0, sid.long()), widths)


def gather_rows(table: torch.Tensor, sid: torch.Tensor,
                widths: Sequence[int]):
    """The column groups of table[sid]: table (N, W) f32, sid (R,) int32
    row ids, ``widths`` summing to W. On a CUDA tensor this launches
    ``gather_rows_kernel`` into one (W, R) array and returns views of its
    rows; on a CPU tensor it runs ``gather_rows_plain``."""
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_plain(table, sid, widths)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    w = sum(widths)
    if w not in KERNEL_WIDTHS:
        raise ValueError(f"gather_rows: {w} columns, the kernel takes "
                         f"{KERNEL_WIDTHS}")
    kernels.check_tensor("table", table, torch.float32, dev, (None, w))
    kernels.check_tensor("sid", sid, torch.int32, dev, (None,))
    n = sid.shape[0]
    out = torch.empty((w, n), dtype=torch.float32, device=dev)
    if n:
        if table.shape[0] == 0:
            raise ValueError("gather_rows: the table is empty")
        kernels.launch("gather_rows_kernel", "rt_gather_rows", dev,
                       table.data_ptr(), table.shape[0], w, sid.data_ptr(), n,
                       out.data_ptr())
        gather_rows.launches += 1
    return _groups(out.T, widths)


gather_rows.launches = 0


def row_grads_plain(grads, sid: torch.Tensor, n_tab: int,
                    widths: Sequence[int]) -> torch.Tensor:
    """Plain version of ``row_grads_kernel``: the (n_tab, W) gradient of
    the table, ``index_add_`` of the groups' gradients (zero for None)."""
    like = next(g for g in grads if g is not None)
    n = sid.shape[0]
    cols = torch.cat([like.new_zeros(n, w) if g is None else g.reshape(n, w)
                      for g, w in zip(grads, widths)], 1)
    return like.new_zeros(n_tab, sum(widths)).index_add_(0, sid.long(), cols)


def _columns(grads, widths, n: int, dev):
    """Each column's pointer (None: no gradient) and stride in elements,
    wherever its gradient tensor keeps it."""
    ptrs, strides = [], []
    for k, (g, w) in enumerate(zip(grads, widths)):
        if g is None:
            ptrs += [None] * w
            strides += [0] * w
            continue
        if (g.dtype != torch.float32 or g.device != dev
                or g.shape != _shape(n, w)):
            raise ValueError(f"row_grads: grads[{k}] is {g.dtype} "
                             f"{tuple(g.shape)} on {g.device}, expected "
                             f"float32 {_shape(n, w)} on {dev}")
        col = g.stride(1) if w > 1 else 0
        ptrs += [g.data_ptr() + 4 * j * col for j in range(w)]
        strides += [g.stride(0)] * w
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides))


def row_grads(grads, sid: torch.Tensor, n_tab: int, widths: Sequence[int],
              stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (n_tab, W) table gradient of ``gather_rows``: ``grads`` the
    groups' gradients in any strides (None where a group has none), sid
    (R,) int32. On a CUDA tensor this launches ``row_grads_kernel``; on a
    CPU tensor it runs ``row_grads_plain``. ``stats``, an int64 (2,)
    tensor on the card, receives the rays summed (those with a gradient
    that is not zero) and the row adds issued: their ratio is the rays a
    warp's sum took into one add."""
    dev = sid.device
    if dev.type == "cpu":
        return row_grads_plain(grads, sid, n_tab, widths)
    if dev.type != "cuda":
        raise ValueError(f"row_grads: unsupported device {dev}")
    w = sum(widths)
    if w not in KERNEL_WIDTHS:
        raise ValueError(f"row_grads: {w} columns, the kernel takes "
                         f"{KERNEL_WIDTHS}")
    n = sid.shape[0]
    kernels.check_tensor("sid", sid, torch.int32, dev, (None,))
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (2,))
    ptrs, strides = _columns(grads, widths, n, dev)
    out = torch.zeros((n_tab, w), dtype=torch.float32, device=dev)
    if n:
        if n_tab == 0:
            raise ValueError("row_grads: the table is empty")
        kernels.launch("row_grads_kernel", "rt_row_grads", dev, ptrs,
                       strides, w, sid.data_ptr(), n, n_tab, out.data_ptr(),
                       None if stats is None else stats.data_ptr())
        row_grads.launches += 1
    return out


row_grads.launches = 0


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with ``row_grads`` as its backward. Saves only sid:
    the backward needs no gathered value."""

    @staticmethod
    def forward(ctx, table, sid, widths):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(sid)
        ctx.n_tab, ctx.widths = table.shape[0], widths
        return gather_rows(table, sid, widths)

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return None, None, None
        (sid,) = ctx.saved_tensors
        return row_grads(grads, sid, ctx.n_tab, ctx.widths), None, None


def gather_op(table: torch.Tensor, sid: torch.Tensor,
              widths: Sequence[int]):
    """The column groups of table[sid] (``gather_rows``), differentiable in
    ``table`` through ``row_grads``. sid: (R,) row ids, made int32."""
    return _GatherRows.apply(table, sid.to(torch.int32).contiguous(),
                             tuple(widths))


def gather(table: torch.Tensor, sid: torch.Tensor, widths: Sequence[int]):
    """The column groups of table[sid], sid (R,) row ids: ``gather_op``
    where ``engages``; elsewhere views of an ``index_select`` row
    (``gather_rows_plain``), whose backward is ``index_add_``."""
    if engages(table):
        return gather_op(table, sid, widths)
    return gather_rows_plain(table, sid, widths)
