"""The inverse step's row gather (``render/row_gather.py``) on the CPU,
where its autograd function (``gather_op``) runs the plain versions
(``index_select`` forward, ``index_add_`` backward): gradcheck in
float64; the same gradients as the slices of an ``index_select`` row that
the renderers took before it, with every id 0, a group with no gradient
and rays whose gradients are all zero; the differentiable render with the
function forced on; the backward's column pointers for gradients in any
strides; ``intersect_rows`` on a row's columns against the row, bit for
bit. The kernels themselves are held on the card by
tests/test_torch_row_gather_card.py and chip_smoke.py."""

import pytest
import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core.types import normalize
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.geom.aabb import shape_centers_device
from raytracer_tpu_torch.render import row_gather, split_scene, whitted
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.scenes import generate_scene

GROUPS = {"attrs": row_gather.ATTR_GROUPS, "packed": row_gather.PACK_GROUPS}


def _scene():
    sc = generate_scene(1, device="cpu")
    return sc, linearize(build_bvh(sc.flat, sc.bvh_max_depth))


def _table(which, flat):
    return (whitted._attr_table(flat) if which == "attrs"
            else rowwise.pack_rows(flat))


def _sliced(row, widths):
    """The groups as slices of the gathered row, the renderers' former
    code."""
    out, c = [], 0
    for w in widths:
        out.append(row[:, c] if w == 1 else row[:, c:c + w])
        c += w
    return out


@pytest.mark.parametrize("which", sorted(GROUPS))
def test_plain_op_gradcheck(which):
    widths = GROUPS[which]
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(6, sum(widths), dtype=torch.float64,
                        generator=gen).requires_grad_(True)
    sid = torch.tensor([0, 5, 5, 2, 0, 0, 3, 5, 1, 0, 2], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda t: row_gather.gather_op(t, sid, widths), (table,))


CASES = ["every_id_0", "group_without_grad", "rays_with_zero_grads"]


@pytest.mark.parametrize("which", sorted(GROUPS))
@pytest.mark.parametrize("case", CASES)
def test_same_grads_as_slicing(which, case):
    """Weighted sums of the groups of a scene's table at the ids of a ray
    set: the op's gradient equals that of index_select's sliced row."""
    sc, _ = _scene()
    widths = GROUPS[which]
    table = _table(which, sc.flat).detach().requires_grad_(True)
    gen = torch.Generator().manual_seed(11)
    n = 300
    sid = torch.randint(0, table.shape[0], (n,), generator=gen,
                        dtype=torch.int32)
    sid[::3] = 7   # a run of one id, as most rays hit one shape
    if case == "every_id_0":
        sid.zero_()
    weights = [torch.randn(_shape, generator=gen) for _shape in
               ((n,) if w == 1 else (n, w) for w in widths)]
    used = list(range(len(widths)))
    if case == "group_without_grad":
        used.remove(1)
    if case == "rays_with_zero_grads":
        for x in weights:
            x[40:120] = 0.0

    def loss(groups):
        return sum((groups[k] * weights[k]).sum() for k in used)

    want, = torch.autograd.grad(
        loss(_sliced(table.index_select(0, sid.long()), widths)), table)
    got, = torch.autograd.grad(loss(row_gather.gather_op(table, sid,
                                                         widths)), table)
    assert torch.equal(got, want)
    assert row_gather.gather_rows.launches == 0
    assert row_gather.row_grads.launches == 0


def test_forced_gather_renders_the_same():
    """The differentiable render on the CPU with the autograd function
    forced on (its plain versions) gives the image and the gradients of
    the views of an index_select row, bit for bit."""
    sc, lin = _scene()
    split = split_scene.prepare(sc.flat, lin, device="cpu")
    cfg = RenderConfig(width=24, height=18, max_bounces=3)

    def run():
        c = sc.flat.sphere_center.clone().requires_grad_(True)
        m = sc.flat.mat_color.clone().requires_grad_(True)
        s = sc.flat.replace(sphere_center=c, mat_color=m)
        img = split_mod.render(s, lin, sc.camera, sc.light, cfg, split=split,
                               differentiable=True, device="cpu")
        w = torch.linspace(-1.0, 1.0, img.numel()).reshape(img.shape)
        return (img,) + torch.autograd.grad((img * w).sum(), [c, m])

    want = run()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(row_gather, "engages", lambda table: True)
        got = run()
    finally:
        mp.undo()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[1].abs().max() > 0 and want[2].abs().max() > 0


def test_gather_off_the_card_is_index_select_views():
    """Where the kernels do not engage, the groups are views of one
    index_select row, and the function records no gather of its own."""
    sc, _ = _scene()
    table = whitted._attr_table(sc.flat).detach().requires_grad_(True)
    sid = torch.tensor([3, 0, 0, 7, 3], dtype=torch.int32)
    assert not row_gather.engages(table)
    groups = row_gather.gather(table, sid, row_gather.ATTR_GROUPS)
    row = table.index_select(0, sid.long())
    assert all(g._base is groups[0]._base for g in groups)
    assert all(torch.equal(g, w) for g, w in
               zip(groups, _sliced(row, row_gather.ATTR_GROUPS)))
    assert "GatherRows" not in type(groups[0].grad_fn).__name__


@pytest.mark.parametrize("layout", ["contiguous", "columns_first",
                                    "expanded"])
def test_column_pointers_follow_strides(layout):
    """row_grads hands the kernel each column where its gradient tensor
    keeps it: a contiguous group, a transposed or strided one (the layout
    of the kernel's own outputs) and a broadcast one (stride 0), without a
    copy;
    None groups give null columns."""
    n, widths = 10, row_gather.ATTR_GROUPS
    grads = []
    for k, w in enumerate(widths):
        if k == 2:
            grads.append(None)
            continue
        shape = (n,) if w == 1 else (n, w)
        if layout == "contiguous":
            g = torch.randn(shape)
        elif layout == "columns_first":   # a 1-wide group: every 2nd
            g = (torch.randn(w, n).T if w > 1 else torch.randn(2 * n)[::2])
        else:
            g = torch.randn(shape[1:] or (1,)).expand(shape)
        grads.append(g)
    ptrs, strides = row_gather._columns(grads, widths, n,
                                        torch.device("cpu"))
    c = 0
    for g, w in zip(grads, widths):
        for j in range(w):
            if g is None:
                assert ptrs[c] is None and strides[c] == 0
            else:
                col = g if w == 1 else g[:, j]
                assert ptrs[c] == col.data_ptr()
                assert strides[c] == col.stride(0)
            c += 1
    assert c == sum(widths)
    with pytest.raises(ValueError):
        row_gather._columns([g.double() if g is not None else None
                             for g in grads], widths, n, torch.device("cpu"))


@pytest.mark.parametrize("use_mt", [False, True])
def test_intersect_rows_on_columns(use_mt):
    """intersect_rows on the 24 gathered columns equals intersect_rows on
    the gathered row, bit for bit, on every shape of scene 1."""
    sc, _ = _scene()
    rows = rowwise.pack_rows(sc.flat)
    gen = torch.Generator().manual_seed(5)
    n = 4096
    sid = torch.randint(0, rows.shape[0], (n,), generator=gen,
                        dtype=torch.int32)
    # rays from around the camera toward a point near each ray's shape
    aim = shape_centers_device(sc.flat)[sid.long()]
    o = sc.camera.position + torch.randn(n, 3, generator=gen)
    d = normalize(aim + 0.05 * torch.randn(n, 3, generator=gen) - o,
                  eps=1e-30)
    t_row, in_row = rowwise.intersect_rows(rows.index_select(0, sid.long()),
                                           o, d, use_mt)
    cols = row_gather.gather_rows(rows, sid, row_gather.PACK_GROUPS)
    t_col, in_col = rowwise.intersect_rows(cols, o, d, use_mt)
    assert torch.equal(t_col, t_row) and torch.equal(in_col, in_row)
    assert in_row.sum() > n // 10 and not in_row.all()
