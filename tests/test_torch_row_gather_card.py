"""The inverse step's row-gather kernels on the card (``gather_rows_kernel``
and ``row_grads_kernel``, ``render/row_gather.py``), on the ray ids of
full-HD frames of scenes 1 and 2: every bounce's hit and shadow queries
of a 1920x1080x3 trace, a map with every ray on row 0 and one with every
ray on the scene's most hit row. Skipped without a card; on the card,
from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_row_gather_card.py

(``--noconftest``: tests/conftest.py sets up the JAX reference, which this
file does not import.)

The forward is a copy and is compared bit for bit with ``index_select``.
The backward's sums are taken in another order than ``index_add_``'s
(a tree over a warp's lanes of one id, then atomics in the order the
warps arrive, where index_add_ adds each ray by its own atomic): on
gradients that are multiples of 2**-10 small enough that every partial
sum is exact in f32 the two must agree bit for bit. On a fit's own
gradients the order decides the rounding, and index_add_ is no
yardstick there: on scene 1's floor row (1.25 million rays of bounce 1)
its f32 sum lies 1.8e-3 of the row's summed magnitudes from the float64
sum of the same gradients, the kernel's 2.6e-5 (NVIDIA H100 80GB HBM3).
So each row of the kernel's result is held within ROW_RTOL of that
row's summed magnitudes (the norm of sum |g|, the scale of any order's
rounding) of the float64 sum.
"""

import functools

import pytest
import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.geom import rowwise
from raytracer_tpu_torch.render import row_gather, split_scene, whitted
from raytracer_tpu_torch.render import split as split_mod
from raytracer_tpu_torch.scenes import generate_scene

pytestmark = pytest.mark.card

W, H, BOUNCES = 1920, 1080, 3
ROW_RTOL = 1e-4
# the leaves' gradients against index_select's path: its index_add_ rows
# are off by up to 1.8e-3 (above)
LEAF_RTOL = 1e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _scene(which, dev):
    sc = generate_scene(which, aspect=W / H, device=dev)
    lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
    return sc, lin, split_scene.prepare(sc.flat, lin, device=dev)


@functools.lru_cache(maxsize=None)
def _maps(which, dev):
    """{name: (sid int32, hit bool)}: each closest-hit query of a no-grad
    full-HD trace through the differentiable route's kernel (the bounces'
    hit queries and their shadow rays), every ray on row 0, every ray on
    the most hit row, and a partial warp's worth of bounce 1."""
    sc, _, split = _scene(which, dev)
    cfg = RenderConfig(width=W, height=H, max_bounces=BOUNCES)
    closest = split_mod.make_closest_hit(split, cfg)
    calls = []

    def recording(o, d):
        t, sid, hit = closest(o, d)
        calls.append((sid, hit))
        return t, sid, hit

    o, d, bg = split_mod.primary_rays(sc.camera, cfg)
    with torch.no_grad():
        whitted.trace(sc.flat, sc.light, recording, o, d, bg, cfg)
    maps = {f"query{k}": m for k, m in enumerate(calls)}
    sid0, hit0 = calls[0]
    top = torch.bincount(sid0[hit0].long()).argmax().to(torch.int32)
    maps["all_row_0"] = (torch.zeros_like(sid0), hit0)
    maps["all_top_row"] = (torch.full_like(sid0, int(top)),
                           torch.ones_like(hit0))
    n = 4096 + 17
    maps["partial_warp"] = (sid0[:n].contiguous(), hit0[:n].contiguous())
    return maps


def _tables(which, dev):
    sc, _, _ = _scene(which, dev)
    return {"attrs": (whitted._attr_table(sc.flat), row_gather.ATTR_GROUPS),
            "packed": (rowwise.pack_rows(sc.flat).contiguous(),
                       row_gather.PACK_GROUPS)}


def _exact_grads(widths, hit, gen, drop=None, columns_first=False):
    """Gradients of the groups: multiples of 2**-10 in [-2, 2] * 2**-10,
    zero on rays without a hit (as a miss or a parked ray gets), None for
    group ``drop``; with ``columns_first``, each group a view of one
    (W, n) array (the layout of the forward's own groups). Every partial
    sum over up to 2**21 rays is exact."""
    n = hit.shape[0]
    g = torch.randint(-2, 3, (sum(widths), n), generator=gen,
                      device=hit.device).to(torch.float32) / 1024.0
    g = g * hit[None, :]
    if not columns_first:
        g = g.T.contiguous().T
    out, c = [], 0
    for k, w in enumerate(widths):
        out.append(None if k == drop else g[c] if w == 1
                   else g[c:c + w].T)
        c += w
    return out


def _rows_far(got, want, scale, rtol):
    """The rows whose difference exceeds rtol times the row's norm of
    ``scale``, and the largest such ratio."""
    err, norm = (got - want).double().norm(dim=1), scale.double().norm(dim=1)
    worst = float((err / norm.clamp_min(1e-300)).max())
    return torch.nonzero(err > rtol * norm).flatten().tolist()[:5], worst


@pytest.mark.parametrize("which", [1, 2])
def test_forward_is_index_select(card, which):
    for name, (table, widths) in _tables(which, card).items():
        for key, (sid, _) in _maps(which, card).items():
            before = row_gather.gather_rows.launches
            groups = row_gather.gather_rows(table, sid, widths)
            assert row_gather.gather_rows.launches == before + 1
            got = torch.cat([g.reshape(sid.shape[0], -1) for g in groups], 1)
            want = table.index_select(0, sid.long())
            assert torch.equal(got, want), (name, key)


@pytest.mark.parametrize("which", [1, 2])
def test_backward_equals_index_add_and_counts(card, which):
    """Exact gradients: row_grads bit for bit index_add_, with a group
    without gradient or not, in rows or in columns; stats: the rays with a
    gradient that is not zero, and at most one add a ray."""
    gen = torch.Generator(device=card).manual_seed(7 + which)
    for name, (table, widths) in _tables(which, card).items():
        n_tab = table.shape[0]
        for key, (sid, hit) in _maps(which, card).items():
            for drop, columns_first in ((None, False), (1, False),
                                        (1, True)):
                grads = _exact_grads(widths, hit, gen, drop, columns_first)
                stats = torch.zeros(2, dtype=torch.int64, device=card)
                got = row_gather.row_grads(grads, sid, n_tab, widths, stats)
                want = row_gather.row_grads_plain(grads, sid, n_tab, widths)
                assert torch.equal(got, want), (name, key, drop,
                                                 columns_first)
                nonzero = torch.zeros_like(hit)
                for g in grads:
                    if g is not None:
                        nonzero |= (g.reshape(hit.shape[0], -1) != 0).any(1)
                rays, adds = stats.tolist()
                assert rays == int(nonzero.sum()), (name, key, drop)
                assert 0 < adds <= rays or rays == 0, (name, key, drop)


def _fit_step(which, dev):
    """A full-HD loss and its gradients through the differentiable route:
    every sphere's centre (sphere 0 moved by 0.3), every shape's colour
    (shape 0's x 0.8) and the light's position (moved by 0.2), MSE
    against the unmoved scene's image."""
    sc, lin, split = _scene(which, dev)
    cfg = RenderConfig(width=W, height=H, max_bounces=BOUNCES)
    flat, light = sc.flat, sc.light
    with torch.no_grad():
        target = split_mod.render(flat, lin, sc.camera, light, cfg,
                                  split=split, differentiable=True,
                                  device=dev)
    leaves = [torch.cat([flat.sphere_center[:1] + 0.3,
                         flat.sphere_center[1:]]).requires_grad_(True),
              torch.cat([flat.mat_color[:1] * 0.8,
                         flat.mat_color[1:]]).requires_grad_(True),
              (light.position + 0.2).requires_grad_(True)]
    s = flat.replace(sphere_center=leaves[0], mat_color=leaves[1])
    lt = type(light)(leaves[2], light.base_color, light.intensity)
    img = split_mod.render(s, lin, sc.camera, lt, cfg, split=split,
                           differentiable=True, device=dev)
    return img, torch.autograd.grad(((img - target) ** 2).mean(), leaves)


@pytest.mark.parametrize("which", [1, 2])
def test_fit_gradients(card, which):
    """The differentiable render through the kernels against the same
    render through index_select: the image bit for bit; every row_grads
    result within ROW_RTOL of the float64 sum of its gradients (relative
    to each row's summed magnitudes); the leaves' gradients within
    LEAF_RTOL of index_select's path; 9 gathers and 6 backward launches a
    3-bounce step (each bounce: the attribute rows, the packed rows of
    the hits and of the shadow rays, whose t only decides a comparison
    and gets no gradient)."""
    calls = []
    real = row_gather.row_grads

    def recording(grads, sid, n_tab, widths, stats=None):
        out = real(grads, sid, n_tab, widths, stats)
        calls.append((grads, sid, n_tab, widths, out))
        return out

    # the wrapper counts its launches on the module's row_grads: this one
    recording.launches = 0
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(row_gather, "row_grads", recording)
        g0 = row_gather.gather_rows.launches
        img, grads = _fit_step(which, card)
        assert row_gather.gather_rows.launches - g0 == 3 * BOUNCES
        assert recording.launches == 2 * BOUNCES
        mp.setattr(row_gather, "engages", lambda table: False)
        img_ref, grads_ref = _fit_step(which, card)
    finally:
        mp.undo()
    assert torch.equal(img, img_ref)
    assert len(calls) == 2 * BOUNCES
    for k, (gs, sid, n_tab, widths, out) in enumerate(calls):
        g64 = [None if g is None else g.double() for g in gs]
        exact = row_gather.row_grads_plain(g64, sid, n_tab, widths)
        scale = row_gather.row_grads_plain(
            [None if g is None else g.abs() for g in g64], sid, n_tab, widths)
        far, worst = _rows_far(out, exact, scale, ROW_RTOL)
        assert not far, (k, far, worst)
    for k, (g, w) in enumerate(zip(grads, grads_ref)):
        far, worst = _rows_far(g.reshape(-1, 3), w.reshape(-1, 3),
                               w.reshape(-1, 3), LEAF_RTOL)
        assert not far, (k, far, worst)
        assert w.abs().max() > 0
