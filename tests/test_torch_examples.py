"""The pieces of the port's inverse-rendering examples
(``raytracer_tpu_torch/examples/inverse.py``) against the JAX example
(``examples/inverse.py``) and optax, which the port replaces:

- ``cosine_lr`` against ``optax.cosine_decay_schedule``;
- ``Adam`` (torch.optim.Adam, parameter groups, clip_grad_norm_) against
  ``optax.adam``, ``multi_transform`` and ``clip_by_global_norm`` over a
  few steps, with a masked gradient as the mesh fit's phases take it;
- ``rademacher``'s seeded probes;
- the deform fit's weld of the monkey (486 vertices, 1452 edges) and its
  umbrella Laplacian against a numpy recomputation, and its basis against
  the JAX example's construction;
- one ``--kernel`` evaluation at 24x18: the loss and gradient of the
  perturbed sphere's centre and colour through ``make_kernel_renderer``
  against the JAX package's (its split kernel in interpret mode, one
  compile), on the same target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracer_tpu.config import RenderConfig as JaxConfig
from raytracer_tpu.diff import make_kernel_renderer as jax_kernel_renderer
from raytracer_tpu.diff.inverse import image_loss as jax_image_loss
from raytracer_tpu_torch.diff import make_kernel_renderer
from raytracer_tpu_torch.examples import inverse
from raytracer_tpu_torch.scenes import generate_scene1

from torch_port_common import interpret_unroll, jax_scene, ported


def test_cosine_lr_matches_optax():
    for lr, n in ((0.03, 10), (0.1, 7), (0.02, 1)):
        sched = optax.cosine_decay_schedule(lr, n)
        for k in range(n + 3):
            np.testing.assert_allclose(inverse.cosine_lr(lr, k, n),
                                       float(sched(k)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["adam", "clip+groups+cosine"])
def test_adam_steps_match_optax(kind):
    """Four steps on seeded gradients: the parameters after each within
    rtol 1e-5 and atol 1e-6 (f32 Adam, the same formula rounded in
    another order: an update of the order of lr moves values of the order
    of 1, whose ulp is 1.2e-7, and four steps can add a few). The
    grouped variant is the mesh fit's optimizer: a global-norm clip at
    1.0 over both groups, rates lr and 5 lr, each cosine-decayed over 4
    steps, and the second group's gradient masked to 0 in the first two
    steps (its moments still move it after)."""
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=3).astype(np.float32),
          "b": rng.normal(size=(2, 3)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 3
              for k, v in p0.items()} for _ in range(4)]
    lr, n = 0.05, 4
    if kind == "adam":
        opt = optax.adam(lr)
        port = inverse.Adam([([torch.tensor(p0["a"])], lr),
                             ([torch.tensor(p0["b"])], lr)])
        masks = [{"a": 1.0, "b": 1.0}] * n
    else:
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.multi_transform(
                              {"slow": optax.adam(
                                  optax.cosine_decay_schedule(lr, n)),
                               "fast": optax.adam(
                                   optax.cosine_decay_schedule(5 * lr, n))},
                              {"a": "slow", "b": "fast"}))
        port = inverse.Adam([([torch.tensor(p0["a"])], lr),
                             ([torch.tensor(p0["b"])], 5 * lr)],
                            decay_steps=n, clip=1.0)
        masks = [{"a": 1.0, "b": 0.0}] * 2 + [{"a": 1.0, "b": 1.0}] * 2
    p = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(p)
    update = jax.jit(opt.update)
    for g, m in zip(grads, masks):
        gj = {k: jnp.asarray(v) * m[k] for k, v in g.items()}
        upd, st = update(gj, st, p)
        p = optax.apply_updates(p, upd)
        port.step([torch.tensor(g[k]) * m[k] for k in ("a", "b")])
        for k, t in zip(("a", "b"), port.params):
            np.testing.assert_allclose(t.numpy(), np.asarray(p[k]),
                                       rtol=1e-5, atol=1e-6)


def test_rademacher_probes():
    """+-1 entries from a seeded generator: the same draws for the same
    seed, about half of each sign."""
    a = inverse.rademacher(torch.Generator().manual_seed(0), (486, 3), "cpu")
    b = inverse.rademacher(torch.Generator().manual_seed(0), (486, 3), "cpu")
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(a.mean())) < 0.1


def test_weld_and_laplacian_match_numpy():
    """The monkey's triangle soup welds into the JAX record's 486
    vertices and 1452 edges; each corner maps to a vertex within the
    1e-4 quantum; the edges, degrees and umbrella Laplacian equal a
    numpy recomputation from the triangles (loop over neighbours)."""
    flat = generate_scene1(device="cpu").flat
    mids = inverse.monkey_ids(flat)
    corners = np.stack([getattr(flat, k).numpy()[mids]
                        for k in ("tri_p1", "tri_p2", "tri_p3")], axis=1)
    vid, base, edges, deg = inverse.weld(corners)
    assert mids.shape == (968,) and base.shape == (486, 3)
    assert edges.shape == (1452, 2)
    np.testing.assert_allclose(base[vid], corners, rtol=0, atol=1e-4)
    nbrs = [set() for _ in range(486)]
    for tri in vid:
        for i in tri:
            nbrs[i].update(int(j) for j in tri if j != i)
    want_edges = sorted((i, j) for i in range(486) for j in nbrs[i] if i < j)
    assert [tuple(e) for e in edges.tolist()] == want_edges
    np.testing.assert_array_equal(deg, [len(s) for s in nbrs])
    x = np.random.default_rng(3).normal(size=(486, 3)).astype(np.float32)
    want = np.stack([x[i] - x[sorted(nbrs[i])].sum(0) / max(len(nbrs[i]), 1)
                     for i in range(486)])
    got = inverse.make_laplacian(edges, deg, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_deform_basis_matches_the_jax_construction():
    """``deform_basis`` equals the JAX example's basis (copied here from
    examples/inverse.py::main_kernel_deform) on the welded monkey: 28
    coarse columns (84 coefficients), unit-RMS columns."""
    flat = generate_scene1(device="cpu").flat
    mids = inverse.monkey_ids(flat)
    corners = np.stack([getattr(flat, k).numpy()[mids]
                        for k in ("tri_p1", "tri_p2", "tri_p3")], axis=1)
    _, base, _, _ = inverse.weld(corners)
    bv = jnp.asarray(base)
    rel = bv - bv.mean(0)
    feats = [jnp.ones(base.shape[0])]
    small = [0]
    for a in range(3):
        small.append(len(feats))
        feats.append(rel[:, a])
        for b2 in range(a, 3):
            small.append(len(feats))
            feats.append(rel[:, a] * rel[:, b2])
        for w in (0.15, 0.3, 0.6):
            if w == 0.3:
                small += [len(feats), len(feats) + 1]
            feats.append(jnp.sin(rel[:, a] * w))
            feats.append(jnp.cos(rel[:, a] * w))
    for (a, b2) in ((0, 1), (0, 2), (1, 2)):
        for w in (0.2, 0.4):
            for sgn in (1.0, -1.0):
                u = rel[:, a] + sgn * rel[:, b2]
                if w == 0.2:
                    small += [len(feats), len(feats) + 1]
                feats.append(jnp.sin(w * u))
                feats.append(jnp.cos(w * u))
    want = jnp.stack(feats, axis=-1).astype(jnp.float32)
    want = want / jnp.sqrt(jnp.mean(want ** 2, axis=0, keepdims=True)
                           + 1e-12)
    tb = torch.from_numpy(base)
    got, got_small = inverse.deform_basis(tb - tb.mean(0))
    assert got_small == small and len(small) * 3 == 84
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_kernel_fit_loss_and_gradient_match_jax():
    """The --kernel fit's first evaluation at 24x18 with 3 bounces (scene
    1, sphere 0 moved by (1.2, -1.5, 0.9) and recoloured): the loss and
    the gradients of the centre and colour through the port's
    ``make_kernel_renderer`` against the JAX package's, on the port's
    target. The port's scene and tables are the JAX package's, carried
    across (``ported``; the camera's half height as JAX rounds it). The
    bar is tests/test_grad.py's: rtol 1e-3, atol 1e-5."""
    cfg = inverse.KERNEL_CFG.replace(width=24, height=18)
    pt = ported(1)
    loss_fn, p0, _, _, target = inverse.kernel_problem(
        pt, make_kernel_renderer(None, pt.split, device="cpu"), cfg)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    val = loss_fn(p)
    grads = torch.autograd.grad(val, list(p.values()))
    val = float(val.detach())

    jsc, bvh, split = jax_scene(1)
    jcfg = JaxConfig(width=24, height=18, max_bounces=3, use_bvh=True,
                     ray_chunk=432, tile_h=16, tile_w=128)
    flat = jsc.flat
    tgt = jnp.asarray(target.numpy())
    with interpret_unroll():
        jren = jax_kernel_renderer(bvh, split)

        def jax_loss(q):
            s = flat.replace(
                sphere_center=flat.sphere_center.at[0].set(q["center"]),
                mat_color=flat.mat_color.at[0].set(q["color"]))
            return jax_image_loss(jren(s, jsc.camera, jsc.light, jcfg), tgt)

        want, g_want = jax.jit(jax.value_and_grad(jax_loss))(
            {k: jnp.asarray(v.numpy()) for k, v in p0.items()})
    assert val > 1e-3
    np.testing.assert_allclose(val, float(want), rtol=1e-3)
    for k, g in zip(p, grads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
