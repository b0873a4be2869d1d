"""The --kernel fit's trajectory in the port against the JAX example's, on
the CPU (not a Tier-1 test: the JAX side runs its split kernel in
interpret mode, about a second a step at 64x48):

    JAX_PLATFORMS=cpu python tests/compare_kernel_fit.py [W H STEPS]

Both fit scene 1's sphere 0 from the same perturbation to the same target
(the port's image of the true scene) with Adam at lr 0.1: the port through
``raytracer_tpu_torch.examples.inverse`` (torch.optim.Adam), the JAX
package through its ``make_kernel_renderer`` and optax.adam. Prints each
step's two losses and centres, then the largest relative loss difference
and centre distance over the steps."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.config import RenderConfig as JaxConfig  # noqa: E402
from raytracer_tpu.diff import make_kernel_renderer as jax_renderer  # noqa
from raytracer_tpu.diff.inverse import image_loss  # noqa: E402
from raytracer_tpu_torch.diff import make_kernel_renderer  # noqa: E402
from raytracer_tpu_torch.examples import inverse  # noqa: E402

from torch_port_common import interpret_unroll, jax_scene, ported  # noqa


def main(w=64, h=48, steps=25):
    cfg = inverse.KERNEL_CFG.replace(width=w, height=h)
    pt = ported(1)
    loss_fn, p0, _, _, target = inverse.kernel_problem(
        pt, make_kernel_renderer(None, pt.split, device="cpu"), cfg)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = inverse.Adam([(list(p.values()), 0.1)])
    port = []
    for _ in range(steps):
        val = loss_fn(p)
        opt.step(torch.autograd.grad(val, list(p.values())))
        port.append((float(val.detach()),
                     p["center"].detach().numpy().copy()))

    sc, bvh, split = jax_scene(1)
    jcfg = JaxConfig(width=w, height=h, max_bounces=3, use_bvh=True,
                     ray_chunk=w * h, tile_h=16, tile_w=128)
    flat, tgt = sc.flat, jnp.asarray(target.numpy())
    with interpret_unroll():
        ren = jax_renderer(bvh, split)

        def loss(q):
            s = flat.replace(
                sphere_center=flat.sphere_center.at[0].set(q["center"]),
                mat_color=flat.mat_color.at[0].set(q["color"]))
            return image_loss(ren(s, sc.camera, sc.light, jcfg), tgt)

        adam = optax.adam(0.1)

        @jax.jit
        def step(q, st):
            val, g = jax.value_and_grad(loss)(q)
            upd, st = adam.update(g, st, q)
            return optax.apply_updates(q, upd), st, val

        q = {k: jnp.asarray(v.numpy()) for k, v in p0.items()}
        st = adam.init(q)
        d_loss = d_centre = 0.0
        for k in range(steps):
            q, st, val = step(q, st)
            pv, pc = port[k]
            jc = np.asarray(q["center"])
            d_loss = max(d_loss, abs(pv - float(val)) / float(val))
            d_centre = max(d_centre, float(np.linalg.norm(pc - jc)))
            print(f"step {k}: loss port {pv:.8g} jax {float(val):.8g}; "
                  f"centre port {pc.tolist()} jax {jc.tolist()}")
    print(f"{w}x{h}, {steps} steps: largest relative loss difference "
          f"{d_loss:.3g}, largest centre distance {d_centre:.3g}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
