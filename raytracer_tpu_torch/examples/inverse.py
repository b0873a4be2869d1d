"""Inverse rendering examples (port of ``examples/inverse.py``): recover
scene parameters from target images by gradient descent, through the
brute-force oracle or through the production kernels.

    python -m raytracer_tpu_torch.examples.inverse \\
        [--kernel | --kernel-mesh | --kernel-camera | --kernel-deform] \\
        [--steps N] [--lr X] [--out DIR] [--device DEV]

- no flag (``main``): a sphere's position and colour through the oracle
  at 64x48;
- ``--kernel`` (``main_kernel``): sphere 0 of scene 1 at 800x600 through
  the production split kernel, every step refreshing the tables from the
  current geometry (``diff.make_kernel_renderer``);
- ``--kernel-mesh`` (``main_kernel_mesh``): a rigid translation of the
  968-triangle monkey and the light's position, from two views;
- ``--kernel-deform`` (``main_kernel_deform``): a smooth per-vertex
  deformation of the welded monkey under an umbrella-Laplacian prior, by
  central finite differences over a low-frequency basis, then SPSA;
- ``--kernel-camera`` (``main_kernel_camera``): the camera's position,
  yaw and pitch, by annealed pyramid phases, then finite differences.

Each fit keeps the JAX example's scenes, cameras, perturbations, defaults
and success checks. optax has no place on the card, so its pieces become
PyTorch's: ``optax.adam`` is ``torch.optim.Adam``, ``clip_by_global_norm``
is ``clip_grad_norm_``, ``multi_transform`` is parameter groups,
``cosine_decay_schedule`` is ``cosine_lr`` set on the groups each step,
and ``jax.random`` Rademacher probes come from a seeded
``torch.Generator``. The JAX example's asserts are the fits' success
checks: each fit records their verdict and, unless called with
``strict=False``, raises on the first that fails. The JSON records (the
JAX example's fields) and the PNGs go to ``--out`` (default
``chiprun_out/inverse``). ``--device`` defaults to ``cuda``; ``cpu`` runs
the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from raytracer_tpu_torch.accel import build_bvh, linearize
from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.core import camera as cam_ops
from raytracer_tpu_torch.core.scene import TRIANGLE, SceneBuilder
from raytracer_tpu_torch.core.types import Light, Material
from raytracer_tpu_torch.device import resolve_device
from raytracer_tpu_torch.diff import (fit_scene_params, image_loss,
                                      image_loss_pyramid,
                                      make_kernel_renderer)
from raytracer_tpu_torch.io import write_png
from raytracer_tpu_torch.render.reference import render as render_ref
from raytracer_tpu_torch.render.split_scene import prepare
from raytracer_tpu_torch.scenes import generate_scene1, meshgen

OUT = os.path.join("chiprun_out", "inverse")

# The kernel fits' frame: scene 1 at 800x600 with 3 bounces.
KERNEL_CFG = RenderConfig(width=800, height=600, max_bounces=3,
                          use_bvh=True, ray_chunk=480000, tile_h=16,
                          tile_w=128)


# -- optax's pieces ---------------------------------------------------------

def cosine_lr(lr: float, k: int, n: int) -> float:
    """``optax.cosine_decay_schedule(lr, n)`` at step k: lr * 0.5 * (1 +
    cos(pi * min(k, n) / n))."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(k, n) / n))


class Adam:
    """Adam over parameter groups, each with its own rate: a constant
    one, or with ``decay_steps`` the cosine decay of ``cosine_lr`` (step
    k takes its rate at k, as optax's schedule counts updates from 0);
    with ``clip``, the gradients are first clipped to that global norm
    over every parameter (``optax.chain(clip_by_global_norm(clip),
    multi_transform({g: adam(schedule_g)}))``). A parameter whose
    gradient is zero still takes its step from the moments, as optax's
    Adam does."""

    def __init__(self, groups, decay_steps=None, clip=None):
        self.params = [p for ps, _ in groups for p in ps]
        self.rates = [lr for _, lr in groups]
        self.opt = torch.optim.Adam([{"params": list(ps), "lr": lr}
                                     for ps, lr in groups])
        self.decay_steps, self.clip, self.k = decay_steps, clip, 0

    def step(self, grads) -> None:
        """One update of the parameters, in place, with ``grads`` (one
        tensor a parameter, in order)."""
        for p, g in zip(self.params, grads):
            p.grad = g.detach().to(p.dtype).clone()
        if self.clip is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip)
        if self.decay_steps is not None:
            for group, lr in zip(self.opt.param_groups, self.rates):
                group["lr"] = cosine_lr(lr, self.k, self.decay_steps)
        self.opt.step()
        self.k += 1


def rademacher(gen: torch.Generator, shape, device) -> torch.Tensor:
    """+-1 f32 entries, each with probability 1/2, from ``gen`` (a seeded
    CPU generator, so that a run on any device draws the same probes)."""
    return (torch.randint(0, 2, shape, generator=gen) * 2 - 1).to(
        device=device, dtype=torch.float32)


# -- shared set-up ------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _scalar(x) -> float:
    return float(x.detach())


def kernel_scene(dev, cfg: RenderConfig = KERNEL_CFG):
    """Scene 1 at ``cfg``'s aspect with its reference tree, split tables
    and ``make_kernel_renderer`` on ``dev``: (scene, renderer)."""
    sc = generate_scene1(aspect=cfg.width / cfg.height, device=dev)
    bvh = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
    return sc, make_kernel_renderer(bvh, prepare(sc.flat, bvh, device=dev),
                                    device=dev)


def _set_row(x: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """``x.at[i].set(v)``, differentiable with respect to v."""
    return torch.cat([x[:i], v[None], x[i + 1:]])


def monkey_ids(flat) -> np.ndarray:
    """The shape rows of scene 1's 968-triangle monkey: the triangles
    after the free one (scene 1 packs 4 spheres and the mirror wall, then
    the free triangle, before it)."""
    n_monkey = len(meshgen.monkey_mesh())
    tri_ids = np.nonzero(flat.shape_type.cpu().numpy() == TRIANGLE)[0]
    return tri_ids[1:1 + n_monkey]


def _write(out: str, name: str, img) -> None:
    write_png(os.path.join(out, name), img)


def _verdict(out: str, name: str, rec: dict, checks, strict: bool) -> dict:
    """Record the fit's success checks (the JAX example's asserts: (ok,
    message) pairs) in ``rec``, write it to ``out/name`` and print it
    without its curves; with ``strict``, raise AssertionError with the
    message of the first check that failed."""
    rec["checks"] = [{"check": msg, "passed": bool(ok)} for ok, msg in checks]
    rec["passed"] = all(ok for ok, _ in checks)
    with open(os.path.join(out, name), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if not k.endswith("curve")}, indent=1))
    failed = [msg for ok, msg in checks if not ok]
    if strict and failed:
        raise AssertionError(failed[0])
    return rec


# -- --kernel -----------------------------------------------------------------

def kernel_problem(sc, renderer, cfg: RenderConfig):
    """--kernel's problem: sphere 0's centre and colour, perturbed to a
    sized-to-the-basin offset (pixel-MSE gradients pull a displaced
    object back only while its silhouette still overlaps the target).
    Returns (loss_fn(p), p0, p_true, with_params(p) -> scene, target),
    the target the renderer's image of the true scene."""
    flat = sc.flat
    dev = flat.device
    with torch.no_grad():
        target = renderer(flat, sc.camera, sc.light, cfg)

    def with_params(p):
        return flat.replace(
            sphere_center=_set_row(flat.sphere_center, 0, p["center"]),
            mat_color=_set_row(flat.mat_color, 0, p["color"]))

    def loss_fn(p):
        return image_loss(renderer(with_params(p), sc.camera, sc.light,
                                   cfg), target)

    p0 = {"center": flat.sphere_center[0] + torch.tensor(
              [1.2, -1.5, 0.9], device=dev),
          "color": torch.tensor([0.15, 0.7, 0.8], device=dev)}
    p_true = {"center": flat.sphere_center[0], "color": flat.mat_color[0]}
    return loss_fn, p0, p_true, with_params, target


def main_kernel(steps: int, lr: float, out: str = OUT, device=None,
                strict: bool = True) -> dict:
    """The fit through the production split kernel at full scene-1 scale
    (sphere 0's centre and colour only: a whole-array fit with Adam drags
    every other shape's colour off truth). Writes INVERSE_kernel.json
    (loss curve, fwd / fwd+bwd times). ``strict``: raise if a success
    check fails (else the record holds the verdict)."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = KERNEL_CFG
    sc, renderer = kernel_scene(dev, cfg)
    loss_fn, p0, p_true, with_params, target = kernel_problem(sc, renderer,
                                                              cfg)
    _write(out, "inverse_kernel_target.png", target)
    with torch.no_grad():
        _write(out, "inverse_kernel_init.png",
               renderer(with_params(p0), sc.camera, sc.light, cfg))

    # fwd / fwd+bwd times at full 800x600 through the kernel path
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}

    def fwd():
        with torch.no_grad():
            return loss_fn(p)

    def fwd_bwd():
        return torch.autograd.grad(loss_fn(p), list(p.values()))

    times = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / 10 * 1e3

    opt = Adam([(list(p.values()), lr)])
    t0 = time.perf_counter()
    history = []
    for _ in range(steps):
        val = loss_fn(p)
        opt.step(torch.autograd.grad(val, list(p.values())))
        history.append(_scalar(val))
    fit_s = time.perf_counter() - t0
    with torch.no_grad():
        _write(out, "inverse_kernel_fit.png",
               renderer(with_params(p), sc.camera, sc.light, cfg))
        # the loss floor: the target and the fit's forward are the same
        # route here, so it is ~0 unless a knife-edge decision flips
        loss_floor = _scalar(loss_fn(p_true))
    err = float(torch.linalg.vector_norm(p["center"].detach()
                                         - p_true["center"]))
    rec = {
        "config": "scene 1 (1240 shapes), 800x600, 3 bounces, production "
                  "split kernel, per-step update_dynamic refresh",
        "device": _device_name(dev),
        "steps": steps, "lr": lr,
        "fwd_ms": round(times["fwd"], 2),
        "fwd_bwd_ms": round(times["fwd_bwd"], 2),
        "bwd_over_fwd": round(times["fwd_bwd"] / times["fwd"], 2),
        "fit_wall_s": round(fit_s, 1),
        "loss_first": history[0], "loss_last": history[-1],
        "loss_floor_at_true_params": loss_floor,
        "loss_curve": [round(h, 6) for h in history],
        "true_center": p_true["center"].tolist(),
        "recovered_center": p["center"].detach().tolist(),
        "center_err": err,
        "true_color": p_true["color"].tolist(),
        "recovered_color": p["color"].detach().tolist(),
    }
    excess0 = history[0] - loss_floor
    excess1 = history[-1] - loss_floor
    return _verdict(out, "INVERSE_kernel.json", rec, [
        (excess1 < 0.05 * excess0,
         f"kernel-path fit did not converge: {excess1} vs {excess0}"),
        (err < 0.1, f"center not recovered: {err}")], strict)


# -- --kernel-mesh ----------------------------------------------------------

def _look(cfg, position, dev):
    """A camera at ``position`` looking at the monkey (0, 0, -30)."""
    return cam_ops.look_at(
        cam_ops.from_euler(position=position, fov_deg=60,
                           aspect=cfg.width / cfg.height, device=dev),
        (0.0, 0.0, -30.0))


def main_kernel_mesh(steps: int, lr: float, out: str = OUT,
                     device=None, strict: bool = True) -> dict:
    """Rigid translation of the 968-triangle monkey and the light
    position, from two monkey-facing views, through the production
    kernel: gradients flow through every vertex of every triangle row
    (the tables' per-step refresh and kernel_vjp's re-derivation). Two
    views ~90 degrees apart make every translation direction in-plane for
    one of them (with hit decisions held fixed there are no silhouette
    gradients, and one view cannot see its depth). Writes
    INVERSE_kernel_mesh.json."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = KERNEL_CFG
    sc, renderer = kernel_scene(dev, cfg)
    cameras = [_look(cfg, (0.0, -6.0, -48.0), dev),
               _look(cfg, (-18.0, -6.0, -30.0), dev)]
    mask = torch.zeros((sc.flat.tri_p1.shape[0], 1), device=dev)
    mask[torch.as_tensor(monkey_ids(sc.flat), device=dev)] = 1.0
    base = (sc.flat.tri_p1, sc.flat.tri_p2, sc.flat.tri_p3)

    def with_params(p):
        dm = mask * p["delta"]
        # the planes are recomputed from the vertices, as a general edit
        # must (a rigid translation keeps n and shifts d)
        s = sc.flat.replace(tri_p1=base[0] + dm, tri_p2=base[1] + dm,
                            tri_p3=base[2] + dm).recompute_tri_planes()
        return s, Light(p["light"], sc.light.base_color,
                        sc.light.intensity)

    true_light = sc.light.position.clone()
    p_true = {"delta": torch.zeros(3, device=dev), "light": true_light}
    with torch.no_grad():
        s_t, l_t = with_params(p_true)
        targets = [renderer(s_t, c, l_t, cfg) for c in cameras]
    _write(out, "inverse_mesh_target.png", targets[0])

    def loss_fn(p):
        s, light = with_params(p)
        loss = 0.0
        for c, t in zip(cameras, targets):
            loss = loss + image_loss_pyramid(renderer(s, c, light, cfg), t)
        return loss / len(cameras)

    # perturbation sized to the surrogate's validity region
    p0 = {"delta": torch.tensor([0.4, -0.3, 0.25], device=dev),
          "light": true_light + torch.tensor([1.2, -1.0, 0.8], device=dev)}
    with torch.no_grad():
        s0, l0 = with_params(p0)
        _write(out, "inverse_mesh_init.png",
               renderer(s0, cameras[0], l0, cfg))

    # per-group Adam (mesh slow, light 5x faster) under one clip, cosine
    # decay on both; block coordinate descent by gradient masks: phase 1
    # the mesh alone, phase 2 the light alone, phase 3 both
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = Adam([([p["delta"]], lr), ([p["light"]], 5 * lr)],
               decay_steps=steps, clip=1.0)
    n1, n2 = steps // 3, 2 * steps // 3

    def mask_at(i):
        if i < n1:
            return {"delta": 1.0, "light": 0.0}
        if i < n2:
            return {"delta": 0.0, "light": 1.0}
        return {"delta": 1.0, "light": 1.0}

    def snapshot():
        return {k: v.detach().clone() for k, v in p.items()}

    t0 = time.perf_counter()
    history, delta_hist, light_hist = [], [], []
    best = (float("inf"), snapshot())
    for i in range(steps):
        if i in (n1, n2):
            # each phase restarts from the best iterate so far
            with torch.no_grad():
                for k, v in best[1].items():
                    p[k].copy_(v)
        val = loss_fn(p)
        g = torch.autograd.grad(val, [p["delta"], p["light"]])
        m = mask_at(i)
        opt.step([g[0] * m["delta"], g[1] * m["light"]])
        history.append(_scalar(val))
        # as the JAX loop keeps it: the step's loss with the updated
        # iterate
        if history[-1] < best[0]:
            best = (history[-1], snapshot())
        delta_hist.append(p["delta"].detach().tolist())
        light_hist.append(p["light"].detach().tolist())
    fit_s = time.perf_counter() - t0
    pb = best[1]
    with torch.no_grad():
        s_fit, l_fit = with_params(pb)
        _write(out, "inverse_mesh_fit.png",
               renderer(s_fit, cameras[0], l_fit, cfg))
        loss_floor = _scalar(loss_fn(p_true))
    delta_err = float(torch.linalg.vector_norm(pb["delta"]))
    light_err = float(torch.linalg.vector_norm(pb["light"] - true_light))
    rec = {
        "config": "scene 1 (968-tri monkey rigid translation + light "
                  "position), TWO 800x600 views, 3 bounces, production "
                  "split kernel, per-step update_dynamic refresh",
        "device": _device_name(dev),
        "steps": steps, "lr": lr, "fit_wall_s": round(fit_s, 1),
        "loss_first": history[0], "loss_last": history[-1],
        "loss_best": best[0],
        "best_step": int(np.argmin(history)),
        "loss_floor_at_true_params": loss_floor,
        "init_delta": p0["delta"].tolist(),
        "recovered_delta": pb["delta"].tolist(),
        "delta_err": delta_err,
        "true_light": true_light.tolist(),
        "init_light": p0["light"].tolist(),
        "recovered_light": pb["light"].tolist(),
        "light_err": light_err,
        "loss_curve": [round(h, 6) for h in history],
        "delta_curve": delta_hist[:: max(1, steps // 20)],
        "light_curve": light_hist[:: max(1, steps // 20)],
    }
    excess0 = history[0] - loss_floor
    excess1 = best[0] - loss_floor
    return _verdict(out, "INVERSE_kernel_mesh.json", rec, [
        (excess1 < 0.1 * excess0,
         f"mesh+light fit did not converge: {excess1} vs {excess0}"),
        (delta_err < 0.15, f"mesh translation not recovered: {delta_err}"),
        (light_err < 0.5, f"light not recovered: {light_err}")], strict)


# -- --kernel-deform --------------------------------------------------------

def weld(corners: np.ndarray):
    """Weld a triangle soup (T, 3 corners, 3) into a vertex graph by
    position quantised to 1e-4: (vid (T, 3) vertex ids, base vertices (V,
    3) f32, edges (E, 2) int32 with i < j, sorted, and each vertex's
    degree (V,) f32)."""
    flatc = corners.reshape(-1, 3)
    keys = np.round(flatc / 1e-4).astype(np.int64)
    _, vid_flat = np.unique(keys, axis=0, return_inverse=True)
    vid_flat = vid_flat.reshape(-1)
    vid = vid_flat.reshape(-1, 3)
    n_vert = int(vid_flat.max()) + 1
    base_vert = np.zeros((n_vert, 3), np.float32)
    base_vert[vid_flat] = flatc                  # last write wins (welded)
    edges = set()
    for a, b, c in vid.tolist():
        for e in ((a, b), (b, c), (c, a)):
            if e[0] != e[1]:
                edges.add((min(e), max(e)))
    edges = np.asarray(sorted(edges), np.int32)
    deg = np.zeros(n_vert, np.float32)
    np.add.at(deg, edges[:, 0], 1.0)
    np.add.at(deg, edges[:, 1], 1.0)
    return vid, base_vert, edges, deg


def make_laplacian(edges: np.ndarray, deg: np.ndarray, device):
    """The umbrella Laplacian of the graph: x (V, 3) -> x_i minus the
    mean of x over i's neighbours."""
    ei = torch.as_tensor(edges[:, 0], dtype=torch.int64, device=device)
    ej = torch.as_tensor(edges[:, 1], dtype=torch.int64, device=device)
    degj = torch.as_tensor(np.maximum(deg, 1.0), device=device)[:, None]

    def laplacian(x):
        nbr = (torch.zeros_like(x).index_add(0, ei, x.index_select(0, ej))
               .index_add(0, ej, x.index_select(0, ei)))
        return x - nbr / degj

    return laplacian


def deform_basis(rel: torch.Tensor):
    """The generic low-frequency basis of the vertex field over the
    centred vertices rel (V, 3): quadratic polynomials and sin / cos at
    three frequencies per axis, oblique sums and differences at two,
    columns scaled to unit RMS (Adam's steps are scale-free). Returns
    (B (V, F), the columns of the coarse sub-basis)."""
    feats = [torch.ones_like(rel[:, 0])]
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
            feats.append(torch.sin(rel[:, a] * w))
            feats.append(torch.cos(rel[:, a] * w))
    for (a, b2) in ((0, 1), (0, 2), (1, 2)):
        for w in (0.2, 0.4):
            for sgn in (1.0, -1.0):
                u = rel[:, a] + sgn * rel[:, b2]
                if w == 0.2:
                    small += [len(feats), len(feats) + 1]
                feats.append(torch.sin(w * u))
                feats.append(torch.cos(w * u))
    b = torch.stack(feats, dim=-1)
    b = b / torch.sqrt(torch.mean(b ** 2, dim=0, keepdim=True) + 1e-12)
    return b, small


def main_kernel_deform(steps: int, lr: float, out: str = OUT,
                       device=None, strict: bool = True) -> dict:
    """A smooth per-vertex deformation of the monkey (486 welded vertices,
    3 offsets each) from four close views, under an umbrella-Laplacian
    prior: central finite differences over the 84 coefficients of a
    coarse low-frequency basis, then a short per-vertex SPSA polish, both
    over the true rendered loss (the mesh is flat-shaded, and the
    silhouette-blind analytic gradient measured uphill on the JAX
    package). Recovery is reported for all vertices and for the observed
    ones (front-facing to some view and lit). Writes
    INVERSE_kernel_deform.json."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = KERNEL_CFG
    sc, renderer = kernel_scene(dev, cfg)
    cameras = [_look(cfg, pos, dev) for pos in (
        (0.0, -4.0, -44.0), (-11.0, -5.0, -37.0), (10.0, -3.0, -40.0),
        # top-down: constrains the depth directions the side views miss
        (3.0, -16.0, -26.0))]

    mids_np = monkey_ids(sc.flat)
    flat_np = {k: getattr(sc.flat, k).cpu().numpy()
               for k in ("tri_p1", "tri_p2", "tri_p3")}
    corners = np.stack([flat_np[k][mids_np]
                        for k in ("tri_p1", "tri_p2", "tri_p3")], axis=1)
    vid_np, base_vert, edges, deg = weld(corners)
    n_vert = base_vert.shape[0]
    laplacian = make_laplacian(edges, deg, dev)
    vids = [torch.as_tensor(vid_np[:, c], dtype=torch.int64, device=dev)
            for c in range(3)]
    mids = torch.as_tensor(mids_np, dtype=torch.int64, device=dev)
    base = (sc.flat.tri_p1, sc.flat.tri_p2, sc.flat.tri_p3)

    def with_offsets(off):
        p1, p2, p3 = (b.index_add(0, mids, off.index_select(0, v))
                      for b, v in zip(base, vids))
        return sc.flat.replace(tri_p1=p1, tri_p2=p2,
                               tri_p3=p3).recompute_tri_planes()

    # ground truth: a smooth warp, about one period across the mesh
    bv = torch.as_tensor(base_vert, device=dev)
    rel = bv - bv.mean(0)
    true_off = torch.stack([
        0.35 * torch.sin(rel[:, 1] * 0.30),
        0.30 * torch.cos(rel[:, 0] * 0.26),
        0.25 * torch.sin(rel[:, 0] * 0.22 + rel[:, 1] * 0.18)], dim=-1)
    true_rms = float(torch.sqrt(torch.mean(true_off ** 2)))
    with torch.no_grad():
        s_t = with_offsets(true_off)
        targets = [renderer(s_t, c, sc.light, cfg) for c in cameras]
        _write(out, "inverse_deform_target.png", targets[0])
        _write(out, "inverse_deform_init.png",
               renderer(with_offsets(torch.zeros_like(true_off)),
                        cameras[0], sc.light, cfg))

    lam = 0.5   # the Laplacian prior's weight

    @torch.no_grad()
    def total_loss(off) -> float:
        s = with_offsets(off)
        data = 0.0
        for c, t in zip(cameras, targets):
            data = data + image_loss_pyramid(renderer(s, c, sc.light, cfg),
                                             t)
        reg = torch.mean(torch.sum(laplacian(off) ** 2, -1))
        return _scalar(data / len(cameras) + lam * reg)

    b, small = deform_basis(rel)
    bs = b[:, torch.as_tensor(small, device=dev)]

    def fd_phase(loss_of, p, n, plr, h):
        """Central-difference gradient + Adam over a coefficient matrix:
        2 * p.numel() loss evaluations a step."""
        p = p.clone()
        opt = Adam([([p], plr)], decay_steps=max(n, 1))
        hist, best = [], (loss_of(p), p.clone())
        for _ in range(n):
            g = torch.zeros_like(p)
            for i in range(p.shape[0]):
                for a in range(p.shape[1]):
                    e = torch.zeros_like(p)
                    e[i, a] = h
                    g[i, a] = (loss_of(p + e) - loss_of(p - e)) / (2 * h)
            opt.step([g])
            v = loss_of(p)
            hist.append(v)
            if v < best[0]:
                best = (v, p.clone())
        return best, hist

    def spsa_phase(loss_of, p, n, plr, delta, gen, track_every=5):
        """SPSA + Adam; the exact loss is tracked every ``track_every``
        steps (a probe pair is already 2 evaluations)."""
        p = p.clone()
        opt = Adam([([p], plr)], decay_steps=max(n, 1))
        hist, best = [], (loss_of(p), p.clone())
        for k in range(n):
            pert = rademacher(gen, tuple(p.shape), dev)
            lp = loss_of(p + delta * pert)
            lm = loss_of(p - delta * pert)
            opt.step([(lp - lm) / (2 * delta) * pert])
            if k % track_every == track_every - 1 or k == n - 1:
                v = loss_of(p)
                hist.append(v)
                if v < best[0]:
                    best = (v, p.clone())
            else:
                hist.append(min(lp, lm))
        return best, hist

    t0 = time.perf_counter()
    loss_init = total_loss(torch.zeros_like(true_off))
    n_fd = max(10, min(25, steps // 40))
    (v1, c1), hist1 = fd_phase(lambda c: total_loss(bs @ c),
                               torch.zeros((bs.shape[1], 3), device=dev),
                               n_fd, lr, h=0.02)
    # a short per-vertex SPSA polish under the prior, kept only if it
    # improves the true loss
    gen = torch.Generator().manual_seed(0)
    (v2, p2), hist2 = spsa_phase(total_loss, bs @ c1, max(steps // 8, 60),
                                 lr / 50.0, delta=0.005, gen=gen)
    history = hist1 + hist2
    best = (v2, p2) if v2 < v1 else (v1, bs @ c1)
    fit_s = time.perf_counter() - t0
    p = best[1]
    with torch.no_grad():
        _write(out, "inverse_deform_fit.png",
               renderer(with_offsets(p), cameras[0], sc.light, cfg))

    # observed vertices: some incident triangle faces a camera and is lit
    tri_n = s_t.plane_normal[mids].cpu().numpy()
    tri_c = ((s_t.tri_p1[mids] + s_t.tri_p2[mids] + s_t.tri_p3[mids])
             / 3.0).cpu().numpy()
    lp_ = sc.light.position.cpu().numpy()
    lit = ((lp_ - tri_c) * tri_n).sum(-1) > 0
    seen = np.zeros(tri_n.shape[0], bool)
    for c in cameras:
        seen |= ((c.position.cpu().numpy() - tri_c) * tri_n).sum(-1) > 0
    obs_tri = lit & seen
    obs_v = np.zeros(n_vert, bool)
    for c in range(3):
        obs_v[vid_np[:, c][obs_tri]] = True
    n_obs = max(int(obs_v.sum()), 1)
    obs = torch.as_tensor(obs_v, device=dev)[:, None]

    diff2 = (p - true_off) ** 2
    err_rms = float(torch.sqrt(torch.mean(diff2)))
    err_rms_obs = float(torch.sqrt(torch.where(obs, diff2, 0.0).sum()
                                   / (3 * n_obs)))
    init_rms = true_rms   # the zero init's distance from the truth
    init_rms_obs = float(torch.sqrt(torch.where(obs, true_off ** 2,
                                                0.0).sum() / (3 * n_obs)))
    rec = {
        "config": "scene 1 monkey (968 tris, welded vertices): per-vertex "
                  "deformation + Laplacian reg, FOUR 800x600 views, "
                  "production split kernel, per-step update_dynamic",
        "device": _device_name(dev),
        "n_vertices": n_vert, "n_edges": int(edges.shape[0]),
        "steps": steps, "lr": lr, "laplacian_weight": lam,
        "fd_steps": n_fd, "fit_wall_s": round(fit_s, 1),
        "loss_at_zero_init": loss_init,
        "loss_first": history[0], "loss_last": history[-1],
        "loss_best": best[0], "best_step": int(np.argmin(history)),
        "true_offset_rms": true_rms,
        "init_vertex_rms_err": init_rms,
        "recovered_vertex_rms_err": err_rms,
        "recovered_over_init": round(err_rms / init_rms, 4),
        "n_observed_vertices": int(obs_v.sum()),
        "init_vertex_rms_err_observed": init_rms_obs,
        "recovered_vertex_rms_err_observed": err_rms_obs,
        "recovered_over_init_observed": round(
            err_rms_obs / max(init_rms_obs, 1e-9), 4),
        "loss_curve": [round(h, 6) for h in history],
    }
    # the appearance is recovered and the observed surface improves; full
    # vertex recovery is not claimed (most of the rms lies in directions a
    # flat-shaded mesh hardly shows)
    return _verdict(out, "INVERSE_kernel_deform.json", rec, [
        (best[0] < 0.3 * loss_init,
         f"appearance not recovered: loss {best[0]} vs init {loss_init}"),
        (err_rms_obs < 0.95 * init_rms_obs,
         f"observed-surface vertex field did not improve: {err_rms_obs} "
         f"vs {init_rms_obs}")], strict)


# -- --kernel-camera ----------------------------------------------------------

def main_kernel_camera(steps: int, lr: float, out: str = OUT,
                       device=None, strict: bool = True) -> dict:
    """The camera pose of scene 1's demo view (position, yaw and pitch,
    parameterised as the reference's camera is) from pixels, through the
    production kernel: Adam over three annealed pyramid phases (the
    64-pixel-pooled loss alone first: a wide, low-bias basin), then a
    central-difference polish of the full pyramid (the analytic gradient
    is silhouette-blind at the basin floor). Writes
    INVERSE_kernel_camera.json."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = KERNEL_CFG
    sc, renderer = kernel_scene(dev, cfg)
    yaw_t, pitch_t = (float(v) for v in cam_ops.yaw_pitch_of(sc.camera))
    pos_t = sc.camera.position.detach().clone()
    f32 = dict(dtype=torch.float32, device=dev)
    p_true = {"pos": pos_t, "yaw": torch.tensor(yaw_t, **f32),
              "pitch": torch.tensor(pitch_t, **f32)}

    def cam_of(p):
        return cam_ops.from_euler(position=p["pos"], yaw=p["yaw"],
                                  pitch=p["pitch"], fov_deg=60.0,
                                  aspect=cfg.width / cfg.height, device=dev)

    with torch.no_grad():
        target = renderer(sc.flat, cam_of(p_true), sc.light, cfg)
    _write(out, "inverse_camera_target.png", target)

    def make_loss(scales):
        def loss_fn(p):
            img = renderer(sc.flat, cam_of(p), sc.light, cfg)
            return image_loss_pyramid(img, target, scales=scales)
        return loss_fn

    phases = ((64,), (64, 16), (1, 4, 16, 64))
    loss_fn = make_loss(phases[-1])   # the reported loss: the full pyramid

    @torch.no_grad()
    def full_loss(p) -> float:
        return _scalar(loss_fn(p))

    # ~0.75 units of translation and ~1.5 degrees of look direction
    p0 = {"pos": pos_t + torch.tensor([0.5, -0.4, 0.4], **f32),
          "yaw": torch.tensor(yaw_t + 1.5, **f32),
          "pitch": torch.tensor(pitch_t - 1.0, **f32)}
    with torch.no_grad():
        _write(out, "inverse_camera_init.png",
               renderer(sc.flat, cam_of(p0), sc.light, cfg))

    keys = ("pos", "yaw", "pitch")
    steps_of = [steps // 3, steps // 4, steps - steps // 3 - steps // 4]
    phase_lrs = [lr, lr / 2.0, lr / 5.0]
    t0 = time.perf_counter()
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}

    def snapshot():
        return {k: v.detach().clone() for k, v in p.items()}

    def restore(q):
        with torch.no_grad():
            for k in keys:
                p[k].copy_(q[k])

    history = [full_loss(p)]
    best = (history[0], snapshot())
    for scales, plr, n in zip(phases, phase_lrs, steps_of):
        phase_loss = make_loss(scales)
        restore(best[1])                  # restart from the best so far
        opt = Adam([([p[k] for k in keys], plr)], decay_steps=max(n, 1),
                   clip=1.0)
        for _ in range(n):
            opt.step(torch.autograd.grad(phase_loss(p),
                                         [p[k] for k in keys]))
            history.append(full_loss(p))
            if history[-1] < best[0]:
                best = (history[-1], snapshot())

    def fd_grad(q, h_pos=0.03, h_ang=0.03):
        g = []
        for kname, h in (("pos", h_pos), ("yaw", h_ang), ("pitch", h_ang)):
            v = q[kname].detach()
            if v.dim() == 0:
                lp = full_loss({**q, kname: v + h})
                lm = full_loss({**q, kname: v - h})
                g.append(torch.tensor((lp - lm) / (2 * h), **f32))
            else:
                rows = []
                for a in range(3):
                    e = torch.zeros(3, **f32)
                    e[a] = h
                    lp = full_loss({**q, kname: v + e})
                    lm = full_loss({**q, kname: v - e})
                    rows.append((lp - lm) / (2 * h))
                g.append(torch.tensor(rows, **f32))
        return g

    # a finite-difference polish of the full pyramid's true loss
    n_fd = max(steps // 6, 30)
    restore(best[1])
    fd_opt = Adam([([p[k] for k in keys], 0.02)], decay_steps=n_fd)
    for _ in range(n_fd):
        fd_opt.step(fd_grad(p))
        history.append(full_loss(p))
        if history[-1] < best[0]:
            best = (history[-1], snapshot())
    fit_s = time.perf_counter() - t0
    pb = best[1]
    with torch.no_grad():
        _write(out, "inverse_camera_fit.png",
               renderer(sc.flat, cam_of(pb), sc.light, cfg))
    loss_floor = full_loss(p_true)
    pos_err = float(torch.linalg.vector_norm(pb["pos"] - pos_t))
    yaw_err = abs(float(pb["yaw"]) - yaw_t)
    pitch_err = abs(float(pb["pitch"]) - pitch_t)
    rec = {
        "config": "scene 1 camera pose (position + yaw/pitch), 800x600, "
                  "3 bounces, production split kernel",
        "device": _device_name(dev),
        "steps": steps, "lr": lr, "fit_wall_s": round(fit_s, 1),
        "loss_first": history[0], "loss_last": history[-1],
        "loss_best": best[0], "best_step": int(np.argmin(history)),
        "loss_floor_at_true_pose": loss_floor,
        "true_pos": pos_t.tolist(),
        "init_pos": p0["pos"].tolist(),
        "recovered_pos": pb["pos"].tolist(),
        "pos_err": pos_err,
        "true_yaw_pitch": [yaw_t, pitch_t],
        "init_yaw_pitch": [float(p0["yaw"]), float(p0["pitch"])],
        "recovered_yaw_pitch": [float(pb["yaw"]), float(pb["pitch"])],
        "yaw_err_deg": yaw_err, "pitch_err_deg": pitch_err,
        "loss_curve": [round(h, 6) for h in history],
    }
    return _verdict(out, "INVERSE_kernel_camera.json", rec, [
        (pos_err < 0.05, f"camera position not recovered: {pos_err}"),
        (yaw_err < 0.05 and pitch_err < 0.05,
         f"camera angles not recovered: {yaw_err}, {pitch_err}")], strict)


# -- the oracle fit -----------------------------------------------------------

def main(out: str = OUT, device=None, strict: bool = True) -> dict:
    """A sphere's position and colour from a 64x48 target through the
    brute-force oracle (200 SGD steps at lr 2.0, as the JAX example).
    Writes INVERSE_oracle.json."""
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    cfg = RenderConfig(width=64, height=48, max_bounces=2, use_bvh=False,
                       ray_chunk=1024)
    b = SceneBuilder()
    b.add_sphere((0.3, -0.2, -5), 1.0, Material(color=(0.9, 0.2, 0.1),
                                                fresnel=0, specular=0.2))
    b.add_wall((-20, 2, -20), 40, 40, (0, 1, 0),
               Material(color=(0.4, 0.4, 0.7), specular=0))
    scene = b.build(device=dev)
    cam = cam_ops.from_euler(position=(0, 0, 0), fov_deg=60,
                             aspect=cfg.width / cfg.height, device=dev)
    light = Light((0, -3, 0), (1, 1, 1), 6.0, device=dev)

    target = render_ref(scene, cam, light, cfg, device=dev)
    _write(out, "inverse_target.png", target)
    init = {
        "sphere_center": _set_row(scene.sphere_center, 0, torch.tensor(
            [-0.4, 0.3, -4.5], device=dev)),
        "mat_color": _set_row(scene.mat_color, 0, torch.tensor(
            [0.2, 0.6, 0.8], device=dev)),
    }
    _write(out, "inverse_init.png",
           render_ref(scene.replace(**init), cam, light, cfg, device=dev))
    t0 = time.perf_counter()
    params, history = fit_scene_params(scene, cam, light, cfg, target, init,
                                       steps=200, lr=2.0)
    fit_s = time.perf_counter() - t0
    print(f"loss: {history[0]:.6f} -> {history[-1]:.6f}")
    print("recovered center:", params["sphere_center"][0].tolist(),
          "true:", scene.sphere_center[0].tolist())
    print("recovered color:", params["mat_color"][0].tolist(),
          "true:", scene.mat_color[0].tolist())
    _write(out, "inverse_fit.png",
           render_ref(scene.replace(**params), cam, light, cfg, device=dev))
    rec = {
        "config": "2 shapes, 64x48, 2 bounces, brute-force oracle, 200 SGD "
                  "steps at lr 2.0",
        "device": _device_name(dev), "fit_wall_s": round(fit_s, 1),
        "loss_first": history[0], "loss_last": history[-1],
        "true_center": scene.sphere_center[0].tolist(),
        "recovered_center": params["sphere_center"][0].tolist(),
        "true_color": scene.mat_color[0].tolist(),
        "recovered_color": params["mat_color"][0].tolist(),
        "loss_curve": [round(h, 6) for h in history],
    }
    return _verdict(out, "INVERSE_oracle.json", rec, [
        (history[-1] < history[0] * 0.1, "optimization failed to converge")],
        strict)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", action="store_true",
                    help="fit through the production split kernel at "
                         "scene-1 scale (800x600)")
    ap.add_argument("--kernel-mesh", action="store_true",
                    help="mesh-translation + light-position fit through "
                         "the production kernel (800x600)")
    ap.add_argument("--kernel-camera", action="store_true",
                    help="camera-pose (position + yaw/pitch) fit through "
                         "the production kernel (800x600)")
    ap.add_argument("--kernel-deform", action="store_true",
                    help="per-vertex mesh deformation fit with Laplacian "
                         "regularization (800x600)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--out", default=OUT,
                    help="directory of the JSON records and PNGs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    kw = dict(out=args.out, device=args.device)
    if args.kernel_deform:
        main_kernel_deform(args.steps,
                           args.lr if args.lr is not None else 0.03, **kw)
    elif args.kernel_camera:
        main_kernel_camera(args.steps,
                           args.lr if args.lr is not None else 0.02, **kw)
    elif args.kernel_mesh:
        main_kernel_mesh(args.steps,
                         args.lr if args.lr is not None else 0.05, **kw)
    elif args.kernel:
        main_kernel(args.steps, args.lr if args.lr is not None else 0.1,
                    **kw)
    else:
        main(**kw)
