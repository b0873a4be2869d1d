"""The one-launch whole-frame path (port of
``raytracer_tpu/render/wholeframe.py``, raygen mode).

``wholeframe`` is the wrapper of the CUDA kernel ``wholeframe_kernel``
(csrc/raytrace.cu), which replaces the TPU kernel ``_wholeframe_kernel``
(wholeframe.py:75-385) in raygen mode: one thread per pixel generates its
primary ray and background from the pixel index and the camera scalars,
then runs every bounce (closest walk with normals, shadow walk with
t_init = light distance, material gather by canonical id, Phong with 1/d
attenuation and x0.3 shadows, reflection, optional Fresnel). A frame is
one launch and the result is (H, W, 3) f32 in image order. On a CPU tensor
the wrapper runs ``wholeframe_plain``, the same function in PyTorch.

The TPU kernel's tile layout (16x128 tiles of 32x64 pixel blocks, the
f32-carried pixel index, the padding to 832x608) has no counterpart: the
pixel index is an int32 and no pixel is padded. The sorted-continuation
hybrid's state modes are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.geom.direct import INF, div_rn, sqrt_rn
from raytracer_tpu_torch.render import kernels, shading, whitted
from raytracer_tpu_torch.render.split import closest_pass_plain
from raytracer_tpu_torch.render.split_scene import SplitScene

PAR_W = 24  # light pos(3) + color(3), camera pos/front/right/up, half_w,
#             half_h, pixel-row offset, 3 unused


def make_params(camera, light) -> torch.Tensor:
    """The (24,) f32 parameter row of the JAX kernel's raygen mode (its
    pixel-row offset, slot 20, serves strip sharding, not ported yet: 0)."""
    half_w, half_h = camera.half_extent()
    dev = camera.device
    return torch.cat([
        light.position, light.color, camera.position, camera.front,
        camera.right, camera.up, torch.stack([half_w, half_h]).reshape(2),
        torch.zeros(4, dtype=torch.float32,
                     device=dev)]).to(torch.float32).contiguous()


def wholeframe_plain(split: SplitScene, attr_tab: torch.Tensor,
                     par: torch.Tensor, cfg: RenderConfig,
                     pixels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``wholeframe_kernel``, in the JAX kernel's order of
    operations. Traces every pixel (returns (H, W, 3)) or only the given
    flat pixel indices y * W + x (returns (len(pixels), 3))."""
    w_img, h_img = cfg.width, cfg.height
    dev = par.device
    pix = (torch.arange(w_img * h_img, device=dev) if pixels is None
           else pixels.to(device=dev, dtype=torch.int64))
    p = [par[i] for i in range(21)]
    lx, ly, lz, lcr, lcg, lcb = p[0:6]
    cpx, cpy, cpz, fx_, fy_, fz_ = p[6:12]
    rx_, ry_, rz_, ux_, uy_, uz_ = p[12:18]
    half_w, half_h, y_off = p[18:21]

    xi = (pix % w_img).to(torch.float32)
    yi = (pix // w_img).to(torch.float32) + y_off
    ndc_x = div_rn(2.0 * xi, w_img) - 1.0
    ndc_y = 1.0 - div_rn(2.0 * yi, h_img)
    vx = (cpx + fx_ + ndc_x * half_w * rx_ + ndc_y * half_h * ux_) - cpx
    vy = (cpy + fy_ + ndc_x * half_w * ry_ + ndc_y * half_h * uy_) - cpy
    vz = (cpz + fz_ + ndc_x * half_w * rz_ + ndc_y * half_h * uz_) - cpz
    nrm = sqrt_rn(vx * vx + vy * vy + vz * vz)
    ox = torch.broadcast_to(cpx, xi.shape).clone()
    oy = torch.broadcast_to(cpy, xi.shape).clone()
    oz = torch.broadcast_to(cpz, xi.shape).clone()
    dx, dy, dz = vx / nrm, vy / nrm, vz / nrm
    f_bg = div_rn(yi, h_img)
    bg = [d0 + (s0 - d0) * f_bg
          for d0, s0 in zip(shading.BG_DARK, shading.BG_SKY)]

    zero = torch.zeros_like(ox)
    acc = [zero, zero, zero]
    at = [torch.ones_like(ox)] * 3
    alive = ox < 1e30
    park_o, park_d = whitted.PARK_ORIGIN, whitted._PARK_DIR
    tri_mode = cfg.tri_mode
    for _ in range(cfg.max_bounces):
        t, gid, n = closest_pass_plain(split, (ox, oy, oz), (dx, dy, dz),
                                       tri_mode=tri_mode, rid=True,
                                       with_normals=True)
        nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
        hit = t < INF
        miss_now = alive & ~hit
        acc = [a + torch.where(miss_now, g * b, 0.0)
               for a, g, b in zip(acc, at, bg)]
        live = alive & hit

        ts = torch.where(hit, t, 0.0)
        px = ox + ts * dx
        py = oy + ts * dy
        pz = oz + ts * dz
        ldx = lx - px
        ldy = ly - py
        ldz = lz - pz
        dist = sqrt_rn(ldx * ldx + ldy * ldy + ldz * ldz)
        if cfg.enable_shadows:
            inv = 1.0 / torch.maximum(dist, torch.tensor(1e-30, device=dev))
            eps = cfg.shadow_eps
            so = tuple(torch.where(hit, pc + nc * eps, park_o)
                       for pc, nc in ((px, nx), (py, ny), (pz, nz)))
            sd = tuple(torch.where(hit, lc * inv, park_d)
                       for lc in (ldx, ldy, ldz))
            limit = torch.where(hit, dist, 0.0)
            st, _, _ = closest_pass_plain(split, so, sd, tri_mode=tri_mode,
                                          rid=True, t_init=limit)
            in_shadow = st < limit
        else:
            in_shadow = torch.zeros_like(hit)

        # material: the JAX kernel's static resolve over rid_values is the
        # gather attr_tab[rid] on hit lanes and zeros elsewhere
        rid = torch.clamp_min(gid, 0).to(torch.int64)
        mat = torch.where(hit[:, None], attr_tab[rid, 3:11], 0.0)
        mcr, mcg, mcb, ka, kd, ks, kf, shin = mat.unbind(1)

        dist_p = sqrt_rn(torch.maximum(ldx * ldx + ldy * ldy + ldz * ldz,
                                          torch.tensor(1e-30, device=dev)))
        lc = [lcr / dist_p, lcg / dist_p, lcb / dist_p]
        ldnx = ldx / dist_p
        ldny = ldy / dist_p
        ldnz = ldz / dist_p
        diff = torch.clamp_min(nx * ldnx + ny * ldny + nz * ldnz, 0.0)
        dotln = nx * ldnx + ny * ldny + nz * ldnz
        rdx = -ldnx + 2.0 * dotln * nx
        rdy = -ldny + 2.0 * dotln * ny
        rdz = -ldnz + 2.0 * dotln * nz
        spec_cos = torch.clamp_min(dx * rdx + dy * rdy + dz * rdz, 0.0)
        spec = torch.pow(spec_cos, shin)
        specc = torch.where(diff > 0, ks * spec, 0.0)
        col = [(ka * lci + (kd * diff) * lci + specc * lci) * mci
               for lci, mci in zip(lc, (mcr, mcg, mcb))]
        col = [torch.where(in_shadow, c * shading.SHADOW_FACTOR, c)
               for c in col]
        acc = [a + torch.where(live, g * c, 0.0)
               for a, g, c in zip(acc, at, col)]

        # reflection (gpu_shader.comp:495-516)
        dotdn = nx * dx + ny * dy + nz * dz
        ndx = dx - 2.0 * dotdn * nx
        ndy = dy - 2.0 * dotdn * ny
        ndz = dz - 2.0 * dotdn * nz
        cont = live & (ks > 0)
        mc = (mcr, mcg, mcb)
        if cfg.use_fresnel:
            cosr = torch.clamp_min(-(ndx * nx + ndy * ny + ndz * nz), 0.0)
            x1 = 1.0 - cosr
            x2 = x1 * x1
            f = torch.clamp(x1 * (x2 * x2), 0.0, 0.8)   # integer_pow(x, 5)
            w = kf * f
            nat = [g * (m + (1.0 - m) * w) for g, m in zip(at, mc)]
            # the extra term is NOT attenuated (reference double-count)
            acc = [a + torch.where(cont, (1.0 - w) * m * c, 0.0)
                   for a, m, c in zip(acc, mc, col)]
        else:
            nat = [g * ks for g in at]
        at = [torch.where(cont, ng, g) for ng, g in zip(nat, at)]
        ox = torch.where(cont, px + nx * cfg.reflect_eps, park_o)
        oy = torch.where(cont, py + ny * cfg.reflect_eps, park_o)
        oz = torch.where(cont, pz + nz * cfg.reflect_eps, park_o)
        dx = torch.where(cont, ndx, park_d)
        dy = torch.where(cont, ndy, park_d)
        dz = torch.where(cont, ndz, park_d)
        alive = cont

    out = torch.stack(acc, dim=-1)
    return out.reshape(h_img, w_img, 3) if pixels is None else out


def wholeframe(split: SplitScene, attr_tab: torch.Tensor, par: torch.Tensor,
               cfg: RenderConfig,
               stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The frame (H, W, 3) f32. On a CUDA tensor this launches
    ``wholeframe_kernel`` once on the current stream; on a CPU tensor it
    runs ``wholeframe_plain``. ``stats``, an int64 (3,) tensor on the
    card, receives the counts of pre-pass, node and triangle tests."""
    dev = par.device
    if dev.type == "cpu":
        return wholeframe_plain(split, attr_tab, par, cfg)
    if dev.type != "cuda":
        raise ValueError(f"wholeframe: unsupported device {dev}")
    w_img, h_img = cfg.width, cfg.height
    if w_img <= 0 or h_img <= 0 or cfg.max_bounces < 0:
        raise ValueError("width, height must be positive, max_bounces >= 0")
    kernels.check_tensor("par", par, torch.float32, dev, (PAR_W,))
    kernels.check_tensor("attr_tab", attr_tab, torch.float32, dev,
                         (None, whitted.ATTR_W))
    if attr_tab.shape[0] <= split.max_id:
        raise ValueError(f"attr_tab has {attr_tab.shape[0]} rows; the "
                         f"tables name shape {split.max_id}")
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (3,))
    out = torch.empty((h_img, w_img, 3), dtype=torch.float32, device=dev)
    args = kernels.table_args(split, dev)
    status = kernels.library().rt_wholeframe(
        *args, attr_tab.data_ptr(), par.data_ptr(), out.data_ptr(), w_img,
        h_img, cfg.max_bounces, cfg.shadow_eps, cfg.reflect_eps,
        int(cfg.use_fresnel), int(cfg.enable_shadows), cfg.tri_mode,
        None if stats is None else stats.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check_status("wholeframe_kernel", status)
    wholeframe.launches += 1
    return out


wholeframe.launches = 0


def _wholeframe_render(split: SplitScene, attr_tab: torch.Tensor, light,
                       cfg: RenderConfig, camera) -> torch.Tensor:
    """Trace the frame in one launch, with in-kernel raygen from the
    camera (the JAX function's raygen mode)."""
    return wholeframe(split, attr_tab, make_params(camera, light), cfg)


def _render_blocks(scene, split: SplitScene, camera, light,
                   cfg: RenderConfig) -> torch.Tensor:
    """Whole-frame render (the JAX function's non-hybrid branch). The
    port's kernel writes image order directly, so there are no pixel
    blocks to un-block; the name is kept so the counterpart is easy to
    find."""
    return _wholeframe_render(split, whitted._attr_table(scene), light, cfg,
                              camera)
