"""The whole-frame kernel and the sorted-continuation hybrid (port of
``raytracer_tpu/render/wholeframe.py``).

``wholeframe`` is the wrapper of the CUDA kernel ``wholeframe_kernel``
(csrc/raytrace.cu), which replaces the TPU kernel ``_wholeframe_kernel``
(wholeframe.py:75-385) in its three modes, and does what the JAX
``_wholeframe_render`` plumbing does:

- raygen: one thread per pixel generates its primary ray and background
  from the pixel index and the camera scalars, then runs every bounce
  (closest walk with normals, shadow walk with t_init = light distance,
  material gather by canonical id, Phong with 1/d attenuation and x0.3
  shadows, reflection, optional Fresnel). A frame is one launch; the
  result is (H, W, 3) f32 in image order.
- raygen + ``emit_state``: the same for ``bounces`` bounces (1 in the
  hybrid), and also the continuation state o, d, atten of every pixel; a
  ray that ended leaves the parked ray with its attenuation frozen.
- consume (``rays``, ``ret``): one thread per given ray, o, d and
  optionally the entry attenuation (else 1), with ``ret`` the ray's int32
  image-order pixel index y * W + x, from which the background is
  re-derived with the raygen arithmetic. A parked ray (ox >= 1e30) adds
  nothing. It may emit again.

On a CPU tensor the wrapper runs ``wholeframe_plain``, the same function
in PyTorch.

``_render_blocks`` is the whole-frame route of ``render()``: the one-launch
frame, or, with ``cfg.sort_bounces`` and at least 2 bounces, the hybrid
(wholeframe.py:564-696): bounce 1 emits the reflection rays, a stable
sort by ``whitted._bounce_sort_key`` plus gathers re-packs them into
coherent runs (parked rays last), a continuation launch finishes bounces
2..n, and the un-sorted colours are composited in image order. Per-ray
hits are the same as the one-launch frame's; colours differ only by f32
re-association (the JAX package's bar: 1e-6).

The TPU kernel's tile layout (16x128 tiles of 32x64 pixel blocks, the
f32-carried pixel index, the padding to 832x608) has no counterpart: the
pixel index is an int32, no pixel is padded, and the continuation launch
takes the sorted stream as it is. The JAX A/B switches ``USE_GATHER_REPACK``
and ``CONT_TILE`` (bit-exact either way on its TPU) have no counterpart;
``SLIM_SORT`` is the route taken without ``second_sort``.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytracer_tpu_torch.config import RenderConfig
from raytracer_tpu_torch.geom.direct import INF, div_rn, sqrt_rn
from raytracer_tpu_torch.render import kernels, shading, whitted
from raytracer_tpu_torch.render.split import closest_pass_plain
from raytracer_tpu_torch.render.split_scene import SplitScene

# The whole-frame route (one-launch frame and hybrid); off sends render()
# to the per-bounce route (render/split.py::_render_impl).
USE_WHOLEFRAME = True

PAR_W = 24  # light pos(3) + color(3), camera pos/front/right/up, half_w,
#             half_h, pixel-row offset, 3 unused
N_STATE = 9  # o(3), d(3), atten(3)


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


def _background(yi, h_img):
    f_bg = div_rn(yi, h_img)
    return [d0 + (s0 - d0) * f_bg
            for d0, s0 in zip(shading.BG_DARK, shading.BG_SKY)]


def _trace_plain(split, attr_tab, p, cfg, bounces, st, bg):
    """The bounce loop of ``wholeframe_plain``, in the JAX kernel's order
    of operations, over rays st = [o(3), d(3), atten(3)] (each (R,)) with
    backgrounds bg (3). Returns the colour rows (3) and the state rows
    (9) after the loop."""
    lx, ly, lz, lcr, lcg, lcb = p[0:6]
    ox, oy, oz, dx, dy, dz = st[0:6]
    at = list(st[6:9])
    dev = ox.device
    zero = torch.zeros_like(ox)
    acc = [zero, zero, zero]
    alive = ox < 1e30
    park_o, park_d = whitted.PARK_ORIGIN, whitted._PARK_DIR
    tri_mode = cfg.tri_mode
    for _ in range(bounces):
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
            st_t, _, _ = closest_pass_plain(split, so, sd, tri_mode=tri_mode,
                                            rid=True, t_init=limit)
            in_shadow = st_t < limit
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
    return acc, [ox, oy, oz, dx, dy, dz, *at]


def wholeframe_plain(split: SplitScene, attr_tab: torch.Tensor,
                     par: torch.Tensor, cfg: RenderConfig,
                     pixels: Optional[torch.Tensor] = None, *,
                     bounces: Optional[int] = None, emit_state: bool = False,
                     rays: Optional[torch.Tensor] = None,
                     ret: Optional[torch.Tensor] = None):
    """Plain version of ``wholeframe_kernel`` in all its modes (see
    ``wholeframe``). In raygen mode it traces every pixel (colours (H, W,
    3)) or only the given flat pixel indices y * W + x (colours
    (len(pixels), 3)); in consume mode the given rays (colours (R, 3)).
    With ``emit_state`` it returns (colours, state (9, R))."""
    w_img, h_img = cfg.width, cfg.height
    dev = par.device
    p = [par[i] for i in range(21)]
    y_off = p[20]
    if rays is None:
        pix = (torch.arange(w_img * h_img, device=dev) if pixels is None
               else pixels.to(device=dev, dtype=torch.int64))
        cpx, cpy, cpz, fx_, fy_, fz_ = p[6:12]
        rx_, ry_, rz_, ux_, uy_, uz_ = p[12:18]
        half_w, half_h = p[18:20]
        xi = (pix % w_img).to(torch.float32)
        yi = (pix // w_img).to(torch.float32) + y_off
        ndc_x = div_rn(2.0 * xi, w_img) - 1.0
        ndc_y = 1.0 - div_rn(2.0 * yi, h_img)
        vx = (cpx + fx_ + ndc_x * half_w * rx_ + ndc_y * half_h * ux_) - cpx
        vy = (cpy + fy_ + ndc_x * half_w * ry_ + ndc_y * half_h * uy_) - cpy
        vz = (cpz + fz_ + ndc_x * half_w * rz_ + ndc_y * half_h * uz_) - cpz
        nrm = sqrt_rn(vx * vx + vy * vy + vz * vz)
        one = torch.ones_like(xi)
        st = [torch.broadcast_to(c, xi.shape).clone() for c in (cpx, cpy,
                                                                 cpz)]
        st += [vx / nrm, vy / nrm, vz / nrm, one, one, one]
    else:
        yi = (ret.to(device=dev, dtype=torch.int64) // w_img).to(
            torch.float32) + y_off
        st = list(rays.unbind(0))
        if len(st) == 6:
            st += [torch.ones_like(st[0])] * 3
    acc, state = _trace_plain(split, attr_tab, p, cfg,
                              cfg.max_bounces if bounces is None else bounces,
                              st, _background(yi, h_img))
    out = torch.stack(acc, dim=-1)
    if rays is None and pixels is None:
        out = out.reshape(h_img, w_img, 3)
    return (out, torch.stack(state)) if emit_state else out


def wholeframe(split: SplitScene, attr_tab: torch.Tensor, par: torch.Tensor,
               cfg: RenderConfig, *, bounces: Optional[int] = None,
               emit_state: bool = False, rays: Optional[torch.Tensor] = None,
               ret: Optional[torch.Tensor] = None,
               stats: Optional[torch.Tensor] = None):
    """One launch of ``wholeframe_kernel`` on the current stream (on a CPU
    tensor: ``wholeframe_plain``) for ``bounces`` bounces (default
    cfg.max_bounces).

    Raygen mode (``rays`` None): returns the frame (H, W, 3) f32. Consume
    mode: ``rays`` (6 or 9, R) f32 rows o, d[, atten] and ``ret`` (R,)
    int32 image-order pixel indices; returns (R, 3). With ``emit_state``
    it returns (colours, state (9, R) f32 rows o, d, atten), R = W * H in
    raygen mode, in image order. ``stats``, an int64 (3,) tensor on the
    card, receives the counts of pre-pass, node and triangle tests."""
    dev = par.device
    if dev.type == "cpu":
        return wholeframe_plain(split, attr_tab, par, cfg, bounces=bounces,
                                emit_state=emit_state, rays=rays, ret=ret)
    if dev.type != "cuda":
        raise ValueError(f"wholeframe: unsupported device {dev}")
    w_img, h_img = cfg.width, cfg.height
    bounces = cfg.max_bounces if bounces is None else bounces
    if w_img <= 0 or h_img <= 0 or bounces < 0:
        raise ValueError("width, height must be positive, bounces >= 0")
    kernels.check_tensor("par", par, torch.float32, dev, (PAR_W,))
    kernels.check_tensor("attr_tab", attr_tab, torch.float32, dev,
                         (None, whitted.ATTR_W))
    if attr_tab.shape[0] <= split.max_id:
        raise ValueError(f"attr_tab has {attr_tab.shape[0]} rows; the "
                         f"tables name shape {split.max_id}")
    if rays is None:
        if ret is not None:
            raise ValueError("ret is given without rays")
        n, n_rows = w_img * h_img, 0
        out = torch.empty((h_img, w_img, 3), dtype=torch.float32, device=dev)
    else:
        n_rows, n = rays.shape if rays.dim() == 2 else (None, None)
        if n_rows not in (6, 9):
            raise ValueError(f"rays: shape {tuple(rays.shape)}, expected "
                             "(6 or 9, R)")
        kernels.check_tensor("rays", rays, torch.float32, dev, (n_rows, n))
        kernels.check_tensor("ret", ret, torch.int32, dev, (n,))
        out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if stats is not None:
        kernels.check_tensor("stats", stats, torch.int64, dev, (3,))
    state = torch.empty((N_STATE, n), dtype=torch.float32, device=dev) \
        if emit_state else None
    if n:
        status = kernels.library().rt_wholeframe(
            *kernels.table_args(split, dev), attr_tab.data_ptr(),
            par.data_ptr(), None if rays is None else rays.data_ptr(),
            n_rows, None if ret is None else ret.data_ptr(), n,
            out.data_ptr(), None if state is None else state.data_ptr(),
            w_img, h_img, bounces, cfg.shadow_eps, cfg.reflect_eps,
            int(cfg.use_fresnel), int(cfg.enable_shadows), cfg.tri_mode,
            None if stats is None else stats.data_ptr(),
            kernels.stream_ptr(dev))
        kernels.check_status("wholeframe_kernel", status)
        wholeframe.launches += 1
        mode = ("consume" if rays is not None else "raygen") + \
            ("+emit" if emit_state else "")
        wholeframe.mode_launches[mode] = \
            wholeframe.mode_launches.get(mode, 0) + 1
    return (out, state) if emit_state else out


wholeframe.launches = 0
wholeframe.mode_launches = {}   # launches by mode: raygen[+emit], consume[+emit]


def _repack(state: torch.Tensor, rows: int):
    """The hybrid's re-pack: a stable sort of the continuation rays by the
    bounce-sort key, and the first ``rows`` state rows gathered into that
    order. Returns (rays (rows, R), perm int64: sorted position -> source
    position)."""
    key = whitted._bounce_sort_key(state[0:3].t(), state[3:6].t(),
                                   state[0] < 1e30)
    _, perm = torch.sort(key, stable=True)
    return state[0:rows].index_select(1, perm), perm


def _unsort(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of x (in sorted order) back to source order."""
    return torch.empty_like(x).index_copy_(0, perm, x)


def _hybrid(split: SplitScene, attr_tab: torch.Tensor, par: torch.Tensor,
            cfg: RenderConfig) -> torch.Tensor:
    """The sorted-continuation hybrid (wholeframe.py:594-686). Without
    ``second_sort`` (the JAX ``SLIM_SORT`` route, 2 launches): only o, d
    and the pixel index are re-packed; the continuation accumulates
    relative to attenuation 1, and the colour is acc1 + at1 * unsort(rel)
    in image order. With ``second_sort`` the full state is re-packed (the
    continuation starts from the entry attenuation) and, from 3 bounces
    on, bounce 2 runs alone (consume + emit) before a second re-pack and
    a continuation over bounces 3..n (3 launches)."""
    h_img, w_img, nb = cfg.height, cfg.width, cfg.max_bounces
    acc1, state = wholeframe(split, attr_tab, par, cfg, bounces=1,
                             emit_state=True)
    acc1 = acc1.reshape(-1, 3)
    if not cfg.second_sort:
        rays, perm = _repack(state, 6)
        rel = wholeframe(split, attr_tab, par, cfg, bounces=nb - 1,
                         rays=rays, ret=perm.to(torch.int32))
        colors = acc1 + state[6:9].t() * _unsort(rel, perm)
        return colors.reshape(h_img, w_img, 3)
    rays, perm = _repack(state, N_STATE)
    ret = perm.to(torch.int32)
    if nb >= 3:
        acc2, st2 = wholeframe(split, attr_tab, par, cfg, bounces=1,
                               emit_state=True, rays=rays, ret=ret)
        rays2, perm2 = _repack(st2, N_STATE)
        accc = wholeframe(split, attr_tab, par, cfg, bounces=nb - 2,
                          rays=rays2, ret=ret[perm2])
        tail, perm = accc + acc2[perm2], perm[perm2]
    else:
        tail = wholeframe(split, attr_tab, par, cfg, bounces=nb - 1,
                          rays=rays, ret=ret)
    return (acc1 + _unsort(tail, perm)).reshape(h_img, w_img, 3)


def _render_blocks(scene, split: SplitScene, camera, light,
                   cfg: RenderConfig) -> torch.Tensor:
    """The whole-frame route (the JAX function of this name): the hybrid
    when ``cfg.sort_bounces`` and ``cfg.max_bounces >= 2``, else the
    one-launch frame. The port's kernel writes image order directly, so
    there are no pixel blocks to un-block; the name is kept so the
    counterpart is easy to find."""
    attr_tab = whitted._attr_table(scene)
    par = make_params(camera, light)
    if cfg.sort_bounces and cfg.max_bounces >= 2:
        return _hybrid(split, attr_tab, par, cfg)
    return wholeframe(split, attr_tab, par, cfg)
