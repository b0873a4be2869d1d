"""The ``fit`` loop: inverse rendering through the production kernel. One
step is the loss of the image that ``diff.make_kernel_renderer``
renders (the tables refreshed with ``update_dynamic``, then
``split.render(differentiable=True)``) against the target,
``torch.autograd.grad`` and an Adam update (``torch.optim.Adam``, a
group a parameter at the traffic's rate).

The set-up builds one fit, renders the target from the true scene
without gradients, and warms every operation of a step up without
moving the start (``warmup_steps`` losses and gradients, and an update
of a spare copy). The window's first ``check.steps`` steps are the
fit's first, from the seed's start; they keep each step's loss, the
first image, the first gradient as Adam holds it after one step and the
parameters' change after the last. The check follows them with the
reference and compares those and the target.

Parameters (``params`` of the mix): ``shape_row`` fits one row of a shape
field (the group's first shape), ``translate`` a rigid translation of
the group's triangles (their planes recomputed from the vertices),
``light_position`` the light. ``step_ms`` is the window's host-clock
length over the steps completed in it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import port
from rtbench.devclock import Clock, release
from rtbench.reference import scene as ref_scene
from rtbench.reference import tracer, traffic, work
from rtbench.spans import Spans

FAULTS = ("stale", "half", "alter")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def start_values(mix, spec, seed) -> dict:
    """Each parameter's starting value, f64 on the host."""
    start = traffic.fit_start(mix, seed)
    out = {}
    for prm in mix["params"]:
        name, kind = prm["name"], prm["kind"]
        if kind == "shape_row":
            row = int(spec.groups[prm["group"]][0])
            truth = spec.flat[prm["field"]][row].astype(np.float64)
        elif kind == "translate":
            truth = np.zeros(3)
        elif kind == "light_position":
            truth = np.asarray(spec.light["position"], np.float64)
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = truth + start[name] if "offset_norm" in prm \
            else start[name]
    return out


def image_loss(mix, img, target):
    """The mix's loss of an (H, W, 3) image: the pixel MSE, or the sum of
    the MSEs of s x s average-pooled copies (whole windows), s in
    ``scales``."""
    loss = mix["loss"]
    if loss["kind"] == "mse":
        return torch.mean((img - target) ** 2)
    total = 0.0
    for s in loss["scales"]:
        h, w = img.shape[0] // s, img.shape[1] // s
        a = img[:h * s, :w * s].reshape(h, s, w, s, 3).sum((1, 3)) / (s * s)
        b = target[:h * s, :w * s].reshape(h, s, w, s, 3).sum((1, 3)) / (s * s)
        total = total + torch.mean((a - b) ** 2)
    return total


class Loop:
    def __init__(self, cell, device, fault=None):
        from raytracer_tpu_torch import diff
        self.diff = diff
        self.cell, self.fault = cell, fault
        mix, cfg, seed = cell.mix, cell.config, cell.seed
        self.clock = Clock(device)
        spec = ref_scene.make_scene(cfg, run_seed=seed)
        self.spec = spec
        self.ps = port.build(spec, cfg, mix, device)
        w, h = int(mix["width"]), int(mix["height"])
        pose = traffic.look_at_pose(cfg["camera"]["position"],
                                    cfg["camera"]["look_at"])
        consts = port.camera_consts(float(cfg["camera"]["fov_deg"]), w / h,
                                    device)
        self.cam = port.camera(torch.tensor(pose, dtype=torch.float32,
                                            device=device), consts)
        self.renderer = diff.make_kernel_renderer(self.ps.bvh, self.ps.split,
                                                  device=device)
        with torch.no_grad():
            self.target = self.renderer(self.ps.flat, self.cam, self.ps.light,
                                        self.ps.cfg)
        f32 = dict(dtype=torch.float32, device=device)
        self.leaves = {n: torch.tensor(v, **f32).requires_grad_(True)
                       for n, v in start_values(mix, spec, seed).items()}
        self.opt = torch.optim.Adam([{"params": [self.leaves[p["name"]]],
                                      "lr": p["lr"]} for p in mix["params"]])
        self.masks = {}
        for p in mix["params"]:
            if p["kind"] == "translate":
                m = torch.zeros((spec.num_shapes, 1), **f32)
                m[torch.from_numpy(spec.groups[p["group"]]).to(device)] = 1.0
                self.masks[p["name"]] = m
        self.n_check = int(mix["check"]["steps"])
        self.p0 = {n: v.detach().clone() for n, v in self.leaves.items()}
        self.image1 = None
        self.rec = {"losses": []}
        self._warm_up(int(mix["warmup_steps"]))

    def _warm_up(self, passes: int) -> None:
        """Every operation of a step, the start left as it is: ``passes``
        losses and gradients at the start, and one update of a spare copy
        of the parameters by a spare optimizer of the same groups."""
        leaves = list(self.leaves.values())
        for _ in range(max(passes, 1)):
            grads = torch.autograd.grad(self.loss(), leaves)
        spare = [v.detach().clone().requires_grad_(True) for v in leaves]
        opt = torch.optim.Adam([{"params": [c], "lr": g["lr"]} for c, g in
                                zip(spare, self.opt.param_groups)])
        for c, g in zip(spare, grads):
            c.grad = g
        opt.step()

    def scene(self):
        """The program's scene and light at the current parameters."""
        flat, light = self.ps.flat, self.ps.light
        fields, moved = {}, False
        for p in self.cell.mix["params"]:
            leaf = self.leaves[p["name"]]
            if p["kind"] == "shape_row":
                row = int(self.spec.groups[p["group"]][0])
                x = fields.get(p["field"], getattr(flat, p["field"]))
                fields[p["field"]] = torch.cat([x[:row], leaf[None],
                                                x[row + 1:]])
            elif p["kind"] == "translate":
                dm = self.masks[p["name"]] * leaf
                for f in ("tri_p1", "tri_p2", "tri_p3"):
                    fields[f] = fields.get(f, getattr(flat, f)) + dm
                moved = True
            else:
                light = type(light)(leaf, light.base_color, light.intensity)
        s = flat.replace(**fields)
        return (s.recompute_tri_planes() if moved else s), light

    def loss(self, keep_image=False):
        s, light = self.scene()
        img = self.renderer(s, self.cam, light, self.ps.cfg)
        if self.fault == "alter":
            img = img * 1.01
        if keep_image:
            self.image1 = img.detach()
        target = self.target
        if self.fault == "half":
            img, target = img[: img.shape[0] // 2], target[: img.shape[0] // 2]
        mix = self.cell.mix
        if mix["loss"]["kind"] == "mse":
            return self.diff.image_loss(img, target)
        return self.diff.image_loss_pyramid(img, target,
                                            tuple(mix["loss"]["scales"]))

    def step(self, k: int, spans: Spans, marks=None):
        """The window's step ``k``; the first ``check.steps`` keep what the
        check compares (device tensors, no sync)."""
        leaves = list(self.leaves.values())
        if marks is not None:
            marks.append(self.clock.mark())
        with spans("loss"):
            val = self.loss(keep_image=k == 0)
        if marks is not None:
            marks.append(self.clock.mark())
        with spans("autograd"):
            grads = torch.autograd.grad(val, leaves)
        if marks is not None:
            marks.append(self.clock.mark())
        with spans("optimizer"):
            for p, g in zip(leaves, grads):
                p.grad = g
            if self.fault != "stale":
                self.opt.step()
        if k < self.n_check:
            self.rec["losses"].append(val.detach())
            if k == 0:
                self.rec["grad1"] = {n: self.opt.state[v].get(
                    "exp_avg", torch.zeros_like(v)).clone() / (1 - BETA1)
                    for n, v in self.leaves.items()}
            if k == self.n_check - 1:
                self.rec["change"] = {n: v.detach() - self.p0[n]
                                      for n, v in self.leaves.items()}

    def window(self, seconds: float, spans: Spans, traced: bool) -> dict:
        """Steps until ``seconds`` of host time have passed, and at least
        the ``check.steps`` that the check compares."""
        marks = [] if traced else None
        k = 0
        t0 = time.perf_counter()
        while k < self.n_check or time.perf_counter() - t0 < seconds:
            self.step(k, spans, marks)
            k += 1
        with spans("wait"):
            self.clock.sync()
        t1 = time.perf_counter()
        out = {"units": k, "seconds": t1 - t0,
               "step_ms": (t1 - t0) / k * 1e3}
        if marks:
            fwd = [self.clock.ms(marks[i], marks[i + 1])
                   for i in range(0, len(marks), 3)]
            bwd = [self.clock.ms(marks[i + 1], marks[i + 2])
                   for i in range(0, len(marks), 3)]
            out["forward_ms"] = float(np.mean(fwd))
            out["backward_ms"] = float(np.mean(bwd))
        return out

    def answers(self, result: dict) -> dict:
        """What the check compares, on the host; frees the program."""
        cpu = lambda d: {n: v.cpu() for n, v in d.items()}   # noqa: E731
        rec = self.rec
        out = {"target": self.target.cpu(), "image1": self.image1.cpu(),
               "losses": [float(v) for v in rec["losses"]],
               "grad1": cpu(rec["grad1"]), "change": cpu(rec["change"])}
        self.ps = self.renderer = self.target = self.image1 = None
        self.opt = self.leaves = self.rec = None
        return out

    def numbers(self, result: dict, device, traced: bool):
        """(the numbers compared, the work count of the first step's frame
        with ``traced``, the numbers over their limits), once the window
        has closed; frees the program first."""
        ans = self.answers(result)
        release(device)
        ref = reference_steps(self.cell, device, count=traced)
        nums = compare(ans, ref, float(self.cell.mix["check"]["tolerance"]))
        bad = sum(1 for k, v in nums.items()
                  if not v <= self.cell.limits.get(k, 0.0))
        return nums, ref.get("work"), bad


def reference_steps(cell, device, dtype=torch.float32,
                    count: bool = False) -> dict:
    """The reference's target, first image, losses, first gradients and
    change after ``check.steps`` steps of plain Adam from the same start,
    and with ``count`` the work count of the first step's frame."""
    mix, cfg, seed = cell.mix, cell.config, cell.seed
    spec = ref_scene.make_scene(cfg, run_seed=seed)
    rs = tracer.ref_scene(spec, device, dtype)
    g0 = tracer.geometry(spec.flat, device, dtype)
    light0 = work.light_tensors(spec.light, device, dtype)
    w, h = int(mix["width"]), int(mix["height"])
    render = cfg["render"] | {"max_bounces": int(mix["max_bounces"])}
    pose = traffic.look_at_pose(cfg["camera"]["position"],
                                cfg["camera"]["look_at"])
    o, d, bg = tracer.camera_rays(pose, float(cfg["camera"]["fov_deg"]), w,
                                  h, torch.arange(w * h, device=device),
                                  device, dtype)
    with torch.no_grad():
        target = tracer.trace(rs, g0, light0, o, d, bg, render).reshape(
            h, w, 3)
    starts = start_values(mix, spec, seed)
    leaves = {n: torch.tensor(v, dtype=torch.float32, device=device).to(
        dtype).requires_grad_(True) for n, v in starts.items()}
    p0 = {n: v.detach().clone() for n, v in leaves.items()}
    m = {n: torch.zeros_like(v) for n, v in leaves.items()}
    v2 = {n: torch.zeros_like(v) for n, v in leaves.items()}
    lr = {p["name"]: p["lr"] for p in mix["params"]}
    losses, out = [], {"target": target}
    for i in range(int(mix["check"]["steps"])):
        g, light = dict(g0), dict(light0)
        for p in mix["params"]:
            leaf = leaves[p["name"]]
            if p["kind"] == "shape_row":
                row = torch.tensor([int(spec.groups[p["group"]][0])],
                                   device=device)
                g[p["field"]] = g[p["field"]].index_copy(0, row, leaf[None])
            elif p["kind"] == "translate":
                rows = torch.from_numpy(spec.groups[p["group"]]).to(device)
                for f in ("tri_p1", "tri_p2", "tri_p3"):
                    g[f] = g[f].index_add(0, rows, leaf.expand(
                        rows.shape[0], 3))
                g = tracer.tri_planes(g, rows)
            else:
                light["position"] = leaf
        rs.refit({k: x.detach() for k, x in g.items()})
        counts = torch.zeros((w * h, rs.count_width), dtype=torch.float64,
                             device=device) if count and i == 0 else None
        img = tracer.trace(rs, g, light, o, d, bg, render, grad=True,
                           counts=counts).reshape(h, w, 3)
        loss = image_loss(mix, img, target)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (n, leaf), gr in zip(leaves.items(), grads):
                m[n] = BETA1 * m[n] + (1 - BETA1) * gr
                v2[n] = BETA2 * v2[n] + (1 - BETA2) * gr * gr
                mh = m[n] / (1 - BETA1 ** (i + 1))
                vh = v2[n] / (1 - BETA2 ** (i + 1))
                leaf -= lr[n] * mh / (torch.sqrt(vh) + EPS)
        if i == 0:
            out["image1"] = img.detach()
            out["grad1"] = {n: gr.detach() for n, gr in
                            zip(leaves.keys(), grads)}
            if counts is not None:
                out["work"] = work.frame_work(counts.mean(0), spec.flat, w,
                                              h)
    out["losses"] = losses
    out["change"] = {n: (v.detach() - p0[n]) for n, v in leaves.items()}
    return out


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's; only the leaves in ``keep`` (default all)."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in ref}
    med = float(np.median(list(norms.values())))
    keep = list(ref) if keep is None else keep
    return max(abs(float(torch.linalg.vector_norm(prog[n].double()))
                   - norms[n]) / max(norms[n], med, 1e-30) for n in keep)


def moving_leaves(grad: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of at least a thousandth of the median leaf's (a leaf below it
    moves under Adam by round-off alone)."""
    norms = {n: float(torch.linalg.vector_norm(g.double()))
             for n, g in grad.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def compare(ans: dict, ref: dict, tol: float) -> dict:
    def px(a, b):
        diff = (a.double() - b.double().cpu()).abs().amax(-1)
        return float((~(diff <= tol)).double().mean())
    grad = {n: v.cpu() for n, v in ref["grad1"].items()}
    return {
        "target_px": px(ans["target"], ref["target"]),
        "image_px": px(ans["image1"], ref["image1"]),
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(ans["losses"], ref["losses"])),
        "grad_gap": leaf_gap(ans["grad1"], grad),
        "update_gap": leaf_gap(ans["change"], {n: v.cpu() for n, v in
                                               ref["change"].items()},
                               moving_leaves(grad)),
    }


def control(cell, device, dtype) -> dict:
    """The reference in ``dtype`` in the program's place, judged against
    the float32 reference as a run's steps are."""
    low = reference_steps(cell, device, dtype)
    low["target"] = low["target"].float().cpu()
    low["image1"] = low["image1"].float().cpu()
    ref = reference_steps(cell, device)
    return compare(low, ref, float(cell.mix["check"]["tolerance"]))
