"""The ``fly`` loop: a viewer's stream of frames along the traffic's
camera path through the mix's route (``port.render``), at most
``in_flight`` frames queued on the card (the host waits on frame
i - in_flight's end event before it issues frame i), and the check of
sampled frames against the reference.

A frame is complete at the CUDA event recorded after its render call.
``frame_ms`` is the window's host-clock length, from the first issue to
the synchronize after the last frame, over the frames it completed;
``frame_p95_ms`` the 95th percentile of the intervals between the end
events of successive frames, read once the window has closed.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from rtbench import port
from rtbench.devclock import Clock, release
from rtbench.reference import scene as ref_scene
from rtbench.reference import tracer, traffic, work
from rtbench.spans import Spans

FAULTS = ("stale", "half", "alter")


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Loop:
    def __init__(self, cell, device, fault=None):
        self.cell, self.fault = cell, fault
        self.clock = Clock(device)
        mix, cfg, seed = cell.mix, cell.config, cell.seed
        self.ps = port.build(ref_scene.make_scene(cfg, run_seed=seed), cfg,
                             mix, device)
        self.w, self.h = int(mix["width"]), int(mix["height"])
        self.poses = traffic.fly_poses(mix, cfg["camera"], seed)
        self.pose_t = torch.tensor(self.poses, dtype=torch.float32,
                                   device=device)
        self.consts = port.camera_consts(float(cfg["camera"]["fov_deg"]),
                                         self.w / self.h, device)
        self.period = self.poses.shape[0]
        self.prev = None
        for k in range(int(mix["warmup_frames"])):
            self._issue(port.camera(self.pose_t[self.period - 1 - k],
                                    self.consts))
        self.prev = None

    def window(self, seconds: float, spans: Spans, traced: bool) -> dict:
        """Frames until ``seconds`` of host time have passed, and at least
        the ``check.frames`` that the check keeps; the window closes at
        the synchronize after the last one."""
        n_keep = int(self.cell.mix["check"]["frames"])
        pick = random.Random(self.cell.seed)
        kept = []          # reservoir of (frame index, image)
        ends = []
        in_flight = int(self.cell.mix["in_flight"])
        k = 0
        t0 = time.perf_counter()
        while True:
            if k >= in_flight:
                with spans("wait"):
                    ends[k - in_flight].synchronize()
            if k >= n_keep and time.perf_counter() - t0 >= seconds:
                break
            with spans("camera"):
                cam = port.camera(self.pose_t[k % self.period], self.consts)
            with spans("render"):
                img = self._issue(cam)
            ends.append(self.clock.mark())
            if len(kept) < n_keep:
                kept.append((k, img))
            else:
                j = pick.randrange(k + 1)
                if j < n_keep:
                    kept[j] = (k, img)
            k += 1
        with spans("wait"):
            self.clock.sync()
        t1 = time.perf_counter()
        gaps = [ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))]
        return {"units": k, "seconds": t1 - t0,
                "frame_ms": (t1 - t0) / k * 1e3,
                "frame_p95_ms": percentile(gaps, 95) if gaps else None,
                "gap_ms": [percentile(gaps, q) for q in (5, 50, 90, 99)]
                if gaps else [],
                "kept": sorted(kept, key=lambda x: x[0])}

    def _issue(self, cam):
        if self.fault is None:
            return port.render(self.ps, cam)
        if self.fault == "stale" and self.prev is not None:
            return self.prev
        img = port.render(self.ps, cam)
        if self.fault == "half":
            img = torch.cat([img[: self.h // 2],
                             torch.zeros_like(img[self.h // 2:])])
        elif self.fault == "alter":
            img = img * 1.01
        self.prev = img
        return img

    def answers(self, result: dict) -> list:
        """The sampled pixels of the kept frames, on the host; frees the
        frames and the program's tables."""
        n_pix = int(self.cell.mix["check"]["pixels"])
        out = []
        for i, (k, img) in enumerate(result.pop("kept")):
            pix = traffic.sample_pixels(self.cell.seed, i, self.w * self.h,
                                        n_pix)
            vals = img.reshape(-1, 3)[torch.from_numpy(pix).to(img.device)]
            out.append((k, pix, vals.cpu()))
        self.ps = self.prev = None
        return out

    def numbers(self, result: dict, device, traced: bool):
        """(the numbers compared, the work count with ``traced``, the
        frames that failed), once the window has closed; frees the
        program first."""
        answers = self.answers(result)
        release(device)
        shares = check(self.cell, answers, device)
        work = work_count(self.cell, device) if traced else None
        limit = self.cell.limits.get("worst_frame_px", 0.0)
        return ({"worst_frame_px": max(shares)}, work,
                sum(1 for s in shares if not s <= limit))


def reference_pixels(cell, frames, device, dtype=torch.float32,
                     count: bool = False):
    """The reference's colours of the pixels ``pix`` of each frame ``k``
    of the path, for ``frames`` [(k, pix)]; with ``count`` also the mean
    of the walk's tests a pixel (``tracer.COUNTS``)."""
    mix, cfg = cell.mix, cell.config
    spec = ref_scene.make_scene(cfg, run_seed=cell.seed)
    rs = tracer.ref_scene(spec, device, dtype)
    g = tracer.geometry(spec.flat, device, dtype)
    light = work.light_tensors(spec.light, device, dtype)
    poses = traffic.fly_poses(mix, cfg["camera"], cell.seed)
    w, h = int(mix["width"]), int(mix["height"])
    render = cfg["render"] | {"max_bounces": int(mix["max_bounces"])}
    out, per_px = [], []
    for k, pix in frames:
        o, d, bg = tracer.camera_rays(poses[k % poses.shape[0]],
                                      float(cfg["camera"]["fov_deg"]), w, h,
                                      torch.from_numpy(pix).to(device),
                                      device, dtype)
        counts = torch.zeros((pix.shape[0], rs.count_width),
                             dtype=torch.float64,
                             device=device) if count else None
        out.append(tracer.trace(rs, g, light, o, d, bg, render,
                                counts=counts))
        if count:
            per_px.append(counts.mean(0))
    mean = torch.stack(per_px).mean(0) if count else None
    return out, mean, spec


def check(cell, answers, device) -> list:
    """For each kept frame, the share of its sampled pixels whose largest
    channel lies more than the tolerance from the reference's."""
    refs, _, _ = reference_pixels(cell, [(k, pix) for k, pix, _ in answers],
                                  device)
    tol = float(cell.mix["check"]["tolerance"])
    shares = []
    for (_, _, vals), ref in zip(answers, refs):
        diff = (vals.to(device).float() - ref.float()).abs().amax(-1)
        shares.append(float((~(diff <= tol)).double().mean()))
    return shares


def work_count(cell, device) -> dict:
    """The frozen count of a frame (``work.frame_work``): the mean tests a
    pixel over ``check.count_frames`` views evenly spaced along the path
    (each recurs in every lap of the window), on ``check.count_pixels``
    pixels of each drawn from the seed."""
    c = cell.mix["check"]
    w, h = int(cell.mix["width"]), int(cell.mix["height"])
    period = int(cell.mix["path"]["period_frames"])
    n = int(c["count_frames"])
    frames = [(j * period // n, traffic.sample_pixels(
        cell.seed, 1000 + j, w * h, int(c["count_pixels"])))
        for j in range(n)]
    _, mean, spec = reference_pixels(cell, frames, device, count=True)
    return work.frame_work(mean, spec.flat, w, h)


def control(cell, device, dtype) -> dict:
    """The reference in ``dtype`` in the program's place: the sampled
    pixels of ``check.frames`` frames of the path drawn from the seed,
    judged as a run's."""
    mix = cell.mix
    w, h = int(mix["width"]), int(mix["height"])
    frames = sorted(traffic.rng(cell.seed, 3).choice(
        int(mix["path"]["period_frames"]), size=int(mix["check"]["frames"]),
        replace=False))
    frames = [(int(k), traffic.sample_pixels(cell.seed, i, w * h,
                                             int(mix["check"]["pixels"])))
              for i, k in enumerate(frames)]
    low, _, _ = reference_pixels(cell, frames, device, dtype)
    answers = [(k, pix, v.float().cpu()) for (k, pix), v in zip(frames, low)]
    return {"worst_frame_px": max(check(cell, answers, device))}
