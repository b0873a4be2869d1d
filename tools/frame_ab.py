"""A/B of the production frames across copies of the port, in turns: the
one-launch frame and the sorted-continuation hybrid of scenes 1 and 2 at
800x600x3, through ``split.render``.

    python3 tools/frame_ab.py LABEL=DIR [LABEL=DIR ...] [--order a,b,b,a]

Each DIR holds a copy of ``raytracer_tpu_torch/`` (the repo itself,
``.``, or another commit unpacked with ``git archive`` into a git-ignored
directory). Needs a CUDA card. Every copy's kernels are built first, one
process each, all at once; then each label of ``--order`` (default: each
label once) is timed in a process of its own: each frame's ms by CUDA
events over 20 frames, 5 times (chip_smoke.py's ``cuda_ms``), and the
host's issue ms of one frame (``host_ms``). Prints the card's name and
power limit, then one line ``RESULT <label> <json>`` a label. Quicker
than tools/kernel_ab.py (~20 s a label) where only the frames matter.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS, FRAMES = 5, 20


def time_one(label, root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import raytracer_tpu_torch
    from raytracer_tpu_torch.accel import build_bvh, linearize
    from raytracer_tpu_torch.config import RenderConfig
    from raytracer_tpu_torch.render import split_scene
    from raytracer_tpu_torch.render.split import render
    from raytracer_tpu_torch.scenes import generate_scene

    if not os.path.abspath(raytracer_tpu_torch.__file__).startswith(
            os.path.abspath(root)):
        raise RuntimeError(f"{label}: imported {raytracer_tpu_torch.__file__}")
    dev = torch.device("cuda", 0)
    out = {}
    for which in (1, 2):
        sc = generate_scene(which, device=dev)
        lin = linearize(build_bvh(sc.flat, sc.bvh_max_depth))
        split = split_scene.prepare(sc.flat, lin)
        for name, cfg in (("one-launch", RenderConfig()),
                          ("hybrid", RenderConfig(sort_bounces=True))):
            def frame():
                return render(sc.flat, lin, sc.camera, sc.light, cfg,
                              split=split)
            frame()
            key = f"scene {which} {name}"
            out[key] = [cs.cuda_ms(frame, FRAMES) for _ in range(REPS)]
            out[key + " host_ms"] = cs.host_ms(frame, FRAMES)
    print("RESULT", label, json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--time"]:
        time_one(argv[1], argv[2])
        return 0
    order, dirs = None, {}
    args = iter(argv)
    for a in args:
        if a == "--order":
            order = next(args).split(",")
        else:
            label, _, d = a.partition("=")
            dirs[label] = d
    order = order or list(dirs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from raytracer_tpu_torch.render import kernels; kernels.library()",
         os.path.abspath(d)]) for d in dirs.values()]
    if any(p.wait() for p in builds):
        return 1
    rc = 0
    for label in order:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time", label, dirs[label]]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
