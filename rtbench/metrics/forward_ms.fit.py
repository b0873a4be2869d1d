"""ms a step between the CUDA events around the loss evaluation
(diff.make_kernel_renderer: update_dynamic, split.render(differentiable=
True), render/whitted.py; then the loss), mean over the traced window."""


def read(ctx):
    return ctx["res"].get("forward_ms") if ctx["kind"] == "fit" else None
