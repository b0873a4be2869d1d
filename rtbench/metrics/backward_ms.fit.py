"""ms a step between the CUDA events around ``torch.autograd.grad``
(autograd through render/whitted.py and diff/kernel_vjp.py), mean over
the traced window."""


def read(ctx):
    return ctx["res"].get("backward_ms") if ctx["kind"] == "fit" else None
