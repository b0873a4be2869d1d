"""Host ms a frame spends issuing it: the benchmark's spans around the
camera build (core/camera.py::from_euler) and the render call
(render/split.py::render, which returns without a sync), over the traced
window's frames."""


def read(ctx):
    if ctx["kind"] != "fly" or not ctx["res"]["units"]:
        return None
    s = ctx["spans"]
    return (s.get("camera", 0.0) + s.get("render", 0.0)) / \
        ctx["res"]["units"] * 1e3
