"""Shading constants (port of the parts of
``raytracer_tpu/render/shading.py`` on this path; reference
gpu_shader.comp:331-361, 436, 491).

The background gradient mix(dark, sky, y/H) and the Phong term are
inlined in the whole-frame kernel and its plain version
(render/wholeframe.py), term by term as the JAX kernel has them.
"""

BG_DARK = (0.05, 0.07, 0.1)
BG_SKY = (0.5, 0.7, 1.0)

# Shadowed surfaces are darkened x0.3, not black (gpu_shader.comp:491,591).
SHADOW_FACTOR = 0.3

