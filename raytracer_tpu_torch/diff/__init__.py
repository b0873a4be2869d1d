"""Differentiable rendering through the production kernel and the inverse
fits (port of ``raytracer_tpu/diff``)."""

from raytracer_tpu_torch.diff.inverse import (fit_scene_params, image_loss,
                                              image_loss_pyramid,
                                              make_kernel_renderer,
                                              make_loss_fn)

__all__ = ["image_loss", "image_loss_pyramid", "fit_scene_params",
           "make_kernel_renderer", "make_loss_fn"]
