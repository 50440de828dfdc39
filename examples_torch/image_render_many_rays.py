#!/usr/bin/env python3
"""Iterative (megabatched) render at 2·10⁷ rays through the ideal camera —
the out-of-core mode for high-quality images (the PyTorch port of
examples/image_render_many_rays.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.presets.geometry import ideal_camera  # noqa: E402
from examples_torch.common import capped, keep_batches  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-8, 8, -8, 8, -60, 35], no_pol=True, device=device)

    img = ot.presets.image.tv_testcard1(s=[8, 8])
    RS = ot.RaySource(img, divergence="Lambertian", div_angle=5, pos=[0, 0, -50])
    RT.add(RS)
    RT.add(ideal_camera(cam_pos=[0, 0, 0], z_g=-50, b=25, r=4, r_det=5))

    N = capped(20_000_000, rays)
    keep_batches(RT, 20_000_000, N)
    imgs = RT.iterative_render(N)
    return dict(rays=N, batches=max(1, int(N / RT.ITER_RAYS_STEP)), power=imgs[0].power(),
                source_power=RS.power, image=imgs[0].get("sRGB (Absolute RI)", 315))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], flip=True, path="image_render_many_rays.png")


if __name__ == "__main__":
    results = main()
    plot(results)
    print("saved image_render_many_rays.png; power:", f"{results['power']:.4f} W")
