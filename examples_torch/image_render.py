#!/usr/bin/env python3
"""Scene imaging through an ideal camera: an RGB image source imaged onto
the detector (the PyTorch port of examples/image_render.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.presets.geometry import ideal_camera  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-8, 8, -8, 8, -60, 35], device=device)

    # image source: preset scene on a 8x8mm emitter at z=-50
    img = ot.presets.image.color_checker(s=[8, 8])
    RS = ot.RaySource(img, divergence="Lambertian", div_angle=5, pos=[0, 0, -50])
    RT.add(RS)

    RT.add(ideal_camera(cam_pos=[0, 0, 0], z_g=-50, b=25, r=4, r_det=5))

    N = capped(2_000_000, rays)
    RT.trace(N)
    dimg = RT.detector_image()
    return dict(rays=N, power=dimg.power(), source_power=RS.power,
                image=dimg.get("sRGB (Absolute RI)", 315))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], flip=True, path="image_render.png")


if __name__ == "__main__":
    results = main()
    plot(results)
    print("saved image_render.png; power:", f"{results['power']:.4f} W")
