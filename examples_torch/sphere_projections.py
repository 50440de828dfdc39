#!/usr/bin/env python3
"""Spherical detector projection methods: the same wide-angle signal
unwrapped with the four azimuthal projections (the PyTorch port of
examples/sphere_projections.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

METHODS = ["Equidistant", "Orthographic", "Equal-Area", "Stereographic"]


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-12, 12, -12, 12, -10, 40], device=device)
    RS = ot.RaySource(ot.Point(), pos=[0, 0, 0], divergence="Isotropic", div_angle=60,
                      spectrum=ot.presets.light_spectrum.d65)
    RT.add(RS)
    RT.add(ot.Detector(ot.SphericalSurface(r=9, R=-10), pos=[0, 0, 20]))

    N = capped(1_000_000, rays)
    RT.trace(N)
    powers, images = {}, {}
    for method in METHODS:
        img = RT.detector_image(projection_method=method)
        powers[method] = img.power()
        images[method] = img.get("Irradiance", 189)
    return dict(rays=N, powers=powers, source_power=RS.power, images=images)


def plot(results):
    from optrace_tpu_torch import plots
    for method, image in results["images"].items():
        plots.image_plot(image, path=f"sphere_projection_{method.replace(' ', '_')}.png")


if __name__ == "__main__":
    plot(main())
    print("saved sphere_projection_*.png")
