#!/usr/bin/env python3
"""Prism dispersion: D65 white light split into its spectral components
(the PyTorch port of examples/prism.py — renders the detector image to
prism.png instead of opening the GUI)."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    n = ot.presets.refraction_index.LAK8

    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -5, 25], device=device)

    RS = ot.RaySource(ot.CircularSurface(r=0.05), divergence="None",
                      spectrum=ot.presets.light_spectrum.d65,
                      pos=[0, -2.5, 0], s=[0, 0.3, 0.7])
    RT.add(RS)

    # prism from two tilted circular surfaces
    front = ot.TiltedSurface(r=3, normal=[0, -0.45, float(np.sqrt(1 - 0.45 ** 2))])
    back = front.copy()
    back.rotate(180)
    RT.add(ot.Lens(front, back, de=0.5, pos=[0, 0, 10], n=n))

    RT.add(ot.Detector(ot.RectangularSurface(dim=[10, 10]), pos=[0, 0, 20]))

    N = capped(500_000, rays)
    RT.trace(N)
    img = RT.detector_image()
    spec = RT.detector_spectrum()
    return dict(rays=N, material=n.desc, abbe_number=float(n.abbe_number()), power=img.power(),
                source_power=RS.power, image=img.get("sRGB (Absolute RI)", 315), spectrum=spec)


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="prism.png")
    plots.spectrum_plot(results["spectrum"], path="prism_spectrum.png")


if __name__ == "__main__":
    results = main()
    print(f"Abbe Number of {results['material']}: {results['abbe_number']:.4g}")
    plot(results)
    print("saved prism.png, prism_spectrum.png; detector power:", f"{results['power']:.4f} W")
