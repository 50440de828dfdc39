#!/usr/bin/env python3
"""User-defined function surfaces: a lens with crossed cosine-modulated
faces produces a structured PSF (the PyTorch port of
examples/cosine_surfaces.py). A function surface takes torch tensors and
returns a torch tensor."""

import pathlib
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def lens_surfaces():
    """The lens's two faces: cosine ripples along x in front, along y behind."""
    front = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * torch.cos(4 * np.pi * x),
                                 z_min=-0.05, z_max=0.05)
    back = ot.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * torch.cos(4 * np.pi * y),
                                z_min=-0.05, z_max=0.05)
    return front, back


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60], device=device)

    RS = ot.RaySource(ot.CircularSurface(r=2.5), divergence="None",
                      spectrum=ot.LightSpectrum("Monochromatic", wl=550), pos=[0, 0, -5])
    RT.add(RS)

    front, back = lens_surfaces()
    RT.add(ot.Lens(front, back, n=ot.presets.refraction_index.PMMA, pos=[0, 0, 0], d=0.5))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))

    N = capped(500_000, rays)
    RT.trace(N)
    img = RT.detector_image()
    return dict(rays=N, power=img.power(), source_power=RS.power,
                image=img.get("Irradiance", 315))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], log=True, path="cosine_surfaces.png")


if __name__ == "__main__":
    results = main()
    plot(results)
    print("saved cosine_surfaces.png; power:", f"{results['power']:.4f} W")
