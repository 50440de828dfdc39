#!/usr/bin/env python3
"""Spherical aberration of a singlet lens: paraxial rays and marginal rays
focus at different distances (the PyTorch port of
examples/spherical_aberration.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -25, 40], device=device)

    # paraxial bundle and marginal ring bundle
    RS0 = ot.RaySource(ot.CircularSurface(r=1), divergence="None",
                       spectrum=ot.presets.light_spectrum.d65, pos=[0, 0, -15])
    RS1 = ot.RaySource(ot.RingSurface(r=4.5, ri=1), divergence="None",
                       spectrum=ot.presets.light_spectrum.d65, pos=[0, 0, -15])
    RT.add(RS0)
    RT.add(RS1)

    n = ot.RefractionIndex("Constant", n=1.5)
    L = ot.Lens(ot.SphericalSurface(r=5, R=15), ot.SphericalSurface(r=5, R=-15),
                de=0.2, pos=[0, 0, 0], n=n)
    RT.add(L)

    RT.add(ot.Detector(ot.RectangularSurface(dim=[10, 10]), pos=[0, 0, 23.0]))

    N = capped(1_000_000, rays)
    RT.trace(N)
    res0, fs0 = RT.focus_search("RMS Spot Size", z_start=18, source_index=0)
    res1, _ = RT.focus_search("RMS Spot Size", z_start=18, source_index=1)
    img = RT.detector_image()
    return dict(rays=N, paraxial_focus=float(res0.x), marginal_focus=float(res1.x),
                aberration=float(res0.x - res1.x), focus_bounds=[float(b) for b in fs0["bounds"]],
                power=img.power(), source_power=RS0.power + RS1.power,
                image=img.get("Irradiance", 315))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], log=True, path="spherical_aberration.png")


if __name__ == "__main__":
    results = main()
    print(f"paraxial focus: {results['paraxial_focus']:.3f} mm, marginal focus: "
          f"{results['marginal_focus']:.3f} mm "
          f"(spherical aberration: {results['aberration']:.3f} mm)")
    plot(results)
    print("saved spherical_aberration.png")
