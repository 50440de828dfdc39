#!/usr/bin/env python3
"""Achromatic doublet: crown+flint cemented pair cancels the chromatic
focal shift (the PyTorch port of examples/achromat.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

LINES = [(486.13, "F"), (587.56, "d"), (656.27, "C")]


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 80], device=device)

    RS = ot.RaySource(ot.CircularSurface(r=2.5), divergence="None",
                      spectrum=ot.presets.light_spectrum.FDC,
                      pos=[0, 0, -5])
    RT.add(RS)

    # BK7 crown + SF10 flint cemented doublet (catalog-style prescription)
    bk7 = ot.presets.refraction_index.BK7
    sf10 = ot.presets.refraction_index.SF10

    L1 = ot.Lens(ot.SphericalSurface(r=3, R=33.55), ot.SphericalSurface(r=3, R=-27.05),
                 n=bk7, n2=sf10, pos=[0, 0, 0], d1=0, d2=2.8)
    L2 = ot.Lens(ot.SphericalSurface(r=3, R=-27.05), ot.SphericalSurface(r=3, R=-96.08),
                 n=sf10, pos=[0, 0, 2.8 + 1e-6], d1=0, d2=1.0)
    RT.add(L1)
    RT.add(L2)

    RT.add(ot.Detector(ot.RectangularSurface(dim=[2, 2]), pos=[0, 0, 60]))

    N = capped(500_000, rays)
    RT.trace(N)
    # per-line focus: the achromat brings F and C lines to a common focus
    focal_points = {}
    for wl, name in LINES:
        tma = ot.TMA(RT.lenses, wl=wl)
        focal_points[name] = float(tma.focal_points[1])
    res, fsdict = RT.focus_search("RMS Spot Size", z_start=40)
    RT.detectors[0].move_to([0, 0, res.x])
    img = RT.detector_image()
    return dict(rays=N, focal_points=focal_points, focus=float(res.x),
                focus_bounds=[float(b) for b in fsdict["bounds"]], power=img.power(),
                source_power=RS.power, image=img.get("sRGB (Absolute RI)", 189))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="achromat.png")


if __name__ == "__main__":
    results = main()
    for wl, name in LINES:
        print(f"line {name} ({wl:.1f} nm): focal point at {results['focal_points'][name]:.4f} mm")
    plot(results)
    print(f"best focus at {results['focus']:.3f} mm; saved achromat.png")
