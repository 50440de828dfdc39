#!/usr/bin/env python3
"""57-surface microscope (Nikon patent objective + eyepiece, the reference
benchmark geometry) imported from ZEMAX files and traced end to end (the
PyTorch port of examples/microscope.py). It needs the public .zmx/.agf
fixtures of the reference package's examples in ``examples_torch/resources``
(``materials/`` and ``microscope/``), which the repository does not ship;
without them ``main`` exits."""

import os
import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

RES = str(pathlib.Path(__file__).resolve().parent / "resources")


def main(device=None, rays=None):
    if not os.path.isdir(RES):
        raise SystemExit("reference resource files not mounted — this example "
                         "needs the public .zmx/.agf fixtures")

    with ot.global_options.no_warnings():
        n_dict = {}
        for cat in ["schott.agf", "ohara.agf", "hikari.agf", "hoya.agf"]:
            p = os.path.join(RES, "materials", cat)
            if os.path.isfile(p):
                n_dict |= ot.load_agf(p)

        G = ot.load_zmx(os.path.join(
            RES, "microscope", "Nikon_1p25NA_60x_US7889433B2_MultiConfig_v2.zmx"),
            n_dict=n_dict)

    ext = G.extent
    RT = ot.Raytracer(outline=[ext[0] - 2, ext[1] + 2, ext[2] - 2, ext[3] + 2,
                               ext[4] - 10, ext[5] + 10], no_pol=True, device=device)
    RT.add(G)
    RS = ot.RaySource(ot.Point(), pos=[0, 0, ext[4] - 5], divergence="Isotropic",
                      div_angle=25, spectrum=ot.LightSpectrum("Monochromatic", wl=550))
    RT.add(RS)

    N = capped(500_000, rays)
    RT.trace(N)
    img = RT.detector_image()
    return dict(rays=N, lenses=len(G.lenses), tracing_surfaces=len(G.tracing_surfaces),
                power=img.power(), source_power=RS.power, image=img.get("Irradiance", 189))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="microscope_psf.png")


if __name__ == "__main__":
    results = main()
    print(f"microscope: {results['lenses']} lenses, {results['tracing_surfaces']} tracing surfaces")
    plot(results)
    print("saved microscope_psf.png; detector power:", f"{results['power']:.5f} W")
