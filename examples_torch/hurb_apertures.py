#!/usr/bin/env python3
"""HURB edge diffraction: slit and pinhole far fields via Heisenberg
uncertainty ray bending (the PyTorch port of examples/hurb_apertures.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    N = capped(1_000_000, rays)
    powers, source_powers, images = {}, {}, {}
    for name, aperture in [
            ("slit", ot.SlitSurface(dim=[9, 9], dimi=[4.0, 0.02])),
            ("pinhole", ot.RingSurface(r=4.0, ri=0.01))]:
        RT = ot.Raytracer(outline=[-60, 60, -60, 60, -10, 510],
                          use_hurb=True, no_pol=True, device=device)
        RS = ot.RaySource(ot.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="None",
                          spectrum=ot.LightSpectrum("Monochromatic", wl=550))
        RT.add(RS)
        RT.add(ot.Aperture(aperture, pos=[0, 0, 0]))
        RT.add(ot.Detector(ot.RectangularSurface(dim=[110, 110]), pos=[0, 0, 500]))
        with ot.global_options.no_warnings():
            RT.trace(N)
        img = RT.detector_image(extent=[-40, 40, -40, 40])
        powers[name], source_powers[name] = img.power(), RS.power
        images[name] = img.get("Irradiance", 315)
    return dict(rays=2 * N, powers=powers, source_powers=source_powers, images=images)


def plot(results):
    from optrace_tpu_torch import plots
    for name, image in results["images"].items():
        plots.image_plot(image, log=True, path=f"hurb_{name}.png")
        print(f"saved hurb_{name}.png")


if __name__ == "__main__":
    plot(main())
