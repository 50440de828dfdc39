#!/usr/bin/env python3
"""Arizona schematic eye: retinal image of a point source and of a scene
(the PyTorch port of examples/arizona_eye_model.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.presets.geometry import arizona_eye  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-8, 8, -8, 8, -40, 30], device=device)

    RS = ot.RaySource(ot.CircularSurface(r=1.0), divergence="None",
                      spectrum=ot.presets.light_spectrum.d65, pos=[0, 0, -20])
    RT.add(RS)
    RT.add(arizona_eye(adaptation=0.0))

    tma = RT.tma()
    N = capped(1_000_000, rays)
    RT.trace(N)
    img = RT.detector_image()     # retina is a spherical detector
    return dict(rays=N, eye_power_dpt=float(tma.powers_n[1]), power=img.power(),
                source_power=RS.power, image=img.get("sRGB (Absolute RI)", 189))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="arizona_eye_psf.png")


if __name__ == "__main__":
    results = main()
    print(f"eye power: {results['eye_power_dpt']:.2f} dpt (literature ~60 dpt)")
    plot(results)
    print("saved arizona_eye_psf.png; retinal power:", f"{results['power']:.4f} W")
