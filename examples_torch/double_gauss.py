#!/usr/bin/env python3
"""Nikkor-Wakamiya 100mm f/1.4 double gauss: PSFs of point sources at
several field angles (the PyTorch port of examples/double_gauss.py,
prescription from patent US4448497)."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.presets.geometry import double_gauss  # noqa: E402
from examples_torch.common import capped  # noqa: E402

ANGLES = [0, 5, 10]


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-2000, 2000, -22000, 2000, -50001, 180], no_pol=True,
                      device=device)

    g = 50000.0
    for deg in ANGLES:
        xp = g * np.tan(np.radians(deg))
        RT.add(ot.RaySource(ot.Point(), divergence="Isotropic", orientation="Converging",
                            conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, -xp, -g],
                            desc=f"{deg}°", spectrum=ot.presets.light_spectrum.d65))

    RT.add(double_gauss())

    tma = RT.tma()
    N = capped(1_000_000, rays)
    RT.trace(N)
    powers, source_powers, images = [], [], []
    for i, deg in enumerate(ANGLES):
        img = RT.detector_image(source_index=i)
        powers.append(img.power())
        source_powers.append(RT.ray_sources[i].power)
        images.append(img.get("sRGB (Absolute RI)", 189))
    return dict(rays=N, efl=float(tma.efl), powers=powers, source_powers=source_powers,
                images=images)


def plot(results):
    from optrace_tpu_torch import plots
    for deg, image in zip(ANGLES, results["images"]):
        plots.image_plot(image, path=f"double_gauss_psf_{deg}deg.png")


if __name__ == "__main__":
    results = main()
    print(f"efl = {results['efl']:.2f} mm (design: 100 mm)")
    plot(results)
    print("saved double_gauss_psf_{0,5,10}deg.png")
