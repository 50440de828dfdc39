#!/usr/bin/env python3
"""Le Grand full theoretical eye: paraxial properties and retinal PSF
(the PyTorch port of examples/legrand_eye_model.py)."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.presets.geometry import legrand_eye  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-8, 8, -8, 8, -20, 30], device=device)
    RS = ot.RaySource(ot.CircularSurface(r=1.5), divergence="None",
                      spectrum=ot.LightSpectrum("Monochromatic", wl=546), pos=[0, 0, -10])
    RT.add(RS)
    RT.add(legrand_eye())

    tma = RT.tma()
    N = capped(500_000, rays)
    RT.trace(N)
    img = RT.detector_image()
    return dict(rays=N, eye_power_dpt=float(tma.powers_n[1]), efl=float(tma.efl),
                focal_points=[float(f) for f in tma.focal_points], power=img.power(),
                source_power=RS.power, image=img.get("Irradiance", 189))


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="legrand_eye_psf.png")


if __name__ == "__main__":
    results = main()
    print(f"eye power: {results['eye_power_dpt']:.2f} dpt, efl: {results['efl']:.3f} mm")
    print(f"focal points: {results['focal_points']}")
    plot(results)
    print("saved legrand_eye_psf.png")
