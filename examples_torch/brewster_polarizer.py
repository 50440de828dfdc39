#!/usr/bin/env python3
"""Brewster-angle polarizer: p-polarized light passes a tilted glass plate
losslessly, s-polarized light loses ~15% per surface (the PyTorch port of
examples/brewster_polarizer.py). It writes no image."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

POLARIZATIONS = [("y", "p-polarized"), ("x", "s-polarized"), ("Uniform", "unpolarized")]


def main(device=None, rays=None):
    n_glass = ot.presets.refraction_index.BK7
    n_d = float(np.asarray(n_glass(np.array([587.56])))[0])
    brewster = np.degrees(np.arctan(n_d))

    th = np.radians(brewster)
    normal = [0.0, float(np.sin(th)), float(np.cos(th))]

    N = capped(100_000, rays)
    transmission = {}
    for pol, label in POLARIZATIONS:
        RT = ot.Raytracer(outline=[-50, 50, -50, 50, -40, 120], device=device)
        RT.add(ot.RaySource(ot.CircularSurface(r=0.5), pos=[0, 0, -5], divergence="None",
                            polarization=pol,
                            spectrum=ot.LightSpectrum("Monochromatic", wl=587.56)))
        RT.add(ot.Lens(ot.TiltedSurface(r=10, normal=normal), ot.CircularSurface(r=40),
                       n=n_glass, n2=n_glass, pos=[0, 0, 10], d1=0.1, d2=45))
        with ot.global_options.no_warnings():
            RT.trace(N)
        T = RT.rays.w_list[:, 1].sum() / RT.rays.w_list[:, 0].sum()
        transmission[label] = float(T)
    return dict(rays=len(POLARIZATIONS) * N, brewster_deg=float(brewster),
                transmission=transmission)


if __name__ == "__main__":
    results = main()
    print(f"Brewster angle for BK7: {results['brewster_deg']:.2f}°")
    for _, label in POLARIZATIONS:
        print(f"{label:>12}: transmission through first surface T = "
              f"{results['transmission'][label]:.4f}")
