#!/usr/bin/env python3
"""Astigmatism of oblique incidence on a spherical lens: tangential and
sagittal foci separate for a tilted beam (the PyTorch port of
examples/astigmatism.py)."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402


def main(device=None, rays=None):
    RT = ot.Raytracer(outline=[-12, 12, -25, 12, -10, 80], device=device)

    theta = 20.0   # field angle in degrees
    th = np.radians(theta)
    RS = ot.RaySource(ot.CircularSurface(r=1.5), pos=[0, -12 * np.tan(th), -8],
                      divergence="None", s_sph=[theta, 90],
                      spectrum=ot.LightSpectrum("Monochromatic", wl=550))
    RT.add(RS)

    n = ot.presets.refraction_index.BK7
    RT.add(ot.Lens(ot.SphericalSurface(r=5, R=25), ot.SphericalSurface(r=5, R=-25),
                   n=n, pos=[0, 0, 4], d=1.5))

    N = capped(500_000, rays)
    RT.trace(N)
    res, fsdict = RT.focus_search("RMS Spot Size", z_start=30, return_cost=True)
    return dict(rays=N, focus=float(res.x), focus_bounds=[float(b) for b in fsdict["bounds"]],
                focus_result=res, focus_costs=fsdict)


def plot(results):
    from optrace_tpu_torch import plots
    plots.focus_search_cost_plot(results["focus_result"], results["focus_costs"],
                                 path="astigmatism_cost.png")


if __name__ == "__main__":
    results = main()
    print(f"best overall focus at z = {results['focus']:.2f} mm "
          f"(between the separated tangential and sagittal line foci)")
    plot(results)
    print("saved astigmatism_cost.png")
