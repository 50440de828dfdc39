#!/usr/bin/env python3
"""Gallery of the material presets: dispersion curves and the Abbe diagram
(the PyTorch port of examples/refraction_index_presets.py). It traces no
rays and computes on the host: ``device`` and ``rays`` are accepted and
unused."""

import pathlib
import sys

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402


def main(device=None, rays=None):
    glasses = ot.presets.refraction_index.glasses[:8]
    abbe = {n.get_desc(): float(n.abbe_number()) for n in glasses}
    return dict(rays=0, abbe_numbers=abbe, glasses=glasses,
                abbe_glasses=ot.presets.refraction_index.glasses[:12])


def plot(results):
    from optrace_tpu_torch import plots
    plots.refraction_index_plot(results["glasses"], title="Glass Dispersion",
                                path="glass_dispersion.png")
    plots.abbe_plot(results["abbe_glasses"], path="abbe_diagram.png")


if __name__ == "__main__":
    results = main()
    plot(results)
    for name, V in results["abbe_numbers"].items():
        print(f"{name:>14}: V = {V:6.2f}")
    print("saved glass_dispersion.png, abbe_diagram.png")
