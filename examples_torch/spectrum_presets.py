#!/usr/bin/env python3
"""Gallery of the light-spectrum presets (the PyTorch port of
examples/spectrum_presets.py). It traces no rays and computes on the host:
``device`` and ``rays`` are accepted and unused. ``main`` returns the CIE
1931 chromaticities that the chromaticity diagram marks."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402


def main(device=None, rays=None):
    natural = ot.presets.light_spectrum.standard_natural
    chromaticities = {}
    for spec in natural:
        xyz = np.asarray(spec.xyz(), dtype=np.float64)
        chromaticities[spec.get_desc()] = [float(xyz[0] / xyz.sum()), float(xyz[1] / xyz.sum())]
    return dict(rays=0, chromaticities_xy=chromaticities)


def plot(results):
    from optrace_tpu_torch import plots
    plots.spectrum_plot(ot.presets.light_spectrum.standard_natural,
                        title="Standard Illuminants", path="spectra_natural.png")
    plots.spectrum_plot(ot.presets.light_spectrum.standard_f,
                        title="Fluorescent Illuminants", path="spectra_f.png")
    plots.spectrum_plot(ot.presets.light_spectrum.srgb[:3],
                        title="sRGB Primaries", path="spectra_srgb.png")
    plots.chromaticities_cie_1931(ot.presets.light_spectrum.standard_natural,
                                  path="chromaticities.png")


if __name__ == "__main__":
    plot(main())
    print("saved spectra_*.png, chromaticities.png")
