#!/usr/bin/env python3
"""PSF convolution imaging: image a scene by convolving with a traced PSF
instead of tracing every ray (the PyTorch port of examples/psf_imaging.py).
It traces no rays: ``rays`` is accepted and has nothing to cap."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402


def main(device=None, rays=None):
    # object scene and an aberrated-lens PSF
    img = ot.presets.image.ETDRS_chart(s=[1.5, 1.5])
    psf = ot.presets.psf.halo(sig1=1.0, sig2=0.5, r=8.0, a=0.2)

    with ot.global_options.no_warnings():
        out = ot.convolve(img, psf, m=-1, device=device)     # m<0: real image is flipped

    return dict(rays=0, shape=list(out.shape), mean=float(np.mean(out.data)), image=out)


def plot(results):
    from optrace_tpu_torch import plots
    plots.image_plot(results["image"], path="psf_imaging.png")


if __name__ == "__main__":
    results = main()
    plot(results)
    print("saved psf_imaging.png; output size", tuple(results["shape"]))
