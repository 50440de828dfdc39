#!/usr/bin/env python3
"""Vision through a patient's eye with progressing levels of keratoconus
(the PyTorch port of examples/keratoconus.py). The anterior cornea of the
Arizona eye model is deformed by a Gaussian cone with parameters from
Tan et al. (2008), https://doi.org/10.1167/8.2.13 — a FunctionSurface2D
built on top of the preset cornea's sag, in torch operations."""

import pathlib
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped, keep_batches  # noqa: E402

# options
g = 0.67e3                 # object distance
G_alpha = 4                # angle of object in view
P = 3.0                    # pupil diameter
position = "far"           # keratoconus cone position
cases = [0, 7]             # cases to simulate (indices into gauss_param)
delta_A = 0                # relative eye adaption / refractive error

# Table 1 of Tan et al. (2008): h0, sigma_x, sigma_y
gauss_param = \
    [[0.0000, 0.0001, 0.0001],   # 0   Healthy: V = 0.00 mm^3
     [0.0051, 0.4183, 0.4729],   # 1   Mild: V < 0.02 mm^3
     [0.0087, 0.4348, 0.5718],   # 2
     [0.0090, 0.5170, 0.4960],   # 3
     [0.0101, 0.7323, 0.6944],   # 4   Moderate: V 0.02-0.1 mm^3
     [0.0118, 0.6581, 0.7755],   # 5
     [0.0156, 0.6417, 0.6008],   # 6
     [0.0200, 0.8000, 0.8000],   # 7
     [0.0246, 1.1821, 0.8553],   # 8   Advanced: V 0.1-0.4 mm^3
     [0.0269, 0.9700, 0.8823],   # 9
     [0.0296, 1.1606, 0.8822],   # 10
     [0.0400, 1.2000, 1.2000],   # 11
     [0.0410, 1.7380, 1.0590],   # 12  Severe: V > 0.4 mm^3
     [0.0507, 1.7013, 1.0280],   # 13
     [0.0541, 1.7629, 1.0309]]   # 14

# cone position (Figure 1 of Tan et al. 2008)
positions = {"axis": [0., 0.], "average": [0.4, -0.9], "far": [1.1, -1.4]}

N_rays = 3e5

# resulting properties
A = 1 / g * 1000 + delta_A                       # adaption in dpt for given g
G = g * np.tan(G_alpha / 180 * np.pi)            # half object size
OL = max(G, 8)                                   # half of x, y outline size
sr_angle = np.arctan(1.4 * P / 2 / g) / np.pi * 180
G_size = g * np.tan(G_alpha / 180 * np.pi)


def cornea_ant_func(x, y, cornea_front, gauss_param, position):
    """anterior cornea with keratoconus cone: the preset cornea sag minus a
    Gaussian bump, on torch tensors"""
    base = cornea_front._sag(x, y)
    h, sx, sy = gauss_param
    x0, y0 = position
    return base - h * torch.exp(-(x - x0) ** 2 / 2 / sx ** 2
                                - (y - y0) ** 2 / 2 / sy ** 2)


def deformed_front(cornea_front, num):
    """The anterior cornea of case ``num``: a FunctionSurface2D."""
    func_args = dict(cornea_front=cornea_front, gauss_param=gauss_param[num],
                     position=positions[position])
    return ot.FunctionSurface2D(func=cornea_ant_func, func_args=func_args,
                                r=cornea_front.r)


def main(device=None, rays=None):
    image = ot.presets.image.ETDRS_chart_inverted

    RT = ot.Raytracer(outline=[-OL, OL, -OL, OL, -g, 28], device=device)

    RS = ot.RaySource(ot.Point(), divergence="Lambertian", div_angle=sr_angle,
                      pos=[0, 0, -g])
    RT.add(RS)

    # eye model + extra rectangular retina detector
    geom = ot.presets.geometry.arizona_eye(adaptation=A, pupil=P)
    RT.add(geom)
    RT.add(ot.Detector(ot.RectangularSurface([4, 4]), pos=RT.detectors[0].pos,
                       desc="Retina"))

    old_cornea = RT.lenses[0]
    cornea = old_cornea

    N = capped(N_rays, rays)
    keep_batches(RT, N_rays, N)
    powers, images = [], []
    for num in cases:
        RT.remove(cornea)

        # new deformed anterior cornea surface
        cfront = deformed_front(old_cornea.front, num)
        cornea = ot.Lens(cfront, old_cornea.back, d1=0, d2=0.55, pos=[0, 0, 0],
                         n=old_cornea.n, n2=old_cornea.n2)
        RT.add(cornea)

        # render the PSF on the retina
        det_im = RT.iterative_render(N, detector_index=1, limit=4)
        psf = det_im[0]
        img = image([2 * G_size, 2 * G_size])

        # image magnification of the (healthy) eye
        m = ot.presets.geometry.arizona_eye().tma().image_magnification(RS.pos[2])

        # convolve object with PSF and show the retinal image
        img_conv = ot.convolve(img, psf, m=m, keep_size=True, device=device)
        powers.append(psf.power())
        images.append(img_conv)
    return dict(rays=len(cases) * N, powers=powers, source_power=RS.power,
                magnification=float(m), images=images,
                object_image=image([2 * G_size, 2 * G_size]))


def plot(results):
    from optrace_tpu_torch import plots as otp
    # input image
    otp.image_plot(results["object_image"], path="keratoconus_object.png")
    for num, img_conv in zip(cases, results["images"]):
        otp.image_plot(img_conv, flip=True, path=f"keratoconus_case{num}.png")


if __name__ == "__main__":
    plot(main())
