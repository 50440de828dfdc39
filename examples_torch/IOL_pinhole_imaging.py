#!/usr/bin/env python3
"""Vision with an Alcon IQ monofocal intraocular lens after cataract
surgery: polychromatic pinhole image on the retina for several object
distances, with HURB diffraction blurring (the PyTorch port of
examples/IOL_pinhole_imaging.py)."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped, keep_batches  # noqa: E402

# simulation parameters
P = 4.5                    # pupil diameter
N_rays = 3e6               # number of rays (increase for less image noise)
N_px = 189                 # pixel side length of the image
oh_angle = 50 / 1e5        # visual object half angle (50 mm radius at 100 m)
g = [100000, 1333, 667]    # object distances


def main(device=None, rays=None):
    # raytracer sized for the worst-case object distance, HURB enabled
    max_g = np.max(g)
    RS_r_max = oh_angle * max_g
    RT_xy_max = max(RS_r_max, 10)
    RT_z0_min = -max(400, max_g)
    RT = ot.Raytracer(outline=[-RT_xy_max, RT_xy_max, -RT_xy_max, RT_xy_max,
                               RT_z0_min, 30], use_hurb=True, device=device)

    # Arizona eye model; remove the natural eye lens, keep its rear medium
    eye = ot.presets.geometry.arizona_eye(pupil=P)
    nE = eye.lenses[1].n2
    eye.remove(eye.lenses[1])

    # the Alcon IQ IOL from research data and patent US7350916;
    # n from okulix.de/okulix-en.pdf p.6, Abbe number from
    # https://doi.org/10.1371/journal.pone.0228342
    ACD = 4.15
    front = ot.SphericalSurface(r=3, R=21.557)
    back = ot.AsphericSurface(r=3, R=-22, k=-42.1929,
                              coeff=[-2.3318e-04, -2.1144e-05, 8.9923e-06])
    n_IOL = ot.RefractionIndex("Abbe", n=1.554, V=37,
                               lines=ot.presets.spectral_lines.FdC)
    IOL = ot.Lens(front, back, d1=0, d2=0.593, pos=[0, 0, 0.55 + ACD],
                  n=n_IOL, n2=nE, desc="IOL")

    eye.add(IOL)
    RT.add(eye)

    # extra rectangular retina detector (detector_index=1)
    RT.add(ot.Detector(ot.RectangularSurface([4, 4]), pos=RT.detectors[0].pos,
                       desc="Retina"))

    N = capped(N_rays, rays)
    keep_batches(RT, N_rays, N)
    powers, source_powers, images = [], [], []
    # simulate the image for different object distances
    for gi in g:
        # every object point emits a cone directed towards the pupil
        RS_r = oh_angle * gi
        RS_sr_angle = np.rad2deg(np.arcsin(3.5 / gi))   # max pupil size + margin

        RS = ot.RaySource(ot.CircularSurface(r=RS_r), divergence="Isotropic",
                          orientation="Converging", conv_pos=[0, 0, 0],
                          div_angle=RS_sr_angle, pos=[0, 0, -gi],
                          spectrum=ot.presets.light_spectrum.d65)
        RT.add(RS)

        # iteratively render the retinal image at a fixed, comparable extent
        det_im = RT.iterative_render(N, detector_index=1,
                                     extent=[-0.10, 0.10, -0.10, 0.10])

        # perceptual rendering intent (see the reference publication)
        im_sRGB = det_im[0].get("sRGB (Perceptual RI)", N_px,
                                L_th=0.01, chroma_scale=0.5)

        RT.remove(RS)
        powers.append(det_im[0].power())
        source_powers.append(RS.power)
        images.append(im_sRGB)
    return dict(rays=len(g) * N, powers=powers, source_powers=source_powers,
                images=images, desc=IOL.desc)


def plot(results):
    from optrace_tpu_torch import plots as otp
    for gi, im_sRGB in zip(g, results["images"]):
        otp.image_plot(im_sRGB, path=f"IOL_pinhole_{1000 / gi:.2f}D.png",
                       title=f"{results['desc']}, P={P}mm, {1 / gi * 1e3:.2f}D, Perceptual RI")


if __name__ == "__main__":
    plot(main())
