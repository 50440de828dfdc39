#!/usr/bin/env python3
"""Vision with an Alcon IQ monofocal intraocular lens: ETDRS target image
on the retina via PSF convolution for several object distances, with HURB
diffraction (the PyTorch port of examples/IOL_target_imaging.py)."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

# simulation parameters
P = 3.0                       # pupil diameter
N_rays = 1500000
N_px = 189
G_angle = np.deg2rad(1.0)     # half angle of the image
g = [100000, 1333, 667]       # object distances


def main(device=None, rays=None):
    img = ot.presets.image.ETDRS_chart

    # raytracer sized for the worst-case object distance, HURB enabled
    max_g = np.max(g)
    RS_r_max = G_angle * max_g
    RT_xy_max = max(RS_r_max, 10)
    RT_z0_min = -max(400, max_g)
    RT = ot.Raytracer(outline=[-RT_xy_max, RT_xy_max, -RT_xy_max, RT_xy_max,
                               RT_z0_min, 30], use_hurb=True, device=device)

    # Arizona eye model; remove the natural eye lens, keep its rear medium
    eye = ot.presets.geometry.arizona_eye(pupil=P)
    nE = eye.lenses[1].n2
    eye.remove(eye.lenses[1])

    # the Alcon IQ IOL (patent US7350916; n from okulix.de, V from
    # https://doi.org/10.1371/journal.pone.0228342)
    ACD = 4.15
    front = ot.SphericalSurface(r=3, R=21.557)
    back = ot.AsphericSurface(r=3, R=-22, k=-42.1929,
                              coeff=[-2.3318e-04, -2.1144e-05, 8.9923e-06])
    n_IOL = ot.RefractionIndex("Abbe", n=1.554, V=37,
                               lines=ot.presets.spectral_lines.FdC)
    IOL = ot.Lens(front, back, d1=0, d2=0.593, pos=[0, 0, 0.55 + ACD],
                  n=n_IOL, n2=nE, desc="Alcon IQ IOL")

    eye.add(IOL)
    RT.add(eye)

    # extra rectangular retina detector (detector_index=1)
    RT.add(ot.Detector(ot.RectangularSurface([4, 4]), pos=RT.detectors[0].pos,
                       desc="Retina"))

    N = capped(N_rays, rays)
    powers, source_powers, magnifications, images = [], [], [], []
    for gi in g:
        # point-source divergence sampling the pupil, with margin
        RS_sr_angle = np.arctan(3 / gi) / np.pi * 180
        G_size = gi * np.tan(G_angle)

        RT.remove(RT.ray_sources)
        RS = ot.RaySource(ot.Point(), divergence="Lambertian",
                          div_angle=RS_sr_angle, pos=[0, 0, -gi],
                          spectrum=ot.presets.light_spectrum.d65)
        RT.add(RS)

        RT.trace(N)

        # render the PSF
        psf = RT.detector_image(detector_index=1,
                                extent=[-0.1 / 1.25, 0.1 / 1.25,
                                        -0.1 / 1.25, 0.1 / 1.25])

        # target image and system magnification
        img1 = img([2 * G_size, 2 * G_size])
        m = ot.presets.geometry.arizona_eye().tma().image_magnification(RS.pos[2])

        # convolve; perceptual intent with fixed chroma scale
        img2 = ot.convolve(img1, psf, m=m,
                           cargs=dict(rendering_intent="Perceptual",
                                      L_th=0.01, chroma_scale=0.5),
                           keep_size=True, padding_mode="edge", device=device)
        powers.append(psf.power())
        source_powers.append(RS.power)
        magnifications.append(float(m))
        images.append(img2)
    return dict(rays=len(g) * N, powers=powers, source_powers=source_powers,
                magnifications=magnifications, images=images, desc=IOL.desc)


def plot(results):
    from optrace_tpu_torch import plots as otp
    for gi, img2 in zip(g, results["images"]):
        otp.image_plot(img2, flip=True, path=f"IOL_target_{1000 / gi:.2f}D.png",
                       title=f"{results['desc']}, {1 / gi * 1e3:.2f}D, P={P}mm, Perceptual RI")


if __name__ == "__main__":
    plot(main())
