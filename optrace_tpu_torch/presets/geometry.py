"""Geometry presets (counterpart of ``optrace_tpu/presets/geometry.py``):

- ideal_camera: ideal lens + sensor
- arizona_eye / legrand_eye: standard schematic human eye models
  (published prescriptions)
- double_gauss: Nikkor-Wakamiya 100 mm f/1.4 objective
  (published patent US4448497 prescription)
"""

import numpy as np

from ..geometry import (Group, Lens, IdealLens, Aperture, Detector,
                        SphericalSurface, ConicSurface, RingSurface, RectangularSurface,
                        Volume)
from ..geometry.volume import BoxVolume
from ..spectrum.refraction_index import RefractionIndex


def ideal_camera(cam_pos, z_g: float, b: float = 10.0, r: float = 6.0,
                 r_det: float = 6.0) -> Group:
    """Ideal camera: aberration-free lens plus detector at image distance b
    for an object at z_g."""
    cam_pos = np.asarray(cam_pos, dtype=np.float64)
    g = cam_pos[2] - z_g
    if g <= 0:
        raise ValueError("Object position z_g needs to be before cam_pos[2].")
    if b <= 0:
        raise ValueError("Image distance b needs to be positive.")

    # imaging equation 1/f = 1/g + 1/b, D in dpt with f in mm
    f = 1.0 / (1.0 / g + 1.0 / b)
    D = 1000.0 / f

    L = IdealLens(r=r, D=D, pos=cam_pos)
    det = Detector(RectangularSurface(dim=[2 * r_det, 2 * r_det]),
                   pos=cam_pos + [0, 0, b])
    vol = BoxVolume(dim=[2 * r_det, 2 * r_det], length=b,
                    pos=cam_pos, opacity=0.1)
    return Group([L, det, vol], desc="Ideal Camera")


def arizona_eye(adaptation: float = 0.0, pupil: float = 5.7, r_det: float = 8.0,
                pos=None) -> Group:
    """Arizona schematic eye model (Schwiegerling, "Field Guide to Visual
    and Ophthalmic Optics"), accommodating via the parameter A in dpt

    :param adaptation: accommodation A in dpt
    :param pupil: pupil diameter in mm
    :param r_det: retina radial size
    """
    A = adaptation
    pos = np.asarray(pos if pos is not None else [0, 0, 0], dtype=np.float64)

    # published model parameters (all lengths mm, indices at accommodation A)
    n_aqueous = RefractionIndex("Abbe", n=1.337, V=61.3, desc="Aqueous")
    n_cornea = RefractionIndex("Abbe", n=1.377, V=57.1, desc="Cornea")
    n_lens = RefractionIndex("Abbe", n=1.42 + 0.00256 * A - 0.00022 * A ** 2, V=51.9, desc="Lens")
    n_vitreous = RefractionIndex("Abbe", n=1.336, V=61.1, desc="Vitreous")

    d_aq = 2.97 - 0.04 * A       # aqueous thickness
    d_lens = 3.767 + 0.04 * A    # lens thickness

    # cornea
    cornea_front = ConicSurface(r=5.45, R=7.8, k=-0.25)
    cornea_back = ConicSurface(r=5.45, R=6.5, k=-0.25)
    cornea = Lens(cornea_front, cornea_back, d1=0, d2=0.55, pos=pos,
                  n=n_cornea, n2=n_aqueous, desc="Cornea")

    # pupil aperture directly in front of the lens (published model layout)
    ap = Aperture(RingSurface(r=5.45, ri=pupil / 2),
                  pos=pos + [0, 0, 0.55 + d_aq - 1e-9], desc="Pupil")

    # crystalline lens
    lens_front = ConicSurface(r=5.1, R=12.0 - 0.4 * A, k=-7.518749 + 1.285720 * A)
    lens_back = ConicSurface(r=5.1, R=-5.224557 + 0.2 * A, k=-1.353971 - 0.431762 * A)
    lens = Lens(lens_front, lens_back, d1=0, d2=d_lens,
                pos=pos + [0, 0, 0.55 + d_aq], n=n_lens, n2=n_vitreous, desc="Lens")

    # retina as spherical detector
    retina = Detector(SphericalSurface(r=r_det, R=-13.4),
                      pos=pos + [0, 0, 24.0], desc="Retina")

    # eye-ball display volume (conic pair with matching edge radii)
    vol_front = ConicSurface(r=12.776270, R=14.8152, k=0.344612)
    vol_back = ConicSurface(r=12.776270, R=-13.4, k=0.1)
    vol = Volume(vol_front, vol_back, pos=retina.pos,
                 d1=vol_front.ds + vol_back.ds, d2=0, color=(1, 1, 0.95))

    return Group([cornea, ap, lens, retina, vol], n0=None, desc="Arizona Eye Model")


def legrand_eye(pupil: float = 5.7, r_det: float = 8.0, pos=None) -> Group:
    """Le Grand full theoretical eye: four spherical refracting surfaces
    with constant media."""
    pos = np.asarray(pos if pos is not None else [0, 0, 0], dtype=np.float64)

    n_cornea = RefractionIndex("Constant", n=1.3771, desc="Cornea")
    n_aqueous = RefractionIndex("Constant", n=1.3374, desc="Aqueous")
    n_lens = RefractionIndex("Constant", n=1.4200, desc="Lens")
    n_vitreous = RefractionIndex("Constant", n=1.3360, desc="Vitreous")

    cornea = Lens(SphericalSurface(r=5.5, R=7.8), SphericalSurface(r=5.5, R=6.5),
                  d1=0.25, d2=0.30, pos=pos + [0, 0, 0.25], n=n_cornea, n2=n_aqueous,
                  desc="Cornea")
    # pupil at z=3.6 mm, coinciding with the anterior lens surface
    ap = Aperture(RingSurface(r=5.5, ri=pupil / 2), pos=pos + [0, 0, 3.6], desc="Pupil")
    lens = Lens(SphericalSurface(r=4.8, R=10.2), SphericalSurface(r=4.8, R=-6.0),
                d1=1.5, d2=2.5, pos=pos + [0, 0, 5.10], n=n_lens, n2=n_vitreous,
                desc="Lens")
    retina = Detector(SphericalSurface(r=r_det, R=-13.4),
                      pos=pos + [0, 0, 24.197], desc="Retina")

    vol_front = ConicSurface(r=12.776270, R=14.8152, k=0.344612)
    vol_back = ConicSurface(r=12.776270, R=-13.4, k=0.1)
    vol = Volume(vol_front, vol_back, pos=retina.pos,
                 d1=vol_front.ds + vol_back.ds, d2=0, color=(1.0, 1.0, 0.95))

    return Group([cornea, ap, lens, retina, vol], n0=None, desc="LeGrand Eye Model")


def double_gauss(with_detector: bool = True) -> Group:
    """Nikkor-Wakamiya 100 mm f/1.4 double-gauss objective (US4448497),
    the flagship render geometry: 7 lenses (14 spherical refracting
    surfaces), one ring aperture and a rectangular detector."""
    G = Group(desc="Nikkor Wakamiya 100mm f/1.4")

    n_0 = RefractionIndex("Abbe", n=1.797, V=45.3)
    L_0 = Lens(SphericalSurface(r=38.0, R=78.36), SphericalSurface(r=38.0, R=469.5),
               n=n_0, pos=[0, 0, 0], d1=0, d2=9.8837)
    G.add(L_0)

    n_1 = RefractionIndex("Abbe", n=1.773, V=49.4)
    L_1 = Lens(SphericalSurface(r=32.0, R=50.3), SphericalSurface(r=31.0, R=74.38),
               n=n_1, pos=[0, 0, L_0.back.pos[2] + 0.1938], d1=0, d2=9.1085)
    G.add(L_1)

    n_2 = RefractionIndex("Abbe", n=1.673, V=32.2)
    L_2 = Lens(SphericalSurface(r=29.5, R=138.1), SphericalSurface(r=25.5, R=34.33),
               n=n_2, pos=[0, 0, L_1.back.pos[2] + 2.9457], d1=0, d2=2.3256)
    G.add(L_2)

    AP = Aperture(RingSurface(ri=24.8, r=38.0), pos=[0, 0, L_2.back.pos[2] + 16.07])
    G.add(AP)

    n_3 = RefractionIndex("Abbe", n=1.740, V=28.3)
    L_3 = Lens(SphericalSurface(r=24.4, R=-34.41), SphericalSurface(r=28.5, R=-2907.0),
               n=n_3, pos=[0, 0, L_2.back.pos[2] + 16.07 + 13], d1=0, d2=1.938)
    G.add(L_3)

    n_4 = RefractionIndex("Abbe", n=1.773, V=49.4)
    L_4 = Lens(SphericalSurface(r=28.5, R=-2907.0), SphericalSurface(r=30.0, R=-59.05),
               n=n_4, pos=[0, 0, L_3.back.pos[2] + 1e-6], d1=0, d2=12.403)
    G.add(L_4)

    n_5 = RefractionIndex("Abbe", n=1.788, V=47.5)
    L_5 = Lens(SphericalSurface(r=33.4, R=-150.9), SphericalSurface(r=33.9, R=-57.89),
               n=n_5, pos=[0, 0, L_4.back.pos[2] + 0.3876], d1=0, d2=8.333)
    G.add(L_5)

    n_6 = RefractionIndex("Abbe", n=1.788, V=47.5)
    L_6 = Lens(SphericalSurface(r=33.0, R=284.6), SphericalSurface(r=33.0, R=-253.2),
               n=n_6, pos=[0, 0, L_5.back.pos[2] + 0.1938], d1=0, d2=5.0388)
    G.add(L_6)

    if with_detector:
        det = Detector(RectangularSurface(dim=[86.53, 86.53]),
                       pos=[0, 0, L_6.back.pos[2] + 73.839])
        G.add(det)
    return G


eye_models: list = [legrand_eye, arizona_eye]
geometries: list = [ideal_camera, *eye_models, double_gauss]
