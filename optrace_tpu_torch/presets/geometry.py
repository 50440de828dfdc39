"""Geometry presets (counterpart of ``optrace_tpu/presets/geometry.py``):
the double-Gauss objective. The eye models and the ideal camera arrive with
``IdealLens`` and the volumes."""

from ..geometry import (Group, Lens, Aperture, Detector, SphericalSurface,
                        RingSurface, RectangularSurface)
from ..spectrum.refraction_index import RefractionIndex


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


geometries: list = [double_gauss]
