"""The program's scene of ``configs/iol_eye.json`` through the program's
public classes, as ``scene.py`` builds the other configurations: the
``asphere`` row becomes an ``AsphericSurface``, every other row as
``scene.py`` builds it, the raytracer bends the rays at its ring stop by
HURB where the configuration says so (``use_hurb``, ``hurb_factor``), and
the point source is the keratoconic eye's, a D65 point
(``scene_keratoconus.ray_source``)."""

from . import scene as bscene, scene_keratoconus
from .reference_iol import ASPHERE


def _surface(ot, row: dict):
    if row["type"] != ASPHERE:
        return bscene._surface(ot, row)
    return ot.AsphericSurface(r=float(row["r"]), R=float(row["R"]), k=float(row["k"]),
                              coeff=[float(c) for c in row["coeff"]])


def build(ot, cfg: dict, seed: int, no_pol: bool, device=None):
    """A ``Raytracer`` with the configuration's cornea, pupil, intraocular
    lens, detector and source, HURB on as the configuration says."""
    bscene.apply_global_options(ot, cfg)
    RT = ot.Raytracer(outline=list(cfg["outline"]), n0=bscene._medium(ot, cfg, "ambient"), no_pol=no_pol,
                      use_hurb=bool(cfg["use_hurb"]), device=device)
    RT.HURB_FACTOR = float(cfg["hurb_factor"])
    rows = cfg["surfaces"]
    z = float(cfg["first_vertex_z"])
    i = 0
    while i < len(rows):
        row = rows[i]
        if row["type"] == "stop":
            RT.add(ot.Aperture(ot.RingSurface(r=float(row["r"]), ri=float(row["ri"])), pos=[0, 0, z]))
            z += float(row["d"])
            i += 1
            continue
        back = rows[i + 1]
        n2 = None if back["after"] == "ambient" else bscene._medium(ot, cfg, back["after"])
        RT.add(ot.Lens(_surface(ot, row), _surface(ot, back), n=bscene._medium(ot, cfg, row["after"]),
                       pos=[0, 0, z], d1=0.0, d2=float(row["d"]), n2=n2))
        z += float(row["d"]) + float(back["d"])
        i += 2
    RT.add(bscene._detector(ot, cfg["detector"], z))
    RT.add(scene_keratoconus.ray_source(ot, cfg, seed))
    return RT
