"""The program's scene of ``configs/keratoconic_eye.json`` through the
program's public classes, as ``scene.py`` builds the other configurations:
the cone's row becomes a ``FunctionSurface2D`` over the conic's own sag less
the Gaussian cone (as ``examples_torch/keratoconus.py:deformed_front`` builds
it), every other row as ``scene.py`` builds it, and the point source with
the program's D65 spectrum, the ``RaySource`` default that the example
leaves in place."""

import torch

from . import reference, scene as bscene
from .reference_keratoconus import CONE


def cone_sag(x, y, conic, h0, sigma_x, sigma_y, x0, y0):
    """The anterior cornea with its cone, on the trace's tensors."""
    return conic._sag(x, y) - h0 * torch.exp(-(x - x0) ** 2 / 2 / sigma_x ** 2
                                             - (y - y0) ** 2 / 2 / sigma_y ** 2)


def _surface(ot, row: dict):
    if row["type"] != CONE:
        return bscene._surface(ot, row)
    conic = ot.ConicSurface(r=float(row["r"]), R=float(row["R"]), k=float(row["k"]))
    args = {k: float(row[k]) for k in ("h0", "sigma_x", "sigma_y", "x0", "y0")}
    return ot.FunctionSurface2D(r=float(row["r"]), func=cone_sag, func_args=dict(args, conic=conic))


def ray_source(ot, cfg: dict, seed: int):
    src = cfg["ray_source"]
    if src["emitter"] != "point" or src["spectrum"] != "D65":
        raise ValueError("the keratoconic eye's source is a point with the D65 spectrum")
    return ot.RaySource(ot.Point(), spectrum=ot.presets.light_spectrum.d65, divergence=src["divergence"],
                        div_angle=float(src["div_angle_deg"]), orientation=src["orientation"],
                        conv_pos=list(src["conv_pos"]), polarization=src["polarization"],
                        pos=list(reference.source_centre(cfg, seed)), power=float(src["power"]))


def build(ot, cfg: dict, seed: int, no_pol: bool, device=None):
    """A ``Raytracer`` with the configuration's lenses (the cone on the
    cornea), stop, detector and source."""
    bscene.apply_global_options(ot, cfg)
    RT = ot.Raytracer(outline=list(cfg["outline"]), n0=bscene._medium(ot, cfg, "ambient"), no_pol=no_pol,
                      device=device)
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
    RT.add(ray_source(ot, cfg, seed))
    return RT
