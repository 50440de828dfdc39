"""The program's scene built from a configuration file through the program's
public classes: the same data that the reference traces, and no preset of
the program, so that an edit of a preset does not move the yardstick."""

import math

from . import reference


def _medium(ot, cfg: dict, name: str):
    m = dict(cfg["media"], ambient=cfg["ambient"])[name]
    if m["model"] == "Constant":
        return ot.RefractionIndex("Constant", n=float(m["n"]))
    if m["model"] == "Abbe":
        return ot.RefractionIndex("Abbe", n=float(m["n"]), V=float(m["V"]),
                                  lines=list(cfg.get("abbe_lines_nm", (486.1327, 587.5618, 656.272))))
    raise ValueError(f"unknown medium model {m['model']}")


def _surface(ot, row: dict):
    R, k = float(row["R"]), float(row.get("k", 0.0))
    if math.isinf(R):
        return ot.CircularSurface(r=float(row["r"]))
    if k == 0.0:
        return ot.SphericalSurface(r=float(row["r"]), R=R)
    return ot.ConicSurface(r=float(row["r"]), R=R, k=k)


def _detector(ot, det: dict, z: float):
    if det["shape"] == "rectangle":
        return ot.Detector(ot.RectangularSurface(dim=list(det["dim"])), pos=[0, 0, z])
    if det["shape"] == "sphere":
        return ot.Detector(ot.SphericalSurface(r=float(det["r"]), R=float(det["R"])), pos=[0, 0, z])
    raise ValueError(f"unknown detector shape {det['shape']}")


def ray_source(ot, cfg: dict, seed: int):
    src = cfg["ray_source"]
    kw = dict(divergence=src["divergence"], div_angle=float(src["div_angle_deg"]),
              orientation=src["orientation"], conv_pos=list(src["conv_pos"]),
              pos=list(reference.source_centre(cfg, seed)), power=float(src["power"]))
    if src["emitter"] == "point":
        return ot.RaySource(ot.Point(), spectrum=ot.LightSpectrum(src["spectrum"]),
                            polarization=src["polarization"], **kw)
    if src["emitter"] == "rgb_image":
        chart = ot.RGBImage(reference.chart_pixels(cfg, seed), s=list(src["size_mm"]))
        return ot.RaySource(chart, **kw)
    raise ValueError(f"unknown emitter {src['emitter']}")


def apply_global_options(ot, cfg: dict) -> None:
    go = ot.global_options
    go.wavelength_range = list(cfg["wavelength_range_nm"])
    for key, val in cfg.get("global_options", {}).items():
        setattr(go, key, val)


def build(ot, cfg: dict, seed: int, no_pol: bool, device=None):
    """A ``Raytracer`` with the configuration's surfaces, stop, detector and
    source (whose position the seed draws where the configuration says so)."""
    apply_global_options(ot, cfg)
    RT = ot.Raytracer(outline=list(cfg["outline"]), n0=_medium(ot, cfg, "ambient"), no_pol=no_pol,
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
        if back["type"] == "stop":
            raise ValueError("a lens needs two refracting surfaces in a row")
        n2 = None if back["after"] == "ambient" else _medium(ot, cfg, back["after"])
        RT.add(ot.Lens(_surface(ot, row), _surface(ot, back), n=_medium(ot, cfg, row["after"]),
                       pos=[0, 0, z], d1=0.0, d2=float(row["d"]), n2=n2))
        z += float(row["d"]) + float(back["d"])
        i += 2
    RT.add(_detector(ot, cfg["detector"], z))
    RT.add(ray_source(ot, cfg, seed))
    return RT
