"""ZEMAX file import (counterpart of ``optrace_tpu/io/load.py``, host numpy
over this package's classes):

- :func:`load_agf`: ``.agf`` glass catalogs -> dict[name, RefractionIndex];
  13 dispersion formula modes, coefficient padding, wavelength-range and
  index/Abbe consistency checks.
- :func:`load_zmx`: sequential ``.zmx`` (MM units) -> :class:`Group`;
  STANDARD/EVENASPH surfaces, cemented-surface chains with 1e-7 z-offsets,
  STOP -> RingSurface aperture, trailing passive surface -> rectangular
  Detector, leading infinite-distance surface -> ambient medium.

Both loaders are built as two-phase parsers: a tokenizer first turns the
file into tagged records (and, for zmx, groups them into per-surface
blocks), then a separate assembly phase builds the domain objects.  File
format per the public ZEMAX manual ("THE ZMX FILE FORMAT" chapter) and the
.agf glass-catalog description.
"""

import os.path
from dataclasses import dataclass, field

import numpy as np

from ..spectrum.refraction_index import RefractionIndex
from ..geometry import (Group, Lens, PointMarker, Detector, Aperture,
                        CircularSurface, ConicSurface, SphericalSurface,
                        RingSurface, AsphericSurface, Surface, RectangularSurface)
from ..presets import spectral_lines
from ..utils.warnings import warning

# agf formula mode number -> dispersion model name (mode 1 is first entry)
_AGF_FORMULAS = {
    1: "Schott", 2: "Sellmeier1", 3: "Herzberger", 4: "Sellmeier2",
    5: "Conrady", 6: "Sellmeier3", 7: "Handbook of Optics 1",
    8: "Handbook of Optics 2", 9: "Sellmeier4", 10: "Extended",
    11: "Sellmeier5", 12: "Extended2", 13: "Extended3",
}


# ----------------------------------------------------------------------
# tokenizing

def _decode_file(path: str) -> str:
    """Read a text file, trying a codec ladder (ZEMAX exports vary)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} not found/ is not a file.")
    with open(path, "rb") as f:
        blob = f.read()

    codecs = ["utf-8-sig", "utf-16", "latin-1"]
    try:
        import chardet
        guess = chardet.detect(blob).get("encoding")
        if guess:
            codecs.insert(0, guess)
    except ImportError:
        pass

    for codec in codecs:
        try:
            return blob.decode(codec).lstrip("﻿")
        except (UnicodeDecodeError, LookupError):
            continue
    raise RuntimeError(f"Could not decode {path}.")   # pragma: no cover


def _tagged_records(text: str):
    """Yield (tag, fields, trailing_text) for each non-empty line."""
    for line in text.splitlines():
        fields = line.split()
        if not fields or line.startswith(" "):
            continue
        tag = fields[0]
        yield tag, fields, line[len(tag) + 1:].rstrip("\r\n")


# ----------------------------------------------------------------------
# .agf glass catalogs

def _agf_blocks(text: str) -> list[dict]:
    """Group catalog lines into one dict of raw fields per glass entry."""
    blocks: list[dict] = []
    for tag, fields, _ in _tagged_records(text):
        if tag == "NM":
            blocks.append({"NM": fields})
        elif blocks and tag in ("CD", "LD") and tag not in blocks[-1]:
            blocks[-1][tag] = fields
    return blocks


def _glass_from_block(block: dict):
    """Build one (name, RefractionIndex) pair from a raw glass block,
    or None when the entry is unusable.  Emits the consistency warnings
    of the index and Abbe checks."""
    nm = block["NM"]
    name = nm[1]
    formula_no = int(float(nm[2]))
    if formula_no not in _AGF_FORMULAS:
        warning(f"{name}: Unknown index formula mode number {formula_no}, skipping.")
        return None
    model = _AGF_FORMULAS[formula_no]
    nd_file, abbe_file = float(nm[4]), float(nm[5])

    if "CD" not in block or "LD" not in block:
        return None

    want = RefractionIndex.coeff_count[model]
    have = [float(c) for c in block["CD"][1:]][:want]
    have += [0.0] * (want - len(have))

    try:
        glass = RefractionIndex(model, coeff=have, desc=name)

        # validity range of the formula, file stores micrometers
        lo, hi = (float(v) * 1000 for v in block["LD"][1:3])
        probes = spectral_lines.FdC
        if lo > probes[0] or hi < probes[2]:
            warning(f"{name} wavelength range [{lo}, {hi}]nm does not overlap "
                    f"with testing wavelengths {probes}nm, skipping checks.")
        else:
            nd_calc = float(np.asarray(glass(np.array([spectral_lines.d])))[0])
            abbe_calc = glass.abbe_number(probes)
            if abs(nd_calc - nd_file) > 1e-4:
                warning(f"{name}: Index from file is {nd_file}, but calculated "
                        f"index is {nd_calc}. This can be due to different "
                        "probe wavelengths.")
            elif abs(abbe_calc - abbe_file) > 0.3:
                warning(f"{name}: The Abbe number from file is {abbe_file}, but "
                        f"calculated is {abbe_calc}. This can be due to "
                        "different probe wavelengths.")
        return name, glass

    except Exception as err:
        warning(f"Error for material {name}: {err}")
        return None


def load_agf(path: str) -> dict:
    """Load an .agf material catalogue -> dict[name, RefractionIndex]."""
    catalog = {}
    for block in _agf_blocks(_decode_file(path)):
        entry = _glass_from_block(block)
        if entry is not None:
            catalog[entry[0]] = entry[1]
    return catalog


# ----------------------------------------------------------------------
# .zmx geometries

@dataclass
class _SurfRec:
    """One parsed SURF block."""
    kind: str = "STANDARD"
    R: float = np.inf
    k: float = 0.0
    r: float = None
    comment: str = ""
    thick: float = 0.0
    thick_inf: bool = False
    parm: list = field(default_factory=lambda: [0.0] * 10)
    glass: RefractionIndex = None
    is_stop: bool = False


def _parse_zmx_header(text: str) -> tuple[str, str]:
    """Validate global keywords; return (name, text after first SURF check)."""
    title = ""
    for tag, fields, rest in _tagged_records(text):
        if tag == "SURF":
            break
        if tag == "NAME":
            title = rest.rstrip("\n\r")
        elif tag == "UNIT" and fields[1] != "MM":
            raise RuntimeError(f"Unsupported Unit {fields[1]}.")
        elif tag == "MODE" and fields[1] != "SEQ":
            raise RuntimeError(f"Unsupported Mode {fields[1]}.")
    return title


def _parse_surf_blocks(text: str, n_dict: dict) -> list[_SurfRec]:
    """Split the file into SURF blocks and parse each into a _SurfRec.

    SURF markers live at indent 0, their properties at indent 2."""
    recs: list[_SurfRec] = []
    cur = None
    for line in text.splitlines():
        if line.startswith("SURF"):
            cur = _SurfRec()
            recs.append(cur)
            continue
        if cur is None or not line.startswith("  "):
            continue
        body = line[2:]
        key = body[:4]
        fields = body.split()
        if key == "TYPE":
            cur.kind = fields[1]
        elif key == "CURV":
            c = float(fields[1])
            cur.R = 1.0 / c if c else np.inf
        elif key == "CONI":
            cur.k = float(fields[1])
        elif key == "DIAM":
            cur.r = max(float(fields[1]), 1e-9)
        elif key == "COMM":
            cur.comment = body[5:].rstrip("\n\r")
        elif key == "COAT":
            warning("Coatings are not supported. "
                    f"Ignoring coating '{body[5:].rstrip()}'.")
        elif key == "STOP":
            cur.is_stop = True
        elif key == "DISZ":
            t = float(fields[1])
            cur.thick_inf = not np.isfinite(t)
            cur.thick = max(t, 3 * Surface.N_EPS) if not cur.thick_inf else 0.0
        elif key == "PARM":
            slot, val = fields[1:3]
            cur.parm[int(float(slot)) - 1] = float(val)
        elif key == "GLAS":
            material = fields[1]
            nd, V = (float(fields[4]), float(fields[5])) if len(fields) > 6 \
                else (None, None)
            if material == "___BLANK":
                cur.glass = RefractionIndex("Abbe", n=nd, V=V)
            elif material in n_dict:
                cur.glass = n_dict[material]
            elif nd is not None and V is not None and nd > 1 and V > 0:
                cur.glass = RefractionIndex("Abbe", n=nd, V=V)
            else:
                raise RuntimeError(f"Material {material} missing in n_dict parameter.")
    return recs


def _rec_to_surface(rec: _SurfRec):
    """Instantiate the matching Surface subclass for one record."""
    if rec.kind == "EVENASPH":
        return AsphericSurface(r=rec.r, R=rec.R, k=rec.k, coeff=rec.parm,
                               desc=rec.comment)
    if rec.kind != "STANDARD":
        raise RuntimeError(f"Surface mode {rec.kind} not supported yet.")
    if not np.isfinite(rec.R):
        return CircularSurface(r=rec.r, desc=rec.comment)
    if rec.k:
        return ConicSurface(r=rec.r, R=rec.R, k=rec.k, desc=rec.comment)
    return SphericalSurface(r=rec.r, R=rec.R, desc=rec.comment)


def _assemble_group(recs: list[_SurfRec], title: str, no_marker: bool) -> Group:
    """Walk the surface records and emit lenses/apertures/detector.

    z is measured from the first glass surface.  A run of consecutive
    glass records forms a cemented chain: each shared interface belongs
    to the preceding lens and the following lens starts 1e-7 mm behind
    it.
    """
    ambient = None
    if recs and recs[0].thick_inf:
        ambient = recs[0].glass or RefractionIndex("Constant", n=1)
        recs = recs[1:]

    G = Group(long_desc=title, n0=ambient)

    # surfaces without a DIAM entry span the largest radius in the file
    known = [rec.r for rec in recs if rec.r is not None]
    fallback_r = max(known) if known else 1.0
    for rec in recs:
        if rec.r is None:
            rec.r = fallback_r

    first = next((j for j, rec in enumerate(recs) if rec.glass is not None),
                 len(recs))
    z, j = 0.0, first
    while j < len(recs):
        rec = recs[j]

        if rec.glass is not None:
            lens = Lens(_rec_to_surface(rec), _rec_to_surface(recs[j + 1]),
                        n=rec.glass, pos=[0, 0, z], d1=0, d2=rec.thick,
                        n2=(rec.glass if recs[j + 1].glass is not None
                            else RefractionIndex("Constant", n=1)),
                        desc=rec.comment)
            G.add(lens)
            if recs[j + 1].glass is not None:      # cemented: share the interface
                z += rec.thick + 1e-7
                j += 1
            else:
                z += rec.thick + recs[j + 1].thick
                j += 2
            continue

        if rec.is_stop:
            half_span = max(G.extent[1] - G.extent[0],
                            G.extent[3] - G.extent[2]) / 2
            G.add(Aperture(RingSurface(ri=rec.r, r=max(rec.r + 1, half_span)),
                           pos=[0, 0, z], desc=rec.comment))
        elif j + 1 == len(recs):
            # trailing passive surface acts as the image plane
            G.add(Detector(RectangularSurface(dim=[2 * rec.r, 2 * rec.r]),
                           pos=[0, 0, z], desc=rec.comment))
        z += rec.thick
        j += 1

    if title and not no_marker:
        ext = G.extent
        G.add(PointMarker(title, [ext[0] - 1.5, np.mean(ext[2:4]),
                                  np.mean(ext[4:6])], label_only=True))
    return G


def load_zmx(filename: str, n_dict: dict = None, no_marker: bool = False) -> Group:
    """Load a sequential ZEMAX .zmx geometry (MM units) into a Group."""
    text = _decode_file(filename)
    title = _parse_zmx_header(text)
    recs = _parse_surf_blocks(text, n_dict or {})
    return _assemble_group(recs, title, no_marker)
