"""The port's ZEMAX loaders (io/load.py) against the JAX package's, on
synthetic files written to ``tmp_path`` as tests/test_load_errors.py
writes them: every case of that file, a catalog with every one of the 13
formula modes, and a prescription with a cemented doublet, a stop and an
even asphere whose loaded groups are then traced ray by ray.

Loaded groups are compared field by field: element and surface types,
positions, radii, curvatures, conic constants and asphere coefficients to
1e-12 (both are host f64), z extents to 1e-7 mm (the JAX package probes an
asphere's extent through its f32 sag), media by their index at seven
wavelengths to rtol 1e-6 (the JAX package evaluates a medium in f32). The
traces use the tolerances of tests/test_torch_common.py.
"""

import warnings

import numpy as np
import pytest

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc

from test_torch_common import make_bundle, jax_trace, torch_trace_scene, assert_sections_agree

BASE_ZMX = """MODE SEQ
NAME synthetic test lens
UNIT MM X W X Y
SURF 0
  TYPE STANDARD
  CURV 0.0
  DISZ INFINITY
SURF 1
  TYPE STANDARD
  CURV 0.05
  DIAM 5
  GLAS ___BLANK 0 0 1.5168 64.17 0 0 0 0
  DISZ 3.0
SURF 2
  TYPE STANDARD
  CURV -0.05
  DIAM 5
  DISZ 10.0
SURF 3
  TYPE STANDARD
  CURV 0.0
  DIAM 4
  DISZ 0.0
"""

# a cemented doublet (four refracting surfaces in a row: one run of the run
# kernel), a stop, an even asphere singlet with a conic back, the image plane
RUN_ZMX = """MODE SEQ
NAME doublet stop asphere
UNIT MM X W X Y
SURF 0
  TYPE STANDARD
  CURV 0.0
  DISZ INFINITY
SURF 1
  TYPE STANDARD
  CURV 0.05
  DIAM 5
  GLAS CROWN 0 0 1.5168 64.17 0 0 0 0
  DISZ 3.0
SURF 2
  TYPE STANDARD
  CURV -0.06
  DIAM 5
  GLAS ___BLANK 0 0 1.62 36.37 0 0 0 0
  DISZ 1.5
SURF 3
  TYPE STANDARD
  CURV -0.01
  DIAM 5
  DISZ 2.0
SURF 4
  TYPE STANDARD
  CURV 0.0
  DIAM 2
  STOP
  DISZ 2.0
SURF 5
  TYPE EVENASPH
  CURV 0.04
  DIAM 5
  PARM 1 0.0
  PARM 2 1e-5
  GLAS ___BLANK 0 0 1.5168 64.17 0 0 0 0
  DISZ 2.5
SURF 6
  TYPE STANDARD
  CURV -0.04
  CONI -1.0
  DIAM 5
  DISZ 20.0
SURF 7
  TYPE STANDARD
  CURV 0.0
  DIAM 6
  DISZ 0.0
"""

STOP_ZMX = BASE_ZMX.replace(
    "SURF 3\n  TYPE STANDARD\n  CURV 0.0\n  DIAM 4\n  DISZ 0.0\n",
    "SURF 3\n  TYPE STANDARD\n  CURV 0.0\n  DIAM 2\n  STOP\n  DISZ 5.0\n"
    "SURF 4\n  TYPE STANDARD\n  CURV 0.0\n  DIAM 4\n  DISZ 0.0\n")

# case -> (text, n_dict glass names, write encoding, load keywords, error)
ZMX_CASES = {
    "unsupported_unit": (BASE_ZMX.replace("UNIT MM", "UNIT IN"), (), "utf-8", {}, "Unsupported Unit"),
    "unsupported_mode": (BASE_ZMX.replace("MODE SEQ", "MODE NSEQ"), (), "utf-8", {}, "Unsupported Mode"),
    "missing_material": (BASE_ZMX.replace("GLAS ___BLANK 0 0 1.5168 64.17 0 0 0 0", "GLAS UNOBTAINIUM 0 0"),
                         (), "utf-8", {}, "missing in n_dict"),
    "unsupported_surface_type": (BASE_ZMX.replace("SURF 1\n  TYPE STANDARD", "SURF 1\n  TYPE TOROIDAL"),
                                 (), "utf-8", {}, "not supported"),
    "blank_glass": (BASE_ZMX, (), "utf-8", {}, None),
    "named_glass": (BASE_ZMX.replace("___BLANK", "MYGLASS"), ("MYGLASS",), "utf-8", {}, None),
    "stop_ring": (STOP_ZMX, (), "utf-8", {}, None),
    "even_asphere": (BASE_ZMX.replace("SURF 1\n  TYPE STANDARD\n  CURV 0.05\n  DIAM 5",
                                      "SURF 1\n  TYPE EVENASPH\n  CURV 0.05\n  DIAM 5\n"
                                      "  PARM 1 0.0\n  PARM 2 1e-5"), (), "utf-8", {}, None),
    "utf16": (BASE_ZMX, (), "utf-16", {}, None),
    "no_marker": (BASE_ZMX, (), "utf-8", dict(no_marker=True), None),
    "doublet_stop_asphere": (RUN_ZMX, ("CROWN",), "utf-8", {}, None),
}

WLS = np.linspace(400.0, 700.0, 7)


def _n(ri):
    return None if ri is None else np.asarray(ri(WLS), dtype=np.float64)


def _surface_fields(s):
    d = dict(type=type(s).__name__, pos=np.asarray(s.pos), r=s.r, z=(s.z_min, s.z_max))
    for key in ("R", "k", "ri", "dim", "coeff", "parax_roc"):
        if hasattr(s, key):
            d[key] = np.asarray(getattr(s, key), dtype=np.float64)
    return d


def _group_fields(G):
    out = dict(n0=_n(G.n0), desc=G.long_desc)
    for kind in ("lenses", "apertures", "detectors", "markers"):
        rows = []
        for el in getattr(G, kind):
            row = dict(type=type(el).__name__, pos=np.asarray(el.pos), desc=el.desc)
            if kind != "markers":
                row["front"] = _surface_fields(el.front)
            if kind == "lenses":
                row.update(back=_surface_fields(el.back), n=_n(el.n), n2=_n(el.n2), d=el.d)
            if kind == "markers":
                row.update(text=el.desc, label_only=el.label_only)
            rows.append(row)
        out[kind] = rows
    return out


def _assert_fields_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_fields_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_fields_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (str, bool)):
        assert a == b, path
    else:
        rtol = 1e-6 if path.endswith((".n", ".n2", ".n0")) else 1e-12
        atol = 1e-7 if path.endswith(".z") else 1e-12
        np.testing.assert_allclose(np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64),
                                   rtol=rtol, atol=atol, err_msg=path)


def _load_both(tmp_path, case):
    text, glasses, enc, kw, _ = ZMX_CASES[case]
    f = tmp_path / "t.zmx"
    f.write_text(text, encoding=enc)
    groups = []
    for pkg in (ot, otp):
        n_dict = {g: pkg.presets.refraction_index.BK7 for g in glasses}
        with pkg.global_options.no_warnings():
            groups.append(pkg.load_zmx(str(f), n_dict=n_dict or None, **kw))
    return groups


@pytest.mark.parametrize("case", sorted(ZMX_CASES))
def test_load_zmx_cases(tmp_path, case):
    error = ZMX_CASES[case][4]
    if error is not None:
        for pkg in (ot, otp):
            f = tmp_path / "t.zmx"
            f.write_text(ZMX_CASES[case][0])
            with pytest.raises(RuntimeError, match=error):
                pkg.load_zmx(str(f))
        return
    Gj, Gt = _load_both(tmp_path, case)
    _assert_fields_equal(_group_fields(Gj), _group_fields(Gt))
    assert len(Gt.markers) == (0 if case == "no_marker" else 1)
    if case == "named_glass":
        assert Gt.lenses[0].n is otp.presets.refraction_index.BK7
    if case == "stop_ring":
        assert type(Gt.apertures[0].front).__name__ == "RingSurface"
        assert Gt.apertures[0].pos[2] == pytest.approx(13.0, abs=1e-9)


def test_missing_files():
    for pkg in (ot, otp):
        with pytest.raises(FileNotFoundError):
            pkg.load_zmx("/nonexistent/file.zmx")
        with pytest.raises(FileNotFoundError):
            pkg.load_agf("/nonexistent/file.agf")


def test_loaded_prescription_traced_ray_by_ray(tmp_path):
    """The loaded doublet + stop + asphere, traced by both packages on the
    same bundle; the doublet's four surfaces form one run of the port."""
    Gj, Gt = _load_both(tmp_path, "doublet_stop_asphere")
    RTs = []
    for pkg, G in ((ot, Gj), (otp, Gt)):
        kw = {"device": "cpu"} if pkg is otp else {}
        RT = pkg.Raytracer(outline=[-10, 10, -10, 10, -10, 60], no_pol=True, **kw)
        RT.add(pkg.RaySource(pkg.CircularSurface(r=2.0), pos=[0, 0, -5], divergence="None",
                             spectrum=pkg.presets.light_spectrum.d65))
        RT.add(G)
        RTs.append(RT)
    bundle = make_bundle("lens", 2000, seed=9)
    out_j, _ = jax_trace(RTs[0], bundle, True, kernel=False)
    out_t, steps = torch_trace_scene(RTs[1], bundle, True)
    assert_sections_agree(out_j, out_t, 2000)
    assert [len(i) for k, i in ttc._partition_runs(steps, []) if k == "run"] == [4]
    assert float(out_t["w"][:, -2].sum()) > 0.1


AGF_BLOCK = """NM TESTGLAS 2 0 1.51680 64.17 0
ED 0 0 0 0 0
CD 1.03961212 0.00600069867 0.231792344 0.0200179144 1.01046945 103.560653
TD 0 0 0 0 0 0 0
LD 0.3 2.5
"""


def _every_mode():
    """One glass per formula mode (n about 1.5 and slightly dispersive), one
    with a short and one with a long coefficient line, one without CD, one
    with a range that misses the test lines, an unknown mode."""
    lines = []
    for mode in range(1, 14):
        lines += [f"NM G{mode} {mode} 0 1.5 60 0", "CD 2.25 0.01 0 0 0 0 0 0 0 0 0", "LD 0.3 2.5"]
    lines += ["NM SHORT 2 0 1.5168 64.17 0", "CD 1.03961212 0.00600069867", "LD 0.3 2.5",
              "NM LONG 1 0 1.5 60 0", "CD 2.25 0.01 0 0 0 0 0 0 0 0 0 0 0 0 0", "LD 0.3 2.5",
              "NM NOCD 2 0 1.5 60 0", "LD 0.3 2.5",
              "NM FARIR 2 0 1.5 60 0", "CD 1.0 0.01 0 0 0 0", "LD 3.0 9.0",
              "NM ODD 99 0 1.5 60 0", "CD 1 2 3", "LD 0.3 2.5"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("case", ["sellmeier_block", "unknown_formula", "every_mode", "utf16"])
def test_load_agf(tmp_path, case):
    text = {"sellmeier_block": AGF_BLOCK, "unknown_formula": AGF_BLOCK.replace("NM TESTGLAS 2", "NM TESTGLAS 99"),
            "every_mode": _every_mode(), "utf16": AGF_BLOCK}[case]
    f = tmp_path / "t.agf"
    f.write_text(text, encoding="utf-16" if case == "utf16" else "utf-8")
    cats, msgs = [], []
    for pkg in (ot, otp):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cats.append(pkg.load_agf(str(f)))
        msgs.append(sorted(str(w.message) for w in rec if issubclass(w.category, pkg.OptraceWarning)))
    assert cats[0].keys() == cats[1].keys()
    assert msgs[0] == msgs[1] and bool(msgs[1]) == (case in ("unknown_formula", "every_mode"))
    for name in cats[0]:
        np.testing.assert_allclose(_n(cats[1][name]), _n(cats[0][name]), rtol=1e-6, err_msg=name)
        assert cats[1][name].get_desc() == cats[0][name].get_desc() == name
    if case in ("sellmeier_block", "utf16"):
        assert list(cats[1]) == ["TESTGLAS"]
        np.testing.assert_allclose(_n(cats[1]["TESTGLAS"]), _n(otp.presets.refraction_index.BK7),
                                   rtol=1e-12)
    elif case == "unknown_formula":
        assert "TESTGLAS" not in cats[1]
    else:
        assert {f"G{m}" for m in range(1, 14)} | {"SHORT", "LONG", "FARIR"} == set(cats[1])
