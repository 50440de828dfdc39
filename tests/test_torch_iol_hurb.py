"""The pseudophakic eye of the benchmark (``benchmark/configs/iol_eye.json``):
the Arizona eye with the Alcon IQ intraocular lens in its lens's place, a
3 mm pupil that bends the rays passing it by HURB (Heisenberg-uncertainty
ray bending) and the lens's strongly hyperbolic even-asphere back, held on
the CPU against the benchmark's plain reference of it
(``benchmark/reference_iol.py``).

- ``render_huge`` of the port at 2·10⁵ rays against the reference's own
  rays: the power on the image, the spot's centroid and RMS radius and the
  colour, each within five standard errors of the two samples (the RMS
  radius's from the spread of the reference's squared radii, since HURB's
  bends near the pupil's edge give the spot heavy tails). The same
  tolerances refuse the port with HURB off: its spot's RMS radius lies some
  25 standard errors inside the reference's.
- The reference's bend is the port's ``_hurb`` on injected rays and normals,
  and its asphere hit and normal are the port's asphere surface's, all in
  f64 to its rounding; importing the reference loads nothing of the port or
  of JAX.
- A capture (a stand-in for the CUDA graph) replays the eager HURB batch bit
  for bit with fresh normals for each batch's generator, and the counter
  ``trace_bundle.hurb_rays`` counts at every replay.
- The HURB step runs inside the device interval ``trace_bundle.hurb``, and
  only it.
- The scene built from the configuration is the one that
  ``examples_torch/IOL_target_imaging.py`` builds: surfaces, positions and
  media at the F, d and C lines.
"""

import copy
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.parallel import render as render_mod
from optrace_tpu_torch.parallel.checkpoint import batch_generator
from optrace_tpu_torch.tracer import trace_core

from test_torch_graph_step import _same, stand_in  # noqa: F401  (a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference, reference_iol as ri, scene_iol  # noqa: E402

CFG = json.loads((ROOT / "benchmark" / "configs" / "iol_eye.json").read_text())
N_PROGRAM, N_REFERENCE = 200_000, 400_000
HALF = 0.08         # mm around the spot: the cell's extent
SIGMAS = 5.0        # tolerance of a gap, in standard errors of the two samples
LINES = (486.1327, 587.5618, 656.272)


def hurb_off(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["use_hurb"] = False
    return cfg


def port_scene(cfg: dict, seed: int):
    return scene_iol.build(otp, cfg, seed, no_pol=True, device="cpu")


def spot_moments(x, y, w, xyz):
    """Power, centroid, RMS radius, colour (X, Y and Z over the power), and
    the spreads their standard errors take: of x, of y and of the squared
    radius about the centroid."""
    P = float(w.sum())
    cx, cy = float((w * x).sum()) / P, float((w * y).sum()) / P
    r2 = (x - cx) ** 2 + (y - cy) ** 2
    ms = float((w * r2).sum()) / P
    return dict(power=P, cx=cx, cy=cy, rms=math.sqrt(ms), colour=(xyz.sum(0) / P).tolist(),
                var_x=float((w * (x - cx) ** 2).sum()) / P, var_y=float((w * (y - cy) ** 2).sum()) / P,
                sd_r2=math.sqrt(float((w * (r2 - ms) ** 2).sum()) / P), hits=int((w > 0).sum()))


def image_moments(data: np.ndarray, extent) -> dict:
    """``spot_moments`` of an (Ny, Nx, 4) XYZW image, each pixel at its centre."""
    Ny, Nx, _ = data.shape
    x0, x1, y0, y1 = extent
    xs = x0 + (np.arange(Nx) + 0.5) * (x1 - x0) / Nx
    ys = y0 + (np.arange(Ny) + 0.5) * (y1 - y0) / Ny
    X, Y = np.meshgrid(xs, ys)
    t = torch.as_tensor
    return spot_moments(t(X.ravel()), t(Y.ravel()), t(data[..., 3].ravel()), t(data[..., :3].reshape(-1, 3)))


def reference_moments(cfg: dict, seed: int, extent) -> dict:
    """The reference's moments of ``N_REFERENCE`` rays inside ``extent``."""
    scene = ri.Scene(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    p, s, w, wl = ri.rk.sample_rays(scene, N_REFERENCE, gen, seed)
    tr = ri.trace(scene, p, s, w, wl, gen)
    x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
    x0, x1, y0, y1 = extent
    wh = torch.where((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1), wh, torch.zeros_like(wh))
    return spot_moments(x, y, wh, reference.observers(wl) * wh[:, None])


def gaps(a: dict, b: dict) -> dict:
    """Each moment's gap in standard errors of the two samples, the program's
    ``a`` (its hits the reference's share of ``N_PROGRAM``) against the
    reference's ``b``: the power's by its binomial share of the rays, the
    centroid's by the spot's spread, the RMS radius's by the spread of the
    squared radii, the colour's by its mean."""
    nb = b["hits"]
    share = nb / N_REFERENCE
    both = 1 / (N_PROGRAM * share) + 1 / nb
    out = dict(power=abs(a["power"] - b["power"]) / (b["power"] * math.sqrt((1 - share) / share * both)),
               cx=abs(a["cx"] - b["cx"]) / math.sqrt(b["var_x"] * both),
               cy=abs(a["cy"] - b["cy"]) / math.sqrt(b["var_y"] * both),
               rms=abs(a["rms"] - b["rms"]) / (b["sd_r2"] * math.sqrt(both) / (2 * b["rms"])))
    out["colour"] = max(abs(p - q) / (q * math.sqrt(both)) for p, q in zip(a["colour"], b["colour"]))
    return out


@pytest.fixture(scope="module")
def cases():
    """Two object points drawn from their seeds, each with its extent around
    the reference's spot and the reference's moments."""
    out = {}
    for seed in (101, 20260517):
        ext = ri.spot_extent(CFG, seed, HALF, "cpu")
        out[seed] = (ext, reference_moments(CFG, seed, ext))
    return out


@pytest.mark.parametrize("seed", [101, 20260517])
def test_render_huge_against_the_reference(cases, seed):
    """``render_huge`` over two batches at the spot: the power on the image,
    the centroid, the RMS radius and the colour within five standard errors
    of the reference's."""
    ext, ref = cases[seed]
    img = port_scene(CFG, seed).render_huge(N_PROGRAM, batch_size=N_PROGRAM // 2, extent=ext)
    got = gaps(image_moments(img.data, img.extent), ref)
    assert max(got.values()) < SIGMAS, got


def test_hurb_off_is_refused(cases):
    """The tolerances above see HURB: the port with HURB off renders a spot
    whose RMS radius lies far inside the reference's (HURB's bends near the
    pupil's edge spread the halo), well beyond them."""
    seed = 101
    ext, ref = cases[seed]
    img = port_scene(hurb_off(CFG), seed).render_huge(N_PROGRAM, batch_size=N_PROGRAM // 2, extent=ext)
    got = gaps(image_moments(img.data, img.extent), ref)
    assert got["rms"] > 3 * SIGMAS, got


def _steps_f64():
    steps = port_scene(CFG, 3)._build_steps("cpu", torch.float64)
    return {st.sfns.kind if st.action == "refract" else st.action: st for st in steps[:5]}


BEND_CASES = {     # radius at the pupil (mm, from uniform u), and the rays' tilt
    "near the axis": (lambda u: 0.3 * u, 0.01),
    "across the opening and the ring": (lambda u: 1.6 * u, 0.05),
    "at the edge, oblique": (lambda u: 1.5 - 1e-4 * u, 0.6),
}


@pytest.mark.parametrize("rays", sorted(BEND_CASES))
def test_the_reference_bend_is_the_ports(rays):
    """``reference_iol.hurb_bend`` and the port's ``_hurb`` on the same rays
    at the pupil, the same normals and the aqueous index, in f64: the same
    directions to f64 rounding, the same rays absorbed (oblique rays at the
    edge bend backwards), the same rays left unbent (those on the ring)."""
    step = _steps_f64()["absorb"]
    assert step.hurb and step.hurb_kind == "ring"
    radius, tilt = BEND_CASES[rays]
    gen = torch.Generator()
    gen.manual_seed(sorted(BEND_CASES).index(rays))
    N = 4096
    u = lambda: torch.rand(N, generator=gen, dtype=torch.float64)     # noqa: E731
    r, phi = radius(u()), 2 * math.pi * u()
    p = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.zeros(N, dtype=torch.float64)], dim=1)
    s = torch.stack([tilt * (2 * u() - 1), tilt * (2 * u() - 1), torch.ones(N, dtype=torch.float64)], dim=1)
    s = s / s.norm(dim=1, keepdim=True)
    w = torch.ones(N, dtype=torch.float64)
    wl = 380 + 400 * u()
    n = ri.Scene(CFG).index(CFG["media"]["aqueous"], wl)
    normals = (torch.randn(N, generator=gen, dtype=torch.float64),
               torch.randn(N, generator=gen, dtype=torch.float64))
    factor = float(CFG["hurb_factor"])
    s_port, w_port, _, n_neg = trace_core._hurb(step, normals, p, s, w, wl, n, None, r >= 0, True, factor)
    surf = next(x for x in ri.Scene(CFG).surfaces if x["kind"] == "stop")
    s_ref, w_ref = ri.hurb_bend(surf, normals, p, s, w, wl, n, factor, r >= 0)
    bent = r < 1.5
    assert bool(bent.any()) and bool((s_ref[bent] != s[bent]).any(dim=1).all())
    assert torch.equal(s_ref[~bent], s[~bent])
    assert torch.equal(w_port, w_ref) and int(n_neg) == int((w_ref == 0).sum())
    if rays == "at the edge, oblique":
        assert 0 < int(n_neg) < N // 2
    assert float((s_port - s_ref).abs().max()) < 1e-14


def test_the_reference_asphere_is_the_ports():
    """``reference_iol.asphere_hit`` and ``asphere_normal`` against the port's
    asphere surface (its hit solve and normals in f64) on injected rays in
    the surface's own frame, from 0.6 mm ahead of its vertex: the same hits
    and normals to f64 rounding."""
    step = _steps_f64()["asphere"]
    surf = dict(next(x for x in ri.Scene(CFG).surfaces if "coeff" in x), z=0.0)
    gen = torch.Generator()
    gen.manual_seed(11)
    N = 4096
    u = lambda: torch.rand(N, generator=gen, dtype=torch.float64)     # noqa: E731
    r, phi = 2.5 * torch.sqrt(u()), 2 * math.pi * u()
    p = torch.stack([r * torch.cos(phi), r * torch.sin(phi), torch.full((N,), -0.6, dtype=torch.float64)],
                    dim=1)
    s = torch.stack([0.1 * (2 * u() - 1), 0.1 * (2 * u() - 1), torch.ones(N, dtype=torch.float64)], dim=1)
    s = s / s.norm(dim=1, keepdim=True)
    hw = torch.ones(N, dtype=torch.bool)
    p_port, hit, ill, _ = trace_core._surface_hit(step, p, s, hw)
    t, met = ri.asphere_hit(surf, p, s)
    p_ref = p + t[:, None] * s
    assert bool(hit.all()) and bool(met.all()) and not bool(ill.any())
    assert float((p_port - p_ref).abs().max()) < 1e-12
    # the polynomial moves the hits off the conic's by up to some 0.7 µm
    t_conic, _ = reference._hit(surf, p, s)
    assert float((p_ref - (p + t_conic[:, None] * s)).abs().max()) > 1e-4
    n_port = step.sfns.normal_fn(step.sfns.params, p_port[:, 0], p_port[:, 1])
    assert float((n_port - ri.asphere_normal(surf, p_ref)).abs().max()) < 1e-13


def test_the_reference_loads_nothing_of_the_port():
    r = subprocess.run([sys.executable, "-c", "import sys, json; sys.path.insert(0, '.')\n"
                        "from benchmark import reference_iol\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "optrace_tpu", "optrace_tpu_torch"} & top
    assert "torch" in top


# ----------------------------------------------------------------------
# the HURB step inside a render batch

N_BATCH = 4096
GRID = [dict(extent=[-0.3, 0.3, -0.3, 0.3], Nx=31, Ny=31)]


def test_the_captured_hurb_batch_replays_the_eager_one(stand_in, monkeypatch):  # noqa: F811  (the fixture)
    """A capture of the eye's batch (the stand-in graph) gives the eager batch
    bit for bit; each batch's generator draws normals of its own, and a
    replay counts the rays that enter the HURB step as an eager batch does."""
    drawn = []
    real = trace_core._hurb_normals

    def recording(*a, **k):
        out = real(*a, **k)
        drawn.append(out[0].clone())
        return out
    monkeypatch.setattr(trace_core, "_hurb_normals", recording)
    RT = port_scene(CFG, 3)
    eager, _ = render_mod._eager_fused_render(RT, N_BATCH, GRID, device="cpu")
    step = stand_in(eager, RT.trace_program_key)
    counts = []
    for b in range(4):
        before = trace_core.trace_bundle.hurb_rays
        out = step(batch_generator(9, b, "cpu"))
        counts.append(trace_core.trace_bundle.hurb_rays - before)
        drawn_step = drawn[-1]
        assert _same(out, eager(batch_generator(9, b, "cpu")))
        assert torch.equal(drawn[-1], drawn_step)
        assert b == 0 or not torch.equal(drawn_step, drawn_before)
        drawn_before = drawn_step
    # the stand-in's replay runs the batch again, which counts by itself
    # (the card's replay does not): a replay adds its capture's count on top
    assert counts == [N_BATCH] + [2 * N_BATCH] * 3
    assert step.captured_launches[(trace_core.trace_bundle, "hurb_rays")] == N_BATCH


def test_the_hurb_step_is_its_own_device_interval(monkeypatch):
    """``trace_bundle`` opens the interval ``trace_bundle.hurb`` once a batch,
    around the draws and the bend, and not at all with HURB off."""
    opened = []

    class Interval:
        def __init__(self, name, device):
            opened.append(name)

        def __enter__(self):
            opened.append("enter")

        def __exit__(self, *exc):
            opened.append("exit")

    for name in ("_hurb_normals", "_hurb"):
        real = getattr(trace_core, name)
        monkeypatch.setattr(trace_core, name, lambda *a, _real=real, _name=name, **k:
                            opened.append(_name) or _real(*a, **k))
    monkeypatch.setattr(trace_core, "device_interval", Interval)
    step, _ = render_mod._eager_fused_render(port_scene(CFG, 3), N_BATCH, GRID, device="cpu")
    step(batch_generator(1, 0, "cpu"))
    assert opened == ["trace_bundle.hurb", "enter", "_hurb_normals", "_hurb", "exit"]
    opened.clear()
    step, _ = render_mod._eager_fused_render(port_scene(hurb_off(CFG), 3), N_BATCH, GRID, device="cpu")
    step(batch_generator(1, 0, "cpu"))
    assert opened == []


# ----------------------------------------------------------------------
# the configuration against the upstream example

def example_scene(monkeypatch):
    """The raytracer of ``examples_torch/IOL_target_imaging.py`` as the
    example has built it when it first traces (its scene whole, its first
    source the 100 m point)."""
    from examples_torch import IOL_target_imaging as ex

    class Built(Exception):
        pass

    def trace(RT, *a, **k):
        raise Built(RT)
    monkeypatch.setattr(otp.Raytracer, "trace", trace)
    with pytest.raises(Built) as built:
        ex.main(device="cpu", rays=1000)
    return built.value.args[0]


def test_the_configuration_is_the_examples_scene(monkeypatch):
    """The cornea, the pupil, the IOL, their positions and media at the F, d
    and C lines, the flat detector at the retina and HURB: the scene built
    from ``iol_eye.json`` against the example's own."""
    ex = example_scene(monkeypatch)
    ours = port_scene(CFG, 3)
    assert ex.use_hurb and ours.use_hurb and ours.HURB_FACTOR == ex.HURB_FACTOR == math.sqrt(2)
    wl = np.asarray(LINES)
    assert len(ex.lenses) == len(ours.lenses) == 2
    for a, b in zip(ex.lenses, ours.lenses):
        for sa, sb in ((a.front, b.front), (a.back, b.back)):
            assert type(sa) is type(sb)
            for key in ("r", "R", "k"):
                assert getattr(sa, key) == getattr(sb, key), key
            assert getattr(sa, "coeff", None) == getattr(sb, "coeff", None)
            assert np.allclose(sa.pos, sb.pos, rtol=0, atol=1e-12)
        for na, nb in ((a.n, b.n), (a.n2, b.n2)):
            assert np.allclose(np.asarray(na(wl)), np.asarray(nb(wl)), rtol=0, atol=1e-14)
    assert type(ours.lenses[1].back) is otp.AsphericSurface
    (pa,), (pb,) = ex.apertures, ours.apertures
    assert (pa.front.r, pa.front.ri) == (pb.front.r, pb.front.ri) == (5.45, 1.5)
    assert np.allclose(pa.front.pos, pb.front.pos, rtol=0, atol=1e-12)
    # the example's flat retina, its detector 1 (detector 0 the spherical one)
    flat, (det,) = ex.detectors[1], ours.detectors
    assert np.allclose(flat.front.extent, det.front.extent, rtol=0, atol=1e-12)
    assert np.allclose(flat.pos, det.pos, rtol=0, atol=1e-12)
    src = ex.ray_sources[0]
    assert src.pos[2] == -1e5 and src.divergence == "Lambertian"
    assert math.isclose(src.div_angle, CFG["ray_source"]["div_angle_deg"], rel_tol=1e-12)
    assert np.allclose(np.asarray(ex.n0(wl)), np.asarray(ours.n0(wl)), rtol=0, atol=0)
