"""The keratoconic eye of the benchmark (``benchmark/configs/keratoconic_eye.json``):
the Arizona eye with a Gaussian cone on its anterior cornea, a
``FunctionSurface2D`` whose hit the port solves numerically (the generic
step), held on the CPU against the benchmark's plain reference of it
(``benchmark/reference_keratoconus.py``).

- ``render_huge`` and ``trace`` + ``detector_image`` of the port at 2·10⁵
  rays, with cone parameters drawn from a seed within Tan et al.'s Table 1,
  against the reference's own rays: the power on the image, the spot's
  centroid and RMS radius, and the colour, each within five standard errors
  of the two samples. The same tolerances refuse the healthy cornea (h0 = 0)
  in the cone's place.
- The reference with h0 = 0 is its conic path within f64 rounding, and
  importing it loads nothing of the port or of JAX.
- The generic step makes nothing from host data, and a capture (a stand-in for the CUDA graph) replays the
  eager batch bit for bit, with the sag evaluations counted at every replay.
- The generic step runs inside the device interval ``trace_bundle.generic``,
  and only it; its sag is evaluated 44 times a ray (42 by the hit solve, two
  by the numeric normals).
"""

import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import geom
from optrace_tpu_torch.parallel import render as render_mod
from optrace_tpu_torch.parallel.checkpoint import batch_generator
from optrace_tpu_torch.tracer import trace_core

from test_torch_graph_step import _HostDataRecorder, _same, stand_in  # noqa: F401  (a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference, reference_keratoconus as rk, scene_keratoconus  # noqa: E402

CFG = json.loads((ROOT / "benchmark" / "configs" / "keratoconic_eye.json").read_text())
N_PROGRAM, N_REFERENCE = 200_000, 400_000
HALF = 0.2          # mm around the spot: the widest cone of the table keeps its PSF inside
# Table 1 of Tan et al. (2008), cases 1-14: the range of h0, sigma_x, sigma_y;
# the cone's centre between the axis and the "far" position of Figure 1
TABLE_RANGE = dict(h0=(0.0051, 0.0541), sigma_x=(0.4183, 1.7629), sigma_y=(0.4729, 1.2000),
                   x0=(0.0, 1.1), y0=(-1.4, 0.0))
SIGMAS = 5.0        # tolerance of a gap, in standard errors of the two samples


def cone_config(seed: int, **fixed) -> dict:
    """The configuration with cone parameters drawn from ``seed`` within
    Table 1's range (``fixed`` overrides some)."""
    rng = np.random.default_rng(seed)
    cfg = json.loads(json.dumps(CFG))
    row = cfg["surfaces"][0]
    for key, (lo, hi) in TABLE_RANGE.items():
        row[key] = float(lo + (hi - lo) * rng.random())
    row.update(fixed)
    return cfg


def spot_moments(x, y, w, xyz):
    """Power, centroid, RMS radius and colour (X, Y and Z over the power)
    of hits at (x, y) with powers w and tristimulus values xyz."""
    P = float(w.sum())
    cx, cy = float((w * x).sum()) / P, float((w * y).sum()) / P
    rms = math.sqrt(float((w * ((x - cx) ** 2 + (y - cy) ** 2)).sum()) / P)
    return dict(power=P, cx=cx, cy=cy, rms=rms, colour=(xyz.sum(0) / P).tolist(), hits=int((w > 0).sum()))


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
    scene = rk.Scene(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    p, s, w, wl = rk.sample_rays(scene, N_REFERENCE, gen, seed)
    tr = rk.trace(scene, p, s, w, wl)
    x, y, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
    x0, x1, y0, y1 = extent
    wh = torch.where((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1), wh, torch.zeros_like(wh))
    return spot_moments(x, y, wh, reference.observers(wl) * wh[:, None])


def gaps(a: dict, b: dict) -> dict:
    """Each moment's gap in standard errors of the two samples (the power's
    by its binomial share of the rays, the centroid's and colour's by the
    spot's spread, the RMS radius's by its own)."""
    na, nb = a["hits"], b["hits"]
    share = b["hits"] / N_REFERENCE
    both = 1 / na + 1 / nb
    out = dict(power=abs(a["power"] - b["power"]) / (b["power"] * math.sqrt((1 - share) / share * both)),
               cx=abs(a["cx"] - b["cx"]) / (b["rms"] * math.sqrt(both / 2)),
               cy=abs(a["cy"] - b["cy"]) / (b["rms"] * math.sqrt(both / 2)),
               rms=abs(a["rms"] - b["rms"]) / (b["rms"] * math.sqrt(both)))
    # each channel's mean over the hits: the spread of the observer's value
    # over the spectrum is about its mean, so its error is about mean / sqrt(n)
    out["colour"] = max(abs(p - q) / (q * math.sqrt(both)) for p, q in zip(a["colour"], b["colour"]))
    return out


def port_scene(cfg: dict, seed: int):
    return scene_keratoconus.build(otp, cfg, seed, no_pol=True, device="cpu")


@pytest.fixture(scope="module")
def cases():
    """Two cones drawn from their seeds, each with its extent around the
    reference's spot and the reference's moments."""
    out = {}
    for seed in (101, 20260517):
        cfg = cone_config(seed)
        ext = rk.spot_extent(cfg, seed, HALF, "cpu")
        out[seed] = (cfg, ext, reference_moments(cfg, seed, ext))
    return out


@pytest.mark.parametrize("seed", [101, 20260517])
def test_render_huge_against_the_reference(cases, seed):
    """``render_huge`` over two batches at the spot: the power on the image,
    the centroid, the RMS radius and the colour within five standard errors
    of the reference's."""
    cfg, ext, ref = cases[seed]
    RT = port_scene(cfg, seed)
    img = RT.render_huge(N_PROGRAM, batch_size=N_PROGRAM // 2, extent=ext)
    got = gaps(image_moments(img.data, img.extent), ref)
    assert max(got.values()) < SIGMAS, got


@pytest.mark.parametrize("seed", [101, 20260517])
def test_trace_against_the_reference(cases, seed):
    """The stored trace (eager: a function surface keeps it so) and its
    detector image on the same extent, held as the render is."""
    cfg, ext, ref = cases[seed]
    RT = port_scene(cfg, seed)
    assert RT._trace_entry(N_PROGRAM).eager_reason
    RT.trace(N_PROGRAM)
    img = RT.detector_image(extent=list(ext))
    got = gaps(image_moments(img.data, img.extent), ref)
    assert max(got.values()) < SIGMAS, got


def test_the_healthy_cornea_is_refused(cases):
    """The tolerances above see the cone: the port with the healthy cornea
    (h0 = 0) in its place lies beyond them."""
    seed = 101
    cfg, ext, ref = cases[seed]
    RT = port_scene(cone_config(seed, h0=0.0), seed)
    img = RT.render_huge(N_PROGRAM, batch_size=N_PROGRAM // 2, extent=ext)
    got = gaps(image_moments(img.data, img.extent), ref)
    assert max(got["cx"], got["cy"], got["rms"]) > 3 * SIGMAS, got


def test_a_healthy_cone_is_the_conic_path():
    """The reference with h0 = 0 traces as ``reference.trace`` does through
    the conic: Newton's steps leave the conic's hit in place and the sag's
    gradient gives the conic's normal, to f64 rounding."""
    cfg = cone_config(5, h0=0.0)
    gen = torch.Generator()
    gen.manual_seed(5)
    scene = rk.Scene(cfg)
    p, s, w, wl = rk.sample_rays(scene, 20000, gen, 5)
    cone = rk.trace(scene, p, s, w, wl)
    conic = reference.trace(reference.Scene(cfg), p, s, None, w, wl, store=False)
    assert float(cone["last"][1].sum()) > 0.5
    # the end lies 6 mm behind the retina, 700 mm from the object point
    assert torch.allclose(cone["end"], conic["end"], rtol=0, atol=1e-10)
    assert torch.allclose(cone["last"][0], conic["last"][0], rtol=0, atol=1e-10)
    assert torch.allclose(cone["last"][1], conic["last"][1], rtol=1e-13, atol=0)


def test_the_reference_loads_nothing_of_the_port():
    r = subprocess.run([sys.executable, "-c", "import sys, json; sys.path.insert(0, '.')\n"
                        "from benchmark import reference_keratoconus\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not {"jax", "jaxlib", "flax", "optrace_tpu", "optrace_tpu_torch"} & top
    assert "torch" in top


# ----------------------------------------------------------------------
# the generic step inside a render batch

N_BATCH = 4096
GRID = [dict(extent=[-0.3, 0.3, -0.3, 0.3], Nx=31, Ny=31)]


def test_the_generic_step_makes_nothing_from_host_data():
    """The function surface's hit solve over its sag, its numeric normals
    and its mask, with the user's scalars, make no tensor from host data:
    what a CUDA graph's capture could not record. (The Abbe media around it
    make their line wavelengths as host scalars, which a capture takes as
    arguments; the eye's cell has captured them since PR 18.)"""
    steps = port_scene(CFG, 3)._build_steps("cpu")
    generic = [st for st in steps if st.sfns.kind == "generic"]
    assert len(generic) == 1
    sf = generic[0].sfns
    gen = torch.Generator()
    gen.manual_seed(0)
    o = torch.stack([torch.rand(N_BATCH, generator=gen) * 2 - 1, torch.rand(N_BATCH, generator=gen) * 2 - 1,
                     torch.full((N_BATCH,), -1.0)], dim=1)
    s = torch.tensor([0.01, -0.02, 1.0]).expand(N_BATCH, 3) / math.sqrt(1.0005)
    rec = _HostDataRecorder()
    with rec:
        t, valid, ill = sf.hit_fn(sf.params, o, s)
        q = o + t[:, None] * s
        n = sf.normal_fn(sf.params, q[:, 0], q[:, 1])
        m = sf.mask_fn(sf.params, q[:, 0], q[:, 1])
    assert rec.made == []
    assert bool(valid.all()) and not bool(ill.any()) and bool(m.all())
    assert torch.allclose(n.norm(dim=1), torch.ones(N_BATCH))


def test_the_captured_generic_batch_replays_the_eager_one(stand_in):  # noqa: F811  (the fixture)
    """A capture of the keratoconic eye's batch (the stand-in graph) gives the
    eager batch bit for bit, and the sag evaluations of a replay are
    counted as those of an eager batch."""
    RT = port_scene(CFG, 3)
    eager, _ = render_mod._eager_fused_render(RT, N_BATCH, GRID, device="cpu")
    step = stand_in(eager, RT.trace_program_key)
    counts = []
    for b in range(4):
        before = geom.generic_sag.sag_evals
        out = step(batch_generator(9, b, "cpu"))
        counts.append(geom.generic_sag.sag_evals - before)
        assert _same(out, eager(batch_generator(9, b, "cpu")))
    # the stand-in's replay runs the batch again, which counts by itself
    # (the card's replay does not): a replay adds its capture's count on top
    per_batch = counts[0]
    assert per_batch == 44 * N_BATCH
    assert counts[1:] == [2 * per_batch] * 3
    assert step.captured_launches[(geom.generic_sag, "sag_evals")] == per_batch


def test_the_generic_step_is_its_own_device_interval(monkeypatch):
    """``trace_bundle`` opens the interval ``trace_bundle.generic`` once for
    the cone and never for a conic; the interval holds the hit solve, the
    mask and the normals: every sag evaluation of the batch."""
    opened = []

    class Interval:
        def __init__(self, name, device):
            opened.append(name)

        def __enter__(self):
            self.before = geom.generic_sag.sag_evals

        def __exit__(self, *exc):
            opened.append(geom.generic_sag.sag_evals - self.before)

    monkeypatch.setattr(trace_core, "device_interval", Interval)
    step, _ = render_mod._eager_fused_render(port_scene(CFG, 3), N_BATCH, GRID, device="cpu")
    before = geom.generic_sag.sag_evals
    step(batch_generator(1, 0, "cpu"))
    assert opened == ["trace_bundle.generic", 44 * N_BATCH]
    assert geom.generic_sag.sag_evals - before == 44 * N_BATCH
    opened.clear()
    healthy = json.loads(json.dumps(CFG))
    healthy["surfaces"][0]["type"] = "conic"
    step, _ = render_mod._eager_fused_render(scene_keratoconus.build(otp, healthy, 3, True, "cpu"), N_BATCH,
                                             GRID, device="cpu")
    step(batch_generator(1, 0, "cpu"))
    assert opened == []
