"""The yardstick on the CPU: the scene a configuration builds, the
reference's optics, the roofline's counts, the profile's reading, and
that nothing of a run loads JAX."""

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_common import ROOT
from benchmark import profiling, reference, roofline, scene as bscene

import optrace_tpu_torch as ot

DG = json.loads((ROOT / "benchmark/configs/double_gauss.json").read_text())


def test_the_configuration_builds_its_scene():
    """The program's scene from the file holds the surfaces, media, stop and
    detector that the reference reads from the same file."""
    RT = bscene.build(ot, DG, seed=3, no_pol=True, device="cpu")
    ref = reference.Scene(DG)
    refr = [s for s in ref.surfaces if s["kind"] == "refract"]
    port = [surf for L in RT.lenses for surf in (L.front, L.back)]
    assert len(port) == len(refr) == 14
    wl = torch.tensor([400.0, 587.5618, 700.0], dtype=torch.float64)
    for L, (f, b) in zip(RT.lenses, zip(refr[0::2], refr[1::2])):
        assert L.front.pos[2] == pytest.approx(f["z"], abs=1e-9)
        assert L.back.pos[2] == pytest.approx(b["z"], abs=1e-9)
        assert 1 / L.front.R == pytest.approx(f["c"]) and 1 / L.back.R == pytest.approx(b["c"])
        # the program keeps the Abbe lines in f32: its indices lie 1e-7 off
        assert np.asarray(L.n(wl.numpy())) == pytest.approx(ref.index(f["n2"], wl).numpy(), rel=1e-6)
    stop = [s for s in ref.surfaces if s["kind"] == "stop"][0]
    assert RT.apertures[0].pos[2] == pytest.approx(stop["z"], abs=1e-9)
    assert RT.apertures[0].surface.ri == stop["ri"]
    assert RT.detectors[0].pos[2] == pytest.approx(ref.detector["z"], abs=1e-9)
    assert RT.ray_sources[0].pos == pytest.approx(reference.source_position(DG, 3))
    assert list(RT.outline) == DG["outline"]


def test_source_position_is_a_function_of_the_seed():
    a, b = reference.source_position(DG, 2**40 + 1), reference.source_position(DG, 2**40 + 2)
    assert a == reference.source_position(DG, 2**40 + 1) and a != b
    tilt = math.degrees(math.atan2(math.hypot(a[0], a[1]), -a[2]))
    assert tilt <= DG["ray_source"]["field_angle_max_deg"]


def test_normal_incidence_keeps_direction_and_fresnel_loss():
    """A ray along the axis through one surface: no bend, T = 4 n1 n2 / (n1 + n2)²."""
    cfg = dict(DG, surfaces=[dict(type="conic", R=50.0, k=0.0, r=10.0, after="L1", d=5.0)])
    sc = reference.Scene(cfg)
    p = torch.tensor([[0.0, 0.0, -10.0]], dtype=torch.float64)
    s = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    wl = torch.tensor([587.5618], dtype=torch.float64)
    tr = reference.trace(sc, p, s, None, torch.ones(1, dtype=torch.float64), wl)
    n2 = float(sc.index(cfg["media"]["L1"], wl))
    assert n2 == pytest.approx(1.797, abs=1e-12)
    assert float(tr["w"][0, 1]) == pytest.approx(4 * n2 / (1 + n2) ** 2, rel=1e-12)
    assert tr["p"][0, 1].tolist() == pytest.approx([0, 0, 0])


def test_srgb_of_white_and_of_a_spectral_colour():
    white = torch.tensor([[[0.95047, 1.0, 1.08883]]], dtype=torch.float64)
    assert reference.xyz_to_srgb_absolute(white).flatten().tolist() == pytest.approx([1, 1, 1], abs=1e-4)
    # 520 nm lies outside the gamut: clipped onto its edge, no channel negative
    _, xb, yb, zb = reference.observer_table()
    green = torch.tensor([[[xb[160], yb[160], zb[160]]]], dtype=torch.float64)
    rgb = reference.xyz_to_srgb_absolute(green).flatten()
    assert rgb.min() >= 0 and rgb[1] == pytest.approx(1.0) and rgb[0] < 0.5


def test_binning_edges():
    x = torch.tensor([0.0, 1.0, 0.5, 1.5], dtype=torch.float64)
    y = torch.tensor([0.0, 1.0, 0.5, 0.5], dtype=torch.float64)
    w = torch.ones(4, dtype=torch.float64)
    img = reference.bin_xyzw(x, y, w, torch.full((4,), 550.0, dtype=torch.float64), 2, 2, (0, 1, 0, 1))
    assert img[..., 3].tolist() == [[1.0, 0.0], [0.0, 2.0]]


# ----------------------------------------------------------------------
# roofline counts, from the scene's shapes

def test_kernel1_counts():
    sc = reference.Scene(DG)
    assert [len(r) for r in roofline.runs(sc)] == [6, 8]
    alive = [1.0] * len(sc.surfaces)
    ops, nbytes = roofline.kernel1_work(sc, 10**6, alive, pol=False, store=False)
    # each run reads and writes 28 B a ray and 4 B a ray of each of its media
    # (4 and 5), and 16 B a step: the main path's bound of 0.04418 ms
    assert nbytes == 10**6 * (56 + 16) + 6 * 16 + 10**6 * (56 + 20) + 8 * 16
    assert ops == 14 * 150 * 10**6
    assert roofline.least_seconds(ops, nbytes) * 1e3 == pytest.approx(0.04418, abs=1e-5)
    _, nbytes = roofline.kernel1_work(sc, 10**6, alive, pol=True, store=True)
    assert roofline.least_seconds(0, nbytes) * 1e3 == pytest.approx(0.17552, abs=1e-5)


def test_kernel2_counts():
    ops, nbytes = roofline.kernel2_work(10**6, 945, 945)
    assert nbytes == 16 * 10**6 + 16 * 945 * 945 and ops == 30 * 10**6
    assert roofline.least_seconds(ops, nbytes) * 1e3 == pytest.approx(0.00904, abs=1e-5)


def test_shares_of_the_scene():
    sh = roofline.shares(DG, 5, "cpu", n=20000)
    # the cone overfills the first two lenses a little (about 7 % missed)
    assert sh["alive"][0] == 1.0 and 0.85 < sh["hits"] < 0.97
    assert all(a >= b for a, b in zip(sh["alive"], sh["alive"][1:]))


# ----------------------------------------------------------------------
# the profile's reading

def _ev(name, start, end, cuda):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def test_profile_reading():
    events = [_ev("bench:stretch", 0, 100, False), _ev("bench:stretch", 0, 100, True),
              _ev("aten::add", 10, 40, False),
              _ev("conic_run_kernel<false>", 20, 30, True), _ev("conic_run_kernel<false>", 25, 35, True),
              _ev("bin_xyzw_sum", 50, 60, True), _ev("Memcpy DtoH", 90, 100, True)]
    tr = profiling.read(SimpleNamespace(events=lambda: events), "bench:stretch")
    assert tr["window_s"] == pytest.approx(100e-6) and tr["busy_s"] == pytest.approx(35e-6)
    assert tr["launches"] == 3
    assert profiling.seconds_of(tr, "conic_run") == (2, pytest.approx(20e-6))
    idle = dict(tr["breakdown"]["idle_gaps"])
    assert idle["bench:stretch"] == pytest.approx(50e-6) and idle["aten::add"] == pytest.approx(15e-6)


# ----------------------------------------------------------------------
# no JAX

def _loaded_after(code: str) -> list:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_nothing_of_a_run_loads_jax():
    code = ("import sys, json, pathlib; sys.path.insert(0, '.')\n"
            "from benchmark import harness, reference, roofline, profiling, scene, calibrate\n"
            "import optrace_tpu_torch\n"
            "for p in pathlib.Path('benchmark').glob('*/*.json'): json.loads(p.read_text())\n"
            "for kind in ('entries', 'metrics'):\n"
            "    for p in sorted(pathlib.Path('benchmark', kind).glob('*.py')):\n"
            "        harness.load_module(kind, p.stem)\n")
    top = _loaded_after(code)
    assert not {"jax", "jaxlib", "flax", "optrace_tpu"} & set(top)
    assert "optrace_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after("import sys; sys.path.insert(0, '.')\nfrom benchmark import reference")
    assert not {"jax", "jaxlib", "flax", "optrace_tpu", "optrace_tpu_torch"} & set(top)
