"""The port's slice as a whole, ray by ray: ``trace_bundle`` of both
packages on one injected bundle (stored sections, n, INFOS), and the
detector sink with ``store_sections=False`` through both ``_detector_sink``s.

The JAX side runs its Pallas run kernel in interpret mode or its scan; the
port runs on the CPU (plain versions). Tolerances and the flip budget are
stated in tests/test_torch_common.py.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from optrace_tpu.parallel import render as jrender
from optrace_tpu.tracer.detector import init_hit_carry as j_init_hit_carry

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops.cuda_run import conic_run, PreparedRun
from optrace_tpu_torch.parallel import render as trender
from optrace_tpu_torch.presets import geometry as tgeo
from optrace_tpu_torch.tracer import trace_core as ttc
from optrace_tpu_torch.tracer.detector import init_hit_carry as t_init_hit_carry
from optrace_tpu_torch.tracer.trace_core import _partition_runs
from optrace_tpu_torch.utils import tracing

from tests.test_torch_common import (build_scene, double_gauss_scene, make_bundle, jax_trace,
                                     torch_trace, torch_steps, assert_sections_agree,
                                     FLIP_BUDGET_PER_20K, P_RTOL, P_ATOL_THROW, W_RTOL, W_ATOL,
                                     W_ATOL_POL, POL_ATOL)

N = 20000
SCENES = {"double_gauss": double_gauss_scene, "build": build_scene}


@pytest.mark.parametrize("scene,no_pol,kernel", [
    ("double_gauss", True, True),
    ("double_gauss", False, False),
    ("build", False, True),
    ("build", True, False),
])
def test_stored_sections_match(scene, no_pol, kernel):
    RT = SCENES[scene]()
    bundle = make_bundle(scene, N, seed=3)
    out_j, jsteps = jax_trace(RT, bundle, no_pol, kernel)
    out_t, _ = torch_trace(RT, jsteps, bundle, no_pol)
    assert_sections_agree(out_j, out_t, N, no_pol)
    if no_pol:
        assert out_t["pol"] is None and out_j["pol"] is None
    else:
        polj, polt = out_j["pol"], out_t["pol"].numpy()
        keep = ~np.any((out_j["w"] > 0) != (out_t["w"].numpy() > 0), axis=1)
        np.testing.assert_allclose(polt[keep], polj[keep], atol=POL_ATOL)
    # the trace really did something: most rays reach the last lens
    assert (out_t["w"][:, -2] > 0).float().mean() > 0.5


def test_partition_of_the_double_gauss():
    """The ring aperture splits the 14 refractions into runs of 6 and 8."""
    RT = double_gauss_scene()
    steps = torch_steps(RT._build_steps())
    runs = _partition_runs(steps, [])
    assert [(k, len(i)) for k, i in runs] == [("run", 6), ("step", 1), ("run", 8), ("step", 1)]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: all that the partition's
    rule reads of where the state lies."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("cuda_trace", [True, False], ids=["cuda_trace", "cuda_trace_off"])
@pytest.mark.parametrize("derivative", ["none", "rays", "surface", "tangent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_short_runs_where_the_kernel_takes_them(device, dtype, derivative, cuda_trace):
    """The Arizona eye's conics come in pairs around the pupil. Where the
    kernel takes the runs (f32 on a CUDA device, ``cuda_trace`` on, no
    derivative), each pair is a run; absorbers at a run's edges are still
    trimmed and a step that a sink consumes still unrolled. Everywhere else
    the partition is the JAX package's: both pairs under ``MIN_RUN``."""
    RT = otp.Raytracer(outline=[-12, 12, -12, 12, -12, 30], no_pol=True, device="cpu")
    RT.add(tgeo.arizona_eye())
    steps = RT._build_steps()
    n = 8

    def state(*shape, fill=0.0):
        t = torch.full(shape, fill, dtype=dtype)
        return t.as_subclass(_OnCard) if device == "cuda" else t
    p, s, w, wl = state(n, 3), state(n, 3), state(n, fill=1.0), state(n, fill=555.0)
    if derivative == "rays":
        p.requires_grad_()
    elif derivative == "surface":
        steps[3].sfns.params["rho"].requires_grad_()
    kernel = device == "cuda" and dtype == torch.float32 and derivative == "none" and cuda_trace
    otp.global_options.cuda_trace = cuda_trace
    try:
        with fwAD.dual_level():
            if derivative == "tangent":
                s = fwAD.make_dual(s, torch.ones_like(s))
            min_run = ttc._shortest_run(steps, p, s, w, None, wl, True)
    finally:
        otp.global_options.cuda_trace = True
    assert min_run == (1 if kernel else ttc.MIN_RUN)
    part = _partition_runs(steps, [], min_run=min_run)
    if not kernel:
        assert part == _partition_runs(steps, []) == [("step", [i]) for i in range(6)]
        return
    assert part == [("run", [0, 1]), ("step", [2]), ("run", [3, 4]), ("step", [5])]
    otp.global_options.cuda_fuse_planar = True
    try:
        # the pupil joins the runs; the end absorber is trimmed off the run's edge
        assert _partition_runs(steps, [], min_run=1) == [("run", [0, 1, 2, 3, 4]), ("step", [5])]
        # a sink on the cornea's back: its step unrolled, the pupil trimmed off the next run
        sink = [False, True, False, False, False, False]
        assert _partition_runs(steps, [sink], min_run=1) == [
            ("run", [0]), ("step", [1]), ("step", [2]), ("run", [3, 4]), ("step", [5])]
    finally:
        otp.global_options.cuda_fuse_planar = False


def test_kernel1_counts_its_refractions():
    """``conic_run.refractions`` adds a launch's refraction steps, the
    absorbers inside it left out; both counters of the kernel's share are
    registered, so a replayed graph adds what its capture counted."""
    RT = otp.Raytracer(outline=[-12, 12, -12, 12, -12, 30], no_pol=True, device="cpu")
    RT.add(tgeo.arizona_eye())
    steps = RT._build_steps()
    chain = ttc._frame_chain(steps, np.float32)
    consts = ttc._run_steps(steps, [0, 1, 2, 3, 4], chain, np.asarray(RT.outline, dtype=np.float64))
    assert PreparedRun(consts, [(0, 1), (1, 2), (2, 2), (2, 3), (3, 0)]).refractions == 4
    assert PreparedRun(consts[:1], [(0, 1)]).refractions == 1
    registered = tracing.counts()
    assert (conic_run, "refractions") in registered
    assert (ttc.trace_bundle, "unrolled_refractions") in registered


class _FakeRT:
    """What ``_detector_sink`` reads of a raytracer: its detectors, its
    section bounds, and through them the port's detector target and extent."""
    detector_target = otp.Raytracer.detector_target
    detector_extent = otp.Raytracer.detector_extent

    def __init__(self, detectors, bounds):
        self.detectors = detectors
        self._bounds = bounds

    def _section_z_bounds(self):
        return self._bounds


@pytest.mark.parametrize("scene,no_pol,kernel,extent", [
    ("double_gauss", True, True, (-2.0, 2.0, -2.0, 2.0)),
    ("build", False, False, (-3.0, 3.0, -3.0, 3.0)),
])
def test_detector_sink_images_match(scene, no_pol, kernel, extent):
    """Sink mode: no stored sections, the detector crossing is consumed
    while the trace runs, then binned.

    Ray by ray, the hit positions, weights and hit flags of both sinks
    agree. A ray that lies within the position tolerance of a pixel edge
    may fall into either pixel, so the images are compared twice: with
    those edge rays taken out of both, pixel by pixel to atol 1e-5 of the
    total power; and in full, where the summed difference is bounded by
    the edge rays' weight."""
    RT = SCENES[scene]()
    Nx = Ny = 64
    bundle = make_bundle(scene, N, seed=5)

    jsink, jfin, _, jmask = jrender._detector_sink(RT, 0, None, extent, Nx, Ny)
    out_j, jsteps = jax_trace(RT, bundle, no_pol, kernel, store_sections=False,
                              sinks=[(jsink, j_init_hit_carry(N), jmask)])
    cj = out_j["sinks"][0]

    dsurf = RT.detectors[0].surface
    det = otp.Detector(otp.RectangularSurface(dim=[float(v) for v in dsurf.dim]),
                       pos=[float(v) for v in dsurf.pos])
    fake = _FakeRT([det], RT._section_z_bounds())
    tsink, tfin, _, tmask = trender._detector_sink(fake, 0, None, extent, Nx, Ny, "cpu")
    assert tmask == jmask
    out_t, _ = torch_trace(RT, jsteps, bundle, no_pol, store_sections=False,
                           sinks=[(tsink, t_init_hit_carry(N, "cpu"), tmask)])
    assert "p" not in out_t
    ct = out_t["sinks"][0]

    # ray by ray
    budget = int(np.ceil(FLIP_BUDGET_PER_20K * N / 20000))
    hit_j = cj[2] & cj[3]
    hit_t = (ct[2] & ct[3]).numpy()
    flipped = hit_j != hit_t
    assert flipped.sum() <= budget
    both = hit_j & hit_t
    assert both.mean() > 0.5
    np.testing.assert_allclose(ct[0].numpy()[both], cj[0][both], rtol=P_RTOL, atol=P_ATOL_THROW)
    np.testing.assert_allclose(ct[1].numpy()[both], cj[1][both], rtol=W_RTOL,
                               atol=W_ATOL if no_pol else W_ATOL_POL)
    d_infos = np.abs(out_t["infos"].numpy().astype(int) - out_j["infos"].astype(int)).sum()
    assert d_infos <= 2 * budget

    # images
    img_j = np.asarray(jfin(cj, out_j["wl"]))
    img_t = tfin(ct, out_t["wl"]).numpy()
    power = float(img_j[..., 3].sum())
    assert power > 0.05 and img_t.shape == (Ny, Nx, 4)
    assert img_t[..., 3].sum() == pytest.approx(power, rel=1e-5, abs=2 * budget / N)

    def edge_dist(x, lo, hi, n):
        g = (x - lo) / (hi - lo) * n
        return np.abs(g - np.round(g)) * (hi - lo) / n

    ph = cj[0]
    edge = ((edge_dist(ph[:, 0], extent[0], extent[1], Nx) < 2 * P_ATOL_THROW)
            | (edge_dist(ph[:, 1], extent[2], extent[3], Ny) < 2 * P_ATOL_THROW)) & hit_j
    edge = edge | flipped
    assert edge.mean() < 0.15
    w_edge = float(np.maximum(cj[1], ct[1].numpy())[edge].sum())
    assert np.abs(img_t[..., 3] - img_j[..., 3]).sum() <= 2 * w_edge + 1e-5 * power

    cj_in = (cj[0], np.where(edge, 0.0, cj[1]).astype(np.float32), cj[2], cj[3], cj[4])
    ct_in = (ct[0], torch.where(torch.from_numpy(edge), 0.0, ct[1]), ct[2], ct[3], ct[4])
    img_j_in = np.asarray(jfin(cj_in, out_j["wl"]))
    img_t_in = tfin(ct_in, out_t["wl"]).numpy()
    np.testing.assert_allclose(img_t_in, img_j_in, atol=1e-5 * power)
