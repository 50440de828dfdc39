"""The stored trace's sections written in place: ``trace_bundle`` without a
derivative fills one (N, nt, 3) / (N, nt) buffer per kind, stored section by
section, section 0 and every unrolled step by a copy into its column and
every run through ``SectionSlots`` (on the CPU ``conic_run_reference(out=...)``,
on the card kernel 1 itself).

The stacked form is the route that a derivative takes (the per-section
tensors kept and stacked at the end): :func:`stacked` forces it, and the
in-place sections must equal it bit for bit. The slice as a whole is held
against the JAX package's ``trace_bundle`` at the tolerances of
tests/test_torch_common.py (those of tests/test_pallas_run.py).
"""

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import cuda_run
from optrace_tpu_torch.ops.cuda_run import SectionSlots, conic_run, conic_run_reference, section_buffer
from optrace_tpu_torch.tracer import trace_core as ttc
from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss
from optrace_tpu_torch.presets.geometry import double_gauss

from tests.test_torch_common import (build_scene, double_gauss_scene, make_bundle, jax_trace,
                                     torch_steps, torch_n0, assert_sections_agree, POL_ATOL)

N = 3000
KEYS = ("p", "w", "pol", "n", "infos")


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


class StackedSections(ttc._Sections):
    """The stacked form: every section a tensor of its own, stacked at the
    end, as a trace stores them from where a derivative flows on."""

    def __init__(self, *args):
        super().__init__(*args)
        self.to_lists()


def stacked(monkeypatch, fn):
    """``fn()`` with ``trace_bundle`` storing the stacked form."""
    with monkeypatch.context() as m:
        m.setattr(ttc, "_Sections", StackedSections)
        return fn()


def spy_routes(monkeypatch):
    """A list that records, for every bundle traced from now on, whether
    its sections stayed in place to the end."""
    seen = []
    real = ttc._Sections.result

    def spy(self):
        seen.append(self.in_place)
        return real(self)
    monkeypatch.setattr(ttc._Sections, "result", spy)
    return seen


def _routes(monkeypatch, fn):
    """(in place, stacked) outputs of ``fn()``, each route really taken."""
    seen = spy_routes(monkeypatch)
    a = fn()
    b = stacked(monkeypatch, fn)
    assert seen == [True, False], seen
    return a, b


def _jax_scene(name, no_pol):
    if name == "double_gauss":
        RT = double_gauss_scene()
    elif name == "filter_first":
        # a filter before the lenses: the first step is unrolled, and the
        # run of 6 ends at the last surface before the end absorber
        RT = build_scene()
        RT.add(ot.Filter(ot.CircularSurface(r=2.5), pos=[0, 0, -2],
                         spectrum=ot.TransmissionSpectrum("Gaussian", mu=560.0, sig=80.0, val=0.8)))
    else:
        RT = build_scene()
    RT.no_pol = no_pol
    return RT


def _trace(RT, steps, bundle, no_pol, dtype=torch.float32):
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)).to(dtype) for a in bundle)
    with torch.no_grad():
        return ttc.trace_bundle(steps, torch_n0(RT), tuple(float(v) for v in RT.outline),
                                p, s, pols, w, wl, no_pol)


@pytest.mark.parametrize("scene,no_pol,dtype", [
    ("double_gauss", True, torch.float32),
    ("double_gauss", False, torch.float32),
    ("filter_first", False, torch.float32),
    ("double_gauss", False, torch.float64),
    ("filter_first", True, torch.float64),
])
def test_in_place_sections_equal_the_stacked_form(monkeypatch, scene, no_pol, dtype):
    RT = _jax_scene(scene, no_pol)
    jsteps = RT._build_steps()
    steps = torch_steps(jsteps, dtype)
    kinds = [k for k, _ in ttc._partition_runs(steps, [])]
    if scene == "filter_first":
        assert kinds == ["step", "run", "step"] and jsteps[0].action == "filter"
    bundle = make_bundle("double_gauss" if scene == "double_gauss" else "build", N, seed=5)
    a, b = _routes(monkeypatch, lambda: _trace(RT, steps, bundle, no_pol, dtype))
    for k in KEYS:
        assert _same_bits(a[k], b[k]), k
    nt = len(steps) + 1
    assert a["p"].shape == (N, nt, 3) and a["p"].dtype == dtype
    assert all(a[k] is None or a[k].transpose(0, 1).is_contiguous() for k in ("p", "w", "pol", "n"))
    assert (a["pol"] is None) == no_pol
    assert (a["w"][:, -2] > 0).float().mean() > 0.5


def test_steps_scene_with_hurb_and_an_image_source(monkeypatch):
    """Image source, filter, HURB at the double Gauss's ring aperture (an
    unrolled step between the runs of 6 and 8) and an ideal lens, through
    the port's own ``Raytracer`` on the CPU, with the generator seeded alike
    for both routes."""
    RT = otp.Raytracer(outline=[-150, 150, -150, 150, -60, 250], no_pol=False, use_hurb=True, device="cpu")
    RT.add(otp.RaySource(otp.presets.image.color_checker([30, 20]), divergence="Isotropic",
                         orientation="Converging", conv_pos=[0, 0, 0], div_angle=1.0, pos=[0, 0, -50]))
    RT.add(otp.Filter(otp.CircularSurface(r=45), pos=[0, 0, -20],
                      spectrum=otp.TransmissionSpectrum("Gaussian", mu=550.0, sig=60.0, val=0.9)))
    G = double_gauss(with_detector=False)
    RT.add(G)
    z_last = max(L.back.pos[2] for L in G.lenses)
    RT.add(otp.IdealLens(r=35, D=2.0, pos=[0, 0, z_last + 3.0]))
    RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
    steps, source = RT._build_steps(), RT._make_source_fn(N)
    assert [k for k, _ in ttc._partition_runs(steps, [], True)] == ["step", "run", "step", "run", "step",
                                                                    "step"]

    def run():
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            p, s, pols, w, wl = source(gen)
            return ttc.trace_bundle(steps, RT.n0, tuple(float(v) for v in RT.outline), p, s, pols, w, wl,
                                    False, True, gen=gen)
    a, b = _routes(monkeypatch, run)
    for k in KEYS:
        assert _same_bits(a[k], b[k]), k
    assert int(a["infos"][ttc.HURB_NEG_DIR].sum()) >= 0 and (a["w"][:, -2] > 0).any()


def _run_call(nt=9, col0=3, L=4, with_pol=True, seed=0, dtype=torch.float32):
    """Rays, media and the constants of a run of ``L`` steps: spheres with an
    absorbing ring in the middle whose (ambient) media row differs from the
    row n₂ of the step before it."""
    rng = np.random.default_rng(seed)
    n = 400
    r, th = 2.5 * np.sqrt(rng.uniform(0, 1, n)), rng.uniform(0, 2 * np.pi, n)
    p = torch.from_numpy(np.stack([r * np.cos(th), r * np.sin(th), np.full(n, -2.0)], -1)).to(dtype)
    s = torch.zeros((n, 3), dtype=dtype)
    s[:, 2] = 1.0
    w = torch.full((n,), 1.0 / n, dtype=dtype)
    w[::7] = 0.0                                        # dead rays keep their n column too
    pol = torch.zeros((n, 3), dtype=dtype)
    pol[:, 0] = 1.0
    n_tab = torch.stack([torch.full((n,), v, dtype=dtype) for v in (1.0, 1.5, 1.7, 1.33)])

    def sphere(z, rho):
        edge = rho * 9.0 / (1.0 + np.sqrt(1.0 - 9.0 * rho * rho))       # the sag at r = 3
        return dict(kind="conic", is_flat=False, rho=rho, k=0.0, r=3.0, z_min=min(0.0, edge),
                    z_max=max(0.0, edge), dx=0.0, dy=0.0, dz=z, ox=0.0, oy=0.0, oz=0.0,
                    out=(-10, 10, -10, 10, -10, 80))
    ring = dict(kind="ring", is_flat=True, action="absorb", mask="ring", rho=0.0, k=0.0, r=3.0, ri=0.8,
                z_min=0.0, z_max=0.0, dx=0.0, dy=0.0, dz=1.0, ox=0.0, oy=0.0, oz=0.0,
                out=(-10, 10, -10, 10, -10, 80))
    steps = [sphere(2.0, 0.05), sphere(1.0, -0.04), ring, sphere(1.0, 0.03)][:L]
    # the ring's pair names row 3, which the step before it (n₂ = row 0) never read
    med_idx = [(0, 1), (1, 0), (3, 3), (0, 2)][:L]
    def nan(*tail):
        return section_buffer(n, nt, *tail, dtype=dtype, device="cpu").fill_(float("nan"))
    slots = SectionSlots(nan(3), nan(), nan(), nan(3) if with_pol else None, col0)
    return (p, s, w, n_tab, med_idx, steps), dict(pol=pol if with_pol else None), slots


@pytest.mark.parametrize("with_pol,dtype", [(True, torch.float32), (False, torch.float32),
                                            (True, torch.float64)])
def test_reference_writes_its_columns_and_no_other(with_pol, dtype):
    """``conic_run_reference(out=...)`` puts the (L, N, ...) result's steps
    into columns col0 … col0 + L − 1 bit for bit, with n₂ of each step (the
    ambient row at the absorbing ring, also for dead rays), and leaves
    every other column as it was (NaN)."""
    args, kw, slots = _run_call(with_pol=with_pol, dtype=dtype)
    L, c0 = len(args[5]), slots.col0
    state_a, (counts_a, *ys) = conic_run_reference(*args, **kw)
    state_b, (counts_b, *none) = conic_run_reference(*args, **kw, out=slots)
    assert none == [None, None, None]
    assert all(_same_bits(x, y) for x, y in zip(state_a, state_b)) and torch.equal(counts_a, counts_b)
    ys_p, ys_w, ys_pol = ys
    cols = slice(c0, c0 + L)
    assert _same_bits(slots.p[:, cols], ys_p.transpose(0, 1))
    assert _same_bits(slots.w[:, cols], ys_w.transpose(0, 1))
    n_rows = args[3][[r2 for _, r2 in args[4]]]
    assert _same_bits(slots.n[:, cols], n_rows.transpose(0, 1))
    assert torch.equal(slots.n[:, c0 + 2], torch.full_like(slots.n[:, 0], 1.33))     # the ring's ambient
    assert int(counts_a[2, 0]) == 0 and int((ys_w[2] == 0).sum()) > int((ys_w[1] == 0).sum())
    if with_pol:
        assert _same_bits(slots.pol[:, cols], ys_pol.transpose(0, 1))
    outside = [k for k in range(slots.nt) if not c0 <= k < c0 + L]
    for t in (slots.p, slots.w, slots.n) + ((slots.pol,) if with_pol else ()):
        assert torch.isnan(t[:, outside]).all()
        assert not torch.isnan(t[:, cols]).any()


def _bad_slots(slots, what):
    p, w, n, pol, col0 = slots
    return {
        "shape": lambda: slots._replace(w=torch.zeros((p.shape[0], p.shape[1] + 1))),
        "dtype": lambda: slots._replace(n=n.double()),
        "col0_negative": lambda: slots._replace(col0=-1),
        "col0_past_the_end": lambda: slots._replace(col0=p.shape[1] - 3),
        "non_contiguous": lambda: slots._replace(p=torch.zeros((p.shape[1], p.shape[0], 4))[..., :3].transpose(0, 1)),
        "ray_major": lambda: slots._replace(w=torch.zeros(w.shape)),
        "pol_missing": lambda: slots._replace(pol=None),
        "pol_shape": lambda: slots._replace(pol=torch.zeros((p.shape[0], p.shape[1], 4))),
        "rays": lambda: slots._replace(w=w[1:]),
        "not_slots": lambda: tuple(slots),
    }[what]()


@pytest.mark.parametrize("what", ["shape", "dtype", "col0_negative", "col0_past_the_end", "non_contiguous",
                                  "ray_major", "pol_missing", "pol_shape", "rays", "not_slots"])
def test_wrapper_checks_the_slots(what):
    """The wrapper refuses slots that the run cannot fill, before it runs,
    with a ValueError (a buffer not stored section by section too, whose
    run's columns the kernel's (L, N) rows are not); a run without
    polarization takes no pol buffer, and ``out`` needs stored sections."""
    args, kw, slots = _run_call()
    before = cuda_run.conic_run.launches
    with pytest.raises(ValueError):
        conic_run(*args, **kw, out=_bad_slots(slots, what))
    assert torch.isnan(slots.p).all() and conic_run.launches == before
    with pytest.raises(ValueError, match="None"):
        conic_run(*args, out=slots)                     # slots with pol, run without
    with pytest.raises(ValueError, match="store"):
        conic_run(*args, **kw, store=False, out=slots)


def test_spot_loss_gradient_is_the_stacked_routes(monkeypatch):
    """A design step's gradient (its runs carry a derivative, so its
    sections are stacked from the first run on) equals bit for bit the
    gradient through the stacked form from section 0 on, and its loss the
    loss-only evaluation's, whose sections stay in place."""
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550)))
    n = otp.RefractionIndex("Constant", n=1.5)
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20), n=n, pos=[0, 0, 0], d=1.0))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=60), otp.SphericalSurface(r=3, R=80), n=n, pos=[0, 0, 4], d=1.0))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 19]))
    ext = [-2.0, 2.0, -2.0, 2.0]
    render, params0 = make_parameterized_render(RT, 2048, extent=ext, Nx=63, Ny=63)
    loss = spot_loss(render)

    def grad():
        params = [dict(p) for p in params0]
        rho = params[0]["rho"].detach().clone().requires_grad_()
        params[0] = dict(params[0], rho=rho)
        value = loss(params, 4, ext)
        value.backward()
        return value.detach(), rho.grad
    seen = spy_routes(monkeypatch)
    value, g = grad()
    with torch.no_grad():
        value_only = loss(params0, 4, ext)
    value_s, g_s = stacked(monkeypatch, grad)
    assert seen == [False, True, False], seen
    assert _same_bits(value, value_s) and _same_bits(g, g_s) and float(g) != 0.0
    assert _same_bits(value, value_only)


def test_a_derivative_through_a_medium_stacks_from_there_on(monkeypatch):
    """A derivative that enters through a medium function (a closure, which
    no parameter shows) reaches the sections: they are stacked from the
    first run on, and the gradient arrives."""
    RT = _jax_scene("filter_first", True)
    steps = torch_steps(RT._build_steps())
    dn = torch.zeros((), requires_grad=True)

    def shifted(fn):
        return None if fn is None else (lambda wl_: fn(wl_) + dn)
    steps_m = [st._replace(n1_fn=shifted(st.n1_fn), n2_fn=shifted(st.n2_fn)) for st in steps]
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in make_bundle("build", 500, seed=2))
    seen = spy_routes(monkeypatch)
    out = ttc.trace_bundle(steps_m, torch_n0(RT), tuple(float(v) for v in RT.outline), p, s, pols, w, wl, True)
    assert seen == [False] and out["p"].requires_grad
    (out["p"][:, -1, 0] ** 2 * out["w"][:, -2]).sum().backward()
    assert torch.isfinite(dn.grad) and float(dn.grad) != 0.0
    ref = _trace(RT, steps, make_bundle("build", 500, seed=2), True)
    for k in ("p", "w", "n"):
        assert _same_bits(out[k].detach(), ref[k]), k


@pytest.mark.parametrize("no_pol", [True, False])
def test_host_arrays_are_in_c_order(no_pol):
    """A stored trace keeps its sections as ``trace_bundle`` stores them,
    section by section; the public arrays made from them at the first read
    are in C order all the same, with the same values."""
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=no_pol, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="Lambertian", div_angle=2))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                    n=otp.RefractionIndex("Constant", n=1.5), pos=[0, 0, 0], d=1.0))
    RT.trace(500)
    dev = RT.rays._dev
    for key, name in (("p", "p_list"), ("w", "w_list"), ("n", "n_list"), ("pol", "pol_list")):
        a = getattr(RT.rays, name)
        if dev[key] is None:            # no polarization traced: a NaN broadcast, as before
            assert no_pol and np.isnan(a).all()
            continue
        assert a.flags.c_contiguous, name
        assert dev[key].transpose(0, 1).is_contiguous(), key
        assert np.array_equal(a, dev[key].numpy().astype(a.dtype)), name
    assert RT.rays.rays_by_mask(np.arange(500) % 7 == 0)[0].flags.c_contiguous


@pytest.mark.parametrize("no_pol,kernel", [(True, True), (False, True)])
def test_the_slice_against_the_jax_package(no_pol, kernel):
    """The in-place sections of a scene whose first step is unrolled (a
    filter) and whose run ends at the last surface, ray by ray against the
    JAX package's trace (its Pallas run kernel in interpret mode, or its
    scan) at the stated tolerances, at the ray count that they are stated
    for; INFOS agree."""
    n = 20000
    RT = _jax_scene("filter_first", no_pol)
    bundle = make_bundle("build", n, seed=9)
    out_j, jsteps = jax_trace(RT, bundle, no_pol, kernel=kernel)
    out_t = _trace(RT, torch_steps(jsteps), bundle, no_pol)
    flips = assert_sections_agree(out_j, out_t, n, no_pol=no_pol)
    if not no_pol:
        keep = ~np.any((out_j["w"] > 0) != (out_t["w"].numpy() > 0), axis=1)
        np.testing.assert_allclose(out_t["pol"].numpy()[keep], out_j["pol"][keep], atol=POL_ATOL)
    if flips == 0:
        assert np.array_equal(out_t["infos"].numpy(), out_j["infos"])
    assert (out_t["w"][:, 1] < out_t["w"][:, 0]).any()          # the filter took power
