"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both packages are driven with identical inputs: a scene is built with the
JAX package's public classes, its compiled step list is turned into a plain
numpy description (``spec_from_jax_steps``) from which the port builds its
own steps (``scene_compile.steps_from_numpy``), and ray bundles are made
with numpy from a seed. The port runs on the CPU here, where the kernel
wrappers take their plain PyTorch versions.
"""

import contextlib
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import optrace_tpu as ot
from optrace_tpu.tracer import trace_core as jtc

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc
from optrace_tpu_torch.tracer.scene_compile import steps_from_numpy

# one intra-op thread for the port's tests: pytest-xdist runs a worker for
# most cores, and a pool of a thread per core in every worker spins against
# the others (a case that takes 0.8 s alone took 55 s so). Every worker
# imports this module while it collects the tests.
torch.set_num_threads(1)

# tolerances of the JAX package's own kernel-vs-scan test
# (tests/test_pallas_run.py): positions rtol 5e-6 / atol 2e-5 mm, weights
# atol 1e-9 (+ rtol 2e-6 for the Fresnel products)
P_RTOL, P_ATOL = 5e-6, 2e-5
# free flight behind the last lens multiplies the f32 rounding of the
# direction (1.2e-7 per ulp, a few ulp between two operation orders) by the
# throw: 83 mm to the outline of the double Gauss, 74 mm to its detector.
# Positions at the end of such a throw get this absolute tolerance instead.
P_ATOL_THROW = 2e-4
W_RTOL, W_ATOL = 2e-6, 1e-9
# with polarization transport that test allows atol 1e-8 on the weights
# (1/N = 5e-5 a ray) and 1e-5 on the polarization vectors after 6 surfaces;
# the double Gauss has 14, so 2e-5 here: the s/p basis is
# the cross product of two nearly parallel directions
W_ATOL_POL, POL_ATOL = 1e-8, 2e-5
# XLA's CPU code may contract a*b+c to FMA where eager PyTorch does not: a
# ray within one rounding of an aperture edge or of the TIR limit can then
# fall on the other side. At most this many rays per 20 000 may differ in
# their hit/miss history; they are left out of the position comparison.
FLIP_BUDGET_PER_20K = 4


def medium_desc(ri):
    """RefractionIndex (JAX package) → constructor keywords for the port."""
    st = ri.spectrum_type
    if st == "Constant":
        return dict(n_type=st, n=float(ri.val))
    if st == "Abbe":
        return dict(n_type=st, n=float(ri.val), V=float(ri.V), lines=np.asarray(ri.lines))
    return dict(n_type=st, coeff=[float(c) for c in ri.coeff])


def spectrum_desc(sp):
    """TransmissionSpectrum (JAX package) → constructor keywords for the port."""
    st = sp.spectrum_type
    d = dict(spectrum_type=st, inverse=bool(sp.inverse))
    if st == "Constant":
        d.update(val=float(sp.val))
    elif st == "Rectangle":
        d.update(val=float(sp.val), wl0=float(sp.wl0), wl1=float(sp.wl1))
    elif st == "Gaussian":
        d.update(val=float(sp.val), mu=float(sp.mu), sig=float(sp.sig))
    elif st == "Data":
        d.update(wls=np.asarray(sp._wls), vals=np.asarray(sp._vals))
    else:
        raise ValueError(f"a '{st}' spectrum has no plain description")
    return d


def spec_from_jax_steps(steps):
    """The JAX package's TraceStep list as a plain numpy description."""
    spec, descs = [], {}

    def med(fn):
        if fn is None:
            return None
        if id(fn) not in descs:
            descs[id(fn)] = medium_desc(fn)
        return descs[id(fn)]

    for st in steps:
        spec.append(dict(kind=st.sfns.kind, action=st.action, pos_host=st.pos_host,
                         params={k: np.asarray(v) for k, v in st.sfns.params.items()},
                         n1=med(st.n1_fn), n2=med(st.n2_fn), D=float(st.D),
                         spectrum=spectrum_desc(st.spectrum_fn) if st.spectrum_fn is not None else None))
    return spec


def build_scene(with_flats=True):
    """The scene of tests/test_pallas_run.py:_build: spheres, a conic with
    k = −0.5 and (optionally) a flat back."""
    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -10, 80], no_pol=True)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="Lambertian",
                        div_angle=8, pos=[0, 0, -5],
                        spectrum=ot.presets.light_spectrum.d65))
    n1 = ot.presets.refraction_index.BK7
    n2 = ot.presets.refraction_index.F2
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=20), ot.SphericalSurface(r=3, R=-25),
                   n=n1, pos=[0, 0, 0], d=1.0))
    back = ot.CircularSurface(r=3) if with_flats else ot.SphericalSurface(r=3, R=-40)
    RT.add(ot.Lens(ot.ConicSurface(r=3, R=30, k=-0.5), back,
                   n=n2, pos=[0, 0, 5], d=0.8))
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=15), ot.SphericalSurface(r=3, R=-15),
                   n=n1, pos=[0, 0, 10], d=1.2))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


def double_gauss_scene():
    """The double Gauss behind the fused render's entry point."""
    from optrace_tpu.presets.geometry import double_gauss
    RT = ot.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], no_pol=True)
    RT.add(ot.RaySource(ot.Point(), divergence="Isotropic", orientation="Converging",
                        conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                        spectrum=ot.LightSpectrum("Constant")))
    RT.add(double_gauss())
    return RT


def _pols_for(s, rng):
    """Unit polarization vectors perpendicular to each direction."""
    ref = rng.normal(size=s.shape)
    q = np.cross(s, np.cross(ref, s))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def make_bundle(scene: str, N: int, seed: int = 0):
    """(p, s, pols, w, wl) f32 numpy rays aimed at the scene's first lens;
    a few percent miss it, so the miss bookkeeping is exercised."""
    rng = np.random.default_rng(seed)
    if scene == "double_gauss":
        p = np.tile(np.array([0.0, 0.0, -50000.0]), (N, 1))
        r = 40.0 * np.sqrt(rng.uniform(0, 1, N))
        th = rng.uniform(0, 2 * np.pi, N)
        target = np.stack([r * np.cos(th), r * np.sin(th), np.zeros(N)], axis=-1)
        s = target - p
    else:
        r = 2.4 * np.sqrt(rng.uniform(0, 1, N))
        th = rng.uniform(0, 2 * np.pi, N)
        p = np.stack([r * np.cos(th), r * np.sin(th), np.full(N, -5.0)], axis=-1)
        sin_t = np.sin(np.radians(9.0)) * np.sqrt(rng.uniform(0, 1, N))
        phi = rng.uniform(0, 2 * np.pi, N)
        s = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), np.sqrt(1 - sin_t ** 2)], axis=-1)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    wl = rng.uniform(400.0, 760.0, N)
    w = np.full(N, 1.0 / N)
    f32 = np.float32
    s = s.astype(f32)
    return p.astype(f32), s, _pols_for(s.astype(np.float64), rng), w.astype(f32), wl.astype(f32)


def jax_trace(RT, bundle, no_pol, kernel, store_sections=True, sinks=None):
    """The JAX package's trace_bundle on the bundle. ``kernel=True`` runs
    the Pallas run kernel in interpret mode, as tests/test_pallas_run.py
    does; ``False`` runs the scan."""
    steps = RT._build_steps()
    p, s, pols, w, wl = (jnp.asarray(a) for a in bundle)
    old_env = os.environ.get("OPTRACE_TPU_PALLAS_INTERPRET")
    old_flag = ot.global_options.pallas_trace
    try:
        if kernel:
            os.environ["OPTRACE_TPU_PALLAS_INTERPRET"] = "1"
        else:
            os.environ.pop("OPTRACE_TPU_PALLAS_INTERPRET", None)
        ot.global_options.pallas_trace = bool(kernel)

        @jax.jit
        def run(p, s, pols, w, wl):
            return jtc.trace_bundle(steps, RT.n0, tuple(float(v) for v in RT.outline),
                                    p, s, pols, w, wl, no_pol, False,
                                    sinks=sinks, store_sections=store_sections)
        out = run(p, s, pols, w, wl)
        return jax.tree_util.tree_map(np.asarray, out), steps
    finally:
        ot.global_options.pallas_trace = old_flag
        if old_env is None:
            os.environ.pop("OPTRACE_TPU_PALLAS_INTERPRET", None)
        else:
            os.environ["OPTRACE_TPU_PALLAS_INTERPRET"] = old_env


def torch_steps(jax_steps, dtype=torch.float32):
    return steps_from_numpy(spec_from_jax_steps(jax_steps), "cpu", dtype)


def torch_n0(RT):
    return otp.RefractionIndex(**{k: (list(np.asarray(v).tolist()) if isinstance(v, np.ndarray) else v)
                                  for k, v in medium_desc(RT.n0).items()})


def torch_trace(RT, jax_steps, bundle, no_pol, store_sections=True, sinks=None):
    """The port's trace_bundle on the same steps and bundle, on the CPU."""
    steps = torch_steps(jax_steps)
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
    with torch.no_grad():
        out = ttc.trace_bundle(steps, torch_n0(RT), tuple(float(v) for v in RT.outline),
                               p, s, pols, w, wl, no_pol,
                               sinks=sinks, store_sections=store_sections)
    return out, steps


def assert_sections_agree(out_j, out_t, N, no_pol=True):
    """Stored sections, n and INFOS of both packages agree within the stated
    tolerances and the counted flip budget. Returns the number of flips."""
    pj, wj = out_j["p"], out_j["w"]
    pt, wt = out_t["p"].numpy(), out_t["w"].numpy()
    assert pj.shape == pt.shape and wj.shape == wt.shape
    flipped = np.any((wj > 0) != (wt > 0), axis=1)
    n_flip = int(flipped.sum())
    budget = int(np.ceil(FLIP_BUDGET_PER_20K * N / 20000))
    assert n_flip <= budget, f"{n_flip} rays differ in hit/miss, budget {budget}"
    keep = ~flipped
    np.testing.assert_allclose(pt[keep, :-1], pj[keep, :-1], rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(pt[keep, -1], pj[keep, -1], rtol=P_RTOL, atol=P_ATOL_THROW)
    np.testing.assert_allclose(wt[keep], wj[keep], rtol=W_RTOL,
                               atol=W_ATOL if no_pol else W_ATOL_POL)
    np.testing.assert_allclose(out_t["n"].numpy(), out_j["n"], rtol=1e-6)
    d_infos = np.abs(out_t["infos"].numpy().astype(int) - out_j["infos"].astype(int)).sum()
    assert d_infos <= 2 * n_flip, f"INFOS differ by {d_infos} with {n_flip} flipped rays"
    return n_flip


# ----------------------------------------------------------------------
# scenes with function and data surfaces: their closures have no plain
# description, so each package builds the scene from its own classes (a
# user function takes jnp on one side and torch on the other) and the same
# bundle is injected into both traces

def sphere_sag(r2, R):
    """Sag of a sphere of radius R at squared radius r2 (host f64)."""
    rho = 1.0 / R
    return rho * r2 / (1.0 + np.sqrt(np.clip(1.0 - rho * rho * r2, 0.0, None)))


def data_sphere(pkg, r, R, n=201, astig=0.0):
    """A DataSurface2D of ``pkg`` sampled from a sphere (plus ``astig``·x·y)
    on an n × n grid over [−r, r]²."""
    xy = np.linspace(-r, r, n)
    X, Y = np.meshgrid(xy, xy)
    Z = sphere_sag(X ** 2 + Y ** 2, R) + astig * X * Y
    with pkg.global_options.no_warnings():
        return pkg.DataSurface2D(r=r, data=Z.T)


def generic_scene(name, pkg, lib, no_pol=True):
    """A scene with generic surfaces, built from the public classes of
    ``pkg`` (``optrace_tpu`` with ``lib = jnp`` or ``optrace_tpu_torch``
    with ``lib = torch``):

    - ``cosine_lens``: the lens of examples/cosine_surfaces.py, two
      FunctionSurface2D with crossed cosine modulation (its z bounds, as
      the example gives them, leave part of each face ill-conditioned);
    - ``data_lens``: a DataSurface2D front (sphere R = 20 with a saddle)
      and a spherical back;
    - ``function_lens``: the same front as a FunctionSurface2D without a
      derivative function (numeric normals) and the same back;
    - ``data_double_gauss``: the double Gauss with its first surface a
      DataSurface2D sampled from the same sphere; runs on both sides of the
      generic step.
    """
    kw = {"device": "cpu"} if pkg is otp else {}
    with pkg.global_options.no_warnings():
        if name == "data_double_gauss":
            from importlib import import_module
            geo = import_module(pkg.__name__ + ".presets.geometry")
            RT = pkg.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], no_pol=no_pol, **kw)
            RT.add(pkg.RaySource(pkg.Point(), divergence="Isotropic", orientation="Converging",
                                 conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                                 spectrum=pkg.LightSpectrum("Constant")))
            G = geo.double_gauss()
            L0 = G.lenses[0]
            L = pkg.Lens(data_sphere(pkg, 38.0, 78.36), pkg.SphericalSurface(r=38.0, R=469.5),
                         n=L0.n, pos=[0, 0, 0], d1=0, d2=9.8837)
            G.remove(L0)
            G.add(L)
            RT.add(G)
            return RT
        RT = pkg.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=no_pol, **kw)
        RT.add(pkg.RaySource(pkg.CircularSurface(r=2.5), divergence="None",
                             spectrum=pkg.LightSpectrum("Monochromatic", wl=550), pos=[0, 0, -5]))
        if name == "cosine_lens":
            front = pkg.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * lib.cos(4 * np.pi * x),
                                          z_min=-0.05, z_max=0.05)
            back = pkg.FunctionSurface2D(r=3, func=lambda x, y: 0.05 * lib.cos(4 * np.pi * y),
                                         z_min=-0.05, z_max=0.05)
            RT.add(pkg.Lens(front, back, n=pkg.presets.refraction_index.PMMA, pos=[0, 0, 0], d=0.5))
        else:
            if name == "data_lens":
                front = data_sphere(pkg, 3.0, 20.0, astig=0.004)
            else:
                front = pkg.FunctionSurface2D(
                    r=3, func=lambda x, y: (x * x + y * y) / (20.0 + lib.sqrt(400.0 - x * x - y * y))
                    + 0.004 * x * y)
            RT.add(pkg.Lens(front, pkg.SphericalSurface(r=3, R=-25), n=pkg.presets.refraction_index.BK7,
                            pos=[0, 0, 0], d=1.0))
        RT.add(pkg.Detector(pkg.RectangularSurface(dim=[8, 8]), pos=[0, 0, 40]))
    return RT


def torch_trace_scene(RT_t, bundle, no_pol, store_sections=True):
    """The port's trace_bundle over the port's own scene (its
    ``_build_steps``) on the bundle, on the CPU."""
    steps = RT_t._build_steps()
    p, s, pols, w, wl = (torch.from_numpy(np.array(a)) for a in bundle)
    with torch.no_grad():
        out = ttc.trace_bundle(steps, RT_t.n0, tuple(float(v) for v in RT_t.outline),
                               p, s, pols, w, wl, no_pol, store_sections=store_sections)
    return out, steps


def gui_scene(pkg, ray_outline=(-12, 12, -12, 12, -12, 80)):
    """The scene of tests/test_gui.py (``tracing_geometry``), built from the
    public classes of ``pkg``: two sources, a lens, an ideal lens, an
    aperture, a filter, a flat and a spherical detector, a marker and a
    volume. The port's raytracer lies on the CPU."""
    kw = {"device": "cpu"} if pkg is otp else {}
    RT = pkg.Raytracer(outline=list(ray_outline), **kw)
    RT.add(pkg.RaySource(pkg.CircularSurface(r=1), pos=[0, 0, -10], divergence="Lambertian",
                         div_angle=3, spectrum=pkg.presets.light_spectrum.d65))
    RT.add(pkg.RaySource(pkg.Point(), pos=[0, 1, -10], divergence="Isotropic",
                         div_angle=3, spectrum=pkg.presets.light_spectrum.FDC, power=0.5))
    n = pkg.presets.refraction_index.BK7
    RT.add(pkg.Lens(pkg.SphericalSurface(r=4, R=25), pkg.SphericalSurface(r=4, R=-25),
                    n=n, pos=[0, 0, 0], d=1.0))
    RT.add(pkg.IdealLens(r=4, D=10, pos=[0, 0, 6]))
    RT.add(pkg.Aperture(pkg.RingSurface(r=5, ri=2.5), pos=[0, 0, 10]))
    RT.add(pkg.Filter(pkg.CircularSurface(r=5), pos=[0, 0, 14],
                      spectrum=pkg.TransmissionSpectrum("Gaussian", mu=550, sig=80)))
    RT.add(pkg.Detector(pkg.RectangularSurface(dim=[10, 10]), pos=[0, 0, 40]))
    RT.add(pkg.Detector(pkg.SphericalSurface(r=5, R=-30), pos=[0, 0, 60]))
    RT.add(pkg.PointMarker("mark", pos=[0, 0, 20]))
    RT.add(pkg.BoxVolume(dim=[4, 4], length=5, pos=[0, 0, 30]))
    return RT


@contextlib.contextmanager
def cpu_default_device():
    """``device=None`` read as the CPU while the block runs, in every module
    of the port that bound ``utils/device.py:resolve_device`` (and so in
    ``make_generator``, the raytracer, the renders, the images, the mesh);
    a device that is named is resolved as before. Every module of the port
    is imported first, so that none binds the CPU rule for good by being
    imported inside the block. Undone after the block. The package itself
    has no switch for this: without a card, ``device=None`` raises."""
    import importlib
    import pkgutil
    import sys
    from optrace_tpu_torch.utils import device
    real = device.resolve_device

    def cpu_rule(dev=None):
        return torch.device("cpu") if dev is None else real(dev)
    for info in pkgutil.walk_packages(otp.__path__, "optrace_tpu_torch."):
        importlib.import_module(info.name)
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "optrace_tpu_torch" and getattr(mod, "resolve_device", None) is real:
                mp.setattr(mod, "resolve_device", cpu_rule)
        yield cpu_rule


@pytest.fixture
def cpu_as_default_device():
    """:func:`cpu_default_device` for one test."""
    with cpu_default_device() as rule:
        yield rule


@contextlib.contextmanager
def closing_new_figures():
    """Close every matplotlib figure that the block opened (the GUI's image
    actions open one each) and leave the others, such as a live GUI's
    scene, open."""
    import matplotlib.pyplot as plt
    before = set(plt.get_fignums())
    try:
        yield
    finally:
        for num in set(plt.get_fignums()) - before:
            plt.close(num)


def without_idle_draws(gui):
    """Make ``draw_idle`` of a GUI's scene canvas do nothing. Under Agg every
    ``draw_idle`` (a key press, a widget's change) is a whole draw of the 3D
    scene, about 1 s on the CPU; the GUI tests read state, and draw
    explicitly where pixels count (screenshots, clicks at projected points)."""
    gui.scene.fig.canvas.draw_idle = lambda *args, **kwargs: None
    return gui


# ----------------------------------------------------------------------
# the example scripts of examples_torch/

EXAMPLE_RAYS = 20000        # the ray cap of the examples in the tier-1 run


@contextlib.contextmanager
def recording_example():
    """``chip_smoke.py``'s recorders while the block runs: of kernel 1's
    wrapper in the trace, of kernel 2's in the images, renders and design
    renders (on the CPU each wrapper takes its plain version), and of the
    rays traced. Yields a dict that holds, once the block has ended, the
    calls of each wrapper ("conic_run", "bin_xyzw"), the rays ("rays") and
    the traces that traced them ("traces")."""
    import chip_smoke
    from optrace_tpu_torch.image import render_image
    from optrace_tpu_torch.parallel import render
    from optrace_tpu_torch.tracer import diff
    counts = {}
    with chip_smoke.RunRecorder() as run, chip_smoke.RayCounter() as rays, \
            chip_smoke.BinRecorder(render_image) as b_image, chip_smoke.BinRecorder(render) as b_render, \
            chip_smoke.BinRecorder(diff) as b_diff:
        yield counts
    counts.update(conic_run=len(run.calls), bin_xyzw=len(b_image.calls) + len(b_render.calls) + len(b_diff.calls),
                  rays=rays.rays, traces=rays.traces)


def run_example(name, where, rays=EXAMPLE_RAYS):
    """``main(device="cpu", rays=rays)`` of ``examples_torch/<name>.py``,
    then its ``plot`` where it has one, in the directory ``where`` with
    progress bars and warnings off. Closes the figures the plots opened.

    :return: (results, the sorted names of the files written, the calls of
        the kernels' wrappers, the rays and the traces in ``main``:
        :func:`recording_example`)"""
    import importlib
    import matplotlib
    matplotlib.use("Agg")
    mod = importlib.import_module(f"examples_torch.{name}")
    cwd = os.getcwd()
    os.chdir(where)
    try:
        with otp.global_options.no_progress_bar(), otp.global_options.no_warnings(), \
                closing_new_figures():
            with recording_example() as calls:
                results = mod.main(device="cpu", rays=rays)
            if hasattr(mod, "plot"):
                mod.plot(results)
    finally:
        os.chdir(cwd)
    written = sorted(f for f in os.listdir(where) if os.path.getsize(os.path.join(where, f)) > 0)
    return results, written, dict(calls)


@pytest.fixture(scope="module")
def ran_examples(tmp_path_factory):
    """Each example run once for the test module, by ``run_example`` in a
    directory of its own: name -> (results, files, kernel calls)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = run_example(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


def assert_kernels_as_the_smoke_expects(name, calls):
    """The example calls kernel 1's wrapper on the CPU exactly where its runs
    reach ``MIN_RUN`` (``chip_smoke.EXAMPLES_LONG_RUNS``, among the examples
    whose launches of kernel 1 the card's phase ``examples`` expects: there
    shorter runs take it too), and kernel 2's exactly where that phase
    expects launches of kernel 2."""
    import chip_smoke
    assert set(chip_smoke.EXAMPLES_LONG_RUNS) <= set(chip_smoke.EXAMPLES_KERNEL_1)
    assert (calls["conic_run"] > 0) == (name in chip_smoke.EXAMPLES_LONG_RUNS), (name, calls)
    assert (calls["bin_xyzw"] > 0) == (name not in chip_smoke.EXAMPLES_WITHOUT_KERNEL_2), (name, calls)
