"""The f32 error budget against the f64 oracle, on the port, and the f64
oracle against the JAX package's.

The scene of ``tests/test_accuracy.py:test_long_stack_error_budget``: five
dispersive lenses (BK7 and F2 in turns) over a 400 mm track, a Lambertian
disk source, 3000 rays. One f64 bundle is made with numpy from seed 0 and
traced through

- (a) the port's f32 steps (``Raytracer._build_steps()``; on the CPU the run
  of ten refractions takes kernel 1's plain version, which the kernel equals
  bit for bit on the card),
- (b) the port's f64 steps (``_build_steps(dtype=torch.float64)``), the
  oracle,
- (c) the JAX package's f64 steps under ``jax.enable_x64``.

(a) against (b) holds the JAX test's budget at the image plane: median
transverse error under 5e-4 mm, 99th percentile under 2e-3 mm, under 1 % of
the live rays disagreeing on whether they live. Measured on the CPU: median
9.7e-7 mm, 99th percentile 3.6e-6 mm, 0 disagreements on 1444 live rays.
(b) against (c) is the f64 parity: the same live rays in every section,
positions within 1e-8 mm and weights within 1e-12 (measured: 5.7e-14 mm and
8.1e-19).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optrace_tpu as ot
from optrace_tpu.tracer.trace_core import trace_bundle as jax_trace_bundle

import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer.trace_core import trace_bundle

N, SEED = 3000, 0
OUTLINE = (-20.0, 20.0, -20.0, 20.0, -10.0, 400.0)
P_ATOL_F64, W_ATOL_F64 = 1e-8, 1e-12


def long_stack(pkg, **kw):
    """``tests/test_accuracy.py:68``'s scene, built with ``pkg``."""
    RT = pkg.Raytracer(outline=list(OUTLINE), no_pol=True, **kw)
    RT.add(pkg.RaySource(pkg.CircularSurface(r=2), pos=[0, 0, 0],
                         divergence="Lambertian", div_angle=10,
                         spectrum=pkg.presets.light_spectrum.d65))
    glasses = [pkg.presets.refraction_index.BK7, pkg.presets.refraction_index.F2]
    z = 30.0
    for i in range(5):
        RT.add(pkg.Lens(pkg.SphericalSurface(r=8, R=60 + 10 * i),
                        pkg.SphericalSurface(r=8, R=-(70 + 10 * i)),
                        n=glasses[i % 2], de=1.0, pos=[0, 0, z]))
        z += 70.0
    RT.add(pkg.Detector(pkg.RectangularSurface(dim=[20, 20]), pos=[0, 0, 390]))
    return RT


def f64_bundle(seed=SEED):
    """The source's rays in f64, made with numpy: positions uniform on the
    disk of radius 2 at z = 0, Lambertian directions within 10° (sin²θ
    uniform), wavelengths uniform over [380, 780] nm, weights 1/N, no
    polarization. Returns (p, s, pols, w, wl)."""
    rng = np.random.default_rng(seed)
    r, phi = 2.0 * np.sqrt(rng.random(N)), 2 * np.pi * rng.random(N)
    p = np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros(N)], axis=1)
    sin_t = np.sqrt(rng.random(N)) * np.sin(np.radians(10.0))
    psi = 2 * np.pi * rng.random(N)
    s = np.stack([sin_t * np.cos(psi), sin_t * np.sin(psi), np.sqrt(1 - sin_t ** 2)], axis=1)
    wl = 380.0 + 400.0 * rng.random(N)
    return p, s, np.zeros((N, 3)), np.full(N, 1.0 / N), wl


def trace_three():
    """(p, w) of the three traces, (N, nt, 3) and (N, nt) in f64: the port
    in f32, the port in f64, the JAX package in f64."""
    bundle = f64_bundle()
    RT = long_stack(otp, device="cpu")
    out = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        args = [torch.as_tensor(a, dtype=dtype) for a in bundle]
        res = trace_bundle(RT._build_steps(dtype=dtype), RT.n0.on_device("cpu", dtype), OUTLINE, *args,
                           True, False, gen=otp.make_generator(1, "cpu"))
        out[name] = (res["p"].double().numpy(), res["w"].double().numpy())
    RTj = long_stack(ot)
    with jax.enable_x64():
        res = jax_trace_bundle(RTj._build_steps(np.float64), RTj.n0, OUTLINE,
                               *[jnp.asarray(a, jnp.float64) for a in bundle], True, False,
                               key=jax.random.PRNGKey(1))
        out["jax_f64"] = (np.asarray(res["p"], np.float64), np.asarray(res["w"], np.float64))
    return out


@pytest.fixture(scope="module")
def traced():
    return trace_three()


def test_f32_within_the_error_budget(traced):
    """The JAX test's budget (``_final_errors``): the transverse error at
    the last section that any ray reaches alive in both traces."""
    (p32, w32), (p64, w64) = traced["f32"], traced["f64"]
    alive = (w64 > 0) & (w32 > 0)
    last = max(j for j in range(p64.shape[1]) if alive[:, j].any())
    m = alive[:, last]
    d = p32[m, last] - p64[m, last]
    dxy = np.hypot(d[:, 0], d[:, 1])
    disagree = int(((w64[:, last] > 0) != (w32[:, last] > 0)).sum())
    n_alive = int(m.sum())
    assert n_alive > 500
    assert np.median(dxy) < 5e-4
    assert np.percentile(dxy, 99) < 2e-3
    assert disagree < 0.01 * n_alive


def test_f64_oracle_equals_the_jax_f64_trace(traced):
    (pt, wt), (pj, wj) = traced["f64"], traced["jax_f64"]
    assert pt.shape == pj.shape and wt.shape == wj.shape
    live = wt > 0
    assert np.array_equal(live, wj > 0)
    assert live[:, -2].sum() > 500
    np.testing.assert_allclose(wt, wj, rtol=0, atol=W_ATOL_F64)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=P_ATOL_F64)
