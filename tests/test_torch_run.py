"""The run kernel's plain version (``conic_run_reference`` and its
``_one_step``) against the JAX package's Pallas run kernel in interpret mode
and against that kernel's pure-jnp step body on adversarial bundles.

Tolerances as in tests/test_torch_common.py; the single-step comparisons
use the JAX unit test's own (tests/test_pallas_run_unit.py: rtol 1e-6,
atol 1e-6) and demand equal counters.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from optrace_tpu.ops.pallas_run import conic_run_pallas, _one_step as j_one_step
from optrace_tpu.tracer import trace_core as jtc

from optrace_tpu_torch.ops import cuda_run
from optrace_tpu_torch.ops.cuda_run import conic_run, conic_run_reference, _one_step, _step_table
from optrace_tpu_torch.tracer import trace_core as ttc

from tests.test_torch_common import (build_scene, make_bundle, torch_steps, FLIP_BUDGET_PER_20K,
                                     P_RTOL, P_ATOL, W_RTOL, W_ATOL, W_ATOL_POL, POL_ATOL)

N = 20000


def _jax_consts(steps, idxs, chain, outline64):
    """The constant tuple that trace_core._conic_run_pallas_dispatch builds."""
    consts = []
    for i in idxs:
        pr = steps[i].sfns.params
        _, delta, origin = chain[i]

        def f(v, default=0.0):
            return float(np.asarray(v if v is not None else default).reshape(-1)[0])
        consts.append(tuple(sorted(dict(
            rho=f(pr.get("rho"), 1.0), k=f(pr.get("k"), 0.0), r=f(pr.get("r"), 1.0),
            z_min=f(pr.get("z_min_rel")), z_max=f(pr.get("z_max_rel")),
            is_flat=bool(steps[i].sfns.is_flat), is_asph=False, coeff=(), is_tilt=False,
            tn=(0.0, 0.0, 1.0), action="refract", mask="circle", ri=0.0, hw=1.0, hh=1.0,
            hwi=0.0, hhi=0.0, angle=0.0,
            dx=float(delta[0]), dy=float(delta[1]), dz=float(delta[2]),
            ox=float(origin[0]), oy=float(origin[1]), oz=float(origin[2]),
            out=tuple(float(outline64[q] - origin[q // 2]) for q in range(6))).items())))
    return tuple(consts)


@pytest.mark.parametrize("with_pol", [False, True], ids=["nopol", "pol"])
@pytest.mark.parametrize("store", [True, False], ids=["store", "nostore"])
def test_reference_matches_pallas_interpret(with_pol, store):
    """One 6-step run (spheres, a conic with k = −0.5, a flat back) through
    ``conic_run_pallas(interpret=True)`` and through the port's plain
    version: state, counts and sections."""
    RT = build_scene()
    jsteps = RT._build_steps()
    idxs = list(range(6))
    outline64 = np.asarray(RT.outline, dtype=np.float64)
    p, s, pols, w, wl = make_bundle("build", N, seed=9)

    jchain = jtc._frame_chain(jsteps, np.float32)
    media, pairs = jtc._media_rows(jsteps, idxs)
    n_tab_j = jnp.stack([m(jnp.asarray(wl)) for m in media])
    med = jnp.stack([jnp.stack([n_tab_j[pairs[i][0]], n_tab_j[pairs[i][1]]]) for i in idxs])
    (pj, sj, wj, qj), (cj, ypj, ywj, yqj) = conic_run_pallas(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(w), med,
        jnp.asarray(pols) if with_pol else None,
        consts=_jax_consts(jsteps, idxs, jchain, outline64), store=store, interpret=True)

    tsteps = torch_steps(jsteps)
    tchain = ttc._frame_chain(tsteps, np.float32)
    for a, b in zip(jchain, tchain):        # bit-identical frame shifts
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    tmedia, tpairs = ttc._media_rows(tsteps, idxs)
    assert [tpairs[i] for i in idxs] == [pairs[i] for i in idxs]
    n_tab_t = torch.stack([m(torch.from_numpy(wl)) for m in tmedia])
    np.testing.assert_allclose(n_tab_t.numpy(), np.asarray(n_tab_j), rtol=1e-6)
    consts = ttc._run_steps(tsteps, idxs, tchain, outline64)
    (pt, st, wt, qt), (ct, ypt, ywt, yqt) = conic_run_reference(
        torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(w), n_tab_t,
        [tpairs[i] for i in idxs], consts,
        pol=torch.from_numpy(pols) if with_pol else None, store=store)

    w_atol = W_ATOL_POL if with_pol else W_ATOL
    flipped = (np.asarray(wj) > 0) != (wt.numpy() > 0)
    if store:
        flipped |= np.any((np.asarray(ywj) > 0) != (ywt.numpy() > 0), axis=0)
    assert flipped.sum() <= FLIP_BUDGET_PER_20K
    keep = ~flipped
    np.testing.assert_allclose(pt.numpy()[keep], np.asarray(pj)[keep], rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(st.numpy()[keep], np.asarray(sj)[keep], rtol=P_RTOL, atol=2e-6)
    np.testing.assert_allclose(wt.numpy()[keep], np.asarray(wj)[keep], rtol=W_RTOL, atol=w_atol)
    assert ct.dtype == torch.int32 and ct.shape == (6, 4)
    assert np.abs(ct.numpy() - np.asarray(cj)).sum() <= 2 * flipped.sum()
    assert ct.numpy()[:, 0].sum() > 0          # some rays do miss
    if with_pol:
        np.testing.assert_allclose(qt.numpy()[keep], np.asarray(qj)[keep], atol=POL_ATOL)
    else:
        assert qt is None and qj is None
    if store:
        np.testing.assert_allclose(ypt.numpy()[:, keep], np.asarray(ypj)[:, keep],
                                   rtol=P_RTOL, atol=P_ATOL)
        np.testing.assert_allclose(ywt.numpy()[:, keep], np.asarray(ywj)[:, keep],
                                   rtol=W_RTOL, atol=w_atol)
        assert (yqt is None) == (not with_pol)
        if with_pol:
            np.testing.assert_allclose(yqt.numpy()[:, keep], np.asarray(yqj)[:, keep], atol=POL_ATOL)
    else:
        assert ypt is None and ywt is None and yqt is None


# ----------------------------------------------------------------------
# one step on adversarial bundles (the bundles of tests/test_pallas_run_unit.py)

def _const(**kw):
    c = dict(rho=0.05, k=-0.5, r=2.5, z_min=0.0, z_max=0.2, is_flat=False,
             is_asph=False, coeff=(), is_tilt=False, tn=(0.0, 0.0, 1.0),
             action="refract", mask="circle", ri=0.0, hw=1.0, hh=1.0,
             hwi=0.0, hhi=0.0, angle=0.0, kind="conic",
             dx=0.0, dy=0.0, dz=0.0, ox=0.0, oy=0.0, oz=0.0,
             out=(-100.0, 100.0, -100.0, 100.0, -100.0, 100.0))
    c.update(kw)
    return c


def _radial_bundle(n=64, r_max=2.4, z0=-1.0, tilt=0.08):
    rng = np.random.default_rng(7)
    r = np.linspace(0.0, r_max, n)
    th = rng.uniform(0, 2 * np.pi, n)
    p = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, z0)], axis=-1).astype(np.float32)
    s = np.stack([np.full(n, tilt) * np.cos(th + 1.0), np.full(n, tilt) * np.sin(th + 1.0),
                  np.ones(n)], axis=-1)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    return p, s.astype(np.float32), np.full(n, 0.5, np.float32)


def _pol_for(s):
    ref = np.array([1.0, 0.0, 0.0])
    q = np.cross(s, np.cross(ref, s))
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    q = np.where(n > 1e-9, q / np.where(n > 0, n, 1.0), np.array([0.0, 1.0, 0.0]))
    return q.astype(s.dtype)


def _tile(v, n):
    return np.tile(np.asarray(v, np.float32), (n, 1))


def _bundles():
    """name -> (p, s, w, n1, n2, const, expectation on (miss, tir, outl))."""
    out = {}
    box = (-1.5, 1.5, -1.5, 1.5, -3.0, 3.0)
    p, s, w = _radial_bundle()
    out["outline_escape"] = (p, s, w, 1.0, 1.5, _const(out=box), lambda m, t, o: o > 5)
    p, s, w = _radial_bundle(z0=4.0)
    out["outline_escape_frame_shift"] = (p, s, w, 1.0, 1.5, _const(dz=5.0, out=box),
                                         lambda m, t, o: o > 5)
    p, s, w = _radial_bundle(z0=1.0)
    out["behind_surface"] = (p, s, w, 1.0, 1.5, _const(), lambda m, t, o: m == 64)
    n = 16
    r = np.linspace(0.1, 0.9, n).astype(np.float32)
    p = np.stack([r, np.zeros(n, np.float32), np.full(n, -1.0, np.float32)], axis=-1)
    out["conic_linear_degenerate"] = (p, _tile([0, 0, 1], n), np.ones(n, np.float32), 1.0, 1.5,
                                      _const(rho=0.05, k=-1.0), lambda m, t, o: m == 0)
    # k=-4, sz=0.5 -> A = 0 exactly; rho=1, px=4, sx=0.5, pz=1 -> B = 0 exactly
    out["conic_doubly_degenerate"] = (
        _tile([4.0, 0.0, 1.0], 4), _tile([0.5, np.sqrt(0.5, dtype=np.float32), 0.5], 4),
        np.ones(4, np.float32), 1.0, 1.5, _const(rho=1.0, k=-4.0, r=8.0, z_max=2.0),
        lambda m, t, o: m == 4)
    n = 8
    p = np.zeros((n, 3), np.float32)
    p[:, 2] = -1e-9
    s = _tile([1.0, 0.0, 1e-7], n)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    out["grazing"] = (p, s, np.ones(n, np.float32), 1.0, 1.5,
                      _const(is_flat=True, z_max=0.0, kind="circle"), lambda m, t, o: True)
    p = np.zeros((n, 3), np.float32)
    p[:, 2] = -0.5
    out["tir"] = (p, _tile([0.8, 0.0, 0.6], n), np.ones(n, np.float32), 1.5, 1.0,
                  _const(is_flat=True, z_max=0.0, r=5.0, kind="circle"), lambda m, t, o: t == 8)
    p, s, _ = _radial_bundle()
    out["dead_rays"] = (p, s, np.zeros(64, np.float32), 1.0, 1.5, _const(dx=0.5, dz=2.0),
                        lambda m, t, o: (m, t, o) == (0, 0, 0))
    p, s, w = _radial_bundle(r_max=3.2)
    out["aperture_misses"] = (p, s, w, 1.0, 1.5, _const(), lambda m, t, o: 0 < m < 64)
    return out


BUNDLES = _bundles()


@pytest.mark.parametrize("with_pol", [False, True], ids=["nopol", "pol"])
@pytest.mark.parametrize("name", sorted(BUNDLES))
def test_one_step_matches_jax_step(name, with_pol):
    p, s, w, n1, n2, c, expect = BUNDLES[name]
    n = p.shape[0]
    n1, n2 = np.full(n, n1, np.float32), np.full(n, n2, np.float32)
    pol = _pol_for(s) if with_pol else None

    comps = (p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2], w)
    jpol = None if pol is None else tuple(jnp.asarray(pol[:, i]) for i in range(3))
    stj, qj, fj = j_one_step(*(jnp.asarray(a) for a in comps), jnp.asarray(n1), jnp.asarray(n2),
                             c, pol=jpol)
    tpol = None if pol is None else tuple(torch.from_numpy(pol[:, i].copy()) for i in range(3))
    stt, qt, ft = _one_step(*(torch.from_numpy(a.copy()) for a in comps), torch.from_numpy(n1),
                            torch.from_numpy(n2), c, pol=tpol)

    for a, b in zip(stt, stj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if with_pol:
        for a, b in zip(qt, qj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    counts_t = tuple(int(f.sum()) for f in ft[:3])
    counts_j = tuple(int(jnp.sum(f)) for f in fj[:3])
    assert counts_t == counts_j
    assert expect(*counts_t), counts_t
    if name == "dead_rays":
        np.testing.assert_allclose(torch.stack(stt[:3], -1).numpy(),
                                   p - np.array([0.5, 0.0, 2.0], np.float32), atol=1e-7)
        assert np.array_equal(torch.stack(stt[3:6], -1).numpy(), s)
        if with_pol:
            assert np.array_equal(torch.stack(qt, -1).numpy(), pol)
    if name in ("grazing", "tir"):
        assert float(stt[6].abs().max()) == 0.0


def test_f64_and_gradient_take_the_plain_version():
    """f64 state and a surface parameter that needs a gradient run through
    ``conic_run_reference``; the gradient is finite."""
    p, s, w = _radial_bundle()
    n_tab = torch.stack([torch.full((64,), 1.0, dtype=torch.float64),
                         torch.full((64,), 1.5, dtype=torch.float64)])
    rho = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    c = _const(rho=rho)
    (p2, s2, w2, _), (counts, _, ys_w, _) = conic_run_reference(
        torch.from_numpy(p).double(), torch.from_numpy(s).double(), torch.from_numpy(w).double(),
        n_tab, [(0, 1)], [c])
    assert p2.dtype == torch.float64 and counts.shape == (1, 4)
    (p2[:, 2] * ys_w[0]).sum().backward()
    assert torch.isfinite(rho.grad) and rho.grad != 0


def test_trace_bundle_keeps_gradients_through_a_run():
    """A surface parameter that requires a gradient sends the run through
    the plain version inside ``trace_bundle`` and the gradient arrives."""
    RT = build_scene()
    steps = torch_steps(RT._build_steps())
    rho = steps[2].sfns.params["rho"].requires_grad_()
    p, s, pols, w, wl = (torch.from_numpy(a) for a in make_bundle("build", 500, seed=1))
    out = ttc.trace_bundle(steps, lambda x: torch.ones_like(x), tuple(RT.outline), p, s, pols, w, wl,
                           True)
    assert [k for k, _ in ttc._partition_runs(steps, [])] == ["run", "step"]
    (out["p"][:, 5, 0] * out["w"][:, 5]).sum().backward()
    assert torch.isfinite(rho.grad) and rho.grad != 0


def test_wrapper_on_cpu_and_unported_kinds():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; a step kind that is not ported makes both versions raise."""
    p, s, w = (torch.from_numpy(a) for a in _radial_bundle())
    n_tab = torch.stack([torch.ones(64), torch.full((64,), 1.5)])
    before = conic_run.launches
    a = conic_run(p, s, w, n_tab, [(0, 1)], [_const()], store=False)
    b = conic_run_reference(p, s, w, n_tab, [(0, 1)], [_const()], store=False)
    assert conic_run.launches == before
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][0], b[1][0])
    for kind in ("asphere", "tilted", "ring"):
        with pytest.raises(NotImplementedError, match="not ported"):
            conic_run(p, s, w, n_tab, [(0, 1)], [_const(kind=kind)])


def test_step_table_layout():
    """The table handed to the kernel: derived constants rounded once from
    f64, the media rows and the flat flag in their integer slots."""
    c = _const(rho=0.04, k=-0.5, r=2.0, z_min=-0.1, z_max=0.3, dz=5.0, oz=12.5)
    tab = _step_table([c, _const(is_flat=True, kind="circle")], [(0, 1), (1, 2)])
    assert tab.shape == (2, cuda_run.STEP_WORDS) and tab.dtype == np.float32
    f32 = np.float32
    assert tab[0, 2] == f32(5.0) and tab[0, 5] == f32(12.5)
    assert tab[0, 6] == f32(-0.1 - 1.0) and tab[0, 7] == f32(1 / 0.04) and tab[0, 8] == f32(2 / 0.04)
    assert tab[0, 10] == f32(0.5) and tab[0, 11] == f32(-0.1 - 1e-10) and tab[0, 13] == f32(0.3)
    assert tab[0, 14] == f32((2.0 + 1e-10) ** 2) and tab[0, 15] == f32(-0.5 * 0.04 * 0.04)
    ints = tab.view(np.int32)
    assert ints[0, 23:26].tolist() == [0, 0, 1] and ints[1, 23:26].tolist() == [1, 1, 2]
