"""Every step kind of the run kernel's plain version (``conic_run_reference``:
even asphere, tilted plane, absorb action with circle, ring, rectangle and
slit masks) against the JAX package's Pallas run kernel in interpret mode on
the same constants, the step table that the CUDA kernel reads, and the
single-step kernel's plain version against ``conic_step_xla``.

Tolerances: positions rtol 5e-6 / atol 5e-5 mm (the tolerance that
tests/test_pallas_run.py uses for these kinds), weights atol 1e-8, counters
equal up to the flipped rays, at most 4 flipped rays per 20 000.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import optrace_tpu as ot
from optrace_tpu.ops.pallas_run import conic_run_pallas
from optrace_tpu.ops.pallas_trace import conic_step_xla, conic_step_pallas

from optrace_tpu_torch.ops import cuda_run, cuda_trace
from optrace_tpu_torch.ops.cuda_run import conic_run_reference, _step_table, _coeff_region, _table_bytes
from optrace_tpu_torch.ops.cuda_trace import conic_step, conic_step_reference

from tests.test_torch_common import make_bundle, FLIP_BUDGET_PER_20K, W_RTOL, POL_ATOL

P_RTOL_K, P_ATOL_K, W_ATOL_K = 5e-6, 5e-5, 1e-8
OUT = (-10.0, 10.0, -10.0, 10.0, -12.0, 60.0)


def _c(kind, dz, oz, **kw):
    """A step in the port's form; ``oz`` is the applied origin after ``dz``."""
    c = dict(kind=kind, is_flat=kind not in ("conic", "asphere", "tilted"), action="refract",
             rho=1.0, k=0.0, r=3.0, z_min=0.0, z_max=0.0, dx=0.0, dy=0.0, dz=dz,
             ox=0.0, oy=0.0, oz=oz, out=tuple(OUT[q] - (oz if q >= 4 else 0.0) for q in range(6)))
    c.update(kw)
    return c


def _jax_const(c):
    """The same step in the form of trace_core._conic_run_pallas_dispatch."""
    kind = c["kind"]
    return tuple(sorted(dict(
        rho=c["rho"], k=c["k"], r=c["r"], z_min=c["z_min"], z_max=c["z_max"],
        is_flat=c["is_flat"], is_asph=kind == "asphere", coeff=tuple(c.get("coeff", ())),
        is_tilt=kind == "tilted", tn=tuple(c.get("tn", (0.0, 0.0, 1.0))),
        action=c["action"], mask=c.get("mask", "circle"),
        ri=c.get("ri", 0.0), hw=c.get("hw", 1.0), hh=c.get("hh", 1.0), hwi=c.get("hwi", 0.0),
        hhi=c.get("hhi", 0.0), angle=c.get("angle", 0.0),
        dx=c["dx"], dy=c["dy"], dz=c["dz"], ox=c["ox"], oy=c["oy"], oz=c["oz"], out=c["out"]).items()))


def _sag(r, rho, k, coeff=()):
    z = rho * r * r / (1 + np.sqrt(1 - (k + 1) * rho * rho * r * r))
    return z + sum(a * r ** (2 * (i + 1)) for i, a in enumerate(coeff))


def _steps(which):
    """A run around the step kind under test: a sphere in front, the kind,
    a sphere behind, all with f32-representable constants."""
    f = lambda v: float(np.float32(v))
    th = np.radians(8.0)
    front = _c("conic", 0.0, 0.0, rho=f(1 / 20), z_max=f(_sag(3, 1 / 20, 0)))
    back = _c("conic", 3.0, 8.0, rho=f(-1 / 15), z_min=f(_sag(3, -1 / 15, 0)))
    mid = {
        "asphere": _c("asphere", 5.0, 5.0, rho=f(1 / 30), k=-0.5, coeff=(f(2e-4), f(-1e-6)),
                      z_max=f(_sag(3, 1 / 30, -0.5, (2e-4, -1e-6)))),
        "asphere3": _c("asphere", 5.0, 5.0, rho=f(-1 / 25), k=0.3, r=2.5,
                       coeff=(f(-3e-4), f(2e-6), f(1e-8)),
                       z_min=f(_sag(2.5, -1 / 25, 0.3, (-3e-4, 2e-6, 1e-8)))),
        "tilted": _c("tilted", 5.0, 5.0, tn=(0.0, f(np.sin(th)), f(np.cos(th))),
                     z_min=f(-3 * np.tan(th)), z_max=f(3 * np.tan(th))),
        "circle": _c("circle", 5.0, 5.0, action="absorb", mask="circle", r=0.5),
        "ring": _c("ring", 5.0, 5.0, action="absorb", mask="ring", r=3.0, ri=1.0),
        "rect": _c("rect", 5.0, 5.0, action="absorb", mask="rect", hw=0.6, hh=0.3, angle=f(0.35)),
        "slit": _c("slit", 5.0, 5.0, action="absorb", mask="slit", hw=2.5, hh=2.5, hwi=1.0, hhi=0.3,
                   angle=f(0.35)),
    }[which]
    return [front, mid, back]


KINDS = ["asphere", "asphere3", "tilted", "circle", "ring", "rect", "slit"]


@pytest.mark.parametrize("with_pol", [False, True], ids=["nopol", "pol"])
@pytest.mark.parametrize("which", KINDS)
def test_reference_kinds_match_pallas_interpret(which, with_pol):
    N = 5000 if which.startswith("asphere") else 20000
    steps = _steps(which)
    p, s, pols, w, wl = make_bundle("build", N, seed=40)
    p = p.copy()
    p[:, 2] = -5.0
    p[:, :2] *= 1.3          # some rays miss the first aperture
    rng = np.random.default_rng(41)
    n_tab = np.stack([np.ones(N), 1.5 + 0.02 * rng.uniform(size=N), 1.62 + 0.03 * rng.uniform(size=N)]
                     ).astype(np.float32)
    absorb = steps[1]["action"] == "absorb"
    # air → glass | (glass → other glass, or a stop inside the glass) | → air
    med_idx = [(0, 1), (1, 1) if absorb else (1, 2), (1 if absorb else 2, 0)]
    med = jnp.asarray(np.stack([np.stack([n_tab[a], n_tab[b]]) for a, b in med_idx]))

    (pj, sj, wj, qj), (cj, ypj, ywj, yqj) = conic_run_pallas(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(w), med, jnp.asarray(pols) if with_pol else None,
        consts=tuple(_jax_const(c) for c in steps), store=True, interpret=True)
    (pt, st, wt, qt), (ct, ypt, ywt, yqt) = conic_run_reference(
        torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(w), torch.from_numpy(n_tab),
        med_idx, steps, pol=torch.from_numpy(pols) if with_pol else None, store=True)

    flipped = np.any((np.asarray(ywj) > 0) != (ywt.numpy() > 0), axis=0)
    assert flipped.sum() <= int(np.ceil(FLIP_BUDGET_PER_20K * N / 20000))
    keep = ~flipped
    np.testing.assert_allclose(pt.numpy()[keep], np.asarray(pj)[keep], rtol=P_RTOL_K, atol=P_ATOL_K)
    np.testing.assert_allclose(st.numpy()[keep], np.asarray(sj)[keep], rtol=P_RTOL_K, atol=2e-6)
    np.testing.assert_allclose(ypt.numpy()[:, keep], np.asarray(ypj)[:, keep], rtol=P_RTOL_K, atol=P_ATOL_K)
    np.testing.assert_allclose(ywt.numpy()[:, keep], np.asarray(ywj)[:, keep], rtol=W_RTOL, atol=W_ATOL_K)
    assert ct.shape == (3, 4) and np.abs(ct.numpy() - np.asarray(cj)).sum() <= 2 * flipped.sum()
    if with_pol:
        np.testing.assert_allclose(yqt.numpy()[:, keep], np.asarray(yqj)[:, keep], atol=POL_ATOL)
    # the step under test did something
    w0, w1 = ywt.numpy()[0], ywt.numpy()[1]
    if absorb:
        n_abs = int(((w0 > 0) & (w1 == 0)).sum())
        assert 0 < n_abs < (w0 > 0).sum()
        assert ct.numpy()[1, :2].sum() == 0        # an absorber counts no miss and no TIR
        assert np.array_equal(yqt.numpy()[1], yqt.numpy()[0]) if with_pol else True
    else:
        assert int(((w0 > 0) & (w1 > 0)).sum()) > N // 2
        assert float(np.abs(ypt.numpy()[1, keep] - ypt.numpy()[0, keep]).max()) > 1.0


def test_asphere_ill_conditioned_counter_matches():
    """Rays that reach an asphere outside its bracket (no sign change): the
    fourth counter, in the port and in the JAX kernel."""
    N = 2000
    c = _steps("asphere")[1]
    c = dict(c, dz=0.0, oz=0.0, out=OUT)
    rng = np.random.default_rng(42)
    r = np.sqrt(rng.uniform(0, 1, N)) * 4.2          # beyond the aperture of 3
    th = rng.uniform(0, 2 * np.pi, N)
    p = np.stack([r * np.cos(th), r * np.sin(th), np.full(N, -2.0)], -1).astype(np.float32)
    s = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (N, 1))
    s[:50, 2] = 0.0
    s[:50, 0] = 1.0                                  # sz = 0: unguarded divisions
    w = np.full(N, 1.0, np.float32)
    n_tab = np.stack([np.ones(N), np.full(N, 1.5)]).astype(np.float32)
    med = jnp.asarray(n_tab)[None]
    _, (cj, _, ywj, _) = conic_run_pallas(jnp.asarray(p), jnp.asarray(s), jnp.asarray(w), med, None,
                                          consts=(_jax_const(c),), store=True, interpret=True)
    _, (ct, _, ywt, _) = conic_run_reference(torch.from_numpy(p), torch.from_numpy(s), torch.from_numpy(w),
                                             torch.from_numpy(n_tab), [(0, 1)], [c], store=True)
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    assert ct.numpy()[0, 3] > 100 and ct.numpy()[0, 0] > 100
    assert np.array_equal(ywt.numpy() > 0, np.asarray(ywj) > 0)
    assert torch.isfinite(ywt).all()


def test_step_table_of_the_new_kinds():
    """The words the CUDA kernel reads for asphere, tilted and absorb steps:
    kind, action and mask codes, the derived constants rounded once from
    f64, and the coefficient region with its offsets."""
    f32 = np.float32
    steps = [_steps("asphere")[1], _steps("tilted")[1], _steps("ring")[1], _steps("slit")[1],
             _steps("asphere3")[1], _steps("rect")[1], _steps("circle")[1]]
    med_idx = [(0, 1), (1, 2), (2, 2), (2, 2), (2, 0), (0, 0), (0, 0)]
    tab = _step_table(steps, med_idx)
    ints = tab.view(np.int32)
    assert tab.shape == (7, cuda_run.STEP_WORDS)
    assert ints[:, 23].tolist() == [2, 3, 1, 1, 2, 1, 1]            # solve kind
    assert ints[:, 26].tolist() == [0, 0, 1, 1, 0, 1, 1]            # action
    assert ints[:, 27].tolist() == [0, 0, 1, 3, 0, 2, 0]            # mask
    assert ints[:, 41].tolist() == [0, 4, 4, 4, 4, 10, 10] and ints[:, 42].tolist() == [2, 0, 0, 0, 3, 0, 0]
    a, t, ring, slit = steps[0], steps[1], steps[2], steps[3]
    assert tab[0, 38] == f32((a["k"] + 1.0) * a["rho"] * a["rho"])
    assert tab[0, 39] == f32(a["z_min"] - 1e-7) and tab[0, 40] == f32(a["z_max"] + 1e-7)
    assert tab[0, 16] == f32(-a["rho"])
    assert tab[1, 35:38].tolist() == [f32(v) for v in t["tn"]]
    assert tab[2, 28] == f32((ring["ri"] - 1e-10) ** 2) and tab[2, 14] == f32((ring["r"] + 1e-10) ** 2)
    assert tab[3, 29] == f32(slit["hw"] + 1e-10) and tab[3, 32] == f32(slit["hhi"] - 1e-10)
    assert tab[3, 33] == f32(np.cos(slit["angle"])) and tab[3, 34] == f32(np.sin(slit["angle"]))
    region = _coeff_region(steps)
    c0, c4 = steps[0]["coeff"], steps[4]["coeff"]
    expect = list(c0) + [2.0 * c0[0], 4.0 * c0[1]] + list(c4) + [2.0 * c4[0], 4.0 * c4[1], 6.0 * c4[2]]
    assert region.dtype == np.float32 and region.tolist() == [f32(v) for v in expect]
    assert len(_table_bytes(steps, med_idx)) == 4 * (7 * cuda_run.STEP_WORDS + 10)
    # the whole table must fit the kernel's shared memory: said, not truncated
    many = [dict(steps[4], coeff=tuple([1e-9] * 40))] * 200
    with pytest.raises(ValueError, match="shared memory"):
        _table_bytes(many, [(0, 1)] * 200)
    assert cuda_run.MAX_RUN * cuda_run.STEP_WORDS * 4 <= cuda_run.SMEM_BYTES


def test_step_tag_names_what_a_step_does():
    tags = [cuda_run.step_tag(_steps(k)[1]) for k in KINDS]
    assert tags == ["asphere", "asphere", "tilted", "absorb:circle", "absorb:ring", "absorb:rect",
                    "absorb:slit"]
    assert cuda_run.step_tag(_c("circle", 0.0, 0.0)) == "flat" and cuda_run.step_tag(_steps("ring")[0]) == "conic"


# ----------------------------------------------------------------------
# the single-step kernel's plain version

def _probe_inputs(N):
    """The inputs of bench.py:_bench_trace_step."""
    rng = np.random.default_rng(0)
    p = np.column_stack([rng.uniform(-2, 2, (N, 2)), np.full(N, -5.0)]).astype(np.float32)
    s = rng.normal(0, 0.05, (N, 3)).astype(np.float32)
    s[:, 2] = 1.0
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1, N).astype(np.float32)
    return p, s, w, np.full(N, 1.0, np.float32), np.full(N, 1.52, np.float32)


PROBE_KW = dict(rho=1 / 20.0, k=-0.5, z_min_rel=0.0, z_max_rel=0.3, r_ap=3.0)


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_conic_step_reference_matches_jax(oracle):
    """10 chained calls on the probe's inputs, the weights revived to 1e-3
    between them, against ``conic_step_xla`` and the Pallas step in
    interpret mode: atol 2e-6 (the f32 step), positions after the 5 mm
    flight atol 2e-5."""
    N = 20000
    args = _probe_inputs(N)
    jfn = conic_step_xla if oracle == "xla" else (lambda *a, **k: conic_step_pallas(*a, interpret=True, **k))
    sj = tuple(jnp.asarray(a) for a in args[:3])
    st = tuple(torch.from_numpy(a) for a in args[:3])
    n1, n2 = args[3], args[4]
    for _ in range(10):
        sj = jfn(sj[0], sj[1], jnp.maximum(sj[2], 1e-3), jnp.asarray(n1), jnp.asarray(n2), **PROBE_KW)
        st = conic_step_reference(st[0], st[1], torch.clamp(st[2], min=1e-3), torch.from_numpy(n1),
                                  torch.from_numpy(n2), **PROBE_KW)
        np.testing.assert_allclose(st[0].numpy(), np.asarray(sj[0]), atol=2e-5)
        np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), atol=2e-6)
        np.testing.assert_allclose(st[2].numpy(), np.asarray(sj[2]), atol=2e-6)
    assert 0.0 < float(st[2].min()) and float(st[2].max()) < 1.0


def test_conic_step_differs_from_a_run_step_where_it_should():
    """No N_EPS in the aperture test, no miss kill, no outline: a ray
    outside the aperture keeps its weight and its direction."""
    p = torch.tensor([[0.0, 0.0, -5.0], [3.5, 0.0, -5.0], [0.5, 0.5, -5.0]])
    s = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    w = torch.tensor([0.7, 0.7, 0.0])
    n1, n2 = torch.ones(3), torch.full((3,), 1.52)
    before = conic_step.launches
    p2, s2, w2 = conic_step(p, s, w, n1, n2, **PROBE_KW)        # CPU tensors: the plain version
    assert conic_step.launches == before
    ref = conic_step_reference(p, s, w, n1, n2, **PROBE_KW)
    assert all(torch.equal(a, b) for a, b in zip((p2, s2, w2), ref))
    assert 0.6 < float(w2[0]) < 0.7                             # Fresnel loss on the hit
    assert float(w2[1]) == pytest.approx(0.7) and torch.equal(s2[1], s[1])       # the miss is left alone
    assert float(w2[2]) == 0.0 and torch.equal(p2[2], p[2])     # a dead ray does not move
    # the same ray in a step of a run is killed
    c = dict(cuda_trace._consts(**{k: v for k, v in PROBE_KW.items()}), single=False)
    c["out"] = (-100.0, 100.0, -100.0, 100.0, -100.0, 100.0)
    st, _, flags = cuda_run._one_step(p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2], w, n1, n2, c)
    assert float(st[6][1]) == 0.0 and bool(flags[0][1])
    # and the table's aperture word is r_ap·r_ap for the single step
    tab = _step_table([cuda_trace._consts(**PROBE_KW)], [(0, 0)])
    assert tab[0, 14] == np.float32(9.0)
    assert _step_table([c], [(0, 0)])[0, 14] == np.float32((3.0 + 1e-10) ** 2)


def test_conic_step_gradient_and_f64():
    p, s, w, n1, n2 = (torch.from_numpy(a).double() for a in _probe_inputs(256))
    rho = torch.tensor(1 / 20.0, dtype=torch.float64, requires_grad=True)
    c = dict(cuda_trace._consts(**PROBE_KW), rho=rho)
    st, _, _ = cuda_run._one_step(p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2], w, n1, n2, c)
    (st[3] * st[6]).sum().backward()
    assert torch.isfinite(rho.grad) and float(rho.grad) != 0.0
    out = conic_step_reference(p, s, w, n1, n2, **PROBE_KW)
    assert out[0].dtype == torch.float64
