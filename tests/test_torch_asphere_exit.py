"""The run kernel's exact early exit from the asphere solve, on the CPU.

The kernel (``csrc/trace_step.cuh:asph_solve``) leaves the bracketed
Illinois loop once every ray of a warp has a settled bracket (finite ends
that are equal or neighbouring floats) instead of running all ASPH_ITERS
iterations. ``cuda_run._asph_solve`` can model that: ``freeze="lane"`` stops
a lane at the iteration in which its own bracket settles (the earliest exit
there can be), ``freeze="warp"`` when its 32 neighbours have settled too (the
kernel's vote). Both must give the hit parameter of the full 40 iterations
bit for bit, in f32, NaN and inf included, and ``_one_step`` must go on
giving the bits it gave before the solve was factored out.
"""

import numpy as np
import pytest
import torch

from optrace_tpu_torch.ops import cuda_run
from optrace_tpu_torch.ops.cuda_run import _asph_solve, _asph_settled, _one_step, ASPH_ITERS

N = 20000
R, K, R_AP = 60.0, -0.8, 8.0
COEFFS = {"len1": (1e-5,), "len2": (1e-5, -1e-8),
          "len9": (1e-5, -1e-8, 2e-11, -3e-14, 1e-16, -2e-19, 1e-22, -1e-25, 1e-28)}


def _sag(r, coeff):
    rho = 1.0 / R
    r2 = r * r
    z = rho * r2 / (1.0 + np.sqrt(1.0 - (K + 1.0) * rho * rho * r2))
    return z + sum(a * r2 ** (i + 1) for i, a in enumerate(coeff))


def _const(coeff):
    zs = _sag(np.linspace(0.0, R_AP, 400), coeff)
    return dict(kind="asphere", is_flat=False, action="refract", rho=1.0 / R, k=K, r=R_AP,
                z_min=float(zs.min()), z_max=float(zs.max()), coeff=coeff,
                dx=0.0, dy=0.0, dz=0.0, ox=0.0, oy=0.0, oz=0.0,
                out=(-50.0, 50.0, -50.0, 50.0, -15.0, 300.0))


def _bundle(stress: bool, seed: int):
    """A disc source of radius 4 at 10 mm before the vertex with a cone of
    8 degrees (the asphere scene of chip_smoke.py); the stress bundle takes
    3 x the aperture and the angles, so that many rays pass the surface's
    edge and their brackets hold no sign change. Four special lanes are put
    in front of every group of 1000 rays: sz = 0 and a NaN position (their
    brackets are inf or NaN and never settle), an infinite lateral position
    (a finite bracket around a NaN function) and a ray far outside the
    surface. Returns the six columns and the mask of the lanes that never
    settle."""
    rng = np.random.default_rng(seed)
    scale = 3.0 if stress else 1.0
    rad = 4.0 * scale * np.sqrt(rng.uniform(0, 1, N))
    phi = rng.uniform(0, 2 * np.pi, N)
    p = np.stack([rad * np.cos(phi), rad * np.sin(phi), np.full(N, -10.0)], axis=-1)
    th = np.radians(8.0) * scale * np.sqrt(rng.uniform(0, 1, N))
    al = rng.uniform(0, 2 * np.pi, N)
    s = np.stack([np.sin(th) * np.cos(al), np.sin(th) * np.sin(al), np.cos(th)], axis=-1)
    p, s = p.astype(np.float32), s.astype(np.float32)
    special = np.zeros(N, dtype=bool)
    for q in range(0, N, 1000):
        s[q] = (1.0, 0.0, 0.0)                  # sz = 0: the bracket's divisions give inf and nan
        p[q + 1, 2] = np.nan
        p[q + 2, 0] = np.inf
        p[q + 3, :2] = (40.0, -35.0)            # far outside: ill-conditioned
        special[q:q + 2] = True
    cols = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (p, s) for i in range(3)]
    return cols, special


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("freeze", ["lane", "warp"])
@pytest.mark.parametrize("coeff", sorted(COEFFS))
@pytest.mark.parametrize("bundle", ["nominal", "stress"])
def test_frozen_bracket_gives_the_bits_of_forty_iterations(bundle, coeff, freeze, capsys):
    c = _const(COEFFS[coeff])
    cols, special = _bundle(bundle == "stress", seed=3)
    assert all(col.dtype == torch.float32 for col in cols)
    t40, ill40, none = _asph_solve(*cols, c)
    tfz, illfz, iters = _asph_solve(*cols, c, freeze=freeze)
    assert none is None and t40.dtype == torch.float32
    assert torch.equal(_bits(tfz), _bits(t40)), "a frozen bracket changed a bit of t"
    assert torch.equal(illfz, ill40)

    iters = iters.numpy()
    # lanes with sz = 0 or a NaN position never settle
    assert (iters[special] == ASPH_ITERS).all()
    assert not np.isfinite(t40.numpy()[special]).any()
    usual = ~special
    per_warp = iters[: N - N % 32].reshape(-1, 32).max(axis=1)
    usual_warps = ~special[: N - N % 32].reshape(-1, 32).any(axis=1)
    with capsys.disabled():
        print(f"\n[asphere exit] {bundle:7s} {coeff} freeze={freeze}: iterations mean "
              f"{iters[usual].mean():.2f}, p99 {np.percentile(iters[usual], 99):.0f}, most "
              f"{iters[usual].max()}, slowest of 32 neighbours mean {per_warp[usual_warps].mean():.2f}; "
              f"ill-conditioned {int(ill40.sum())}")
    assert int(ill40.sum()) >= (1000 if bundle == "stress" else N // 1000)
    if freeze == "lane":
        assert iters[usual].max() < ASPH_ITERS, "a usual ray never settled"
        assert iters[usual].mean() < (25.0 if bundle == "stress" else 12.0)
    else:
        # a warp with a lane that never settles runs all the iterations
        assert (per_warp[::-1][-1] == ASPH_ITERS) and iters.max() == ASPH_ITERS


@pytest.mark.parametrize("pair,settled", [
    ((1.0, 1.0), True), ((1.0, float(np.nextafter(np.float32(1.0), np.float32(2.0)))), True),
    ((1.0, 1.0 + 3e-7), False), ((0.0, -0.0), True),
    ((0.0, float(np.nextafter(np.float32(0.0), np.float32(-1.0)))), True),
    ((float(np.nextafter(np.float32(0.0), np.float32(1.0))),
      float(np.nextafter(np.float32(0.0), np.float32(-1.0)))), False),
    ((float("inf"), float("inf")), False), ((float("nan"), 1.0), False),
    ((2e38, 2e38), False), ((-5.0, -5.0), True)])
def test_settled_rule(pair, settled):
    """Equal or neighbouring finite floats below 1e38 are settled; nothing
    else is, and above 1e38 the sum t1 + t2 could overflow."""
    t1, t2 = (torch.tensor([v], dtype=torch.float32) for v in pair)
    assert bool(_asph_settled(t1, t2)) is settled
    assert bool(_asph_settled(t2, t1)) is settled
    if settled:     # what the exit relies on: the mean is one of the two ends, and stays
        mid = 0.5 * (t1 + t2)
        assert bool((mid == t1) | (mid == t2))
        assert torch.equal(0.5 * (mid + mid), mid)


@pytest.mark.parametrize("coeff", sorted(COEFFS))
def test_one_step_keeps_its_bits(coeff):
    """``_one_step`` with the factored solve against the loop written out
    as it stood in ``_one_step`` before: same state, same flags, bit for bit."""
    c = _const(COEFFS[coeff])
    cols, _ = _bundle(True, seed=5)
    px, py, pz, sx, sy, sz = cols
    w = torch.ones(N)
    n1, n2 = torch.ones(N), torch.full((N,), 1.5)
    state, _, (miss, tir, outl, ill) = _one_step(px, py, pz, sx, sy, sz, w, n1, n2, c)

    where, F = torch.where, cuda_run._asph_sag_F
    # the step's own standoff advance, then the solve as it was written
    ok_adv = (w > 0) & (sz != 0)
    t0 = (c["z_min"] - cuda_run.ADVANCE_STANDOFF - pz) / where(ok_adv, sz, 1.0)
    adv = ok_adv & (t0 > 0)
    ax, ay, az = where(adv, px + t0 * sx, px), where(adv, py + t0 * sy, py), where(adv, pz + t0 * sz, pz)
    eps_b = cuda_run.C_EPS / 10.0
    t1 = torch.clamp((c["z_min"] - eps_b - az) / sz, min=-cuda_run.C_EPS)
    t2 = (c["z_max"] + eps_b - az) / sz
    f1 = F(t1, ax, ay, az, sx, sy, sz, c["rho"], c["k"], c["coeff"])
    f2 = F(t2, ax, ay, az, sx, sy, sz, c["rho"], c["k"], c["coeff"])
    ill_ref = f1 * f2 > 0.0
    for _ in range(ASPH_ITERS):
        df = f2 - f1
        denom = where(torch.abs(df) > cuda_run.N_EPS, df, 1.0)
        ts = t1 - f1 / denom * (t2 - t1)
        mid = 0.5 * (t1 + t2)
        inside = (ts > torch.minimum(t1, t2)) & (ts < torch.maximum(t1, t2))
        ts = where(inside, ts, mid)
        fs = F(ts, ax, ay, az, sx, sy, sz, c["rho"], c["k"], c["coeff"])
        use_left = f1 * fs <= 0.0
        t1, f1, t2, f2 = (where(use_left, t1, ts), where(use_left, 0.5 * f1, fs),
                          where(use_left, ts, t2), where(use_left, fs, 0.5 * f2))
    t_ref = 0.5 * (t1 + t2)
    t_new, ill_new, _ = _asph_solve(ax, ay, az, sx, sy, sz, c)
    assert torch.equal(_bits(t_new), _bits(t_ref)) and torch.equal(ill_new, ill_ref)
    assert torch.equal(ill, ill_ref)
    # rays with a valid hit stand on the surface
    hit = (state[6] > 0)
    assert int(hit.sum()) > N // 20
    r2 = (state[0] ** 2 + state[1] ** 2)[hit].double().numpy()
    z_surf = _sag(np.sqrt(r2), COEFFS[coeff])
    np.testing.assert_allclose(state[2][hit].double().numpy(), z_surf, atol=2e-5)
