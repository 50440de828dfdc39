// One trace step for one ray: the physics shared by the whole-run kernel
// (conic_run.cu) and the single-step kernel (conic_step.cu).
//
// trace_step<POL, RUN, ALL_KINDS> computes what
// optrace_tpu/ops/pallas_run.py:_one_step computes (RUN = true) and what
// optrace_tpu/ops/pallas_trace.py:_step_math computes (RUN = false), in the
// operation order of the plain PyTorch
// versions (ops/cuda_run.py:_one_step, ops/cuda_trace.py). The two TPU step
// bodies are the same arithmetic up to three real differences, which RUN
// compiles in or out (ALL_KINDS only drops the step kinds that a run of flat
// and conic refractions does not need):
//   - the run step shifts the frame first, kills rays that miss the surface,
//     holds every step kind and the absorb action, and ends with the
//     outline-box kill; the single step is a conic refraction with none of
//     these (a miss only leaves weight and direction as they were);
//   - the aperture test is r² <= r_ap2 in both; the host fills r_ap2 with
//     (r + N_EPS)² for a run and with r_ap·r_ap for the single step;
//   - the single step writes D = sqrt(has_root ? disc : 0) and
//     T = n2cb/n1ca · ½ · (ts² + tp²). Both give the bits of the run step's
//     forms (sqrt(has_root ? disc : 1) masked to 0, and
//     n2cb/n1ca · (½ts·ts + ½tp·tp)): a factor ½ commutes with every rounding
//     short of underflow. So one body serves both.
//
// Arithmetic contract: every operation is a separate IEEE f32 add, mul, div
// or sqrt. Compile WITHOUT --use_fast_math and with -fmad=false. Non-finite
// values are part of the contract: divisions by sz in the asphere and tilted
// solves are deliberately unguarded, and inf/NaN flow into `valid = false`
// through isfinite and ordered comparisons. min/max/clamp propagate NaN as
// the tensor versions do (fminf/fmaxf would drop it).
//
// What a step costs on an H100 is its instruction count, not its bytes: the
// state is in registers and the constants are warp-uniform. So the design
// removes instructions whose result no output bit depends on, and nothing
// else:
//   - The asphere's bracketed solve is defined as ASPH_ITERS iterations (the
//     plain version runs them all). The kernel leaves the loop as soon as
//     every ray of the warp has a SETTLED bracket: t1 and t2 finite, below
//     1e38 in size, and equal or neighbouring floats. From then on the
//     result cannot change. No float lies strictly between t1 and t2, so the
//     secant point is never "inside" and ts = mid = ½(t1 + t2), which rounds
//     to one of the two, call it m (t1 + t2 cannot overflow below 1e38, and
//     halving is exact or, for denormals, rounds onto t1 or t2). The update
//     keeps one end and replaces the other by m: the bracket either stays as
//     it is or collapses onto (m, m), and ½(m + m) = m. Every later
//     iteration is of the same form, so the ½(t1 + t2) after 40 iterations
//     is the ½(t1 + t2) of the moment the bracket settled, bit for bit. Only
//     f1 and f2 go on changing (the Illinois halving), and nothing after the
//     loop reads them. A ray whose bracket is inf or NaN never settles, so
//     its warp runs all 40 iterations: right by construction, only slower.
//     On the front surface of an R = 60, k = −0.8 asphere a ray's bracket
//     settles after about 5 iterations in the mean and the last of a warp's
//     32 after about 18 (tests/test_torch_asphere_exit.py counts them).
//   - The polynomial's coefficients are loaded once a step into registers
//     (up to 8; longer ones are read in a loop), zero-padded at the high
//     end: Horner starts from 0, and 0·r² + 0 = 0 for every r² that is not
//     inf or NaN, for which the first true term gives NaN as well.
//   - Two of the conic step's IEEE divisions feed values that almost no ray
//     uses (the linear root when |A| ≤ 1e-10, the z_max clamp of an abnormal
//     hit); each sits behind the branch that selects it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define C_EPS 1e-6f
#define N_EPS 1e-10f
#define INV_SQRT2 0.70710678118654757f
#define ASPH_ITERS 40

enum StepKind { KIND_CONIC = 0, KIND_FLAT = 1, KIND_ASPHERE = 2, KIND_TILTED = 3 };
enum StepAction { ACT_REFRACT = 0, ACT_ABSORB = 1 };
enum StepMask { MASK_CIRCLE = 0, MASK_RING = 1, MASK_RECT = 2, MASK_SLIT = 3 };

// One step. Filled on the host (ops/cuda_run.py:_step_table) in f64 and
// rounded once to f32; the layout must match STEP_WORDS there.
struct Step {
    float dx, dy, dz;          //  0 frame delta applied before the step
    float ox, oy, oz;          //  3 applied origin: sections are state + origin
    float z_floor;             //  6 z_min − ADVANCE_STANDOFF
    float inv_rho, two_inv_rho;//  7
    float k, k1;               //  9 conic constant, k + 1
    float lo, hi;              // 11 z_min − N_EPS, z_max + N_EPS
    float z_max;               // 13
    float r_ap2;               // 14 (r + N_EPS)²; r_ap² for the single step
    float krr, neg_rho;        // 15 k·ρ², −ρ
    float out[6];              // 17 outline box relative to the applied origin
    int kind;                  // 23 StepKind
    int n1_row, n2_row;        // 24 rows of n_tab
    int action;                // 26 StepAction
    int mask;                  // 27 StepMask of an absorb step
    float ri2;                 // 28 (ri − N_EPS)²
    float hw_e, hh_e;          // 29 hw + N_EPS, hh + N_EPS
    float hwi_e, hhi_e;        // 31 hwi − N_EPS, hhi − N_EPS
    float ca, sa;              // 33 cos, sin of the mask's rotation angle
    float tnx, tny, tnz;       // 35 unit normal of a tilted plane
    float k1rr;                // 38 (k + 1)·ρ²
    float zlo_b, zhi_b;        // 39 asphere bracket: z_min − C_EPS/10, z_max + C_EPS/10
    int coeff_off, n_coeff;    // 41 asphere coefficients in the coefficient region
    int pad;                   // 43
};

struct RayState {
    float px, py, pz, sx, sy, sz, w;
    float qx, qy, qz;          // polarization (POL only)
};

struct StepFlags {
    bool miss, tir, outl, ill;
};

__device__ __forceinline__ float max_p(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float min_p(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float clamp_p(float x, float lo, float hi) {
    return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

// The polynomial of an even asphere in r². NC > 0: the coefficients in NC
// registers, zero-padded above n (the header says why that changes no bit);
// NC = 0: any length, read from the coefficient region at every evaluation.
template <int NC>
struct AsphPoly {
    float c[NC > 0 ? NC : 1];
    const float* p;
    int n;

    __device__ __forceinline__ void load(const float* src, int n_cf) {
        p = src;
        n = n_cf;
#pragma unroll
        for (int i = 0; i < NC; ++i) c[i] = (i < n_cf) ? src[i] : 0.f;
    }

    // Horner from the last coefficient, as the plain version's loop
    __device__ __forceinline__ float eval(float r2) const {
        float poly = 0.f;
        if (NC > 0) {
#pragma unroll
            for (int i = NC - 1; i >= 0; --i) poly = poly * r2 + c[i];
        } else {
            for (int i = n - 1; i >= 0; --i) poly = poly * r2 + p[i];
        }
        return poly;
    }
};

// F(t) = z(t) − sag(x(t), y(t)) of an even asphere: guarded square root,
// Horner in r².
template <int NC>
__device__ __forceinline__ float asph_F(
    float t, float px, float py, float pz, float sx, float sy, float sz,
    float rho, float k1rr, const AsphPoly<NC>& poly_cf)
{
    const float x = px + t * sx;
    const float y = py + t * sy;
    const float r2 = x * x + y * y;
    const float arg = 1.f - k1rr * r2;
    const bool ok = arg > 0.f;
    float root = sqrtf(ok ? arg : 1.f);
    root = ok ? root : 0.f;
    const float z = rho * r2 / (1.f + root);
    const float poly = poly_cf.eval(r2);
    return pz + t * sz - (z + poly * r2);
}

// Whether a bracket can no longer move the result: both ends finite and
// below 1e38 in size, and equal or neighbouring floats (their bit patterns,
// mapped to integers in the order of the floats, differ by at most 1; +0
// and −0 map to the same integer).
__device__ __forceinline__ bool asph_settled(float t1, float t2) {
    int o1 = __float_as_int(t1), o2 = __float_as_int(t2);
    o1 = (o1 < 0) ? (int)(0x80000000u - (unsigned)o1) : o1;
    o2 = (o2 < 0) ? (int)(0x80000000u - (unsigned)o2) : o2;
    const bool close = ((unsigned)o1 - (unsigned)o2 + 1u) <= 2u;
    return (fabsf(t1) < 1e38f) && (fabsf(t2) < 1e38f) && close;
}

// Bracketed Illinois false position on F. Defined as ASPH_ITERS iterations;
// leaves the loop once the bracket of every ray in `lanes` (the lanes of the
// warp that run this step together) is settled, which changes no bit of t.
template <int NC>
__device__ __forceinline__ float asph_solve(
    const Step& c, const float* __restrict__ cf, unsigned lanes,
    float px, float py, float pz, float sx, float sy, float sz, bool& ill)
{
    AsphPoly<NC> poly;
    poly.load(cf, c.n_coeff);
    const float rho = -c.neg_rho;
    const float k1rr = c.k1rr;
    float t1 = max_p((c.zlo_b - pz) / sz, -C_EPS);
    float t2 = (c.zhi_b - pz) / sz;
    float f1 = asph_F<NC>(t1, px, py, pz, sx, sy, sz, rho, k1rr, poly);
    float f2 = asph_F<NC>(t2, px, py, pz, sx, sy, sz, rho, k1rr, poly);
    ill = (f1 * f2 > 0.f);
#pragma unroll 1
    for (int it = 0; it < ASPH_ITERS; ++it) {
        const float df = f2 - f1;
        const float denom = (fabsf(df) > N_EPS) ? df : 1.f;
        float ts = t1 - f1 / denom * (t2 - t1);
        const float mid = 0.5f * (t1 + t2);
        const bool inside = (ts > min_p(t1, t2)) && (ts < max_p(t1, t2));
        ts = inside ? ts : mid;
        const float fs = asph_F<NC>(ts, px, py, pz, sx, sy, sz, rho, k1rr, poly);
        const bool use_left = f1 * fs <= 0.f;
        const float nt1 = use_left ? t1 : ts;
        const float nf1 = use_left ? 0.5f * f1 : fs;
        const float nt2 = use_left ? ts : t2;
        const float nf2 = use_left ? fs : 0.5f * f2;
        t1 = nt1; f1 = nf1; t2 = nt2; f2 = nf2;
        if (__all_sync(lanes, asph_settled(t1, t2))) break;
    }
    return 0.5f * (t1 + t2);
}

// One step for a ray that is alive on entry (w > 0). For RUN the caller has
// applied the frame shift already (dead rays take it too). `coef` is the
// coefficient region of the step table (RUN) or unused. `lanes` is the mask
// of the lanes of this warp that make this call together (the rays alive on
// entry): the asphere solve votes among them. ALL_KINDS = false
// compiles the asphere, the tilted plane and the absorb action out: a run of
// flat and conic refractions alone then takes fewer registers.
template <bool POL, bool RUN, bool ALL_KINDS>
__device__ __forceinline__ void trace_step(
    const Step& c, const float* __restrict__ coef, unsigned lanes, float n1, float n2,
    RayState& r, StepFlags& f)
{
    float px = r.px, py = r.py, pz = r.pz, sx = r.sx, sy = r.sy, sz = r.sz, w = r.w;
    f.miss = false; f.tir = false; f.outl = false; f.ill = false;

    // previous section position: origin of the outline intersection
    const float ppx = px, ppy = py, ppz = pz;

    // standoff advance
    {
        const bool ok_adv = sz != 0.f;
        const float t0 = (c.z_floor - pz) / (ok_adv ? sz : 1.f);
        if (ok_adv && (t0 > 0.f)) {
            px = px + t0 * sx;
            py = py + t0 * sy;
            pz = pz + t0 * sz;
        }
    }

    const int kind = RUN ? c.kind : KIND_CONIC;
    float t;
    bool valid;
    if (kind == KIND_FLAT) {
        const bool sz_ok = sz != 0.f;
        t = sz_ok ? (-pz / (sz_ok ? sz : 1.f)) : INFINITY;
        valid = isfinite(t) && (t >= -C_EPS);
    } else if (ALL_KINDS && kind == KIND_TILTED) {
        const float num = -(px * c.tnx + py * c.tny + pz * c.tnz);
        const float den = sx * c.tnx + sy * c.tny + sz * c.tnz;
        t = num / den;
        valid = isfinite(t) && (den != 0.f);
    } else if (ALL_KINDS && kind == KIND_ASPHERE) {
        // bracketed Illinois false position (asph_solve); the polynomial
        // in 4 or 8 registers, or read in a loop when it is longer
        const float* cf = coef + c.coeff_off;
        if (c.n_coeff <= 4) {
            t = asph_solve<4>(c, cf, lanes, px, py, pz, sx, sy, sz, f.ill);
        } else if (c.n_coeff <= 8) {
            t = asph_solve<8>(c, cf, lanes, px, py, pz, sx, sy, sz, f.ill);
        } else {
            t = asph_solve<0>(c, cf, lanes, px, py, pz, sx, sy, sz, f.ill);
        }
        valid = isfinite(t) && !f.ill;
    } else {
        // conic root: Citardauq pair + one guarded Newton polish
        const float A = 1.f + c.k * sz * sz;
        const float B = sx * px + sy * py + sz * (pz * c.k1 - c.inv_rho);
        const float C = px * px + py * py + pz * (pz * c.k1 - c.two_inv_rho);
        const float disc = B * B - C * A;
        const bool has_root = disc >= 0.f;
        float D = sqrtf(has_root ? disc : 1.f);
        D = has_root ? D : 0.f;
        const float sgnB = (B >= 0.f) ? 1.f : -1.f;
        const float q = -(B + sgnB * D);
        const bool okA = fabsf(A) > N_EPS;
        const bool okq = fabsf(q) > N_EPS;
        const bool okB = fabsf(B) > N_EPS;
        float t1 = okA ? (q / (okA ? A : 1.f)) : INFINITY;
        float t2 = okq ? (C / (okq ? q : 1.f)) : INFINITY;
        // the linear root: a division that only a ray with |A| <= N_EPS uses
        const bool lin = !okA && okB;
        if (lin) {
            const float t_lin = -C / (2.f * B);
            t1 = t_lin;
            t2 = t_lin;
        }

        const float z1 = pz + sz * t1;
        const float z2 = pz + sz * t2;
        const float fw = pz - C_EPS;
        const bool ok1 = (c.lo <= z1) && (z1 <= c.hi) && (z1 >= fw) && isfinite(t1);
        const bool ok2 = (c.lo <= z2) && (z2 <= c.hi) && (z2 >= fw) && isfinite(t2);
        const bool use1 = ok1 && !(ok2 && (t2 < t1));
        t = use1 ? t1 : t2;
        const float z_sel = use1 ? z1 : z2;
        const bool in_range = (c.lo <= z_sel) && (z_sel <= c.hi) && isfinite(t);
        valid = has_root && in_range && !(lin && !okB);

        const float At = A * t;
        const float Qp = 2.f * (At + B);
        const float Qv = (At + 2.f * B) * t + C;
        const float scale = fabsf(At) + fabsf(B);
        bool okp = valid && (fabsf(Qp) > 1e-5f * scale + N_EPS) && isfinite(t);
        const float stp = clamp_p(Qv / (okp ? Qp : 1.f), -1e-3f, 1e-3f);
        const float t_pol = t - stp;
        const float z_pol = pz + sz * t_pol;
        okp = okp && (c.lo <= z_pol) && (z_pol <= c.hi);
        t = okp ? t_pol : t;
    }

    // clamp abnormal hits to the z_max plane
    const bool t_fin = isfinite(t);
    float t_safe = t_fin ? t : 0.f;
    const float z_hit = pz + t_safe * sz;
    const bool beh = pz > c.hi;
    const bool neg = z_hit < pz - C_EPS;
    const bool bad = !valid || neg || !t_fin;
    if (bad && !beh) {
        // the z_max clamp: a division that only an abnormal hit uses
        const bool sz_ok = sz != 0.f;
        t_safe = sz_ok ? ((c.z_max - pz) / (sz_ok ? sz : 1.f)) : 0.f;
    }
    t_safe = beh ? 0.f : t_safe;
    const bool ok = !(bad || beh);

    px = px + t_safe * sx;
    py = py + t_safe * sy;
    pz = pz + t_safe * sz;
    const float r2h = px * px + py * py;

    if (RUN && ALL_KINDS && c.action == ACT_ABSORB) {
        // fused aperture: a ray that hits the shape is absorbed, a ray
        // through the opening goes on untouched (no miss kill, no
        // refraction; direction and polarization stay)
        bool hitm;
        if (c.mask == MASK_RING) {
            hitm = (r2h <= c.r_ap2) && (r2h >= c.ri2);
        } else if (c.mask == MASK_RECT || c.mask == MASK_SLIT) {
            const float xr = px * c.ca + py * c.sa;
            const float yr = -px * c.sa + py * c.ca;
            hitm = (fabsf(xr) <= c.hw_e) && (fabsf(yr) <= c.hh_e);
            if (c.mask == MASK_SLIT) {
                const bool innm = (fabsf(xr) < c.hwi_e) && (fabsf(yr) < c.hhi_e);
                hitm = hitm && !innm;
            }
        } else {
            hitm = r2h <= c.r_ap2;
        }
        if (hitm && ok) w = 0.f;
    } else {
        const bool hit = (r2h <= c.r_ap2) && ok;
        if (RUN) {
            f.miss = !hit;
            if (f.miss) w = 0.f;
        }

        // normal
        float nx, ny, nz;
        if (kind == KIND_FLAT) {
            nx = 0.f; ny = 0.f; nz = 1.f;
        } else if (ALL_KINDS && kind == KIND_TILTED) {
            nx = c.tnx; ny = c.tny; nz = c.tnz;
        } else if (ALL_KINDS && kind == KIND_ASPHERE) {
            // radial slope m = dsag/dr; n ∝ (−m/r·x, −m/r·y, 1). r² reuses the
            // aperture product: the normal is used only where p is the hit
            const float rho = -c.neg_rho;
            const float* dcf = coef + c.coeff_off + c.n_coeff;   // 2(i+1)·a_i
            const float rr = sqrtf(max_p(r2h, 1e-20f));
            const float root = sqrtf(max_p(1.f - c.k1rr * rr * rr, N_EPS));
            float m = rho * rr / root;
            float dpoly = 0.f;
            for (int i = c.n_coeff - 1; i >= 0; --i) dpoly = dpoly * r2h + dcf[i];
            m = m + dpoly * rr;
            const float mr = m / rr;
            const float nxu = -mr * px;
            const float nyu = -mr * py;
            const float inv = 1.f / sqrtf(nxu * nxu + nyu * nyu + 1.f);
            nx = nxu * inv;
            ny = nyu * inv;
            nz = inv;
        } else {
            const float arg = 1.f - c.krr * r2h;
            const float den = sqrtf((arg > N_EPS) ? arg : N_EPS);
            nx = c.neg_rho * px / den;
            ny = c.neg_rho * py / den;
            const float argz = 1.f - (nx * nx + ny * ny);
            nz = sqrtf((argz > N_EPS) ? argz : N_EPS);
        }

        // Snell + Fresnel
        const float ns = nx * sx + ny * sy + nz * sz;
        const bool graze = ns < 1e-6f;
        const float ns_safe = graze ? 1.f : ns;
        const float Nq = n1 / n2;
        const float W2 = 1.f - Nq * Nq * (1.f - ns * ns);
        const bool tir = W2 < 0.f;
        float W = sqrtf(tir ? 1.f : W2);
        W = tir ? 0.f : W;
        const float fr = Nq * ns - W;
        const float sx_ = sx * Nq - nx * fr;
        const float sy_ = sy * Nq - ny * fr;
        const float sz_ = sz * Nq - nz * fr;

        const bool upd = hit && !tir;
        float A_ts2 = 0.5f, A_tp2 = 0.5f;
        if (POL) {
            // s/p decomposition across the direction change
            const bool changed = (sx != sx_) || (sy != sy_) || (sz != sz_);
            const float cx = sy_ * sz - sz_ * sy;
            const float cy = sz_ * sx - sx_ * sz;
            const float cz = sx_ * sy - sy_ * sx;
            const float cn2 = cx * cx + cy * cy + cz * cz;
            const bool cok = cn2 > 0.f;
            const float cinv = 1.f / sqrtf(cok ? cn2 : 1.f);
            const float psx = cok ? cx * cinv : 0.f;
            const float psy = cok ? cy * cinv : 0.f;
            const float psz = cok ? cz * cinv : 0.f;
            // p-basis before (b) and after (b_) the refraction
            const float bx = psy * sz - psz * sy;
            const float by = psz * sx - psx * sz;
            const float bz = psx * sy - psy * sx;
            float A_ts = psx * r.qx + psy * r.qy + psz * r.qz;
            float A_tp = bx * r.qx + by * r.qy + bz * r.qz;
            A_ts = changed ? A_ts : INV_SQRT2;
            A_tp = changed ? A_tp : INV_SQRT2;
            const float bx_ = psy * sz_ - psz * sy_;
            const float by_ = psz * sx_ - psx * sz_;
            const float bz_ = psx * sy_ - psy * sx_;
            if (upd && changed) {
                r.qx = psx * A_ts + bx_ * A_tp;
                r.qy = psy * A_ts + by_ * A_tp;
                r.qz = psz * A_ts + bz_ * A_tp;
            }
            A_ts2 = A_ts * A_ts;
            A_tp2 = A_tp * A_tp;
        }
        const float n1ca = n1 * ns_safe;
        const float n2cb = n2 * W;
        const float ts = 2.f * n1ca / (n1ca + n2cb);
        const float tp = 2.f * n1ca / (n2 * ns_safe + n1 * W);
        float T = n2cb / n1ca * (A_ts2 * ts * ts + A_tp2 * tp * tp);
        T = (tir || graze) ? 0.f : T;

        if (hit) w = w * T;
        f.tir = tir && hit;
        if (upd) { sx = sx_; sy = sy_; sz = sz_; }
    }

    if (RUN) {
        // outline-box kill, intersected from the previous position
        const bool inside = (c.out[0] < px) && (px < c.out[1])
                         && (c.out[2] < py) && (py < c.out[3])
                         && (c.out[4] < pz) && (pz < c.out[5]);
        f.outl = !inside && (w > 0.f);
        if (f.outl) {
            float tmin = INFINITY;
            {
                const bool okd = sx != 0.f;
                const float den = okd ? sx : 1.f;
                float tb = (c.out[0] - ppx) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
                tb = (c.out[1] - ppx) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
            }
            {
                const bool okd = sy != 0.f;
                const float den = okd ? sy : 1.f;
                float tb = (c.out[2] - ppy) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
                tb = (c.out[3] - ppy) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
            }
            {
                const bool okd = sz != 0.f;
                const float den = okd ? sz : 1.f;
                float tb = (c.out[4] - ppz) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
                tb = (c.out[5] - ppz) / den;
                if (okd && (tb > 0.f) && (tb < tmin)) tmin = tb;
            }
            tmin = isfinite(tmin) ? tmin : 0.f;
            px = ppx + tmin * sx;
            py = ppy + tmin * sy;
            pz = ppz + tmin * sz;
            w = 0.f;
        }
    }

    r.px = px; r.py = py; r.pz = pz;
    r.sx = sx; r.sy = sy; r.sz = sz;
    r.w = w;
}
