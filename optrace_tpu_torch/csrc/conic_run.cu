// Whole-run trace kernel: L consecutive refract steps (flat discs, spheres,
// conics) for every ray in one launch, ray state in registers.
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_run.py:conic_run_pallas
// (step body _one_step, outline kill _outline_block). It computes the same
// step: frame shift, standoff advance, hit solve (plane, or conic Citardauq
// root pair + one guarded Newton polish), abnormal-hit clamp, aperture mask
// and miss kill, normal, Snell + Fresnel (no-pol A² = ½, or s/p polarization
// transport), TIR kill, outline-box kill, per-step counts [miss, tir,
// outline, ill], and optionally the per-step absolute positions, weights and
// polarizations.
//
// Design for Hopper: one thread per ray; p, s, w (and pol) live in registers
// for the whole run; the per-step parameters are a small table staged in
// shared memory (read uniformly by every thread, so the flat/conic branch
// never diverges inside a warp); media are read from the unique-media table
// n_tab (M, N) through a per-step row index, so a ray reads each medium value
// once per use instead of a gathered (L, 2, N) copy; counts are reduced with
// __ballot_sync/__popc per warp and one integer atomicAdd per warp, step and
// non-zero counter (exact at any N).
//
// Bound: per ray the kernel must move 28 B in + 28 B out of state (40 + 40
// with pol), 4·M B of media (M: the rows of n_tab that the run's steps name,
// not all the table holds) and, when sections are stored, 16 B (28 B with
// pol) per step; it does on the order of 150 f32 operations per ray-step,
// among them 2 square roots and about 8 divisions. At N = 10⁶, L = 56 with
// stored sections that is about 0.9 GB against about 8 GFLOP, so on an H100
// (3.35 TB/s, 67 TFLOP/s f32) the memory side is the tighter bound by far;
// the no-store form moves under 0.1 GB and is bound by its operations.
//
// Arithmetic contract: every operation is a separate IEEE f32 add, mul, div
// or sqrt in the order of the plain PyTorch version
// (ops/cuda_run.py:conic_run_reference). Compile WITHOUT --use_fast_math and
// with -fmad=false, so that kernel and plain version make the same hit/miss
// decisions. Non-finite values are part of the contract: t = ±inf and NaN
// flow into `valid = false` through isfinite and ordered comparisons.

#include <cuda_runtime.h>
#include <math.h>

#define C_EPS 1e-6f
#define N_EPS 1e-10f
#define INV_SQRT2 0.70710678118654757f

// One step of the run. Filled on the host (ops/cuda_run.py:_step_table) in
// f64 and rounded once to f32; the layout must match STEP_WORDS there.
struct Step {
    float dx, dy, dz;          // frame delta applied before the step
    float ox, oy, oz;          // applied origin: sections are state + origin
    float z_floor;             // z_min − ADVANCE_STANDOFF
    float inv_rho, two_inv_rho;
    float k, k1;               // conic constant, k + 1
    float lo, hi;              // z_min − N_EPS, z_max + N_EPS
    float z_max;
    float r_ap2;               // (r + N_EPS)²
    float krr, neg_rho;        // k·ρ², −ρ
    float out[6];              // outline box relative to the applied origin
    int is_flat;
    int n1_row, n2_row;        // rows of n_tab
    int pad;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

template <bool POL, bool STORE>
__global__ void conic_run_kernel(
    const float* __restrict__ p_in, const float* __restrict__ s_in,
    const float* __restrict__ w_in, const float* __restrict__ pol_in,
    const float* __restrict__ n_tab, const Step* __restrict__ steps_g,
    int L, long long N,
    float* __restrict__ p_out, float* __restrict__ s_out,
    float* __restrict__ w_out, float* __restrict__ pol_out,
    int* __restrict__ counts,
    float* __restrict__ ys_p, float* __restrict__ ys_w,
    float* __restrict__ ys_pol)
{
    extern __shared__ Step steps[];
    {
        const int* src = reinterpret_cast<const int*>(steps_g);
        int* dst = reinterpret_cast<int*>(steps);
        const int words = L * (int)(sizeof(Step) / sizeof(int));
        for (int q = threadIdx.x; q < words; q += blockDim.x) dst[q] = src[q];
    }
    __syncthreads();

    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = i < N;
    const int lane = threadIdx.x & 31;

    float px = 0.f, py = 0.f, pz = 0.f, sx = 0.f, sy = 0.f, sz = 1.f, w = 0.f;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
        px = p_in[3 * i]; py = p_in[3 * i + 1]; pz = p_in[3 * i + 2];
        sx = s_in[3 * i]; sy = s_in[3 * i + 1]; sz = s_in[3 * i + 2];
        w = w_in[i];
        if (POL) { qx = pol_in[3 * i]; qy = pol_in[3 * i + 1]; qz = pol_in[3 * i + 2]; }
    }

    int last_row = -1;      // medium row whose value is still in a register
    float last_n = 1.f;

    for (int j = 0; j < L; ++j) {
        const Step& c = steps[j];
        const bool hw = w > 0.f;

        // frame shift into this surface's vertex frame (dead rays too)
        px = px - c.dx;
        py = py - c.dy;
        pz = pz - c.dz;

        bool miss = false, n_tir = false, outl = false;

        // a dead ray takes only the frame shift: every update below is
        // masked by hw, hit (⊂ hw) or w > 0
        if (hw) {
            float n1 = 1.f, n2 = 1.f;
            n1 = (c.n1_row == last_row) ? last_n : __ldg(n_tab + (size_t)c.n1_row * N + i);
            n2 = __ldg(n_tab + (size_t)c.n2_row * N + i);
            last_row = c.n2_row;
            last_n = n2;

            // previous section position: origin of the outline intersection
            const float ppx = px, ppy = py, ppz = pz;

            // standoff advance (hw is true here)
            {
                const bool ok_adv = sz != 0.f;
                const float t0 = (c.z_floor - pz) / (ok_adv ? sz : 1.f);
                if (ok_adv && (t0 > 0.f)) {
                    px = px + t0 * sx;
                    py = py + t0 * sy;
                    pz = pz + t0 * sz;
                }
            }

            float t;
            bool valid;
            if (c.is_flat) {
                const bool sz_ok = sz != 0.f;
                t = sz_ok ? (-pz / (sz_ok ? sz : 1.f)) : INFINITY;
                valid = isfinite(t) && (t >= -C_EPS);
            } else {
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
                const float t_lin = -C / (2.f * (okB ? B : 1.f));
                const bool lin = !okA && okB;
                t1 = lin ? t_lin : t1;
                t2 = lin ? t_lin : t2;

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
                const float stp = clampf(Qv / (okp ? Qp : 1.f), -1e-3f, 1e-3f);
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
            const bool sz_ok = sz != 0.f;
            const float t_zmax = sz_ok ? ((c.z_max - pz) / (sz_ok ? sz : 1.f)) : 0.f;
            t_safe = (bad && !beh) ? t_zmax : t_safe;
            t_safe = beh ? 0.f : t_safe;
            const bool ok = !(bad || beh);

            px = px + t_safe * sx;
            py = py + t_safe * sy;
            pz = pz + t_safe * sz;
            const float r2h = px * px + py * py;

            const bool hit = (r2h <= c.r_ap2) && ok;
            miss = !hit;
            if (miss) w = 0.f;

            // normal
            float nx, ny, nz;
            if (c.is_flat) {
                nx = 0.f; ny = 0.f; nz = 1.f;
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
            const float f = Nq * ns - W;
            const float sx_ = sx * Nq - nx * f;
            const float sy_ = sy * Nq - ny * f;
            const float sz_ = sz * Nq - nz * f;

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
                float A_ts = psx * qx + psy * qy + psz * qz;
                float A_tp = bx * qx + by * qy + bz * qz;
                A_ts = changed ? A_ts : INV_SQRT2;
                A_tp = changed ? A_tp : INV_SQRT2;
                const float bx_ = psy * sz_ - psz * sy_;
                const float by_ = psz * sx_ - psx * sz_;
                const float bz_ = psx * sy_ - psy * sx_;
                if (upd && changed) {
                    qx = psx * A_ts + bx_ * A_tp;
                    qy = psy * A_ts + by_ * A_tp;
                    qz = psz * A_ts + bz_ * A_tp;
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
            n_tir = tir && hit;
            if (upd) { sx = sx_; sy = sy_; sz = sz_; }

            // outline-box kill, intersected from the previous position
            const bool inside = (c.out[0] < px) && (px < c.out[1])
                             && (c.out[2] < py) && (py < c.out[3])
                             && (c.out[4] < pz) && (pz < c.out[5]);
            outl = !inside && (w > 0.f);
            if (outl) {
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

        // per-step counts: one ballot per counter, one atomic per warp
        const unsigned b_miss = __ballot_sync(0xffffffffu, miss);
        const unsigned b_tir = __ballot_sync(0xffffffffu, n_tir);
        const unsigned b_out = __ballot_sync(0xffffffffu, outl);
        if (lane == 0) {
            if (b_miss) atomicAdd(counts + 4 * j + 0, __popc(b_miss));
            if (b_tir) atomicAdd(counts + 4 * j + 1, __popc(b_tir));
            if (b_out) atomicAdd(counts + 4 * j + 2, __popc(b_out));
        }

        if (STORE && active) {
            // sections are absolute; the carried state stays in the
            // surface's frame
            const size_t r = (size_t)j * N + i;
            ys_p[3 * r] = px + c.ox;
            ys_p[3 * r + 1] = py + c.oy;
            ys_p[3 * r + 2] = pz + c.oz;
            ys_w[r] = w;
            if (POL) {
                ys_pol[3 * r] = qx;
                ys_pol[3 * r + 1] = qy;
                ys_pol[3 * r + 2] = qz;
            }
        }
    }

    if (active) {
        p_out[3 * i] = px; p_out[3 * i + 1] = py; p_out[3 * i + 2] = pz;
        s_out[3 * i] = sx; s_out[3 * i + 1] = sy; s_out[3 * i + 2] = sz;
        w_out[i] = w;
        if (POL) { pol_out[3 * i] = qx; pol_out[3 * i + 1] = qy; pol_out[3 * i + 2] = qz; }
    }
}

// Launches the run on `stream`. Allocates nothing and does not synchronise.
// `counts` (L, 4) int32 must be zero on entry. Returns cudaGetLastError().
extern "C" int conic_run_launch(
    const void* p_in, const void* s_in, const void* w_in, const void* pol_in,
    const void* n_tab, const void* steps, int L, long long N,
    void* p_out, void* s_out, void* w_out, void* pol_out, void* counts,
    void* ys_p, void* ys_w, void* ys_pol,
    int with_pol, int store, void* stream)
{
    if (N <= 0 || L <= 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    const size_t smem = (size_t)L * sizeof(Step);
    cudaStream_t st = (cudaStream_t)stream;
#define OT_LAUNCH(POL, STORE)                                                     \
    conic_run_kernel<POL, STORE><<<blocks, threads, smem, st>>>(                   \
        (const float*)p_in, (const float*)s_in, (const float*)w_in,               \
        (const float*)pol_in, (const float*)n_tab, (const Step*)steps, L, N,      \
        (float*)p_out, (float*)s_out, (float*)w_out, (float*)pol_out,             \
        (int*)counts, (float*)ys_p, (float*)ys_w, (float*)ys_pol)
    if (with_pol) { if (store) OT_LAUNCH(true, true); else OT_LAUNCH(true, false); }
    else          { if (store) OT_LAUNCH(false, true); else OT_LAUNCH(false, false); }
#undef OT_LAUNCH
    return (int)cudaGetLastError();
}

extern "C" int conic_run_step_bytes(void) { return (int)sizeof(Step); }
