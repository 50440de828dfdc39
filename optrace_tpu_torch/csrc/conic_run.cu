// Whole-run trace kernel: L consecutive trace steps for every ray in one
// launch, ray state in registers.
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_run.py:conic_run_pallas
// (step body _one_step, outline kill _outline_block). It computes the same
// step (trace_step.cuh): frame shift, standoff advance, hit solve by kind
// (plane; conic Citardauq root pair + one guarded Newton polish; even asphere
// by an Illinois bracketed solve of 40 iterations, left early once no later
// iteration can change the result; tilted plane with a constant
// normal), abnormal-hit clamp, then either aperture mask, miss kill, normal,
// Snell + Fresnel (no-pol A² = ½, or s/p polarization transport) and TIR
// kill, or the absorb mask of a fused aperture (circle, ring, rectangle,
// slit); outline-box kill, per-step counts [miss, tir, outline, ill], and
// optionally the per-step absolute positions, weights and polarizations.
//
// Design for Hopper: one thread per ray; p, s, w (and pol) live in registers
// for the whole run; the per-step parameters are a small table staged in
// shared memory (read uniformly by every thread, so the branch on the step
// kind never diverges inside a warp), followed by a coefficient region that
// holds the polynomial of each asphere step; media are read from the
// unique-media table n_tab (M, N) through a per-step row index, so a ray
// reads each medium value once per use instead of a gathered (L, 2, N) copy
// (an absorb step reads none); counts are reduced with
// __ballot_sync/__popc per warp and one integer atomicAdd per warp, step and
// non-zero counter (exact at any N); sections leave with streaming stores,
// since the kernel never reads one back. They leave section by section: step
// j of the run is row j of ys_p (L, N, 3), ys_w and ys_n (L, N) and ys_pol
// (L, N, 3), one coalesced store a warp and word, which is the TPU kernel's
// layout and also the columns of the trace's section-major buffers
// (ops/cuda_run.py:SectionSlots, whose (N, nt, 3) is the transpose of a
// contiguous (nt, N, 3)): the wrapper passes the run's first column, so the
// trace needs no restacking. Laid out ray by ray instead ((N, nt, 3)
// contiguous), a warp's 32 rays are a row of nt sections apart and every
// store falls into 32 sectors written in part; staged in shared memory that
// took 2.0 × this layout's time on the stack's run of 56 (PERF.md). With
// ys_n the kernel also writes each step's medium n₂ (at an absorb step the
// ambient row, which the step itself does not read). The kernel is
// instantiated twice over the step kinds: a run of flat and conic refractions alone (most runs
// of most lens systems) takes the instantiation without the asphere solve,
// the tilted plane and the absorb masks, which needs fewer registers (40 to
// 48 against 51 to 60) and is about 9 % faster at 56 steps.
//
// Bound by the table of peaks: per ray the kernel must move 28 B in + 28 B
// out of state (40 + 40 with pol), 4·M B of media (M: the rows of n_tab that
// the run's steps name, not all the table holds) and, when sections are
// stored, 16 B (28 B with pol) per step, 4 B more with n; a flat, conic or
// tilted step is on the order of 150 f32 operations per ray, an asphere step
// about 1700 as it is defined (42 evaluations of the sag, each a square root,
// a division and a Horner polynomial, and 40 bracket updates; the kernel
// does about a third of them, see trace_step.cuh), an absorb step about 60. At N = 10⁶, L = 56
// conic steps with stored sections that is about 0.9 GB against about
// 8 GFLOP, so on an H100 (3.35 TB/s, 67 TFLOP/s f32) the memory side is the
// tighter bound; the no-store form moves under 0.1 GB and is bound by its
// operations, and so is a run of asphere steps even with stored sections.
//
// What bounds it on the card is neither: it is the rate at which an SM issues
// instructions. The arithmetic contract below makes every division and square
// root the IEEE sequence (a reciprocal estimate, Newton steps and a residual
// correction: about a dozen instructions each) and splits every multiply-add,
// so a conic step is about 470 instructions a ray for its 150 operations, and
// at 56 steps and 10⁶ rays the measured time is what 132 SMs need to issue
// them at four warp-instructions a clock. More warps in flight, other launch
// bounds or a step table in the constant bank instead of shared memory (tried:
// the compiler turns the uniform loads into indexed LDC one for one, no
// gain) cannot help; fewer instructions can, and within the contract
// those are the ones whose result no bit depends on (trace_step.cuh). Tensor
// cores, TMA and clusters have nothing to offer: there is no matrix product,
// and no tile that two threads share.
//
// Arithmetic contract: every operation is a separate IEEE f32 add, mul, div
// or sqrt in the order of the plain PyTorch version
// (ops/cuda_run.py:conic_run_reference). Compile WITHOUT --use_fast_math and
// with -fmad=false, so that kernel and plain version make the same hit/miss
// decisions. Non-finite values are part of the contract: t = ±inf and NaN
// flow into `valid = false` through isfinite and ordered comparisons.

#include "trace_step.cuh"

template <bool POL, bool STORE, bool ALL_KINDS>
__global__ void __launch_bounds__(256) conic_run_kernel(
    const float* __restrict__ p_in, const float* __restrict__ s_in,
    const float* __restrict__ w_in, const float* __restrict__ pol_in,
    const float* __restrict__ n_tab, const int* __restrict__ table_g,
    int L, int table_words, long long N,
    float* __restrict__ p_out, float* __restrict__ s_out,
    float* __restrict__ w_out, float* __restrict__ pol_out,
    int* __restrict__ counts,
    float* __restrict__ ys_p, float* __restrict__ ys_w,
    float* __restrict__ ys_pol, float* __restrict__ ys_n)
{
    // the step table: L Step structs, then the coefficient region
    extern __shared__ int table[];
    for (int q = threadIdx.x; q < table_words; q += blockDim.x) table[q] = table_g[q];
    __syncthreads();
    const Step* steps = reinterpret_cast<const Step*>(table);
    const float* coef = reinterpret_cast<const float*>(steps + L);

    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = i < N;
    const int lane = threadIdx.x & 31;

    RayState r;
    r.px = 0.f; r.py = 0.f; r.pz = 0.f; r.sx = 0.f; r.sy = 0.f; r.sz = 1.f; r.w = 0.f;
    r.qx = 0.f; r.qy = 0.f; r.qz = 0.f;
    if (active) {
        r.px = p_in[3 * i]; r.py = p_in[3 * i + 1]; r.pz = p_in[3 * i + 2];
        r.sx = s_in[3 * i]; r.sy = s_in[3 * i + 1]; r.sz = s_in[3 * i + 2];
        r.w = w_in[i];
        if (POL) { r.qx = pol_in[3 * i]; r.qy = pol_in[3 * i + 1]; r.qz = pol_in[3 * i + 2]; }
    }

    int last_row = -1;      // medium row whose value is still in a register
    float last_n = 1.f;

    for (int j = 0; j < L; ++j) {
        const Step& c = steps[j];

        // frame shift into this surface's vertex frame (dead rays too)
        r.px = r.px - c.dx;
        r.py = r.py - c.dy;
        r.pz = r.pz - c.dz;

        StepFlags f;
        f.miss = false; f.tir = false; f.outl = false; f.ill = false;

        // a dead ray takes only the frame shift: every update of the step
        // is masked by hw, hit (⊂ hw) or w > 0
        const bool alive = r.w > 0.f;
        const unsigned lanes = __ballot_sync(0xffffffffu, alive);
        if (alive) {
            float n1 = 1.f, n2 = 1.f;
            if (!ALL_KINDS || c.action == ACT_REFRACT) {
                // an absorb step reads no medium and leaves the cached row
                n1 = (c.n1_row == last_row) ? last_n : __ldg(n_tab + (size_t)c.n1_row * N + i);
                n2 = __ldg(n_tab + (size_t)c.n2_row * N + i);
                last_row = c.n2_row;
                last_n = n2;
            }
            trace_step<POL, true, ALL_KINDS>(c, coef, lanes, n1, n2, r, f);
        }

        // per-step counts: one ballot per counter, one atomic per warp
        const unsigned b_miss = __ballot_sync(0xffffffffu, f.miss);
        const unsigned b_tir = __ballot_sync(0xffffffffu, f.tir);
        const unsigned b_out = __ballot_sync(0xffffffffu, f.outl);
        const unsigned b_ill = __ballot_sync(0xffffffffu, f.ill);
        if (lane == 0) {
            if (b_miss) atomicAdd(counts + 4 * j + 0, __popc(b_miss));
            if (b_tir) atomicAdd(counts + 4 * j + 1, __popc(b_tir));
            if (b_out) atomicAdd(counts + 4 * j + 2, __popc(b_out));
            if (b_ill) atomicAdd(counts + 4 * j + 3, __popc(b_ill));
        }

        if (STORE && active) {
            // sections are absolute; the carried state stays in the
            // surface's frame. The kernel never reads a section back:
            // streaming stores keep them from evicting the media rows
            const size_t row = (size_t)j * N + i;
            __stcs(ys_p + 3 * row, r.px + c.ox);
            __stcs(ys_p + 3 * row + 1, r.py + c.oy);
            __stcs(ys_p + 3 * row + 2, r.pz + c.oz);
            __stcs(ys_w + row, r.w);
            if (POL) {
                __stcs(ys_pol + 3 * row, r.qx);
                __stcs(ys_pol + 3 * row + 1, r.qy);
                __stcs(ys_pol + 3 * row + 2, r.qz);
            }
            if (ys_n) {
                // the medium after the step: the row the step read, or at an
                // absorb step (and for a dead ray) read here
                if (c.n2_row != last_row) {
                    last_row = c.n2_row;
                    last_n = __ldg(n_tab + (size_t)c.n2_row * N + i);
                }
                __stcs(ys_n + row, last_n);
            }
        }
    }

    if (active) {
        p_out[3 * i] = r.px; p_out[3 * i + 1] = r.py; p_out[3 * i + 2] = r.pz;
        s_out[3 * i] = r.sx; s_out[3 * i + 1] = r.sy; s_out[3 * i + 2] = r.sz;
        w_out[i] = r.w;
        if (POL) { pol_out[3 * i] = r.qx; pol_out[3 * i + 1] = r.qy; pol_out[3 * i + 2] = r.qz; }
    }
}

// Launches the run on `stream`. Allocates nothing and does not synchronise.
// `table` holds L Step structs followed by the coefficient region,
// `table_words` 32-bit words in all (at most 48 KB: static-limit shared
// memory). `all_kinds` = 0 promises that every step is a refraction on a
// flat disc or a conic and takes the smaller instantiation. `counts` (L, 4)
// int32 must be zero on entry. With `store` the sections go to ys_p, ys_w,
// ys_pol and, where ys_n is not null, ys_n, step j at row j. Returns
// cudaGetLastError().
extern "C" int conic_run_launch(
    const void* p_in, const void* s_in, const void* w_in, const void* pol_in,
    const void* n_tab, const void* table, int L, int table_words, long long N,
    void* p_out, void* s_out, void* w_out, void* pol_out, void* counts,
    void* ys_p, void* ys_w, void* ys_pol, void* ys_n,
    int with_pol, int store, int all_kinds, void* stream)
{
    if (N <= 0 || L <= 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    const size_t smem = (size_t)table_words * sizeof(int);
    cudaStream_t st = (cudaStream_t)stream;
#define OT_LAUNCH(POL, STORE, ALL)                                                \
    conic_run_kernel<POL, STORE, ALL><<<blocks, threads, smem, st>>>(              \
        (const float*)p_in, (const float*)s_in, (const float*)w_in,               \
        (const float*)pol_in, (const float*)n_tab, (const int*)table, L,          \
        table_words, N,                                                           \
        (float*)p_out, (float*)s_out, (float*)w_out, (float*)pol_out,             \
        (int*)counts, (float*)ys_p, (float*)ys_w, (float*)ys_pol, (float*)ys_n)
#define OT_LAUNCH_KINDS(POL, STORE)                                               \
    do { if (all_kinds) OT_LAUNCH(POL, STORE, true); else OT_LAUNCH(POL, STORE, false); } while (0)
    if (with_pol) { if (store) OT_LAUNCH_KINDS(true, true); else OT_LAUNCH_KINDS(true, false); }
    else          { if (store) OT_LAUNCH_KINDS(false, true); else OT_LAUNCH_KINDS(false, false); }
#undef OT_LAUNCH_KINDS
#undef OT_LAUNCH
    return (int)cudaGetLastError();
}

extern "C" int conic_run_step_bytes(void) { return (int)sizeof(Step); }
