// Single-step trace kernel: one fused no-pol conic hit-and-refract step for
// every ray.
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_trace.py:conic_step_pallas
// (step body _step_math): standoff advance, conic root + one guarded Newton
// polish, abnormal-hit clamp, aperture test r² <= r_ap·r_ap, conic normal,
// Snell + Fresnel with A² = ½. It is trace_step<false, false, false> of
// trace_step.cuh, the step function of the whole-run kernel with the frame
// shift, the miss kill, the outline box, the counts, the stored sections and
// the polarization compiled out; the header says why one body gives the bits
// of both TPU step bodies. What differs from a step of a run stays different:
// n1 and n2 are per-ray arrays, the aperture test has no N_EPS (the host
// fills r_ap2 with r_ap·r_ap), a ray that misses keeps its weight and
// direction, and nothing is counted.
//
// Design for Hopper: one thread per ray, the nine inputs read once and the
// seven outputs written once; the step's constants are a kernel argument.
//
// Bound: 36 B in and 28 B out per ray against about 150 f32 operations: at
// N = 10⁶ that is 64 MB and 0.15 GFLOP, so on an H100 (3.35 TB/s, 67 TFLOP/s
// f32) the bytes bound it, at about 0.019 ms. The (N, 3) layout of p and s
// makes each thread's loads 12 B apart; a warp still reads whole lines.
//
// Arithmetic contract: as in trace_step.cuh (no --use_fast_math, -fmad=false).

#include "trace_step.cuh"

__global__ void conic_step_kernel(
    Step c,
    const float* __restrict__ p_in, const float* __restrict__ s_in,
    const float* __restrict__ w_in, const float* __restrict__ n1_in,
    const float* __restrict__ n2_in, long long N,
    float* __restrict__ p_out, float* __restrict__ s_out,
    float* __restrict__ w_out)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;

    RayState r;
    r.px = p_in[3 * i]; r.py = p_in[3 * i + 1]; r.pz = p_in[3 * i + 2];
    r.sx = s_in[3 * i]; r.sy = s_in[3 * i + 1]; r.sz = s_in[3 * i + 2];
    r.w = w_in[i];
    r.qx = 0.f; r.qy = 0.f; r.qz = 0.f;

    // a dead ray is left as it is: every update of the step is masked by
    // hw or hit (⊂ hw)
    if (r.w > 0.f) {
        StepFlags f;
        trace_step<false, false, false>(c, nullptr, 0u, n1_in[i], n2_in[i], r, f);
    }

    p_out[3 * i] = r.px; p_out[3 * i + 1] = r.py; p_out[3 * i + 2] = r.pz;
    s_out[3 * i] = r.sx; s_out[3 * i + 1] = r.sy; s_out[3 * i + 2] = r.sz;
    w_out[i] = r.w;
}

// Launches the step on `stream`. `step` points to one Step on the host.
// Allocates nothing and does not synchronise. Returns cudaGetLastError().
extern "C" int conic_step_launch(
    const void* step, const void* p_in, const void* s_in, const void* w_in,
    const void* n1_in, const void* n2_in, long long N,
    void* p_out, void* s_out, void* w_out, void* stream)
{
    if (N <= 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    conic_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        *reinterpret_cast<const Step*>(step),
        (const float*)p_in, (const float*)s_in, (const float*)w_in,
        (const float*)n1_in, (const float*)n2_in, N,
        (float*)p_out, (float*)s_out, (float*)w_out);
    return (int)cudaGetLastError();
}

extern "C" int conic_step_step_bytes(void) { return (int)sizeof(Step); }
