// Wavelengths of an RGB image source: the colour path of source sampling,
// from each ray's pixel and two uniforms to one wavelength, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this map to XLA
// (optrace_tpu/color/srgb.py:random_wavelengths_from_srgb), which fuses it.
// The port's plain route (color/srgb.py:wavelengths_from_srgb on the
// gathered pixels) runs it as dozens of small PyTorch launches a batch; this
// kernel is that route in one, and equals it bit for bit on the card. Per
// ray, in the plain route's order of f32 operations:
//   - the pixel's sRGB triple, gathered from the image's (Iy·Ix, 3) table at
//     the flat index P;
//   - srgb_to_srgb_linear of each channel (odd-extended: the sign times
//     ((|v| + 0.055) / 1.055)^2.4, or v / 12.92 where |v| <= 0.04045), times
//     the channel's power factor;
//   - the running sums c0 = r, c1 = r + g, c2 = c1 + b, c0 and c1 each over
//     c2 where c2 > 0 (else over 1), and the primary: red where
//     choice < c0 / c2, blue where choice > c1 / c2, else green;
//   - u through the chosen primary's inverse CDF, tabulated at M points
//     of u in [0, 1] (ops/interp.py:uniform_interp: floor, clamp to the
//     last cell, the fraction taken from the clamped cell, a linear blend,
//     and the ends `left` and `right` outside the table).
// The plain route looks u up in all three tables and selects; this kernel
// looks it up in the chosen one alone, which gives the same value.
//
// PyTorch on the card divides an f32 tensor by a Python number d as a
// product with the reciprocal taken in f64 and rounded once, (float)(1 / d)
// (PyTorch 2.11 on an H100: 0 of 10⁶ products differ; 1.0f / (float)d
// differs in 78 % of them for d = 1.055). The plain route divides by 1.055,
// 12.92 and 1 / (M − 1) so; the launcher forms the three reciprocals on the
// host as PyTorch does, and the kernel multiplies by them. Its additions,
// products, powf and comparisons with Python numbers are the f32 operations
// with the number rounded to f32.
//
// Design for Hopper: one thread per ray. A ray reads its index and two
// uniforms, gathers 12 B of the image table and two entries of one inverse
// CDF, and writes one f32. The image table (a ColorChecker chart 74 kB, a
// 4K image 100 MB) and the three tables (48 kB) are read through the
// read-only cache; the tables stay in L1 and L2.
//
// Bound: 20 B a ray in and out (8 B index, two 4 B uniforms, 4 B
// wavelength) against about 40 f32 operations and three powf: at
// N = 10⁶, 20 MB, about 6 µs at 3.35 TB/s on an H100. The bytes bound it.
//
// Arithmetic contract: no --use_fast_math and -fmad=false (ops/_build.py),
// so every operation is the IEEE f32 operation of the plain route; powf is
// the function PyTorch's pow of an f32 tensor by a Python number calls.

#include <cuda_runtime.h>

__device__ __forceinline__ float srgb_to_linear(float v, float inv_1p055, float inv_12p92)
{
    const float a = fabsf(v);
    if (a <= 0.04045f) return v * inv_12p92;
    const float sign = (0.f < v) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
    return sign * powf((a + 0.055f) * inv_1p055, 2.4f);
}

__global__ void srgb_wavelengths_kernel(
    const long long* __restrict__ P, const float* __restrict__ choice,
    const float* __restrict__ u, long long N, const float* __restrict__ pix,
    const float* __restrict__ factors, const float* __restrict__ tables, int M,
    float inv_1p055, float inv_12p92, float inv_dx, float left, float right,
    float* __restrict__ out)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;

    const float* px = pix + 3 * P[i];
    const float r = srgb_to_linear(px[0], inv_1p055, inv_12p92) * factors[0];
    const float g = srgb_to_linear(px[1], inv_1p055, inv_12p92) * factors[1];
    const float b = srgb_to_linear(px[2], inv_1p055, inv_12p92) * factors[2];
    const float c1 = r + g;
    const float c2 = c1 + b;
    const float last = (c2 > 0.f) ? c2 : 1.f;
    const float ch = choice[i];
    const int k = (ch < r / last) ? 0 : ((ch > c1 / last) ? 2 : 1);

    // uniform_interp(u, table_k, 0, 1 / (M - 1), left, right); u − 0 is u
    const float* t = tables + (long long)k * M;
    const float x = u[i] * inv_dx;
    const float cell = fminf(fmaxf(floorf(x), 0.f), (float)(M - 2));
    const float frac = x - cell;
    const int i0 = (int)cell;
    float v = t[i0] * (1.f - frac) + t[i0 + 1] * frac;
    if (x < 0.f) v = left;
    if (x > (float)(M - 1)) v = right;
    out[i] = v;
}

// Launches the kernel on `stream` for N rays. P: (N,) int64 flat pixel
// indices into pix, each in range (the caller's duty: the kernel does not
// check them); choice, u: (N,) f32; pix: (pixels, 3) f32 sRGB; factors: (3,)
// f32; tables: (3, M) f32, M >= 2; out: (N,) f32. Allocates nothing and
// does not synchronise. Returns cudaGetLastError().
extern "C" int srgb_wavelengths_launch(
    const void* P, const void* choice, const void* u, long long N, const void* pix,
    const void* factors, const void* tables, int M, float left, float right,
    void* out, void* stream)
{
    if (N <= 0) return 0;
    // the reciprocals of PyTorch's division by a Python number: in f64, rounded once
    const float inv_1p055 = (float)(1.0 / (1.0 + 0.055));
    const float inv_12p92 = (float)(1.0 / 12.92);
    const float inv_dx = (float)(1.0 / (1.0 / (double)(M - 1)));
    const int threads = 256;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    srgb_wavelengths_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)P, (const float*)choice, (const float*)u, N, (const float*)pix,
        (const float*)factors, (const float*)tables, M, inv_1p055, inv_12p92, inv_dx,
        left, right, (float*)out);
    return (int)cudaGetLastError();
}
