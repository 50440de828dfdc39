// Detector binning kernel: weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w).
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_binning.py:bin_xyzw_pallas
// (body _bin_kernel), which reduces one-hot × values products on the matrix
// unit in O(bins · rays) work. Here one pass over the rays does the bin index
// (ops/binning.py:binning_indices_2d: floor(N/s·(x − x0)), the inclusive
// positive edge, outside → weight 0), the CIE observer lookup (uniform 1 nm
// table with zero padding, staged in shared memory) and four f32 atomic adds
// into the (Ny·Nx, 4) image. Rays whose masked weight is 0 (dead rays, rays
// outside the extent) add nothing and are skipped.
//
// Bound: the kernel must read 16 B per ray and write the image once
// (Ny·Nx·16 B); at N = 10⁶ and 945² that is 30 MB, about 9 µs at 3.35 TB/s
// on an H100, against about 30 f32 operations per ray: bytes are the bound.
// The image (14.3 MB at 945²) stays in the 50 MB L2, where the atomics are
// resolved.
//
// What the time really depends on is how many atomics meet on one address.
// Rays spread over the image hardly ever do; the image of a point (the double
// Gauss at focus) puts all 10⁶ rays into a few pixels, and then the atomics
// serialise. So a warp first looks at its own keys (__match_any_sync): when
// its 32 rays fall into at most WARP_GROUPS pixels, each pixel's values are
// summed across the warp with shuffles and added with one atomic per pixel
// and channel; otherwise every ray adds for itself.
//
// Sums are taken in the order the atomics arrive, so the image differs from
// the plain version's by f32 summation order, and from run to run.

#include <cuda_runtime.h>
#include <math.h>

#define OBS_MAX 512     // padded observer table entries per channel
#define WARP_GROUPS 8   // distinct pixels in a warp up to which the warp sums before it adds

__global__ void bin_xyzw_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ w, const float* __restrict__ wl, long long N,
    const float* __restrict__ obs, int n_obs, float wl0, float wl1,
    float x0, float x1, float y0, float y1, float scale_x, float scale_y,
    int Nx, int Ny, float* __restrict__ img)
{
    __shared__ float tab[3 * OBS_MAX];
    for (int q = threadIdx.x; q < 3 * n_obs; q += blockDim.x) {
        tab[(q / n_obs) * OBS_MAX + (q % n_obs)] = obs[q];
    }
    __syncthreads();

    // no early return: every lane takes part in the warp votes below
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int key = -1;                       // pixel index, −1: nothing to add
    float vx = 0.f, vy = 0.f, vz = 0.f, vw = 0.f;
    if (i < N) {
        const float x = px[i], y = py[i];
        float fx = floorf(scale_x * (x - x0));
        float fy = floorf(scale_y * (y - y0));
        if (x == x1) fx = (float)(Nx - 1);
        if (y == y1) fy = (float)(Ny - 1);
        const bool inside = (fx >= 0.f) && (fy >= 0.f) && (fy < (float)Ny) && (fx < (float)Nx);
        const float wm = inside ? w[i] : 0.f;
        if (wm != 0.f) {
            // observer lookup: linear interpolation on the 1 nm grid; the
            // table has one zero entry before its first and after its last
            // wavelength
            const float lam = wl[i];
            const float g = lam - wl0;
            float ox = 0.f, oy = 0.f, oz = 0.f;
            if ((g >= 0.f) && (lam <= wl1)) {
                const float idx = floorf(g);
                const float frac = g - idx;
                int i0 = (int)idx + 1;
                i0 = min(max(i0, 0), n_obs - 2);
                const float a = 1.f - frac;
                ox = tab[i0] * a + tab[i0 + 1] * frac;
                oy = tab[OBS_MAX + i0] * a + tab[OBS_MAX + i0 + 1] * frac;
                oz = tab[2 * OBS_MAX + i0] * a + tab[2 * OBS_MAX + i0 + 1] * frac;
            }
            key = (int)fy * Nx + (int)fx;
            vx = ox * wm; vy = oy * wm; vz = oz * wm; vw = wm;
        }
    }

    const unsigned FULL = 0xffffffffu;
    const unsigned peers = __match_any_sync(FULL, key);
    const bool leader = (key >= 0) && (lane == __ffs(peers) - 1);
    unsigned todo = __ballot_sync(FULL, leader);        // one bit per distinct pixel
    if (todo == 0u) return;

    if (__popc(todo) > WARP_GROUPS) {
        if (key >= 0) {
            float* dst = img + 4 * (size_t)key;
            atomicAdd(dst + 0, vx);
            atomicAdd(dst + 1, vy);
            atomicAdd(dst + 2, vz);
            atomicAdd(dst + 3, vw);
        }
        return;
    }
    // few distinct pixels: one warp sum and one set of atomics per pixel
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int k = __shfl_sync(FULL, key, src);
        const bool mine = key == k;
        float a = mine ? vx : 0.f, b = mine ? vy : 0.f, c = mine ? vz : 0.f, d = mine ? vw : 0.f;
        for (int off = 16; off > 0; off >>= 1) {
            a += __shfl_xor_sync(FULL, a, off);
            b += __shfl_xor_sync(FULL, b, off);
            c += __shfl_xor_sync(FULL, c, off);
            d += __shfl_xor_sync(FULL, d, off);
        }
        if (lane == src) {
            float* dst = img + 4 * (size_t)k;
            atomicAdd(dst + 0, a);
            atomicAdd(dst + 1, b);
            atomicAdd(dst + 2, c);
            atomicAdd(dst + 3, d);
        }
    }
}

// Accumulates into `img` (Ny, Nx, 4) on `stream`. Allocates nothing and does
// not synchronise. Returns cudaGetLastError(), or -1 for a table too large.
extern "C" int bin_xyzw_launch(
    const void* px, const void* py, const void* w, const void* wl, long long N,
    const void* obs, int n_obs, float wl0, float wl1,
    float x0, float x1, float y0, float y1, float scale_x, float scale_y,
    int Nx, int Ny, void* img, void* stream)
{
    if (n_obs > OBS_MAX || n_obs < 2) return -1;
    if (N <= 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((N + threads - 1) / threads);
    bin_xyzw_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)px, (const float*)py, (const float*)w, (const float*)wl, N,
        (const float*)obs, n_obs, wl0, wl1, x0, x1, y0, y1, scale_x, scale_y,
        Nx, Ny, (float*)img);
    return (int)cudaGetLastError();
}
