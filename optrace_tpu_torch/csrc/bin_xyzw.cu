// Detector binning kernel: weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w).
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_binning.py:bin_xyzw_pallas
// (body _bin_kernel), which reduces one-hot × values products on the matrix
// unit in O(bins · rays) work. Here one pass over the rays does the bin index
// (ops/binning.py:binning_indices_2d: floor(N/s·(x − x0)), the inclusive
// positive edge, outside → weight 0), the CIE observer lookup (uniform 1 nm
// table with zero padding) and the sum into the (Ny·Nx, 4) image. Rays whose
// masked weight is 0 (dead rays, rays outside the extent) add nothing.
//
// Bound: the kernel must read 16 B per ray and write the image once
// (Ny·Nx·16 B); at N = 10⁶ and 945² that is 30 MB, about 9 µs at 3.35 TB/s
// on an H100, against about 30 f32 operations per ray: bytes are the bound.
// The image (14.3 MB at 945²) stays in the 50 MB L2, where the atomics are
// resolved.
//
// What the time really depends on is neither: it is the number of atomic
// operations and how many of them meet on one address. Rays spread over the
// image never meet, and then every instruction spent looking for duplicates
// is lost; the image of a point (the double Gauss at focus) puts 8 of 10
// rays into one pixel and the rest into 20 more, and the L2 takes the
// read-modify-writes of one address one after the other. The design, in the
// order of a ray's way through it:
//   - A persistent grid (at most BIN_BLOCKS_PER_SM blocks an SM) strides over
//     the rays; a warp takes 128 neighbours a turn with 16 coalesced streaming
//     loads in flight a thread, in four votes of 32 neighbours each, so that
//     sorted or clustered rays vote "one pixel". The observer table is staged
//     once a block in shared memory: lanes index it at random, and the
//     constant bank would serialise them.
//   - Duplicates are found without __match_any_sync, which takes one round
//     per distinct key and so up to 32 rounds to learn that nothing can be
//     combined. A minimum and a maximum over the warp's live keys are one
//     instruction each (__reduce_min_sync, __reduce_max_sync). Equal: the
//     warp is one pixel, one shuffle sum. Otherwise the warp first sums the
//     rays of the pixel it accumulates already (one ballot), then looks for
//     partners: every live lane writes its number into a 64-entry table of
//     the warp in shared memory at the hash of its pixel and reads the entry
//     back; the number that stays is the pixel's leader, and a lane that
//     finds another lane there with its own key has a partner. One store, one
//     load, one shuffle and one ballot tell a vote of 32 spread rays that
//     nothing can be combined; where partners exist, at most BIN_PEEL groups
//     are summed with shuffles, and what is left adds for itself. (A first
//     form took the key of the first live lane as the candidate: on two hot
//     pixels among spread rays that lane is a lone ray every other time, the
//     warps claimed their accumulators late, and the input took 0.134 ms
//     where the table takes 0.037.)
//   - A sum goes into the warp's accumulator (BIN_WARP_SLOTS of them, in the
//     registers of every lane alike, claimed by the first groups the warp
//     sums) or, when that holds another pixel, into the image. At the block's
//     end the warps' accumulators meet in shared memory, one entry a lane of
//     the first warp, which sums equal pixels once more. No shared-memory
//     atomic is used: an f32 add there is a compare-and-swap loop, and eight
//     warps that meet on one accumulator spin in it (a first version with
//     such accumulators took 0.041 ms on clustered rays where this one takes
//     0.021). The global atomics that meet on the pixel of a focused spot
//     fall from one a warp to one a block.
//   - A pixel is 16 B, and compute capability 9.x adds a float4 to global
//     memory in one reduction (atomicAdd(float4*, float4)): one operation a
//     ray or group instead of four. The image must be 16-byte aligned.
//   The three constants were chosen by tools/tune_binning.py on an NVIDIA
//   H100 80GB HBM3 at 700.00 W, the card of every time in this note (36
//   combinations, five inputs, 10⁶ rays): one accumulator a warp beats two and four on
//   spread and clustered rays (registers: 0.0122 / 0.0137 / 0.0164 ms spread)
//   and loses on two hot pixels (0.037 / 0.022 / 0.023 ms); two groups a vote
//   beat one on the focused spot and on two hot pixels (0.045 against
//   0.052 ms, 0.037 against 0.061) and three or four on clustered rays (0.021
//   against 0.024 and 0.027); four blocks an SM beat two and eight (0.0207
//   against 0.0263 and 0.0220 ms clustered). Loads of 16 bytes (a lane's four rays neighbours, so that a
//   vote's rays lie four apart) bought nothing on spread rays (0.0121 against
//   0.0120 ms) and are not kept. Tensor cores, TMA and clusters have nothing
//   to offer: there is no matrix product and no tile that is used twice.
//
// Sums are taken in the order the atomics arrive, so the image differs from
// the plain version's by f32 summation order, and from run to run.

#include <cuda_runtime.h>
#include <math.h>

#define OBS_MAX 512     // padded observer table entries per channel
#ifndef BIN_WARP_SLOTS
#define BIN_WARP_SLOTS 1    // pixels a warp accumulates in registers
#endif
#ifndef BIN_PEEL
#define BIN_PEEL 2      // groups a vote sums before the rest add alone
#endif
#define BIN_HASH 64     // entries of a warp's table of pixel leaders (a power of two)
#ifndef BIN_BLOCKS_PER_SM
#define BIN_BLOCKS_PER_SM 4
#endif
#define BIN_THREADS 256
#define BIN_WARPS (BIN_THREADS / 32)
#define BIN_TILE 128        // rays a warp takes a turn: 4 votes of 32 rays
#define DEAD 0xffffffffu    // key of a lane with nothing to add
#define FULL 0xffffffffu

static_assert(BIN_WARPS * BIN_WARP_SLOTS <= 32, "the block's accumulators are merged by one warp");

__device__ __forceinline__ void add_global(float* img, unsigned key, float a, float b, float c, float d)
{
    atomicAdd(reinterpret_cast<float4*>(img) + key, make_float4(a, b, c, d));
}

// Sum over the lanes of `m` (not empty); every lane gets the sums.
__device__ __forceinline__ void warp_sum4(unsigned m, int lane, float& a, float& b, float& c, float& d)
{
    if ((m & (m - 1u)) == 0u) {         // one lane: hand its values round
        const int src = __ffs(m) - 1;
        a = __shfl_sync(FULL, a, src); b = __shfl_sync(FULL, b, src);
        c = __shfl_sync(FULL, c, src); d = __shfl_sync(FULL, d, src);
        return;
    }
    const bool mine = (m >> lane) & 1u;
    a = mine ? a : 0.f; b = mine ? b : 0.f; c = mine ? c : 0.f; d = mine ? d : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        b += __shfl_xor_sync(FULL, b, off);
        c += __shfl_xor_sync(FULL, c, off);
        d += __shfl_xor_sync(FULL, d, off);
    }
}

// A warp's accumulators: the same values in the registers of every lane.
struct WarpSlots {
    unsigned key[BIN_WARP_SLOTS];
    float acc[BIN_WARP_SLOTS][4];
    int n;
};

// The sum of a group, known to every lane: into the warp's accumulator for
// that pixel or a free one; otherwise lane `src` adds it to the image.
__device__ __forceinline__ void add_warp(
    WarpSlots& ws, int lane, int src, float* img, unsigned key, float a, float b, float c, float d)
{
#pragma unroll
    for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
        if (s < ws.n && ws.key[s] == key) {
            ws.acc[s][0] += a; ws.acc[s][1] += b; ws.acc[s][2] += c; ws.acc[s][3] += d;
            return;
        }
    }
    if (ws.n < BIN_WARP_SLOTS) {
#pragma unroll
        for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
            if (s == ws.n) {
                ws.key[s] = key;
                ws.acc[s][0] = a; ws.acc[s][1] = b; ws.acc[s][2] = c; ws.acc[s][3] = d;
            }
        }
        ws.n += 1;
        return;
    }
    if (lane == src) add_global(img, key, a, b, c, d);
}

// All 32 lanes call this together, each with one ray (key DEAD: none).
// `lead` is the warp's table of pixel leaders, BIN_HASH entries in shared memory.
__device__ __forceinline__ void warp_accumulate(
    WarpSlots& ws, unsigned key, float vx, float vy, float vz, float vw, int lane,
    volatile int* lead, float* img)
{
    const unsigned kmin = __reduce_min_sync(FULL, key);
    if (kmin == DEAD) return;
    const unsigned kmax = __reduce_max_sync(FULL, key == DEAD ? 0u : key);
    if (kmin == kmax) {
        // the warp's live rays are one pixel
        float a = vx, b = vy, c = vz, d = vw;
        warp_sum4(__ballot_sync(FULL, key != DEAD), lane, a, b, c, d);
        add_warp(ws, lane, 0, img, kmin, a, b, c, d);
        return;
    }
    // rays of the pixels that the warp accumulates already
#pragma unroll
    for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
        if (s < ws.n) {
            const bool mine = key == ws.key[s];
            const unsigned m = __ballot_sync(FULL, mine);
            if (m != 0u) {
                float a = vx, b = vy, c = vz, d = vw;
                warp_sum4(m, lane, a, b, c, d);
                ws.acc[s][0] += a; ws.acc[s][1] += b; ws.acc[s][2] += c; ws.acc[s][3] += d;
                if (mine) key = DEAD;
            }
        }
    }
    // which of the other lanes share a pixel: every live lane writes its
    // number into the table at its pixel's hash, and the number that stays is
    // the pixel's leader. A lane that finds another lane's number there and
    // that lane's key equal to its own has a partner (two pixels with one
    // hash hide each other's partners for this vote: they add alone)
    const unsigned h = (key * 2654435761u) >> 26;
    if (key != DEAD) lead[h] = lane;
    __syncwarp();
    const int leader = (key != DEAD) ? lead[h] : lane;
    __syncwarp();
    const unsigned leader_key = __shfl_sync(FULL, key, leader);     // every lane takes part
    const bool partner = (leader != lane) && (leader_key == key);
    unsigned partners = __ballot_sync(FULL, partner);
    for (int r = 0; r < BIN_PEEL && partners != 0u; ++r) {
        const unsigned cand = __shfl_sync(FULL, key, __ffs(partners) - 1);
        const bool mine = key == cand;
        const unsigned m = __ballot_sync(FULL, mine);
        float a = vx, b = vy, c = vz, d = vw;
        warp_sum4(m, lane, a, b, c, d);
        add_warp(ws, lane, __ffs(m) - 1, img, cand, a, b, c, d);
        if (mine) key = DEAD;
        partners &= ~m;
    }
    if (key != DEAD) add_global(img, key, vx, vy, vz, vw);
}

struct BinArgs {
    int n_obs;
    float wl0, wl1;
    float x0, x1, y0, y1, scale_x, scale_y;
    int Nx, Ny;
};

// Pixel index and values of one ray; DEAD when it adds nothing.
__device__ __forceinline__ unsigned ray_value(
    const BinArgs& g, const float* tab, float x, float y, float w, float lam,
    float& vx, float& vy, float& vz, float& vw)
{
    float fx = floorf(g.scale_x * (x - g.x0));
    float fy = floorf(g.scale_y * (y - g.y0));
    if (x == g.x1) fx = (float)(g.Nx - 1);
    if (y == g.y1) fy = (float)(g.Ny - 1);
    const bool inside = (fx >= 0.f) && (fy >= 0.f) && (fy < (float)g.Ny) && (fx < (float)g.Nx);
    const float wm = inside ? w : 0.f;
    vx = 0.f; vy = 0.f; vz = 0.f; vw = 0.f;
    if (!(wm != 0.f)) return DEAD;
    // observer lookup: linear interpolation on the 1 nm grid; the table has
    // one zero entry before its first and after its last wavelength
    const float gl = lam - g.wl0;
    float ox = 0.f, oy = 0.f, oz = 0.f;
    if ((gl >= 0.f) && (lam <= g.wl1)) {
        const float idx = floorf(gl);
        const float frac = gl - idx;
        int i0 = (int)idx + 1;
        i0 = min(max(i0, 0), g.n_obs - 2);
        const float a = 1.f - frac;
        ox = tab[i0] * a + tab[i0 + 1] * frac;
        oy = tab[OBS_MAX + i0] * a + tab[OBS_MAX + i0 + 1] * frac;
        oz = tab[2 * OBS_MAX + i0] * a + tab[2 * OBS_MAX + i0 + 1] * frac;
    }
    vx = ox * wm; vy = oy * wm; vz = oz * wm; vw = wm;
    return (unsigned)((int)fy * g.Nx + (int)fx);
}

__global__ void __launch_bounds__(BIN_THREADS) bin_xyzw_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ w, const float* __restrict__ wl, long long N,
    const float* __restrict__ obs, BinArgs g, float* __restrict__ img)
{
    __shared__ float tab[3 * OBS_MAX];
    __shared__ int lead_tab[BIN_WARPS][BIN_HASH];
    __shared__ unsigned m_key[BIN_WARPS * BIN_WARP_SLOTS];
    __shared__ float m_acc[BIN_WARPS * BIN_WARP_SLOTS][4];
    for (int q = threadIdx.x; q < 3 * g.n_obs; q += blockDim.x) {
        tab[(q / g.n_obs) * OBS_MAX + (q % g.n_obs)] = obs[q];
    }
    __syncthreads();

    // a warp takes BIN_TILE consecutive rays a turn, in four votes of 32
    // neighbours each; the loop's bounds are the same for every lane
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long stride = (((long long)gridDim.x * blockDim.x) >> 5) * BIN_TILE;
    WarpSlots ws;
    ws.n = 0;
#pragma unroll
    for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
        ws.key[s] = DEAD;
        ws.acc[s][0] = 0.f; ws.acc[s][1] = 0.f; ws.acc[s][2] = 0.f; ws.acc[s][3] = 0.f;
    }
    for (long long base = warp * BIN_TILE; base < N; base += stride) {
        float x[4], y[4], ww[4], lam[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {       // all loads first: 16 in flight a thread
            const long long i = base + 32 * j + lane;
            const bool in = i < N;
            x[j] = in ? __ldcs(px + i) : 0.f;
            y[j] = in ? __ldcs(py + i) : 0.f;
            ww[j] = in ? __ldcs(w + i) : 0.f;
            lam[j] = in ? __ldcs(wl + i) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float vx, vy, vz, vw;
            const unsigned key = ray_value(g, tab, x[j], y[j], ww[j], lam[j], vx, vy, vz, vw);
            warp_accumulate(ws, key, vx, vy, vz, vw, lane, lead_tab[wib], img);
        }
    }

    // the warps' accumulators meet in shared memory, one entry a lane of
    // the first warp, which sums equal pixels once more and adds each to the
    // image with one atomic
#pragma unroll
    for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
        if (lane == s) {
            const int e = wib * BIN_WARP_SLOTS + s;
            m_key[e] = (s < ws.n) ? ws.key[s] : DEAD;
            m_acc[e][0] = ws.acc[s][0]; m_acc[e][1] = ws.acc[s][1];
            m_acc[e][2] = ws.acc[s][2]; m_acc[e][3] = ws.acc[s][3];
        }
    }
    __syncthreads();
    if (wib == 0) {
        const bool has = lane < BIN_WARPS * BIN_WARP_SLOTS;
        unsigned key = has ? m_key[lane] : DEAD;
        const float vx = has ? m_acc[lane][0] : 0.f, vy = has ? m_acc[lane][1] : 0.f;
        const float vz = has ? m_acc[lane][2] : 0.f, vw = has ? m_acc[lane][3] : 0.f;
        for (;;) {
            const unsigned live = __ballot_sync(FULL, key != DEAD);
            if (live == 0u) break;
            const int src = __ffs(live) - 1;
            const unsigned cand = __shfl_sync(FULL, key, src);
            const bool mine = key == cand;
            float a = vx, b = vy, c = vz, d = vw;
            warp_sum4(__ballot_sync(FULL, mine), lane, a, b, c, d);
            if (lane == src) add_global(img, cand, a, b, c, d);
            if (mine) key = DEAD;
        }
    }
}

// Accumulates into `img` (Ny, Nx, 4), 16-byte aligned, on `stream`. Allocates
// nothing and does not synchronise. Returns cudaGetLastError(), -1 for a
// table too large and -2 for an image that is not 16-byte aligned.
extern "C" int bin_xyzw_launch(
    const void* px, const void* py, const void* w, const void* wl, long long N,
    const void* obs, int n_obs, float wl0, float wl1,
    float x0, float x1, float y0, float y1, float scale_x, float scale_y,
    int Nx, int Ny, void* img, void* stream)
{
    if (n_obs > OBS_MAX || n_obs < 2) return -1;
    if (((size_t)img & 15) != 0) return -2;
    if (N <= 0) return 0;

    static int n_sm = 0;        // of the current device at the first launch
    if (n_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (n_sm <= 0) n_sm = 1;
    }
    const long long per_block = (long long)BIN_WARPS * BIN_TILE;
    const long long want = (N + per_block - 1) / per_block;
    const long long most = (long long)n_sm * BIN_BLOCKS_PER_SM;
    const unsigned blocks = (unsigned)(want < most ? want : most);
    const BinArgs g = {n_obs, wl0, wl1, x0, x1, y0, y1, scale_x, scale_y, Nx, Ny};
    bin_xyzw_kernel<<<blocks, BIN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)px, (const float*)py, (const float*)w, (const float*)wl, N,
        (const float*)obs, g, (float*)img);
    return (int)cudaGetLastError();
}
