// Detector binning kernel: weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w),
// summed in fixed point so that the image does not depend on the order of
// the rays.
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_binning.py:bin_xyzw_pallas
// (body _bin_kernel), which reduces one-hot × values products on the matrix
// unit in O(bins · rays) work. Here one pass over the rays does the bin index
// (ops/binning.py:binning_indices_2d: floor(N/s·(x − x0)), the inclusive
// positive edge, outside → weight 0), the CIE observer lookup (uniform 1 nm
// table with zero padding) and the sum into the (Ny·Nx, 4) image. Rays whose
// masked weight is 0 (dead rays, rays outside the extent) add nothing.
//
// Fixed point (ops/binning.py:bin_xyzw_fixed is the plain version, bit for
// bit). Each of a ray's four f32 values is rounded once, half to even, to a
// 64-bit integer at the scale 2^e, and the integers are summed; integer
// addition is associative, so warps may arrive in any order and the image
// is a function of the set of rays, in one call and across a resumed render.
// e is the largest exponent with N·max|w|·B·2^e < 2^62 (B: the largest
// observer value, or 1), so no sum of a call can overflow; at 10⁶ rays of
// weight up to 1 a ray's value is quantised to about 2⁻⁴¹ of itself. Three
// launches: bin_xyzw_wmax reduces max|w| into one word on the device (a
// maximum does not depend on order, and nothing is read back, so the call
// can be captured in a CUDA graph), bin_xyzw_kernel adds the integers into
// a (Ny·Nx, 4) int64 scratch image that the launch zeroes first (a memset,
// so a captured call zeroes it at every replay), and bin_xyzw_finalize
// converts each channel whose sum is not 0 to f32 as (float)((double)sum·2^-e)
// and adds it to the image without atomics.
//
// Bound: the function must read 16 B per ray and write the image once
// (Ny·Nx·16 B). At N = 10⁶ and 945² that is 30.3 MB, about 9 µs at
// 3.35 TB/s on an H100, against about 30 operations per ray: bytes are the
// bound. The scratch is this kernel's working memory, not the function's:
// 28.6 MB at 945², zeroed, added into and read once more, which stays in the
// 50 MB L2, where the atomics are resolved.
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
//     where the table took 0.037, both in the f32 form.)
//   - A sum goes into the warp's accumulator (BIN_WARP_SLOTS of them, in the
//     registers of every lane alike, claimed by the first groups the warp
//     sums) or, when that holds another pixel, into the image. At the block's
//     end the warps' accumulators meet in shared memory, one entry a lane of
//     the first warp, which sums equal pixels once more. No shared-memory
//     atomic is used: in the f32 form an add there was a compare-and-swap
//     loop, and eight warps that met on one accumulator spun in it (0.041 ms
//     on clustered rays against 0.021 without). The global atomics that meet
//     on the pixel of a focused spot fall from one a warp to one a block.
//   - A pixel of the scratch is 32 B, four 64-bit integers; there is no
//     four-wide 64-bit atomic, so a ray or group adds with four
//     atomicAdd(unsigned long long*), two's complement carrying the sign.
//     (The f32 form of this kernel added a float4 with one vector atomic.)
//   The f32 form of this kernel took its constants from tools/tune_binning.py
//   (one accumulator a warp, two groups a vote, four blocks an SM; the
//   times are in that form's history). In fixed point a group that misses
//   the warp's accumulators costs four 64-bit atomics on one address where
//   it cost one vector atomic, and a hot pixel that no accumulator holds
//   queues four times as long in the L2. So the warp keeps two
//   accumulators and a vote sums up to three groups: tried on the card
//   against one and four accumulators and one to three groups, on the
//   inputs of chip_smoke.py:check_binning, this removes the one input on
//   which the kernel lost most (two hot pixels among spread rays), ties on
//   the render's focused spot and costs a little on spread rays, which
//   meet no partner anyway. Times: PERF.md §6. Tensor cores, TMA and
//   clusters have nothing to offer: there is no matrix product and no tile
//   that is used twice.
//
#include <cuda_runtime.h>
#include <math.h>

#define OBS_MAX 512     // padded observer table entries per channel
#ifndef BIN_WARP_SLOTS
#define BIN_WARP_SLOTS 2    // pixels a warp accumulates in registers
#endif
#ifndef BIN_PEEL
#define BIN_PEEL 3      // groups a vote sums before the rest add alone
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
#define FIXED_BITS 62       // |a call's integer sums| < 2^FIXED_BITS

static_assert(BIN_WARPS * BIN_WARP_SLOTS <= 32, "the block's accumulators are merged by one warp");

typedef long long i64;
typedef unsigned long long u64;

// The exponent e of the fixed point (ops/binning.py:fixed_point_exponent):
// the exponent field of N·max|w|·B in f64; a bound of 0 gives FIXED_BITS.
__device__ __forceinline__ int fixed_exponent(unsigned wmax_bits, i64 N, double obs_bound)
{
    const double bound = ((double)__uint_as_float(wmax_bits) * (double)N) * obs_bound;
    const i64 biased = __double_as_longlong(bound) >> 52;
    return biased == 0 ? FIXED_BITS : (int)(FIXED_BITS + 1022 - biased);
}

// 2^e exactly, for e in [-1022, 1023]
__device__ __forceinline__ double pow2(int e)
{
    return __longlong_as_double((i64)(e + 1023) << 52);
}

__device__ __forceinline__ void add_global(i64* img, unsigned key, i64 a, i64 b, i64 c, i64 d)
{
    u64* px = reinterpret_cast<u64*>(img) + 4 * (size_t)key;
    atomicAdd(px, (u64)a); atomicAdd(px + 1, (u64)b);
    atomicAdd(px + 2, (u64)c); atomicAdd(px + 3, (u64)d);
}

// Sum over the lanes of `m` (not empty); every lane gets the sums.
__device__ __forceinline__ void warp_sum4(unsigned m, int lane, i64& a, i64& b, i64& c, i64& d)
{
    if ((m & (m - 1u)) == 0u) {         // one lane: hand its values round
        const int src = __ffs(m) - 1;
        a = __shfl_sync(FULL, a, src); b = __shfl_sync(FULL, b, src);
        c = __shfl_sync(FULL, c, src); d = __shfl_sync(FULL, d, src);
        return;
    }
    const bool mine = (m >> lane) & 1u;
    a = mine ? a : 0; b = mine ? b : 0; c = mine ? c : 0; d = mine ? d : 0;
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
    i64 acc[BIN_WARP_SLOTS][4];
    int n;
};

// The sum of a group, known to every lane: into the warp's accumulator for
// that pixel or a free one; otherwise lane `src` adds it to the image.
__device__ __forceinline__ void add_warp(
    WarpSlots& ws, int lane, int src, i64* img, unsigned key, i64 a, i64 b, i64 c, i64 d)
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
    WarpSlots& ws, unsigned key, i64 vx, i64 vy, i64 vz, i64 vw, int lane,
    volatile int* lead, i64* img)
{
    const unsigned kmin = __reduce_min_sync(FULL, key);
    if (kmin == DEAD) return;
    const unsigned kmax = __reduce_max_sync(FULL, key == DEAD ? 0u : key);
    if (kmin == kmax) {
        // the warp's live rays are one pixel
        i64 a = vx, b = vy, c = vz, d = vw;
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
                i64 a = vx, b = vy, c = vz, d = vw;
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
        i64 a = vx, b = vy, c = vz, d = vw;
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
    double obs_bound;
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

// max|w| over all rays into *wmax (zeroed before), as the bits of a
// non-negative float, whose order is the order of the values
__global__ void __launch_bounds__(BIN_THREADS) bin_xyzw_wmax(
    const float* __restrict__ w, i64 N, unsigned* __restrict__ wmax)
{
    __shared__ unsigned warp_max[BIN_WARPS];
    unsigned m = 0u;
    const i64 stride = (i64)gridDim.x * blockDim.x;
    for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += 4 * stride) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {       // four loads in flight a thread
            const i64 k = i + j * stride;
            v[j] = k < N ? __ldcs(w + k) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) m = max(m, __float_as_uint(fabsf(v[j])));
    }
    // one atomic a block: atomics of every warp on one word queue in the L2
    m = __reduce_max_sync(FULL, m);
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
        m = __reduce_max_sync(FULL, threadIdx.x < BIN_WARPS ? warp_max[threadIdx.x] : 0u);
        if (threadIdx.x == 0) atomicMax(wmax, m);
    }
}

__global__ void __launch_bounds__(BIN_THREADS) bin_xyzw_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ w, const float* __restrict__ wl, i64 N,
    const float* __restrict__ obs, BinArgs g, const unsigned* __restrict__ wmax,
    i64* __restrict__ img)
{
    __shared__ float tab[3 * OBS_MAX];
    __shared__ int lead_tab[BIN_WARPS][BIN_HASH];
    __shared__ unsigned m_key[BIN_WARPS * BIN_WARP_SLOTS];
    __shared__ i64 m_acc[BIN_WARPS * BIN_WARP_SLOTS][4];
    for (int q = threadIdx.x; q < 3 * g.n_obs; q += blockDim.x) {
        tab[(q / g.n_obs) * OBS_MAX + (q % g.n_obs)] = obs[q];
    }
    __syncthreads();
    const double scale = pow2(fixed_exponent(*wmax, N, g.obs_bound));

    // a warp takes BIN_TILE consecutive rays a turn, in four votes of 32
    // neighbours each; the loop's bounds are the same for every lane
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const i64 warp = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const i64 stride = (((i64)gridDim.x * blockDim.x) >> 5) * BIN_TILE;
    WarpSlots ws;
    ws.n = 0;
#pragma unroll
    for (int s = 0; s < BIN_WARP_SLOTS; ++s) {
        ws.key[s] = DEAD;
        ws.acc[s][0] = 0; ws.acc[s][1] = 0; ws.acc[s][2] = 0; ws.acc[s][3] = 0;
    }
    for (i64 base = warp * BIN_TILE; base < N; base += stride) {
        float x[4], y[4], ww[4], lam[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {       // all loads first: 16 in flight a thread
            const i64 i = base + 32 * j + lane;
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
            // each f32 value rounded once to the fixed point, half to even
            // (a power of two times an f32 is exact in f64); a ray that adds
            // nothing converts nothing
            i64 qx = 0, qy = 0, qz = 0, qw = 0;
            if (key != DEAD) {
                qx = __double2ll_rn((double)vx * scale); qy = __double2ll_rn((double)vy * scale);
                qz = __double2ll_rn((double)vz * scale); qw = __double2ll_rn((double)vw * scale);
            }
            warp_accumulate(ws, key, qx, qy, qz, qw, lane, lead_tab[wib], img);
        }
    }

    // the warps' accumulators meet in shared memory, one entry a lane of
    // the first warp, which sums equal pixels once more and adds each to the
    // image with one group of atomics
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
        const i64 vx = has ? m_acc[lane][0] : 0, vy = has ? m_acc[lane][1] : 0;
        const i64 vz = has ? m_acc[lane][2] : 0, vw = has ? m_acc[lane][3] : 0;
        for (;;) {
            const unsigned live = __ballot_sync(FULL, key != DEAD);
            if (live == 0u) break;
            const int src = __ffs(live) - 1;
            const unsigned cand = __shfl_sync(FULL, key, src);
            const bool mine = key == cand;
            i64 a = vx, b = vy, c = vz, d = vw;
            warp_sum4(__ballot_sync(FULL, mine), lane, a, b, c, d);
            if (lane == src) add_global(img, cand, a, b, c, d);
            if (mine) key = DEAD;
        }
    }
}

// Each channel whose sum is not 0: out += (float)((double)sum·2^-e); the
// other channels stay as they are.
__global__ void __launch_bounds__(BIN_THREADS) bin_xyzw_finalize(
    const i64* __restrict__ acc, i64 P, const unsigned* __restrict__ wmax, i64 N,
    double obs_bound, float* __restrict__ out)
{
    const double inv = pow2(-fixed_exponent(*wmax, N, obs_bound));
    const longlong2* a2 = reinterpret_cast<const longlong2*>(acc);
    for (i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += (i64)gridDim.x * blockDim.x) {
        const longlong2 lo = a2[2 * p], hi = a2[2 * p + 1];
        if ((lo.x | lo.y | hi.x | hi.y) == 0) continue;
        float* o = out + 4 * p;
        if (lo.x != 0) o[0] = o[0] + (float)((double)lo.x * inv);
        if (lo.y != 0) o[1] = o[1] + (float)((double)lo.y * inv);
        if (hi.x != 0) o[2] = o[2] + (float)((double)hi.x * inv);
        if (hi.y != 0) o[3] = o[3] + (float)((double)hi.y * inv);
    }
}

// Accumulates into `img` (Ny, Nx, 4) f32 on `stream`, through `scratch`:
// Ny·Nx·32 + 16 bytes, 16-byte aligned, of any content (the (Ny·Nx, 4)
// int64 sums, then the max|w| word), which it zeroes first. Allocates
// nothing and does not synchronise. Returns cudaGetLastError(), -1 for a
// table too large and -2 for a scratch that is not 16-byte aligned.
// (Named for the fixed point: a caller built for the f32 form's 19
// arguments finds no symbol instead of passing the wrong ones.)
extern "C" int bin_xyzw_fixed_launch(
    const void* px, const void* py, const void* w, const void* wl, long long N,
    const void* obs, int n_obs, float wl0, float wl1,
    float x0, float x1, float y0, float y1, float scale_x, float scale_y,
    int Nx, int Ny, double obs_bound, void* scratch, void* img, void* stream)
{
    if (n_obs > OBS_MAX || n_obs < 2) return -1;
    if (((size_t)scratch & 15) != 0) return -2;
    if (N <= 0) return 0;
    const long long P = (long long)Nx * Ny;
    i64* acc = (i64*)scratch;
    unsigned* wmax = (unsigned*)(acc + 4 * P);

    static int n_sm = 0;        // of the current device at the first launch
    if (n_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
        if (n_sm <= 0) n_sm = 1;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const long long most = (long long)n_sm * BIN_BLOCKS_PER_SM;
    cudaMemsetAsync(scratch, 0, (size_t)P * 32 + 16, st);
    const long long want_w = (N + BIN_THREADS - 1) / BIN_THREADS;
    bin_xyzw_wmax<<<(unsigned)(want_w < most ? want_w : most), BIN_THREADS, 0, st>>>(
        (const float*)w, N, wmax);

    const long long per_block = (long long)BIN_WARPS * BIN_TILE;
    const long long want = (N + per_block - 1) / per_block;
    const unsigned blocks = (unsigned)(want < most ? want : most);
    const BinArgs g = {n_obs, wl0, wl1, x0, x1, y0, y1, scale_x, scale_y, Nx, Ny, obs_bound};
    bin_xyzw_kernel<<<blocks, BIN_THREADS, 0, st>>>(
        (const float*)px, (const float*)py, (const float*)w, (const float*)wl, N,
        (const float*)obs, g, wmax, acc);

    const long long want_p = (P + BIN_THREADS - 1) / BIN_THREADS;
    bin_xyzw_finalize<<<(unsigned)(want_p < 4 * most ? want_p : 4 * most), BIN_THREADS, 0, st>>>(
        acc, P, wmax, N, obs_bound, (float*)img);
    return (int)cudaGetLastError();
}
