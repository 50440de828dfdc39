// Detector binning kernel: weighted 2-D histogram of (x̄·w, ȳ·w, z̄·w, w),
// summed in fixed point so that the image does not depend on the order of
// the rays.
//
// Replaces the TPU kernel optrace_tpu/ops/pallas_binning.py:bin_xyzw_pallas
// (body _bin_kernel), which reduces one-hot × values products on the matrix
// unit in O(bins · rays) work. Here each ray's bin index
// (ops/binning.py:binning_indices_2d: floor(N/s·(x − x0)), the inclusive
// positive edge, outside → weight 0) and CIE observer lookup (uniform 1 nm
// table with zero padding) are computed as there, and the rays are summed
// into the (Ny·Nx, 4) image. Rays whose masked weight is 0 (dead rays, rays
// outside the extent) add nothing.
//
// Fixed point (ops/binning.py:bin_xyzw_fixed is the plain version, bit for
// bit). Each of a ray's four f32 values is rounded once, half to even, to a
// 64-bit integer at the scale 2^e, and the integers are summed; integer
// addition is associative, so rays may arrive in any order and the image
// is a function of the set of rays, in one call and across a resumed render.
// e is the largest exponent with N·max|w|·B·2^e < 2^62 (B: the largest
// observer value, or 1), so no sum of a call can overflow. A pixel's channel
// whose sum is not 0 is converted once, out += (float)((double)sum·2^-e);
// the other channels stay as they are.
//
// Bound: the function must read 16 B per ray and write the image once
// (Ny·Nx·16 B): 30.3 MB at N = 10⁶ and 945², about 9 µs at 3.35 TB/s on an
// H100, against about 30 operations per ray. The sums are what is hard on
// this card: device memory has no four-wide 64-bit atomic, read-modify-
// writes that meet on one address (the image of a point puts 8 of 10 rays
// into one pixel) are taken one after the other in the L2, and in shared
// memory a 64-bit add is a compare-and-swap loop (ATOMS.CAST.SPIN.64),
// which lanes that meet on one pixel repeat one after the other. So the rays
// are first sorted by image tile, and each tile is then summed in shared
// memory with native 32-bit atomics and written once. Four launches and a
// memset of the tile counts:
//   - bin_xyzw_count: the key of each ray, the count of live rays in each
//     tile of BIN_TILE consecutive keys (a block counts in shared memory, a
//     warp's increments of one counter aggregated by the hardware, and adds
//     each tile's count to the device with one atomic), and max|w| over all
//     rays (the exponent depends on every ray, so the rounding waits). Rays
//     that add nothing drop out here.
//   - bin_xyzw_plan, one block: the exclusive scan of the tile counts gives
//     each tile its segment of the record array; a tile of c rays becomes
//     ⌈c / BIN_CHUNK⌉ work items {tile, first record, records, slot}, and a
//     tile of more than one item (a "split" tile) gets a slot of int64 sums
//     in device memory and a count of its items still to come. The work
//     list stays on the device; nothing is read back, so the call captures
//     into a CUDA graph.
//   - bin_xyzw_scatter: each block takes 4096 rays, orders them by tile in
//     shared memory, reserves its range in each tile's segment with one
//     atomic and writes each tile's run of 16-byte records (key, w, λ) as
//     one stretch. The order inside a segment varies from run to run; the
//     integer sums do not. It also zeroes the split tiles' slots.
//   - bin_xyzw_sum: a persistent grid over the work items. A block rounds
//     each ray's values at the scale 2^e and adds them into the tile's sums
//     in shared memory. A warp's hot pixel (of its last group of at least
//     BIN_HOT_MIN lanes of one pixel; one minimum and one maximum over the
//     warp tell a group of one pixel) is summed in each lane's registers and
//     added once an item: that makes the image of a point cheap. Every
//     other ray adds for itself, a 64-bit add being two 32-bit atomics, the
//     carry taken from the low word's old value. A tile of one item is then
//     converted and added to the image, each lit pixel once. A split tile's
//     items add their lit pixels into its slot with 64-bit atomics in device
//     memory (on the image of a point a handful of pixels an item), and the
//     item that arrives last converts the slot and writes the tile.
// Beyond BIN_HIST_MAX tiles (images of more than 16.7 M pixels) counts and
// places are taken with atomics on the device counters directly. The
// scratch is sized from N and Ny·Nx alone (ops/cuda_binning.py:
// scratch_layout mirrors layout() below): 16 B a ray of records, 8 B a tile
// and 16 B a work item of plan, BIN_TILE·32 B a possible split tile; only
// the counts (4 B a tile) are zeroed by a memset. BIN_TILE, BIN_CHUNK and
// BIN_BLOCKS_PER_SM are those tools/tune_binning.py found best on the inputs
// of chip_smoke.py:check_binning; the designs this one was measured against
// are in PERF.md §6. Tensor cores, TMA and clusters have nothing to offer:
// there is no matrix product and no tile that is read twice from device
// memory.
//
#include <cuda_runtime.h>
#include <math.h>

#define OBS_MAX 512     // padded observer table entries per channel
#ifndef BIN_TILE
#define BIN_TILE 2048           // pixels a tile: consecutive keys, summed in shared memory
#endif
#ifndef BIN_CHUNK
#define BIN_CHUNK 4096          // rays a work item at most
#endif
#ifndef BIN_BLOCKS_PER_SM
#define BIN_BLOCKS_PER_SM 2     // blocks an SM of the summing pass
#endif
#define BIN_THREADS 256         // threads a block of the summing pass
#define BIN_WIDE 512            // threads a block of the counting and scatter passes
#define BIN_COUNT_BLOCKS_PER_SM 2
#define BIN_RAYS_PER_THREAD 8   // of the scatter pass: a block places 4096 rays
#define BIN_WARPS (BIN_WIDE / 32)
#define BIN_HOT_MIN 4           // lanes of one pixel that make it a warp's hot pixel
#define BIN_HIST_MAX 8192       // tiles a block counts in shared memory
#define PLAN_THREADS 1024
// the scatter's shared memory at most: counts and offsets of BIN_HIST_MAX
// tiles and the block's records
#define SCATTER_SMEM_MAX (8 * BIN_HIST_MAX + 16 * BIN_WIDE * BIN_RAYS_PER_THREAD)
#define DEAD 0xffffffffu        // key of a ray that adds nothing
#define WHOLE 0xffffffffu       // split slot of a work item that is its whole tile
#define FULL 0xffffffffu
#define FIXED_BITS 62           // |a call's integer sums| < 2^FIXED_BITS

static_assert((BIN_TILE & (BIN_TILE - 1)) == 0 && BIN_TILE >= BIN_THREADS, "a tile is a power of two");
static_assert(BIN_TILE <= 65536 && BIN_CHUNK >= 32, "tile and chunk sizes");

typedef long long i64;
typedef unsigned long long u64;

// The parts of the scratch, each 16-byte aligned, in bytes from its start.
// ops/cuda_binning.py:scratch_layout computes the same.
struct Layout {
    i64 tiles, items, splits;       // tiles, work items at most, split tiles at most
    i64 count, cursor, item, arrive, rec, split, zeroed, total;
};

static i64 up16(i64 b) { return (b + 15) & ~(i64)15; }

static Layout layout(i64 N, i64 P)
{
    Layout L;
    L.tiles = (P + BIN_TILE - 1) / BIN_TILE;
    L.items = L.tiles + (N + BIN_CHUNK - 1) / BIN_CHUNK;
    L.splits = N / (BIN_CHUNK + 1) < L.tiles ? N / (BIN_CHUNK + 1) : L.tiles;
    L.count = 16;                               // after the head: max|w|, items, split tiles
    L.cursor = L.count + up16(4 * L.tiles);
    L.zeroed = L.cursor;                        // the head and the counts
    L.item = L.cursor + up16(4 * L.tiles);
    L.arrive = L.item + 16 * L.items;
    L.rec = L.arrive + up16(4 * L.splits);
    L.split = L.rec + 16 * N;
    L.total = L.split + L.splits * BIN_TILE * 32;
    return L;
}

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

struct BinArgs {
    int n_obs;
    float wl0, wl1;
    float x0, x1, y0, y1, scale_x, scale_y;
    int Nx, Ny;
    double obs_bound;
};

// Pixel index of one ray; DEAD when its masked weight is 0.
__device__ __forceinline__ unsigned ray_key(const BinArgs& g, float x, float y, float w)
{
    float fx = floorf(g.scale_x * (x - g.x0));
    float fy = floorf(g.scale_y * (y - g.y0));
    if (x == g.x1) fx = (float)(g.Nx - 1);
    if (y == g.y1) fy = (float)(g.Ny - 1);
    const bool inside = (fx >= 0.f) && (fy >= 0.f) && (fy < (float)g.Ny) && (fx < (float)g.Nx);
    const float wm = inside ? w : 0.f;
    if (!(wm != 0.f)) return DEAD;
    return (unsigned)((int)fy * g.Nx + (int)fx);
}

// A live ray's four values: the observer lookup, linear interpolation on the
// 1 nm grid of a table with one zero entry before its first and after its
// last wavelength, times the weight.
__device__ __forceinline__ void ray_values(
    const BinArgs& g, const float* tab, float w, float lam, float& vx, float& vy, float& vz)
{
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
    vx = ox * w; vy = oy * w; vz = oz * w;
}

// Pass 1: tile counts of the live rays into count[] and max|w| over all
// rays into head[0] (the bits of a non-negative float, whose order is the
// order of the values). head and count are zeroed before.
__global__ void __launch_bounds__(BIN_WIDE) bin_xyzw_count(
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ w,
    i64 N, BinArgs g, unsigned T, unsigned* __restrict__ head, unsigned* __restrict__ count)
{
    extern __shared__ unsigned hist[];      // T counters when T <= BIN_HIST_MAX
    __shared__ unsigned warp_max[BIN_WARPS];
    const bool local = T <= BIN_HIST_MAX;
    if (local) {
        for (unsigned t = threadIdx.x; t < T; t += BIN_WIDE) hist[t] = 0u;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    unsigned m = 0u;
    const i64 stride = (i64)gridDim.x * BIN_WIDE;
    // the loop's bounds are the same for every lane of a block
    for (i64 base = (i64)blockIdx.x * BIN_WIDE; base < N; base += 4 * stride) {
        float x[4], y[4], ww[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {       // all loads first: 12 in flight a thread
            const i64 k = base + j * stride + threadIdx.x;
            const bool in = k < N;
            x[j] = in ? __ldcs(px + k) : 0.f;
            y[j] = in ? __ldcs(py + k) : 0.f;
            ww[j] = in ? __ldcs(w + k) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            m = max(m, __float_as_uint(fabsf(ww[j])));
            const unsigned key = ray_key(g, x[j], y[j], ww[j]);
            // lanes of one counter are one increment (ATOMS.POPC.INC)
            if (key != DEAD) {
                if (local) atomicAdd(hist + key / BIN_TILE, 1u);       // the block is uniform in `local`
                else atomicAdd(count + key / BIN_TILE, 1u);
            }
        }
    }
    // one atomic a block: atomics of every warp on one word queue in the L2
    m = __reduce_max_sync(FULL, m);
    if (lane == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
        m = __reduce_max_sync(FULL, threadIdx.x < BIN_WARPS ? warp_max[threadIdx.x] : 0u);
        if (threadIdx.x == 0) atomicMax(head, m);
    }
    if (local) {
        for (unsigned t = threadIdx.x; t < T; t += BIN_WIDE) {
            if (hist[t] != 0u) atomicAdd(count + t, hist[t]);
        }
    }
}

// Exclusive scan over the block of one value a thread; *total gets the sum.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* tmp, unsigned* total)
{
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    unsigned inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += o;
    }
    if (lane == 31) tmp[wid] = inc;
    __syncthreads();
    if (wid == 0) {
        const unsigned s = lane < (int)(blockDim.x >> 5) ? tmp[lane] : 0u;
        unsigned t = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned o = __shfl_up_sync(FULL, t, off);
            if (lane >= off) t += o;
        }
        tmp[lane] = t - s;                  // exclusive prefix of each warp
        if (lane == 31) tmp[32] = t;
    }
    __syncthreads();
    const unsigned ex = tmp[wid] + inc - v;
    *total = tmp[32];
    __syncthreads();
    return ex;
}

// Pass 2, one block: each tile's segment (cursor[] = its start), its work
// items {tile, first record, records, split slot or WHOLE} and the split
// tiles' counters of items still to arrive; head[1] = work items, head[2] =
// split tiles.
__global__ void __launch_bounds__(PLAN_THREADS) bin_xyzw_plan(
    unsigned T, unsigned* __restrict__ head, const unsigned* __restrict__ count,
    unsigned* __restrict__ cursor, uint4* __restrict__ items, unsigned* __restrict__ arrive)
{
    __shared__ unsigned tmp[33];
    const unsigned per = (T + PLAN_THREADS - 1) / PLAN_THREADS;
    const unsigned t0 = min(T, threadIdx.x * per), t1 = min(T, t0 + per);
    unsigned rays = 0u, n_items = 0u, n_split = 0u;
    for (unsigned t = t0; t < t1; ++t) {
        const unsigned n = (count[t] + BIN_CHUNK - 1) / BIN_CHUNK;
        rays += count[t]; n_items += n; n_split += n > 1u;
    }
    unsigned total_items, total_split, total_rays;
    unsigned r = block_scan(rays, tmp, &total_rays);
    unsigned it = block_scan(n_items, tmp, &total_items);
    unsigned sp = block_scan(n_split, tmp, &total_split);
    const int lane = threadIdx.x & 31;
    for (unsigned k = 0; k < per; ++k) {        // the same count of rounds for every lane
        const unsigned t = t0 + k;
        const unsigned c = t < t1 ? count[t] : 0u;
        const unsigned n = (c + BIN_CHUNK - 1) / BIN_CHUNK;
        if (t < t1) cursor[t] = r;
        const unsigned slot = n > 1u ? sp : WHOLE;
        if (n > 1u) arrive[sp] = n;
        // a lane writes its tile's items when they are few; the warp writes
        // those of a tile of many together, so that they do not wait on one thread
        if (n <= 4u) {
            for (unsigned j = 0; j < n; ++j) items[it + j] = make_uint4(t, r + j * BIN_CHUNK, min((unsigned)BIN_CHUNK, c - j * BIN_CHUNK), slot);
        }
        for (unsigned many = __ballot_sync(FULL, n > 4u); many != 0u; many &= many - 1u) {
            const int src = __ffs(many) - 1;
            const unsigned ns = __shfl_sync(FULL, n, src), ts = __shfl_sync(FULL, t, src);
            const unsigned its = __shfl_sync(FULL, it, src), slots = __shfl_sync(FULL, slot, src);
            const unsigned rs = __shfl_sync(FULL, r, src), cs = __shfl_sync(FULL, c, src);
            for (unsigned j = lane; j < ns; j += 32) {
                items[its + j] = make_uint4(ts, rs + j * BIN_CHUNK, min((unsigned)BIN_CHUNK, cs - j * BIN_CHUNK), slots);
            }
        }
        r += c; it += n; sp += n > 1u;
    }
    if (threadIdx.x == 0) { head[1] = total_items; head[2] = total_split; }
}

// Pass 3: each block places BIN_WIDE·BIN_RAYS_PER_THREAD rays into their
// tiles' segments as records {key, w, λ, 0}, and the grid zeroes the split
// tiles' slots. cursor[] holds each tile's start and ends at its end.
__global__ void __launch_bounds__(BIN_WIDE) bin_xyzw_scatter(
    const float* __restrict__ px, const float* __restrict__ py, const float* __restrict__ w,
    const float* __restrict__ wl, i64 N, BinArgs g, unsigned T, const unsigned* __restrict__ head,
    unsigned* __restrict__ cursor, uint4* __restrict__ rec, i64* __restrict__ split)
{
    // when T <= BIN_HIST_MAX: T counters (then each tile's place less the
    // block's offset), T offsets and the block's records
    extern __shared__ unsigned hist[];
    const bool local = T <= BIN_HIST_MAX;
    const i64 n_zero = (i64)head[2] * 2 * BIN_TILE;     // longlong2 words of the split slots
    longlong2* z = reinterpret_cast<longlong2*>(split);
    for (i64 q = (i64)blockIdx.x * BIN_WIDE + threadIdx.x; q < n_zero; q += (i64)gridDim.x * BIN_WIDE) {
        z[q] = make_longlong2(0, 0);
    }
    if (local) {
        for (unsigned t = threadIdx.x; t < T; t += BIN_WIDE) hist[t] = 0u;
    }
    __syncthreads();
    const i64 first = (i64)blockIdx.x * (BIN_WIDE * BIN_RAYS_PER_THREAD) + threadIdx.x;
    unsigned key[BIN_RAYS_PER_THREAD], rank[BIN_RAYS_PER_THREAD];
    float ww[BIN_RAYS_PER_THREAD], lam[BIN_RAYS_PER_THREAD];
    {
        float x[BIN_RAYS_PER_THREAD], y[BIN_RAYS_PER_THREAD];
#pragma unroll
        for (int r = 0; r < BIN_RAYS_PER_THREAD; ++r) {
            const i64 i = first + r * BIN_WIDE;
            const bool in = i < N;
            x[r] = in ? __ldcs(px + i) : 0.f;
            y[r] = in ? __ldcs(py + i) : 0.f;
            ww[r] = in ? __ldcs(w + i) : 0.f;
            lam[r] = in ? __ldcs(wl + i) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < BIN_RAYS_PER_THREAD; ++r) {
            key[r] = ray_key(g, x[r], y[r], ww[r]);
            // the ray's place among the block's rays of its tile (the lanes of
            // one tile take theirs with one aggregated increment)
            rank[r] = 0u;
            if (key[r] != DEAD) {
                if (local) rank[r] = atomicAdd(hist + key[r] / BIN_TILE, 1u);
                else rank[r] = atomicAdd(cursor + key[r] / BIN_TILE, 1u);
            }
        }
    }
    if (local) {
        // the block's rays in order of tile in shared memory, then written
        // out by consecutive threads: each tile's run of records is one
        // stretch of the segment, so that the stores meet whole sectors
        __shared__ unsigned tmp[33];
        unsigned* loc = hist + T;                                        // the block's offset of each tile
        uint4* stage = reinterpret_cast<uint4*>(hist + ((2 * T + 3) & ~3u));
        __syncthreads();
        const unsigned per = (T + BIN_WIDE - 1) / BIN_WIDE;
        const unsigned t0 = min(T, threadIdx.x * per), t1 = min(T, t0 + per);
        unsigned mine = 0u;
        for (unsigned t = t0; t < t1; ++t) mine += hist[t];
        unsigned total;
        unsigned off = block_scan(mine, tmp, &total);
        for (unsigned t = t0; t < t1; ++t) {
            const unsigned n = hist[t];
            loc[t] = off;
            // the block's range in the tile's segment, less its own offset
            if (n != 0u) hist[t] = atomicAdd(cursor + t, n) - off;
            off += n;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BIN_RAYS_PER_THREAD; ++r) {
            if (key[r] != DEAD) {
                stage[loc[key[r] / BIN_TILE] + rank[r]] =
                    make_uint4(key[r], __float_as_uint(ww[r]), __float_as_uint(lam[r]), 0u);
            }
        }
        __syncthreads();
        for (unsigned i = threadIdx.x; i < total; i += BIN_WIDE) {
            const uint4 q = stage[i];
            rec[hist[q.x / BIN_TILE] + i] = q;
        }
        return;
    }
#pragma unroll
    for (int r = 0; r < BIN_RAYS_PER_THREAD; ++r) {
        if (key[r] != DEAD) {
            rec[rank[r]] = make_uint4(key[r], __float_as_uint(ww[r]), __float_as_uint(lam[r]), 0u);
        }
    }
}

// Sum over the lanes of `m` (not empty); every lane gets the sums.
__device__ __forceinline__ void warp_sum4(unsigned m, int lane, i64& a, i64& b, i64& c, i64& d)
{
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

// The four channels of one pixel += (a, b, c, d), 64-bit integers in shared
// memory, [4][BIN_TILE] channel by channel. Each is two native 32-bit
// atomics (a 64-bit add in shared memory is a compare-and-swap loop, which
// lanes that meet on one pixel repeat one after the other): the low word's
// old value gives the carry into the high word, so the pair holds the sum
// modulo 2^64 in any order. All four low words first, so that their round
// trips overlap.
__device__ __forceinline__ void add_pixel(i64* sums, unsigned p, i64 a, i64 b, i64 c, i64 d)
{
    const u64 v[4] = {(u64)a, (u64)b, (u64)c, (u64)d};
    unsigned* h = reinterpret_cast<unsigned*>(sums);
    unsigned old[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) old[ch] = atomicAdd(h + 2 * (ch * BIN_TILE + p), (unsigned)v[ch]);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
        const unsigned lo = (unsigned)v[ch];
        const unsigned up = (unsigned)(v[ch] >> 32) + (old[ch] + lo < old[ch] ? 1u : 0u);
        if (up != 0u) atomicAdd(h + 2 * (ch * BIN_TILE + p) + 1, up);
    }
}

// A warp's hot pixel: the pixel of its last group of at least BIN_HOT_MIN
// rays, whose rays each lane sums in its own registers; warp-uniform key.
struct Hot {
    unsigned key;
    i64 acc[4];
};

// The hot pixel's sums, reduced over the warp, into the tile's sums.
__device__ __forceinline__ void hot_flush(i64* sums, unsigned tile0, Hot& h, int lane)
{
    if (h.key == DEAD) return;
    warp_sum4(FULL, lane, h.acc[0], h.acc[1], h.acc[2], h.acc[3]);
    if (lane == 0) add_pixel(sums, h.key - tile0, h.acc[0], h.acc[1], h.acc[2], h.acc[3]);
    h.key = DEAD;
    h.acc[0] = 0; h.acc[1] = 0; h.acc[2] = 0; h.acc[3] = 0;
}

// The group's lanes `m` (warp-uniform, at least BIN_HOT_MIN of them) become
// the warp's hot pixel `key`.
__device__ __forceinline__ void hot_take(i64* sums, unsigned tile0, Hot& h, unsigned key, unsigned m,
                                         int lane, i64 qx, i64 qy, i64 qz, i64 qw)
{
    hot_flush(sums, tile0, h, lane);
    h.key = key;
    if ((m >> lane) & 1u) { h.acc[0] = qx; h.acc[1] = qy; h.acc[2] = qz; h.acc[3] = qw; }
}

// All 32 lanes call this together, each with one ray (key DEAD: none), and
// add the rays into the tile's sums. A ray of the warp's hot pixel adds in
// its lane's registers. The other rays become the hot pixel when at least
// BIN_HOT_MIN of them are one pixel (all of them, which one minimum and one
// maximum tell, or those of the first lane's pixel); otherwise each adds
// for itself, which costs less than summing a few lanes with shuffles.
__device__ __forceinline__ void warp_add(
    i64* sums, unsigned tile0, unsigned key, i64 qx, i64 qy, i64 qz, i64 qw, int lane, Hot& h)
{
    const bool mine_hot = key != DEAD && key == h.key;
    if (mine_hot) { h.acc[0] += qx; h.acc[1] += qy; h.acc[2] += qz; h.acc[3] += qw; }
    unsigned todo = __ballot_sync(FULL, key != DEAD && !mine_hot);
    if (todo == 0u) return;
    const bool in = (todo >> lane) & 1u;
    const unsigned kmin = __reduce_min_sync(FULL, in ? key : DEAD);
    const unsigned kmax = __reduce_max_sync(FULL, in ? key : 0u);
    const unsigned cand = kmin == kmax ? kmin : __shfl_sync(FULL, key, __ffs(todo) - 1);
    const unsigned m = __ballot_sync(FULL, in && key == cand);
    if (__popc(m) >= BIN_HOT_MIN) {
        hot_take(sums, tile0, h, cand, m, lane, qx, qy, qz, qw);
        todo &= ~m;
    }
    if ((todo >> lane) & 1u) add_pixel(sums, key - tile0, qx, qy, qz, qw);
}

__device__ __forceinline__ float4 load_pixel(const float* out, i64 pixel, bool aligned)
{
    if (aligned) return reinterpret_cast<const float4*>(out)[pixel];
    const float* o = out + 4 * pixel;
    return make_float4(o[0], o[1], o[2], o[3]);
}

// o += the converted sums, channel by channel where a sum is not 0
__device__ __forceinline__ void store_pixel(float* out, i64 pixel, bool aligned, float4 o,
                                            const i64* v, double inv)
{
    if (v[0] != 0) o.x = o.x + (float)((double)v[0] * inv);
    if (v[1] != 0) o.y = o.y + (float)((double)v[1] * inv);
    if (v[2] != 0) o.z = o.z + (float)((double)v[2] * inv);
    if (v[3] != 0) o.w = o.w + (float)((double)v[3] * inv);
    if (aligned) {
        reinterpret_cast<float4*>(out)[pixel] = o;
    } else {
        float* p = out + 4 * pixel;
        p[0] = o.x; p[1] = o.y; p[2] = o.z; p[3] = o.w;
    }
}

#define BIN_STAGE 4     // pixels a thread converts with their loads in flight together

// Adds the lit pixels of the tile starting at pixel tile0 to out: their sums
// from `src` ([4][BIN_TILE] int64, channel by channel), which is the block's
// shared memory (and set back to 0) or a split tile's slot (read from the L2).
template <bool SHARED>
__device__ __forceinline__ void write_tile(i64* src, unsigned tile0, float* out, bool aligned, double inv)
{
    for (unsigned p0 = threadIdx.x; p0 < BIN_TILE; p0 += BIN_STAGE * BIN_THREADS) {
        i64 v[BIN_STAGE][4];
        bool lit[BIN_STAGE];
        float4 o[BIN_STAGE];
#pragma unroll
        for (int k = 0; k < BIN_STAGE; ++k) {
            const unsigned p = p0 + k * BIN_THREADS;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                v[k][c] = p < BIN_TILE ? (SHARED ? src[c * BIN_TILE + p] : __ldcg(src + c * BIN_TILE + p)) : 0;
            }
            lit[k] = (v[k][0] | v[k][1] | v[k][2] | v[k][3]) != 0;
            if (SHARED && lit[k]) {
#pragma unroll
                for (int c = 0; c < 4; ++c) src[c * BIN_TILE + p] = 0;
            }
            if (lit[k]) o[k] = load_pixel(out, (i64)tile0 + p, aligned);
        }
#pragma unroll
        for (int k = 0; k < BIN_STAGE; ++k) {
            if (lit[k]) store_pixel(out, (i64)tile0 + p0 + k * BIN_THREADS, aligned, o[k], v[k], inv);
        }
    }
}

// Pass 4: the work items, by a persistent grid. The tile's sums live in
// shared memory, channel by channel ([4][BIN_TILE] int64), and are zero
// between items: the block zeroes them once and every read of a lit pixel
// puts its zeros back.
__global__ void __launch_bounds__(BIN_THREADS, BIN_BLOCKS_PER_SM) bin_xyzw_sum(
    const uint4* __restrict__ rec, const unsigned* __restrict__ head,
    const uint4* __restrict__ items, unsigned* __restrict__ arrive, i64* __restrict__ split,
    const float* __restrict__ obs, BinArgs g, i64 N, float* __restrict__ out, bool aligned)
{
    extern __shared__ i64 sums[];
    __shared__ float tab[3 * OBS_MAX];
    __shared__ int last;
    for (int q = threadIdx.x; q < 3 * g.n_obs; q += BIN_THREADS) {
        tab[(q / g.n_obs) * OBS_MAX + (q % g.n_obs)] = obs[q];
    }
    for (int q = threadIdx.x; q < 4 * BIN_TILE; q += BIN_THREADS) sums[q] = 0;
    __syncthreads();
    const int e = fixed_exponent(head[0], N, g.obs_bound);
    const double scale = pow2(e), inv = pow2(-e);
    const unsigned n_items = head[1];
    const int lane = threadIdx.x & 31;
    Hot hot = {DEAD, {0, 0, 0, 0}};

    for (unsigned it = blockIdx.x; it < n_items; it += gridDim.x) {
        const uint4 item = items[it];           // tile, first record, records, split slot or WHOLE
        const unsigned start = item.y, len = item.z;
        const unsigned tile0 = item.x * BIN_TILE;
        // the loop's bounds are the same for every lane of the block
        for (unsigned base = 0; base < len; base += 4 * BIN_THREADS) {
            uint4 r[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {       // all loads first: 4 records in flight a thread
                const unsigned k = base + j * BIN_THREADS + threadIdx.x;
                r[j] = k < len ? __ldcs(rec + start + k) : make_uint4(DEAD, 0u, 0u, 0u);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const unsigned key = r[j].x;
                // each f32 value rounded once to the fixed point, half to even
                // (a power of two times an f32 is exact in f64)
                i64 qx = 0, qy = 0, qz = 0, qw = 0;
                if (key != DEAD) {
                    const float wv = __uint_as_float(r[j].y);
                    float vx, vy, vz;
                    ray_values(g, tab, wv, __uint_as_float(r[j].z), vx, vy, vz);
                    qx = __double2ll_rn((double)vx * scale); qy = __double2ll_rn((double)vy * scale);
                    qz = __double2ll_rn((double)vz * scale); qw = __double2ll_rn((double)wv * scale);
                }
                warp_add(sums, tile0, key, qx, qy, qz, qw, lane, hot);
            }
        }
        hot_flush(sums, tile0, hot, lane);
        __syncthreads();
        if (item.w == WHOLE) {
            write_tile<true>(sums, tile0, out, aligned, inv);  // the whole tile: each lit pixel once
        } else {
            // a split tile: the lit pixels into its slot; the last item writes
            u64* slot = reinterpret_cast<u64*>(split) + (size_t)item.w * 4 * BIN_TILE;
            for (unsigned p = threadIdx.x; p < BIN_TILE; p += BIN_THREADS) {
                const i64 a = sums[p], b = sums[BIN_TILE + p];
                const i64 cc = sums[2 * BIN_TILE + p], d = sums[3 * BIN_TILE + p];
                if ((a | b | cc | d) == 0) continue;
                sums[p] = 0; sums[BIN_TILE + p] = 0; sums[2 * BIN_TILE + p] = 0; sums[3 * BIN_TILE + p] = 0;
                if (a != 0) atomicAdd(slot + p, (u64)a);
                if (b != 0) atomicAdd(slot + BIN_TILE + p, (u64)b);
                if (cc != 0) atomicAdd(slot + 2 * BIN_TILE + p, (u64)cc);
                if (d != 0) atomicAdd(slot + 3 * BIN_TILE + p, (u64)d);
            }
            __threadfence();
            __syncthreads();
            if (threadIdx.x == 0) last = atomicSub(arrive + item.w, 1u) == 1u;
            __syncthreads();
            if (last) {
                __threadfence();
                write_tile<false>(reinterpret_cast<i64*>(slot), tile0, out, aligned, inv);
            }
        }
        __syncthreads();
    }
}

// The constants the library was built with: BIN_TILE, BIN_CHUNK,
// BIN_BLOCKS_PER_SM, BIN_HIST_MAX.
extern "C" void bin_xyzw_tiles_config(long long* out)
{
    out[0] = BIN_TILE; out[1] = BIN_CHUNK; out[2] = BIN_BLOCKS_PER_SM; out[3] = BIN_HIST_MAX;
}

// Bytes of scratch a call of N rays into Nx·Ny pixels needs.
extern "C" long long bin_xyzw_tiles_scratch_bytes(long long N, long long P)
{
    return layout(N, P).total;
}

// Accumulates into `img` (Ny, Nx, 4) f32 on `stream`, through `scratch`:
// `scratch_bytes` (at least bin_xyzw_tiles_scratch_bytes(N, Nx·Ny)),
// 16-byte aligned, of any content. Allocates nothing and does not
// synchronise. Returns cudaGetLastError(), -1 for a table too large, -2 for
// a scratch that is not 16-byte aligned, -3 for one too small and -4 for N
// or Nx·Ny beyond the kernel's 32-bit indices (N < 2^31, Nx·Ny < 2^29).
extern "C" int bin_xyzw_tiles_launch(
    const void* px, const void* py, const void* w, const void* wl, long long N,
    const void* obs, int n_obs, float wl0, float wl1,
    float x0, float x1, float y0, float y1, float scale_x, float scale_y,
    int Nx, int Ny, double obs_bound, void* scratch, long long scratch_bytes, void* img, void* stream)
{
    if (n_obs > OBS_MAX || n_obs < 2) return -1;
    if (((size_t)scratch & 15) != 0) return -2;
    const long long P = (long long)Nx * Ny;
    if (N >= (1LL << 31) || P >= (1LL << 29) || Nx < 1 || Ny < 1) return -4;
    if (N <= 0) return 0;
    const Layout L = layout(N, P);
    if (scratch_bytes < L.total) return -3;
    char* base = (char*)scratch;
    unsigned* head = (unsigned*)base;
    unsigned* count = (unsigned*)(base + L.count);
    unsigned* cursor = (unsigned*)(base + L.cursor);
    uint4* items = (uint4*)(base + L.item);
    unsigned* arrive = (unsigned*)(base + L.arrive);
    uint4* rec = (uint4*)(base + L.rec);
    i64* split = (i64*)(base + L.split);

    static int n_sm[64] = {0};      // of each device at its first launch
    int dev = 0;
    cudaGetDevice(&dev);
    dev &= 63;
    if (n_sm[dev] == 0) {
        int n = 0;
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        cudaFuncSetAttribute(bin_xyzw_sum, cudaFuncAttributeMaxDynamicSharedMemorySize, 32 * BIN_TILE);
        cudaFuncSetAttribute(bin_xyzw_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, SCATTER_SMEM_MAX);
        n_sm[dev] = n > 0 ? n : 1;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    const unsigned T = (unsigned)L.tiles;
    const size_t hist = T <= BIN_HIST_MAX ? 4 * (size_t)T : 0;
    const BinArgs g = {n_obs, wl0, wl1, x0, x1, y0, y1, scale_x, scale_y, Nx, Ny, obs_bound};

    cudaMemsetAsync(scratch, 0, (size_t)L.zeroed, st);
    const long long want_c = (N + 4 * BIN_WIDE - 1) / (4 * BIN_WIDE);
    const long long most_c = (long long)n_sm[dev] * BIN_COUNT_BLOCKS_PER_SM;
    bin_xyzw_count<<<(unsigned)(want_c < most_c ? want_c : most_c), BIN_WIDE, hist, st>>>(
        (const float*)px, (const float*)py, (const float*)w, N, g, T, head, count);
    bin_xyzw_plan<<<1, PLAN_THREADS, 0, st>>>(T, head, count, cursor, items, arrive);
    const long long per_block = (long long)BIN_WIDE * BIN_RAYS_PER_THREAD;
    const size_t scatter_smem = T > BIN_HIST_MAX ? 0 : 4 * (((size_t)2 * T + 3) & ~(size_t)3) + 16 * per_block;
    bin_xyzw_scatter<<<(unsigned)((N + per_block - 1) / per_block), BIN_WIDE, scatter_smem, st>>>(
        (const float*)px, (const float*)py, (const float*)w, (const float*)wl, N, g, T, head,
        cursor, rec, split);
    const long long most_s = (long long)n_sm[dev] * BIN_BLOCKS_PER_SM;
    bin_xyzw_sum<<<(unsigned)(L.items < most_s ? L.items : most_s), BIN_THREADS, 32 * BIN_TILE, st>>>(
        rec, head, items, arrive, split, (const float*)obs, g, N, (float*)img,
        ((size_t)img & 15) == 0);
    return (int)cudaGetLastError();
}
