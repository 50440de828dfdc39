// The generic step of a function surface in one launch: for each ray the
// standoff advance, the bracketed solve over the surface's sag, the
// clamping of abnormal hits, the hit point, the circle mask (and a recorded
// user mask), and for a refraction the normal at the hit, all on chip.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA's fusion
// (optrace_tpu/ops/geom.py:hit_newton under jax.jit). The port's eager
// route (tracer/trace_core.py:_surface_hit over ops/geom.py, the normals by
// torch.func.jvp) runs it as about 2 300 small launches a batch, each
// reading and writing the whole ray state.
//
// The sag is a user's Python function of tensors, so the kernel holds no
// sag: it runs a program recorded from it (ops/sag_program.py), a
// straight-line list of elementwise f32 operations over a register file of
// at most MAX_REGS registers (x, y, the constants, the temporaries). One
// program word is an op code and four registers (result, three operands).
// The program and its constants are arguments, decoded into shared memory
// once a block: no build per surface.
//
// Design for Hopper: an interpreter pays a dispatch for every op (the word,
// the branch, the operands' addresses), which costs more than the op. So a
// thread carries RAYS rays (4) through the same program: a register is a
// float4 in shared memory (one column a thread: 16 B a thread, no bank
// conflicts), each word is decoded once for four rays, and each operand is
// one 128-bit load. The rays of a thread are neighbours, so its loads of p
// and s are 48 contiguous bytes. Everything outside the program (the
// bracket, the clamp, the mask) is straight code over the four rays in
// registers. A ray past N repeats the last ray and writes nothing.
//
// Per ray, in the eager route's order of f32 operations (ops/geom.py):
//   advance_to_standoff, hit_newton (two ends and `iters` Illinois steps,
//   each step one sag evaluation), clamp_abnormal, p_hit = ps + t * s, the
//   mask (x² + y² <= (r + N_EPS)², and the recorded mask program), then
//   the outputs where the ray was alive before the step. The normals take
//   one more evaluation of the program with two tangents (forward mode):
//   n = (−∂z/∂x, −∂z/∂y, 1) / √(∂z/∂x² + ∂z/∂y² + 1). Every ray runs every
//   step: no early exit, no fewer iterations, no lower precision.
//
// Each op is PyTorch's CUDA kernel of it (ops/sag_program.py records the
// special cases: the division by a Python number as the product with the
// f64 reciprocal, PyTorch's pow specializations); comparisons with numbers
// are in f32; torch.minimum/maximum propagate NaN.
//
// Bound: per ray 28 B in (p, s, hw) and 40 B out (p, hit, ill, normals):
// 68 MB at 10⁶ rays, 0.020 ms at 3.35 TB/s; the operations, about
// 44 × (the program's ops) + 40 × 15 for the solve, some 1 800–2 300 f32
// operations a ray for the keratoconic cornea, 0.03 ms at 67 TFLOP/s. The
// operations bound it; the interpreter's dispatch, shared over four rays,
// and the operands' trips through shared memory cost several times that.
//
// Arithmetic contract: no --use_fast_math and -fmad=false (ops/_build.py),
// so every operation is the IEEE f32 operation of the eager route; expf,
// logf, sinf, cosf, tanf, powf, sqrtf and rsqrtf are the functions
// PyTorch's kernels call.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_REGS 64
#define MAX_OPS 256
#define TPB 64       // threads a block
#define RAYS 4       // rays a thread: the components of a float4

// the op codes of ops/sag_program.py:OPS, in its order
enum Op {
    OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_DIV = 3, OP_NEG = 4, OP_SQR = 5, OP_CUBE = 6,
    OP_INVSQR = 7, OP_RECIP = 8, OP_SQRT = 9, OP_RSQRT = 10, OP_POW = 11, OP_EXP = 12,
    OP_LOG = 13, OP_SIN = 14, OP_COS = 15, OP_TAN = 16, OP_ABS = 17, OP_WHERE = 18, OP_GT = 19,
    OP_GE = 20, OP_LT = 21, OP_LE = 22, OP_EQ = 23, OP_NE = 24, OP_AND = 25, OP_OR = 26,
    OP_XOR = 27, OP_NOT = 28, OP_ONE = 29, OP_COPY = 30
};

// A program in shared memory: its words decoded into (op, result, a, b) and
// the third operand c apart (where's second branch). An operand is a slot of
// the thread's register file (x, y, the temporaries) or, where negative, the
// constant -1 - k of the block's array.
struct Prog {
    const int4* code;
    const int* c;
    int n_ops;
    const float* consts;
    int out;
};

template <typename Fn>
__device__ __forceinline__ float4 map4(Fn f, float4 a, float4 b, float4 c)
{
    return make_float4(f(a.x, b.x, c.x), f(a.y, b.y, c.y), f(a.z, b.z, c.z), f(a.w, b.w, c.w));
}

__device__ __forceinline__ float truth(bool v) { return v ? 1.f : 0.f; }

// one op on the four rays, dispatched once
__device__ __forceinline__ float4 apply(int op, float4 A, float4 B, float4 C)
{
    switch (op) {
        case OP_ADD: return map4([](float a, float b, float) { return a + b; }, A, B, C);
        case OP_SUB: return map4([](float a, float b, float) { return a - b; }, A, B, C);
        case OP_MUL: return map4([](float a, float b, float) { return a * b; }, A, B, C);
        case OP_DIV: return map4([](float a, float b, float) { return a / b; }, A, B, C);
        case OP_NEG: return map4([](float a, float, float) { return -a; }, A, B, C);
        case OP_SQR: return map4([](float a, float, float) { return a * a; }, A, B, C);
        case OP_CUBE: return map4([](float a, float, float) { return a * a * a; }, A, B, C);
        case OP_INVSQR:
            return map4([](float a, float, float) { return (float)(1.0 / (double)(a * a)); }, A, B, C);
        case OP_RECIP: return map4([](float a, float, float) { return 1.0f / a; }, A, B, C);
        case OP_SQRT: return map4([](float a, float, float) { return sqrtf(a); }, A, B, C);
        case OP_RSQRT: return map4([](float a, float, float) { return rsqrtf(a); }, A, B, C);
        case OP_POW: return map4([](float a, float b, float) { return powf(a, b); }, A, B, C);
        case OP_EXP: return map4([](float a, float, float) { return expf(a); }, A, B, C);
        case OP_LOG: return map4([](float a, float, float) { return logf(a); }, A, B, C);
        case OP_SIN: return map4([](float a, float, float) { return sinf(a); }, A, B, C);
        case OP_COS: return map4([](float a, float, float) { return cosf(a); }, A, B, C);
        case OP_TAN: return map4([](float a, float, float) { return tanf(a); }, A, B, C);
        case OP_ABS: return map4([](float a, float, float) { return fabsf(a); }, A, B, C);
        case OP_WHERE: return map4([](float a, float b, float c) { return (a != 0.f) ? b : c; }, A, B, C);
        case OP_GT: return map4([](float a, float b, float) { return truth(a > b); }, A, B, C);
        case OP_GE: return map4([](float a, float b, float) { return truth(a >= b); }, A, B, C);
        case OP_LT: return map4([](float a, float b, float) { return truth(a < b); }, A, B, C);
        case OP_LE: return map4([](float a, float b, float) { return truth(a <= b); }, A, B, C);
        case OP_EQ: return map4([](float a, float b, float) { return truth(a == b); }, A, B, C);
        case OP_NE: return map4([](float a, float b, float) { return truth(a != b); }, A, B, C);
        case OP_AND:
            return map4([](float a, float b, float) { return truth(a != 0.f && b != 0.f); }, A, B, C);
        case OP_OR:
            return map4([](float a, float b, float) { return truth(a != 0.f || b != 0.f); }, A, B, C);
        case OP_XOR:
            return map4([](float a, float b, float) { return truth((a != 0.f) != (b != 0.f)); }, A, B, C);
        case OP_NOT: return map4([](float a, float, float) { return truth(a == 0.f); }, A, B, C);
        case OP_ONE: return make_float4(1.f, 1.f, 1.f, 1.f);
        default: return A;    // OP_COPY
    }
}

// the tangent of one op's result v from its operands' values (a, b) and
// tangents (ta, tb, tc) for one ray (ops/sag_program.py:_tangent, same order)
__device__ __forceinline__ float tangent(int op, float v, float a, float b, float ta, float tb, float tc)
{
    switch (op) {
        case OP_ADD: return ta + tb;
        case OP_SUB: return ta - tb;
        case OP_MUL: return ta * b + a * tb;
        case OP_DIV: return (ta - v * tb) / b;
        case OP_NEG: return -ta;
        case OP_SQR: return (2.f * a) * ta;
        case OP_CUBE: return (3.f * (a * a)) * ta;
        case OP_INVSQR: return (-2.f * v / a) * ta;
        case OP_RECIP: return (-(v * v)) * ta;
        case OP_SQRT: return ta / (v + v);
        case OP_RSQRT: return (-0.5f * v * v * v) * ta;
        case OP_POW: return (b * powf(a, b - 1.f)) * ta;
        case OP_EXP: return v * ta;
        case OP_LOG: return ta / a;
        case OP_SIN: return cosf(a) * ta;
        case OP_COS: return (-sinf(a)) * ta;
        case OP_TAN: return (1.f + v * v) * ta;
        case OP_ABS: return ((a > 0.f) ? 1.f : ((a < 0.f) ? -1.f : 0.f)) * ta;
        case OP_WHERE: return (a != 0.f) ? tb : tc;
        case OP_COPY: return ta;
        default: return 0.f;  // comparisons, logic, fill: no derivative
    }
}

__device__ __forceinline__ float get(const float4& v, int j)
{
    return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ void set(float4& v, int j, float x)
{
    if (j == 0) v.x = x; else if (j == 1) v.y = x; else if (j == 2) v.z = x; else v.w = x;
}

// The register file of a thread: slot k at R[k * TPB] of the block's shared
// array of float4 (one column a thread: 16 B a thread, no bank conflicts);
// the constants, the same for every ray, once a block.
__device__ __forceinline__ float4 operand(int k, const float4* R, const float* C)
{
    if (k < 0) {
        const float c = C[-1 - k];
        return make_float4(c, c, c, c);
    }
    return R[k * TPB];
}

// the program at the four rays' (x, y)
__device__ __forceinline__ float4 run(const Prog& P, float4 x, float4 y, float4* R)
{
    R[0] = x;
    R[TPB] = y;
    for (int k = 0; k < P.n_ops; ++k) {
        const int4 w = P.code[k];
        const float4 a = operand(w.z, R, P.consts), b = operand(w.w, R, P.consts);
        const float4 c = (w.x == OP_WHERE) ? operand(P.c[k], R, P.consts) : a;
        R[w.y * TPB] = apply(w.x, a, b, c);
    }
    return operand(P.out, R, P.consts);
}

__device__ __forceinline__ float4 tangent_of(int k, const float4* u)
{
    return k < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : u[k];
}

// the program at the four rays' (x, y) with each value's tangents along x
// (u) and y (w), kept in the thread's own arrays by slot
__device__ __forceinline__ void run_dual(const Prog& P, float4 x, float4 y, float4* R, float4* u, float4* w,
                                         float4* dzdx, float4* dzdy)
{
    R[0] = x; R[TPB] = y;
    u[0] = make_float4(1.f, 1.f, 1.f, 1.f); u[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    w[0] = u[1]; w[1] = u[0];
    for (int k = 0; k < P.n_ops; ++k) {
        const int4 q = P.code[k];
        const int ic = (q.x == OP_WHERE) ? P.c[k] : q.z;
        const float4 a = operand(q.z, R, P.consts), b = operand(q.w, R, P.consts);
        const float4 c = operand(ic, R, P.consts);
        const float4 v = apply(q.x, a, b, c);
        const float4 ua = tangent_of(q.z, u), ub = tangent_of(q.w, u), uc = tangent_of(ic, u);
        const float4 wa = tangent_of(q.z, w), wb = tangent_of(q.w, w), wc = tangent_of(ic, w);
        float4 du, dw;
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
            set(du, j, tangent(q.x, get(v, j), get(a, j), get(b, j), get(ua, j), get(ub, j), get(uc, j)));
            set(dw, j, tangent(q.x, get(v, j), get(a, j), get(b, j), get(wa, j), get(wb, j), get(wc, j)));
        }
        R[q.y * TPB] = v; u[q.y] = du; w[q.y] = dw;
    }
    *dzdx = tangent_of(P.out, u);
    *dzdy = tangent_of(P.out, w);
}

// a program's register as an operand: x and y keep slots 0 and 1, the
// constants (registers 2 … 1 + nc) become -1 - k, the temporaries move down
// by nc
__device__ __forceinline__ int slot(int reg, int nc)
{
    return reg < 2 ? reg : (reg < 2 + nc ? 1 - reg : reg - nc);
}

// a program's packed words (ops/sag_program.py:encode) and constants into
// shared memory
__device__ __forceinline__ void decode(const int* __restrict__ words, int n, const float* __restrict__ consts,
                                       int nc, int4* code, int* c, float* C)
{
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int w = words[k];
        code[k] = make_int4(w & 31, slot((w >> 5) & 63, nc), slot((w >> 11) & 63, nc),
                            slot((w >> 17) & 63, nc));
        c[k] = slot((w >> 23) & 63, nc);
    }
    for (int k = threadIdx.x; k < nc; k += blockDim.x) C[k] = consts[k];
}

__device__ __forceinline__ float4 along(const float* o, const float* t, const float* d)
{
    return make_float4(o[0] + t[0] * d[0], o[1] + t[1] * d[1], o[2] + t[2] * d[2], o[3] + t[3] * d[3]);
}

__device__ __forceinline__ float4 pack(const float* a)
{
    return make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ float nan_min(float a, float b)
{
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b)
{
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

struct Consts {
    float eps;       // C_EPS / 10, the bracket's margin
    float c_eps;     // C_EPS
    float n_eps;     // N_EPS
    float standoff;  // ADVANCE_STANDOFF
};

__global__ void __launch_bounds__(TPB) generic_hit_kernel(
    const float* __restrict__ p, const float* __restrict__ s, const unsigned char* __restrict__ hw,
    long long N, const float* __restrict__ zmin_p, const float* __restrict__ zmax_p,
    const float* __restrict__ r_p,
    const int* __restrict__ sag_code, int sag_n, const float* __restrict__ sag_consts, int sag_nc,
    int sag_out,
    const int* __restrict__ mask_code, int mask_n, const float* __restrict__ mask_consts,
    int mask_nc, int mask_out, int n_slots, int iters, Consts K,
    float* __restrict__ p_new, unsigned char* __restrict__ hit_out, unsigned char* __restrict__ ill_out,
    float* __restrict__ normals, float* __restrict__ t_dbg, unsigned char* __restrict__ valid_dbg,
    unsigned char* __restrict__ broken_dbg)
{
    // shared: the register files (n_slots × TPB float4), then each program's
    // decoded words, third operands and constants
    extern __shared__ float4 s_regs[];
    int4* s_code = (int4*)(s_regs + n_slots * TPB);
    int* s_c = (int*)(s_code + sag_n + mask_n);
    float* s_consts = (float*)(s_c + sag_n + mask_n);
    decode(sag_code, sag_n, sag_consts, sag_nc, s_code, s_c, s_consts);
    decode(mask_code, mask_n, mask_consts, mask_nc, s_code + sag_n, s_c + sag_n, s_consts + sag_nc);
    __syncthreads();

    const long long i0 = ((long long)blockIdx.x * TPB + threadIdx.x) * RAYS;
    if (i0 >= N) return;
    const Prog S = {s_code, s_c, sag_n, s_consts, slot(sag_out, sag_nc)};
    float4* R = s_regs + threadIdx.x;

    const float zmin = *zmin_p, zmax = *zmax_p;
    float px[RAYS], py[RAYS], pz[RAYS], sx[RAYS], sy[RAYS], sz[RAYS], ox[RAYS], oy[RAYS], oz[RAYS];
    float t1[RAYS], t2[RAYS], f1[RAYS], f2[RAYS], ts[RAYS];
    bool alive[RAYS], ill[RAYS];
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
        const long long q = (i0 + j < N) ? i0 + j : N - 1;     // past N: the last ray again
        px[j] = p[3 * q]; py[j] = p[3 * q + 1]; pz[j] = p[3 * q + 2];
        sx[j] = s[3 * q]; sy[j] = s[3 * q + 1]; sz[j] = s[3 * q + 2];
        alive[j] = hw[q] != 0;
        // geom.advance_to_standoff
        const bool ok0 = alive[j] && (sz[j] != 0.f);
        const float z_floor = zmin - K.standoff;
        const float t0 = (z_floor - pz[j]) / (ok0 ? sz[j] : 1.f);
        const bool adv = ok0 && (t0 > 0.f);
        ox[j] = adv ? px[j] + t0 * sx[j] : px[j];
        oy[j] = adv ? py[j] + t0 * sy[j] : py[j];
        oz[j] = adv ? pz[j] + t0 * sz[j] : pz[j];
        // geom.hit_newton's bracket
        t1[j] = ((zmin - K.eps) - oz[j]) / sz[j];
        t1[j] = (t1[j] != t1[j]) ? t1[j] : fmaxf(t1[j], -K.c_eps);
        t2[j] = ((zmax + K.eps) - oz[j]) / sz[j];
    }

    // geom.hit_newton, F(t) = oz + t sz − sag(ox + t sx, oy + t sy), for four
    // rays at a time: the bracket's two ends, then `iters` Illinois steps
    for (int it = -2; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
            if (it == -2) {
                ts[j] = t1[j];
            } else if (it == -1) {
                ts[j] = t2[j];
            } else {
                const float df = f2[j] - f1[j];
                const float denom = (fabsf(df) > K.n_eps) ? df : 1.f;
                const float e = t1[j] - f1[j] / denom * (t2[j] - t1[j]);
                const float mid = 0.5f * (t1[j] + t2[j]);
                const bool inside = (e > nan_min(t1[j], t2[j])) && (e < nan_max(t1[j], t2[j]));
                ts[j] = inside ? e : mid;
            }
        }
        const float4 g = run(S, along(ox, ts, sx), along(oy, ts, sy), R);
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
            const float fs = (oz[j] + ts[j] * sz[j]) - get(g, j);
            if (it == -2) {
                f1[j] = fs;
            } else if (it == -1) {
                f2[j] = fs;
                ill[j] = f1[j] * f2[j] > 0.f;
            } else {
                const bool left = f1[j] * fs <= 0.f;
                const float nt1 = left ? t1[j] : ts[j], nf1 = left ? 0.5f * f1[j] : fs;
                const float nt2 = left ? ts[j] : t2[j], nf2 = left ? fs : 0.5f * f2[j];
                t1[j] = nt1; f1[j] = nf1; t2[j] = nt2; f2[j] = nf2;
            }
        }
    }

    float hx[RAYS], hy[RAYS], hz[RAYS];
    bool in[RAYS];
    const float re = *r_p + K.n_eps;
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
        const float t = 0.5f * (t1[j] + t2[j]);
        const bool valid = isfinite(t) && !ill[j];
        // geom.clamp_abnormal
        const bool t_fin = isfinite(t);
        const float t_safe = t_fin ? t : 0.f;
        const float z_hit = oz[j] + t_safe * sz[j];
        const bool beh = oz[j] > (zmax + K.n_eps);
        const bool neg = z_hit < oz[j] - K.c_eps;
        const bool bad = !valid || neg || !t_fin;
        const bool sz_ok = sz[j] != 0.f;
        float t_zmax = (zmax - oz[j]) / (sz_ok ? sz[j] : 1.f);
        t_zmax = sz_ok ? t_zmax : 0.f;
        float t_out = (bad && !beh) ? t_zmax : t_safe;
        t_out = beh ? 0.f : t_out;
        const bool ok = !(bad || beh);
        const bool broken = (bad && !beh) || beh;
        // the hit point and the circle mask
        hx[j] = ox[j] + t_out * sx[j];
        hy[j] = oy[j] + t_out * sy[j];
        hz[j] = oz[j] + t_out * sz[j];
        in[j] = (hx[j] * hx[j] + hy[j] * hy[j] <= re * re) && ok;
        if (i0 + j < N) {
            if (t_dbg) t_dbg[i0 + j] = t;
            if (valid_dbg) valid_dbg[i0 + j] = valid;
            if (broken_dbg) broken_dbg[i0 + j] = broken && alive[j];
        }
    }
    if (mask_n > 0) {
        const Prog M = {s_code + sag_n, s_c + sag_n, mask_n, s_consts + sag_nc, slot(mask_out, mask_nc)};
        const float4 g = run(M, pack(hx), pack(hy), R);
#pragma unroll
        for (int j = 0; j < RAYS; ++j) in[j] = in[j] && get(g, j) != 0.f;
    }
    float qx[RAYS], qy[RAYS];
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
        qx[j] = alive[j] ? hx[j] : px[j];
        qy[j] = alive[j] ? hy[j] : py[j];
        if (i0 + j < N) {
            p_new[3 * (i0 + j)] = qx[j];
            p_new[3 * (i0 + j) + 1] = qy[j];
            p_new[3 * (i0 + j) + 2] = alive[j] ? hz[j] : pz[j];
            hit_out[i0 + j] = in[j] && alive[j];
            ill_out[i0 + j] = ill[j] && alive[j];
        }
    }

    if (normals) {
        float4 u[MAX_REGS], w[MAX_REGS];
        float4 dx, dy;
        run_dual(S, pack(qx), pack(qy), R, u, w, &dx, &dy);
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
            if (i0 + j >= N) continue;
            const float nx = -get(dx, j), ny = -get(dy, j);
            const float norm = sqrtf(nx * nx + ny * ny + 1.f);
            normals[3 * (i0 + j)] = nx / norm;
            normals[3 * (i0 + j) + 1] = ny / norm;
            normals[3 * (i0 + j) + 2] = 1.f / norm;
        }
    }
}

// Launches the kernel on `stream` for N rays. p, s: (N, 3) f32 in the
// surface's frame; hw: (N,) bool, the rays alive before the step; zmin,
// zmax, r: device pointers to the surface's f32 parameters; the sag program
// (sag_n words, sag_nc constants, result register sag_out) and the mask
// program (mask_n = 0: none), each within MAX_OPS words and MAX_REGS
// registers, n_slots the larger of the two programs' registers less their
// constants; p_new (N, 3), hit and ill (N,) out; normals (N, 3), t, valid
// and broken may be null. Allocates nothing and does not synchronise.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a program
// outside the limits.
extern "C" int generic_hit_launch(
    const void* p, const void* s, const void* hw, long long N,
    const void* zmin, const void* zmax, const void* r,
    const void* sag_code, int sag_n, const void* sag_consts, int sag_nc, int sag_out,
    const void* mask_code, int mask_n, const void* mask_consts, int mask_nc, int mask_out,
    int n_slots, int iters, float eps, float c_eps, float n_eps, float standoff,
    void* p_new, void* hit, void* ill, void* normals, void* t, void* valid, void* broken,
    void* stream)
{
    if (N <= 0) return 0;
    if (sag_n < 0 || sag_n > MAX_OPS || mask_n < 0 || mask_n > MAX_OPS || sag_nc < 0 || mask_nc < 0
        || 2 + sag_nc > MAX_REGS || 2 + mask_nc > MAX_REGS || sag_out < 0 || sag_out >= MAX_REGS
        || mask_out < 0 || mask_out >= MAX_REGS || n_slots < 2 || n_slots > MAX_REGS)
        return (int)cudaErrorInvalidValue;
    // shared memory above the 48 kB a launch may take unasked: set once, for
    // the largest program, before any capture
    static const int raised = cudaFuncSetAttribute(
        generic_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_REGS * TPB * sizeof(float4) + 2 * MAX_OPS * (sizeof(int4) + sizeof(int))
              + 2 * MAX_REGS * sizeof(float)));
    if (raised != 0) return raised;
    const Consts K = {eps, c_eps, n_eps, standoff};
    const long long threads = (N + RAYS - 1) / RAYS;
    const unsigned blocks = (unsigned)((threads + TPB - 1) / TPB);
    const size_t smem = (size_t)n_slots * TPB * sizeof(float4) + (size_t)(sag_n + mask_n) * (sizeof(int4) + sizeof(int))
                        + (size_t)(sag_nc + mask_nc) * sizeof(float);
    generic_hit_kernel<<<blocks, TPB, smem, (cudaStream_t)stream>>>(
        (const float*)p, (const float*)s, (const unsigned char*)hw, N, (const float*)zmin,
        (const float*)zmax, (const float*)r, (const int*)sag_code, sag_n, (const float*)sag_consts,
        sag_nc, sag_out, (const int*)mask_code, mask_n, (const float*)mask_consts, mask_nc, mask_out,
        n_slots, iters, K, (float*)p_new, (unsigned char*)hit, (unsigned char*)ill, (float*)normals,
        (float*)t, (unsigned char*)valid, (unsigned char*)broken);
    return (int)cudaGetLastError();
}
