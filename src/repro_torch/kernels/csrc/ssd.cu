// The Mamba-2 state-space-duality (SSD) scan, chunked dual form, group
// size 1, forward only.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_kernel (driven by
// ssd_scan).  On the TPU the grid is (b, H, n_chunks) with the chunk axis
// innermost and sequential: the (P, N) state is carried in VMEM scratch from
// one grid step to the next, and each step holds a (Q, Q) fp32 score tile
// (256 KB at Q 256) plus the chunk's B and C in VMEM.  Blocks on the H100
// run in no order and a block may opt into at most 227 KB of shared memory,
// so here one block owns one (batch, head), walks the chunks in order
// itself with the fp32 state resident in shared memory, and tiles each
// chunk's quadratic term into 64 x 64 sub-tiles at or below the diagonal.
//
// What it computes, per (b, h), for x (b, S, H, P), dt (b, S, H) fp32
// (post-softplus), A (H,) fp32 < 0, B and C (b, S, N) in x's type: with a =
// dt * A[h] and, within a chunk of Q tokens, a_cum its running sum,
//     y     = (L o C B^T)(x dt) + (C state^T) exp(a_cum)
//     L_ij  = exp(a_cum_i - a_cum_j) for i >= j, 0 above the diagonal
//     state = state exp(a_tot) + (x dt exp(a_tot - a_cum))^T B
// y is written in x's type straight into (b, S, H, P), the final state in
// fp32 (b, H, P, N).  The last chunk is bounded by S: tokens past it load
// as x = B = C = 0 and a = 0, which is the reference's zero padding (dt = 0
// there), and nothing past S is stored.  exp is evaluated only where i >= j
// is selected, never above the diagonal (exp(+large) = inf, inf * 0 = NaN).
// x, B and C are read in place through their batch and token strides (the
// model hands views into the conv output, token stride conv_ch); dt and
// dt * A are applied here in fp32; y is written in the caller's layout —
// no fp32 (b, H, S, P) copy of x dt, no padded copies, no transposes.
//
// What bounds it on an H100: bytes.  Per (b, chunk) the lower triangle of
// C B^T (all heads share B and C), per (b, h, chunk) its masked product with
// x and the 4QNP of C state^T and the state update: 25.3 GFLOP at the
// mamba2-1.3b serving shape (4, 2000, 64, 64, 128, 256) would take 25.6 us
// at the bf16 tensor-core rate, while x, y, dt, B, C and the state take
// 43.5 us at 3.35 TB/s.  Two kernels:
//
// * ssd_scan_kernel_mma, bf16 inputs, on the tensor cores (m16n8k16 bf16
//   mma.sync, fp32 accumulate; fragment helpers in tensor_core.cuh).  One
//   block of 4 warps per (b, h), chunks in order; each 64-row query
//   sub-tile i has 16 rows per warp, like the flash forward with C for q, B
//   for k and x for v:
//     - acc = C_i state^T, the state's fp32 pairs packed to bf16 B
//       fragments as they are read (the state rounded once, as an operand),
//       scaled per row by exp(a_cum_i) in fp32 (skipped in the first
//       chunk, where the state is 0);
//     - for each key sub-tile j <= i: S = C_i B_j^T, then in registers, in
//       fp32, (L o S)_ij dt_j, rounded to bf16 once as the A operand of acc
//       += (.) x_j (x by ldmatrix.trans): dt sits on the score side, so x,
//       B and C go into every product exact.  Off the diagonal L factors
//       as exp2(a_i - a_ref) exp2(a_ref - a_j) through the a_cum before
//       sub-tile i (both factors <= 1), so a thread takes 16 exps per
//       stage for its 32 entries; on the diagonal a warp skips the key
//       columns past its last row;
//     - the state update, d = (x_j w_j)^T B_j per 64-token sub-tile j with
//       w = dt exp(a_tot - a_cum): x by ldmatrix.trans, scaled by w in fp32
//       and carried as hi = bf16(x w) plus lo = bf16(x w - hi) into two
//       products with the same exact B fragments, added to the fp32 state
//       in shared memory (scaled by exp(a_tot) at the first).  One rounding
//       of x w leaves the state 1.6e-3 to 3.4e-3 of its scale from the
//       plain version, past the 1e-4 the state is held to; hi + lo leaves
//       2e-6 to 5e-6 (tests/test_torch_ssd.py, the rounding model).  It
//       runs in the stages of the chunk's last query sub-tile, which visits
//       every key sub-tile once, after that sub-tile's C state^T.  Each warp
//       owns 16-row x 64-column items of the state, so the read-modify-write
//       needs no atomics.
//   C_i, B_j, x_j and dt come through cp.async: x in 16-byte copies, B and
//   C in 16-byte copies when N % 8 == 0 and they lie on the 16-byte grid,
//   else in 8-byte ones, dt in 4-byte ones; rows past the ragged edge are
//   zero-filled by the copy's src-size.  B_j and x_j stream through two
//   buffers: sub-tile i visits j = i - 1 first (still resident from the
//   last stage), then 0 .. i - 2, the diagonal last, so a chunk of four
//   sub-tiles loads 7 (B, x) sub-tiles for its 10 stages, and the next one
//   is in flight while the current multiplies.  C_i + 1 (or the next
//   chunk's C_0 and dt) goes in flight as soon as the diagonal stage's S has
//   read C_i.  One barrier per stage: the prefetch into the other buffer is
//   issued after it.  N is padded to a multiple of 16 with zeros in shared
//   memory.  Rows are padded by 16 bytes, so ldmatrix and the state's
//   float2 reads meet no bank conflicts.  a_cum (in log2 units, for exp2f)
//   and w are formed once per chunk in shared memory; a_cum is a
//   fixed-order parallel scan — per-thread runs, warp shuffles, then the
//   warp totals in order — with no atomics, so a second launch is
//   bit-equal (its fp32 rounding order differs from jnp.cumsum's; the
//   tolerances cover that).  Shared memory at the full config (P 64, N 128,
//   Q 256): 109,584 bytes (state 34,816, C 17,408, two B 34,816, two x
//   18,432, two chunks' dt, a_cum, w 4,112), so two blocks share an SM and
//   the serving batch's 256 blocks run in one wave on 132 SMs; 214
//   registers at P 64, no spills (ptxas -v, nvcc 12.9; chip_smoke.py prints
//   every instance).  With 8 warps per SM the products run far below the
//   tensor cores' rate: every stage waits on its ldmatrix -> mma chains
//   and a barrier.  C B^T is computed per head (a third of the mma work at
//   the serving shape): sharing it across heads, and splitting the grid
//   over p-slabs for batch 1, are later work.
// * ssd_scan_kernel, fp32 inputs, fp32 FMA on the CUDA cores (fp32 must
//   meet 1e-4 of the sequential recurrence; no TF32).  4P threads; the
//   chunk's a_cum scanned by thread 0 in token order; for each 64-row query
//   sub-tile the block loads C_i (fp32, n-major, padded stride 68), computes
//   C_i state^T, then for each key sub-tile j <= i loads B_j and x_j dt_j,
//   forms the masked score tile in shared memory and accumulates it times
//   x_j dt_j in registers (each thread a 4 x 4 (row, p) block of y_i); then
//   the state is scaled by exp(a_tot) and gets (x_j dt_j exp(a_tot -
//   a_cum))^T B_j added, each thread owning 4 x 4 (p, n) blocks.  137,216
//   bytes of shared memory at the full config, one block per SM.
//
// Head dims P are template parameters (16 for the reduced test configs,
// 32, 64 and 128).  Wider or other heads, and states too wide for a
// block's shared memory, are cut by the wrapper (ssd.py's kernel_plan):
//   - P slabs.  Given dt, A, B and C, the columns of y and the rows of the
//     state are independent, so a head of P columns (rounded up to 16
//     with zero columns) runs as slabs of compiled widths: one launch per
//     width, its slabs an index of the grid (block = (head, batch, slab)),
//     each slab reading x at its column offset through x's head stride
//     and writing its columns of y and rows of the state.
//   - N pieces.  C B^T and C state^T are sums over N, and the state's
//     columns evolve independently, so the wrapper walks N in pieces, one
//     launch each on the same stream: every piece writes its columns of
//     the state, and y is the sum of the pieces' y, kept in fp32 (y
//     itself for fp32 inputs, a scratch buffer for bf16) and rounded to
//     y's type by the last piece.
// The plan depends on (P, N, dtype) alone and keeps the compiled instance
// wherever it fits at chunk 256: every registered arch's shape runs one
// launch as before.  Limits that stay: P <= 256, N <= 512, and the chunk
// the plan's widest launch fits in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int TQ = 64;          // rows of a sub-tile of a chunk

// ---------------------------------------------------------------------------
// ssd_scan_kernel: fp32, FMA
// ---------------------------------------------------------------------------

constexpr int LDK = TQ + 4;     // padded stride of the n-major tiles

// where a launch's slabs and state piece lie in the whole problem: x's
// head stride (elements); the width PT of y's and the state's heads and
// the first column p0 of the launch's first slab (slab s starts at p0 + s
// P); the state's width NT and the piece's first column n0; whether the
// piece is the first (y is written, not added to) and the last (the bf16
// kernel rounds the fp32 sum into y)
struct Geometry {
    long long xsh;
    int PT, p0, NT, n0, first, last;
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// rows t0 .. t0 + TQ - 1 (chunk-relative; rows >= q_len load zeros) of a
// (b, S, N) operand into dst[n * LDK + row]
__device__ void load_nmajor(float* dst, const float* src,
                            long long tok_stride, int t0, int q_len, int N,
                            int tid, int nt) {
    for (int e = tid; e < TQ * N; e += nt) {
        const int r = e / N, n = e % N;
        const int t = t0 + r;
        dst[n * LDK + r] = t < q_len ? src[t * tok_stride + n] : 0.f;
    }
}

template <int P>
__global__ void __launch_bounds__(4 * P)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ state_out, int batch, int S, int H, int N,
                int chunk, long long xsb, long long xss, long long bsb,
                long long bss, long long csb, long long css, Geometry geo) {
    constexpr int NT = 4 * P;            // threads
    constexpr int PG = P / 4;            // 4-wide column groups of p
    // block (head, batch, slab), heads fastest
    const int h = (int)(blockIdx.x % H), b = (int)(blockIdx.x / H % batch);
    const int p_off = geo.p0 + (int)(blockIdx.x / H / batch) * P;
    const int tid = threadIdx.x;

    extern __shared__ float smem[];
    float* Cs = smem;                    // N x LDK, C of the query sub-tile
    float* Bs = Cs + N * LDK;            // N x LDK, B of the key sub-tile
    float* Xs = Bs + N * LDK;            // TQ x P, x dt (x dt decay) rows
    float* Ss = Xs + TQ * P;             // TQ x LDK, masked scores, c-major
    float* St = Ss + TQ * LDK;           // N x P, the state, n-major
    float* acum = St + N * P;            // n_sub * TQ, a_cum of the chunk

    const float Ah = A[h];
    const float* xb = x + b * xsb + h * geo.xsh + p_off;
    const float* Bb = Bm + b * bsb;
    const float* Cb = Cm + b * csb;
    const float* dtb = dt + (long long)b * S * H + h;
    float* yb = y + ((long long)b * S * H + h) * geo.PT + p_off;

    for (int e = tid; e < N * P; e += NT) St[e] = 0.f;

    // the thread's 4 x 4 block of a y sub-tile: rows r0.., columns p0..
    const int r0 = (tid / PG) * 4, p0 = (tid % PG) * 4;

    for (int c0 = 0; c0 < S; c0 += chunk) {
        const int q_len = min(chunk, S - c0);
        const int tiles = (q_len + TQ - 1) / TQ;
        const float* xc = xb + c0 * xss;
        const float* Bc = Bb + c0 * bss;
        const float* Cc = Cb + c0 * css;
        const float* dtc = dtb + (long long)c0 * H;
        __syncthreads();                 // the last chunk is done with acum
        for (int q = tid; q < tiles * TQ; q += NT)
            acum[q] = q < q_len ? dtc[(long long)q * H] * Ah : 0.f;
        __syncthreads();
        if (tid == 0) {                  // in token order, as jnp.cumsum
            float run = 0.f;
            for (int q = 0; q < tiles * TQ; ++q) {
                run += acum[q];
                acum[q] = run;
            }
        }
        __syncthreads();
        const float a_tot = acum[q_len - 1];

        for (int it = 0; it < tiles; ++it) {
            const int i0 = it * TQ;
            __syncthreads();             // Cs / Ss of the last sub-tile read
            load_nmajor(Cs, Cc, css, i0, q_len, N, tid, NT);
            __syncthreads();
            // off = C_i state^T (scaled by exp(a_cum) at the store)
            float off[4][4] = {};
            for (int n = 0; n < N; ++n) {
                const float4 c = ld4(Cs + n * LDK + r0);
                const float4 s = ld4(St + n * P + p0);
                const float cv[4] = {c.x, c.y, c.z, c.w};
                const float sv[4] = {s.x, s.y, s.z, s.w};
                #pragma unroll
                for (int i = 0; i < 4; ++i)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j)
                        off[i][j] = fmaf(cv[i], sv[j], off[i][j]);
            }
            float acc[4][4] = {};
            for (int jt = 0; jt <= it; ++jt) {
                const int j0 = jt * TQ;
                __syncthreads();         // Bs / Xs / Ss of the last j read
                load_nmajor(Bs, Bc, bss, j0, q_len, N, tid, NT);
                for (int e = tid; e < TQ * P; e += NT) {
                    const int r = e / P, p = e % P, t = j0 + r;
                    Xs[e] = t < q_len ? xc[t * xss + p]
                        * dtc[(long long)t * H] : 0.f;
                }
                __syncthreads();
                // the masked score tile: 16 4x4 blocks per row of blocks
                for (int blk = tid; blk < (TQ / 4) * (TQ / 4); blk += NT) {
                    const int rb = (blk / (TQ / 4)) * 4;
                    const int cb = (blk % (TQ / 4)) * 4;
                    float s[4][4] = {};
                    for (int n = 0; n < N; ++n) {
                        const float4 c = ld4(Cs + n * LDK + rb);
                        const float4 k = ld4(Bs + n * LDK + cb);
                        const float cv[4] = {c.x, c.y, c.z, c.w};
                        const float kv[4] = {k.x, k.y, k.z, k.w};
                        #pragma unroll
                        for (int i = 0; i < 4; ++i)
                            #pragma unroll
                            for (int j = 0; j < 4; ++j)
                                s[i][j] = fmaf(cv[i], kv[j], s[i][j]);
                    }
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int gj = j0 + cb + j;
                        float v[4];
                        #pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int gi = i0 + rb + i;
                            v[i] = gi >= gj
                                ? s[i][j] * expf(acum[gi] - acum[gj]) : 0.f;
                        }
                        *reinterpret_cast<float4*>(Ss + (cb + j) * LDK + rb) =
                            make_float4(v[0], v[1], v[2], v[3]);
                    }
                }
                __syncthreads();
                for (int c = 0; c < TQ; ++c) {
                    const float4 s = ld4(Ss + c * LDK + r0);
                    const float4 xv = ld4(Xs + c * P + p0);
                    const float sv[4] = {s.x, s.y, s.z, s.w};
                    const float xw[4] = {xv.x, xv.y, xv.z, xv.w};
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[i][j] = fmaf(sv[i], xw[j], acc[i][j]);
                }
            }
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int t = i0 + r0 + i;
                if (t >= q_len) continue;
                const float ea = expf(acum[t]);
                float* yr = yb + (long long)(c0 + t) * H * geo.PT + p0;
                #pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float v = acc[i][j] + off[i][j] * ea;
                    yr[j] = geo.first ? v : yr[j] + v;   // N pieces add up
                }
            }
        }

        // state <- state exp(a_tot) + (x dt exp(a_tot - a_cum))^T B
        __syncthreads();                 // every read of the old state done
        const float decay = expf(a_tot);
        for (int e = tid; e < N * P; e += NT) St[e] *= decay;
        for (int jt = 0; jt < tiles; ++jt) {
            const int j0 = jt * TQ;
            __syncthreads();
            load_nmajor(Bs, Bc, bss, j0, q_len, N, tid, NT);
            for (int e = tid; e < TQ * P; e += NT) {
                const int r = e / P, p = e % P, t = j0 + r;
                Xs[e] = t < q_len ? xc[t * xss + p]
                    * dtc[(long long)t * H] * expf(a_tot - acum[t]) : 0.f;
            }
            __syncthreads();
            for (int blk = tid; blk < PG * (N / 4); blk += NT) {
                const int pb = (blk % PG) * 4, nb = (blk / PG) * 4;
                float d[4][4] = {};          // [p][n]
                for (int q = 0; q < TQ; ++q) {
                    const float4 xv = ld4(Xs + q * P + pb);
                    const float xw[4] = {xv.x, xv.y, xv.z, xv.w};
                    float kv[4];
                    #pragma unroll
                    for (int k = 0; k < 4; ++k) kv[k] = Bs[(nb + k) * LDK + q];
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        #pragma unroll
                        for (int k = 0; k < 4; ++k)
                            d[i][k] = fmaf(xw[i], kv[k], d[i][k]);
                }
                #pragma unroll
                for (int k = 0; k < 4; ++k)
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        St[(nb + k) * P + pb + i] += d[i][k];
            }
        }
    }
    __syncthreads();
    float* so = state_out + (((long long)b * H + h) * geo.PT + p_off) *
                geo.NT + geo.n0;
    for (int e = tid; e < P * N; e += NT) {
        const int p = e / N, n = e % N;
        so[(long long)p * geo.NT + n] = St[n * P + p];
    }
}

// ---------------------------------------------------------------------------
// ssd_scan_kernel_mma: bf16, tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;     // 4 warps, 16 rows of a sub-tile each
constexpr int MMA_WARPS = MMA_THREADS / 32;

// the shared-memory layout for (P, N, chunk), in bytes; the wrapper's
// ssd.mma_smem_bytes is the same formula
struct MmaLayout {
    int np, ld, qpad;                    // N padded to 16, row stride, Q
    size_t c_off, b_off, x_off, dt_off, bytes;
    __host__ __device__ MmaLayout(int P, int N, int chunk) {
        np = (N + 15) / 16 * 16;
        ld = np + 8;                     // bf16 C / B rows and fp32 state
        qpad = (chunk + TQ - 1) / TQ * TQ;
        c_off = (size_t)4 * P * ld;                      // state, fp32
        b_off = c_off + (size_t)2 * TQ * ld;             // C_i
        x_off = b_off + (size_t)2 * 2 * TQ * ld;         // two B_j
        dt_off = x_off + (size_t)2 * 2 * TQ * (P + 8);   // two x_j
        bytes = dt_off + (size_t)4 * (4 * qpad + MMA_WARPS);  // two dt,
    }                                                  // a_cum, w, totals
};

// a register of two bf16 x values times (w0, w1) in fp32, split into hi =
// bf16 of the products and lo = bf16 of the remainders
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
    tc::split_bf16(__uint_as_float(v << 16) * w0,
                   __uint_as_float(v & 0xffff0000u) * w1, hi, lo);
}

// the k-th key sub-tile query sub-tile it visits (k = 0 .. it): it - 1
// first (the sub-tile the last stage left in its buffer), then 0 .. it - 2,
// the diagonal last
__device__ __forceinline__ int key_tile(int it, int k) {
    return k == it ? it : (k == 0 ? it - 1 : k - 1);
}

template <int P>
__global__ void __launch_bounds__(MMA_THREADS, 2)
ssd_scan_kernel_mma(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ state_out, int batch, int S, int H,
                    int N, int chunk, long long xsb, long long xss,
                    long long bsb, long long bss, long long csb,
                    long long css, int bc16, Geometry geo,
                    float* __restrict__ yacc) {
    constexpr int XLD = P + 8;           // padded x row, bf16 elements
    constexpr int NO = P / 8;            // y n-tiles
    constexpr int PM = P / 16;           // state m-tiles
    const MmaLayout L(P, N, chunk);
    const int LD = L.ld, NP = L.np;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* st = reinterpret_cast<float*>(smem_raw);
    float* dt2 = reinterpret_cast<float*>(smem_raw + L.dt_off);  // 2 chunks'
    float* acum = dt2 + 2 * L.qpad;      // running sum of a, times log2 e
    float* ws = acum + L.qpad;           // dt exp(a_tot - a_cum)
    float* wsum = ws + L.qpad;           // the scan's warp totals
    const uint32_t sC = tc::smem_addr(smem_raw + L.c_off);
    const uint32_t sB = tc::smem_addr(smem_raw + L.b_off);
    const uint32_t sX = tc::smem_addr(smem_raw + L.x_off);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // block (head, batch, slab), heads fastest
    const int h = (int)(blockIdx.x % H), b = (int)(blockIdx.x / H % batch);
    const int p_off = geo.p0 + (int)(blockIdx.x / H / batch) * P;
    const float Ah = A[h];
    const __nv_bfloat16* xb = x + b * xsb + h * geo.xsh + p_off;
    const __nv_bfloat16* Bb = Bm + b * bsb;
    const __nv_bfloat16* Cb = Cm + b * csb;

    // the state and the C / B buffers' pad columns start at zero (the
    // copies never write columns >= N)
    for (int e = tid; e < (int)(L.x_off / 4); e += MMA_THREADS)
        reinterpret_cast<uint32_t*>(smem_raw)[e] = 0u;
    __syncthreads();

    // rows t0.. of a chunk (rows >= q_len zero-filled) of B or C / of x;
    // a B or C row is `units` copies of bw elements, and the block's
    // threads step through the tile's copies by (dr rows, dc copies)
    const int bw = bc16 ? 8 : 4, units = N / bw;
    const int dr = MMA_THREADS / units, dc = MMA_THREADS % units;
    const int r_first = tid / units, c_first = tid % units;
    auto load_bc = [&](uint32_t dst, const __nv_bfloat16* src, long long ts,
                       int t0, int q_len) {
        for (int r = r_first, c = c_first; r < TQ;) {
            const int s = t0 + r;
            const bool in = s < q_len;
            const __nv_bfloat16* p = src + (in ? s : 0) * ts + c * bw;
            const uint32_t d = dst + (r * LD + c * bw) * 2;
            if (bc16) tc::cp_async16(d, p, in);
            else tc::cp_async8(d, p, in);
            r += dr;
            c += dc;
            if (c >= units) {
                c -= units;
                ++r;
            }
        }
    };
    auto load_x = [&](uint32_t dst, const __nv_bfloat16* src, int t0,
                      int q_len) {
        for (int e = tid; e < TQ * (P / 8); e += MMA_THREADS) {
            const int r = e / (P / 8), c = (e % (P / 8)) * 8, s = t0 + r;
            const bool in = s < q_len;
            tc::cp_async16(dst + (r * XLD + c) * 2,
                           src + (in ? s : 0) * xss + c, in);
        }
    };
    // B_j and x_j of the chunk at c0 into buffer buf
    auto load_tile = [&](int c0, int j, int buf) {
        const int q_len = min(chunk, S - c0);
        load_bc(sB + buf * TQ * LD * 2, Bb + c0 * bss, bss, j * TQ, q_len);
        load_x(sX + buf * TQ * XLD * 2, xb + c0 * xss, j * TQ, q_len);
    };
    // dt of the chunk at c0 (zero past S) into dt buffer buf
    auto load_dt = [&](int c0, int buf) {
        const int q_len = min(chunk, S - c0);
        const uint32_t dst = tc::smem_addr(dt2 + buf * L.qpad);
        for (int q = tid; q < (q_len + TQ - 1) / TQ * TQ; q += MMA_THREADS) {
            const bool in = q < q_len;
            tc::cp_async4(dst + q * 4,
                          dt + ((long long)b * S + c0 + (in ? q : 0)) * H + h,
                          in);
        }
    };
    // each chunk's dt, C_0 and first B / x sub-tile are in flight before
    // it starts: the first chunk's from here, the next one's from the last
    // stage of the chunk before
    int cur = 0;                         // the buffer the stage reads
    load_tile(0, 0, cur);
    load_bc(sC, Cb, css, 0, min(chunk, S));
    load_dt(0, 0);
    tc::cp_async_commit();

    for (int c0 = 0, ci = 0; c0 < S; c0 += chunk, ++ci) {
        const int q_len = min(chunk, S - c0);
        const int tiles = (q_len + TQ - 1) / TQ, qpad = tiles * TQ;
        const float* dts = dt2 + (ci & 1) * L.qpad;
        tc::cp_async_wait<0>();
        __syncthreads();

        // a_cum by a fixed-order scan: each thread sums a run of E tokens,
        // the warps scan the runs by shuffles, the warp totals are added in
        // order; then w
        {
            const int E = (qpad + MMA_THREADS - 1) / MMA_THREADS;
            const int q0 = tid * E, q1 = min(q0 + E, qpad);
            float run = 0.f;
            for (int q = q0; q < q1; ++q) run += dts[q] * Ah;
            float incl = run;
            #pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += v;
            }
            float excl = __shfl_up_sync(0xffffffffu, incl, 1);
            if (lane == 31) wsum[warp] = incl;
            __syncthreads();
            float base = 0.f;
            for (int w = 0; w < warp; ++w) base += wsum[w];
            float r = lane ? base + excl : base;
            for (int q = q0; q < q1; ++q) {
                r += dts[q] * Ah;
                acum[q] = r * tc::LOG2E;
            }
        }
        __syncthreads();
        const float a_tot = acum[q_len - 1];
        for (int q = tid; q < qpad; q += MMA_THREADS)
            ws[q] = dts[q] * exp2f(a_tot - acum[q]);
        const float decay = exp2f(a_tot);
        const int n_items = PM * ((NP + 63) / 64);

        for (int it = 0; it < tiles; ++it) {
            const int i0 = it * TQ;
            // C_i came in flight during the last sub-tile's diagonal stage.
            // From the second sub-tile on, the stage buffer still holds key
            // sub-tile it - 1, which this sub-tile visits first; the one it
            // visits next goes in flight now
            if (it > 0) {
                load_tile(c0, key_tile(it, 1), cur ^ 1);
                tc::cp_async_commit();
                tc::cp_async_wait<1>();
                __syncthreads();
            }

            // acc = C_i state^T, the state's fp32 pairs packed to bf16
            float acc[NO][4];
            #pragma unroll
            for (int n = 0; n < NO; ++n)
                acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
            const uint32_t crow = sC + ((16 * warp + tc::a_row(lane)) * LD +
                                        tc::a_col(lane)) * 2;
            for (int kb = 0; c0 > 0 && kb < NP / 16; kb += 8) {
                #pragma unroll
                for (int k8 = 0; k8 < 8; ++k8) {
                    const int kk = kb + k8;
                    if (kk >= NP / 16) break;
                    uint32_t ca[4];
                    tc::ldsm_x4(ca, crow + kk * 32);
                    #pragma unroll
                    for (int n = 0; n < NO; ++n) {
                        const float* sp = st + (8 * n + g) * LD + 16 * kk +
                                          2 * t;
                        const float2 lo = *reinterpret_cast<const float2*>(sp);
                        const float2 hi =
                            *reinterpret_cast<const float2*>(sp + 8);
                        tc::mma_bf16(acc[n], ca, tc::pack_bf16(lo.x, lo.y),
                                     tc::pack_bf16(hi.x, hi.y));
                    }
                }
            }
            // this warp's rows (chunk-relative; >= q_len are padding); off
            // the diagonal L_ij = exp2(a_i - a_ref) exp2(a_ref - a_j) with
            // a_ref the a_cum before the sub-tile: both factors <= 1
            const int r0 = i0 + 16 * warp + g, r1 = r0 + 8;
            const float ai0 = acum[r0], ai1 = acum[r1];
            const float aref = it > 0 ? acum[i0 - 1] : 0.f;
            const float f0 = exp2f(ai0 - aref), f1 = exp2f(ai1 - aref);
            {
                const float e0 = exp2f(ai0), e1 = exp2f(ai1);
                #pragma unroll
                for (int n = 0; n < NO; ++n) {
                    acc[n][0] *= e0;
                    acc[n][1] *= e0;
                    acc[n][2] *= e1;
                    acc[n][3] *= e1;
                }
            }

            for (int k = 0; k <= it; ++k) {
                const int jt = key_tile(it, k), j0 = jt * TQ;
                const bool last = k == it;       // the diagonal
                // the first stage of a later sub-tile reads the resident
                // sub-tile; the others wait for theirs and, once every warp
                // is past the stage that read the other buffer, send the
                // next one into it (none where the next stage reuses this)
                if (k > 0 || it == 0) {
                    tc::cp_async_wait<0>();
                    __syncthreads();
                    if (!last)
                        load_tile(c0, key_tile(it, k + 1), cur ^ 1);
                    else if (it + 1 == tiles && c0 + chunk < S)
                        load_tile(c0 + chunk, 0, cur ^ 1);
                    tc::cp_async_commit();
                }
                const uint32_t sb = sB + cur * TQ * LD * 2;
                const uint32_t sx = sX + cur * TQ * XLD * 2;
                // S = C_i B_j^T; on the diagonal, key pairs np <= warp
                float s[8][4];
                #pragma unroll
                for (int n = 0; n < 8; ++n)
                    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
                for (int kb = 0; kb < NP / 16; kb += 8) {
                    #pragma unroll
                    for (int k8 = 0; k8 < 8; ++k8) {
                        const int kk = kb + k8;
                        if (kk >= NP / 16) break;
                        uint32_t ca[4];
                        tc::ldsm_x4(ca, crow + kk * 32);
                        #pragma unroll
                        for (int np = 0; np < 4; ++np) {
                            if (last && np > warp) continue;
                            uint32_t kr[4];
                            tc::ldsm_x4(kr, sb + ((np * 16 + tc::bn_row(lane)) *
                                                  LD + kk * 16 +
                                                  tc::bn_col(lane)) * 2);
                            tc::mma_bf16(s[2 * np], ca, kr[0], kr[1]);
                            tc::mma_bf16(s[2 * np + 1], ca, kr[2], kr[3]);
                        }
                    }
                }
                if (last) {
                    // C_i is read: the next sub-tile's C, or the next
                    // chunk's C_0 and dt, go in flight behind this stage
                    __syncthreads();
                    if (it + 1 < tiles) {
                        load_bc(sC, Cb + c0 * css, css, i0 + TQ, q_len);
                    } else if (c0 + chunk < S) {
                        load_bc(sC, Cb + (c0 + chunk) * css, css, 0,
                                min(chunk, S - c0 - chunk));
                        load_dt(c0 + chunk, (ci + 1) & 1);
                    }
                    tc::cp_async_commit();
                }
                // (L o S) dt_j in fp32, rounded to bf16 once: the A
                // operand of acc += (.) x_j
                uint32_t pa[4][4];
                #pragma unroll
                for (int n = 0; n < 8; ++n) {
                    const int kc = 8 * n + 2 * t;          // sub-tile columns
                    const float aj0 = acum[j0 + kc], aj1 = acum[j0 + kc + 1];
                    const float d0 = dts[j0 + kc], d1 = dts[j0 + kc + 1];
                    float v[4];
                    if (last) {
                        const int q0 = 16 * warp + g, q1 = q0 + 8;   // rows
                        v[0] = q0 >= kc ? s[n][0] * exp2f(ai0 - aj0) * d0
                                        : 0.f;
                        v[1] = q0 >= kc + 1 ? s[n][1] * exp2f(ai0 - aj1) * d1
                                            : 0.f;
                        v[2] = q1 >= kc ? s[n][2] * exp2f(ai1 - aj0) * d0
                                        : 0.f;
                        v[3] = q1 >= kc + 1 ? s[n][3] * exp2f(ai1 - aj1) * d1
                                            : 0.f;
                    } else {
                        const float w0 = exp2f(aref - aj0) * d0;
                        const float w1 = exp2f(aref - aj1) * d1;
                        v[0] = s[n][0] * f0 * w0;
                        v[1] = s[n][1] * f0 * w1;
                        v[2] = s[n][2] * f1 * w0;
                        v[3] = s[n][3] * f1 * w1;
                    }
                    pa[n / 2][(n & 1) * 2] = tc::pack_bf16(v[0], v[1]);
                    pa[n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(v[2], v[3]);
                }
                #pragma unroll
                for (int kc = 0; kc < TQ / 16; ++kc) {
                    if (last && kc > warp) continue;
                    #pragma unroll
                    for (int np = 0; np < NO / 2; ++np) {
                        uint32_t vr[4];
                        tc::ldsm_x4_trans(vr, sx + ((kc * 16 + tc::a_row(lane)) *
                                                    XLD + np * 16 +
                                                    tc::a_col(lane)) * 2);
                        tc::mma_bf16(acc[2 * np], pa[kc], vr[0], vr[1]);
                        tc::mma_bf16(acc[2 * np + 1], pa[kc], vr[2], vr[3]);
                    }
                }

                // the last query sub-tile visits every key sub-tile once:
                // there the state update takes its part of (x w)^T B, after
                // every warp's C_i state^T read the old state
                if (it + 1 == tiles) {
                    if (k == 0) __syncthreads();
                    for (int item = warp; item < n_items; item += MMA_WARPS) {
                        const int p0 = (item % PM) * 16, n0 = (item / PM) * 64;
                        float d[8][4];
                        #pragma unroll
                        for (int n = 0; n < 8; ++n)
                            d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
                        #pragma unroll
                        for (int kc = 0; kc < TQ / 16; ++kc) {
                            // A = (x w)^T: x_j is k-major, so ldmatrix.trans
                            uint32_t xa[4], hi[4], lo[4];
                            tc::ldsm_x4_trans(
                                xa, sx + ((kc * 16 + tc::bn_row(lane)) * XLD +
                                          p0 + tc::bn_col(lane)) * 2);
                            const float* w = ws + j0 + kc * 16 + 2 * t;
                            scale_split(xa[0], w[0], w[1], hi[0], lo[0]);
                            scale_split(xa[1], w[0], w[1], hi[1], lo[1]);
                            scale_split(xa[2], w[8], w[9], hi[2], lo[2]);
                            scale_split(xa[3], w[8], w[9], hi[3], lo[3]);
                            uint32_t br[4][4];
                            #pragma unroll
                            for (int np = 0; np < 4; ++np)
                                if (n0 + np * 16 < NP)
                                    tc::ldsm_x4_trans(
                                        br[np],
                                        sb + ((kc * 16 + tc::a_row(lane)) * LD +
                                              n0 + np * 16 +
                                              tc::a_col(lane)) * 2);
                            #pragma unroll
                            for (int np = 0; np < 4; ++np) {
                                if (n0 + np * 16 >= NP) continue;
                                tc::mma_bf16(d[2 * np], hi, br[np][0],
                                             br[np][1]);
                                tc::mma_bf16(d[2 * np + 1], hi, br[np][2],
                                             br[np][3]);
                            }
                            #pragma unroll
                            for (int np = 0; np < 4; ++np) {
                                if (n0 + np * 16 >= NP) continue;
                                tc::mma_bf16(d[2 * np], lo, br[np][0],
                                             br[np][1]);
                                tc::mma_bf16(d[2 * np + 1], lo, br[np][2],
                                             br[np][3]);
                            }
                        }
                        // this warp alone owns these state entries; the
                        // first visit scales the old state by exp(a_tot)
                        #pragma unroll
                        for (int n = 0; n < 8; ++n) {
                            if (n0 + n * 8 >= NP) continue;
                            #pragma unroll
                            for (int half = 0; half < 2; ++half) {
                                float2* sp = reinterpret_cast<float2*>(
                                    st + (p0 + g + 8 * half) * LD + n0 +
                                    n * 8 + 2 * t);
                                float2 v = *sp;
                                if (k == 0) {
                                    v.x *= decay;
                                    v.y *= decay;
                                }
                                v.x += d[n][2 * half];
                                v.y += d[n][2 * half + 1];
                                *sp = v;
                            }
                        }
                    }
                }
                if (!(last && it + 1 < tiles)) cur ^= 1;
            }
            #pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int r = half ? r1 : r0;
                if (r >= q_len) continue;
                const long long yo =
                    (((long long)b * S + c0 + r) * H + h) * geo.PT + p_off;
                __nv_bfloat16* yr = y + yo;
                if (geo.first && geo.last) {
                    #pragma unroll
                    for (int n = 0; n < NO; ++n)
                        *reinterpret_cast<uint32_t*>(yr + n * 8 + 2 * t) =
                            tc::pack_bf16(acc[n][2 * half],
                                          acc[n][2 * half + 1]);
                    continue;
                }
                // one piece of an N walk: the fp32 sum of the pieces so
                // far, rounded into y by the last
                float* ya = yacc + yo;
                #pragma unroll
                for (int n = 0; n < NO; ++n) {
                    float2 v = make_float2(acc[n][2 * half],
                                           acc[n][2 * half + 1]);
                    float2* pa = reinterpret_cast<float2*>(ya + n * 8 + 2 * t);
                    if (!geo.first) {
                        const float2 prev = *pa;
                        v.x = prev.x + v.x;
                        v.y = prev.y + v.y;
                    }
                    if (geo.last)
                        *reinterpret_cast<uint32_t*>(yr + n * 8 + 2 * t) =
                            tc::pack_bf16(v.x, v.y);
                    else
                        *pa = v;
                }
            }
        }
    }
    __syncthreads();                     // every warp's state items are in
    float* so = state_out + (((long long)b * H + h) * geo.PT + p_off) *
                geo.NT + geo.n0;
    for (int e = tid; e < P * N; e += MMA_THREADS) {
        const int p = e / N, n = e % N;
        so[(long long)p * geo.NT + n] = st[p * LD + n];
    }
}

// above 48 KB of dynamic shared memory a kernel needs an opt-in
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, size_t& configured) {
    if (bytes <= configured) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) configured = bytes;
    return e;
}

template <int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int batch, int S, int H,
           int N, int chunk, const long long* strides, size_t smem_bytes,
           const Geometry& geo, unsigned blocks, cudaStream_t stream) {
    auto kern = ssd_scan_kernel<P>;
    static size_t configured = 0;
    const cudaError_t e = allow_smem(kern, smem_bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<blocks, 4 * P, smem_bytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y),
        static_cast<float*>(state), batch, S, H, N, chunk, strides[0],
        strides[1], strides[2], strides[3], strides[4], strides[5], geo);
    return (int)cudaGetLastError();
}

template <int P>
int launch_mma(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* state, int batch, int S, int H,
               int N, int chunk, const long long* strides, size_t smem_bytes,
               int bc16, const Geometry& geo, void* yacc, unsigned blocks,
               cudaStream_t stream) {
    auto kern = ssd_scan_kernel_mma<P>;
    static size_t configured = 0;
    if (configured == 0) {               // two blocks per SM want the
        const cudaError_t e = cudaFuncSetAttribute(      // largest carveout
            kern, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return (int)e;
    }
    const cudaError_t e = allow_smem(kern, smem_bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<blocks, MMA_THREADS, smem_bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(state), batch, S,
        H, N, chunk, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5], bc16, geo, static_cast<float*>(yacc));
    return (int)cudaGetLastError();
}

// fp32 -> the FMA kernel, bf16 -> the tensor-core kernel
template <bool MMA>
int dispatch(int P, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* state, int batch,
             int S, int H, int N, int chunk, const long long* strides,
             size_t smem_bytes, int bc16, const Geometry& geo, void* yacc,
             unsigned blocks, cudaStream_t st) {
#define SSD_CASE(p)                                                         \
    if (P == p)                                                             \
        return MMA ? launch_mma<p>(x, dt, A, Bm, Cm, y, state, batch, S, H, \
                                   N, chunk, strides, smem_bytes, bc16,     \
                                   geo, yacc, blocks, st)                   \
                   : launch<p>(x, dt, A, Bm, Cm, y, state, batch, S, H, N,  \
                               chunk, strides, smem_bytes, geo, blocks, st);
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
#undef SSD_CASE
    return -1;
}

bool on_grid(const void* p, long long s0, long long s1, int bytes,
             long long s2 = 0) {
    const int elems = bytes / 2;         // bf16
    return reinterpret_cast<uintptr_t>(p) % bytes == 0 && s0 % elems == 0 &&
           s1 % elems == 0 && s2 % elems == 0;
}

}  // namespace

// Plain C entry point: one launch of n_slab slabs of P columns from column
// geom[2] of x, y and the state, over the state columns n0 .. n0 + N - 1.
// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  Device pointers: x
// (b, S, H, >= p0 + n_slab P) with unit stride along p; dt (b, S, H) fp32
// contiguous; A (H,) fp32; B and C (b, S, N) with unit stride along n
// (views of the piece's columns); y (b, S, H, PT) contiguous in x's type;
// state (b, H, PT, NT) fp32 contiguous; yacc, for bf16 pieces of an N walk
// other than a lone one, an fp32 (b, S, H, PT) scratch (else null).
// strides: x, B, C batch and token strides in elements, in that order;
// geom: x's head stride, PT, p0, n_slab, NT, n0, first, last.  For bf16,
// x starts and steps on the 16-byte grid and B and C on the 8-byte grid
// (the tensor-core kernel's cp.async copies).  smem_bytes: the dynamic
// shared memory the wrapper computed for (P, N, chunk) and the dtype.
// Returns the launch's cudaGetLastError() (0 on success), or -1 on
// arguments the kernels do not take (the Python wrapper checks first and
// raises).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int dtype, int batch, int S,
                               int H, int P, int N, int chunk,
                               const long long* strides,
                               long long smem_bytes, const long long* geom,
                               void* yacc, void* stream) {
    const Geometry geo{geom[0], (int)geom[1], (int)geom[2], (int)geom[4],
                       (int)geom[5], (int)geom[6], (int)geom[7]};
    const long long n_slab = geom[3];
    const long long blocks = (long long)H * batch * n_slab;
    if (batch < 1 || H < 1 || S < 1 || N < 4 || N % 4 || chunk < 1 ||
        chunk > S || smem_bytes < 1 || smem_bytes > 232448 || n_slab < 1 ||
        blocks > 0x7fffffffLL || geo.p0 < 0 || geo.p0 + n_slab * P > geo.PT ||
        geo.n0 < 0 || geo.n0 + N > geo.NT)
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch<false>(P, x, dt, A, Bm, Cm, y, state, batch, S, H, N,
                               chunk, strides, (size_t)smem_bytes, 0, geo,
                               nullptr, (unsigned)blocks, st);
    if (dtype == 1) {
        if ((size_t)smem_bytes != MmaLayout(P, N, chunk).bytes ||
            !on_grid(x, strides[0], strides[1], 16, geo.xsh) ||
            !on_grid(Bm, strides[2], strides[3], 8) ||
            !on_grid(Cm, strides[4], strides[5], 8) ||
            (!(geo.first && geo.last) && yacc == nullptr))
            return -1;
        const int bc16 = N % 8 == 0 && on_grid(Bm, strides[2], strides[3], 16)
                         && on_grid(Cm, strides[4], strides[5], 16);
        return dispatch<true>(P, x, dt, A, Bm, Cm, y, state, batch, S, H, N,
                              chunk, strides, (size_t)smem_bytes, bc16, geo,
                              yacc, (unsigned)blocks, st);
    }
    return -1;
}
