// The bf16 Mamba-2 SSD scan (chunked dual form, group size 1, forward only)
// redesigned for Hopper: a state pass, then a chunk-parallel scan, both on
// wgmma with TMA copies into mbarrier rings fed by a producer warp.
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_kernel (pallas_call at
// :95) for bf16 x, B and C (fp32 inputs run ssd.cu's FMA kernel).  With a =
// dt A[h] and, within a chunk of Q tokens, a_cum its running sum and a_tot
// its total, it computes what that kernel computes:
//     y     = (L o C B^T)(x dt) + (C state_in^T) exp(a_cum)
//     L_ij  = exp(a_cum_i - a_cum_j) for i >= j, 0 above the diagonal
//     state = state_in exp(a_tot) + (x dt exp(a_tot - a_cum))^T B
// y in x's type straight into (b, S, H, P), the final state fp32 (b, H, P,
// N).  The last chunk is the ragged rest, the reference's zero padding (dt
// = 0 there): copies past S read zeros, nothing past S is stored.
//
// The state is sequential over chunks and y is not, so the work is split
// where the dependence lies:
//
// * ssd_state_kernel_wgmma, a block per (64 state columns, head, batch, P
//   slab), walks the chunks in order with the fp32 state in the consumer
//   warpgroup's wgmma accumulators.  A producer warp sends the x and B
//   sub-tiles of 64 tokens through a 4-stage ring (TMA, 4-D maps).  A scan
//   warp forms each chunk's a_cum and w = dt exp(a_tot - a_cum) a chunk
//   ahead (dt by plain loads: its token stride is H floats, under TMA's 16
//   bytes), by a fixed-order scan: runs of 8 tokens a lane, the lanes'
//   totals by full-warp shuffles, 256 tokens a pass; the block of the first
//   columns writes a_cum (log2 units) and dt per token to a scratch (b, H,
//   2, S_pad) fp32 for the scan.  The consumers write the state entering the
//   chunk to the scratch st_in (bf16, (b, n_chunks, H, P, N): the one
//   rounding the state gets as an operand of C state^T), scale the
//   accumulators by exp(a_tot) and add (x w)^T B by wgmma.m64n64k16, A =
//   (x w)^T from registers (x by ldmatrix.trans out of the swizzled tile,
//   times w in fp32, carried as hi = bf16(x w) plus lo = bf16(x w - hi): one
//   rounding leaves the state 1.6e-3 to 3.4e-3 of its scale from the plain
//   version, against the 1e-4 it is held to), B MN-major from shared memory;
//   each k-step's two products go out as soon as its parts are formed.
// * ssd_scan_kernel_wgmma, a block per (head group of GH, 64-row query
//   sub-tile i, batch, P slab), the sub-tiles of a chunk heaviest first; no
//   block waits on another.  The producer loads C_i and the group's a_cum /
//   dt rows once, then st_in of each head (if the chunk is not the first)
//   and, for each key sub-tile j <= i, B_j with its rows' a_cum / dt through
//   a ring of 3 slots and x_hj of each head through a ring of 4 (2 and 4, or
//   2 and 2, where shared memory is short).  The consumers compute y_h =
//   (C_i st_in_h^T) exp(a_cum_i) by wgmma (ss, K = N, two heads at a time);
//   then per j, S = C_i B_j^T ONCE for the group (wgmma.m64n64k16, ss) and
//   for every head P_h = bf16((L_h o S) dt_h) in registers and y_h += P_h
//   x_hj (wgmma rs, x MN-major), the heads' products and S of j + 1 issued
//   together, one wait a j.  Off the diagonal L factors as exp2(a_i -
//   a_ref) exp2(a_ref - a_j) with a_ref the a_cum at the sub-tile's first
//   row (both <= 1): the 64 column factors per head are formed once per B
//   tile by the warpgroup; on the diagonal exp is taken only where i >= j
//   is selected (exp of a positive difference is inf, inf * 0 NaN).  y goes
//   out through a padded staging tile in 16-byte stores of the rows before
//   the chunk's end.  GH = 2 at P 64: four heads' accumulators (128
//   registers) spilled at the 168 two blocks an SM leave a thread.
//
// x, B and C are read in place through 4-D tensor maps with their batch,
// token (and x's head) strides (the model hands views into the conv
// output): x as (P, H, S, b) boxes of one head, B and C as (N, 1, S, b);
// TMA needs them on the 16-byte grid, so N a multiple of 8 (the wrapper
// copies operands off it); the tiles take N up to Np, the next multiple of
// 64, the maps' extent N zero-filling the rest (zero columns of B and C
// change nothing), and the state and st_in are Np wide.  Boxes that run past a chunk's end
// read the next chunk's (finite) tokens: their rows are masked (w = 0,
// i >= j) and never stored.  No atomics; every sum in a fixed order: a
// second launch is bit-equal.
//
// What bounds it on an H100: bytes.  At mamba2-1.3b's serving shape (4,
// 2000, 64, 64, 128, 256) x, y, dt, B, C and the state are 145.6 MB (43.5 us
// at 3.35 TB/s) against 25.3 GFLOP (25.6 us at the bf16 rate).  This design
// reads x twice and writes and reads st_in once (33.5 MB there): ~84 us of
// device-memory traffic; each scan block also reads C_i, B_j and x_hj from
// the L2 (~128 KB a block there).  What holds it back is latency: one
// consumer warpgroup a block, two scan blocks and three state blocks an SM
// at the serving shape (107,640 and 70,752 bytes of shared memory; 168 and
// 91 registers at P 64, 0 spills: ptxas -v).  chip_smoke.py prints every
// instance's registers and fails on a spill or a wgmma serialisation note;
// ssd_wgmma_plan reports the shared-memory plan ssd.py mirrors.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "wgmma_plan.cuh"

namespace {

constexpr int TQ = 64;               // rows of a sub-tile
constexpr int THREADS = 160;         // a consumer warpgroup + a producer warp
constexpr int STATE_THREADS = 192;   // the state pass's: + a scan warp
constexpr int CONSUMERS = 128;
constexpr int BAR_C = 1;             // the consumers' named barrier
constexpr int ST_STAGES = 4;         // the state pass's ring
constexpr int NB = 64;               // state columns of a state-pass block
constexpr int MAX_SMEM = wgmma_plan::MAX_SMEM;

__host__ __device__ constexpr int round1k(int b) { return (b + 1023) & ~1023; }

// heads per scan block: GH y accumulators of P / 2 registers a thread, 64
// in all (32 at P 16; 128, GH 4 at P 64, spilled at the 168 registers two
// blocks of 160 threads leave a thread)
__host__ __device__ constexpr int head_group(int P) {
    return 128 / (P < 32 ? 32 : P);
}

// ---- shared memory of the two kernels (ssd.py's wgmma_smem mirrors it) --

struct StateSmem {                   // byte offsets from a 1,024-aligned base
    int stage, ring, dt, bars, bytes, alloc;
    __host__ __device__ StateSmem(int P, int chunk) {
        const int qpad = (chunk + TQ - 1) / TQ * TQ;
        stage = TQ * P * 2 + TQ * NB * 2;         // x, then B
        ring = ST_STAGES * stage;
        dt = ring;                                // a_cum x 2, w x 2
        bars = dt + 4 * 4 * qpad;
        // full, empty per stage; w_full, w_empty per a_cum / w buffer
        bytes = bars + 8 * (2 * ST_STAGES + 4);
        alloc = bytes + 1024;
    }
};

struct ScanSmem {
    int c_bytes, ac_bytes, bslot, bs, rb, xslot, xs, rx, bars, bytes, alloc;
    __host__ __device__ ScanSmem(int P, int Np) {
        const int gh = head_group(P);
        c_bytes = TQ * Np * 2;                    // a C or B tile
        ac_bytes = gh * 2 * TQ * 4;               // a_cum, dt of the group
        // C_i with its rows' a_cum and dt at 0; a B-ring slot: B_j with
        // theirs, or st_in; an x-ring slot: x_hj
        const int item = c_bytes + ac_bytes;
        rb = round1k(item);
        bslot = round1k(item > P * Np * 2 ? item : P * Np * 2);
        xslot = round1k(TQ * (P + 8) * 2);        // x, then y's staging
        // (B, x) ring slots: (3, 4) where they fit, else (2, 4), else (2, 2)
        for (int k = 0; k < 3; ++k) {
            bs = k == 0 ? 3 : 2;
            xs = k < 2 ? 4 : 2;
            rx = rb + bs * bslot;
            bars = rx + xs * xslot;
            bytes = bars + 8 * (1 + 2 * bs + 2 * xs);
            alloc = bytes + 1024;
            if (alloc <= MAX_SMEM) break;
        }
    }
};

// byte offset of row `row`, 16-byte unit `unit` in a TMA box of W bf16
// columns under W's swizzle (128 / 64 / 32 bytes: the unit's bits XOR the
// address bits 7-9 / 7-8 / 7; boxes start on 1,024-byte boundaries)
template <int W>
__device__ __forceinline__ uint32_t swz(int row, int unit) {
    const int phase = W == 64 ? (row & 7) : W == 32 ? ((row >> 1) & 3)
                                                     : ((row >> 2) & 1);
    return (uint32_t)(row * 2 * W + ((unit ^ phase) << 4));
}

// a register of two bf16 x values times (w0, w1) in fp32, split into hi =
// bf16 of the products and lo = bf16 of the remainders
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
    tc::split_bf16(__uint_as_float(v << 16) * w0,
                   __uint_as_float(v & 0xffff0000u) * w1, hi, lo);
}

// S = C B^T, both 64-row tiles K-major (N / 64 boxes of 64 columns):
// wgmma.m64n64k16 over N / 16 steps, issued (the caller commits and waits)
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t c_tile,
                                             uint32_t b_tile, int Np) {
    hw::Wgmma<64>::template ss0<0, 0>(s, hw::desc_k<64>(c_tile, TQ, 0, 0),
                                      hw::desc_k<64>(b_tile, TQ, 0, 0));
    for (int kk = 1; kk < Np / 16; ++kk)
        hw::Wgmma<64>::template ss<0, 0>(s, hw::desc_k<64>(c_tile, TQ, 0, kk),
                                         hw::desc_k<64>(b_tile, TQ, 0, kk), 1);
}

__device__ __forceinline__ void advance(int& s, uint32_t& par, int n) {
    if (++s == n) {
        s = 0;
        par ^= 1;
    }
}

// ---------------------------------------------------------------------------
// the state pass
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(STATE_THREADS, P > 64 ? 2 : 3)
ssd_state_kernel_wgmma(const __grid_constant__ CUtensorMap tmX,
                       const __grid_constant__ CUtensorMap tmB,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       __nv_bfloat16* __restrict__ st_in,
                       float* __restrict__ acum_out,
                       float* __restrict__ state, int batch, int S, int H,
                       int chunk, int PT, int p0, int Np, int spad) {
    constexpr int WP = wgmma_plan::swizzle_cols(P);
    constexpr int MT = (P + 63) / 64;             // 64-row m-tiles of the state
    constexpr int X_BYTES = TQ * P * 2;
    const StateSmem L(P, chunk);
    const int qpad = (chunk + TQ - 1) / TQ * TQ;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hw::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* sbase = smem_raw + (base - raw);
    float* acum = reinterpret_cast<float*>(sbase + L.dt);  // [2][qpad], log2
    float* ws = acum + 2 * qpad;                 // [2][qpad], dt exp(a_tot - a_cum)
    const uint32_t bars = base + L.bars;
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (ST_STAGES + s); };
    auto w_full = [&](int s) { return bars + 8 * (2 * ST_STAGES + s); };
    auto w_empty = [&](int s) { return bars + 8 * (2 * ST_STAGES + 2 + s); };
    auto sX = [&](int s) { return base + s * L.stage; };
    auto sB = [&](int s) { return base + s * L.stage + X_BYTES; };

    // block (piece of 64 state columns, head, batch, slab), pieces fastest
    const int pieces = Np / NB;
    long long bid = blockIdx.x;
    const int piece = (int)(bid % pieces);
    bid /= pieces;
    const int h = (int)(bid % H);
    bid /= H;
    const int b = (int)(bid % batch);
    const int slab = (int)(bid / batch);
    const int p_off = p0 + slab * P, n0 = piece * NB;
    const int n_chunks = (S + chunk - 1) / chunk;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

    if (tid == 0) {
        for (int s = 0; s < ST_STAGES; ++s) {
            hw::mbar_init(full(s), 1);
            hw::mbar_init(empty(s), 4);           // a consumer warp each
        }
        for (int s = 0; s < 2; ++s) {
            hw::mbar_init(w_full(s), 32);         // the scan warp's lanes
            hw::mbar_init(w_empty(s), 4);
        }
        hw::mbar_fence_init();
    }
    __syncthreads();

    if (warp == 4) {
        // ---- producer: one thread starts the x and B sub-tiles' copies ----
        int s = 0;
        uint32_t par = 1;                         // empty: the previous phase
        for (int c = 0; c < n_chunks && lane == 0; ++c) {
            const int c0 = c * chunk, q_len = min(chunk, S - c0);
            const int tiles = (q_len + TQ - 1) / TQ;
            for (int j = 0; j < tiles; ++j) {
                hw::mbar_wait(empty(s), par);
                hw::mbar_arrive_tx(full(s), L.stage);
                #pragma unroll
                for (int k = 0; k < P / WP; ++k)
                    hw::tma_load_4d(sX(s) + k * TQ * WP * 2, &tmX, full(s),
                                    p_off + k * WP, h, c0 + j * TQ, b);
                hw::tma_load_4d(sB(s), &tmB, full(s), n0, 0, c0 + j * TQ, b);
                advance(s, par, ST_STAGES);
            }
        }
    } else if (warp == 5) {
        // ---- the scan warp: a_cum and w of each chunk, ahead of the
        // consumers, into buffer c & 1.  a_cum by a fixed-order scan: runs
        // of 8 tokens a lane, 256 tokens a pass, the lanes' totals scanned
        // by (full-warp) shuffles, each pass's total carried into the next
        const float Ah = A[h];
        const bool writes_acum = piece == 0 && slab == 0;
        for (int c = 0; c < n_chunks; ++c) {
            const int buf = c & 1;
            const int c0 = c * chunk, q_len = min(chunk, S - c0);
            const int qp = (q_len + TQ - 1) / TQ * TQ;
            float* ac = acum + buf * qpad;
            float* w = ws + buf * qpad;
            hw::mbar_wait(w_empty(buf), ((c >> 1) & 1) ^ 1);
            const float* src = dt + ((long long)b * S + c0) * H + h;
            float carry = 0.f;
            for (int q0 = 0; q0 < qp; q0 += 256) {
                float d[8], r[8], run = 0.f;
                #pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int q = q0 + 8 * lane + e;
                    d[e] = q < q_len ? src[(long long)q * H] : 0.f;
                    run += d[e] * Ah;
                    r[e] = run;
                }
                float incl = run;
                #pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    const float v = __shfl_up_sync(0xffffffffu, incl, o);
                    if (lane >= o) incl += v;
                }
                const float total = __shfl_sync(0xffffffffu, incl, 31);
                const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
                const float before = lane ? carry + excl : carry;
                #pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int q = q0 + 8 * lane + e;
                    if (q < qp) {
                        ac[q] = (before + r[e]) * tc::LOG2E;
                        w[q] = d[e];
                    }
                }
                carry += total;
            }
            __syncwarp();
            const float a_tot = ac[q_len - 1];
            float* ac_row = acum_out + ((long long)b * H + h) * 2 * spad + c0;
            for (int q = lane; q < qp; q += 32) {
                const float d = w[q], a = ac[q];
                w[q] = q < q_len ? d * hw::ex2(a_tot - a) : 0.f;
                if (writes_acum && q < q_len) {
                    ac_row[q] = a;
                    ac_row[spad + q] = d;
                }
            }
            hw::mbar_arrive(w_full(buf));
        }
    } else {
        // ---- consumers: the state's 64 columns in the accumulators ----
        const int g = lane >> 2, t = lane & 3;
        float acc[MT][NB / 2];
        #pragma unroll
        for (int m = 0; m < MT; ++m)
            #pragma unroll
            for (int e = 0; e < NB / 2; ++e) acc[m][e] = 0.f;
        int s = 0;
        uint32_t par = 0;
        for (int c = 0; c < n_chunks; ++c) {
            const int buf = c & 1;
            const int c0 = c * chunk, q_len = min(chunk, S - c0);
            const int tiles = (q_len + TQ - 1) / TQ;
            hw::mbar_wait(w_full(buf), (c >> 1) & 1);
            const float* wsb = ws + buf * qpad;
            const float a_tot = acum[buf * qpad + q_len - 1];

            // the state entering the chunk, as bf16, for the scan's C
            // state^T (the first chunk's is zero and never read)
            if (c > 0) {
                #pragma unroll
                for (int m = 0; m < MT; ++m) {
                    const int p = 64 * m + 16 * warp + g;
                    __nv_bfloat16* row = st_in +
                        ((((long long)b * n_chunks + c) * H + h) * PT +
                         p_off + p) * Np + n0 + 2 * t;
                    #pragma unroll
                    for (int n = 0; n < NB / 8; ++n) {
                        if (p < P)
                            *reinterpret_cast<uint32_t*>(row + 8 * n) =
                                tc::pack_bf16(acc[m][4 * n], acc[m][4 * n + 1]);
                        if (p + 8 < P)
                            *reinterpret_cast<uint32_t*>(row + 8 * Np + 8 * n) =
                                tc::pack_bf16(acc[m][4 * n + 2],
                                              acc[m][4 * n + 3]);
                    }
                }
            }
            const float decay = hw::ex2(a_tot);
            #pragma unroll
            for (int m = 0; m < MT; ++m)
                #pragma unroll
                for (int e = 0; e < NB / 2; ++e) acc[m][e] *= decay;

            for (int j = 0; j < tiles; ++j) {
                hw::mbar_wait(full(s), par);
                // A = (x w)^T, k-major in shared memory: ldmatrix.trans; each
                // k-step's two products go out as soon as its parts are formed
                uint32_t hi[MT][4][4], lo[MT][4][4];
                #pragma unroll
                for (int m = 0; m < MT; ++m) {
                    const int pw = 64 * m + 16 * warp;    // the warp's rows
                    #pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        if (pw < P) {
                            const int kt = kk * 16 + tc::bn_row(lane);
                            const int p = pw + tc::bn_col(lane);
                            uint32_t xa[4];
                            tc::ldsm_x4_trans(
                                xa, sX(s) + (p / WP) * TQ * WP * 2 +
                                        swz<WP>(kt, (p % WP) / 8));
                            const float* w = wsb + j * TQ + kk * 16 + 2 * t;
                            scale_split(xa[0], w[0], w[1], hi[m][kk][0],
                                        lo[m][kk][0]);
                            scale_split(xa[1], w[0], w[1], hi[m][kk][1],
                                        lo[m][kk][1]);
                            scale_split(xa[2], w[8], w[9], hi[m][kk][2],
                                        lo[m][kk][2]);
                            scale_split(xa[3], w[8], w[9], hi[m][kk][3],
                                        lo[m][kk][3]);
                        } else {
                            #pragma unroll
                            for (int e = 0; e < 4; ++e)
                                hi[m][kk][e] = lo[m][kk][e] = 0u;
                        }
                        hw::wg_fence();
                        hw::Wgmma<NB>::template rs<1>(
                            acc[m], hi[m][kk], hw::desc_mn<64>(sB(s), TQ, kk),
                            1);
                        hw::Wgmma<NB>::template rs<1>(
                            acc[m], lo[m][kk], hw::desc_mn<64>(sB(s), TQ, kk),
                            1);
                    }
                }
                hw::wg_commit();
                hw::wg_wait<0>();
                #pragma unroll
                for (int m = 0; m < MT; ++m) hw::fence_regs(acc[m]);
                hw::mbar_arrive_if(empty(s), lane == 0);
                advance(s, par, ST_STAGES);
            }
            hw::mbar_arrive_if(w_empty(buf), lane == 0);
        }
        // the final state, fp32
        #pragma unroll
        for (int m = 0; m < MT; ++m) {
            const int p = 64 * m + 16 * warp + g;
            float* row = state + (((long long)b * H + h) * PT + p_off + p) * Np +
                         n0 + 2 * t;
            #pragma unroll
            for (int n = 0; n < NB / 8; ++n) {
                if (p < P)
                    *reinterpret_cast<float2*>(row + 8 * n) =
                        make_float2(acc[m][4 * n], acc[m][4 * n + 1]);
                if (p + 8 < P)
                    *reinterpret_cast<float2*>(row + 8 * Np + 8 * n) =
                        make_float2(acc[m][4 * n + 2], acc[m][4 * n + 3]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the chunk scan
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel_wgmma(const __grid_constant__ CUtensorMap tmX,
                      const __grid_constant__ CUtensorMap tmB,
                      const __grid_constant__ CUtensorMap tmC,
                      const __grid_constant__ CUtensorMap tmSt,
                      const __grid_constant__ CUtensorMap tmAc,
                      __nv_bfloat16* __restrict__ y, int batch, int S, int H,
                      int chunk, int PT, int p0, int Np) {
    constexpr int GH = head_group(P);
    constexpr int WX = wgmma_plan::swizzle_cols(P);
    const ScanSmem L(P, Np);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hw::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* sbase = smem_raw + (base - raw);
    const uint32_t bars = base + L.bars;
    const int bs = L.bs, xs = L.xs;
    const uint32_t sC = base, res_full = bars;
    auto fullB = [&](int s) { return bars + 8 * (1 + s); };
    auto emptyB = [&](int s) { return bars + 8 * (1 + bs + s); };
    auto fullX = [&](int s) { return bars + 8 * (1 + 2 * bs + s); };
    auto emptyX = [&](int s) { return bars + 8 * (1 + 2 * bs + xs + s); };
    auto slotB = [&](int s) { return base + L.rb + s * L.bslot; };
    auto slotX = [&](int s) { return base + L.rx + s * L.xslot; };
    // the a_cum / dt rows that come with a C or B tile: [head][2][64]
    auto rows_of = [&](uint32_t slot) {
        return reinterpret_cast<float*>(sbase + (slot - base) + L.c_bytes);
    };

    // block (head group, sub-tile, batch, slab), head groups fastest; the
    // sub-tiles of a chunk heaviest first
    const int n_chunks = (S + chunk - 1) / chunk;
    const int tpc = (chunk + TQ - 1) / TQ;        // sub-tiles of a full chunk
    const int last_q = S - (n_chunks - 1) * chunk;
    const int n_sub = (n_chunks - 1) * tpc + (last_q + TQ - 1) / TQ;
    const int n_groups = (H + GH - 1) / GH;
    long long bid = blockIdx.x;
    const int grp = (int)(bid % n_groups);
    bid /= n_groups;
    const int u = (int)(bid % n_sub);
    bid /= n_sub;
    const int b = (int)(bid % batch);
    const int slab = (int)(bid / batch);
    const int c = u / tpc;
    const int c0 = c * chunk, q_len = min(chunk, S - c0);
    const int i = (q_len + TQ - 1) / TQ - 1 - u % tpc;
    const int i0 = i * TQ, h0 = grp * GH, p_off = p0 + slab * P;
    const int tid = threadIdx.x, wg = hw::warpgroup();

    if (tid == 0) {
        hw::mbar_init(res_full, 1);
        for (int s = 0; s < bs; ++s) {
            hw::mbar_init(fullB(s), 1);
            hw::mbar_init(emptyB(s), 4);
        }
        for (int s = 0; s < xs; ++s) {
            hw::mbar_init(fullX(s), 1);
            hw::mbar_init(emptyX(s), 4);
        }
        hw::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 1) {
        // ---- producer: one thread starts every copy, in the consumers'
        // order ----
        if (tid == CONSUMERS) {
            int sb = 0, sx = 0;
            uint32_t pb = 1, px = 1;
            // a C or B tile (64 rows from token `row0`) and its rows' a_cum
            // into `slot`, completing `bar`
            auto load_rows = [&](const CUtensorMap* map, uint32_t slot,
                                 uint32_t bar, int row0, int b, int h0) {
                hw::mbar_arrive_tx(bar, L.c_bytes + L.ac_bytes);
                for (int k = 0; k < Np / 64; ++k)
                    hw::tma_load_4d(slot + k * TQ * 128, map, bar, k * 64, 0,
                                    row0, b);
                hw::tma_load_4d(slot + L.c_bytes, &tmAc, bar, row0, 0, h0, b);
            };
            {
                load_rows(&tmC, sC, res_full, c0 + i0, b, h0);
                if (c > 0) {
                    for (int h = 0; h < GH; ++h) {
                        hw::mbar_wait(emptyB(sb), pb);
                        hw::mbar_arrive_tx(fullB(sb), P * Np * 2);
                        for (int k = 0; k < Np / 64; ++k)
                            hw::tma_load_4d(slotB(sb) + k * P * 128, &tmSt,
                                            fullB(sb), k * 64, p_off, h0 + h,
                                            b * n_chunks + c);
                        advance(sb, pb, bs);
                    }
                }
                for (int j = 0; j <= i; ++j) {
                    hw::mbar_wait(emptyB(sb), pb);
                    load_rows(&tmB, slotB(sb), fullB(sb), c0 + j * TQ, b, h0);
                    advance(sb, pb, bs);
                    for (int h = 0; h < GH; ++h) {
                        hw::mbar_wait(emptyX(sx), px);
                        hw::mbar_arrive_tx(fullX(sx), TQ * P * 2);
                        #pragma unroll
                        for (int k = 0; k < P / WX; ++k)
                            hw::tma_load_4d(slotX(sx) + k * TQ * WX * 2, &tmX,
                                            fullX(sx), p_off + k * WX, h0 + h,
                                            c0 + j * TQ, b);
                        advance(sx, px, xs);
                    }
                }
            }
        }
    } else {
        // ---- consumers: y of GH heads for a tile's 64 rows ----
        const int lane = tid & 31;
        const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
        const int g = lane >> 2, t = lane & 3;
        const int r0 = 16 * warp + g, r1 = r0 + 8;   // sub-tile rows
        int sb = 0, sx = 0;
        uint32_t pb = 0, px = 0;
        float yh[GH][P / 2];             // y of each head, fp32
        float s[32];                     // S = C_i B_j^T
        constexpr int HB = GH > 1 ? 2 : 1;          // heads a batch
        const int rows = min(TQ, q_len - i0);    // rows before the end
        // C_i and its rows' a_cum / dt
        hw::mbar_wait(res_full, 0);
        const float* aci = rows_of(sC);

        // y_h = (C_i st_in_h^T) exp(a_cum_i), two heads at a time; zero
        // in the first chunk
        if (c > 0) {
            #pragma unroll
            for (int h = 0; h < GH; h += 2) {
                constexpr int HN = GH > 1 ? 2 : 1;
                int si[HN];
                #pragma unroll
                for (int k = 0; k < HN; ++k) {
                    si[k] = sb;
                    hw::mbar_wait(fullB(sb), pb);
                    advance(sb, pb, bs);
                }
                hw::wg_fence();
                #pragma unroll
                for (int k = 0; k < HN; ++k) {
                    hw::Wgmma<P>::template ss0<0, 0>(
                        yh[h + k], hw::desc_k<64>(sC, TQ, 0, 0),
                        hw::desc_k<64>(slotB(si[k]), P, 0, 0));
                    for (int kk = 1; kk < Np / 16; ++kk)
                        hw::Wgmma<P>::template ss<0, 0>(
                            yh[h + k], hw::desc_k<64>(sC, TQ, 0, kk),
                            hw::desc_k<64>(slotB(si[k]), P, 0, kk), 1);
                }
                hw::wg_commit();
                hw::wg_wait<0>();
                #pragma unroll
                for (int k = 0; k < HN; ++k) {
                    hw::fence_regs(yh[h + k]);
                    hw::mbar_arrive_if(emptyB(si[k]), lane == 0);
                }
            }
            #pragma unroll
            for (int h = 0; h < GH; ++h) {
                const float* ah = aci + h * 2 * TQ;
                const float e0 = r0 < rows ? hw::ex2(ah[r0]) : 0.f;
                const float e1 = r1 < rows ? hw::ex2(ah[r1]) : 0.f;
                #pragma unroll
                for (int n = 0; n < P / 8; ++n) {
                    yh[h][4 * n] *= e0;
                    yh[h][4 * n + 1] *= e0;
                    yh[h][4 * n + 2] *= e1;
                    yh[h][4 * n + 3] *= e1;
                }
            }
        } else {
            #pragma unroll
            for (int h = 0; h < GH; ++h)
                #pragma unroll
                for (int e = 0; e < P / 2; ++e) yh[h][e] = 0.f;
        }

        // the column factors exp2(a_ref - a_j) dt_j of every head, in
        // place over a B tile's a_cum (a_ref: the sub-tile's first row)
        auto col_factors = [&](int slot) {
            float* a = rows_of(slotB(slot));
            for (int e = tid; e < GH * TQ; e += CONSUMERS) {
                const int h = e / TQ, k = e % TQ;
                float* ah = a + h * 2 * TQ;
                ah[k] = hw::ex2(aci[h * 2 * TQ] - ah[k]) * ah[TQ + k];
            }
        };
        hw::mbar_wait(fullB(sb), pb);
        hw::wg_fence();
        issue_scores(s, sC, slotB(sb), Np);
        hw::wg_commit();
        if (i > 0) col_factors(sb);
        hw::bar_sync(BAR_C, CONSUMERS);
        hw::wg_wait<0>();
        hw::fence_regs(s);

        // per key sub-tile j: P of every head from S in registers, then
        // the heads' P x_hj products and S of j + 1 issued together
        for (int j = 0; j <= i; ++j) {
            const bool diag = j == i;
            const float* acj = rows_of(slotB(sb));
            int nsb = sb;
            uint32_t npb = pb;
            advance(nsb, npb, bs);
            #pragma unroll
            for (int h = 0; h < GH; h += HB) {
                uint32_t pa[HB][4][4];
                #pragma unroll
                for (int k = 0; k < HB; ++k) {
                    const float* ah = aci + (h + k) * 2 * TQ;
                    if (diag) {
                        const float ai0 = ah[r0], ai1 = ah[r1];
                        #pragma unroll
                        for (int n = 0; n < 8; ++n) {
                            const int kc = 8 * n + 2 * t;
                            const float aj0 = ah[kc], aj1 = ah[kc + 1];
                            const float d0 = ah[TQ + kc];
                            const float d1 = ah[TQ + kc + 1];
                            const float v0 = r0 >= kc && r0 < rows
                                ? s[4 * n] * hw::ex2(ai0 - aj0) * d0 : 0.f;
                            const float v1 = r0 >= kc + 1 && r0 < rows
                                ? s[4 * n + 1] * hw::ex2(ai0 - aj1) * d1
                                : 0.f;
                            const float v2 = r1 >= kc && r1 < rows
                                ? s[4 * n + 2] * hw::ex2(ai1 - aj0) * d0
                                : 0.f;
                            const float v3 = r1 >= kc + 1 && r1 < rows
                                ? s[4 * n + 3] * hw::ex2(ai1 - aj1) * d1
                                : 0.f;
                            pa[k][n / 2][(n & 1) * 2] =
                                tc::pack_bf16(v0, v1);
                            pa[k][n / 2][(n & 1) * 2 + 1] =
                                tc::pack_bf16(v2, v3);
                        }
                    } else {
                        const float aref = ah[0];
                        const float f0 =
                            r0 < rows ? hw::ex2(ah[r0] - aref) : 0.f;
                        const float f1 =
                            r1 < rows ? hw::ex2(ah[r1] - aref) : 0.f;
                        const float* w = acj + (h + k) * 2 * TQ;
                        #pragma unroll
                        for (int n = 0; n < 8; ++n) {
                            const int kc = 8 * n + 2 * t;
                            const float w0 = w[kc], w1 = w[kc + 1];
                            pa[k][n / 2][(n & 1) * 2] =
                                tc::pack_bf16(s[4 * n] * f0 * w0,
                                              s[4 * n + 1] * f0 * w1);
                            pa[k][n / 2][(n & 1) * 2 + 1] =
                                tc::pack_bf16(s[4 * n + 2] * f1 * w0,
                                              s[4 * n + 3] * f1 * w1);
                        }
                    }
                }
                int xi[HB];
                #pragma unroll
                for (int k = 0; k < HB; ++k) {
                    xi[k] = sx;
                    hw::mbar_wait(fullX(sx), px);
                    advance(sx, px, xs);
                }
                const bool next_s = h + HB >= GH && !diag;
                if (next_s) hw::mbar_wait(fullB(nsb), npb);
                hw::wg_fence();
                #pragma unroll
                for (int k = 0; k < HB; ++k)
                    #pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        hw::Wgmma<P>::template rs<1>(
                            yh[h + k], pa[k][kk],
                            hw::desc_mn<WX>(slotX(xi[k]), TQ, kk), 1);
                if (next_s) issue_scores(s, sC, slotB(nsb), Np);
                hw::wg_commit();
                if (next_s) {
                    if (j + 1 < i) col_factors(nsb);
                    hw::bar_sync(BAR_C, CONSUMERS);
                }
                hw::wg_wait<0>();
                #pragma unroll
                for (int k = 0; k < HB; ++k) {
                    hw::fence_regs(yh[h + k]);
                    hw::mbar_arrive_if(emptyX(xi[k]), lane == 0);
                }
                hw::fence_regs(s);
            }
            hw::mbar_arrive_if(emptyB(sb), lane == 0);
            sb = nsb;
            pb = npb;
        }

        // y of each head: bf16 into a padded staging tile (an x slot: every
        // copy is consumed), then 16-byte stores of the rows before the
        // chunk's end; heads past H are not stored
        #pragma unroll
        for (int h = 0; h < GH; ++h) {
            if (h0 + h >= H) continue;
            unsigned char* stg = sbase + L.rx + (h & 1) * L.xslot;
            #pragma unroll
            for (int n = 0; n < P / 8; ++n) {
                *reinterpret_cast<uint32_t*>(stg + (r0 * (P + 8) + 8 * n +
                                                    2 * t) * 2) =
                    tc::pack_bf16(yh[h][4 * n], yh[h][4 * n + 1]);
                *reinterpret_cast<uint32_t*>(stg + (r1 * (P + 8) + 8 * n +
                                                    2 * t) * 2) =
                    tc::pack_bf16(yh[h][4 * n + 2], yh[h][4 * n + 3]);
            }
            hw::bar_sync(BAR_C, CONSUMERS);
            for (int e = tid; e < rows * (P / 8); e += CONSUMERS) {
                const int r = e / (P / 8), k = e % (P / 8);
                const uint4 v = *reinterpret_cast<const uint4*>(
                    stg + (r * (P + 8) + 8 * k) * 2);
                *reinterpret_cast<uint4*>(
                    y + (((long long)b * S + c0 + i0 + r) * H + h0 + h) * PT +
                    p_off + 8 * k) = v;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* st_in, void* acum,
           int batch, int S, int H, int n_slab, int PT, int p0, int N,
           int chunk, const long long* st, int spad, cudaStream_t stream) {
    const int Np = (N + NB - 1) / NB * NB;      // the tiles' state width
    constexpr int WX = wgmma_plan::swizzle_cols(P);
    constexpr int GH = head_group(P);
    const StateSmem ls(P, chunk);
    const ScanSmem lc(P, Np);
    if (ls.alloc > MAX_SMEM || lc.alloc > MAX_SMEM) return -1;
    const int n_chunks = (S + chunk - 1) / chunk;
    const int tpc = (chunk + TQ - 1) / TQ;
    const int last_q = S - (n_chunks - 1) * chunk;
    const long long n_sub = (long long)(n_chunks - 1) * tpc +
                            (last_q + TQ - 1) / TQ;
    const long long state_blocks = (long long)(Np / NB) * H * batch * n_slab;
    const long long scan_blocks =
        (long long)((H + GH - 1) / GH) * n_sub * batch * n_slab;
    if (state_blocks > 0x7fffffffLL || scan_blocks > 0x7fffffffLL) return -1;

    typedef cuuint64_t u64;
    typedef cuuint32_t u32;
    CUtensorMap mx, mb, mc, mst, mac;
    const u64 xd[4] = {(u64)PT, (u64)H, (u64)S, (u64)batch};
    const u64 xs[3] = {(u64)st[2] * 2, (u64)st[1] * 2, (u64)st[0] * 2};
    const u32 xb[4] = {(u32)WX, 1u, (u32)TQ, 1u};
    const u64 bd[4] = {(u64)N, 1u, (u64)S, (u64)batch};
    const u64 bs[3] = {(u64)st[4] * 2, (u64)st[4] * 2, (u64)st[3] * 2};
    const u64 cs[3] = {(u64)st[6] * 2, (u64)st[6] * 2, (u64)st[5] * 2};
    const u32 bb[4] = {64u, 1u, (u32)TQ, 1u};
    const u64 sd[4] = {(u64)Np, (u64)PT, (u64)H, (u64)batch * n_chunks};
    const u64 ss[3] = {(u64)Np * 2, (u64)Np * 2 * PT, (u64)Np * 2 * PT * H};
    const u32 sbx[4] = {64u, (u32)P, 1u, 1u};
    const u64 ad[4] = {(u64)S, 2u, (u64)H, (u64)batch};
    const u64 as[3] = {(u64)spad * 4, (u64)spad * 8, (u64)spad * 8 * H};
    const u32 ab[4] = {(u32)TQ, 2u, (u32)GH, 1u};
    const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!wgmma_host::encode_view(&mx, BF, x, xd, xs, xb,
                                 wgmma_host::swizzle_of(WX)) ||
        !wgmma_host::encode_view(&mb, BF, Bm, bd, bs, bb,
                                 CU_TENSOR_MAP_SWIZZLE_128B) ||
        !wgmma_host::encode_view(&mc, BF, Cm, bd, cs, bb,
                                 CU_TENSOR_MAP_SWIZZLE_128B) ||
        !wgmma_host::encode_view(&mst, BF, st_in, sd, ss, sbx,
                                 CU_TENSOR_MAP_SWIZZLE_128B) ||
        !wgmma_host::encode_view(&mac, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, acum,
                                 ad, as, ab, CU_TENSOR_MAP_SWIZZLE_NONE))
        return -2;

    auto kstate = ssd_state_kernel_wgmma<P>;
    auto kscan = ssd_scan_kernel_wgmma<P>;
    static int configured_state = 0, configured_scan = 0;
    if (ls.alloc > configured_state) {
        const cudaError_t e = cudaFuncSetAttribute(
            kstate, cudaFuncAttributeMaxDynamicSharedMemorySize, ls.alloc);
        if (e != cudaSuccess) return (int)e;
        configured_state = ls.alloc;
    }
    if (lc.alloc > configured_scan) {
        const cudaError_t e = cudaFuncSetAttribute(
            kscan, cudaFuncAttributeMaxDynamicSharedMemorySize, lc.alloc);
        if (e != cudaSuccess) return (int)e;
        configured_scan = lc.alloc;
    }
    kstate<<<(unsigned)state_blocks, STATE_THREADS, ls.alloc, stream>>>(
        mx, mb, static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<__nv_bfloat16*>(st_in), static_cast<float*>(acum),
        static_cast<float*>(state), batch, S, H, chunk, PT, p0, Np, spad);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    kscan<<<(unsigned)scan_blocks, THREADS, lc.alloc, stream>>>(
        mx, mb, mc, mst, mac, static_cast<__nv_bfloat16*>(y), batch, S, H,
        chunk, PT, p0, Np);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point: the two kernels of one launch of n_slab slabs of P
// columns from column p0, on the stream in order.  Device pointers: x (b,
// S, H, >= p0 + n_slab P) bf16, unit stride along p; dt (b, S, H) fp32
// contiguous; A (H,) fp32; B and C (b, S, N) bf16, unit stride along n; y
// (b, S, H, PT) bf16 contiguous; with Np = N rounded up to 64, state (b,
// H, PT, Np) fp32 contiguous, st_in (b, n_chunks, H, PT, Np) bf16 and acum
// (b, H, 2, spad) fp32, the scratch (contiguous, uninitialised).  strides:
// x's batch, token and head strides, B's batch and token strides, C's, in
// elements.  Every pointer and stride on the 16-byte grid, N a multiple of
// 8 up to 512, spad >= S a multiple of 4.  Returns the launches'
// cudaGetLastError() (0 on success), -1 on arguments the kernels do not
// take (the wrapper checks first and raises), -2 where
// cuTensorMapEncodeTiled refused a map.
extern "C" int ssd_wgmma_launch(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm, void* y,
                                void* state, void* st_in, void* acum,
                                int batch, int S, int H, int P, int n_slab,
                                int PT, int p0, int N, int chunk,
                                const long long* strides, int spad,
                                void* stream) {
    if (batch < 1 || H < 1 || S < 1 || chunk < 1 || chunk > S ||
        n_slab < 1 || p0 < 0 || p0 + (long long)n_slab * P > PT ||
        PT % 16 || N < 8 || N > 512 || N % 8 || spad < S || spad % 4)
        return -1;
    if (!aligned16(x) || !aligned16(dt) || !aligned16(A) || !aligned16(Bm) ||
        !aligned16(Cm) || !aligned16(y) || !aligned16(state) ||
        !aligned16(st_in) || !aligned16(acum))
        return -1;
    for (int k = 0; k < 7; ++k)
        if (strides[k] % 8) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSD_WGMMA_CASE(p)                                                  \
    if (P == p)                                                            \
        return launch<p>(x, dt, A, Bm, Cm, y, state, st_in, acum, batch,   \
                         S, H, n_slab, PT, p0, N, chunk, strides, spad,    \
                         st);
    SSD_WGMMA_CASE(16)
    SSD_WGMMA_CASE(32)
    SSD_WGMMA_CASE(64)
    SSD_WGMMA_CASE(128)
#undef SSD_WGMMA_CASE
    return -1;
}

// The plan of this file's kernels at head width P, state width N and
// chunk, for chip_smoke.py to hold ssd.py's wgmma_smem to: out[0] the
// state pass's dynamic shared memory, out[1] the scan's, out[2] the scan's
// heads per block, out[3] its B ring's slots, out[4] its x ring's.  -1 for
// a P with no instance.
extern "C" int ssd_wgmma_plan(int P, int N, int chunk, int* out) {
    if (!(P == 16 || P == 32 || P == 64 || P == 128) || N < 1 || chunk < 1)
        return -1;
    const int Np = (N + NB - 1) / NB * NB;
    const StateSmem ls(P, chunk);
    const ScanSmem lc(P, Np);
    out[0] = ls.alloc;
    out[1] = lc.alloc;
    out[2] = head_group(P);
    out[3] = lc.bs;
    out[4] = lc.xs;
    return 0;
}
