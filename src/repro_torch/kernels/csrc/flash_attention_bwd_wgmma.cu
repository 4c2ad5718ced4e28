// flash_bwd_dkv_kernel_wgmma: the bf16 dk / dv pass of the flash backward
// redesigned for Hopper: K and V loaded once by TMA, a producer warp feeding
// a ring of q / dO tiles with their lse / delta rows, two consumer
// warpgroups on wgmma.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_dkv_kernel
// (pallas_call at :326) for bf16 at every compiled pair (fp32 runs
// flash_attention_bwd.cu's FMA kernel); the dq
// pass (flash_attention_bwd.cu) runs before it on the same stream and
// leaves delta = sum(dO * out) for it.  It computes what that kernel
// computes: p = exp(scale s - lse) under the forward's masks (k_pos >=
// Skv, q_row >= Sq, causal k_pos > q_offset + q_row give p = 0), dv = sum
// over the G query heads of a kv head's group and every q row of p^T dO,
// ds = p (dO . v^T - delta), dk = scale * sum ds^T q.
//
// What bounds it on an H100: operations, 2 B H Sq Skv (2D + 2Dv) (s and dk
// at D, dp and dv at Dv; halved when causal) against 989 TFLOP/s of bf16;
// where the block sweeps its q tiles more than once (below) it recomputes
// s: 2 B H Sq Skv (3D + 2Dv) in two sweeps, (6D + 2Dv) in four.  What the
// design does about it, per block of 384 threads owning 128 kv rows of one
// (batch, kv head):
//
// * Warpgroup 2 is the producer (setmaxnreg.dec to 40).  One thread loads
//   the block's K and V once, TMA boxes of the 4-D (D, Hkv, Skv, B) views,
//   rows past Skv as zeros; then, for every (head of the group, q tile) in
//   a fixed order from the causal start, its warp fills a stage of a ring
//   of 3 (dkv_stages): the tile's lse and delta rows by plain loads (rows
//   past Sq as 0: an fp32 row of Sq values is not a TMA box when Sq is not
//   a multiple of 4) and the q and dO tiles by TMA; the full mbarrier
//   counts the warp's 32 arrivals and the copies' bytes, the empty one an
//   arrival from each consumer warp.
// * Warpgroups 0 and 1 are the consumers (setmaxnreg.inc to 232), 64 kv rows
//   each, holding their fp32 dK and dV accumulators in wgmma registers.
//   Per q tile of BQ rows (dkv_bq: 64, or 32): S^T = K Q^T and dP^T = V
//   dO^T by wgmma.m64n{BQ}k16 from shared memory (both K-major), launched
//   together; P^T = exp2(c S^T - lse log2 e) in fp32; P^T and dS^T = P^T
//   (dP^T - delta) each rounded once to bf16 in registers (as
//   flash_attention_bwd.cu's kernel does, C12), packed straight into A
//   operands; dV += P^T dO and dK += dS^T Q by wgmma with A from registers
//   and dO / Q MN-major in shared memory (the transpose is the
//   descriptor's, nothing moves).  A warpgroup whose kv rows all lie after
//   the tile's last q row skips it.  The two warpgroups take turns at the
//   tensor cores (two named barriers, the forward's ping-pong): S^T and
//   dP^T, then dV and dK, so that one computes P^T and dS^T while the
//   other's products run.  dK is scaled once at the store.
// * Where dK's and dV's accumulators together would not fit beside the
//   step's scores (dkv_sweeps), the block sweeps its q tiles more than once,
//   each sweep for part of the columns: at (192, 128) twice, dV alone (S^T,
//   P^T, dV), then dK alone (S^T, dP^T, P^T, dS^T, dK); at (256, 256) four
//   times, dV's and then dK's column halves (64 accumulator registers
//   each, where two sweeps' 128 spilled).  Each value comes from the same
//   operands in the same order as in one sweep.  (128, 128) and (256, 256)
//   take 32-row q steps (dkv_bq): (128, 128)'s 128 accumulator registers
//   beside 64-row scores and dP spilled, and at (256, 256) K, V and two
//   64-row q and dO stages would pass 232,448 bytes.
//
// Swizzle and boxes per operand as in flash_attention_wgmma.cu (64, 32 or
// 16 columns a box).  Each dk / dv tile is written once by one block
// after a fixed loop order: no atomics, bit-equal from one launch to the
// next.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "wgmma_plan.cuh"

namespace {

constexpr int BKV = wgmma_plan::DKV_BKV;   // kv rows per block
constexpr int THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int BAR_TURN = 1;             // named barriers 1, 2: the turns

template <int D, int DV>
struct DkvSmem {                        // byte offsets from a 1,024-aligned base
    static constexpr int BQ = wgmma_plan::dkv_bq(D, DV);
    static constexpr int STAGES = wgmma_plan::dkv_stages(D, DV);
    static constexpr int K_OFF = 0;
    static constexpr int KV_BYTES = BKV * (D + DV) * 2;
    static constexpr int V_OFF = K_OFF + BKV * D * 2;
    static constexpr int Q_STAGE = BQ * D * 2;
    static constexpr int O_STAGE = BQ * DV * 2;
    static constexpr int Q_OFF = K_OFF + KV_BYTES;
    static constexpr int DO_OFF = Q_OFF + STAGES * Q_STAGE;
    static constexpr int L_OFF = DO_OFF + STAGES * O_STAGE;  // lse, delta rows
    static constexpr int BAR_OFF = L_OFF + STAGES * 2 * BQ * 4;
    // kv_full, then per stage q_full, q_empty
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
    static constexpr int ALLOC = BYTES + 1024;
    static_assert(ALLOC == wgmma_plan::dkv_smem(D, DV), "plan");
};

// One sweep of a consumer warpgroup over the block's (head, q tile) pairs:
// the NKC columns of dK from column K0 and the NVC columns of dV from V0
// (none where 0) accumulated and stored.  Per pair the warpgroup
// takes two turns with the other one (named barriers, as the forward's
// ping-pong): S^T and dP^T, then dV and dK; so one warpgroup's products run
// while the other computes P^T and dS^T.  `last`: the block's last sweep
// (warpgroup 1's last turn gives none back).  s, par: the ring's stage and
// full parity of the sweep's first pair, advanced past its last.
template <int D, int DV, int K0, int NKC, int V0, int NVC>
__device__ __forceinline__ void dkv_sweep(
        unsigned char* sbase, uint32_t base,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        int wg, int n_it, int q_first, int b, int hk,
        int k0, int Sq, int Skv, int Hkv, int q_offset, int causal,
        float scale, bool last, int& s, uint32_t& par) {
    using S = DkvSmem<D, DV>;
    constexpr int BQ = S::BQ, STAGES = S::STAGES;
    constexpr int WK = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    constexpr bool DO_DK = NKC > 0, DO_DV = NVC > 0;
    constexpr int NK = DO_DK ? NKC / 2 : 1, NV = DO_DV ? NVC / 2 : 1;
    const uint32_t sK = base + S::K_OFF, sV = base + S::V_OFF;
    const uint32_t bars = base + S::BAR_OFF;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
    const int g = lane / 4, t = lane % 4;
    const int kw0 = k0 + 64 * wg;               // the warpgroup's first kv row
    const int wrow = kw0 + 16 * warp;           // the warp's first kv row
    const int kp0 = wrow + g, kp1 = kp0 + 8;
    const float c = scale * tc::LOG2E;

    float dka[NK], dva[NV];
    #pragma unroll
    for (int i = 0; i < NK; ++i) dka[i] = 0.f;
    #pragma unroll
    for (int i = 0; i < NV; ++i) dva[i] = 0.f;
    float st[BQ / 2], dp[BQ / 2];
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];

    int q0 = q_first;
    for (int it = 0; it < n_it; ++it) {
        const uint32_t q_full = bars + 8 * (1 + s);
        const uint32_t q_empty = bars + 8 * (1 + STAGES + s);
        hw::mbar_wait(q_full, par);
        // every kv row of this warpgroup after every q row of the tile:
        // all masked, the products skipped (the turns still taken)
        const bool run = !(causal && kw0 > q_offset + q0 + BQ - 1);
        const uint32_t qt = base + S::Q_OFF + s * S::Q_STAGE;
        const uint32_t ot = base + S::DO_OFF + s * S::O_STAGE;
        const float* lt = reinterpret_cast<const float*>(
            sbase + S::L_OFF + s * 2 * BQ * 4);
        const float* dt = lt + BQ;
        // turn 1: S^T = K Q^T and dP^T = V dO^T
        hw::bar_sync(BAR_TURN + wg, 256);
        if (run) {
            hw::wg_fence();
            hw::Wgmma<BQ>::template ss0<0, 0>(
                st, hw::desc_k<WK>(sK, BKV, 64 * wg, 0),
                hw::desc_k<WK>(qt, BQ, 0, 0));
            #pragma unroll
            for (int kk = 1; kk < D / 16; ++kk)
                hw::Wgmma<BQ>::template ss<0, 0>(
                    st, hw::desc_k<WK>(sK, BKV, 64 * wg, kk),
                    hw::desc_k<WK>(qt, BQ, 0, kk), 1);
            hw::wg_commit();
            if constexpr (DO_DK) {
                hw::Wgmma<BQ>::template ss0<0, 0>(
                    dp, hw::desc_k<WV>(sV, BKV, 64 * wg, 0),
                    hw::desc_k<WV>(ot, BQ, 0, 0));
                #pragma unroll
                for (int kk = 1; kk < DV / 16; ++kk)
                    hw::Wgmma<BQ>::template ss<0, 0>(
                        dp, hw::desc_k<WV>(sV, BKV, 64 * wg, kk),
                        hw::desc_k<WV>(ot, BQ, 0, kk), 1);
                hw::wg_commit();
            }
        }
        hw::bar_arrive(BAR_TURN + 1 - wg, 256);
        if (run) {
            // both products at once: reading S^T while dP^T is in flight
            // would make ptxas serialise every wgmma (C7514)
            hw::wg_wait<0>();
            hw::fence_regs(st);
            if constexpr (DO_DK) hw::fence_regs(dp);
            // P^T = exp(scale S^T - lse) in fp32; masked on edge tiles
            const bool edge = q0 + BQ > Sq || wrow + 16 > Skv ||
                              (causal && wrow + 15 > q_offset + q0);
            #pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
                const int qc = n * 8 + 2 * t;
                const float2 L = *reinterpret_cast<const float2*>(lt + qc);
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = hw::ex2(fmaf(st[4 * n + e], c,
                                           -(e & 1 ? L.y : L.x) * tc::LOG2E));
                    if (edge) {
                        const int kp = e < 2 ? kp0 : kp1;
                        const int qr = q0 + qc + (e & 1);
                        if (qr >= Sq || kp >= Skv ||
                            (causal && kp > q_offset + qr))
                            p = 0.f;
                    }
                    st[4 * n + e] = p;
                }
            }
            // P^T and dS^T rounded once to bf16, packed into A operands
            #pragma unroll
            for (int n = 0; n < BQ / 8; ++n) {
                const int r = (n & 1) * 2;
                if constexpr (DO_DV) {
                    pa[n / 2][r] = tc::pack_bf16(st[4 * n], st[4 * n + 1]);
                    pa[n / 2][r + 1] = tc::pack_bf16(st[4 * n + 2], st[4 * n + 3]);
                }
                if constexpr (DO_DK) {
                    const float2 dl = *reinterpret_cast<const float2*>(
                        dt + n * 8 + 2 * t);
                    da[n / 2][r] = tc::pack_bf16(st[4 * n] * (dp[4 * n] - dl.x),
                                                 st[4 * n + 1] * (dp[4 * n + 1] - dl.y));
                    da[n / 2][r + 1] = tc::pack_bf16(
                        st[4 * n + 2] * (dp[4 * n + 2] - dl.x),
                        st[4 * n + 3] * (dp[4 * n + 3] - dl.y));
                }
            }
        }
        // turn 2: dV += P^T dO and dK += dS^T Q
        hw::bar_sync(BAR_TURN + wg, 256);
        if (run) {
            hw::wg_fence();
            // the sweep's columns start (V0 / WV, K0 / WK) boxes in
            if constexpr (DO_DV) {
                #pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk)
                    hw::Wgmma<NVC>::template rs<1>(
                        dva, pa[kk],
                        hw::desc_mn<WV>(ot + V0 / WV * BQ * WV * 2, BQ, kk), 1);
            }
            if constexpr (DO_DK) {
                #pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk)
                    hw::Wgmma<NKC>::template rs<1>(
                        dka, da[kk],
                        hw::desc_mn<WK>(qt + K0 / WK * BQ * WK * 2, BQ, kk), 1);
            }
            hw::wg_commit();
        }
        if (!(wg == 1 && last && it == n_it - 1))
            hw::bar_arrive(BAR_TURN + 1 - wg, 256);
        if (run) {
            hw::wg_wait<0>();
            hw::fence_regs(dka);
            hw::fence_regs(dva);
            hw::fence_regs(pa);
            hw::fence_regs(da);
        }
        hw::mbar_arrive_if(q_empty, lane == 0);
        if (++s == STAGES) {
            s = 0;
            par ^= 1;
        }
        q0 += BQ;
        if (q0 >= Sq) q0 = q_first;         // the group's next head
    }

    // the warpgroup's tiles of dK (scaled once) and dV, rows past Skv not
    // stored
    const long long k_row = (long long)Hkv * D, v_row = (long long)Hkv * DV;
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int s = (half ? kp1 : kp0);
        if (s >= Skv) continue;
        const long long row = (long long)b * Skv + s;
        if constexpr (DO_DK) {
            __nv_bfloat16* kr = dk + row * k_row + (long long)hk * D + K0;
            #pragma unroll
            for (int n = 0; n < NKC / 8; ++n)
                *reinterpret_cast<uint32_t*>(kr + n * 8 + 2 * t) = tc::pack_bf16(
                    dka[4 * n + 2 * half] * scale,
                    dka[4 * n + 2 * half + 1] * scale);
        }
        if constexpr (DO_DV) {
            __nv_bfloat16* vr = dv + row * v_row + (long long)hk * DV + V0;
            #pragma unroll
            for (int n = 0; n < NVC / 8; ++n)
                *reinterpret_cast<uint32_t*>(vr + n * 8 + 2 * t) = tc::pack_bf16(
                    dva[4 * n + 2 * half], dva[4 * n + 2 * half + 1]);
        }
    }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tmQ,
                           const __grid_constant__ CUtensorMap tmK,
                           const __grid_constant__ CUtensorMap tmV,
                           const __grid_constant__ CUtensorMap tmO,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int B, int Sq,
                           int Skv, int H, int Hkv, int q_offset, int causal,
                           float scale, int chunk) {
    using S = DkvSmem<D, DV>;
    constexpr int BQ = S::BQ, STAGES = S::STAGES;
    constexpr int WK = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    constexpr int SWEEPS = wgmma_plan::dkv_sweeps(D, DV);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hw::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* sbase = smem_raw + (base - raw);
    const uint32_t bars = base + S::BAR_OFF;
    const uint32_t kv_full = bars;

    const int tid = threadIdx.x, wg = hw::warpgroup();
    // block (batch, kv head, kv tile) in chunks of `chunk` (batch, kv
    // head) pairs whose q, dO, lse and delta fit half the L2
    // (wgmma_plan::block_tile), the kv tiles in order: under a causal mask
    // the first kv tiles, which meet the most q rows, start first
    int bh, kt;
    wgmma_plan::block_tile(blockIdx.x, B * Hkv, (Skv + BKV - 1) / BKV, chunk,
                           bh, kt);
    const int hk = bh % Hkv, b = bh / Hkv;
    const int k0 = kt * BKV;
    const int G = H / Hkv;
    // q tiles whose last row lies before this kv tile are fully masked
    int q_first = 0;
    if (causal && k0 > q_offset) q_first = ((k0 - q_offset) / BQ) * BQ;
    const int nq = q_first < Sq ? (Sq - q_first + BQ - 1) / BQ : 0;
    const int n_it = G * nq;            // (head of the group, q tile) pairs

    if (tid == 0) {
        hw::mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            hw::mbar_init(bars + 8 * (1 + s), 32);          // q_full
            hw::mbar_init(bars + 8 * (1 + STAGES + s), 8);  // q_empty
        }
        hw::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: warp 8 fills the ring, its lane 0 starts the TMA ----
        hw::regs_dec<PRODUCER_REGS>();
        if (tid / 32 == 8) {
            const int lane = tid % 32;
            if (lane == 0) {
                hw::mbar_arrive_tx(kv_full, S::KV_BYTES);
                #pragma unroll
                for (int c = 0; c < D / WK; ++c)
                    hw::tma_load_4d(base + S::K_OFF + c * BKV * WK * 2, &tmK,
                                    kv_full, c * WK, hk, k0, b);
                #pragma unroll
                for (int c = 0; c < DV / WV; ++c)
                    hw::tma_load_4d(base + S::V_OFF + c * BKV * WV * 2, &tmV,
                                    kv_full, c * WV, hk, k0, b);
            }
            int s = 0;
            uint32_t par = 1;                   // empty: the previous phase
            for (int i = 0; i < SWEEPS * G; ++i) {
                const int h = hk * G + i % G;
                const long long stat = ((long long)b * H + h) * Sq;
                for (int q0 = q_first; q0 < Sq; q0 += BQ) {
                    const uint32_t q_full = bars + 8 * (1 + s);
                    hw::mbar_wait(bars + 8 * (1 + STAGES + s), par);
                    float* lt = reinterpret_cast<float*>(
                        sbase + S::L_OFF + s * 2 * BQ * 4);
                    for (int r = lane; r < BQ; r += 32) {
                        const bool in = q0 + r < Sq;
                        lt[r] = in ? lse[stat + q0 + r] : 0.f;
                        lt[BQ + r] = in ? delta[stat + q0 + r] : 0.f;
                    }
                    if (lane == 0) {
                        hw::mbar_arrive_tx(q_full, S::Q_STAGE + S::O_STAGE);
                        #pragma unroll
                        for (int c = 0; c < D / WK; ++c)
                            hw::tma_load_4d(base + S::Q_OFF + s * S::Q_STAGE +
                                                c * BQ * WK * 2,
                                            &tmQ, q_full, c * WK, h, q0, b);
                        #pragma unroll
                        for (int c = 0; c < DV / WV; ++c)
                            hw::tma_load_4d(base + S::DO_OFF + s * S::O_STAGE +
                                                c * BQ * WV * 2,
                                            &tmO, q_full, c * WV, h, q0, b);
                    } else {
                        hw::mbar_arrive(q_full);
                    }
                    if (++s == STAGES) {
                        s = 0;
                        par ^= 1;
                    }
                }
            }
        }
    } else {
        hw::regs_inc<CONSUMER_REGS>();
        // warpgroup 0 takes the first turn
        if (wg == 1 && n_it > 0) hw::bar_arrive(BAR_TURN, 256);
        hw::mbar_wait(kv_full, 0);
        int s = 0;
        uint32_t par = 0;
        if constexpr (SWEEPS == 1) {
            dkv_sweep<D, DV, 0, D, 0, DV>(sbase, base, dk, dv, wg, n_it,
                                          q_first, b, hk, k0, Sq, Skv, Hkv,
                                          q_offset, causal, scale, true, s,
                                          par);
        } else if constexpr (SWEEPS == 2) {
            dkv_sweep<D, DV, 0, 0, 0, DV>(sbase, base, dk, dv, wg, n_it,
                                          q_first, b, hk, k0, Sq, Skv, Hkv,
                                          q_offset, causal, scale, false, s,
                                          par);
            dkv_sweep<D, DV, 0, D, 0, 0>(sbase, base, dk, dv, wg, n_it,
                                         q_first, b, hk, k0, Sq, Skv, Hkv,
                                         q_offset, causal, scale, true, s,
                                         par);
        } else {
            // four sweeps: dV's and then dK's column halves
            dkv_sweep<D, DV, 0, 0, 0, DV / 2>(sbase, base, dk, dv, wg, n_it,
                                              q_first, b, hk, k0, Sq, Skv,
                                              Hkv, q_offset, causal, scale,
                                              false, s, par);
            dkv_sweep<D, DV, 0, 0, DV / 2, DV / 2>(
                sbase, base, dk, dv, wg, n_it, q_first, b, hk, k0, Sq, Skv,
                Hkv, q_offset, causal, scale, false, s, par);
            dkv_sweep<D, DV, 0, D / 2, 0, 0>(sbase, base, dk, dv, wg, n_it,
                                             q_first, b, hk, k0, Sq, Skv, Hkv,
                                             q_offset, causal, scale, false,
                                             s, par);
            dkv_sweep<D, DV, D / 2, D / 2, 0, 0>(
                sbase, base, dk, dv, wg, n_it, q_first, b, hk, k0, Sq, Skv,
                Hkv, q_offset, causal, scale, true, s, par);
        }
    }
}

constexpr long long MAX_BLOCKS = 0x7fffffffLL;

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int Sq, int Skv, int H, int Hkv, int q_offset, int causal,
           float scale, cudaStream_t stream) {
    using S = DkvSmem<D, DV>;
    constexpr int WK = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    const long long blocks = (long long)Hkv * B * ((Skv + BKV - 1) / BKV);
    if (blocks > MAX_BLOCKS) return -1;
    CUtensorMap tq, tk, tv, to;
    if (!wgmma_host::encode(&tq, q, D, H, Sq, B, WK, S::BQ, WK) ||
        !wgmma_host::encode(&tk, k, D, Hkv, Skv, B, WK, BKV, WK) ||
        !wgmma_host::encode(&tv, v, DV, Hkv, Skv, B, WV, BKV, WV) ||
        !wgmma_host::encode(&to, dout, DV, H, Sq, B, WV, S::BQ, WV))
        return -2;
    auto kern = flash_bwd_dkv_kernel_wgmma<D, DV>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    // a (batch, kv head) pair streams its G heads' q, dO, lse and delta
    const int chunk = wgmma_plan::chunk_pairs(
        (long long)Sq * ((D + DV) * 2 + 8) * (H / Hkv));
    kern<<<(unsigned)blocks, THREADS, S::ALLOC, stream>>>(
        tq, tk, tv, to, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), B, Sq, Skv, H, Hkv, q_offset, causal,
        scale, chunk);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point of the bf16 dk / dv pass of this design: contiguous,
// 16-byte aligned q (B, Sq, H, D), k / dk (B, Skv, Hkv, D), v / dv (B, Skv,
// Hkv, Dv), dout (B, Sq, H, Dv) bf16, lse and delta (B, H, Sq) fp32 (delta
// from the dq pass, enqueued before on the same stream).  Returns the
// launch's cudaGetLastError() (0 on success), -1 on arguments it does not
// take, -2 where cuTensorMapEncodeTiled refused a tensor map.
extern "C" int flash_bwd_dkv_wgmma_launch(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
        int Skv, int H, int Hkv, int D, int Dv, int q_offset, int causal,
        float scale, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 ||
        q_offset < 0)
        return -1;
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
    if (any % 16) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_WGMMA_CASE(d, dv_)                                              \
    if (D == d && Dv == dv_)                                                \
        return launch<d, dv_>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, \
                              H, Hkv, q_offset, causal, scale, st);
    DKV_WGMMA_CASE(16, 16)
    DKV_WGMMA_CASE(32, 32)
    DKV_WGMMA_CASE(64, 64)
    DKV_WGMMA_CASE(128, 128)
    DKV_WGMMA_CASE(128, 64)
    DKV_WGMMA_CASE(192, 128)
    DKV_WGMMA_CASE(96, 64)
    DKV_WGMMA_CASE(80, 80)
    DKV_WGMMA_CASE(256, 256)
#undef DKV_WGMMA_CASE
    return -1;
}
