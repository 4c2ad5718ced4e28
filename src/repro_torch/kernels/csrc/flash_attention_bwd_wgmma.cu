// flash_bwd_dq_kernel_wgmma and flash_bwd_dkv_kernel_wgmma: the bf16 dq
// and dk / dv passes of the flash backward redesigned for Hopper: TMA loads
// that complete on mbarriers, a producer warp feeding a ring, two consumer
// warpgroups on wgmma in ping-pong turns.
//
// Replace the TPU kernels repro/kernels/flash_attention.py::_dq_kernel
// (pallas_call at :303) and ::_dkv_kernel (pallas_call at :326) for bf16
// at every compiled pair (fp32 runs flash_attention_bwd.cu's FMA kernels).
// The dq pass runs first and leaves delta = sum(dO * out) for the dk / dv
// pass, which runs after it on the same stream.  They compute what those
// kernels compute: p = exp(scale s - lse) under the forward's masks (k_pos
// >= Skv, q_row >= Sq, causal k_pos > q_offset + q_row give p = 0), ds = p
// (dO . v^T - delta); dq = scale * sum ds k over the kv rows; dv = sum
// over the G query heads of a kv head's group and every q row of p^T dO,
// dk = scale * sum ds^T q.  GQA by index (kv head = h / (H / Hkv)).
//
// What bounds them on an H100: operations, 2 B H Sq Skv (2D + Dv) for dq
// (s and dq at D, dp at Dv) and 2 B H Sq Skv (2D + 2Dv) for dk / dv (s and
// dk at D, dp and dv at Dv), halved when causal, against 989 TFLOP/s of
// bf16; where the dk / dv block sweeps its q tiles more than once (below)
// it recomputes s: 2 B H Sq Skv (3D + 2Dv) in two sweeps, (6D + 2Dv) in
// four.  What the designs do about it, per block of 384 threads:
//
// dq, a block per (batch, head, 128-row q tile):
// * Warpgroup 2 is the producer (setmaxnreg.dec to 40).  One thread loads
//   the block's q and dO tiles once, TMA boxes of the 4-D (D, H, Sq, B)
//   views, then streams the kv head's K and V tiles of BK rows (dq_bk: 64,
//   32 at (256, 256)) through a ring of 3 stages (dq_stages; 2 where 3
//   would pass the shared-memory opt-in), rows past Sq or Skv as zeros; a
//   stage's full mbarrier takes the copies' bytes, its empty one an
//   arrival from each consumer warp.
// * Warpgroups 0 and 1 are the consumers (setmaxnreg.inc to 232), 64 q rows
//   each, holding their fp32 dQ accumulators (D / 2 registers) in wgmma
//   registers and their rows' lse and delta in registers; each first
//   computes delta of its rows in fp32 from dO and out in device memory
//   and stores it.  Per kv tile: S = Q K^T and dP = dO V^T by
//   wgmma.m64n{BK}k16 from shared memory (both K-major), launched
//   together; P = exp2(c S - lse log2 e) in fp32; dS = P (dP - delta)
//   rounded once to bf16 (C12, as the dk / dv pass rounds) and packed
//   straight into A operands; dQ += dS K by wgmma with A from registers and
//   K MN-major in shared memory (the transpose is the descriptor's).  The
//   two warpgroups take turns at the tensor cores (two named barriers):
//   S and dP, then dQ, so that one computes P and dS while the other's
//   products run.  A warpgroup skips the kv tiles wholly after its rows'
//   diagonal, and the block stops after the last tile that meets its
//   last row's.  dQ is scaled once at the store.
// * The blocks run in chunks of (batch, head) pairs whose K and V fit half
//   the L2 (wgmma_plan::block_tile), heads fastest so that a group's G
//   heads read one K and V from it, the q tiles of a chunk in reverse:
//   under a causal mask the heaviest first.
//
// dk / dv, a block per (batch, kv head, 128-row kv tile):
// * Warpgroup 2 is the producer.  One thread loads
//   the block's K and V once, TMA boxes of the 4-D (D, Hkv, Skv, B) views,
//   rows past Skv as zeros; then, for every (head of the group, q tile) in
//   a fixed order from the causal start, its warp fills a stage of a ring
//   of 3 (dkv_stages): the tile's lse and delta rows by plain loads (rows
//   past Sq as 0: an fp32 row of Sq values is not a TMA box when Sq is not
//   a multiple of 4) and the q and dO tiles by TMA; the full mbarrier
//   counts the warp's 32 arrivals and the copies' bytes, the empty one an
//   arrival from each consumer warp.
// * Warpgroups 0 and 1 are the consumers, 64 kv rows
//   each, holding their fp32 dK and dV accumulators in wgmma registers.
//   Per q tile of BQ rows (dkv_bq: 64, or 32): S^T = K Q^T and dP^T = V
//   dO^T by wgmma.m64n{BQ}k16 from shared memory (both K-major), launched
//   together; P^T = exp2(c S^T - lse log2 e) in fp32; P^T and dS^T = P^T
//   (dP^T - delta) each rounded once to bf16 in registers (C12), packed
//   straight into A operands; dV += P^T dO and dK += dS^T Q by wgmma with
//   A from registers and dO / Q MN-major in shared memory.  A warpgroup
//   whose kv rows all lie after the tile's last q row skips it.  The two
//   warpgroups take turns as in dq: S^T and dP^T, then dV and dK.  dK is
//   scaled once at the store.
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
// 16 columns a box).  Each dq, dk and dv tile is written once by one block
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

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = wgmma_plan::DQ_BQ;   // q rows per block

template <int D, int DV>
struct DqSmem {                         // byte offsets from a 1,024-aligned base
    static constexpr int BK = wgmma_plan::dq_bk(D, DV);
    static constexpr int STAGES = wgmma_plan::dq_stages(D, DV);
    static constexpr int Q_OFF = 0;
    static constexpr int DO_OFF = Q_OFF + DQ_BQ * D * 2;
    static constexpr int QO_BYTES = DQ_BQ * (D + DV) * 2;
    static constexpr int K_STAGE = BK * D * 2;
    static constexpr int V_STAGE = BK * DV * 2;
    static constexpr int K_OFF = Q_OFF + QO_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * K_STAGE;
    static constexpr int BAR_OFF = V_OFF + STAGES * V_STAGE;
    // q_full, then per stage kv_full, kv_empty
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * STAGES);
    static constexpr int ALLOC = BYTES + 1024;
    static_assert(ALLOC == wgmma_plan::dq_smem(D, DV), "plan");
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const __grid_constant__ CUtensorMap tmO,
                          const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int B, int Sq,
                          int Skv, int H, int Hkv, int q_offset, int causal,
                          float scale, int chunk) {
    using S = DqSmem<D, DV>;
    constexpr int BK = S::BK, STAGES = S::STAGES;
    constexpr int WK = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hw::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t sQ = base + S::Q_OFF, sO = base + S::DO_OFF;
    const uint32_t sK = base + S::K_OFF, sV = base + S::V_OFF;
    const uint32_t bars = base + S::BAR_OFF;
    const uint32_t q_full = bars;
    auto kv_full = [&](int s) { return bars + 8 * (1 + s); };
    auto kv_empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

    const int tid = threadIdx.x, wg = hw::warpgroup();
    // block (batch, head, q tile) in chunks of `chunk` (batch, head) pairs
    // whose K and V fit half the L2, heads fastest (a group's G heads,
    // which read one K and V, side by side), the q tiles in reverse:
    // under a causal mask the heaviest first
    const int n_qt = (Sq + DQ_BQ - 1) / DQ_BQ;
    int bh, qt;
    wgmma_plan::block_tile(blockIdx.x, B * H, n_qt, chunk, bh, qt);
    const int h = bh % H, b = bh / H;
    const int q0 = (n_qt - 1 - qt) * DQ_BQ;
    const int hk = h / (H / Hkv);
    // kv tiles past the block's last row's diagonal are fully masked
    const int kv_end = causal ? min(Skv, q_offset + q0 + DQ_BQ) : Skv;
    const int n_tiles = (kv_end + BK - 1) / BK;

    if (tid == 0) {
        hw::mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            hw::mbar_init(kv_full(s), 1);
            hw::mbar_init(kv_empty(s), 8);      // one arrival per consumer warp
        }
        hw::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one thread starts every TMA copy ----
        hw::regs_dec<PRODUCER_REGS>();
        if (tid == 256) {
            hw::mbar_arrive_tx(q_full, S::QO_BYTES);
            #pragma unroll
            for (int c = 0; c < D / WK; ++c)
                hw::tma_load_4d(sQ + c * DQ_BQ * WK * 2, &tmQ, q_full, c * WK,
                                h, q0, b);
            #pragma unroll
            for (int c = 0; c < DV / WV; ++c)
                hw::tma_load_4d(sO + c * DQ_BQ * WV * 2, &tmO, q_full, c * WV,
                                h, q0, b);
            int s = 0;
            uint32_t par = 1;                   // empty: the previous phase
            for (int j = 0; j < n_tiles; ++j) {
                hw::mbar_wait(kv_empty(s), par);
                hw::mbar_arrive_tx(kv_full(s), S::K_STAGE + S::V_STAGE);
                #pragma unroll
                for (int c = 0; c < D / WK; ++c)
                    hw::tma_load_4d(sK + s * S::K_STAGE + c * BK * WK * 2, &tmK,
                                    kv_full(s), c * WK, hk, j * BK, b);
                #pragma unroll
                for (int c = 0; c < DV / WV; ++c)
                    hw::tma_load_4d(sV + s * S::V_STAGE + c * BK * WV * 2, &tmV,
                                    kv_full(s), c * WV, hk, j * BK, b);
                if (++s == STAGES) {
                    s = 0;
                    par ^= 1;
                }
            }
        }
    } else {
        // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
        hw::regs_inc<CONSUMER_REGS>();
        const int t128 = tid % 128, lane = tid % 32;
        const int warp = __shfl_sync(0xffffffffu, t128 / 32, 0);
        const int g = lane / 4, t = lane % 4;
        const int r0 = q0 + 64 * wg;            // the warpgroup's first row
        const int wrow = r0 + 16 * warp;        // the warp's first row
        const int ra = wrow + g, rb = ra + 8;   // this thread's two rows
        const bool ina = ra < Sq, inb = rb < Sq;
        const float c = scale * tc::LOG2E;      // exp(scale s) = exp2(c s)

        // delta = sum_d dO * out of rows ra, rb in fp32, from device memory
        // (the dO tile in shared memory is swizzled; rows past Sq read row
        // 0 and count 0), stored for the dk / dv pass; lse of the rows
        const long long stat = ((long long)b * H + h) * Sq;
        const long long o_row = (long long)H * DV;
        const long long ob = (long long)b * Sq * o_row + (long long)h * DV;
        float dl0, dl1, lc0, lc1;
        {
            const long long oa = ob + (ina ? ra : 0) * o_row;
            const long long oc = ob + (inb ? rb : 0) * o_row;
            float s0 = 0.f, s1 = 0.f;
            #pragma unroll
            for (int n = 0; n < DV / 8; ++n) {
                const int col = n * 8 + 2 * t;
                const float2 a0 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(dout + oa + col));
                const float2 b0 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(out + oa + col));
                const float2 a1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(dout + oc + col));
                const float2 b1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(out + oc + col));
                s0 = fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, s0));
                s1 = fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, s1));
            }
            // every lane takes the quad sums (shuffles of the whole
            // warp), then rows past Sq drop theirs
            s0 = tc::quad_sum(s0);
            s1 = tc::quad_sum(s1);
            dl0 = ina ? s0 : 0.f;
            dl1 = inb ? s1 : 0.f;
            lc0 = ina ? lse[stat + ra] * tc::LOG2E : 0.f;
            lc1 = inb ? lse[stat + rb] * tc::LOG2E : 0.f;
            if (t == 0 && ina) delta[stat + ra] = dl0;
            if (t == 0 && inb) delta[stat + rb] = dl1;
        }

        float acc[D / 2];
        #pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float st[BK / 2], dp[BK / 2];
        uint32_t da[BK / 16][4];

        if (wg == 1) hw::bar_arrive(BAR_TURN, 256);   // warpgroup 0 first
        hw::mbar_wait(q_full, 0);
        int s = 0;
        uint32_t par = 0;
        for (int j = 0; j < n_tiles; ++j) {
            const int k0 = j * BK;
            hw::mbar_wait(kv_full(s), par);
            // a warpgroup past Sq, or whose rows all lie before the tile's
            // first kv row, skips its products (the turns still taken)
            const bool run = r0 < Sq && !(causal && k0 > q_offset + r0 + 63);
            const uint32_t kt = sK + s * S::K_STAGE;
            const uint32_t vt = sV + s * S::V_STAGE;
            // turn 1: S = Q K^T and dP = dO V^T
            hw::bar_sync(BAR_TURN + wg, 256);
            if (run) {
                hw::wg_fence();
                hw::Wgmma<BK>::template ss0<0, 0>(
                    st, hw::desc_k<WK>(sQ, DQ_BQ, 64 * wg, 0),
                    hw::desc_k<WK>(kt, BK, 0, 0));
                #pragma unroll
                for (int kk = 1; kk < D / 16; ++kk)
                    hw::Wgmma<BK>::template ss<0, 0>(
                        st, hw::desc_k<WK>(sQ, DQ_BQ, 64 * wg, kk),
                        hw::desc_k<WK>(kt, BK, 0, kk), 1);
                hw::wg_commit();
                hw::Wgmma<BK>::template ss0<0, 0>(
                    dp, hw::desc_k<WV>(sO, DQ_BQ, 64 * wg, 0),
                    hw::desc_k<WV>(vt, BK, 0, 0));
                #pragma unroll
                for (int kk = 1; kk < DV / 16; ++kk)
                    hw::Wgmma<BK>::template ss<0, 0>(
                        dp, hw::desc_k<WV>(sO, DQ_BQ, 64 * wg, kk),
                        hw::desc_k<WV>(vt, BK, 0, kk), 1);
                hw::wg_commit();
            }
            hw::bar_arrive(BAR_TURN + 1 - wg, 256);
            if (run) {
                // both products at once (reading S while dP is in flight
                // would serialise every wgmma, C7514)
                hw::wg_wait<0>();
                hw::fence_regs(st);
                hw::fence_regs(dp);
                // P = exp(scale S - lse) in fp32, masked on edge tiles; dS
                // = P (dP - delta) rounded once to bf16, packed into A
                // operands
                const bool edge = k0 + BK > Skv || wrow + 16 > Sq ||
                                  (causal && k0 + BK - 1 > q_offset + wrow);
                #pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float p = hw::ex2(fmaf(st[4 * n + e], c,
                                               -(e < 2 ? lc0 : lc1)));
                        if (edge) {
                            const int kp = k0 + n * 8 + 2 * t + (e & 1);
                            const int qr = e < 2 ? ra : rb;
                            if (kp >= Skv || qr >= Sq ||
                                (causal && kp > q_offset + qr))
                                p = 0.f;
                        }
                        st[4 * n + e] = p * (dp[4 * n + e] - (e < 2 ? dl0 : dl1));
                    }
                    da[n / 2][(n & 1) * 2] = tc::pack_bf16(st[4 * n], st[4 * n + 1]);
                    da[n / 2][(n & 1) * 2 + 1] =
                        tc::pack_bf16(st[4 * n + 2], st[4 * n + 3]);
                }
            }
            // turn 2: dQ += dS K, K MN-major (the transpose is the
            // descriptor's)
            hw::bar_sync(BAR_TURN + wg, 256);
            if (run) {
                hw::wg_fence();
                #pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    hw::Wgmma<D>::template rs<1>(
                        acc, da[kk], hw::desc_mn<WK>(kt, BK, kk), 1);
                hw::wg_commit();
            }
            // (warpgroup 1's last turn gives none back)
            if (!(wg == 1 && j == n_tiles - 1))
                hw::bar_arrive(BAR_TURN + 1 - wg, 256);
            if (run) {
                hw::wg_wait<0>();
                hw::fence_regs(acc);
                hw::fence_regs(da);
            }
            hw::mbar_arrive_if(kv_empty(s), lane == 0);
            if (++s == STAGES) {
                s = 0;
                par ^= 1;
            }
        }

        // dQ scaled once, rows past Sq not stored
        const long long q_row = (long long)H * D;
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = half ? rb : ra;
            if (row >= Sq) continue;
            __nv_bfloat16* qr =
                dq + ((long long)b * Sq + row) * q_row + (long long)h * D;
            #pragma unroll
            for (int n = 0; n < D / 8; ++n)
                *reinterpret_cast<uint32_t*>(qr + n * 8 + 2 * t) = tc::pack_bf16(
                    acc[4 * n + 2 * half] * scale,
                    acc[4 * n + 2 * half + 1] * scale);
        }
    }
}

// the dq pass's four tensor maps: q, k, v, dout; false where one is refused
bool dq_maps(CUtensorMap (&m)[4], const void* q, const void* k,
             const void* v, const void* dout, int B, int Sq, int Skv, int H,
             int Hkv, int D, int Dv) {
    const int wk = wgmma_plan::swizzle_cols(D);
    const int wv = wgmma_plan::swizzle_cols(Dv);
    const int bk = wgmma_plan::dq_bk(D, Dv);
    return wgmma_host::encode(&m[0], q, D, H, Sq, B, wk, DQ_BQ, wk) &&
           wgmma_host::encode(&m[1], k, D, Hkv, Skv, B, wk, bk, wk) &&
           wgmma_host::encode(&m[2], v, Dv, Hkv, Skv, B, wv, bk, wv) &&
           wgmma_host::encode(&m[3], dout, Dv, H, Sq, B, wv, DQ_BQ, wv);
}

template <int D, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, void* delta, void* dq,
              int B, int Sq, int Skv, int H, int Hkv, int q_offset,
              int causal, float scale, cudaStream_t stream) {
    using S = DqSmem<D, DV>;
    const long long blocks = (long long)H * B * ((Sq + DQ_BQ - 1) / DQ_BQ);
    if (blocks > MAX_BLOCKS) return -1;
    CUtensorMap m[4];
    if (!dq_maps(m, q, k, v, dout, B, Sq, Skv, H, Hkv, D, DV)) return -2;
    auto kern = flash_bwd_dq_kernel_wgmma<D, DV>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::ALLOC);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    // a (batch, q head) pair streams its kv head's K and V
    const int chunk = wgmma_plan::chunk_pairs(
        (long long)Skv * (D + DV) * 2 * Hkv / H);
    kern<<<(unsigned)blocks, THREADS, S::ALLOC, stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<float*>(delta),
        static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, H, Hkv, q_offset, causal,
        scale, chunk);
    return (int)cudaGetLastError();
}

bool takes(int B, int Sq, int Skv, int H, int Hkv, int q_offset) {
    return B >= 1 && H >= 1 && Hkv >= 1 && H % Hkv == 0 && Sq >= 1 &&
           Skv >= 1 && q_offset >= 0;
}

}  // namespace

// Plain C entry point of the bf16 dq pass of this design: contiguous,
// 16-byte aligned q / dq (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv,
// Dv), out / dout (B, Sq, H, Dv) bf16, lse (B, H, Sq) fp32; writes dq and
// delta = sum(dout * out) (B, H, Sq) fp32 for the dk / dv pass, which runs
// after it on the same stream.  Returns the launch's cudaGetLastError() (0
// on success), -1 on arguments it does not take, -2 where
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int flash_bwd_dq_wgmma_launch(
        const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* delta, void* dq, int B,
        int Sq, int Skv, int H, int Hkv, int D, int Dv, int q_offset,
        int causal, float scale, void* stream) {
    if (!takes(B, Sq, Skv, H, Hkv, q_offset)) return -1;
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(dout) |
                          reinterpret_cast<uintptr_t>(dq);
    if (any % 16) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_WGMMA_CASE(d, dv_)                                               \
    if (D == d && Dv == dv_)                                                \
        return launch_dq<d, dv_>(q, k, v, out, dout, lse, delta, dq, B, Sq, \
                                 Skv, H, Hkv, q_offset, causal, scale, st);
    DQ_WGMMA_CASE(16, 16)
    DQ_WGMMA_CASE(32, 32)
    DQ_WGMMA_CASE(64, 64)
    DQ_WGMMA_CASE(128, 128)
    DQ_WGMMA_CASE(128, 64)
    DQ_WGMMA_CASE(192, 128)
    DQ_WGMMA_CASE(96, 64)
    DQ_WGMMA_CASE(80, 80)
    DQ_WGMMA_CASE(256, 256)
#undef DQ_WGMMA_CASE
    return -1;
}

// The host side of one dq launch's tensor maps, for timing: the four
// cuTensorMapEncodeTiled calls flash_bwd_dq_wgmma_launch makes, `reps`
// times over.  0, or -2 where a map is refused.
extern "C" int flash_bwd_dq_wgmma_encode(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         int B, int Sq, int Skv, int H,
                                         int Hkv, int D, int Dv, int reps) {
    CUtensorMap m[4];
    for (int i = 0; i < reps; ++i)
        if (!dq_maps(m, q, k, v, dout, B, Sq, Skv, H, Hkv, D, Dv)) return -2;
    return 0;
}

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
    if (!takes(B, Sq, Skv, H, Hkv, q_offset)) return -1;
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
