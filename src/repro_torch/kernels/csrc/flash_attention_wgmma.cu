// flash_fwd_kernel_wgmma: the bf16 flash attention forward redesigned for
// Hopper (FlashAttention-3's shape): TMA loads that complete on mbarriers,
// a producer warp, two consumer warpgroups on wgmma, ping-pong between them.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (pallas_call at :131) for bf16 at every compiled pair (fp32 runs
// flash_attention.cu's FMA kernel).  It computes
// what that kernel computes: s = q . k^T summed in fp32, the scale D^-0.5
// applied to the fp32 scores, masked scores (k_pos >= Skv, or causal k_pos >
// q_offset + q_row) -1e30, the online softmax, out = p . v / l in q's type,
// lse = m + log(l) in fp32 with l floored at 1e-30.  GQA by index (kv head
// = h / (H / Hkv)), no kv copy.
//
// What bounds it on an H100: operations.  2 B H Sq Skv (D + Dv) of them in
// the reference's count (halved when causal); this kernel carries P into
// P v as two bf16 parts, hi = bf16(P) and lo = bf16(P - hi) (the
// reduced llava15-7b's gradients need them, PERF.md C12), so it runs
// 2 B H Sq Skv (D + 2 Dv): 1.5x at D = Dv, against 989 TFLOP/s of bf16.
// What the design does about it, per block of 384 threads:
//
// * Warpgroup 2 is the producer.  It gives its registers away
//   (setmaxnreg.dec to 40) and one thread starts every copy: the block's
//   128-row q tile once, then the kv tiles of BK rows (fwd_bk: 128, 64 at
//   (256, 256)) through a ring of 3 K and 3 V buffers (2 where 3 would pass
//   the shared-memory opt-in: (192, 128), (256, 256)), each with a full
//   mbarrier (arrive.expect_tx of the tile's bytes, completed by the TMA)
//   and an empty one (one arrival from each consumer warp).  Each copy is a
//   TMA box of the 4-D (D, H, S, B) view of q, k or v: a (batch, head)
//   tile of W columns, W the swizzle width the head dim allows (64 bf16 =
//   128-byte swizzle; 32 = 64-byte at D = 96 and 32; 16 = 32-byte at D = 80
//   and 16: an 80-column row is five 16-column boxes, not 64 + 16, so one
//   descriptor layout serves every k-step).  Rows past Sq or Skv arrive as
//   zeros; no padded copy is made.
// * Warpgroups 0 and 1 are the consumers (setmaxnreg.inc to 232), 64 q rows
//   each.  Per kv tile j: S = Q K^T by wgmma.m64n{BK}k16 with both operands
//   in shared memory (K-major); the online softmax on the fp32 accumulator
//   registers (row max by quad shuffles, the row sums per-lane partials
//   until the end, exp2 with scale * log2 e folded in); O rescaled; P split
//   into hi / lo bf16 A operands in registers; O += P_hi V + P_lo V by
//   wgmma.m64n{Dv}k16 with A from registers and V MN-major from shared
//   memory.  A slot of tensor-core work is [O += P(j-1) V(j-1), S(j) = Q
//   K(j)^T], launched together; the two warpgroups take slots in turns (two
//   named barriers, FlashAttention-3's ping-pong), so one warpgroup's
//   softmax runs while the other's products do.  Ping-pong rather than
//   FA3's intra-warpgroup pipeline: the hi / lo P already doubles P's
//   registers, and at BK = 128 a second live score tile (64 more) beside
//   O (64), P (64) and S (64) would pass the 232 a consumer thread holds.
// * The epilogue divides by l, writes O as bf16 into the q tile's shared
//   memory (free once both consumers are done with q) and stores it with
//   one TMA box per warpgroup, clipped at Sq; lse goes out from registers.
//
// The blocks run in chunks of (batch, head) pairs whose K and V fit half
// the L2 (wgmma_plan::block_tile), within a chunk the q tiles in reverse,
// so under a causal mask the heaviest tiles start first, and the pairs
// fastest, so that the blocks in flight read K and V from the L2 (in
// flash_attention.cu's order, heads fastest, 132 blocks in flight touch
// 132 heads' K and V: 132 MB at (8, 2048, 32, 128), read again from
// device memory for every q tile).  A block stops after the last kv tile
// that meets its rows' diagonal.  The loop
// order is fixed and no sum crosses a block: bit-equal from one launch to
// the next.  Registers, spills and stack per instance: ptxas -v
// (chip_smoke.py's ptxas line fails on a spill or a C7508 "setmaxnreg
// ignored" warning).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "wgmma_plan.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = wgmma_plan::FWD_BQ;  // q rows per block, 64 per consumer
constexpr int THREADS = 384;            // 2 consumer + 1 producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// named barriers (0 is __syncthreads): the consumers' turns, and the
// epilogue's
constexpr int BAR_TURN = 1, BAR_EPI = 3, BAR_EPI_WG = 4;

template <int D, int DV>
struct FwdSmem {                        // byte offsets from a 1,024-aligned base
    static constexpr int BK = wgmma_plan::fwd_bk(D, DV);
    static constexpr int STAGES = wgmma_plan::fwd_stages(D, DV);
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int K_STAGE = BK * D * 2;
    static constexpr int V_STAGE = BK * DV * 2;
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + Q_BYTES;
    static constexpr int V_OFF = K_OFF + STAGES * K_STAGE;
    static constexpr int BAR_OFF = V_OFF + STAGES * V_STAGE;
    // q_full, then per stage k_full, k_empty, v_full, v_empty
    static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES);
    static constexpr int ALLOC = BYTES + 1024;    // room to align the base
    static_assert(ALLOC == wgmma_plan::fwd_smem(D, DV), "plan");
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tmQ,
                       const __grid_constant__ CUtensorMap tmK,
                       const __grid_constant__ CUtensorMap tmV,
                       const __grid_constant__ CUtensorMap tmO,
                       float* __restrict__ lse, int B, int Sq, int Skv,
                       int H, int Hkv, int q_offset, int causal,
                       float scale, int chunk) {
    using S = FwdSmem<D, DV>;
    constexpr int BK = S::BK, STAGES = S::STAGES;
    constexpr int WQ = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = hw::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    unsigned char* sbase = smem_raw + (base - raw);
    const uint32_t sQ = base + S::Q_OFF, sK = base + S::K_OFF;
    const uint32_t sV = base + S::V_OFF, bars = base + S::BAR_OFF;
    const uint32_t q_full = bars;
    auto k_full = [&](int s) { return bars + 8 * (1 + s); };
    auto k_empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
    auto v_full = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
    auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * STAGES + s); };

    const int tid = threadIdx.x, wg = hw::warpgroup();
    // block (batch, head, q tile) in chunks of `chunk` (batch, head) pairs
    // (wgmma_plan::block_tile), the q tiles in reverse: heaviest first
    const int n_qt = (Sq + BQ - 1) / BQ;
    int bh, qt;
    wgmma_plan::block_tile(blockIdx.x, B * H, n_qt, chunk, bh, qt);
    const int h = bh % H, b = bh / H;
    const int q0 = (n_qt - 1 - qt) * BQ;
    const int hk = h / (H / Hkv);
    // kv tiles past the block's last row's diagonal are fully masked
    const int kv_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
    const int n_tiles = (kv_end + BK - 1) / BK;

    if (tid == 0) {
        hw::mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            hw::mbar_init(k_full(s), 1);
            hw::mbar_init(k_empty(s), 8);       // one arrival per consumer warp
            hw::mbar_init(v_full(s), 1);
            hw::mbar_init(v_empty(s), 8);
        }
        hw::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer: one thread starts every TMA copy ----
        hw::regs_dec<PRODUCER_REGS>();
        if (tid == 256) {
            hw::mbar_arrive_tx(q_full, S::Q_BYTES);
            #pragma unroll
            for (int c = 0; c < D / WQ; ++c)
                hw::tma_load_4d(sQ + c * BQ * WQ * 2, &tmQ, q_full, c * WQ, h,
                                q0, b);
            int s = 0;
            uint32_t par = 1;                   // empty: the previous phase
            for (int j = 0; j < n_tiles; ++j) {
                hw::mbar_wait(k_empty(s), par);
                hw::mbar_arrive_tx(k_full(s), S::K_STAGE);
                #pragma unroll
                for (int c = 0; c < D / WQ; ++c)
                    hw::tma_load_4d(sK + s * S::K_STAGE + c * BK * WQ * 2, &tmK,
                                    k_full(s), c * WQ, hk, j * BK, b);
                hw::mbar_wait(v_empty(s), par);
                hw::mbar_arrive_tx(v_full(s), S::V_STAGE);
                #pragma unroll
                for (int c = 0; c < DV / WV; ++c)
                    hw::tma_load_4d(sV + s * S::V_STAGE + c * BK * WV * 2, &tmV,
                                    v_full(s), c * WV, hk, j * BK, b);
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
        const int pos0 = q_offset + wrow + g, pos1 = pos0 + 8;
        const float c = scale * tc::LOG2E;      // exp(scale s) = exp2(c s)
        float o[DV / 2];
        #pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
        float s[BK / 2];
        uint32_t ph[BK / 16][4], pl[BK / 16][4];   // P's hi and lo parts
        #pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        #pragma unroll
        for (int i = 0; i < BK / 16; ++i)
            #pragma unroll
            for (int e = 0; e < 4; ++e) ph[i][e] = pl[i][e] = 0u;
        float m0 = NEG_INF, m1 = NEG_INF;         // running max of raw scores
        float l0 = 0.f, l1 = 0.f;                 // this lane's row sums

        if (wg == 1) hw::bar_arrive(BAR_TURN, 256);   // warpgroup 0 first
        hw::mbar_wait(q_full, 0);
        // slot j: O += P(j-1) V(j-1) and S(j) = Q K(j)^T, then softmax(j)
        int st = 0, ps = STAGES - 1;            // stages of tiles j, j - 1
        uint32_t par = 0, ppar = 1;             // and their full parities
        for (int j = 0; j <= n_tiles; ++j) {
            const bool has_s = j < n_tiles, has_pv = j > 0;
            if (has_pv) hw::mbar_wait(v_full(ps), ppar);
            if (has_s) hw::mbar_wait(k_full(st), par);
            hw::bar_sync(BAR_TURN + wg, 256);
            hw::wg_fence();
            if (has_pv) {
                const uint32_t vt = sV + ps * S::V_STAGE;
                #pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    hw::Wgmma<DV>::template rs<1>(
                        o, ph[kk], hw::desc_mn<WV>(vt, BK, kk), 1);
                #pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    hw::Wgmma<DV>::template rs<1>(
                        o, pl[kk], hw::desc_mn<WV>(vt, BK, kk), 1);
            }
            if (has_s) {
                const uint32_t kt = sK + st * S::K_STAGE;
                hw::Wgmma<BK>::template ss0<0, 0>(
                    s, hw::desc_k<WQ>(sQ, BQ, 64 * wg, 0),
                    hw::desc_k<WQ>(kt, BK, 0, 0));
                #pragma unroll
                for (int kk = 1; kk < D / 16; ++kk)
                    hw::Wgmma<BK>::template ss<0, 0>(
                        s, hw::desc_k<WQ>(sQ, BQ, 64 * wg, kk),
                        hw::desc_k<WQ>(kt, BK, 0, kk), 1);
            }
            hw::wg_commit();
            // the other warpgroup's turn (warpgroup 1's last arrival would
            // have no partner)
            if (!(wg == 1 && j == n_tiles))
                hw::bar_arrive(BAR_TURN + 1 - wg, 256);
            hw::wg_wait<0>();
            hw::fence_regs(o);
            hw::fence_regs(s);
            hw::fence_regs(ph);
            hw::fence_regs(pl);
            hw::mbar_arrive_if(v_empty(ps), has_pv && lane == 0);
            hw::mbar_arrive_if(k_empty(st), has_s && lane == 0);
            if (!has_s) break;
            ps = st;
            ppar = par;
            if (++st == STAGES) {
                st = 0;
                par ^= 1;
            }

            // softmax of tile j; masks only where the tile crosses the
            // diagonal or Skv
            const int k0 = j * BK;
            if (k0 + BK > Skv || (causal && k0 + BK - 1 > q_offset + wrow)) {
                #pragma unroll
                for (int n = 0; n < BK / 8; ++n)
                    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kp = k0 + n * 8 + 2 * t + (e & 1);
                        const int qp = e < 2 ? pos0 : pos1;
                        if (kp >= Skv || (causal && kp > qp)) s[4 * n + e] = NEG_INF;
                    }
            }
            float mx0 = m0, mx1 = m1;
            #pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
                mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
            }
            mx0 = tc::quad_max(mx0);
            mx1 = tc::quad_max(mx1);
            const float a0 = hw::ex2((m0 - mx0) * c), a1 = hw::ex2((m1 - mx1) * c);
            m0 = mx0;
            m1 = mx1;
            const float mc0 = mx0 * c, mc1 = mx1 * c;
            float rs0 = 0.f, rs1 = 0.f;
            #pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const float p0 = hw::ex2(fmaf(s[4 * n], c, -mc0));
                const float p1 = hw::ex2(fmaf(s[4 * n + 1], c, -mc0));
                const float p2 = hw::ex2(fmaf(s[4 * n + 2], c, -mc1));
                const float p3 = hw::ex2(fmaf(s[4 * n + 3], c, -mc1));
                rs0 += p0 + p1;
                rs1 += p2 + p3;
                tc::split_bf16(p0, p1, ph[n / 2][(n & 1) * 2],
                               pl[n / 2][(n & 1) * 2]);
                tc::split_bf16(p2, p3, ph[n / 2][(n & 1) * 2 + 1],
                               pl[n / 2][(n & 1) * 2 + 1]);
            }
            l0 = l0 * a0 + rs0;
            l1 = l1 * a1 + rs1;
            #pragma unroll
            for (int n = 0; n < DV / 8; ++n) {
                o[4 * n] *= a0;
                o[4 * n + 1] *= a0;
                o[4 * n + 2] *= a1;
                o[4 * n + 3] *= a1;
            }
        }

        // epilogue: O / l as bf16 into the q tile's shared memory (both
        // consumers are past their last read of q), one TMA box per
        // warpgroup, clipped at Sq
        l0 = fmaxf(tc::quad_sum(l0), 1e-30f);
        l1 = fmaxf(tc::quad_sum(l1), 1e-30f);
        const float i0 = 1.f / l0, i1 = 1.f / l1;
        hw::bar_sync(BAR_EPI, 256);
        unsigned char* so = sbase + S::Q_OFF + wg * 64 * DV * 2;
        const int ra = 16 * warp + g;
        #pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
            *reinterpret_cast<uint32_t*>(so + (ra * DV + n * 8 + 2 * t) * 2) =
                tc::pack_bf16(o[4 * n] * i0, o[4 * n + 1] * i0);
            *reinterpret_cast<uint32_t*>(so + ((ra + 8) * DV + n * 8 + 2 * t) * 2) =
                tc::pack_bf16(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
        }
        hw::fence_async_smem();
        hw::bar_sync(BAR_EPI_WG + wg, 128);
        if (t128 == 0) {
            hw::tma_store_4d(&tmO, sQ + wg * 64 * DV * 2, 0, h, r0, b);
            hw::tma_store_commit_and_wait();
        }
        if (t == 0) {
            const int s0 = wrow + g, s1 = s0 + 8;
            float* lrow = lse + ((long long)b * H + h) * Sq;
            if (s0 < Sq) lrow[s0] = m0 * scale + logf(l0);
            if (s1 < Sq) lrow[s1] = m1 * scale + logf(l1);
        }
    }
}

constexpr long long MAX_BLOCKS = 0x7fffffffLL;

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Skv, int H, int Hkv, int q_offset,
           int causal, float scale, cudaStream_t stream) {
    using S = FwdSmem<D, DV>;
    constexpr int WQ = wgmma_plan::swizzle_cols(D);
    constexpr int WV = wgmma_plan::swizzle_cols(DV);
    const long long blocks = (long long)H * B * ((Sq + BQ - 1) / BQ);
    if (blocks > MAX_BLOCKS) return -1;
    CUtensorMap tq, tk, tv, to;
    if (!wgmma_host::encode(&tq, q, D, H, Sq, B, WQ, BQ, WQ) ||
        !wgmma_host::encode(&tk, k, D, Hkv, Skv, B, WQ, S::BK, WQ) ||
        !wgmma_host::encode(&tv, v, DV, Hkv, Skv, B, WV, S::BK, WV) ||
        !wgmma_host::encode(&to, out, DV, H, Sq, B, DV, 64, 0))
        return -2;
    auto kern = flash_fwd_kernel_wgmma<D, DV>;
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
        tq, tk, tv, to, static_cast<float*>(lse), B, Sq, Skv, H, Hkv,
        q_offset, causal, scale, chunk);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point of the bf16 forward of this design: contiguous,
// 16-byte aligned q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv),
// out (B, Sq, H, Dv) bf16 and lse (B, H, Sq) fp32 on the device.  Returns
// the launch's cudaGetLastError() (0 on success), -1 on arguments it does
// not take (a pair with no instance, more than 2^31 - 1 blocks), -2 where
// cuTensorMapEncodeTiled refused a tensor map.
extern "C" int flash_fwd_wgmma_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int H, int Hkv,
                                      int D, int Dv, int q_offset, int causal,
                                      float scale, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 ||
        q_offset < 0)
        return -1;
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(out);
    if (any % 16) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_WGMMA_CASE(d, dv)                                               \
    if (D == d && Dv == dv)                                                 \
        return launch<d, dv>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,         \
                             q_offset, causal, scale, st);
    FWD_WGMMA_CASE(16, 16)
    FWD_WGMMA_CASE(32, 32)
    FWD_WGMMA_CASE(64, 64)
    FWD_WGMMA_CASE(128, 128)
    FWD_WGMMA_CASE(128, 64)
    FWD_WGMMA_CASE(192, 128)
    FWD_WGMMA_CASE(96, 64)
    FWD_WGMMA_CASE(80, 80)
    FWD_WGMMA_CASE(256, 256)
#undef FWD_WGMMA_CASE
    return -1;
}

// The plan of an instance of this file's or flash_attention_bwd_wgmma.cu's
// kernels (0 forward, 1 dk / dv, 2 dq) at (D, Dv), for chip_smoke.py to
// hold flash_attention.py's wgmma_plan to: out[0..4] = rows per block, rows
// per step of the inner loop, ring stages, sweeps, dynamic shared memory
// bytes.
extern "C" int flash_wgmma_plan(int kernel, int D, int Dv, int* out) {
    if (D < 16 || Dv < 16 || D > 256 || Dv > 256 || D % 16 || Dv % 16)
        return -1;
    if (kernel == 0) {
        out[0] = BQ;
        out[1] = wgmma_plan::fwd_bk(D, Dv);
        out[2] = wgmma_plan::fwd_stages(D, Dv);
        out[3] = 1;
        out[4] = wgmma_plan::fwd_smem(D, Dv);
        return 0;
    }
    if (kernel == 1) {
        out[0] = wgmma_plan::DKV_BKV;
        out[1] = wgmma_plan::dkv_bq(D, Dv);
        out[2] = wgmma_plan::dkv_stages(D, Dv);
        out[3] = wgmma_plan::dkv_sweeps(D, Dv);
        out[4] = wgmma_plan::dkv_smem(D, Dv);
        return 0;
    }
    if (kernel == 2) {
        out[0] = wgmma_plan::DQ_BQ;
        out[1] = wgmma_plan::dq_bk(D, Dv);
        out[2] = wgmma_plan::dq_stages(D, Dv);
        out[3] = 1;
        out[4] = wgmma_plan::dq_smem(D, Dv);
        return 0;
    }
    return -1;
}
