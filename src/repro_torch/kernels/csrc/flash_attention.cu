// flash_fwd_kernel: FlashAttention-2 forward with GQA, causal masking from
// a q offset, and out + log-sum-exp outputs.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (driven by flash_fwd).  On the TPU the grid is (B, H, nq, nk) with the KV
// axis innermost and sequential, the running max / sum / accumulator
// carried in VMEM scratch from one grid step to the next.  Blocks on the
// H100 run in no order, so here one block owns a (batch, head, 64-row q
// tile) and loops over the 64-row KV tiles itself, with the online-softmax
// state in registers.
//
// What it computes, for q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv,
// Hkv, Dv), all contiguous:  s = (q * D^-0.5) . k^T in fp32, masked where
// k_pos >= Skv or (causal) k_pos > q_offset + q_row, softmax over the
// row, out = p . v cast to q's type, lse = m + log(l) in fp32 with l
// floored at 1e-30 and masked scores set to -1e30 — the TPU kernel's
// constants.  GQA is by index (kv head = h / (H / Hkv)); KV is never
// duplicated.  Ragged Sq / Skv edges are masked in the kernel (rows past
// Sq load zeros and are not stored; KV rows past Skv load zeros and are
// masked), so the wrapper makes no padded copies.  Causal blocks stop
// after the last KV tile that touches their diagonal, skipping the tiles
// above it as the TPU kernel's pl.when does.
//
// What bounds it on an H100: operations, 2*B*H*Sq*Skv*(D + Dv) (halved
// when causal) against (q + k + v + out) bytes plus the fp32 lse.  Two
// kernels:
//
// * flash_fwd_kernel_mma, bf16 inputs, on the tensor cores (FlashAttention-2
//   on Hopper's mma.sync).  One block of 8 warps per (batch, head, 128-row
//   q tile), 16 q rows per warp; grid (H, B, q tiles) with the q tiles in
//   reverse, so that under a causal mask the heaviest tiles (the last
//   rows, which see the most keys) start first.  q's fragments are loaded
//   once with ldmatrix and stay in registers.  64-row K and V tiles come
//   through cp.async 16-byte copies, double-buffered (tile j + 1 in flight
//   while tile j computes), rows past Skv zero-filled by the copy's
//   src-size; shared-memory rows are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads fall in 8 different 4-bank groups (no bank conflicts).
//   S = q k^T by m16n8k16 bf16 mma with fp32 accumulation; the scale
//   D^-0.5 is applied to the fp32 scores (folded with log2 e into exp2f),
//   never to a bf16 copy of q.  The online softmax runs on the accumulator
//   fragments (row max by quad shuffles; the row sum stays a per-lane
//   partial until the end).  P is split in registers into two bf16 parts,
//   hi = bf16(P) and lo = bf16(P - hi), the A operands of two products
//   O += hi v + lo v with the same v fragments (v by ldmatrix.trans): no
//   shared-memory round trip, and P carries ~16 bits into the sum where
//   one bf16 rounding would carry 8.  (One rounding of P is what
//   FlashAttention-2 does; here it moved the reduced llava15-7b's bf16
//   gradients 3 % of a leaf's scale from the plain path, past the 2e-2
//   that chip_smoke.py holds them to: PERF.md, PR 15.)  A warp skips the
//   KV tiles wholly above its own rows' diagonal,
//   and masks only the tiles that cross the diagonal or the Skv edge.
//   Per block at D = Dv = 128: 256 threads of 218 registers, no spills
//   (ptxas -v for sm_90a, nvcc 12.9; chip_smoke.py prints it), and
//   104,448 bytes of shared memory (q, two K and two V tiles): one block
//   per SM.
// * flash_fwd_kernel, fp32 inputs, fp32 FMA on the CUDA cores (fp32 must
//   not use TF32 to meet the 2e-5 tolerance).  The block's 256 threads
//   form a 16 x 16 grid: thread (ty, tx) owns the scores of rows ty + 16i
//   and columns tx + 16j (i, j < 4) and the output columns tx + 16c.  q
//   (pre-scaled), k, v and the probability tile sit in shared memory as
//   fp32 with padded row strides, so the inner loops read it without bank
//   conflicts: 4 q values are broadcast and 4 k values fan out per 16
//   FMAs.  Row max and row sum reduce over the 16 lanes of a half-warp
//   with shuffles.  (It also takes bf16, converting every tile; the entry
//   point sends bf16 to the tensor-core kernel.)
//
// Head dims are template parameters: 16 for the reduced test configs, 32,
// 64, 128, 128 -> 64, and the MLA pairs 192 -> 128 (deepseek-v2-lite-16b:
// qk_nope 128 + qk_rope 64, v 128) and 96 -> 64 (minicpm3-4b: 64 + 32, v
// 64), 80 (zamba2-2.7b's shared attention) and 256, the widest head the
// kernels take.  Any other pair 1 <= D, Dv <= 256 runs on the instance
// that dominates it with the fewest columns (flash_attention.py's
// instance_for): the wrapper zero-pads q, k and v to it, which is exact
// (zero columns add nothing to q k^T and give zero columns of out, which
// the wrapper drops) and passes the true D^-0.5 as the scale.  80 and 96
// are not multiples of 32: every loop over a head dim strides by 16 B
// cp.async chunks (D / 8 of them), 16-column ldmatrix pairs (D / 16) or
// the FMA kernels' 16 columns a thread (D / 16), so a multiple of 16 is
// all a pair needs; the padded row strides (D + 8 bf16: 176, 208 and 400
// bytes) keep ldmatrix's 8 rows in 8 different 16-byte bank groups.  At D
// = 192 the tensor-core kernel computes each 64-row kv tile in two 32-row
// halves (kv_halves): q's fragments take 48 registers a thread there, and
// a whole tile's scores and P parts another 64.  At D = 256 the output's
// accumulators alone take 128 registers a thread, so q's fragments are
// read from shared memory per use (q_in_registers) and the kv tile is
// computed in four 16-row quarters; its shared memory is 202,752 bytes.
//
// The grid is one-dimensional: block i is (head, batch, q tile) in the
// order a (H, B, q tiles) grid would launch them, unfolded from i, so B,
// H and the q tiles are bounded only by their product (< 2^31).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // kv rows per tile of the inner loop
constexpr int THREADS = 256;    // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);          // round to nearest even
}

template <int D, int DV>
struct Smem {
    static constexpr int QS = D + 1;     // padded row strides
    static constexpr int KS = D + 1;
    static constexpr int PS = BK + 1;
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + BQ * QS;
    static constexpr int V_OFF = K_OFF + BK * KS;
    static constexpr int P_OFF = V_OFF + BK * DV;
    static constexpr size_t BYTES = (size_t)(P_OFF + BQ * PS) * sizeof(float);
};

__device__ __forceinline__ float half_warp_max(float v) {
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int q_offset, int causal, float scale) {
    using S = Smem<D, DV>;
    constexpr int NC = DV / 16;          // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem + S::Q_OFF;
    float* Ks = smem + S::K_OFF;
    float* Vs = smem + S::V_OFF;
    float* Ps = smem + S::P_OFF;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    // block (q tile, head, batch), q tiles fastest
    const int n_qt = (Sq + BQ - 1) / BQ;
    const int q0 = (int)(blockIdx.x % n_qt) * BQ;
    const int h = (int)(blockIdx.x / n_qt % H), b = (int)(blockIdx.x / n_qt / H);
    const int hk = h / (H / Hkv);

    const long long q_row = (long long)H * D;      // element strides of a
    const long long k_row = (long long)Hkv * D;    // sequence position
    const long long v_row = (long long)Hkv * DV;
    const T* qb = q + (long long)b * Sq * q_row + (long long)h * D;
    const T* kb = k + (long long)b * Skv * k_row + (long long)hk * D;
    const T* vb = v + (long long)b * Skv * v_row + (long long)hk * DV;

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, d = i - r * D, s = q0 + r;
        Qs[r * S::QS + d] = s < Sq ? to_f32(qb[s * q_row + d]) * scale : 0.f;
    }

    float m[4], l[4], acc[4][NC];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
        #pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    // KV tiles past the last row's diagonal are fully masked: skip them.
    const int kv_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();                 // previous tile fully consumed
        for (int i = tid; i < BK * D; i += THREADS) {
            const int r = i / D, d = i - r * D, s = k0 + r;
            Ks[r * S::KS + d] = s < Skv ? to_f32(kb[s * k_row + d]) : 0.f;
        }
        for (int i = tid; i < BK * DV; i += THREADS) {
            const int r = i / DV, d = i - r * DV, s = k0 + r;
            Vs[r * DV + d] = s < Skv ? to_f32(vb[s * v_row + d]) : 0.f;
        }
        __syncthreads();

        float sc[4][4];
        #pragma unroll
        for (int i = 0; i < 4; ++i)
            #pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        #pragma unroll 16
        for (int d = 0; d < D; ++d) {
            float a[4], bk[4];
            #pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * S::QS + d];
            #pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * S::KS + d];
            #pragma unroll
            for (int i = 0; i < 4; ++i)
                #pragma unroll
                for (int j = 0; j < 4; ++j)
                    sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
        }

        #pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q_pos = q_offset + q0 + ty + 16 * i;
            float mx = NEG_INF;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k_pos = k0 + tx + 16 * j;
                if (k_pos >= Skv || (causal && k_pos > q_pos))
                    sc[i][j] = NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float alpha = expf(m[i] - m_new);
            float rs = 0.f;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                sc[i][j] = expf(sc[i][j] - m_new);
                rs += sc[i][j];
            }
            l[i] = l[i] * alpha + half_warp_sum(rs);
            m[i] = m_new;
            #pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
            #pragma unroll
            for (int j = 0; j < 4; ++j)
                Ps[(ty + 16 * i) * S::PS + tx + 16 * j] = sc[i][j];
        }
        __syncthreads();

        #pragma unroll 8
        for (int j = 0; j < BK; ++j) {
            float p[4];
            #pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * S::PS + j];
            #pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float vv = Vs[j * DV + tx + 16 * c];
                #pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc[i][c] = fmaf(p[i], vv, acc[i][c]);
            }
        }
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= Sq) continue;
        const float li = fmaxf(l[i], 1e-30f);
        T* o = out + (((long long)b * Sq + s) * H + h) * DV;
        #pragma unroll
        for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f32<T>(acc[i][c] / li);
        if (tx == 0) lse[((long long)b * H + h) * Sq + s] = m[i] + logf(li);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 128;         // q rows per block, 16 per warp
constexpr int MMA_BK = 64;          // kv rows per tile
constexpr int MMA_THREADS = 256;    // 8 warps

// sub-tiles a kv tile is computed in: 2 at D > 128, where q's fragments
// (D / 4 registers a thread) leave too few registers for a whole tile's
// scores and P fragments; 4 at D > 192, where the output's accumulators
// take DV / 2; 1 (the whole tile) below
__host__ __device__ constexpr int kv_halves(int D) {
    return D > 192 ? 4 : D > 128 ? 2 : 1;
}

// q's fragments stay in registers (D / 4 a thread) up to D = 192; above,
// each is read from the resident q tile in shared memory where it is used
__host__ __device__ constexpr bool q_in_registers(int D) { return D <= 192; }

template <int D, int DV>
struct MmaSmem {                    // bf16 elements; rows padded by 8
    static constexpr int QS = D + 8;
    static constexpr int KS = D + 8;
    static constexpr int VS = DV + 8;
    static constexpr int Q_OFF = 0;
    static constexpr int K_OFF = Q_OFF + MMA_BQ * QS;          // 2 buffers
    static constexpr int V_OFF = K_OFF + 2 * MMA_BK * KS;      // 2 buffers
    static constexpr size_t BYTES =
        (size_t)(V_OFF + 2 * MMA_BK * VS) * sizeof(__nv_bfloat16);
};

template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int B, int Sq, int Skv, int H,
                     int Hkv, int q_offset, int causal, float scale) {
    using S = MmaSmem<D, DV>;
    constexpr bool QREG = q_in_registers(D);
    // at D > 128 the kv tile is computed in two 32-row halves, so that
    // the scores and P's fragments (16 + 16 registers, not 32 + 32) fit
    // beside the longer q fragments (qf: D / 4 registers)
    constexpr int KH = kv_halves(D);
    constexpr int SUB = MMA_BK / KH;     // kv rows per sub-tile
    constexpr int NT = SUB / 8;          // score n-tiles per sub-tile
    constexpr int NO = DV / 8;           // output n-tiles
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const uint32_t sQ = tc::smem_addr(smem + S::Q_OFF);
    const uint32_t sK = tc::smem_addr(smem + S::K_OFF);
    const uint32_t sV = tc::smem_addr(smem + S::V_OFF);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // block (head, batch, q tile), heads fastest; the q tiles in reverse,
    // heaviest first
    const int h = (int)(blockIdx.x % H), b = (int)(blockIdx.x / H % B);
    const int n_qt = (Sq + MMA_BQ - 1) / MMA_BQ;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / H / B)) * MMA_BQ;
    const int hk = h / (H / Hkv);
    const long long q_row = (long long)H * D;      // element strides of a
    const long long k_row = (long long)Hkv * D;    // sequence position
    const long long v_row = (long long)Hkv * DV;
    const __nv_bfloat16* qb = q + (long long)b * Sq * q_row + (long long)h * D;
    const __nv_bfloat16* kb = k + (long long)b * Skv * k_row + (long long)hk * D;
    const __nv_bfloat16* vb = v + (long long)b * Skv * v_row +
                              (long long)hk * DV;

    // q tile, then K / V tile 0: one group of copies
    for (int i = tid; i < MMA_BQ * (D / 8); i += MMA_THREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = q0 + r;
        const bool in = s < Sq;
        tc::cp_async16(sQ + (r * S::QS + c) * 2,
                       qb + (in ? s : 0) * q_row + c, in);
    }
    auto load_kv = [&](int k0, int buf) {
        const uint32_t dk = sK + buf * MMA_BK * S::KS * 2;
        const uint32_t dv = sV + buf * MMA_BK * S::VS * 2;
        for (int i = tid; i < MMA_BK * (D / 8); i += MMA_THREADS) {
            const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = k0 + r;
            const bool in = s < Skv;
            tc::cp_async16(dk + (r * S::KS + c) * 2,
                           kb + (in ? s : 0) * k_row + c, in);
        }
        for (int i = tid; i < MMA_BK * (DV / 8); i += MMA_THREADS) {
            const int r = i / (DV / 8), c = (i % (DV / 8)) * 8, s = k0 + r;
            const bool in = s < Skv;
            tc::cp_async16(dv + (r * S::VS + c) * 2,
                           vb + (in ? s : 0) * v_row + c, in);
        }
    };
    // KV tiles past the block's last row's diagonal are fully masked
    const int kv_end = causal ? min(Skv, q_offset + q0 + MMA_BQ) : Skv;
    const int n_tiles = (kv_end + MMA_BK - 1) / MMA_BK;
    load_kv(0, 0);
    tc::cp_async_commit();

    // this warp's rows: q0 + 16 warp + g and + 8, at absolute positions
    const int wrow = q0 + 16 * warp;
    const int pos0 = q_offset + wrow + g, pos1 = pos0 + 8;
    const float c = scale * tc::LOG2E;   // exp(scale s) = exp2(c s)
    uint32_t qf[QREG ? D / 16 : 1][4];
    const uint32_t qA = sQ + ((16 * warp + tc::a_row(lane)) * S::QS +
                              tc::a_col(lane)) * 2;
    float o[NO][4];
    #pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF;    // running max of raw scores
    float l0 = 0.f, l1 = 0.f;            // this lane's part of the row sums

    for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
            load_kv((j + 1) * MMA_BK, (j + 1) & 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        if (QREG && j == 0) {
            #pragma unroll
            for (int dc = 0; dc < (QREG ? D / 16 : 1); ++dc)
                tc::ldsm_x4(qf[dc], sQ + ((16 * warp + tc::a_row(lane)) *
                                          S::QS + dc * 16 + tc::a_col(lane)) * 2);
        }
        #pragma unroll 1
        for (int kh = 0; kh < KH; ++kh) {
        const int k0 = j * MMA_BK + kh * SUB;
        // sub-tiles wholly above this warp's diagonal add nothing
        if (!causal || k0 <= q_offset + wrow + 15) {
            const uint32_t kt = sK + ((j & 1) * MMA_BK + kh * SUB) * S::KS * 2;
            const uint32_t vt = sV + ((j & 1) * MMA_BK + kh * SUB) * S::VS * 2;
            float s[NT][4];
            #pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            if constexpr (QREG) {
                #pragma unroll
                for (int dc = 0; dc < D / 16; ++dc) {
                    #pragma unroll
                    for (int np = 0; np < NT / 2; ++np) {
                        uint32_t kr[4];
                        tc::ldsm_x4(kr, kt + ((np * 16 + tc::bn_row(lane)) * S::KS +
                                              dc * 16 + tc::bn_col(lane)) * 2);
                        tc::mma_bf16(s[2 * np], qf[dc], kr[0], kr[1]);
                        tc::mma_bf16(s[2 * np + 1], qf[dc], kr[2], kr[3]);
                    }
                }
            } else {
                #pragma unroll
                for (int dc = 0; dc < D / 16; ++dc) {
                    uint32_t qa[4];
                    tc::ldsm_x4(qa, qA + dc * 32);
                    #pragma unroll
                    for (int np = 0; np < NT / 2; ++np) {
                        uint32_t kr[4];
                        tc::ldsm_x4(kr, kt + ((np * 16 + tc::bn_row(lane)) * S::KS +
                                              dc * 16 + tc::bn_col(lane)) * 2);
                        tc::mma_bf16(s[2 * np], qa, kr[0], kr[1]);
                        tc::mma_bf16(s[2 * np + 1], qa, kr[2], kr[3]);
                    }
                }
            }
            // masks only where the sub-tile crosses the diagonal or Skv
            if (k0 + SUB > Skv ||
                (causal && k0 + SUB - 1 > q_offset + wrow)) {
                #pragma unroll
                for (int n = 0; n < NT; ++n)
                    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kp = k0 + n * 8 + 2 * t + (e & 1);
                        const int qp = e < 2 ? pos0 : pos1;
                        if (kp >= Skv || (causal && kp > qp)) s[n][e] = NEG_INF;
                    }
            }
            float mx0 = m0, mx1 = m1;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
                mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
                mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
            }
            mx0 = tc::quad_max(mx0);
            mx1 = tc::quad_max(mx1);
            const float a0 = exp2f((m0 - mx0) * c), a1 = exp2f((m1 - mx1) * c);
            m0 = mx0;
            m1 = mx1;
            const float mc0 = mx0 * c, mc1 = mx1 * c;
            // P in fp32 for the row sums; as the A operand of P v, split
            // into two bf16 parts, hi = bf16(P) and lo = bf16(P - hi)
            uint32_t pa[NT / 2][4], pl[NT / 2][4];
            float rs0 = 0.f, rs1 = 0.f;
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float p0 = exp2f(fmaf(s[n][0], c, -mc0));
                const float p1 = exp2f(fmaf(s[n][1], c, -mc0));
                const float p2 = exp2f(fmaf(s[n][2], c, -mc1));
                const float p3 = exp2f(fmaf(s[n][3], c, -mc1));
                rs0 += p0 + p1;
                rs1 += p2 + p3;
                tc::split_bf16(p0, p1, pa[n / 2][(n & 1) * 2],
                               pl[n / 2][(n & 1) * 2]);
                tc::split_bf16(p2, p3, pa[n / 2][(n & 1) * 2 + 1],
                               pl[n / 2][(n & 1) * 2 + 1]);
            }
            l0 = l0 * a0 + rs0;
            l1 = l1 * a1 + rs1;
            #pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= a0;
                o[n][1] *= a0;
                o[n][2] *= a1;
                o[n][3] *= a1;
            }
            #pragma unroll
            for (int kc = 0; kc < SUB / 16; ++kc) {
                #pragma unroll
                for (int np = 0; np < NO / 2; ++np) {
                    uint32_t vr[4];
                    tc::ldsm_x4_trans(vr, vt + ((kc * 16 + tc::a_row(lane)) *
                                                S::VS + np * 16 +
                                                tc::a_col(lane)) * 2);
                    tc::mma_bf16(o[2 * np], pa[kc], vr[0], vr[1]);
                    tc::mma_bf16(o[2 * np + 1], pa[kc], vr[2], vr[3]);
                    tc::mma_bf16(o[2 * np], pl[kc], vr[0], vr[1]);
                    tc::mma_bf16(o[2 * np + 1], pl[kc], vr[2], vr[3]);
                }
            }
        }
        }
        __syncthreads();                 // tile j's buffers free again
    }

    l0 = fmaxf(tc::quad_sum(l0), 1e-30f);
    l1 = fmaxf(tc::quad_sum(l1), 1e-30f);
    #pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int s = wrow + g + 8 * half;
        if (s >= Sq) continue;
        const float li = half ? l1 : l0;
        __nv_bfloat16* orow = out + (((long long)b * Sq + s) * H + h) * DV;
        #pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
                tc::pack_bf16(o[n][2 * half] / li, o[n][2 * half + 1] / li);
        if (t == 0)
            lse[((long long)b * H + h) * Sq + s] =
                (half ? m1 : m0) * scale + logf(li);
    }
}

// a one-dimensional grid's limit
constexpr long long MAX_BLOCKS = 0x7fffffffLL;

// above 48 KB of dynamic shared memory a kernel needs an opt-in, once
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool& configured) {
    if (configured) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) configured = true;
    return e;
}

template <int D, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Skv, int H, int Hkv,
               int q_offset, int causal, float scale, cudaStream_t stream) {
    auto kern = flash_fwd_kernel_mma<D, DV>;
    constexpr size_t bytes = MmaSmem<D, DV>::BYTES;
    const long long blocks =
        (long long)H * B * ((Sq + MMA_BQ - 1) / MMA_BQ);
    if (blocks > MAX_BLOCKS) return -1;
    static bool configured = false;
    const cudaError_t e = allow_smem(kern, bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)blocks, MMA_THREADS, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), B, Sq,
        Skv, H, Hkv, q_offset, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int B, int Sq, int Skv, int H, int Hkv, int q_offset,
           int causal, float scale, cudaStream_t stream) {
    auto kern = flash_fwd_kernel<T, D, DV>;
    constexpr size_t bytes = Smem<D, DV>::BYTES;
    const long long blocks = (long long)((Sq + BQ - 1) / BQ) * H * B;
    if (blocks > MAX_BLOCKS) return -1;
    static bool configured = false;
    const cudaError_t e = allow_smem(kern, bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)blocks, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), Sq, Skv, H, Hkv, q_offset, causal, scale);
    return (int)cudaGetLastError();
}

// fp32 -> the FMA kernel, bf16 -> the tensor-core kernel
template <bool MMA>
int dispatch(int D, int Dv, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int Sq, int Skv, int H, int Hkv,
             int q_offset, int causal, float scale, cudaStream_t st) {
#define FLASH_CASE(d, dv)                                                   \
    if (D == d && Dv == dv)                                                 \
        return MMA ? launch_mma<d, dv>(q, k, v, out, lse, B, Sq, Skv, H,    \
                                       Hkv, q_offset, causal, scale, st)    \
                   : launch<float, d, dv>(q, k, v, out, lse, B, Sq, Skv, H, \
                                          Hkv, q_offset, causal, scale, st);
    FLASH_CASE(16, 16)
    FLASH_CASE(32, 32)
    FLASH_CASE(64, 64)
    FLASH_CASE(128, 128)
    FLASH_CASE(128, 64)
    FLASH_CASE(192, 128)
    FLASH_CASE(96, 64)
    FLASH_CASE(80, 80)
    FLASH_CASE(256, 256)
#undef FLASH_CASE
    return -1;
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16.  Device pointers
// to contiguous q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv),
// out (B, Sq, H, Dv) in the inputs' type and lse (B, H, Sq) fp32; for
// bf16, q, k, v and out 16-byte aligned (the tensor-core kernel's
// cp.async copies).  Returns the launch's cudaGetLastError() (0 on
// success), or -1 on arguments the kernels do not take: a pair that is no
// instance, or more than 2^31 - 1 blocks (the Python wrapper pads to an
// instance, checks first and raises).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int dtype, int B,
                                int Sq, int Skv, int H, int Hkv, int D,
                                int Dv, int q_offset, int causal, float scale,
                                void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 ||
        q_offset < 0)
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch<false>(D, Dv, q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                               q_offset, causal, scale, st);
    if (dtype == 1) {
        const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                              reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) |
                              reinterpret_cast<uintptr_t>(out);
        if (any % 16) return -1;
        return dispatch<true>(D, Dv, q, k, v, out, lse, B, Sq, Skv, H, Hkv,
                              q_offset, causal, scale, st);
    }
    return -1;
}
