// flash_bwd_dq_kernel(_mma) / flash_bwd_dkv_kernel: FlashAttention-2
// backward with GQA, causal masking from a q offset, for the out + lse
// that the forward (flash_attention.cu) saved.
//
// Replace the TPU kernels repro/kernels/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (driven by flash_bwd).  On the TPU both are grids whose
// innermost axis runs in order, carrying the dq (resp. dk / dv) sum in VMEM
// scratch from one grid step to the next.  Blocks on the H100 run in no
// order, so each sum lives in one block's registers and the block walks
// the sequential axis itself:
//
// * dq:  one block per (batch, head, q tile); it loops over the
//   64-row KV tiles, recomputes p = exp(s - lse) under the forward's masks
//   and adds ds . k to dq, ds = p * (dO . v^T - delta).  dq is multiplied
//   by D^-0.5 once at the end, as the TPU kernel's finalize does.  The
//   block also computes delta = sum_d dO * out of its rows (the reference
//   computes it outside its kernels) and stores it for the dkv kernel,
//   which runs after it on the same stream.
// * dkv: one block per (batch, kv head, KV tile); it loops over the
//   G query heads of the group and every q tile inside the block, adding
//   p^T . dO to dv and ds^T . (q * D^-0.5) to dk (so dk carries the scale
//   through the pre-scaled q, as in the TPU kernel), and writes each tile
//   of dk and dv exactly once: no atomics, no second pass, bit-equal
//   results from one launch to the next.
//
// Masks: k_pos >= Skv, q_row >= Sq and (causal) k_pos > q_offset + q_row
// give p = 0.  Ragged edges are masked in the kernel (rows past Sq / Skv
// load zeros and are not stored), so the wrapper makes no padded copies.
// Causal tiles wholly above the diagonal are skipped with the TPU kernels'
// test on absolute positions: in the fp32 kernels a (64-row q tile, KV
// tile) pair is computed when k0 <= q_offset + q0 + 63; the tensor-core
// dq pass applies the same test per warp (the wgmma dk / dv pass of
// flash_attention_bwd_wgmma.cu per warpgroup).
//
// What bounds them on an H100: operations.  The dq pass does three
// products per score tile (s and dq at D, dp at Dv) and the dkv pass four
// (s and dk at D, dp and dv at Dv), 2.5x the forward's operations in all
// at D = Dv (FA2's count), against q + k + v + out + dout + dq + dk + dv
// bytes plus lse and delta.
//
// Head dims as in flash_attention.cu, (192, 128), (96, 64), (80, 80) and
// (256, 256) included; any other pair up to 256 runs zero-padded on the
// instance that dominates it (the wrapper pads q, k, v, out and dout and
// drops the gradients' extra columns, which are zero; lse and delta are
// unchanged by zero columns).  At D > 128 the tensor-core dq pass computes
// each 64-row kv tile in two 32-row halves (kv_halves): (192, 128) then
// takes 245 registers a thread, no spills (ptxas -v, nvcc 12.9).  At (256,
// 256) two 64-row K and V tiles beside q and dO would need 270,336 bytes
// of shared memory: there the dq pass takes 32-row kv tiles (dq_bkv),
// 202,752 bytes.  The fp32 kernels there hold one kv (dq pass) or one q /
// dO (dk / dv pass) tile at a time, loading each operand when its product
// runs (dkv_share / dq_share), within 232,448 bytes.
//
// Every grid is one-dimensional: block i is the (x, y, z) block of the
// three-dimensional grid described below, unfolded from i in the order
// such a grid launches, so B, H and the tile count are bounded only by
// their product (< 2^31).
//
// For bf16 inputs the dq pass runs on the tensor cores (m16n8k16 bf16
// mma.sync, fp32 accumulation), in blocks of 8 warps (256 threads), with
// bf16 tiles in shared memory whose rows are padded by 16 bytes, so the 8
// rows an ldmatrix reads fall in 8 different 4-bank groups:
//
// * flash_bwd_dq_kernel_mma: one block per (head, batch, 128-row q tile),
//   grid (H, B, q tiles) with the q tiles in reverse, so that under a
//   causal mask the last tiles, which meet the most KV tiles, start first.
//   The block's q and dO tiles stay resident; 64-row K and V tiles come
//   through cp.async, double-buffered (tile j + 1 in flight while tile j
//   computes), rows past Skv zero-filled.  Each warp owns 16 q rows and
//   their fp32 dQ accumulators (at head dim 128, 64 registers) and reads
//   its q and dO fragments from shared memory per use.  Per KV tile:
//     S = Q K^T;  dP = dO V^T;  P = exp(scale S - lse) in fp32;
//     dS = P (dP - delta) in fp32, packed from the C fragments straight
//     into A fragments with one rounding to bf16;  dQ += dS K (K by
//     ldmatrix.trans).
//   P never enters a product.  dS rounded once keeps the reduced
//   llava15-7b's bf16 gradients within the 2e-2 gate the card is held to,
//   as carrying it in two bf16 parts does (the CPU rounding model,
//   tests/test_torch_flash_backward.py; readings in PERF.md), at half the
//   products of dS K.  A warp skips the KV tiles wholly
//   above its rows' diagonal and masks only the tiles that cross the
//   diagonal or Skv.  On its first tile the block computes delta = sum_d
//   dO * out of its rows in fp32 and stores it for the dkv pass; dQ is
//   multiplied by D^-0.5 once at the store.  Per block at head dim 128:
//   139,264 bytes of shared memory (q, dO, two K and two V tiles), one
//   block per SM (ptxas -v's registers and spills: chip_smoke.py prints
//   them).
// * bf16 dk / dv runs flash_bwd_dkv_kernel_wgmma of
//   flash_attention_bwd_wgmma.cu (Hopper's wgmma, TMA and warp
//   specialisation) at every pair.
// Each dq and each dk / dv tile is written once by one block after a
// fixed loop order: no atomics, bit-equal from one launch to the next.
//
// For fp32 inputs (fp32 gradients must meet 5e-4 without TF32) both passes
// compute in fp32 FMA on the CUDA cores (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel).  The block's 256 threads form a 16 x 16 grid:
// thread (ty, tx) owns the scores of q rows ty + 16i and KV columns tx +
// 16j (i, j < 4), and 4 rows x (width / 16) columns of each accumulator.
// All tiles sit in shared memory as fp32 with rows padded by one float, so
// the inner loops read broadcasts or 16 consecutive banks.  Shared memory
// at head dim 128: dq 148,736 bytes (q, dO, k, v, ds), dkv 165,376 bytes
// (k, v, q, dO, p, ds), one block per SM, through cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "tensor_core.cuh"

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16

__device__ __forceinline__ float half_warp_sum(float v) {
    #pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// rows x width tile of a (.., S, heads, width) tensor into shared memory
// as fp32 (row stride width + 1), times mul; rows past S load zeros.
template <int WIDTH, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int s0,
                                          int S, float mul) {
    for (int i = threadIdx.x; i < ROWS * WIDTH; i += THREADS) {
        const int r = i / WIDTH, d = i - r * WIDTH, s = s0 + r;
        dst[r * (WIDTH + 1) + d] =
            s < S ? src[(long long)s * row_stride + d] * mul : 0.f;
    }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] over two padded tiles
template <int WIDTH>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
    #pragma unroll
    for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    #pragma unroll 16
    for (int d = 0; d < WIDTH; ++d) {
        float a[4], b[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (WIDTH + 1) + d];
        #pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (WIDTH + 1) + d];
        #pragma unroll
        for (int i = 0; i < 4; ++i)
            #pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

constexpr size_t MAX_SMEM = 232448;   // an H100 block's opt-in

// the fp32 passes' layouts; where every tile at once would not fit a
// block's shared memory (head dim 256), K and V (dq pass) or q and dO (dk /
// dv pass) take turns in one buffer of the wider row
template <int D, int DV>
__host__ __device__ constexpr bool dq_share() {
    return (size_t)(2 * BQ * (D + DV + 2) + BQ * (BK + 1)) * sizeof(float)
        > MAX_SMEM;
}

template <int D, int DV>
__host__ __device__ constexpr bool dkv_share() {
    return (size_t)(2 * BK * (D + DV + 2) + 2 * BQ * (BK + 1)) *
        sizeof(float) > MAX_SMEM;
}

template <int D, int DV>
struct DqSmem {
    static constexpr int Q_OFF = 0;
    static constexpr int DO_OFF = Q_OFF + BQ * (D + 1);
    static constexpr int K_OFF = DO_OFF + BQ * (DV + 1);
    static constexpr int V_OFF = dq_share<D, DV>() ? K_OFF
                                                   : K_OFF + BK * (D + 1);
    static constexpr int DS_OFF = dq_share<D, DV>()
        ? K_OFF + BK * ((D > DV ? D : DV) + 1) : V_OFF + BK * (DV + 1);
    static constexpr size_t BYTES =
        (size_t)(DS_OFF + BQ * (BK + 1)) * sizeof(float);
};

template <int D, int DV>
struct DkvSmem {
    static constexpr int K_OFF = 0;
    static constexpr int V_OFF = K_OFF + BK * (D + 1);
    static constexpr int Q_OFF = V_OFF + BK * (DV + 1);
    static constexpr int DO_OFF = dkv_share<D, DV>() ? Q_OFF
                                                     : Q_OFF + BQ * (D + 1);
    static constexpr int P_OFF = dkv_share<D, DV>()
        ? Q_OFF + BQ * ((D > DV ? D : DV) + 1) : DO_OFF + BQ * (DV + 1);
    static constexpr int DS_OFF = P_OFF + BQ * (BK + 1);
    static constexpr size_t BYTES =
        (size_t)(DS_OFF + BQ * (BK + 1)) * sizeof(float);
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int q_offset, int causal, float scale) {
    using S = DqSmem<D, DV>;
    constexpr bool SHARE = dq_share<D, DV>();
    constexpr int NC = D / 16;           // dq columns per thread
    constexpr int NV = DV / 16;
    extern __shared__ float smem[];
    float* Qs = smem + S::Q_OFF;
    float* dOs = smem + S::DO_OFF;
    float* Ks = smem + S::K_OFF;
    float* Vs = smem + S::V_OFF;
    float* dSs = smem + S::DS_OFF;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    // block (q tile, head, batch), q tiles fastest
    const int n_qt = (Sq + BQ - 1) / BQ;
    const int q0 = (int)(blockIdx.x % n_qt) * BQ;
    const int h = (int)(blockIdx.x / n_qt % H), b = (int)(blockIdx.x / n_qt / H);
    const int hk = h / (H / Hkv);
    const long long q_row = (long long)H * D;      // element strides of a
    const long long o_row = (long long)H * DV;     // sequence position
    const long long k_row = (long long)Hkv * D;
    const long long v_row = (long long)Hkv * DV;
    const long long qb = (long long)b * Sq * q_row + (long long)h * D;
    const long long ob = (long long)b * Sq * o_row + (long long)h * DV;
    const float* kb = k + (long long)b * Skv * k_row + (long long)hk * D;
    const float* vb = v + (long long)b * Skv * v_row + (long long)hk * DV;
    const long long stat = ((long long)b * H + h) * Sq;   // lse / delta row

    load_tile<D, BQ>(Qs, q + qb, q_row, q0, Sq, scale);
    load_tile<DV, BQ>(dOs, dout + ob, o_row, q0, Sq, 1.f);
    __syncthreads();

    // delta = sum_d dO * out of this thread's 4 rows (fp32), stored for
    // the dkv pass; lse of the same rows
    float lse_r[4], delta_r[4];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, s = q0 + r;
        float part = 0.f;
        if (s < Sq) {
            const float* o = out + ob + (long long)s * o_row;
            #pragma unroll
            for (int c = 0; c < NV; ++c)
                part = fmaf(dOs[r * (DV + 1) + tx + 16 * c],
                            o[tx + 16 * c], part);
        }
        delta_r[i] = half_warp_sum(part);
        lse_r[i] = s < Sq ? lse[stat + s] : 0.f;
        if (s < Sq && tx == 0) delta[stat + s] = delta_r[i];
    }

    float acc[4][NC];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

    // KV tiles past the last row's diagonal are fully masked: skip them.
    const int kv_end = causal ? min(Skv, q_offset + q0 + BQ) : Skv;
    for (int k0 = 0; k0 < kv_end; k0 += BK) {
        __syncthreads();                 // previous tile fully consumed
        float s[4][4], dp[4][4];
        if constexpr (SHARE) {           // V, then K in its place
            load_tile<DV, BK>(Vs, vb, v_row, k0, Skv, 1.f);
            __syncthreads();
            tile_dot<DV>(dp, dOs, Vs, ty, tx);
            __syncthreads();
            load_tile<D, BK>(Ks, kb, k_row, k0, Skv, 1.f);
            __syncthreads();
            tile_dot<D>(s, Qs, Ks, ty, tx);
        } else {
            load_tile<D, BK>(Ks, kb, k_row, k0, Skv, 1.f);
            load_tile<DV, BK>(Vs, vb, v_row, k0, Skv, 1.f);
            __syncthreads();
            tile_dot<D>(s, Qs, Ks, ty, tx);
            tile_dot<DV>(dp, dOs, Vs, ty, tx);
        }
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const int q_pos = q_offset + q0 + r;
            #pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j, k_pos = k0 + c;
                const bool keep = q0 + r < Sq && k_pos < Skv &&
                                  !(causal && k_pos > q_pos);
                const float p = keep ? expf(s[i][j] - lse_r[i]) : 0.f;
                dSs[r * (BK + 1) + c] = p * (dp[i][j] - delta_r[i]);
            }
        }
        __syncthreads();

        #pragma unroll 8
        for (int j = 0; j < BK; ++j) {
            float ds[4];
            #pragma unroll
            for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (BK + 1) + j];
            #pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float kk = Ks[j * (D + 1) + tx + 16 * c];
                #pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
            }
        }
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= Sq) continue;
        float* o = dq + qb + (long long)s * q_row;
        #pragma unroll
        for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[i][c] * scale;
    }
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                     int q_offset, int causal, float scale) {
    using S = DkvSmem<D, DV>;
    constexpr bool SHARE = dkv_share<D, DV>();
    constexpr int NC = D / 16;           // dk columns per thread
    constexpr int NV = DV / 16;          // dv columns per thread
    extern __shared__ float smem[];
    float* Ks = smem + S::K_OFF;
    float* Vs = smem + S::V_OFF;
    float* Qs = smem + S::Q_OFF;
    float* dOs = smem + S::DO_OFF;
    float* Ps = smem + S::P_OFF;
    float* dSs = smem + S::DS_OFF;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    // block (kv tile, kv head, batch), kv tiles fastest
    const int n_kt = (Skv + BK - 1) / BK;
    const int k0 = (int)(blockIdx.x % n_kt) * BK;
    const int hk = (int)(blockIdx.x / n_kt % Hkv);
    const int b = (int)(blockIdx.x / n_kt / Hkv);
    const int G = H / Hkv;
    const long long q_row = (long long)H * D;
    const long long o_row = (long long)H * DV;
    const long long k_row = (long long)Hkv * D;
    const long long v_row = (long long)Hkv * DV;
    const long long kb = (long long)b * Skv * k_row + (long long)hk * D;
    const long long vb = (long long)b * Skv * v_row + (long long)hk * DV;

    load_tile<D, BK>(Ks, k + kb, k_row, k0, Skv, 1.f);
    load_tile<DV, BK>(Vs, v + vb, v_row, k0, Skv, 1.f);

    float dk_acc[4][NC], dv_acc[4][NV];
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        #pragma unroll
        for (int c = 0; c < NC; ++c) dk_acc[i][c] = 0.f;
        #pragma unroll
        for (int c = 0; c < NV; ++c) dv_acc[i][c] = 0.f;
    }

    // q tiles whose last row lies before this KV tile are fully masked
    int q_first = 0;
    if (causal && k0 > q_offset) q_first = ((k0 - q_offset) / BQ) * BQ;

    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const float* qb = q + (long long)b * Sq * q_row + (long long)h * D;
        const float* ob = dout + (long long)b * Sq * o_row + (long long)h * DV;
        const long long stat = ((long long)b * H + h) * Sq;
        for (int q0 = q_first; q0 < Sq; q0 += BQ) {
            __syncthreads();             // previous tiles fully consumed
            float s[4][4], dp[4][4];
            if constexpr (SHARE) {       // dO, then q in its place
                load_tile<DV, BQ>(dOs, ob, o_row, q0, Sq, 1.f);
                __syncthreads();
                tile_dot<DV>(dp, dOs, Vs, ty, tx);
                __syncthreads();
                load_tile<D, BQ>(Qs, qb, q_row, q0, Sq, scale);
                __syncthreads();
                tile_dot<D>(s, Qs, Ks, ty, tx);
            } else {
                load_tile<D, BQ>(Qs, qb, q_row, q0, Sq, scale);
                load_tile<DV, BQ>(dOs, ob, o_row, q0, Sq, 1.f);
                __syncthreads();
                tile_dot<D>(s, Qs, Ks, ty, tx);
                tile_dot<DV>(dp, dOs, Vs, ty, tx);
            }
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty + 16 * i, sq = q0 + r;
                const bool row_ok = sq < Sq;
                const float l = row_ok ? lse[stat + sq] : 0.f;
                const float dl = row_ok ? delta[stat + sq] : 0.f;
                const int q_pos = q_offset + sq;
                #pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = tx + 16 * j, k_pos = k0 + c;
                    const bool keep = row_ok && k_pos < Skv &&
                                      !(causal && k_pos > q_pos);
                    const float p = keep ? expf(s[i][j] - l) : 0.f;
                    Ps[r * (BK + 1) + c] = p;
                    dSs[r * (BK + 1) + c] = p * (dp[i][j] - dl);
                }
            }
            __syncthreads();

            if constexpr (SHARE) {
                // dk from q, then dO back in its place for dv: each sum
                // takes its terms in the order the loop below takes them
                #pragma unroll 4
                for (int r = 0; r < BQ; ++r) {
                    float ds[4];
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        ds[i] = dSs[r * (BK + 1) + ty + 16 * i];
                    #pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        const float qq = Qs[r * (D + 1) + tx + 16 * c];
                        #pragma unroll
                        for (int i = 0; i < 4; ++i)
                            dk_acc[i][c] = fmaf(ds[i], qq, dk_acc[i][c]);
                    }
                }
                __syncthreads();
                load_tile<DV, BQ>(dOs, ob, o_row, q0, Sq, 1.f);
                __syncthreads();
                #pragma unroll 4
                for (int r = 0; r < BQ; ++r) {
                    float p[4];
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        p[i] = Ps[r * (BK + 1) + ty + 16 * i];
                    #pragma unroll
                    for (int c = 0; c < NV; ++c) {
                        const float o = dOs[r * (DV + 1) + tx + 16 * c];
                        #pragma unroll
                        for (int i = 0; i < 4; ++i)
                            dv_acc[i][c] = fmaf(p[i], o, dv_acc[i][c]);
                    }
                }
                continue;
            }
            // dv[kv row][c] += sum_q p[q][kv row] dO[q][c]; dk likewise
            // with ds and the pre-scaled q
            #pragma unroll 4
            for (int r = 0; r < BQ; ++r) {
                float p[4], ds[4];
                #pragma unroll
                for (int i = 0; i < 4; ++i) {
                    p[i] = Ps[r * (BK + 1) + ty + 16 * i];
                    ds[i] = dSs[r * (BK + 1) + ty + 16 * i];
                }
                #pragma unroll
                for (int c = 0; c < NV; ++c) {
                    const float o = dOs[r * (DV + 1) + tx + 16 * c];
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        dv_acc[i][c] = fmaf(p[i], o, dv_acc[i][c]);
                }
                #pragma unroll
                for (int c = 0; c < NC; ++c) {
                    const float qq = Qs[r * (D + 1) + tx + 16 * c];
                    #pragma unroll
                    for (int i = 0; i < 4; ++i)
                        dk_acc[i][c] = fmaf(ds[i], qq, dk_acc[i][c]);
                }
            }
        }
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = k0 + ty + 16 * i;
        if (s >= Skv) continue;
        float* ok = dk + kb + (long long)s * k_row;
        float* ov = dv + vb + (long long)s * v_row;
        #pragma unroll
        for (int c = 0; c < NC; ++c) ok[tx + 16 * c] = dk_acc[i][c];
        #pragma unroll
        for (int c = 0; c < NV; ++c) ov[tx + 16 * c] = dv_acc[i][c];
    }
}

// ---------------------------------------------------------------------------
// dq for bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;    // 8 warps

// sub-tiles the dq pass computes a kv tile in: 2 at D > 128, where dQ's
// accumulators (D / 2 registers a thread) leave too few registers for a
// whole tile's scores, dP and dS fragments; 1 (the whole tile) below
__host__ __device__ constexpr int kv_halves(int D) { return D > 128 ? 2 : 1; }

constexpr int DQ_BQ = 128;          // q rows per block, 16 per warp

// kv rows per tile of the dq pass: 32 at (256, 256), where two 64-row K
// and V tiles beside q and dO would take 270,336 bytes; 64 below
template <int D, int DV>
__host__ __device__ constexpr int dq_bkv() { return D + DV > 384 ? 32 : 64; }

template <int D, int DV>
struct DqMmaSmem {                  // byte offsets; bf16 rows padded by 8
    static constexpr int BKV = dq_bkv<D, DV>();
    static constexpr int KS = D + 8;          // q and k rows
    static constexpr int VS = DV + 8;         // dO and v rows
    static constexpr int Q_OFF = 0;
    static constexpr int DO_OFF = Q_OFF + DQ_BQ * KS * 2;
    static constexpr int K_OFF = DO_OFF + DQ_BQ * VS * 2;
    static constexpr int V_OFF = K_OFF + 2 * BKV * KS * 2;     // 2 buffers
    static constexpr size_t BYTES = V_OFF + 2 * BKV * VS * 2;  // 2 buffers
};

template <int D, int DV>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_bwd_dq_kernel_mma(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int B, int Sq,
                        int Skv, int H, int Hkv, int q_offset, int causal,
                        float scale) {
    using S = DqMmaSmem<D, DV>;
    constexpr int DQ_BKV = S::BKV;       // kv rows per tile
    // at D > 128 the kv tile is computed in two 32-row halves: the scores,
    // dP and dS fragments (16 + 16 + 8 registers, not 32 + 32 + 16) make
    // room for dQ's D / 2 accumulator registers
    constexpr int KH = kv_halves(D);
    constexpr int SUB = DQ_BKV / KH;     // kv rows per sub-tile
    constexpr int NT = SUB / 8;          // score n-tiles per sub-tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const uint32_t base = tc::smem_addr(smem_raw);
    const uint32_t sQ = base + S::Q_OFF, sO = base + S::DO_OFF;
    const uint32_t sK = base + S::K_OFF, sV = base + S::V_OFF;
    const __nv_bfloat16* dO_s =
        reinterpret_cast<const __nv_bfloat16*>(smem_raw + S::DO_OFF);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // block (head, batch, q tile), heads fastest; the q tiles in reverse,
    // heaviest first
    const int h = (int)(blockIdx.x % H), b = (int)(blockIdx.x / H % B);
    const int n_qt = (Sq + DQ_BQ - 1) / DQ_BQ;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / H / B)) * DQ_BQ;
    const int hk = h / (H / Hkv);
    const long long q_row = (long long)H * D;      // element strides of a
    const long long o_row = (long long)H * DV;     // sequence position
    const long long k_row = (long long)Hkv * D;
    const long long v_row = (long long)Hkv * DV;
    const long long qb = (long long)b * Sq * q_row + (long long)h * D;
    const long long ob = (long long)b * Sq * o_row + (long long)h * DV;
    const __nv_bfloat16* kb = k + (long long)b * Skv * k_row + (long long)hk * D;
    const __nv_bfloat16* vb = v + (long long)b * Skv * v_row +
                              (long long)hk * DV;
    const long long stat = ((long long)b * H + h) * Sq;   // lse / delta row

    // the q and dO tiles, then K / V tile 0: one group of copies
    for (int i = tid; i < DQ_BQ * (D / 8); i += MMA_THREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = q0 + r;
        const bool in = s < Sq;
        tc::cp_async16(sQ + (r * S::KS + c) * 2,
                       q + qb + (in ? s : 0) * q_row + c, in);
    }
    for (int i = tid; i < DQ_BQ * (DV / 8); i += MMA_THREADS) {
        const int r = i / (DV / 8), c = (i % (DV / 8)) * 8, s = q0 + r;
        const bool in = s < Sq;
        tc::cp_async16(sO + (r * S::VS + c) * 2,
                       dout + ob + (in ? s : 0) * o_row + c, in);
    }
    auto load_kv = [&](int k0, int buf) {
        const uint32_t dk = sK + buf * DQ_BKV * S::KS * 2;
        const uint32_t dv = sV + buf * DQ_BKV * S::VS * 2;
        for (int i = tid; i < DQ_BKV * (D / 8); i += MMA_THREADS) {
            const int r = i / (D / 8), c = (i % (D / 8)) * 8, s = k0 + r;
            const bool in = s < Skv;
            tc::cp_async16(dk + (r * S::KS + c) * 2,
                           kb + (in ? s : 0) * k_row + c, in);
        }
        for (int i = tid; i < DQ_BKV * (DV / 8); i += MMA_THREADS) {
            const int r = i / (DV / 8), c = (i % (DV / 8)) * 8, s = k0 + r;
            const bool in = s < Skv;
            tc::cp_async16(dv + (r * S::VS + c) * 2,
                           vb + (in ? s : 0) * v_row + c, in);
        }
    };
    // KV tiles past the block's last row's diagonal are fully masked
    const int kv_end = causal ? min(Skv, q_offset + q0 + DQ_BQ) : Skv;
    const int n_tiles = (kv_end + DQ_BKV - 1) / DQ_BKV;
    load_kv(0, 0);
    tc::cp_async_commit();

    // this warp's rows: q0 + 16 warp + g and + 8
    const int wrow = q0 + 16 * warp;
    const int r0 = wrow + g, r1 = r0 + 8;
    const int pos0 = q_offset + r0, pos1 = pos0 + 8;
    const float c = scale * tc::LOG2E;   // exp(scale s) = exp2(c s)
    float lc0 = 0.f, lc1 = 0.f;          // lse * log2 e of rows r0, r1
    float dl0 = 0.f, dl1 = 0.f;          // delta of rows r0, r1
    float acc[D / 8][4];
    #pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const uint32_t qA = sQ + ((16 * warp + tc::a_row(lane)) * S::KS +
                              tc::a_col(lane)) * 2;
    const uint32_t oA = sO + ((16 * warp + tc::a_row(lane)) * S::VS +
                              tc::a_col(lane)) * 2;

    for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
            load_kv((j + 1) * DQ_BKV, (j + 1) & 1);
            tc::cp_async_commit();
            tc::cp_async_wait<1>();
        } else {
            tc::cp_async_wait<0>();
        }
        __syncthreads();
        if (j == 0) {
            // delta = sum_d dO * out of rows r0, r1 in fp32 (dO from the
            // tile, zero past Sq), stored for the dkv pass; lse of the rows
            const __nv_bfloat16* o0 = out + ob + (r0 < Sq ? r0 : 0) * o_row;
            const __nv_bfloat16* o1 = out + ob + (r1 < Sq ? r1 : 0) * o_row;
            const __nv_bfloat16* d0 = dO_s + (16 * warp + g) * S::VS;
            const __nv_bfloat16* d1 = d0 + 8 * S::VS;
            float s0 = 0.f, s1 = 0.f;
            #pragma unroll
            for (int n = 0; n < DV / 8; ++n) {
                const int col = n * 8 + 2 * t;
                const float2 a0 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(d0 + col));
                const float2 b0 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(o0 + col));
                const float2 a1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(d1 + col));
                const float2 b1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(o1 + col));
                s0 = fmaf(a0.y, b0.y, fmaf(a0.x, b0.x, s0));
                s1 = fmaf(a1.y, b1.y, fmaf(a1.x, b1.x, s1));
            }
            dl0 = tc::quad_sum(s0);
            dl1 = tc::quad_sum(s1);
            if (r0 < Sq) lc0 = lse[stat + r0] * tc::LOG2E;
            if (r1 < Sq) lc1 = lse[stat + r1] * tc::LOG2E;
            if (t == 0 && r0 < Sq) delta[stat + r0] = dl0;
            if (t == 0 && r1 < Sq) delta[stat + r1] = dl1;
        }
        #pragma unroll 1
        for (int kh = 0; kh < KH; ++kh) {
        const int k0 = j * DQ_BKV + kh * SUB;
        // sub-tiles wholly above this warp's diagonal add nothing
        if (!causal || k0 <= q_offset + wrow + 15) {
            const uint32_t kt = sK + ((j & 1) * DQ_BKV + kh * SUB) * S::KS * 2;
            const uint32_t vt = sV + ((j & 1) * DQ_BKV + kh * SUB) * S::VS * 2;
            // S = Q K^T (16 q rows x SUB kv rows)
            float s[NT][4];
            #pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
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
            // dP = dO V^T
            float dp[NT][4];
            #pragma unroll
            for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
            #pragma unroll
            for (int dc = 0; dc < DV / 16; ++dc) {
                uint32_t oa[4];
                tc::ldsm_x4(oa, oA + dc * 32);
                #pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t vr[4];
                    tc::ldsm_x4(vr, vt + ((np * 16 + tc::bn_row(lane)) * S::VS +
                                          dc * 16 + tc::bn_col(lane)) * 2);
                    tc::mma_bf16(dp[2 * np], oa, vr[0], vr[1]);
                    tc::mma_bf16(dp[2 * np + 1], oa, vr[2], vr[3]);
                }
            }
            // P = exp(scale S - lse) in fp32, masked only where the tile
            // crosses the diagonal or Skv; dS = P (dP - delta) in fp32,
            // rounded to bf16 once into the A fragments of dS K
            const bool edge = k0 + SUB > Skv ||
                              (causal && k0 + SUB - 1 > q_offset + wrow);
            uint32_t da[NT / 2][4];
            #pragma unroll
            for (int n = 0; n < NT; ++n) {
                #pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float p = exp2f(fmaf(s[n][e], c, -(e < 2 ? lc0 : lc1)));
                    if (edge) {
                        const int kp = k0 + n * 8 + 2 * t + (e & 1);
                        if (kp >= Skv || (causal && kp > (e < 2 ? pos0 : pos1)))
                            p = 0.f;
                    }
                    s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1));
                }
                da[n / 2][(n & 1) * 2] = tc::pack_bf16(s[n][0], s[n][1]);
                da[n / 2][(n & 1) * 2 + 1] = tc::pack_bf16(s[n][2], s[n][3]);
            }
            // dQ += dS K (K by ldmatrix.trans)
            #pragma unroll
            for (int kc = 0; kc < NT / 2; ++kc) {
                #pragma unroll
                for (int np = 0; np < D / 16; ++np) {
                    uint32_t kr[4];
                    tc::ldsm_x4_trans(kr, kt + ((kc * 16 + tc::a_row(lane)) *
                                                S::KS + np * 16 +
                                                tc::a_col(lane)) * 2);
                    tc::mma_bf16(acc[2 * np], da[kc], kr[0], kr[1]);
                    tc::mma_bf16(acc[2 * np + 1], da[kc], kr[2], kr[3]);
                }
            }
        }
        }
        __syncthreads();                 // tile j's buffers free again
    }

    #pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int s = r0 + 8 * half;
        if (s >= Sq) continue;
        __nv_bfloat16* row = dq + qb + (long long)s * q_row;
        #pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) = tc::pack_bf16(
                acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
}

// above 48 KB of dynamic shared memory a kernel needs an opt-in, once
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, bool& configured) {
    if (configured) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess) configured = true;
    return e;
}

struct Args {
    const void *q, *k, *v, *out, *dout, *lse;
    void *delta, *dq, *dk, *dv;
    int B, Sq, Skv, H, Hkv, q_offset, causal;
    float scale;
};

// a one-dimensional grid's limit
constexpr long long MAX_BLOCKS = 0x7fffffffLL;

template <int D, int DV>
int launch_dq(const Args& a, cudaStream_t st) {
    auto kern = flash_bwd_dq_kernel<D, DV>;
    constexpr size_t bytes = DqSmem<D, DV>::BYTES;
    const long long blocks = (long long)((a.Sq + BQ - 1) / BQ) * a.H * a.B;
    if (blocks > MAX_BLOCKS) return -1;
    static bool configured = false;
    const cudaError_t e = allow_smem(kern, bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)blocks, THREADS, bytes, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.out),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<float*>(a.dq), a.Sq, a.Skv,
        a.H, a.Hkv, a.q_offset, a.causal, a.scale);
    return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_dkv(const Args& a, cudaStream_t st) {
    auto kern = flash_bwd_dkv_kernel<D, DV>;
    constexpr size_t bytes = DkvSmem<D, DV>::BYTES;
    const long long blocks =
        (long long)((a.Skv + BK - 1) / BK) * a.Hkv * a.B;
    if (blocks > MAX_BLOCKS) return -1;
    static bool configured = false;
    const cudaError_t e = allow_smem(kern, bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)blocks, THREADS, bytes, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Skv, a.H,
        a.Hkv, a.q_offset, a.causal, a.scale);
    return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_dq_mma(const Args& a, cudaStream_t st) {
    auto kern = flash_bwd_dq_kernel_mma<D, DV>;
    constexpr size_t bytes = DqMmaSmem<D, DV>::BYTES;
    const long long blocks =
        (long long)a.H * a.B * ((a.Sq + DQ_BQ - 1) / DQ_BQ);
    if (blocks > MAX_BLOCKS) return -1;
    static bool configured = false;
    const cudaError_t e = allow_smem(kern, bytes, configured);
    if (e != cudaSuccess) return (int)e;
    kern<<<(unsigned)blocks, MMA_THREADS, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const __nv_bfloat16*>(a.out),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
        static_cast<__nv_bfloat16*>(a.dq), a.B, a.Sq, a.Skv, a.H, a.Hkv,
        a.q_offset, a.causal, a.scale);
    return (int)cudaGetLastError();
}

// fp32 -> the FMA kernels of both passes; bf16 -> the mma.sync dq pass
// (bf16 dk / dv runs flash_attention_bwd_wgmma.cu's kernel, and never
// comes here: flash_bwd_dkv_launch takes fp32 only)
template <bool MMA>
int dispatch(bool dq_pass, int D, int Dv, const Args& a, cudaStream_t st) {
#define FLASH_BWD_CASE(d, dv)                                               \
    if (D == d && Dv == dv)                                                 \
        return MMA ? launch_dq_mma<d, dv>(a, st)                            \
                   : (dq_pass ? launch_dq<d, dv>(a, st)                     \
                              : launch_dkv<d, dv>(a, st));
    FLASH_BWD_CASE(16, 16)
    FLASH_BWD_CASE(32, 32)
    FLASH_BWD_CASE(64, 64)
    FLASH_BWD_CASE(128, 128)
    FLASH_BWD_CASE(128, 64)
    FLASH_BWD_CASE(192, 128)
    FLASH_BWD_CASE(96, 64)
    FLASH_BWD_CASE(80, 80)
    FLASH_BWD_CASE(256, 256)
#undef FLASH_BWD_CASE
    return -1;
}

int run(bool dq_pass, int dtype, int D, int Dv, const Args& a,
        void* stream) {
    if (a.B < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.Sq < 1 ||
        a.Skv < 1 || a.q_offset < 0)
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<false>(dq_pass, D, Dv, a, st);
    if (dtype == 1 && dq_pass) {         // the tensor-core kernel's copies
        const uintptr_t any = reinterpret_cast<uintptr_t>(a.q) |
                              reinterpret_cast<uintptr_t>(a.k) |
                              reinterpret_cast<uintptr_t>(a.v) |
                              reinterpret_cast<uintptr_t>(a.out) |
                              reinterpret_cast<uintptr_t>(a.dout) |
                              reinterpret_cast<uintptr_t>(a.dq);
        if (any % 16) return -1;
        return dispatch<true>(dq_pass, D, Dv, a, st);
    }
    return -1;
}

}  // namespace

// Plain C entry points: the dq pass in either type (dtype: 0 = float32, 1
// = bfloat16), the dk / dv pass in fp32 (bf16 has
// flash_bwd_dkv_wgmma_launch).  Device pointers to contiguous q / dq (B,
// Sq, H, D), k / dk (B, Skv, Hkv, D), v / dv (B, Skv, Hkv, Dv), out / dout
// (B, Sq, H, Dv) in the inputs' type, and lse / delta (B, H, Sq) fp32; for
// the bf16 dq pass (the tensor-core kernel's cp.async copies) q, k, v,
// out, dout and dq 16-byte aligned.  The dq pass writes dq and delta; the
// dkv pass reads delta and must run after it on the same stream.  Each
// returns the launch's cudaGetLastError() (0 on success), or -1 on
// arguments the kernels do not take: a pair that is no instance, or more
// than 2^31 - 1 blocks (the Python wrapper pads to an instance, checks
// first and raises).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, int dtype, int B,
                                   int Sq, int Skv, int H, int Hkv, int D,
                                   int Dv, int q_offset, int causal,
                                   float scale, void* stream) {
    const Args a{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr,
                 B, Sq, Skv, H, Hkv, q_offset, causal, scale};
    return run(true, dtype, D, Dv, a, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Sq,
                                    int Skv, int H, int Hkv, int D, int Dv,
                                    int q_offset, int causal, float scale,
                                    void* stream) {
    const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
                 nullptr, dk, dv, B, Sq, Skv, H, Hkv, q_offset, causal,
                 scale};
    return run(false, 0, D, Dv, a, stream);
}
