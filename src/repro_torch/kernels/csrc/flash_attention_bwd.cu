// flash_bwd_dq_kernel / flash_bwd_dkv_kernel: the fp32 FlashAttention-2
// backward with GQA, causal masking from a q offset, for the out + lse that
// the forward (flash_attention.cu) saved.  bf16 runs the Hopper kernels of
// flash_attention_bwd_wgmma.cu (wgmma, TMA, warp specialisation).
//
// Replace the TPU kernels repro/kernels/flash_attention.py::_dq_kernel and
// ::_dkv_kernel (driven by flash_bwd) for fp32.  On the TPU both are grids
// whose innermost axis runs in order, carrying the dq (resp. dk / dv) sum
// in VMEM scratch from one grid step to the next.  Blocks on the H100 run
// in no order, so each sum lives in one block's registers and the block
// walks the sequential axis itself:
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
// test on absolute positions: a (64-row q tile, KV tile) pair is computed
// when k0 <= q_offset + q0 + 63.
//
// What bounds them on an H100: operations in fp32 FMA on the CUDA cores
// (fp32 gradients must meet 5e-4 without TF32).  The dq pass does three
// products per score tile (s and dq at D, dp at Dv) and the dkv pass four
// (s and dk at D, dp and dv at Dv), 2.5x the forward's operations in all
// at D = Dv (FA2's count), against q + k + v + out + dout + dq + dk + dv
// bytes plus lse and delta.  The block's 256 threads form a 16 x 16 grid:
// thread (ty, tx) owns the scores of q rows ty + 16i and KV columns tx +
// 16j (i, j < 4), and 4 rows x (width / 16) columns of each accumulator.
// All tiles sit in shared memory as fp32 with rows padded by one float, so
// the inner loops read broadcasts or 16 consecutive banks.  Shared memory
// at head dim 128: dq 148,736 bytes (q, dO, k, v, ds), dkv 165,376 bytes
// (k, v, q, dO, p, ds), one block per SM, through cudaFuncSetAttribute.
// At head dim 256 every tile at once would not fit: K and V (dq pass) or q
// and dO (dk / dv pass) take turns in one buffer of the wider row
// (dq_share / dkv_share), loading each operand when its product runs,
// within 232,448 bytes.
//
// Head dims as in flash_attention.cu, (192, 128), (96, 64), (80, 80) and
// (256, 256) included; any other pair up to 256 runs zero-padded on the
// instance that dominates it (the wrapper pads q, k, v, out and dout and
// drops the gradients' extra columns, which are zero; lse and delta are
// unchanged by zero columns).  Every grid is one-dimensional: block i is
// the (x, y, z) block of the three-dimensional grid described below,
// unfolded from i in the order such a grid launches, so B, H and the tile
// count are bounded only by their product (< 2^31).

#include <cuda_runtime.h>
#include <math.h>

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

// the FMA kernels of both passes (fp32)
int dispatch(bool dq_pass, int D, int Dv, const Args& a, cudaStream_t st) {
#define FLASH_BWD_CASE(d, dv)                                               \
    if (D == d && Dv == dv)                                                 \
        return dq_pass ? launch_dq<d, dv>(a, st) : launch_dkv<d, dv>(a, st);
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

int run(bool dq_pass, int D, int Dv, const Args& a, void* stream) {
    if (a.B < 1 || a.H < 1 || a.Hkv < 1 || a.H % a.Hkv || a.Sq < 1 ||
        a.Skv < 1 || a.q_offset < 0)
        return -1;
    return dispatch(dq_pass, D, Dv, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points of the fp32 passes (bf16 has
// flash_attention_bwd_wgmma.cu's): device pointers to contiguous q / dq
// (B, Sq, H, D), k / dk (B, Skv, Hkv, D), v / dv (B, Skv, Hkv, Dv), out /
// dout (B, Sq, H, Dv) fp32, and lse / delta (B, H, Sq) fp32.  The dq pass
// writes dq and delta; the dkv pass reads delta and must run after it on
// the same stream.  Each returns the launch's cudaGetLastError() (0 on
// success), or -1 on arguments the kernels do not take: a pair that is no
// instance, or more than 2^31 - 1 blocks (the Python wrapper pads to an
// instance, checks first and raises).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, int B, int Sq,
                                   int Skv, int H, int Hkv, int D, int Dv,
                                   int q_offset, int causal, float scale,
                                   void* stream) {
    const Args a{q, k, v, out, dout, lse, delta, dq, nullptr, nullptr,
                 B, Sq, Skv, H, Hkv, q_offset, causal, scale};
    return run(true, D, Dv, a, stream);
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
    return run(false, D, Dv, a, stream);
}
