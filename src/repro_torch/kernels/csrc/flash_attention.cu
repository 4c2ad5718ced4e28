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
// when causal) against (q + k + v + out) bytes plus the fp32 lse.  The
// kernel here takes fp32; bf16 runs the wgmma kernel of
// flash_attention_wgmma.cu at every pair.
//
// flash_fwd_kernel: fp32 FMA on the CUDA cores (fp32 must not use TF32 to
// meet the 2e-5 tolerance).  The block's 256 threads form a 16 x 16 grid:
// thread (ty, tx) owns the scores of rows ty + 16i and columns tx + 16j
// (i, j < 4) and the output columns tx + 16c.  q (pre-scaled), k, v and
// the probability tile sit in shared memory as fp32 with padded row
// strides, so the inner loops read it without bank conflicts: 4 q values
// are broadcast and 4 k values fan out per 16 FMAs.  Row max and row sum
// reduce over the 16 lanes of a half-warp with shuffles.
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
// are not multiples of 32: every loop of the FMA kernel over a head dim
// strides by 16 columns a thread (D / 16), so a multiple of 16 is all a
// pair needs.
//
// The grid is one-dimensional: block i is (head, batch, q tile) in the
// order a (H, B, q tiles) grid would launch them, unfolded from i, so B,
// H and the q tiles are bounded only by their product (< 2^31).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

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

// fp32 -> the FMA kernel at every pair
int dispatch(int D, int Dv, const void* q, const void* k, const void* v,
             void* out, void* lse, int B, int Sq, int Skv, int H, int Hkv,
             int q_offset, int causal, float scale, cudaStream_t st) {
#define FLASH_CASE(d, dv)                                                   \
    if (D == d && Dv == dv)                                                 \
        return launch<float, d, dv>(q, k, v, out, lse, B, Sq, Skv, H, Hkv,  \
                                    q_offset, causal, scale, st);
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

// Plain C entry point of the fp32 forward (bf16 has
// flash_fwd_wgmma_launch).  Device pointers to contiguous fp32 q (B, Sq, H,
// D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out (B, Sq, H, Dv) and lse
// (B, H, Sq).  Returns the launch's cudaGetLastError() (0 on success), or
// -1 on arguments the kernel does not take: a pair that is no instance, or
// more than 2^31 - 1 blocks (the Python wrapper pads to an instance,
// checks first and raises).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Sq, int Skv,
                                int H, int Hkv, int D, int Dv, int q_offset,
                                int causal, float scale, void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 ||
        q_offset < 0)
        return -1;
    return dispatch(D, Dv, q, k, v, out, lse, B, Sq, Skv, H, Hkv, q_offset,
                    causal, scale, static_cast<cudaStream_t>(stream));
}
