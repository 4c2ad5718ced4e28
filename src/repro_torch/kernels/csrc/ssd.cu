// ssd_scan_kernel: the Mamba-2 state-space-duality (SSD) scan, chunked dual
// form, group size 1, forward only.
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
//
// The wrapper's preparation is fused: x is read in place through its batch
// and token strides (the model hands a view into the conv output, token
// stride conv_ch), x * dt and dt * A are formed here in fp32, and y is
// written in the caller's layout — no fp32 (b, H, S, P) copy of x dt, no
// padded copies, no transposes.
//
// What bounds it on an H100: operations, 2Q^2N + 2Q^2P + 4QNP per (b, h,
// chunk) — three tensor-core-shaped products — against x, y, dt, B, C and
// the state in bytes.  This first version computes in fp32 FMA for bf16
// and fp32 inputs alike (fp32 inputs must meet 1e-4 of the sequential
// recurrence; no TF32), recomputes C B^T once per head although all heads
// share B and C, and its grid is one block per (b, h) — 256 blocks at the
// serving batch of 4 on 132 SMs, 64 at batch 1.  Tensor cores and a shared
// C B^T are later work.
//
// Inside a block of 4P threads: the chunk's running sum a_cum sits in
// shared memory (thread 0 scans it in token order, so a second launch is
// bit-equal; there are no atomics).  For each 64-row query sub-tile i the
// block loads C_i (fp32, n-major, padded stride 68), computes C_i state^T,
// then for each key sub-tile j <= i loads B_j (n-major) and x_j dt_j,
// forms the masked score tile (L o C_i B_j^T) in shared memory and
// accumulates it times x_j dt_j in registers: each thread owns a 4 x 4
// (row, p) block of y_i.  After the chunk's y, the state is scaled by
// exp(a_tot) and gets (x_j dt_j exp(a_tot - a_cum))^T B_j added, sub-tile
// by sub-tile; there each thread owns 4 x 4 (p, n) blocks of the state.
// The inner loops read 4 values of each operand per 16 FMAs (float4 along
// the owned dimension, broadcast along the other).  Shared memory at the
// full config (P 64, N 128, Q 256): 137,216 bytes, one block per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TQ = 64;          // rows of a sub-tile of a chunk
constexpr int LDK = TQ + 4;     // padded stride of the n-major tiles

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

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// rows t0 .. t0 + TQ - 1 (chunk-relative; rows >= q_len load zeros) of a
// (b, S, N) operand into dst[n * LDK + row], fp32
template <typename T>
__device__ void load_nmajor(float* dst, const T* src, long long tok_stride,
                            int t0, int q_len, int N, int tid, int nt) {
    for (int e = tid; e < TQ * N; e += nt) {
        const int r = e / N, n = e % N;
        const int t = t0 + r;
        dst[n * LDK + r] = t < q_len ? to_f32(src[t * tok_stride + n]) : 0.f;
    }
}

template <typename T, int P>
__global__ void __launch_bounds__(4 * P)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int N, int chunk,
                long long xsb, long long xss, long long bsb, long long bss,
                long long csb, long long css) {
    constexpr int NT = 4 * P;            // threads
    constexpr int PG = P / 4;            // 4-wide column groups of p
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int n_sub = (chunk + TQ - 1) / TQ;

    extern __shared__ float smem[];
    float* Cs = smem;                    // N x LDK, C of the query sub-tile
    float* Bs = Cs + N * LDK;            // N x LDK, B of the key sub-tile
    float* Xs = Bs + N * LDK;            // TQ x P, x dt (x dt decay) rows
    float* Ss = Xs + TQ * P;             // TQ x LDK, masked scores, c-major
    float* St = Ss + TQ * LDK;           // N x P, the state, n-major
    float* acum = St + N * P;            // n_sub * TQ, a_cum of the chunk

    const float Ah = A[h];
    const T* xb = x + b * xsb + (long long)h * P;
    const T* Bb = Bm + b * bsb;
    const T* Cb = Cm + b * csb;
    const float* dtb = dt + (long long)b * S * H + h;
    T* yb = y + (long long)b * S * H * P + (long long)h * P;

    for (int e = tid; e < N * P; e += NT) St[e] = 0.f;

    // the thread's 4 x 4 block of a y sub-tile: rows r0.., columns p0..
    const int r0 = (tid / PG) * 4, p0 = (tid % PG) * 4;

    for (int c0 = 0; c0 < S; c0 += chunk) {
        const int q_len = min(chunk, S - c0);
        const int tiles = (q_len + TQ - 1) / TQ;
        const T* xc = xb + c0 * xss;
        const T* Bc = Bb + c0 * bss;
        const T* Cc = Cb + c0 * css;
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
                    Xs[e] = t < q_len ? to_f32(xc[t * xss + p])
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
                T* yr = yb + (long long)(c0 + t) * H * P + p0;
                #pragma unroll
                for (int j = 0; j < 4; ++j)
                    yr[j] = from_f32<T>(acc[i][j] + off[i][j] * ea);
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
                Xs[e] = t < q_len ? to_f32(xc[t * xss + p])
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
    float* so = state_out + ((long long)b * H + h) * P * N;
    for (int e = tid; e < P * N; e += NT) {
        const int p = e / N, n = e % N;
        so[e] = St[n * P + p];
    }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int batch, int S, int H,
           int N, int chunk, const long long* strides, size_t smem_bytes,
           cudaStream_t stream) {
    auto kern = ssd_scan_kernel<T, P>;
    static size_t configured = 0;        // above 48 KB needs an opt-in
    if (smem_bytes > configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes);
        if (e != cudaSuccess) return (int)e;
        configured = smem_bytes;
    }
    const dim3 grid(H, batch);
    kern<<<grid, 4 * P, smem_bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<T*>(y),
        static_cast<float*>(state), S, H, N, chunk, strides[0], strides[1],
        strides[2], strides[3], strides[4], strides[5]);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int P, const void* x, const void* dt, const void* A,
             const void* Bm, const void* Cm, void* y, void* state, int batch,
             int S, int H, int N, int chunk, const long long* strides,
             size_t smem_bytes, cudaStream_t st) {
#define SSD_CASE(p)                                                         \
    if (P == p)                                                             \
        return launch<T, p>(x, dt, A, Bm, Cm, y, state, batch, S, H, N,     \
                            chunk, strides, smem_bytes, st);
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
#undef SSD_CASE
    return -1;
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).
// Device pointers: x (b, S, H, P) with unit stride along p and stride P
// along h; dt (b, S, H) fp32 contiguous; A (H,) fp32; B and C (b, S, N)
// with unit stride along n; y (b, S, H, P) contiguous in x's type; state
// (b, H, P, N) fp32 contiguous.  strides: x, B, C batch and token strides
// in elements, in that order.  smem_bytes: the dynamic shared memory the
// wrapper computed for (P, N, chunk).  Returns the launch's
// cudaGetLastError() (0 on success), or -1 on arguments the kernel does not
// take (the Python wrapper checks first and raises).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int dtype, int batch, int S,
                               int H, int P, int N, int chunk,
                               const long long* strides,
                               long long smem_bytes, void* stream) {
    if (batch < 1 || batch > 65535 || H < 1 || S < 1 || N < 4 || N % 4 ||
        chunk < 1 || chunk > S || smem_bytes < 1 || smem_bytes > 232448)
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch<float>(P, x, dt, A, Bm, Cm, y, state, batch, S, H, N,
                               chunk, strides, (size_t)smem_bytes, st);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(P, x, dt, A, Bm, Cm, y, state, batch,
                                       S, H, N, chunk, strides,
                                       (size_t)smem_bytes, st);
    return -1;
}
