// rmsnorm_fwd_kernel: y = x * rsqrt(mean(x^2) + eps) * scale, one block per
// row, statistics in fp32, the result cast back to x's type.
// rmsnorm_bwd_kernel: its input and scale gradients (after the forward's
// notes below).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::_fwd_kernel (driven by
// rmsnorm_fwd), which streams a (block_rows, D) tile through VMEM.  Here a
// block of up to 256 threads owns one row of the (R, D) view of x: any
// leading shape is R = numel / D rows, and D is a runtime argument (the
// widest d_model of the supported archs is 5120).
//
// What bounds it on an H100: bytes, 2*R*D*elt + D*elt (x read, y written,
// scale read once) against ~5 flops per element.  Each thread loads 16
// bytes at a time (8 bf16 or 4 fp32 values) where D and the pointers allow
// it, else one element; the sum of squares is reduced with warp shuffles
// and one shared-memory step across warps.  The second pass reads the row
// again — it was just read by the same block and comes from L1/L2, so
// device memory sees x once.
//
// rmsnorm_bwd_kernel replaces repro/kernels/rmsnorm.py::_bwd_kernel
// (driven by rmsnorm_bwd): with xhat = x * inv, inv = rsqrt(mean(x^2) +
// eps), and dxhat = dy * scale,
//     dx     = inv * (dxhat - xhat * mean(dxhat * xhat))   (x's type)
//     dscale = sum over rows of dy * xhat                  (fp32)
// The TPU kernel emits one partial dscale row per (block_rows, D) tile and
// its wrapper sums them; here one block owns rows_per_block consecutive
// rows (the wrapper fixes the split from the row count alone, so the
// result does not depend on the card) and writes one fp32 partial row,
// and the wrapper sums the partial rows: deterministic, no atomics.
// Each thread owns the same columns in every row, so its partial sums sit
// in a D-float shared-memory row that no other thread touches.  Per row:
// one pass reduces sum x^2 and sum dy * scale * x together (one two-value
// block reduction), a second pass (from L1/L2) writes dx.  Bound: bytes,
// 3*R*D*elt (x, dy read, dx written) + D*elt + the partial rows.  Above
// D = 12,032 (SMEM_MAX_D) that row would pass the 48 KB a block gets
// without an opt-in: there (GLOBAL_ACC) each thread sums its columns
// straight into the block's partial row in device memory, which no other
// thread touches either, in the same order (row by row, fmaf from 0), so
// any D is taken, the sums are the same and the partial rows, their
// number and their order do not change.  The row's reads and writes stay
// in L2 (D * 4 bytes a block).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

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

// VEC values of T moved as one load/store (16 bytes when VEC * sizeof(T)
// is 16, one element when VEC is 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

__device__ __forceinline__ float block_sum(float v, float* red) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = (blockDim.x + 31) >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < n_warps ? red[lane] : 0.f;
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    return red[0];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ y, int D, float eps) {
    __shared__ float red[MAX_THREADS / 32];
    using P = Pack<T, VEC>;
    const long long row = blockIdx.x;
    const P* xr = reinterpret_cast<const P*>(x + row * D);
    const P* sr = reinterpret_cast<const P*>(scale);
    P* yr = reinterpret_cast<P*>(y + row * D);
    const int n_vec = D / VEC;

    float ss = 0.f;
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
        const P p = xr[i];
        #pragma unroll
        for (int e = 0; e < VEC; ++e) {
            const float f = to_f32(p.v[e]);
            ss = fmaf(f, f, ss);
        }
    }
    const float inv = rsqrtf(block_sum(ss, red) / (float)D + eps);

    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
        const P p = xr[i];
        const P s = sr[i];
        P o;
        #pragma unroll
        for (int e = 0; e < VEC; ++e)
            o.v[e] = from_f32<T>(to_f32(p.v[e]) * inv * to_f32(s.v[e]));
        yr[i] = o;
    }
}

// (a, b) summed over the block; red holds 2 * (warps + 1) floats.  The
// result has its own slot, so back-to-back calls need no extra barrier.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_warps = (blockDim.x + 31) >> 5;
    if (lane == 0) {
        red[2 * warp] = a;
        red[2 * warp + 1] = b;
    }
    __syncthreads();
    if (warp == 0) {
        a = lane < n_warps ? red[2 * lane] : 0.f;
        b = lane < n_warps ? red[2 * lane + 1] : 0.f;
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            a += __shfl_xor_sync(0xffffffffu, a, off);
            b += __shfl_xor_sync(0xffffffffu, b, off);
        }
        if (lane == 0) {
            red[2 * (MAX_THREADS / 32)] = a;
            red[2 * (MAX_THREADS / 32) + 1] = b;
        }
    }
    __syncthreads();
    return make_float2(red[2 * (MAX_THREADS / 32)],
                       red[2 * (MAX_THREADS / 32) + 1]);
}

constexpr int SMEM_MAX_D = 12032;    // a partial row in 48 KB of shared memory

template <typename T, int VEC, bool GLOBAL_ACC>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dscale_part, long long rows,
                   int rows_per_block, int D, float eps) {
    extern __shared__ float ds_smem[];   // this block's partial dscale row
    __shared__ float red[2 * (MAX_THREADS / 32 + 1)];
    using P = Pack<T, VEC>;
    const P* sr = reinterpret_cast<const P*>(scale);
    const int n_vec = D / VEC;
    float* part = dscale_part + (long long)blockIdx.x * D;
    float* ds_acc = GLOBAL_ACC ? part : ds_smem;
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
        #pragma unroll
        for (int e = 0; e < VEC; ++e) ds_acc[i * VEC + e] = 0.f;

    const long long row0 = (long long)blockIdx.x * rows_per_block;
    const long long row_end = min(rows, row0 + rows_per_block);
    for (long long row = row0; row < row_end; ++row) {
        const P* xr = reinterpret_cast<const P*>(x + row * D);
        const P* gr = reinterpret_cast<const P*>(dy + row * D);
        P* dr = reinterpret_cast<P*>(dx + row * D);
        float ss = 0.f, t = 0.f;         // sum x^2, sum dy * scale * x
        for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
            const P p = xr[i], g = gr[i], s = sr[i];
            #pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float f = to_f32(p.v[e]);
                ss = fmaf(f, f, ss);
                t = fmaf(to_f32(g.v[e]) * to_f32(s.v[e]), f, t);
            }
        }
        const float2 sums = block_sum2(ss, t, red);
        const float inv = rsqrtf(sums.x / (float)D + eps);
        const float mean_dot = inv * sums.y / (float)D;  // mean(dxhat*xhat)
        for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
            const P p = xr[i], g = gr[i], s = sr[i];
            P o;
            #pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float xhat = to_f32(p.v[e]) * inv;
                const float gy = to_f32(g.v[e]);
                o.v[e] = from_f32<T>(
                    inv * (gy * to_f32(s.v[e]) - xhat * mean_dot));
                ds_acc[i * VEC + e] = fmaf(gy, xhat, ds_acc[i * VEC + e]);
            }
            dr[i] = o;
        }
    }
    if (GLOBAL_ACC) return;              // the sums are in place
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
        #pragma unroll
        for (int e = 0; e < VEC; ++e) part[i * VEC + e] = ds_acc[i * VEC + e];
}

template <typename T>
int launch(const void* x, const void* scale, void* y, long long rows, int D,
           float eps, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = D % VEC == 0 &&
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)y) % 16 == 0;
    const int n_vec = vec ? D / VEC : D;
    int threads = ((n_vec + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    const T* xt = static_cast<const T*>(x);
    const T* st = static_cast<const T*>(scale);
    T* yt = static_cast<T*>(y);
    if (vec)
        rmsnorm_fwd_kernel<T, VEC><<<(unsigned)rows, threads, 0, stream>>>(
            xt, st, yt, D, eps);
    else
        rmsnorm_fwd_kernel<T, 1><<<(unsigned)rows, threads, 0, stream>>>(
            xt, st, yt, D, eps);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx,
               void* dscale_part, long long rows, int rows_per_block, int D,
               float eps, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const bool vec = D % VEC == 0 &&
        ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)dy |
         (uintptr_t)dx) % 16 == 0;
    const int n_vec = vec ? D / VEC : D;
    int threads = ((n_vec + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    const bool global_acc = D > SMEM_MAX_D;
    const size_t smem = global_acc ? 0 : (size_t)D * sizeof(float);
    const T* xt = static_cast<const T*>(x);
    const T* st = static_cast<const T*>(scale);
    const T* gt = static_cast<const T*>(dy);
    T* dt = static_cast<T*>(dx);
    float* pt = static_cast<float*>(dscale_part);
    if (vec && !global_acc)
        rmsnorm_bwd_kernel<T, VEC, false><<<(unsigned)blocks, threads, smem,
                                            stream>>>(xt, st, gt, dt, pt,
                                                      rows, rows_per_block,
                                                      D, eps);
    else if (!global_acc)
        rmsnorm_bwd_kernel<T, 1, false><<<(unsigned)blocks, threads, smem,
                                          stream>>>(xt, st, gt, dt, pt, rows,
                                                    rows_per_block, D, eps);
    else if (vec)
        rmsnorm_bwd_kernel<T, VEC, true><<<(unsigned)blocks, threads, smem,
                                           stream>>>(xt, st, gt, dt, pt,
                                                     rows, rows_per_block, D,
                                                     eps);
    else
        rmsnorm_bwd_kernel<T, 1, true><<<(unsigned)blocks, threads, smem,
                                         stream>>>(xt, st, gt, dt, pt, rows,
                                                   rows_per_block, D, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16.  Device
// pointers to contiguous x (rows, D), scale (D,) and y (rows, D).  Returns
// the launch's cudaGetLastError() (0 on success), or -1 on arguments the
// kernel does not take (the Python wrapper checks first and raises).
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  int dtype, long long rows, int D,
                                  float eps, void* stream) {
    if (rows < 1 || rows > 0x7fffffffLL || D < 1) return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x, scale, y, rows, D, eps, st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(x, scale, y, rows, D, eps, st);
    return -1;
}

// Plain C entry point of the backward.  dtype: 0 = float32, 1 = bfloat16.
// Device pointers to contiguous x, dy, dx (rows, D) and scale (D,) in one
// type, and the fp32 partial rows dscale_part (ceil(rows / rows_per_block),
// D).  Any D: up to 12,032 a block's partial row is summed in shared
// memory, above it in its row of dscale_part.
// Returns the launch's cudaGetLastError() (0 on success), or -1 on
// arguments the kernel does not take (the Python wrapper checks first and
// raises).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx,
                                  void* dscale_part, int dtype,
                                  long long rows, int rows_per_block, int D,
                                  float eps, void* stream) {
    if (rows < 1 || D < 1 || rows_per_block < 1 ||
        (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
        return -1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_bwd<float>(x, scale, dy, dx, dscale_part, rows,
                                 rows_per_block, D, eps, st);
    if (dtype == 1)
        return launch_bwd<__nv_bfloat16>(x, scale, dy, dx, dscale_part, rows,
                                         rows_per_block, D, eps, st);
    return -1;
}
