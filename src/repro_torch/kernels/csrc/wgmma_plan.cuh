// The tiles and shared memory of the Hopper flash kernels
// (flash_attention_wgmma.cu, flash_attention_bwd_wgmma.cu), constexpr for
// device and host, mirrored by flash_attention.py's wgmma_plan
// (chip_smoke.py holds the two to each other through flash_wgmma_plan); and
// the host's TMA tensor maps.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace wgmma_plan {

// the swizzle width of a bf16 operand of `cols` columns: the widest of 64
// (128-byte swizzle), 32 (64-byte) and 16 (32-byte) columns that divides
// it, so that every TMA box and every wgmma descriptor of the operand
// share one layout
__host__ __device__ constexpr int swizzle_cols(int cols) {
    return cols % 64 == 0 ? 64 : cols % 32 == 0 ? 32 : 16;
}

constexpr int MAX_SMEM = 232448;      // an H100 block's opt-in

// forward: 128 q rows a block (64 per consumer warpgroup), kv tiles of
// fwd_bk rows through a ring of fwd_stages (3 where they fit the opt-in,
// else 2); (256, 256) takes 64-row kv tiles, so that q, two K and two V
// tiles fit
constexpr int FWD_BQ = 128;
__host__ __device__ constexpr int fwd_bk(int D, int DV) {
    return D + DV > 384 ? 64 : 128;
}
__host__ __device__ constexpr int fwd_smem_at(int D, int DV, int stages) {
    return FWD_BQ * D * 2 + stages * fwd_bk(D, DV) * (D + DV) * 2 +
           8 * (1 + 4 * stages) + 1024;
}
__host__ __device__ constexpr int fwd_stages(int D, int DV) {
    return fwd_smem_at(D, DV, 3) <= MAX_SMEM ? 3 : 2;
}
__host__ __device__ constexpr int fwd_smem(int D, int DV) {
    return fwd_smem_at(D, DV, fwd_stages(D, DV));
}

// dk / dv: 128 kv rows a block (64 per consumer warpgroup), q / dO tiles
// of dkv_bq rows with their lse and delta rows through a ring of
// dkv_stages (3 where they fit, else 2).  Where dK's and dV's
// accumulators would not fit beside the step's scores the block walks its
// q tiles in sweeps: at D + Dv <= 256 one (dK and dV), to 384 two (dV,
// then dK), above four (dV's and then dK's column halves).  32-row q
// steps where a sweep holds 128 accumulator registers or more ((128,
// 128), whose 64-row steps spilled), or where two 64-row stages would
// pass the opt-in ((256, 256)); 64 elsewhere.
constexpr int DKV_BKV = 128;
__host__ __device__ constexpr int dkv_sweeps(int D, int DV) {
    return D + DV > 384 ? 4 : D + DV > 256 ? 2 : 1;
}
__host__ __device__ constexpr int dkv_acc_regs(int D, int DV) {
    return dkv_sweeps(D, DV) == 1 ? (D + DV) / 2
           : dkv_sweeps(D, DV) == 2 ? (D > DV ? D : DV) / 2
                                    : (D > DV ? D : DV) / 4;
}
__host__ __device__ constexpr int dkv_smem_at(int D, int DV, int bq,
                                              int stages) {
    return DKV_BKV * (D + DV) * 2 + stages * bq * ((D + DV) * 2 + 2 * 4) +
           8 * (1 + 2 * stages) + 1024;
}
__host__ __device__ constexpr int dkv_bq(int D, int DV) {
    return dkv_acc_regs(D, DV) >= 128 || dkv_smem_at(D, DV, 64, 2) > MAX_SMEM
               ? 32 : 64;
}
__host__ __device__ constexpr int dkv_stages(int D, int DV) {
    return dkv_smem_at(D, DV, dkv_bq(D, DV), 3) <= MAX_SMEM ? 3 : 2;
}
__host__ __device__ constexpr int dkv_smem(int D, int DV) {
    return dkv_smem_at(D, DV, dkv_bq(D, DV), dkv_stages(D, DV));
}

// dq: 128 q rows a block (64 per consumer warpgroup), its q and dO tiles
// loaded once, K and V tiles of dq_bk rows through a ring of dq_stages (3
// where they fit, else 2).  dQ's accumulators take D / 2 registers a
// thread and S and dP BK / 2 each: 64-row kv steps where D + Dv <= 384,
// 32 at (256, 256), where dQ alone is 128 registers.
constexpr int DQ_BQ = 128;
__host__ __device__ constexpr int dq_bk(int D, int DV) {
    return D + DV > 384 ? 32 : 64;
}
__host__ __device__ constexpr int dq_smem_at(int D, int DV, int stages) {
    return DQ_BQ * (D + DV) * 2 + stages * dq_bk(D, DV) * (D + DV) * 2 +
           8 * (1 + 2 * stages) + 1024;
}
__host__ __device__ constexpr int dq_stages(int D, int DV) {
    return dq_smem_at(D, DV, 3) <= MAX_SMEM ? 3 : 2;
}
__host__ __device__ constexpr int dq_smem(int D, int DV) {
    return dq_smem_at(D, DV, dq_stages(D, DV));
}

// The order blocks run in.  A block is a tile of one (batch, head) pair
// (q tile of the forward and the dq pass, kv tile of dk / dv), and the
// pairs are taken in chunks of `chunk` pairs whose streamed operands (the
// forward's and the dq pass's K and V, the dk / dv pass's q, dO, lse and
// delta) fit half the H100's 50 MB L2:
// within a chunk the tiles run heaviest first (tile order 0 first), the
// pairs fastest, so that the blocks in flight share their operands in the
// L2 instead of each reading its own from device memory.  Block i of a
// grid of n_pairs x n_tiles -> (pair, tile order).
constexpr long long L2_BUDGET = 24LL << 20;

__host__ __device__ inline void block_tile(long long i, int n_pairs,
                                           int n_tiles, int chunk,
                                           int& pair, int& tile) {
    const long long per = (long long)chunk * n_tiles;
    const int c = (int)(i / per);
    const int rem = (int)(i - c * per);
    const int left = n_pairs - c * chunk;
    const int pairs = left < chunk ? left : chunk;
    tile = rem / pairs;
    pair = c * chunk + rem % pairs;
}

// pairs per chunk for `bytes` streamed per pair
inline int chunk_pairs(long long bytes) {
    const long long n = L2_BUDGET / (bytes > 0 ? bytes : 1);
    return (int)(n < 1 ? 1 : n > (1 << 30) ? (1 << 30) : n);
}

}  // namespace wgmma_plan

namespace wgmma_host {

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, through the runtime's
// entry-point query: the library links nothing beyond the runtime
inline EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a 4-D view of `ptr`: dims innermost first (the innermost dense), the
// byte strides of dims 1-3, boxes of `box` elements, the given swizzle.
// Out-of-range coordinates read as zeros and are not written.  False
// where the map is refused.
inline bool encode_view(CUtensorMap* map, CUtensorMapDataType type,
                        const void* ptr, const cuuint64_t (&dims)[4],
                        const cuuint64_t (&strides)[3],
                        const cuuint32_t (&box)[4], CUtensorMapSwizzle swz) {
    const EncodeTiled fn = encoder();
    if (!fn) return false;
    // a libcuda call: it needs the device's context current on this thread,
    // which a thread that has made no runtime call yet (autograd's worker
    // running a backward) lacks; cudaFree(nullptr) binds it, once a thread
    static thread_local bool bound = false;
    if (!bound) {
        cudaFree(nullptr);
        bound = true;
    }
    const cuuint32_t ones[4] = {1u, 1u, 1u, 1u};
    return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, ones,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// swizzle_cols 64 / 32 / 16 -> 128- / 64- / 32-byte swizzle, 0 -> none
inline CUtensorMapSwizzle swizzle_of(int swizzle_cols) {
    return swizzle_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
           : swizzle_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
           : swizzle_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// the 4-D (width, heads, seq, batch) view of a contiguous bf16 (batch, seq,
// heads, width) tensor, boxes of box_cols x 1 head x box_rows x 1 batch;
// swizzle_cols as swizzle_of (box_cols equal to it, or 0).
inline bool encode(CUtensorMap* map, const void* ptr, int width, int heads,
                   int seq, int batch, int box_cols, int box_rows,
                   int swizzle_cols) {
    const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t row = (cuuint64_t)width * 2;
    const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
    const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1u, (cuuint32_t)box_rows,
                               1u};
    return encode_view(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims,
                       strides, box, swizzle_of(swizzle_cols));
}

}  // namespace wgmma_host
