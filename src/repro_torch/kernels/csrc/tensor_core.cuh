// Building blocks of the bf16 mma.sync kernels (flash_attention_bwd.cu's
// dq pass, ssd.cu; the wgmma kernels take the fragment helpers too):
// asynchronous 16-, 8- and 4-byte copies into shared memory, ldmatrix
// fragment loads and the m16n8k16 bf16 mma of sm_80+ (all in sm_90a), as
// inline PTX.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// for lane l of a warp, g = l / 4, t = l % 4 (PTX ISA, "Matrix fragments
// for mma.m16n8k16"):
//   A (16 x 16, row-major), four .b32 registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   B (16 x 8, k x n), two registers: b0 = B[2t..2t+1][g],
//     b1 = B[2t+8..2t+9][g];
//   C / D (16 x 8 fp32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// The lower 16 bits of a register hold the element of the lower index.
// ldmatrix .x4 loads four 8 x 8 b16 matrices whose rows lanes 0-7, 8-15,
// 16-23 and 24-31 address: register i of lane l holds row l / 4, columns
// 2(l % 4) and 2(l % 4) + 1 of matrix i, or with .trans the transposed
// matrix's (rows 2(l % 4) and 2(l % 4) + 1 of column l / 4).  Hence:
//   * an A operand stored row-major (rows m, columns k) loads with lane l
//     addressing row (l % 8) + 8((l / 8) % 2), column 8(l / 16);
//   * a B operand stored n-major (B[k][n] at row n, column k — K for
//     Q K^T) loads two n-tiles at once with lane l addressing row
//     (l % 8) + 8(l / 16), column 8((l / 8) % 2): registers 0, 1 are b0, b1
//     of n-tile 0 and registers 2, 3 of n-tile 1;
//   * a B operand stored k-major (B[k][n] at row k, column n — V for P V)
//     loads with .trans, lane l addressing row (l % 8) + 8((l / 8) % 2),
//     column 8(l / 16): again b0, b1 of n-tile 0, then of n-tile 1;
//   * an A operand stored k-major (A[m][k] at row k, column m — x for the
//     SSD's x^T B) loads with .trans, lane l addressing the B operand's
//     n-major row (l % 8) + 8(l / 16), column 8((l / 8) % 2).
// A C fragment of 16 x 16 (two n-tiles) packs into the A fragment of the
// next product without leaving registers: a0 = (c0, c1) and a1 = (c2, c3)
// of n-tile 0, a2 and a3 the same of n-tile 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !full the destination is zero-filled and
// nothing is read (src-size 0), so rows past a ragged edge cost no branch.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

// 8 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 8 : 0) : "memory");
}

// 4 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr) : "memory");
}

// c += a . b, bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// two fp32 -> hi = bf16 pair of (a, b), lo = bf16 pair of the remainders
// (a - hi.a, b - hi.b): hi + lo carries ~16 bits of each value
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(a - __bfloat162float(h.x), b - __bfloat162float(h.y));
}

// reductions over the four lanes of a quad (the lanes that share a row
// of a C fragment)
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// lane-dependent parts of the ldmatrix addresses above, in (row, column)
__device__ __forceinline__ int a_row(int lane) {
    return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row(int lane) {
    return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int bn_col(int lane) {
    return ((lane >> 3) & 1) * 8;
}
// the k-major (.trans) B operand uses a_row / a_col, the k-major A operand
// bn_row / bn_col

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace tc
