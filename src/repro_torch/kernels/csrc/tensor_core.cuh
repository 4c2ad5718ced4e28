// Fragment helpers of the bf16 wgmma kernels (flash_attention_wgmma.cu,
// flash_attention_bwd_wgmma.cu, ssd_wgmma.cu), as inline PTX and
// intrinsics: an ldmatrix load, bf16 packing and splitting, quad
// reductions.
//
// Fragment layouts of mma.m16n8k16 (bf16, fp32 accumulate), which wgmma's
// register operands and accumulators repeat per warp (hopper.cuh), for lane
// l of a warp, g = l / 4, t = l % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"):
//   A (16 x 16, row-major), four .b32 registers of two bf16 each:
//     a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9];
//   C / D (16 x 8 fp32): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
// The lower 16 bits of a register hold the element of the lower index.
// ldmatrix .x4 loads four 8 x 8 b16 matrices whose rows lanes 0-7, 8-15,
// 16-23 and 24-31 address; with .trans register i of lane l holds rows
// 2(l % 4) and 2(l % 4) + 1 of column l / 4 of matrix i.  Hence an A
// operand stored k-major (A[m][k] at row k, column m — x for the SSD's
// x^T B) loads with .trans, lane l addressing row (l % 8) + 8(l / 16),
// column 8((l / 8) % 2) (bn_row, bn_col).
// A C fragment of 16 x 16 (two n-tiles) packs into the A fragment of the
// next product without leaving registers: a0 = (c0, c1) and a1 = (c2, c3)
// of n-tile 0, a2 and a3 the same of n-tile 1.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr) : "memory");
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

// lane-dependent parts of the k-major A operand's ldmatrix.trans addresses
__device__ __forceinline__ int bn_row(int lane) {
    return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int bn_col(int lane) {
    return ((lane >> 3) & 1) * 8;
}

constexpr float LOG2E = 1.4426950408889634f;

}  // namespace tc
