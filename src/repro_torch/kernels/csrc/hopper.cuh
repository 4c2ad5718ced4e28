// Building blocks of the Hopper flash kernels (flash_attention_wgmma.cu),
// as inline PTX for sm_90a: mbarriers, TMA tensor copies, wgmma shared-memory
// descriptors, fences and waits, named barriers and setmaxnreg.
//
// Accumulator layout of wgmma.m64nNk16 (fp32 d, PTX ISA "Matrix fragment
// for wgmma"): warp w of the warpgroup owns rows 16w..16w+15; lane l, g =
// l / 4, t = l % 4, holds for every 8-column n-tile j the registers
// d[4j], d[4j+1] = D[16w+g][8j+2t, 8j+2t+1] and d[4j+2], d[4j+3] =
// D[16w+g+8][8j+2t, 8j+2t+1] — each n-tile the C fragment of
// mma.m16n8k16 (tensor_core.cuh).  The A operand from registers (64 x 16
// bf16 a k-step) has the A fragment of mma.m16n8k16 in each warp, so the
// accumulators of n-tiles 2kk and 2kk+1 pack into the A operand of k-step
// kk without leaving registers: a0 = (d[8kk], d[8kk+1]), a1 = (d[8kk+2],
// d[8kk+3]), a2 = (d[8kk+4], d[8kk+5]), a3 = (d[8kk+6], d[8kk+7]).
//
// Shared-memory operands come as TMA writes them: a tile of R rows and C
// columns (C a multiple of the swizzle width W = 64, 32 or 16 bf16, i.e.
// 128-, 64- or 32-byte swizzle) is C / W boxes of R rows x W columns, one
// after the other, each box rows of 2W bytes.  CUTLASS's canonical GMMA
// layouts give the descriptors (units of 16 bytes in the fields):
//   * K-major (the reduction dim contiguous: q, k for q k^T): rows 2W
//     bytes apart, 8-row groups SBO = 16W bytes apart; a k-step of 16
//     columns advances the start address by 32 bytes inside a box, to the
//     next box after W / 16 steps; LBO unused.
//   * MN-major (the output columns contiguous: v for P v): N runs along a
//     box's W columns and on to the next box LBO = 2WR bytes further; K
//     runs down the rows (2W bytes apart), 8-row groups SBO = 16W apart; a
//     k-step of 16 rows advances the start by 32W bytes.
// Every box starts on a 1,024-byte boundary, so the swizzle's phase
// (address bits 7-9) is the descriptor's base offset 0.

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hw {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// arrive and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// arrive where `pred` holds, without a branch around the arrival (a
// branch would put the surrounding wgmma in a divergent path, which ptxas
// serialises)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
        :: "r"(bar), "r"((uint32_t)pred) : "memory");
}

// wait until the barrier's phase with the given parity has completed: the
// spin loop in PTX, so that the code after it is not a divergent path to
// ptxas.  A wait that outlasts 2^26 polls (each try_wait suspends the
// thread for a while first: far longer than any copy or product takes)
// means a broken pipeline: trap, so that the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 n;\nmov.u32 n, 0;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra DONE;\n"
        "add.u32 n, n, 1;\n"
        "setp.lt.u32 p, n, 67108864;\n"
        "@p bra WAIT;\n"
        "trap;\n"
        "DONE:\n}\n"
        :: "r"(bar), "r"(parity) : "memory");
}

// 2^x in one MUFU instruction (ex2.approx.ftz: results below 2^-126 flush
// to 0, where exp2f spends three more instructions on them; a probability
// that small adds nothing next to the row's largest, which is 1)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// the warpgroup of this thread, as a value ptxas knows is the same across
// the warp (a broadcast from lane 0): branches on it are not divergent
__device__ __forceinline__ int warpgroup() {
    return __shfl_sync(0xffffffffu, (int)(threadIdx.x / 128), 0);
}

// ---- TMA ------------------------------------------------------------------

// a box of the 4-D map at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory; completes `bar`'s transactions.  Coordinates past
// the tensor's extent read zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// a box from shared memory to the 4-D map; rows past the tensor's extent
// are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
        "[%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// shared-memory writes of this thread visible to the async proxy (TMA)
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// swizzle width in bf16 columns -> the descriptor's layout type
__host__ __device__ constexpr uint32_t layout_type(int w) {
    return w == 64 ? 1u : w == 32 ? 2u : 3u;     // 128 B, 64 B, 32 B
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t type) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | ((uint64_t)type << 62);
}

// k-step kk (16 columns) of a K-major operand: `rows`-row boxes of W
// columns from `base`, the warpgroup's rows starting at row `row0`
template <int W>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int row0,
                                           int kk) {
    const int col = kk * 16;
    const uint32_t addr = base + (uint32_t)((col / W) * rows * W * 2 +
                                            row0 * W * 2 + (col % W) * 2);
    return make_desc(addr, 16, 16 * W, layout_type(W));
}

// k-step kk (16 rows) of an MN-major operand of `rows`-row boxes of W
// columns from `base`, N across the boxes
template <int W>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kk) {
    return make_desc(base + (uint32_t)(kk * 16 * W * 2), rows * W * 2,
                     16 * W, layout_type(W));
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// registers an asynchronous wgmma writes: no read or write of them moves
// across this point (between the launch and its wait)
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
    #pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
    #pragma unroll
    for (int i = 0; i < R; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// ---- warp specialisation ----------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

}  // namespace hw
