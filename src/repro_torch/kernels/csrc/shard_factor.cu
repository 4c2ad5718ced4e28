// shard_factor_batch_kernel: the greedy mesh-axis assignment / divisibility
// pass of the columnar sweep, for every shard denominator of one table
// build in one launch.
//
// Replaces the TPU kernel repro/kernels/shard_factor.py::_pallas_kernel
// (driven by _pallas_eval, pallas_call at :162).  That version closes over
// one request's (dim, axis, flag) step list as trace-time constants and
// compiles once per program; a table build asks for a few hundred
// denominators, each its own program and operands.  Here the build's
// requests are packed on the host into one set of buffers (one upload) and
// evaluated by one launch; the programs are DATA, so one compilation
// serves every program.
//
// What it computes, per cell i of a request: walk the steps in order; step
// (d, a, flag) applies mesh axis a (size s = sizes[a][i]) to dim d iff
// s divides the quotient q[d] = dims[d][i] / (the sizes applied to d so
// far), axis a is still unused in this cell and — in the FSDP/ZeRO `extra`
// pass (flag > 0) — nothing was assigned yet for this extra axis (flag 2
// opens a new extra axis and resets that latch); an applied step divides
// q[d] by s.  The output is the int64 product of applied sizes (the shard
// denominator).  Keeping the quotient rather than the applied product is
// exact (a factor is applied only where it divides): it is the scalar
// reference's test, with no running product that could pass 2^63.
//
// Division-free divisibility.  Write s = 2^k o with o odd (k = the count
// of trailing zeros of s).  s divides q iff m = q >> k has m << k == q and
// o divides m; with o^-1 the inverse of o mod 2^64, x = m o^-1 (mod 2^64)
// is m / o when o divides m, and x o < 2^64 (__umul64hi(x, o) == 0) iff
// it does — x is then the new quotient.  A shift, two multiplies and a
// compare, no divide (sm_90 has no integer divide; the per-cell kernel
// this replaces ran nvcc's remainder routine at every step).  The host
// packs o^-1 beside every operand (`inverses`, the same index as
// `operands`).  Where every operand a request reads is below 2^32 (the
// host's `wide` 0: every request of the sweeps) the same identity runs in
// 32-bit words, on the inverse's low half: the quotients never exceed
// their dim, so nothing is lost; the 64-bit words serve the rest.
//
// Packed layout (all int64, built by kernels/shard_factor.py, which checks
// every offset, count, limit and flag before the upload and derives
// `inverses`, `wide` and `tiles` itself):
//   requests[r][REQ_*]  cells n, trailing extent C of the (R, C) cell view,
//                       first output cell, first row descriptor, n_dims,
//                       n_axes, first step, n_steps;
//   wide[r]           = 1 where an operand request r reads is >= 2^32;
//   rows[k] = (offset, stride over R, stride over C) of one operand row
//                       in `operands` (stride 0 where the operand
//                       broadcasts; the dims rows first, then the sizes);
//   inverses[i]       = o^-1 of operands[i] (0 where operands[i] < 1);
//   steps[k] = (dim, axis, flag);
//   tiles[b] = (request, first cell, its row ri, its column ci, and the
//                       request's first row descriptor, first step,
//                       n_dims + n_axes and n_steps): SF_TILE cells of one
//                       request, in request order.
//
// Design.  Persistent blocks, SF_BLOCKS_PER_SM an SM, each walking a
// contiguous range of tiles in order, the next tile's entry loaded while
// the current one runs; a block stages a request's row descriptors and
// program in shared memory once per request it meets (the tile entry
// carries the program's place, so those loads start beside the request
// header's).  A thread takes SF_CELLS consecutive cells along C — one
// where the tile holds at most SF_THREADS cells, a small request's, whose
// chain is then the shorter — with its first cell's (ri, ci) from the
// tile's by one compare (C >= SF_TILE) or one 32-bit multiply-high by
// ceil(2^32 / C) (exact for the < 2^16 offsets a tile has; one 32-bit
// divide when a block stages the request), then stepped: no cell index is
// divided.  The cells' quotients live in registers; a step's
// dim is block-uniform, so it picks its dim's registers by a uniform
// switch, not select chains; each step's sizes and inverses are loaded a
// step ahead, in flight while the step before runs, and the cells' step
// chains are independent, so they overlap.  The 64-bit path takes the
// thread's cells one after another, to keep its registers to one cell's.
// Each output cell is written by one thread, with no atomics, so a second
// launch is bit-equal.
//
// What bounds it on an H100 80GB HBM3 (700 W): bytes — the operands and
// the programs read once and 8 bytes per cell written, 6.2 MB and 1.85 us
// at 3.35 TB/s at the sweeps' largest build (97 requests, 771,420 cells) —
// but it runs at ~1/6 of that: ~11 us alone there, against 35.4 us for
// the per-cell kernel it replaces (int64 remainder at every step, one cell
// a thread), ~35 instructions a cell-step against ~146, and ~3.7 us
// against 4.3 on a small search build (50 requests of 20 cells), which is
// the chain of dependent loads from the launch (PERF.md § 6, row 1).
//
// Limits (the wrapper refuses anything beyond them): dims in [0, 2^62],
// sizes >= 1, at most SF_MAX_DIMS dims, SF_MAX_AXES axes and SF_MAX_STEPS
// steps a request, fewer than 2^31 packed operands (32-bit indices).

#include <cuda_runtime.h>

#define SF_MAX_DIMS 8
#define SF_MAX_AXES 8
#define SF_MAX_STEPS 128
#define SF_THREADS 128
#define SF_CELLS 4
#define SF_TILE (SF_THREADS * SF_CELLS)
#define SF_BLOCKS_PER_SM 4
#define SF_REQ_FIELDS 8
#define SF_TILE_FIELDS 8
#define SF_LATCH 0x80000000u        // the extra pass's `assigned`, in `used`

enum { REQ_N, REQ_C, REQ_OUT, REQ_ROW, REQ_DIMS, REQ_AXES, REQ_STEP,
       REQ_STEPS };

typedef unsigned long long u64;

// the step's test and update on one cell, branch-free: s = 2^k o divides
// q iff (q >> k) << k == q and x = (q >> k) o^-1 has x o below the word;
// an extra-pass step's `free` and `bits` also hold the latch
__device__ __forceinline__ void sf_step(unsigned& q, unsigned s,
                                        unsigned inv, unsigned free,
                                        unsigned bits, unsigned& used,
                                        u64& den) {
    const int k = __ffs(s) - 1;                     // s >= 1
    const unsigned m = q >> k, x = m * inv;
    const bool ok = ((m << k) == q) & (__umulhi(x, s >> k) == 0u)
                    & ((used & free) == 0u);
    q = ok ? x : q;
    den = ok ? den * s : den;
    used = ok ? used | bits : used;
}

__device__ __forceinline__ void sf_step(u64& q, u64 s, u64 inv,
                                        unsigned free, unsigned bits,
                                        unsigned& used, u64& den) {
    const int k = __ffsll((long long)s) - 1;
    const u64 m = q >> k, x = m * inv;
    const bool ok = ((m << k) == q) & (__umul64hi(x, s >> k) == 0ull)
                    & ((used & free) == 0u);
    q = ok ? x : q;
    den = ok ? den * s : den;
    used = ok ? used | bits : used;
}

// the low 32 bits of an int64 (little-endian): the whole value where the
// request reads none of 2^32 or more
__device__ __forceinline__ unsigned sf_lo(const void* base, unsigned idx) {
    return __ldg((const unsigned*)base + 2 * (u64)idx);
}

struct SfTile {                     // one thread's cells of one tile
    unsigned rj[SF_CELLS], cj[SF_CELLS];
    long long valid;                // cells of the thread in the request
    long long* out;
};

__device__ __forceinline__ unsigned sf_index(const uint4& d, unsigned r,
                                             unsigned c) {
    return d.x + r * d.y + c * d.z;
}

// every operand of the request below 2^32: 32-bit quotients in
// registers, NC cells at once; each step's sizes and inverses (low words)
// read a step ahead, in flight while the step before runs
template <int NC>
__device__ __forceinline__ void sf_cells32(
    const long long* __restrict__ operands, const u64* __restrict__ inverses,
    const uint4* sdesc, const unsigned* sstep, int nd, int ns,
    const SfTile& c) {
    unsigned q[SF_MAX_DIMS][NC];
#pragma unroll
    for (int k = 0; k < SF_MAX_DIMS; ++k) {
#pragma unroll
        for (int j = 0; j < NC; ++j) q[k][j] = 0u;
        if (k < nd) {
            const uint4 dd = sdesc[k];
#pragma unroll
            for (int j = 0; j < NC; ++j)
                q[k][j] = sf_lo(operands, sf_index(dd, c.rj[j], c.cj[j]));
        }
    }
    unsigned used[NC], sn[NC], in[NC], stn = 0u;
    u64 den[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        used[j] = 0u;
        den[j] = 1ull;
    }
#define SF_FETCH(K)                                                       \
    {                                                                     \
        stn = sstep[K];                                                   \
        const uint4 dd = sdesc[nd + ((stn >> 8) & 0xffu)];                \
        _Pragma("unroll") for (int j = 0; j < NC; ++j) {                  \
            const unsigned idx = sf_index(dd, c.rj[j], c.cj[j]);          \
            sn[j] = sf_lo(operands, idx);                                 \
            in[j] = sf_lo(inverses, idx);                                 \
        }                                                                 \
    }
    if (ns > 0) SF_FETCH(0)
    for (int k = 0; k < ns; ++k) {
        const unsigned st = stn;
        unsigned s[NC], inv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            s[j] = sn[j];
            inv[j] = in[j];
        }
        if (k + 1 < ns) SF_FETCH(k + 1)
        const unsigned fl = st >> 16, bit = 1u << ((st >> 8) & 0xffu);
        const unsigned flags = fl ? bit | SF_LATCH : bit;
        if (fl == 2u) {
#pragma unroll
            for (int j = 0; j < NC; ++j) used[j] &= ~SF_LATCH;
        }
        switch (st & 0xffu) {          // block-uniform
#define SF_DIM(D)                                                         \
    case D:                                                               \
        _Pragma("unroll") for (int j = 0; j < NC; ++j)                    \
            sf_step(q[D][j], s[j], inv[j], flags, flags, used[j], den[j]); \
        break;
            SF_DIM(0) SF_DIM(1) SF_DIM(2) SF_DIM(3)
            SF_DIM(4) SF_DIM(5) SF_DIM(6) SF_DIM(7)
#undef SF_DIM
        }
    }
#undef SF_FETCH
#pragma unroll
    for (int j = 0; j < NC; ++j)
        if (j < c.valid) c.out[j] = (long long)den[j];
}

// a request that reads an operand of 2^32 or more: 64-bit quotients, the
// thread's cells one after another (registers for one cell's state)
__device__ __forceinline__ void sf_cells64(
    const long long* __restrict__ operands, const u64* __restrict__ inverses,
    const uint4* sdesc, const unsigned* sstep, int nd, int ns,
    const SfTile& c) {
#pragma unroll
    for (int j = 0; j < SF_CELLS; ++j) {
        if (j >= c.valid) break;
        u64 q[SF_MAX_DIMS];
#pragma unroll
        for (int k = 0; k < SF_MAX_DIMS; ++k)
            q[k] = k < nd ? (u64)__ldg(operands + sf_index(sdesc[k], c.rj[j],
                                                           c.cj[j]))
                          : 0ull;
        unsigned used = 0u;
        u64 den = 1ull;
        for (int k = 0; k < ns; ++k) {
            const unsigned st = sstep[k];
            const unsigned a = (st >> 8) & 0xffu, fl = st >> 16;
            const unsigned idx = sf_index(sdesc[nd + a], c.rj[j], c.cj[j]);
            const u64 s = (u64)__ldg(operands + idx), inv = __ldg(inverses
                                                                 + idx);
            const unsigned flags = fl ? (1u << a) | SF_LATCH : 1u << a;
            if (fl == 2u) used &= ~SF_LATCH;
            switch (st & 0xffu) {      // block-uniform
#define SF_DIM(D)                                                         \
    case D:                                                               \
        sf_step(q[D], s, inv, flags, flags, used, den);                   \
        break;
                SF_DIM(0) SF_DIM(1) SF_DIM(2) SF_DIM(3)
                SF_DIM(4) SF_DIM(5) SF_DIM(6) SF_DIM(7)
#undef SF_DIM
            }
        }
        c.out[j] = (long long)den;
    }
}

__global__ void __launch_bounds__(SF_THREADS, SF_BLOCKS_PER_SM)
shard_factor_batch_kernel(const long long* __restrict__ operands,
                          const u64* __restrict__ inverses,
                          const long long* __restrict__ rows,
                          const long long* __restrict__ requests,
                          const long long* __restrict__ wide_of,
                          const long long* __restrict__ steps,
                          const long long* __restrict__ tiles,
                          long long n_tiles, long long* __restrict__ out) {
    __shared__ unsigned sstep[SF_MAX_STEPS];  // dim | axis << 8 | flag << 16
    __shared__ uint4 sdesc[SF_MAX_DIMS + SF_MAX_AXES];  // offset, s0, s1
    const int t = threadIdx.x;
    // this block's contiguous range of tiles (n_tiles < 2^31)
    const unsigned per = (unsigned)n_tiles / gridDim.x;
    const unsigned rem = (unsigned)n_tiles - per * gridDim.x;
    const long long lo = (long long)per * blockIdx.x
                         + (blockIdx.x < rem ? blockIdx.x : rem);
    const long long hi = lo + per + (blockIdx.x < rem);
    long long staged = -1, n = 0, C = 1, obase = 0;
    unsigned cmul = 0;
    int nd = 0, ns = 0;
    bool wide = true;
    long long e[SF_TILE_FIELDS] = {};
    if (lo < hi) {
#pragma unroll
        for (int f = 0; f < SF_TILE_FIELDS; ++f)
            e[f] = __ldg(tiles + SF_TILE_FIELDS * lo + f);
    }
    for (long long b = lo; b < hi; ++b) {
        long long e0[SF_TILE_FIELDS];
#pragma unroll
        for (int f = 0; f < SF_TILE_FIELDS; ++f) e0[f] = e[f];
        const long long r = e0[0], first = e0[1], ri0 = e0[2], ci0 = e0[3];
        if (b + 1 < hi) {                  // the next tile's entry, ahead
#pragma unroll
            for (int f = 0; f < SF_TILE_FIELDS; ++f)
                e[f] = __ldg(tiles + SF_TILE_FIELDS * (b + 1) + f);
        }
        if (r != staged) {                 // block-uniform
            __syncthreads();               // every thread done with the old
            // the program's place and counts come with the tile, so its
            // loads start with the request header's, not after them
            const long long row = e0[4], step0 = e0[5];
            const int n_rows = (int)e0[6];
            ns = (int)e0[7];
            const long long* rq = requests + SF_REQ_FIELDS * r;
            n = __ldg(rq + REQ_N);
            C = __ldg(rq + REQ_C);
            obase = __ldg(rq + REQ_OUT);
            wide = __ldg(wide_of + r) != 0;
            nd = (int)__ldg(rq + REQ_DIMS);
            if (t < n_rows) {
                const long long* dr = rows + 3 * (row + t);
                sdesc[t] = make_uint4((unsigned)__ldg(dr),
                                      (unsigned)__ldg(dr + 1),
                                      (unsigned)__ldg(dr + 2), 0u);
            }
            for (int k = t; k < ns; k += SF_THREADS) {
                const long long* sp = steps + 3 * (step0 + k);
                sstep[k] = (unsigned)__ldg(sp)
                           | ((unsigned)__ldg(sp + 1) << 8)
                           | ((unsigned)__ldg(sp + 2) << 16);
            }
            // ceil(2^32 / C) = floor((2^32 - 1) / C) + 1, C in [2, SF_TILE)
            cmul = C >= 2 && C < SF_TILE ? 0xffffffffu / (unsigned)C + 1u
                                         : 0u;
            __syncthreads();
            staged = r;
        }
        // a tile of at most SF_THREADS cells (a small request's) takes one
        // cell a thread, the shorter chain; a full one SF_CELLS (block-
        // uniform)
        const bool one = n - first <= SF_THREADS;
        const int nc = one ? 1 : SF_CELLS;
        const long long c0 = first + (long long)t * nc;
        if (c0 >= n) continue;
        // (ri, ci) of the thread's first cell, from the tile's: the offset
        // u < C + SF_TILE crosses at most one row when C >= SF_TILE, and is
        // below 2^16 otherwise, where cmul divides it exactly
        const long long u = ci0 + (long long)t * nc;
        long long ri, ci;
        if (C >= SF_TILE) {
            const bool w = u >= C;
            ri = ri0 + w;
            ci = w ? u - C : u;
        } else if (C == 1) {
            ri = ri0 + u;
            ci = 0;
        } else {
            const unsigned d = __umulhi((unsigned)u, cmul);
            ri = ri0 + d;
            ci = u - (long long)d * C;
        }
        // 32-bit views: an operand index is < 2^31, so its sum taken mod
        // 2^32 is the index; cells past the request read its first one
        SfTile cells;
        cells.valid = one ? 1 : n - c0;
        cells.out = out + obase + c0;
#pragma unroll
        for (int j = 0; j < SF_CELLS; ++j) {
            const bool v = j < cells.valid;
            cells.rj[j] = v ? (unsigned)ri : 0u;
            cells.cj[j] = v ? (unsigned)ci : 0u;
            if (++ci == C) {
                ci = 0;
                ++ri;
            }
        }
        if (wide)                          // block-uniform
            sf_cells64(operands, inverses, sdesc, sstep, nd, ns, cells);
        else if (one)
            sf_cells32<1>(operands, inverses, sdesc, sstep, nd, ns, cells);
        else
            sf_cells32<SF_CELLS>(operands, inverses, sdesc, sstep, nd, ns,
                                 cells);
    }
}

// Plain C entry point: every pointer is a device pointer to the packed
// int64 buffers; `n_tiles` tiles over min(n_tiles, SMs x SF_BLOCKS_PER_SM)
// persistent blocks of SF_THREADS threads.  Returns the launch's
// cudaGetLastError() (0 on success), a CUDA error of the device query, or
// -1 for a grid it cannot launch (the Python wrapper checks the packed
// buffers first and raises).
extern "C" int shard_factor_batch_launch(const long long* operands,
                                         const long long* inverses,
                                         const long long* rows,
                                         const long long* requests,
                                         const long long* wide,
                                         const long long* steps,
                                         const long long* tiles,
                                         long long* out, long long n_tiles,
                                         void* stream) {
    if (n_tiles < 1 || n_tiles > 2147483647LL) return -1;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long slots = (long long)sms * SF_BLOCKS_PER_SM;
    const long long grid = n_tiles < slots ? n_tiles : slots;
    shard_factor_batch_kernel<<<(unsigned)grid, SF_THREADS, 0,
                                (cudaStream_t)stream>>>(
        operands, (const u64*)inverses, rows, requests, wide, steps, tiles,
        n_tiles, out);
    return (int)cudaGetLastError();
}

// The kernel's limits and shape, for the wrapper to hold its own to.
extern "C" int shard_factor_limits(int* max_dims, int* max_axes,
                                   int* max_steps, int* tile, int* threads,
                                   int* cells, int* blocks_per_sm) {
    *max_dims = SF_MAX_DIMS;
    *max_axes = SF_MAX_AXES;
    *max_steps = SF_MAX_STEPS;
    *tile = SF_TILE;
    *threads = SF_THREADS;
    *cells = SF_CELLS;
    *blocks_per_sm = SF_BLOCKS_PER_SM;
    return 0;
}
