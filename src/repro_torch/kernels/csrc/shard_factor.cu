// shard_factor_batch_kernel: the greedy mesh-axis assignment / divisibility
// pass of the columnar sweep, for every shard denominator of one table
// build in one launch.
//
// Replaces the TPU kernel repro/kernels/shard_factor.py::_pallas_kernel
// (driven by _pallas_eval).  That version closes over one request's
// (dim, axis, flag) step list as trace-time constants and compiles once
// per program; a table build asks for a few hundred denominators, each its
// own program and operands.  Here the build's requests are packed on the
// host into one set of buffers (one upload) and evaluated by one launch
// whose grid runs over (request, tile of SF_TILE cells); the programs are
// DATA read from device memory, so one compilation serves every program.
//
// What it computes, per cell i of a request: walk the steps in order; step
// (d, a, flag) applies mesh axis a (size s = sizes[a][i]) to dim d iff
// dims[d][i] % (totals[d] * s) == 0, axis a is still unused in this cell
// and — in the FSDP/ZeRO `extra` pass (flag > 0) — nothing was assigned
// yet for this extra axis (flag 2 opens a new extra axis and resets that
// latch).  The output is the int64 product of applied sizes (the shard
// denominator).
//
// Packed layout (all int64, built by kernels/shard_factor.py, which checks
// every offset, count and limit before the upload):
//   requests[r][REQ_*]  cells n, trailing extent C of the (R, C) cell view,
//                       first output cell, first row descriptor, n_dims,
//                       n_axes, first step, n_steps;
//   rows[k] = (offset, stride over R, stride over C) of one operand row
//                       in `operands` (stride 0 where the operand
//                       broadcasts; the dims rows first, then the sizes);
//   steps[k] = (dim, axis, flag);
//   tiles[b] = (request, first cell): block b's SF_TILE cells.
// A block stages its request's header, row descriptors and program in
// shared memory (one barrier), then each thread takes one cell: operand
// rows with stride 1 over C are read coalesced along the cells, broadcast
// rows hit one address.  Each output cell is written by one thread, with
// no atomics, so a second launch is bit-equal.
//
// Integer arithmetic: every operand, running product and test is int64,
// as in the host path (numpy int64).  There is no 32-bit path: a test in
// 32 bits would be right only where every dim, size and running product
// is below 2^31, and the kernel would have to be told so per request; at
// these sizes the 64-bit remainder is not what bounds the launch.
//
// What bounds it on an H100: bytes — the compact operands, descriptors,
// programs and tiles are read once and 8 bytes per cell are written —
// against a few int64 operations per step and cell.  For a table build
// (a few hundred requests, ~10^5-10^6 cells) that is a few microseconds of
// memory time at most, so the launch and its latency are the cost; the
// per-thread state (totals, used mask, latch) stays in registers — the
// dim/axis selects are unrolled compare-and-pick chains so no array is
// indexed dynamically and nothing spills to local memory.
//
// Sizes must be >= 1 (a mesh axis size); the kernel does not guard a zero.

#include <cuda_runtime.h>

#define SF_MAX_DIMS 8
#define SF_MAX_AXES 8
#define SF_MAX_STEPS 128
#define SF_TILE 256
#define SF_REQ_FIELDS 8

enum { REQ_N, REQ_C, REQ_OUT, REQ_ROW, REQ_DIMS, REQ_AXES, REQ_STEP,
       REQ_STEPS };

template <int N>
__device__ __forceinline__ long long pick(const long long (&v)[N], int k) {
    long long r = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) r = (j == k) ? v[j] : r;
    return r;
}

__global__ void __launch_bounds__(SF_TILE)
shard_factor_batch_kernel(const long long* __restrict__ operands,
                          const long long* __restrict__ rows,
                          const long long* __restrict__ requests,
                          const long long* __restrict__ steps,
                          const long long* __restrict__ tiles,
                          long long* __restrict__ out) {
    __shared__ long long req[SF_REQ_FIELDS];
    __shared__ long long row[SF_MAX_DIMS + SF_MAX_AXES][3];
    __shared__ unsigned char sdim[SF_MAX_STEPS], saxis[SF_MAX_STEPS],
        sflag[SF_MAX_STEPS];
    const int t = threadIdx.x;
    const long long r = tiles[2 * (long long)blockIdx.x];
    const long long first = tiles[2 * (long long)blockIdx.x + 1];
    if (t < SF_REQ_FIELDS) req[t] = requests[r * SF_REQ_FIELDS + t];
    __syncthreads();
    const int n_dims = (int)req[REQ_DIMS], n_axes = (int)req[REQ_AXES];
    const int n_steps = (int)req[REQ_STEPS];
    const long long* rp = rows + 3 * req[REQ_ROW];
    for (int k = t; k < 3 * (n_dims + n_axes); k += SF_TILE)
        row[k / 3][k % 3] = rp[k];
    const long long* sp = steps + 3 * req[REQ_STEP];
    for (int k = t; k < n_steps; k += SF_TILE) {
        sdim[k] = (unsigned char)sp[3 * k];
        saxis[k] = (unsigned char)sp[3 * k + 1];
        sflag[k] = (unsigned char)sp[3 * k + 2];
    }
    __syncthreads();
    const long long c = first + t;
    if (c >= req[REQ_N]) return;
    const long long ri = c / req[REQ_C], ci = c - ri * req[REQ_C];

    long long d[SF_MAX_DIMS], s[SF_MAX_AXES], totals[SF_MAX_DIMS];
#pragma unroll
    for (int k = 0; k < SF_MAX_DIMS; ++k) {
        d[k] = (k < n_dims)
                   ? operands[row[k][0] + ri * row[k][1] + ci * row[k][2]]
                   : 1;
        totals[k] = 1;
    }
#pragma unroll
    for (int k = 0; k < SF_MAX_AXES; ++k) {
        const int j = n_dims + k;
        s[k] = (k < n_axes)
                   ? operands[row[j][0] + ri * row[j][1] + ci * row[j][2]]
                   : 1;
    }

    unsigned used = 0u;
    bool assigned = false;
    long long denom = 1;
    for (int k = 0; k < n_steps; ++k) {
        const int dd = sdim[k], a = saxis[k], fl = sflag[k];
        if (fl == 2) assigned = false;
        const long long sv = pick(s, a);
        const long long tot = pick(totals, dd);
        bool ok = (pick(d, dd) % (tot * sv) == 0) && !((used >> a) & 1u);
        if (fl) ok = ok && !assigned;
        if (ok) {
#pragma unroll
            for (int j = 0; j < SF_MAX_DIMS; ++j)
                totals[j] = (j == dd) ? tot * sv : totals[j];
            denom *= sv;
            used |= 1u << a;
            if (fl) assigned = true;
        }
    }
    out[req[REQ_OUT] + c] = denom;
}

// Plain C entry point: every pointer is a device pointer to the packed
// int64 buffers; `n_tiles` blocks of SF_TILE threads.  Returns the
// launch's cudaGetLastError() (0 on success), or -1 for a grid it cannot
// launch (the Python wrapper checks the packed buffers first and raises).
extern "C" int shard_factor_batch_launch(const long long* operands,
                                         const long long* rows,
                                         const long long* requests,
                                         const long long* steps,
                                         const long long* tiles,
                                         long long* out, long long n_tiles,
                                         void* stream) {
    if (n_tiles < 1 || n_tiles > 2147483647LL) return -1;
    shard_factor_batch_kernel<<<(unsigned)n_tiles, SF_TILE, 0,
                                (cudaStream_t)stream>>>(
        operands, rows, requests, steps, tiles, out);
    return (int)cudaGetLastError();
}

extern "C" int shard_factor_limits(int* max_dims, int* max_axes,
                                   int* max_steps, int* tile) {
    *max_dims = SF_MAX_DIMS;
    *max_axes = SF_MAX_AXES;
    *max_steps = SF_MAX_STEPS;
    *tile = SF_TILE;
    return 0;
}
