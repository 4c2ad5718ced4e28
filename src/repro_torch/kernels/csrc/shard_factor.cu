// shard_factor_kernel: the greedy mesh-axis assignment / divisibility pass
// of the columnar sweep, one thread per cell.
//
// Replaces the TPU kernel repro/kernels/shard_factor.py::_pallas_kernel
// (driven by _pallas_eval).  That version closes over the (dim, axis, flag)
// step list as trace-time constants and compiles once per program; a sweep
// walks hundreds of distinct programs, so this one reads the program as
// DATA — a small byte-packed struct passed by value in the kernel-parameter
// space (constant bank, broadcast to every thread, no device allocation and
// no host-to-device copy per launch) — and compiles once.
//
// What it computes, per cell i of a flat domain of n cells: walk the steps
// in order; step (d, a, flag) applies mesh axis a (size s = sizes[a][i]) to
// dim d iff dims[d][i] % (totals[d] * s) == 0, axis a is still unused in
// this cell and — in the FSDP/ZeRO `extra` pass (flag > 0) — nothing was
// assigned yet for this extra axis (flag 2 opens a new extra axis and
// resets that latch).  The output is the int64 product of applied sizes
// (the shard denominator).
//
// Layout: dims is (n_dims, n) and sizes is (n_axes, n), int64 row-major, so
// neighbouring threads read neighbouring addresses of each row (coalesced
// along n).  The tail is masked by the grid-stride loop bound; no padding.
//
// What bounds it on an H100: bytes.  Each input is read once and the output
// written once: (n_dims + n_axes + 1) * 8 * n bytes against a few dozen
// int64 ops per step.  At the sweep's sizes (n <= a few thousand cells per
// call) that is well under a microsecond of memory time, so the launch
// itself is the cost; the per-thread state (totals, used mask, latch) stays
// in registers — the dim/axis selects are unrolled compare-and-pick chains
// so no array is indexed dynamically and nothing spills to local memory.
//
// Sizes must be >= 1 (a mesh axis size); the kernel does not guard a zero.

#include <cuda_runtime.h>

#define SF_MAX_DIMS 8
#define SF_MAX_AXES 8
#define SF_MAX_STEPS 128

struct ShardProgram {
    int n_steps;
    unsigned char dim[SF_MAX_STEPS];
    unsigned char axis[SF_MAX_STEPS];
    unsigned char flag[SF_MAX_STEPS];
};

template <int N>
__device__ __forceinline__ long long pick(const long long (&v)[N], int k) {
    long long r = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) r = (j == k) ? v[j] : r;
    return r;
}

__global__ void shard_factor_kernel(const long long* __restrict__ dims,
                                    const long long* __restrict__ sizes,
                                    long long* __restrict__ out,
                                    int n_dims, int n_axes, long long n,
                                    const ShardProgram prog) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        long long d[SF_MAX_DIMS], s[SF_MAX_AXES], totals[SF_MAX_DIMS];
#pragma unroll
        for (int k = 0; k < SF_MAX_DIMS; ++k) {
            d[k] = (k < n_dims) ? dims[(long long)k * n + i] : 1;
            totals[k] = 1;
        }
#pragma unroll
        for (int k = 0; k < SF_MAX_AXES; ++k)
            s[k] = (k < n_axes) ? sizes[(long long)k * n + i] : 1;

        unsigned used = 0u;
        bool assigned = false;
        long long denom = 1;
        for (int k = 0; k < prog.n_steps; ++k) {
            const int dd = prog.dim[k], a = prog.axis[k], fl = prog.flag[k];
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
        out[i] = denom;
    }
}

// Plain C entry point.  `steps` is a HOST pointer to n_steps (dim, axis,
// flag) int32 triples; dims/sizes/out are device pointers.  Returns the
// launch's cudaGetLastError() (0 on success), or -1 when a limit is
// exceeded (the Python wrapper checks the limits first and raises).
extern "C" int shard_factor_launch(const long long* dims,
                                   const long long* sizes,
                                   const int* steps, long long* out,
                                   int n_dims, int n_axes, int n_steps,
                                   long long n, void* stream) {
    if (n_dims < 1 || n_dims > SF_MAX_DIMS || n_axes < 1 ||
        n_axes > SF_MAX_AXES || n_steps < 1 || n_steps > SF_MAX_STEPS ||
        n < 1)
        return -1;
    ShardProgram prog;
    prog.n_steps = n_steps;
    for (int k = 0; k < n_steps; ++k) {
        const int dd = steps[3 * k], a = steps[3 * k + 1],
                  fl = steps[3 * k + 2];
        if (dd < 0 || dd >= n_dims || a < 0 || a >= n_axes || fl < 0 ||
            fl > 2)
            return -1;
        prog.dim[k] = (unsigned char)dd;
        prog.axis[k] = (unsigned char)a;
        prog.flag[k] = (unsigned char)fl;
    }
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond that
    shard_factor_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(dims, sizes, out, n_dims,
                                                  n_axes, n, prog);
    return (int)cudaGetLastError();
}

extern "C" int shard_factor_limits(int* max_dims, int* max_axes,
                                   int* max_steps) {
    *max_dims = SF_MAX_DIMS;
    *max_axes = SF_MAX_AXES;
    *max_steps = SF_MAX_STEPS;
    return 0;
}
