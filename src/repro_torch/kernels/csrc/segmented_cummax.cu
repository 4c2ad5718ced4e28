// segmented_cummax_kernel: per-cell peak of an alloc/free event program,
// one thread per cell.
//
// Replaces the TPU kernel repro/kernels/segmented_cummax.py::_pallas_kernel
// (driven by _pallas_eval), which unrolls the event axis at trace time over
// a VMEM tile.  Here the event count is a runtime argument, so one compiled
// kernel serves every step kind's program.
//
// What it computes: deltas is (n_events, n) int64 row-major; for each cell
// (column) i the output is max_j sum_{e<=j} deltas[e][i], with the running
// sum taken in event order — int64 adds and maxes, so exact.
//
// What bounds it on an H100: bytes.  (n_events + 1) * 8 * n bytes moved
// against two integer ops per element; each thread walks its column with
// the running sum and running max in registers, and the threads of a warp
// read neighbouring addresses of each row (coalesced).  At the sweep's
// sizes (tens of thousands of cells per pipeline stage) the memory time is
// around a microsecond, so the launch itself is the cost.  The tail is
// masked by the grid-stride loop bound; no padding.

#include <cuda_runtime.h>

__global__ void segmented_cummax_kernel(const long long* __restrict__ deltas,
                                        long long* __restrict__ out,
                                        int n_events, long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        long long run = deltas[i];
        long long peak = run;
        for (int e = 1; e < n_events; ++e) {
            run += deltas[(long long)e * n + i];
            peak = run > peak ? run : peak;
        }
        out[i] = peak;
    }
}

// Plain C entry point: device pointers, returns the launch's
// cudaGetLastError() (0 on success), or -1 on a shape the kernel does not
// take (the Python wrapper checks first and raises).
extern "C" int segmented_cummax_launch(const long long* deltas,
                                       long long* out, int n_events,
                                       long long n, void* stream) {
    if (n_events < 1 || n < 1) return -1;
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;   // grid-stride beyond that
    segmented_cummax_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(deltas, out, n_events,
                                                      n);
    return (int)cudaGetLastError();
}
