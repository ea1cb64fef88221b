// Traceback walk over the packed antidiagonal dirs plane, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels biseqt_tpu/ops/pallas_walk.py::_kernel_t
// (traceback_sweep_t / traceback_sweep_t_fused) and ::_kernel
// (traceback_sweep / traceback_sweep_fused): the two compute one walk
// and differ only in TPU layout; this kernel writes _kernel_t's trace
// layout.  The Python wrapper is biseqt_tpu_torch/ops/walk.py, whose
// plain PyTorch twin (_walk_plain) computes the same bytes.
//
// What bounds it on this card.  A walk is a pointer chase: each step
// reads the one nibble at the walker's cursor, and the next cursor
// depends on it.  Per pair that is ~(LS + LT) dependent loads of one
// byte from a plane of ~1 GB, so the walk is bound by the latency of
// device memory, not by bandwidth (it reads ~20 KB of a pair's
// ~3 MB of plane) nor by arithmetic.
//
// What the design does about it.  One thread per walker reads its own
// byte at its cursor (no transpose and no one-hot extraction: TPU
// machinery).  The TPU kernel sweeps every antidiagonal in lockstep;
// here each walker jumps straight from one action to the next, which
// is the same walk because every action either lowers the cursor's
// antidiagonal or ends the walk, and the bytes of steps where a walker
// does not act are 0 (the wrapper zeroes the trace).  Ops are packed
// four per byte in a register and each trace byte is stored once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_INS = 2;

__global__ void walk_kernel(const uint8_t* __restrict__ dirs,
                            const int32_t* __restrict__ dminq,
                            const int32_t* __restrict__ end_i,
                            const int32_t* __restrict__ end_j,
                            int Rp, int B2, int W, int TRb,
                            uint8_t* __restrict__ trace,
                            int32_t* __restrict__ fin_i,
                            int32_t* __restrict__ fin_j) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= 2 * B2) return;
    const int par = b & 1, col = b >> 1;
    int I = end_i[b], J = end_j[b];
    int A = (I < 0) ? -2 : I + J;
    int X = I - J - dminq[b];
    int ST = 0;          // gap state as the op it emits: 0 H, 2 E, 3 F
    if (A >= 2 * Rp) A = -2;   // beyond the plane: the sweep never acts
    const size_t row_bytes = (size_t)B2 * W;
    const uint8_t* plane = dirs + (size_t)col * W;
    uint8_t* tr = trace + (size_t)par * TRb * B2 + col;
    int row = -1;
    unsigned acc = 0;
    while (A >= 0) {
        const int a = A;
        int byte = 0;
        if (X >= 0 && X < W && ((a + X) & 1) == par)
            byte = (plane[(size_t)(a >> 1) * row_bytes + X] >> (4 * (a & 1)))
                   & 15;
        // one fused action (pallas_walk.py step_walk): a gap source
        // enters the gap and emits its first op at once
        const int src = byte & 3;
        const bool stn = ST != 0;
        const int eff = stn ? ST : src;
        const bool stop = (min(I, J) == 0) || src == 0;
        const bool keep = stn || !stop;
        const int OP = keep ? eff : 0;
        const int di = OP & 1;
        const int dj = ((OP + 1) & 2) ? 1 : 0;
        I -= di;
        J -= dj;
        X += dj - di;
        A = keep ? A - di - dj : -2;
        const bool is_e = OP == OP_INS;
        const int gbit = is_e ? (byte & 4) : (byte & 8);
        const int live = is_e ? J : I;
        ST = ((OP & 2) && gbit && live > 0) ? OP : 0;
        if (OP) {
            if ((a >> 2) != row) {
                if (row >= 0) tr[(size_t)row * B2] = (uint8_t)acc;
                row = a >> 2;
                acc = 0;
            }
            acc |= (unsigned)OP << (2 * (a & 3));
        }
    }
    if (row >= 0) tr[(size_t)row * B2] = (uint8_t)acc;
    fin_i[b] = I;
    fin_j[b] = J;
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Walks the 2*B2 walkers of a [Rp, B2, W] plane on `stream` (no
// synchronisation) and returns cudaGetLastError().  `trace` is
// [2, TRb, B2] and must be zeroed by the caller; all pointers are
// device pointers.
extern "C" int bst_walk(const void* dirs, const void* dminq,
                        const void* end_i, const void* end_j, int Rp, int B2,
                        int W, int TRb, void* trace, void* fin_i,
                        void* fin_j, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B2 <= 0 || Rp <= 0) return 0;
    if (2 * TRb < Rp) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (2 * B2 + threads - 1) / threads;
    walk_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs),
        static_cast<const int32_t*>(dminq),
        static_cast<const int32_t*>(end_i),
        static_cast<const int32_t*>(end_j), Rp, B2, W, TRb,
        static_cast<uint8_t*>(trace), static_cast<int32_t*>(fin_i),
        static_cast<int32_t*>(fin_j));
    return (int)cudaGetLastError();
}
