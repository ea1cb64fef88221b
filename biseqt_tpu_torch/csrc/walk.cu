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
// What bounds it on this card.  A walk is a pointer chase: each action
// reads the one nibble at the walker's cursor, and the next cursor
// depends on it.  Per pair that is ~(LS + LT) / 2 dependent reads of one
// byte from a plane of ~1 GB, so a walk that goes to device memory for
// each read is bound by the latency of that memory (~1 us per action),
// not by bandwidth nor by arithmetic.
//
// What the design does about it.  Each action lowers the walker's
// antidiagonal A by 1 (gap) or 2 (diagonal) and moves its lane X by at
// most 1, so the reads of the next D antidiagonals lie in D / 2 + 1 byte
// rows and within D lanes of X.  A warp owns one walker.  It copies
// such a window of the plane (rows of 4D + 1 lanes around X, as aligned
// 4-byte words, clipped to the plane) into shared memory in one round of
// independent asynchronous copies, and one lane then walks through it
// without touching device memory until A leaves the window.  Windows
// are double buffered: while window k is walked, window k + 1 (the next
// D antidiagonals) is already on its way, centred on X at the start of
// window k; with 2D lanes of slack on each side it holds every read of
// both windows.  So a walker pays about one memory round trip per D
// antidiagonals instead of one per action, and the warp walks a run of
// diagonal actions in one pass (below).  The slack makes the copies
// ~(D / 2)(4D + 16) bytes per D antidiagonals: at D = 64 the copies,
// ~1.4 GB per smoke launch, bound the kernel more than the chain of
// windows does.  D = 64 was the fastest of 32, 64 and 128 on an H100
// (0.61, 0.45, 0.67 ms on the smoke's full launch; PERF.md).  The
// walker jumps from one action to the next (the TPU kernel sweeps every
// antidiagonal in lockstep); that is the same walk because every action
// lowers A or ends the walk, and the bytes of steps where a walker does
// not act are 0 (the wrapper zeroes the trace).  Ops are packed four per byte in a
// register and each trace byte is stored once, when its row changes.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int OP_INS = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int D = 64;   // antidiagonals per plane window

// One buffer holds D / 2 + 1 rows of 4D + 16 bytes (4D + 1 lanes with
// the start rounded down to 16 bytes).
struct Window {
    static constexpr int ROWS = D / 2 + 1;
    static constexpr int STRIDE = 4 * D + 16;       // bytes per row
    static constexpr int SIZE = ROWS * STRIDE;      // bytes per buffer
    int r_lo;   // first byte row held
    int x0;     // first lane held (a multiple of 16)

    // Copy the rows of antidiagonals [top - D + 1, top] (top >= 0) and
    // the lanes within 2D of xc into `buf`, 16 bytes per copy, spread
    // over the warp; the caller commits and waits.
    __device__ void fetch(const uint8_t* plane, size_t row_bytes, int W,
                          int top, int xc, uint8_t* buf, int lane) {
        r_lo = max(top - D + 1, 0) >> 1;
        const int rows = (top >> 1) - r_lo + 1;
        const int lo = max(xc - 2 * D, 0), hi = min(xc + 2 * D, W - 1);
        x0 = lo & ~15;
        const int chunks = hi >= lo ? ((hi - x0) >> 4) + 1 : 0;
        for (int k = lane; k < rows * chunks; k += 32) {
            const int r = k / chunks, c = k - r * chunks;
            __pipeline_memcpy_async(
                buf + r * STRIDE + 16 * c,
                plane + (size_t)(r_lo + r) * row_bytes + x0 + 16 * c, 16);
        }
    }
};

// The whole warp runs each walker's loop in lockstep: the walker's state
// is the same in every lane, and only lane 0 stores.  At each position,
// lane k reads the nibble k diagonal steps ahead (antidiagonal A - 2k,
// the same lane X) and a ballot finds the run of diagonal actions that
// starts here, so a run of up to 32 diagonals (the bulk of a homologous
// alignment) takes one pass; any other action is one fused step.
__global__ void walk_kernel(const uint8_t* __restrict__ dirs,
                            const int32_t* __restrict__ dminq,
                            const int32_t* __restrict__ end_i,
                            const int32_t* __restrict__ end_j,
                            int Rp, int B2, int W, int TRb,
                            uint8_t* __restrict__ trace,
                            int32_t* __restrict__ fin_i,
                            int32_t* __restrict__ fin_j) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= 2 * B2) return;   // whole warps
    uint8_t* bufs = smem + (size_t)warp * 2 * Window::SIZE;

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

    if (A >= 0) {
        // the window being walked and the one on its way
        Window wc, wn;
        uint8_t* bc = bufs;
        uint8_t* bn = bufs + Window::SIZE;
        int top = A;
        wc.fetch(plane, row_bytes, W, top, X, bc, lane);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncwarp();
        while (true) {
            // window k + 1, centred on X at the start of window k
            const int next_top = top - D;
            if (next_top >= 0)
                wn.fetch(plane, row_bytes, W, next_top, X, bn, lane);
            __pipeline_commit();
            const int floor_a = top - D + 1;
            while (A >= 0 && A >= floor_a) {
                // X and the parity hold along a diagonal run
                const bool on = X >= 0 && X < W && ((A + X) & 1) == par;
                const int ak = A - 2 * lane;
                const bool held = ak >= 0 && ak >= floor_a;
                int nib = 0;
                if (on && held)
                    nib = (bc[((ak >> 1) - wc.r_lo) * Window::STRIDE
                              + (X - wc.x0)] >> (4 * (ak & 1))) & 15;
                int run = 0;
                if (ST == 0) {
                    // in H a diagonal source acts while i, j > 0
                    const unsigned m = __ballot_sync(
                        FULL, held && (nib & 3) == 1 && I - lane > 0
                                  && J - lane > 0);
                    run = (m == FULL) ? 32 : __ffs(~m) - 1;
                }
                if (run > 0) {
                    // op 1 at antidiagonals A, A - 2, ..., A - 2 (run - 1);
                    // each trace row holds two of them, in lanes k, k + 1
                    const int rk = ak >> 2;
                    const unsigned bit = 1u << (2 * (ak & 3));
                    const unsigned nbit = __shfl_down_sync(FULL, bit, 1);
                    const int nrk = __shfl_down_sync(FULL, rk, 1);
                    const int prk = __shfl_up_sync(FULL, rk, 1);
                    const int r0 = A >> 2;
                    const int rl = (A - 2 * (run - 1)) >> 2;
                    const bool head = lane < run && (lane == 0 || prk != rk);
                    unsigned v = bit | ((lane + 1 < run && nrk == rk) ? nbit
                                                                      : 0u);
                    if (lane == 0 && row == r0) v |= acc;
                    if (head && rk != rl) tr[(size_t)rk * B2] = (uint8_t)v;
                    if (lane == 0 && row >= 0 && row != r0)
                        tr[(size_t)row * B2] = (uint8_t)acc;
                    // the last row stays open
                    const int hl = (run >= 2 && ((A - 2 * (run - 2)) >> 2) == rl)
                                   ? run - 2 : run - 1;
                    acc = __shfl_sync(FULL, v, hl);
                    row = rl;
                    I -= run;
                    J -= run;
                    A -= 2 * run;
                    if (run == 32 || A < 0 || A < floor_a) continue;
                }
                // one fused action at A (pallas_walk.py step_walk): a gap
                // source enters the gap and emits its first op at once
                const int a = A;
                const int byte = __shfl_sync(FULL, nib, run);
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
                        if (row >= 0 && lane == 0)
                            tr[(size_t)row * B2] = (uint8_t)acc;
                        row = a >> 2;
                        acc = 0;
                    }
                    acc |= (unsigned)OP << (2 * (a & 3));
                }
            }
            __pipeline_wait_prior(0);
            __syncwarp();
            if (A < 0) break;
            // A lies in [next_top - 1, next_top]: inside window k + 1
            top = next_top;
            wc = wn;
            uint8_t* done = bc;
            bc = bn;
            bn = done;
        }
    }
    if (lane == 0) {
        if (row >= 0) tr[(size_t)row * B2] = (uint8_t)acc;
        fin_i[b] = I;
        fin_j[b] = J;
    }
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Walks the 2*B2 walkers of a [Rp, B2, W] plane on `stream` (no
// synchronisation) and returns cudaGetLastError().  `trace` is
// [2, TRb, B2] and must be zeroed by the caller; all pointers are
// device pointers; the plane must be 16-byte aligned and W a multiple
// of 16.
extern "C" int bst_walk(const void* dirs, const void* dminq,
                        const void* end_i, const void* end_j, int Rp, int B2,
                        int W, int TRb, void* trace, void* fin_i,
                        void* fin_j, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (B2 <= 0 || Rp <= 0) return 0;
    if (2 * TRb < Rp || W % 16 || reinterpret_cast<uintptr_t>(dirs) % 16)
        return (int)cudaErrorInvalidValue;
    // four warps a block (a few blocks per SM at the smoke's 512
    // walkers, 70 KB of windows)
    constexpr int warps = 4;
    constexpr size_t smem = warps * 2 * (size_t)Window::SIZE;
    err = cudaFuncSetAttribute(walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (2 * B2 + warps - 1) / warps;
    walk_kernel<<<blocks, 32 * warps, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(dirs),
        static_cast<const int32_t*>(dminq),
        static_cast<const int32_t*>(end_i),
        static_cast<const int32_t*>(end_j), Rp, B2, W, TRb,
        static_cast<uint8_t*>(trace), static_cast<int32_t*>(fin_i),
        static_cast<int32_t*>(fin_j));
    return (int)cudaGetLastError();
}
