// Minor-axis transpose of a uint8 plane for Hopper (sm_90a):
// [R, B, W] -> [R, W, B], out[r][w][b] = in[r][b][w].
//
// Replaces the TPU kernel experiments/transpose_probe.py::tr_kernel
// (launched by run_tr), the probe of what a transposed direction plane
// costs.  The probe's Mosaic leg swaps axes 0 and 1 of its [1, BT, W]
// block, which yields [BT, 1, W] and is refused; its own check
// (transpose(0, 2, 1)) states the function meant, and this kernel
// computes that.  The Python wrapper is
// biseqt_tpu_torch/experiments/transpose_probe.py, whose plain version
// (plane.transpose(1, 2).contiguous()) is also PyTorch's own kernel.
//
// What bounds it on this card.  Every byte is read once and written
// once and no arithmetic is done on it: the kernel is bound by the
// bytes it moves, 2 * R * B * W over the 3.35 TB/s of device memory.
//
// What the design does about it.  One block of 256 threads per
// 128 x 128-byte tile.  Each thread reads four 4-byte words from four
// consecutive rows b (one warp reads 128 contiguous bytes of a row),
// transposes that 4 x 4 byte block in registers with __byte_perm, and
// parks the four transposed words in shared memory; after one barrier
// each warp writes 128 contiguous bytes of an output row.  The shared
// array is [4][32][33] words: the padding column puts the 32 words a
// warp stores (stride 33) and the 32 it loads (stride 1) in 32
// different banks.  Ragged edges are masked (missing words read as 0
// and are never stored).  Where B or W is not a multiple of 4, or a
// base pointer is not 4-byte aligned, the same tiles move byte by byte
// (VEC = false).  Offsets are 64-bit: a plane can pass 2^31 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;          // bytes per tile side
constexpr int WORDS = TILE / 4;    // 32 words per tile side
constexpr int THREADS = 256;       // 32 x 8

template <bool VEC>
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int col,
                                          int n) {
    if (VEC) {
        return col < n ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
    }
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (col + i < n) v |= (uint32_t)row[col + i] << (8 * i);
    return v;
}

template <bool VEC>
__device__ __forceinline__ void store4(uint8_t* row, int col, int n,
                                       uint32_t v) {
    if (VEC) {
        if (col < n) *reinterpret_cast<uint32_t*>(row + col) = v;
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (col + i < n) row[col + i] = (uint8_t)(v >> (8 * i));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
transpose_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int R, int B, int W, int n_tb, int n_tw) {
    __shared__ uint32_t s[4][WORDS][WORDS + 1];
    const int tile = blockIdx.x;
    const int tw = tile % n_tw;
    const int tb = (tile / n_tw) % n_tb;
    const size_t r = (size_t)tile / ((size_t)n_tw * n_tb);
    const int b0 = tb * TILE, w0 = tw * TILE;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const uint8_t* src = in + r * (size_t)B * W;
    uint8_t* dst = out + r * (size_t)B * W;

#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int bw = ty + 8 * k;             // word column of the output
        uint32_t x[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
            const int b = b0 + 4 * bw + rr;
            x[rr] = b < B ? load4<VEC>(src + (size_t)b * W, w0 + 4 * tx, W)
                          : 0u;
        }
        // 4 x 4 byte transpose: y[c] byte rr = x[rr] byte c
        const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);
        const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);
        const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
        const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
        s[0][tx][bw] = __byte_perm(lo01, lo23, 0x5410);
        s[1][tx][bw] = __byte_perm(lo01, lo23, 0x7632);
        s[2][tx][bw] = __byte_perm(hi01, hi23, 0x5410);
        s[3][tx][bw] = __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int qw = ty + 8 * k;             // word column of the input
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int w = w0 + 4 * qw + c;
            if (w < W)
                store4<VEC>(dst + (size_t)w * B, b0 + 4 * tx, B, s[c][qw][tx]);
        }
    }
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Transposes the two minor axes of the contiguous uint8 plane `in`
// [R, B, W] into `out` [R, W, B] on `stream` (no synchronisation) and
// returns cudaGetLastError().  `vec` selects 4-byte accesses, which
// need B and W multiples of 4 and both pointers 4-byte aligned.
extern "C" int bst_transpose_minor(const void* in, void* out, int R, int B,
                                   int W, int vec, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (R < 0 || B < 0 || W < 0) return (int)cudaErrorInvalidValue;
    if (R == 0 || B == 0 || W == 0) return 0;
    const int n_tb = (B + TILE - 1) / TILE, n_tw = (W + TILE - 1) / TILE;
    const long long blocks = (long long)R * n_tb * n_tw;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec && (B % 4 || W % 4)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* src = static_cast<const uint8_t*>(in);
    uint8_t* dst = static_cast<uint8_t*>(out);
    if (vec)
        transpose_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
            src, dst, R, B, W, n_tb, n_tw);
    else
        transpose_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
            src, dst, R, B, W, n_tb, n_tw);
    return (int)cudaGetLastError();
}
