// Packed 16-bit integer ops for Hopper (sm_90a): one of ten int16 ops
// on an int16 [R, 128] array.
//
// Replaces the TPU kernel experiments/mosaic_i16_probe.py::kernel
// (launched by try_op), the probe of which int16 vector ops the TPU's
// compiler lowers, with its ten op bodies (mosaic_i16_probe.py:42-62).
// The Python wrapper is biseqt_tpu_torch/experiments/i16_probe.py,
// whose plain version runs the same op as one PyTorch expression.
//
// The arithmetic is done the way a 16-bit DP on Hopper would do it:
// two int16 per 32-bit register, with the SIMD-in-word intrinsics
// (__vadd2, __vmaxs2, __vmins2, __vcmpeq2 and a bitwise select), and
// one warp per 128-lane row, so a lane roll or a shifted slice is a
// warp shuffle plus __byte_perm (the counterpart of the TPU's lane
// rotate).  Lane l of a warp holds the row's elements 4l .. 4l + 3 as
// two words, (4l, 4l + 1) and (4l + 2, 4l + 3), low half first.
//
// What bounds it on this card.  Each element is read once and written
// once, with one to three integer instructions per word in between:
// the ops are bound by the bytes they move (4 bytes per element over
// the 3.35 TB/s of device memory) and, at small R, by the launch.
//
// Ops (the probe's names, same semantics; int16 wrap-around on add and
// on the cast; a roll is jnp.roll along the lanes):
//   0 add                   x + 3
//   1 max                   max(x, 7)
//   2 min-vec (mask trick)  min(x, lane < 100 ? 32000 : -20000)
//   3 roll                  out[j] = x[(j - 1) mod 128]
//   4 roll127               out[j] = x[(j - 127) mod 128]
//   5 where(i1,i16,i16)     lane < 100 ? x : -20000
//   6 select from i32 cmp   (int32) x % 2 == 0 ? x : -1
//   7 i32->i16 cast         (int16)((int32) x + 5)
//   8 i16 cmp + i16 sel     x == 4 ? x : -2
//   9 slice value [r:r+W]   out[j] = j + 3 < 128 ? x[j + 3] : 0

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 128;
constexpr int ROWS_PER_BLOCK = 8;      // one warp per row

__device__ __forceinline__ uint32_t pack(int lo, int hi) {
    return ((uint32_t)lo & 0xffffu) | ((uint32_t)hi << 16);
}

// bitwise select: halves of `m` are 0xffff (take a) or 0 (take b)
__device__ __forceinline__ uint32_t bitsel(uint32_t m, uint32_t a,
                                           uint32_t b) {
    return (a & m) | (b & ~m);
}

// 0xffff in each half whose column (col0 low, col0 + 1 high) is below 100
__device__ __forceinline__ uint32_t below100(int col0) {
    return pack(col0 < 100 ? -1 : 0, col0 + 1 < 100 ? -1 : 0);
}

__device__ __forceinline__ uint32_t even_mask(uint32_t v) {
    // the probe compares in int32: (int32) x % 2 == 0
    const int lo = (int16_t)(v & 0xffffu), hi = (int16_t)(v >> 16);
    return pack(lo % 2 == 0 ? -1 : 0, hi % 2 == 0 ? -1 : 0);
}

__device__ __forceinline__ uint32_t cast_add5(uint32_t v) {
    const int lo = (int16_t)(v & 0xffffu) + 5, hi = (int16_t)(v >> 16) + 5;
    // the low two bytes of each int32: the truncating cast
    return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
}

__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK)
i16_kernel(const uint2* __restrict__ x, uint2* __restrict__ out, int R,
           int op) {
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= R) return;                  // the whole warp leaves
    const int l = threadIdx.x & 31;
    const size_t at = (size_t)row * (LANES / 4) + l;
    const uint2 v = x[at];
    const uint32_t w0 = v.x, w1 = v.y;
    const int c0 = 4 * l;
    uint32_t o0, o1;
    switch (op) {
    case 0:
        o0 = __vadd2(w0, 0x00030003u);
        o1 = __vadd2(w1, 0x00030003u);
        break;
    case 1:
        o0 = __vmaxs2(w0, 0x00070007u);
        o1 = __vmaxs2(w1, 0x00070007u);
        break;
    case 2: {
        const uint32_t hi = pack(32000, 32000), lo = pack(-20000, -20000);
        o0 = __vmins2(w0, bitsel(below100(c0), hi, lo));
        o1 = __vmins2(w1, bitsel(below100(c0 + 2), hi, lo));
        break;
    }
    case 3: {                              // x[j - 1]: the last of lane l - 1
        const uint32_t prev = __shfl_sync(FULL, w1, (l + 31) & 31);
        o0 = __byte_perm(prev, w0, 0x5432);
        o1 = __byte_perm(w0, w1, 0x5432);
        break;
    }
    case 4: {                              // x[j + 1]: the first of lane l + 1
        const uint32_t next = __shfl_sync(FULL, w0, (l + 1) & 31);
        o0 = __byte_perm(w0, w1, 0x5432);
        o1 = __byte_perm(w1, next, 0x5432);
        break;
    }
    case 5: {
        const uint32_t fill = pack(-20000, -20000);
        o0 = bitsel(below100(c0), w0, fill);
        o1 = bitsel(below100(c0 + 2), w1, fill);
        break;
    }
    case 6:
        o0 = bitsel(even_mask(w0), w0, 0xffffffffu);
        o1 = bitsel(even_mask(w1), w1, 0xffffffffu);
        break;
    case 7:
        o0 = cast_add5(w0);
        o1 = cast_add5(w1);
        break;
    case 8: {
        const uint32_t four = 0x00040004u, fill = pack(-2, -2);
        o0 = bitsel(__vcmpeq2(w0, four), w0, fill);
        o1 = bitsel(__vcmpeq2(w1, four), w1, fill);
        break;
    }
    default: {                             // 9: x[j + 3], zeros past 127
        uint32_t n0 = __shfl_down_sync(FULL, w0, 1);
        uint32_t n1 = __shfl_down_sync(FULL, w1, 1);
        if (l == 31) n0 = n1 = 0u;
        o0 = __byte_perm(w1, n0, 0x5432);
        o1 = __byte_perm(n0, n1, 0x5432);
        break;
    }
    }
    out[at] = make_uint2(o0, o1);
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Applies op `op` (0-9, the list above) to the contiguous int16
// [R, 128] array `x`, writing `out` [R, 128], on `stream` (no
// synchronisation), and returns cudaGetLastError().  Both pointers must
// be 8-byte aligned.
extern "C" int bst_i16_op(const void* x, void* out, int R, int op,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (R < 0 || op < 0 || op > 9) return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    i16_kernel<<<blocks, 32 * ROWS_PER_BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint2*>(x), static_cast<uint2*>(out), R, op);
    return (int)cudaGetLastError();
}
