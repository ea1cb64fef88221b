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
// (__vadd2, __vmaxs2, __vmins2, __vcmpeq2 and a bitwise select).
//
// What bounds it on this card.  Each element is read once and written
// once, with one to three integer instructions per word in between:
// the ops are bound by the bytes they move (4 bytes per element over
// the 3.35 TB/s of device memory) and, at small R, by the launch.  The
// design keeps the memory busy with as little in the way as it can:
//   * 16-byte accesses: a uint4 is 8 int16, so 16 threads hold a
//     128-lane row and a warp two rows.  Chunk c of a row (its lanes
//     8c .. 8c + 7, four words, low half first) lies in lane c of a
//     16-thread group, so a lane roll or a shifted slice is one
//     __shfl_sync of width 16 plus __byte_perm (the counterpart of the
//     TPU's lane rotate).
//   * DEPTH chunks a thread, all loaded before any is stored: a warp's
//     tile is 2 * DEPTH rows, DEPTH coalesced 512-byte loads in flight.
//   * One instance per op, so no op is chosen at run time.
//   * Blocks of 8 warps, one tile a warp, as many blocks as the tiles
//     need, scheduled by the card: a block that ends makes room for the
//     next in order, so the tiles in flight stay a compact window of the
//     array whatever each SM's pace.
// Tried on an H100 and not kept, being no faster: DEPTH 1, 4 and 8; a
// grid sized to the card (the SMs times the resident blocks) walking
// the same tiles in a grid-stride loop, with and without streaming hints
// (__ldcs / __stcs); such a grid taking its tiles by tickets from an
// atomic counter; and such a grid staging 64-row tiles through shared
// memory by TMA bulk copies.
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
constexpr int CHUNKS = 16;             // uint4 chunks of a 128-lane row
constexpr int THREADS = 256;
constexpr int DEPTH = 2;               // 16-byte chunks a thread

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

// the halves of `lo`'s high int16 and `hi`'s low int16: the word one
// lane further along a row
__device__ __forceinline__ uint32_t shift1(uint32_t lo, uint32_t hi) {
    return __byte_perm(lo, hi, 0x5432);
}

template <int OP>
__device__ __forceinline__ uint32_t word_op(uint32_t w, int col0) {
    if (OP == 0) return __vadd2(w, 0x00030003u);
    if (OP == 1) return __vmaxs2(w, 0x00070007u);
    if (OP == 2)
        return __vmins2(w, bitsel(below100(col0), pack(32000, 32000),
                                  pack(-20000, -20000)));
    if (OP == 5) return bitsel(below100(col0), w, pack(-20000, -20000));
    // (int32) x % 2 == 0 is a clear low bit, for negative x too:
    // 0xffff in each even half, and the odd halves become -1
    if (OP == 6) return w | ~((~w & 0x00010001u) * 0xffffu);
    // the truncating cast of an int32 sum is the wrapping int16 sum
    if (OP == 7) return __vadd2(w, 0x00050005u);
    // OP == 8
    return bitsel(__vcmpeq2(w, 0x00040004u), w, pack(-2, -2));
}

// op OP on chunk c of a row (lane c of its 16-thread group); every lane
// of the warp must call it, for the shuffles
template <int OP>
__device__ __forceinline__ uint4 chunk_op(uint4 v, int c) {
    if (OP == 3) {                 // x[j - 1]: the last word of chunk c - 1
        const uint32_t prev = __shfl_sync(FULL, v.w, (c + CHUNKS - 1)
                                          % CHUNKS, CHUNKS);
        return make_uint4(shift1(prev, v.x), shift1(v.x, v.y),
                          shift1(v.y, v.z), shift1(v.z, v.w));
    } else if (OP == 4) {          // x[j + 1]: the first word of chunk c + 1
        const uint32_t next = __shfl_sync(FULL, v.x, (c + 1) % CHUNKS,
                                          CHUNKS);
        return make_uint4(shift1(v.x, v.y), shift1(v.y, v.z),
                          shift1(v.z, v.w), shift1(v.w, next));
    } else if (OP == 9) {          // x[j + 3], zeros past lane 127
        uint32_t n0 = __shfl_down_sync(FULL, v.x, 1, CHUNKS);
        uint32_t n1 = __shfl_down_sync(FULL, v.y, 1, CHUNKS);
        if (c == CHUNKS - 1) n0 = n1 = 0u;
        return make_uint4(shift1(v.y, v.z), shift1(v.z, v.w),
                          shift1(v.w, n0), shift1(n0, n1));
    } else {
        const int col = 8 * c;
        return make_uint4(word_op<OP>(v.x, col), word_op<OP>(v.y, col + 2),
                          word_op<OP>(v.z, col + 4),
                          word_op<OP>(v.w, col + 6));
    }
}

// `n` = 16 R chunks; warp w's tile is the 32 * DEPTH chunks from
// 32 * DEPTH * w on (2 * DEPTH rows), lane l taking chunks l, l + 32, ...
// of it.  A row's 16 chunks are all in range or all out, so a group's
// shuffles never mix a real row with a missing one.
template <int OP>
__global__ void __launch_bounds__(THREADS)
i16_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
           long long n) {
    const int lane = threadIdx.x & 31;
    const long long base =
        ((long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32)
        * (32 * DEPTH) + lane;
    uint4 v[DEPTH];
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
        const long long at = base + 32 * k;
        v[k] = at < n ? x[at] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
        const uint4 o = chunk_op<OP>(v[k], lane % CHUNKS);
        const long long at = base + 32 * k;
        if (at < n) out[at] = o;
    }
}

using Kernel = void (*)(const uint4*, uint4*, long long);
const Kernel KERNELS[10] = {
    i16_kernel<0>, i16_kernel<1>, i16_kernel<2>, i16_kernel<3>,
    i16_kernel<4>, i16_kernel<5>, i16_kernel<6>, i16_kernel<7>,
    i16_kernel<8>, i16_kernel<9>};

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Applies op `op` (0-9, the list above) to the contiguous int16
// [R, 128] array `x`, writing `out` [R, 128], on `stream` (no
// synchronisation), and returns cudaGetLastError().  Both pointers must
// be 16-byte aligned.
extern "C" int bst_i16_op(const void* x, void* out, int R, int op,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (R < 0 || op < 0 || op > 9) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)x | (uintptr_t)out) % 16)
        return (int)cudaErrorMisalignedAddress;
    if (R == 0) return 0;
    const long long n = (long long)R * CHUNKS;
    const long long tiles = (n + 32 * DEPTH - 1) / (32 * DEPTH);
    const long long blocks = (tiles + THREADS / 32 - 1) / (THREADS / 32);
    KERNELS[op]<<<(unsigned)blocks, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out), n);
    return (int)cudaGetLastError();
}
