// Row-form banded affine-gap DP for Hopper (sm_90a).
//
// Replaces the TPU kernel biseqt_tpu/ops/pallas_dp.py::_kernel
// (launched by _banded_dp_pallas_jit, public banded_dp_pallas), the
// engine of pw.Aligner(backend="pallas_row").  The Python wrapper is
// biseqt_tpu_torch/ops/dp_row.py, whose plain PyTorch twin
// (_sweep_plain) computes exactly what this kernel does, and whose
// planner (plan) picks the geometry below from the batch.
//
// Lane k of a row is the diagonal d = dmax - k; row i holds the cells
// (i, j = i - dmax + k).  Diag (i-1, j-1) is the same lane of the
// previous row, up (i-1, j) is lane k+1 of the previous row, and left
// (i, j-1) is lane k-1 of the SAME row: the affine E chain is solved in
// closed form as an inclusive prefix max over the lanes,
// E[k] = ge*k + max(A[0..k]) with A[m] = H_pre[m-1] + (go + ge) - ge*m.
//
// What bounds it on this card.  Every row depends on the whole previous
// row, and the prefix max makes every lane of a row depend on every
// lane below it: a pair is a chain of s_len rows.  Per lane and row the
// work is ~12 float operations of the recurrence plus the scan, a table
// lookup and, with directions, a byte of the plane; device-memory
// traffic is that byte per cell.  So a batch is bound by instruction
// issue and a lone pair by the latency of its row chain (a warp issues
// in order, so every stall on the row's dependent operations is paid),
// not by bytes.
//
// What the design does about it.  A thread owns LPT consecutive lanes,
// so the scan is a serial max over its lanes, a 5-step __shfl_up_sync
// scan of the 32 thread totals and an exclusive carry by one shuffle.
// Two geometries (template parameter WPP):
//  * a warp per pair (W = 32 * LPT, LPT 4 or 8), a block of one warp:
//    the row loop has no block barrier and no shared memory but the
//    substitution table; the lane above lane W - 1 is NEG, so the
//    neighbour exchange is one shuffle;
//  * a block per pair (the fewest warps that cover W, lanes past W dead;
//    for wide bands and for a lone pair, which wants few warps on its
//    chain): one __syncthreads a row.
//    Before it each warp publishes its scan total, its total without its
//    top lane (for the E-extend bit of the next warp's first lane) and
//    its first lane's H_pre and F, double buffered by row parity; after
//    it each warp reads the carry of the warps below, and the top thread
//    of each warp forms the next warp's first lane's H itself (the same
//    max and add), so no second exchange is needed;
//  * above 4096 lanes, a thread-block cluster per pair: the fewest blocks
//    of at most 16 warps (8 lanes a thread) that cover W, 16 at most,
//    run the block-per-pair row as one block would, the pair's warps
//    numbered across them.  The row barrier is the cluster's; each warp
//    reads the published values of the warps below it, and the top
//    thread of a block those of the next block's first warp, through
//    distributed shared memory.  Score and end cell are reduced over the
//    cluster at the end.
// Nothing but the recurrence sits on the row chain.  The T codes live
// in registers: lane k of row i + 1 reads the letter lane k + 1 read in
// row i, so a thread's codes shift down one lane a row, its top one from
// the next thread by shuffle; the top lane of each warp takes its new
// letter from a block of 32 codes, one a lane, loaded 32 rows ahead, as
// the S codes are (volatile loads, so that the compiler keeps them
// early), and broadcast by shuffle.  The next row's substitution scores
// are looked up at the end of a row, from the (A + 1) x (A + 1) table in
// shared memory, whose pad row and column (a negative S code scores 0, a
// T pad NEG) leave the lookup without a branch.  The neighbour's F is
// shuffled as soon as it is formed and its H as soon as lane 0's is.
// The mode flags are folded into per-row constants and selects (a row
// loop without branches), directions are a template parameter.  H, F
// and the trackers stay in registers for the whole sweep.  The row
// trackers of the TPU kernel (a strict > per row, lowest lane on ties)
// are kept per lane as (best, first row and step) and reduced once at
// the end: the earliest row and step that reaches the maximum wins, and
// within it the lowest lane, which is the cell the per-row trackers
// pick.  A thread's direction bytes go to the [B, LS, W] plane as one
// word a row, at 64-bit offsets.
//
// Arithmetic follows the TPU kernel's order of float operations (its
// direction bits come from float equality tests): only the grouping of
// the E chain's maxes differs, and max is exact.  Build with
// --fmad=false.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEGF = -1e30f;
// -inf (CUDART_INF_F is a call, not a constant expression)
#define NINF (-CUDART_INF_F)
constexpr int FREE_START_EDGES = 1;
constexpr int LOCAL_START = 2;
constexpr int FREE_END_EDGES = 4;
constexpr int LOCAL_END = 8;
// the modes with instances of their own (pw.Aligner's banded types),
// and the instance that reads the flags at run time
constexpr int GLOBAL = 0;
constexpr int LOCAL = LOCAL_START | LOCAL_END;
constexpr int OVERLAP = FREE_START_EDGES | FREE_END_EDGES;
constexpr int RUNTIME = -1;
constexpr unsigned FULL = 0xffffffffu;
// the end cell's key: (3 * row + step) above the lane's 16 bits
constexpr int KEY_LANE_BITS = 16;

struct Args {
    const int8_t* s;
    const int8_t* t;
    const int32_t* s_lens;
    const int32_t* t_lens;
    const int32_t* dmax;
    const int32_t* w_eff;
    const float* table;
    int A;
    int B, LS, LT, W, flags;
    float go, ge, gg;            // gg = f32(go + ge), summed in double
    float* score;
    int32_t* ei;
    int32_t* ek;
    uint8_t* dirs;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(FULL, v, off);
        v = o < v ? o : v;
    }
    return v;
}

// Block-wide max; every thread gets the result.
__device__ float block_max(float v, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = warp_max(v);
    __syncthreads();                    // red may still be read
    if (lane == 0) red[warp] = v;
    __syncthreads();
    return warp_max(lane < nw ? red[lane] : NINF);
}

__device__ unsigned long long block_min(unsigned long long v,
                                        unsigned long long* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    v = warp_min(v);
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    return warp_min(lane < nw ? red[lane] : ~0ull);
}

// Cluster-wide max and min of a value every thread of each block holds;
// `slot` is a word of shared memory the reduction uses alone.
__device__ float cluster_max(float v, float* slot) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) *slot = v;
    cluster.sync();
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
        v = fmaxf(v, *cluster.map_shared_rank(slot, r));
    return v;
}

__device__ unsigned long long cluster_min(unsigned long long v,
                                          unsigned long long* slot) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) *slot = v;
    cluster.sync();
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
        const unsigned long long o = *cluster.map_shared_rank(slot, r);
        v = o < v ? o : v;
    }
    return v;
}

// *p where `in` holds, else `pad`; no branch.  The load is volatile so
// that the compiler issues it where the code places it, rows before its
// use, and does not sink it to that use.
__device__ __forceinline__ int load_code(const int8_t* p, bool in, int pad) {
    int v = pad;
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
        "@q ld.global.nc.s8 %0, [%1];\n\t}"
        : "+r"(v) : "l"(p), "r"((unsigned)in));
    return v;
}

// The table column of T position idx: its code, or A (the pad column)
// outside [0, tlen) and for a negative code.
__device__ __forceinline__ int t_column(const int8_t* trow, int idx, int tlen,
                                        int A) {
    const int c = load_code(trow + idx, idx >= 0 && idx < tlen, A);
    return c < 0 ? A : c;
}

// H of row 0 at lane k
__device__ __forceinline__ float h_row0(int k, int dmax, int tlen, int weff,
                                        bool zero_start, float go,
                                        float ge) {
    const int j0 = k - dmax;
    const bool valid0 = j0 >= 0 && j0 <= tlen && k < weff;
    float h0 = 0.0f;
    if (!zero_start && j0 > 0) h0 = go + ge * (float)j0;
    return valid0 ? h0 : NEGF;
}

// A thread's LPT direction bytes (packed little-endian in pk) to p, one
// store; p is LPT-aligned.
template <int LPT>
__device__ __forceinline__ void store_bytes(uint8_t* p, const uint32_t* pk) {
    if constexpr (LPT == 4)
        *reinterpret_cast<uint32_t*>(p) = pk[0];
    else
        *reinterpret_cast<uint2*>(p) = make_uint2(pk[0], pk[1]);
}

// WPP: a warp per pair (W = 32 * LPT, a block of one warp); else a block
// per pair of whole warps, the lanes from W up to blockDim.x * LPT dead.
// CL: a cluster of such blocks per pair, rank r holding the pair's warps
// [r * nw, (r + 1) * nw) (the lanes from W up dead).  DIRS: write the
// plane and track the end cell.  MODE: the flags, or RUNTIME to read
// g.flags.
template <int LPT, bool WPP, bool DIRS, int MODE, bool CL = false>
__global__ void __launch_bounds__(WPP ? 32 : 512)
dp_row_kernel(Args g) {
    static_assert(LPT == 4 || LPT == 8, "LPT");
    static_assert(!(CL && WPP), "a cluster is of blocks of warps");
    extern __shared__ float smem[];
    const int A = g.A, A1 = A + 1;
    float* tab = smem;                            // [(A + 1) * (A + 1)]
    float* xch = tab + ((A1 * A1 + 1) & ~1);      // [2][4][32], block mode
    float* red = xch + 256;                       // [32]
    unsigned long long* redk =
        reinterpret_cast<unsigned long long*>(red + 32);   // [32]
    unsigned long long* cred_key = redk + 32;     // [1], cluster mode
    float* cred = reinterpret_cast<float*>(cred_key + 1);  // [2]

    const int tid = threadIdx.x;
    for (int x = tid; x < A1 * A1; x += blockDim.x) {
        const int r = x / A1, c = x - r * A1;
        tab[x] = c == A ? NEGF : (r == A ? 0.0f : g.table[r * A + c]);
    }
    // in a cluster: every block has started before any reads another's
    // shared memory
    if constexpr (CL)
        cg::this_cluster().sync();
    else
        __syncthreads();

    const int lane = tid & 31;
    const int ncl = CL ? (int)cg::this_cluster().num_blocks() : 1;
    const int b = CL ? blockIdx.x / ncl : blockIdx.x;
    const int rank = CL ? blockIdx.x - b * ncl : 0;
    const int w = WPP ? 0 : tid >> 5;         // warp within the block
    const int nw = WPP ? 1 : blockDim.x >> 5;
    const int gw = rank * nw + w;             // warp within the pair
    // a warp of the pair above
    const bool has_next = !WPP && (w + 1 < nw || rank + 1 < ncl);

    const int slen = g.s_lens[b], tlen = g.t_lens[b];
    // lanes past W (a block's last warp) are dead like those past w_eff
    const int dmax = g.dmax[b], weff = min(g.w_eff[b], g.W);
    const int8_t* srow = g.s + (size_t)b * g.LS;
    const int8_t* trow = g.t + (size_t)b * g.LT;
    const int flags = MODE == RUNTIME ? g.flags : MODE;
    const bool local_start = flags & LOCAL_START;
    const bool free_start = flags & FREE_START_EDGES;
    const bool track_local = flags & LOCAL_END;
    const bool track_col = flags & FREE_END_EDGES;
    const bool track_end = DIRS && (track_local || track_col);
    const float go = g.go, ge = g.ge;
    const float lfloor = local_start ? 0.0f : NINF;   // H_pre's local floor
    const int k0 = (rank * (int)blockDim.x + tid) * LPT;
    // this warp's top lane
    const int kt = k0 - lane * LPT + 32 * LPT - 1;

    // A[0]: lane 0's E-chain seed, shr() fills NEG
    const float A0 = NEGF + g.gg;
    float H[LPT], F[LPT], bv[LPT], lb[LPT], gek[LPT], cg1[LPT];
    int lkey[LPT];
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const int k = k0 + m;
        gek[m] = ge * (float)k;
        cg1[m] = g.gg - ge * (float)(k + 1);     // cgek of lane k + 1
        H[m] = h_row0(k, dmax, tlen, weff, local_start || free_start, go,
                      ge);
        F[m] = NEGF;
        // row 0 can hold alignment ends: the trackers are seeded from it
        float b0 = NEGF;
        if (track_local) {
            b0 = H[m];
        } else if (track_col) {
            b0 = fmaxf(k == tlen + dmax ? H[m] : NEGF,
                       slen == 0 ? H[m] : NEGF);
        }
        bv[m] = lb[m] = b0;
        lkey[m] = 0;
    }
    // block mode, the top thread of a warp below another: (H, F) of lane
    // k1 = k0 + LPT (the next warp's first lane) in the previous row
    const int k1 = k0 + LPT;
    const float gek1 = ge * (float)k1;
    float nH = NEGF, nF = NEGF;
    if (has_next && lane == 31)
        nH = h_row0(k1, dmax, tlen, weff, local_start || free_start, go, ge);
    // (H + go, F) of lane k0 + LPT in the previous row: the next thread's
    // first lane; NEG beyond lane W - 1
    float nHG = __shfl_down_sync(FULL, H[0] + go, 1);
    float nFv = __shfl_down_sync(FULL, F[0], 1);
    if (lane == 31) {
        nHG = has_next ? nH + go : NEGF;
        nFv = nF;
    }

    // Codes, 32 rows a block: for the block starting at row i0, lane l
    // holds s[i0 - 1 + l] (row i0 + l) and the column of the warp's top
    // lane in row i0 + 1 + l (as a byte offset into a table row); the
    // next block is loaded a block ahead.
    const char* tabb = reinterpret_cast<const char*>(tab);
    const int row_bytes = 4 * A1;
    int sv = load_code(srow + lane, lane < slen, 0);
    int tv = 4 * t_column(trow, 1 + lane + kt - dmax, tlen, A);
    int sv_n = load_code(srow + 32 + lane, 32 + lane < slen, 0);
    int tv_n = 4 * t_column(trow, 33 + lane + kt - dmax, tlen, A);
    // the columns of this thread's lanes, and their scores, in row 1
    int code[LPT];
    float sub[LPT];
    {
        const int sc = __shfl_sync(FULL, sv, 0);
        const char* tabs = tabb + (sc >= 0 && sc < A ? sc : A) * row_bytes;
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            code[m] = 4 * t_column(trow, k0 + m - dmax, tlen, A);
            sub[m] = *reinterpret_cast<const float*>(tabs + code[m]);
        }
    }

    for (int i0 = 1; i0 <= slen; i0 += 32) {
        if (i0 > 1) {
            sv = sv_n;
            tv = tv_n;
            sv_n = load_code(srow + i0 + 31 + lane, i0 + 31 + lane < slen, 0);
            tv_n = 4 * t_column(trow, i0 + 32 + lane + kt - dmax, tlen, A);
        }
        const int rows = min(32, slen - i0 + 1);
        for (int r = 0; r < rows; ++r) {
            const int i = i0 + r;
            const int jb = i - dmax + k0;            // j of lane k0
            // the lane (relative to k0) whose j is 0 under a free start, and
            // the lane of the column tracker; -1 when the mode has none
            const int mz = free_start ? -jb : -1;
            const int kcol = tlen - i + dmax;
            const int mc = track_col ? kcol - k0 : -1;
            float diag[LPT], Fn[LPT], Fx[LPT], Hpre[LPT], inc[LPT];
            float run = NINF;
#pragma unroll
            for (int m = 0; m < LPT; ++m) {
                diag[m] = H[m] + sub[m];
                const float hg_n = m + 1 < LPT ? H[m + 1] + go : nHG;
                const float f_n = m + 1 < LPT ? F[m + 1] : nFv;
                if (DIRS) {
                    Fx[m] = f_n + ge;
                    Fn[m] = fmaxf(hg_n + ge, Fx[m]);
                } else {
                    Fn[m] = fmaxf(hg_n, f_n) + ge;
                }
                float hp = fmaxf(fmaxf(diag[m], Fn[m]), lfloor);
                hp = fmaxf(hp, m == mz ? 0.0f : NINF);
                Hpre[m] = hp;
                // Q = A of lane k + 1; the running max is the local scan
                run = fmaxf(run, hp + cg1[m]);
                inc[m] = run;
            }
            // the next row's F of lane k0 + LPT
            nFv = __shfl_down_sync(FULL, Fn[0], 1);
            // warp scan of the thread totals (a lane below off gets its own)
            float x = run;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1)
                x = fmaxf(x, __shfl_up_sync(FULL, x, off));
            float excl = __shfl_up_sync(FULL, x, 1);
            if (lane == 0) excl = NINF;
            // carry of the warps below, and P at lane k0 - 1 for lane 0
            float carry = NINF, pprev0 = NEGF;
            if (!WPP) {
                // tot, tot without the top lane, H_pre, F
                float* buf = xch + (i & 1) * 128;
                if (lane == 31) {
                    buf[w] = x;
                    buf[32 + w] = fmaxf(excl, inc[LPT - 2]);
                }
                if (lane == 0) {
                    buf[64 + w] = Hpre[0];
                    buf[96 + w] = Fn[0];
                }
                if constexpr (CL) {
                    cg::cluster_group cluster = cg::this_cluster();
                    cluster.sync();
                    // the slots of the pair's warp u, in its block
                    auto slots = [&](int u) -> const float* {
                        const int r = u / nw;
                        float* p = buf + (u - r * nw);
                        return r == rank ? p
                                         : cluster.map_shared_rank(p, r);
                    };
                    // the max over the warps below the one below, a lane
                    // each, then over the lanes (max regroups exactly)
                    float c2 = NINF;
                    for (int u = lane; u + 1 < gw; u += 32)
                        c2 = fmaxf(c2, slots(u)[0]);
                    c2 = warp_max(c2);
                    if (gw > 0) {
                        const float* below = slots(gw - 1);
                        carry = fmaxf(c2, below[0]);
                        pprev0 = fmaxf(A0, fmaxf(c2, below[32]));
                    }
                    if (has_next && lane == 31) {
                        const float* above = slots(gw + 1);
                        const float E1 = fmaxf(A0, fmaxf(carry, x)) + gek1;
                        nH = k1 < weff ? fmaxf(above[64], E1) : NEGF;
                        nF = above[96];
                    }
                } else {
                    __syncthreads();
                    if (w > 0) {
                        float c2 = NINF;
                        for (int u = 0; u + 1 < w; ++u)
                            c2 = fmaxf(c2, buf[u]);
                        carry = fmaxf(c2, buf[w - 1]);
                        pprev0 = fmaxf(A0, fmaxf(c2, buf[32 + w - 1]));
                    }
                    if (has_next && lane == 31) {
                        // the next warp's first lane, as that warp forms it
                        const float E1 = fmaxf(A0, fmaxf(carry, x)) + gek1;
                        nH = k1 < weff ? fmaxf(buf[64 + w + 1], E1) : NEGF;
                        nF = buf[96 + w + 1];
                    }
                }
            }
            // P at this thread's first lane, then at its other lanes
            const float base = fmaxf(A0, fmaxf(carry, excl));
            float P[LPT];
            P[0] = base;
#pragma unroll
            for (int m = 1; m < LPT; ++m) P[m] = fmaxf(base, inc[m - 1]);
            // P at lane k0 - 1, for the E-extend bit of lane k0
            float Pprev = NEGF;
            if (DIRS) {
                Pprev = __shfl_up_sync(FULL, P[LPT - 1], 1);
                if (lane == 0) Pprev = pprev0;
            }

            uint32_t pk[(LPT + 3) / 4];
#pragma unroll
            for (int q = 0; q < (LPT + 3) / 4; ++q) pk[q] = 0;
            // lanes with a cell of the matrix: jb + m in [0, tlen], k < w_eff
            const int mlo = -jb, mhi = min(tlen - jb, weff - 1 - k0);
            const bool last_col = track_col && i == slen;
#pragma unroll
            for (int m = 0; m < LPT; ++m) {
                const bool ok = k0 + m < weff;
                const float E = P[m] + gek[m];
                // dead lanes are masked after the E merge
                const float Hn = ok ? fmaxf(Hpre[m], E) : NEGF;
                if (m == 0) {
                    // the next row's H + go of lane k0 + LPT
                    nHG = __shfl_down_sync(FULL, Hn + go, 1);
                }
                bv[m] = fmaxf(bv[m], track_local || m == mc ? Hn : NINF);
                if (DIRS) {
                    const bool valid_j = m >= mlo && m <= mhi;
                    int d = Hn == diag[m] ? 1 : (Hn == E ? 2 : 3);
                    if ((local_start && Hn == 0.0f && diag[m] < 0.0f)
                        || (m == mz && Hn == 0.0f && Fn[m] < 0.0f))
                        d = 0;
                    const float pp = m == 0 ? Pprev : P[m > 0 ? m - 1 : 0];
                    const uint32_t byte = d + (P[m] == pp ? 4 : 0)
                                          + (Fn[m] == Fx[m] ? 8 : 0);
                    pk[m >> 2] |= (valid_j ? byte : 0u) << (8 * (m & 3));
                    if (track_end) {
                        // step order of a row: local, column, last row
                        if (track_local && valid_j && Hn > lb[m]) {
                            lb[m] = Hn;
                            lkey[m] = 3 * i;
                        }
                        if (m == mc && Hn > lb[m]) {
                            lb[m] = Hn;
                            lkey[m] = 3 * i + 1;
                        }
                        if (last_col && valid_j && Hn > lb[m]) {
                            lb[m] = Hn;
                            lkey[m] = 3 * i + 2;
                        }
                    }
                }
                H[m] = Hn;
                F[m] = Fn[m];
            }
            if (lane == 31) {
                nHG = has_next ? nH + go : NEGF;
                nFv = nF;
            }
            if (DIRS && k0 < g.W)
                store_bytes<LPT>(g.dirs + ((size_t)b * g.LS + (size_t)(i - 1))
                                              * g.W + k0, pk);

            // the next row: codes shift down a lane, the top lane's from the
            // block; its scores from the table row of its S letter
            const int top = __shfl_sync(FULL, tv, r);
            int cin = __shfl_down_sync(FULL, code[0], 1);
            if (lane == 31) cin = top;
#pragma unroll
            for (int m = 0; m + 1 < LPT; ++m) code[m] = code[m + 1];
            code[LPT - 1] = cin;
            const int sc = __shfl_sync(FULL, r < 31 ? sv : sv_n, (r + 1) & 31);
            const char* tabs = tabb + (sc >= 0 && sc < A ? sc : A) * row_bytes;
#pragma unroll
            for (int m = 0; m < LPT; ++m)
                sub[m] = *reinterpret_cast<const float*>(tabs + code[m]);
        }
    }

    // H holds the pair's last row
    const int kcorner = tlen - slen + dmax;
    float v = NINF;
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const int k = k0 + m;
        const bool ok = k < weff;
        if (track_col)
            v = fmaxf(v, fmaxf(bv[m], ok ? H[m] : NEGF));
        else if (track_local)
            v = fmaxf(v, bv[m]);
        else
            v = fmaxf(v, (k == kcorner && ok) ? H[m] : NEGF);
    }
    float score = WPP ? warp_max(v) : block_max(v, red);
    if constexpr (CL) score = cluster_max(score, cred);
    int ei = slen, ek = kcorner;
    if (track_local || track_col) {
        ei = -1;
        ek = 0;
    }
    if (track_end) {
        float lv = NINF;
#pragma unroll
        for (int m = 0; m < LPT; ++m) lv = fmaxf(lv, lb[m]);
        float M = WPP ? warp_max(lv) : block_max(lv, red);
        if constexpr (CL) M = cluster_max(M, cred + 1);
        unsigned long long key = ~0ull;
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const unsigned long long c =
                ((unsigned long long)lkey[m] << KEY_LANE_BITS)
                | (unsigned)(k0 + m);
            if (lb[m] == M && c < key) key = c;
        }
        key = WPP ? warp_min(key) : block_min(key, redk);
        if constexpr (CL) key = cluster_min(key, cred_key);
        ei = (int)((key >> KEY_LANE_BITS) / 3);
        ek = (int)(key & ((1u << KEY_LANE_BITS) - 1));
    }
    if (tid == 0 && rank == 0) {
        g.score[b] = score;
        g.ei[b] = ei;
        g.ek[b] = ek;
    }
    // in a cluster: no block leaves while another may still read its
    // shared memory
    if constexpr (CL) cg::this_cluster().sync();
}

// Raise the kernel's dynamic shared memory above the 48 KB default
// where the table needs it (an alphabet above ~100 letters).
cudaError_t allow_smem(void (*kernel)(Args), size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a block per pair
template <int LPT, bool WPP, bool DIRS, int MODE>
cudaError_t launch_one(const Args& g, int threads, size_t smem,
                       cudaStream_t st) {
    cudaError_t err = allow_smem(dp_row_kernel<LPT, WPP, DIRS, MODE>, smem);
    if (err != cudaSuccess) return err;
    dp_row_kernel<LPT, WPP, DIRS, MODE><<<g.B, threads, smem, st>>>(g);
    return cudaSuccess;
}

template <int LPT, bool WPP, bool DIRS>
cudaError_t launch_mode(const Args& g, int threads, size_t smem,
                        cudaStream_t st) {
    if (g.flags == LOCAL)
        return launch_one<LPT, WPP, DIRS, LOCAL>(g, threads, smem, st);
    if (g.flags == GLOBAL)
        return launch_one<LPT, WPP, DIRS, GLOBAL>(g, threads, smem, st);
    if (g.flags == OVERLAP)
        return launch_one<LPT, WPP, DIRS, OVERLAP>(g, threads, smem, st);
    return launch_one<LPT, WPP, DIRS, RUNTIME>(g, threads, smem, st);
}

template <int LPT, bool WPP>
cudaError_t launch(const Args& g, bool with_dirs, int threads, size_t smem,
                   cudaStream_t st) {
    if (with_dirs) return launch_mode<LPT, WPP, true>(g, threads, smem, st);
    return launch_mode<LPT, WPP, false>(g, threads, smem, st);
}

constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;      // the card's non-portable limit
constexpr int CLUSTER_LPT = 8;

// A cluster of `cluster` blocks per pair (8 lanes a thread, the run-time
// flags): its kernel, grid, shared memory and cluster attribute
// (non-portable sizes allowed above 8 blocks).
cudaError_t cluster_config(int B, bool with_dirs, int threads, size_t smem,
                           int cluster, cudaStream_t st,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           void (*&kernel)(Args)) {
    kernel = with_dirs ? dp_row_kernel<CLUSTER_LPT, false, true, RUNTIME, true>
                       : dp_row_kernel<CLUSTER_LPT, false, false, RUNTIME,
                                       true>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess && cluster > PORTABLE_CLUSTER)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)B * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return err;
}

// A block's shared memory: the padded table, the warps' exchange, the
// block's and the cluster's reductions.
size_t smem_bytes(int A) {
    const int A1 = A + 1;
    return sizeof(float) * (((A1 * A1 + 1) & ~1) + 256 + 32 + 2)
           + sizeof(unsigned long long) * 33;
}

// Threads a block of a launch in `cluster` blocks a pair: the fewest
// whole warps of lpt lanes that cover the block's share of W.
int block_threads(int W, int lpt, int cluster) {
    const int warps = (W + 32 * lpt - 1) / (32 * lpt);
    return (warps + cluster - 1) / cluster * 32;
}

}  // namespace

// How many clusters of `cluster` blocks a pair of W lanes the card holds
// at once (cudaOccupancyMaxActiveClusters; 0: it cannot run one), or a
// negative CUDA error.
extern "C" int bst_dp_row_clusters(int W, int A, int with_dirs, int cluster,
                                   int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    if (cluster < 2 || cluster > MAX_CLUSTER || A < 1 || A > 127)
        return -(int)cudaErrorInvalidValue;
    const int threads = block_threads(W, CLUSTER_LPT, cluster);
    if (threads > 512) return -(int)cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    void (*kernel)(Args);
    err = cluster_config(1, with_dirs != 0, threads, smem_bytes(A), cluster,
                         nullptr, cfg, attr, kernel);
    if (err != cudaSuccess) return -(int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return -(int)err;
    }
    return clusters;
}

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches the row sweep over B pairs on `stream` (no synchronisation)
// and returns cudaGetLastError().  All pointers are device pointers;
// W must be a multiple of 128, A at most 127.  The geometry: `lpt` (4 or
// 8) lanes a thread; with `warp_per_pair` a warp per pair (W = 32 * lpt,
// a block of one warp), else a block per pair of the fewest warps that
// cover W (at most 512 threads), or with `cluster` > 1 a cluster of that
// many blocks per pair (8 lanes a thread, at most 16 blocks of at most
// 512 threads).  The dirs plane [B, LS, W] must be zeroed by the caller:
// rows past a pair's length are not written.
extern "C" int bst_dp_row(const void* s, const void* t, const void* s_lens,
                          const void* t_lens, const void* dmax,
                          const void* w_eff, const void* table, int A,
                          int B, int LS, int LT, int W, int flags,
                          float go, float ge, float gg, void* score,
                          void* ei, void* ek, void* dirs, int with_dirs,
                          int lpt, int warp_per_pair, int cluster,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (W < 128 || W % 128 || A < 1 || A > 127)
        return (int)cudaErrorInvalidValue;
    const bool wpp = warp_per_pair != 0;
    if ((lpt != 4 && lpt != 8) || (wpp && W != 32 * lpt)
        || cluster < 1 || cluster > MAX_CLUSTER
        || (cluster > 1 && (wpp || lpt != CLUSTER_LPT)))
        return (int)cudaErrorInvalidConfiguration;
    const int threads = wpp ? 32 : block_threads(W, lpt, cluster);
    if (threads > 512) return (int)cudaErrorInvalidConfiguration;
    if (B == 0) return 0;
    Args g;
    g.s = static_cast<const int8_t*>(s);
    g.t = static_cast<const int8_t*>(t);
    g.s_lens = static_cast<const int32_t*>(s_lens);
    g.t_lens = static_cast<const int32_t*>(t_lens);
    g.dmax = static_cast<const int32_t*>(dmax);
    g.w_eff = static_cast<const int32_t*>(w_eff);
    g.table = static_cast<const float*>(table);
    g.A = A;
    g.B = B; g.LS = LS; g.LT = LT; g.W = W; g.flags = flags;
    g.go = go; g.ge = ge; g.gg = gg;
    g.score = static_cast<float*>(score);
    g.ei = static_cast<int32_t*>(ei);
    g.ek = static_cast<int32_t*>(ek);
    g.dirs = static_cast<uint8_t*>(dirs);
    const size_t smem = smem_bytes(A);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool d = with_dirs != 0;
    if (cluster > 1) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr;
        void (*kernel)(Args);
        err = cluster_config(B, d, threads, smem, cluster, st, cfg, attr,
                             kernel);
        if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, g);
    } else if (wpp) {
        err = lpt == 4 ? launch<4, true>(g, d, threads, smem, st)
                       : launch<8, true>(g, d, threads, smem, st);
    } else {
        err = lpt == 4 ? launch<4, false>(g, d, threads, smem, st)
                       : launch<8, false>(g, d, threads, smem, st);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
