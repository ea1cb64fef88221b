// Row-form banded affine-gap DP for Hopper (sm_90a).
//
// Replaces the TPU kernel biseqt_tpu/ops/pallas_dp.py::_kernel
// (launched by _banded_dp_pallas_jit, public banded_dp_pallas), the
// engine of pw.Aligner(backend="pallas_row").  The Python wrapper is
// biseqt_tpu_torch/ops/dp_row.py, whose plain PyTorch twin
// (_sweep_plain) computes exactly what this kernel does.
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
// lane below it: the sweep is a chain of s_len rows, each of which
// crosses the block twice (a scan through shared memory and the
// exchange of the warp-edge lanes for the next row).  Per lane and row
// the work is ~60 dependent float and integer operations, a byte load of
// T and, with directions, one byte store; device-memory traffic is
// that byte per cell.  So the kernel is bound by the latency of the
// per-row barrier chain and by instruction issue, not by bytes.
//
// What the design does about it.  One block per pair, min(W, 1024)
// threads, each owning LPT = W / threads consecutive lanes, so the
// scan is a short serial max inside a thread, a warp __shfl_up_sync
// scan of the thread totals, and one cross-warp pass through shared
// memory: two __syncthreads per row.  H, F and the trackers stay in
// registers for the whole sweep; each lane reads s[i-1] and
// t[i-1+k-dmax] directly (no band-frame stream, so a band left of the
// main diagonal cannot alias letters), and the A x A substitution table
// sits in shared memory (any alphabet up to 64 letters; a uniform
// match / mismatch matrix is one such table).  Many pairs run side by
// side, one block each, to hide the chain's latency.  The row trackers of the
// TPU kernel (a strict > per row, lowest lane on ties) are kept per
// lane as (best, first row and step) and reduced once at the end: the
// earliest row and step that reaches the maximum wins, and within it
// the lowest lane, which is the cell the per-row trackers pick.
// Directions go to the [B, LS, W] plane at 64-bit offsets, one
// coalesced row at a time.
//
// Arithmetic follows the TPU kernel's order of float operations (its
// direction bits come from float equality tests): build with
// --fmad=false.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr int FREE_START_EDGES = 1;
constexpr int LOCAL_START = 2;
constexpr int FREE_END_EDGES = 4;
constexpr int LOCAL_END = 8;
constexpr unsigned FULL = 0xffffffffu;

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
    int with_dirs;
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
    return warp_max(lane < nw ? red[lane] : -CUDART_INF_F);
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

template <int LPT>
__global__ void __launch_bounds__(1024)
dp_row_kernel(Args g) {
    extern __shared__ float smem[];
    float* wtot = smem;            // [32] max of each warp's Q this row
    float* wx = wtot + 32;         // [32] the same without its last lane
    float* eHG = wx + 32;          // [32] H + go of each warp's first lane
    float* eF = eHG + 32;          // [32] F of each warp's first lane
    float* red = eF + 32;          // [32] reduction scratch
    unsigned long long* redk = reinterpret_cast<unsigned long long*>(
        red + 32);                 // [32]
    float* tab = reinterpret_cast<float*>(redk + 32);   // [A * A]

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nw = blockDim.x >> 5;
    const int W = g.W, A = g.A;
    for (int x = tid; x < A * A; x += blockDim.x) tab[x] = g.table[x];

    const int slen = g.s_lens[b], tlen = g.t_lens[b];
    const int dmax = g.dmax[b], weff = g.w_eff[b];
    const int8_t* srow = g.s + (size_t)b * g.LS;
    const int8_t* trow = g.t + (size_t)b * g.LT;
    const bool local_start = g.flags & LOCAL_START;
    const bool free_start = g.flags & FREE_START_EDGES;
    const bool track_local = g.flags & LOCAL_END;
    const bool track_col = g.flags & FREE_END_EDGES;
    const bool track_end = g.with_dirs && (track_local || track_col);
    const float go = g.go, ge = g.ge;
    const int k0 = tid * LPT;

    // A[0]: lane 0's E-chain seed, shr() fills NEG
    const float A0 = NEGF + g.gg;
    float H[LPT], F[LPT], bv[LPT], lb[LPT], gek[LPT], cg1[LPT];
    int lkey[LPT];
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const int k = k0 + m;
        gek[m] = ge * (float)k;
        cg1[m] = g.gg - ge * (float)(k + 1);     // cgek of lane k + 1
        const int j0 = k - dmax;
        const bool valid0 = j0 >= 0 && j0 <= tlen && k < weff;
        float h0 = 0.0f;
        if (!(local_start || free_start) && j0 > 0)
            h0 = go + ge * (float)j0;
        H[m] = valid0 ? h0 : NEGF;
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
    if (lane == 0) {
        eHG[warp] = H[0] + go;
        eF[warp] = F[0];
    }
    __syncthreads();

    for (int i = 1; i <= slen; ++i) {
        const int sc = srow[i - 1];
        // (H + go, F) of lane k0 + LPT in row i - 1: the next thread's
        // first lane, through shared memory across a warp edge, NEG
        // beyond lane W - 1
        float nHG = __shfl_down_sync(FULL, H[0] + go, 1);
        float nF = __shfl_down_sync(FULL, F[0], 1);
        if (lane == 31) {
            nHG = warp + 1 < nw ? eHG[warp + 1] : NEGF;
            nF = warp + 1 < nw ? eF[warp + 1] : NEGF;
        }
        float diag[LPT], Fn[LPT], Fx[LPT], Hpre[LPT], inc[LPT];
        float run = -CUDART_INF_F;
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const int k = k0 + m;
            const int j = i - dmax + k;
            const int tj = j - 1;
            const int tc = (tj >= 0 && tj < tlen) ? trow[tj] : -1;
            float sub;
            if (tc < 0) {
                sub = NEGF;                       // T PAD poisons the cell
            } else {
                sub = (sc >= 0 && sc < A) ? tab[sc * A + tc] : 0.0f;
            }
            diag[m] = H[m] + sub;
            const float hg_n = m + 1 < LPT ? H[m + 1] + go : nHG;
            const float f_n = m + 1 < LPT ? F[m + 1] : nF;
            if (g.with_dirs) {
                Fx[m] = f_n + ge;
                Fn[m] = fmaxf(hg_n + ge, Fx[m]);
            } else {
                Fn[m] = fmaxf(hg_n, f_n) + ge;
            }
            float hp = fmaxf(diag[m], Fn[m]);
            if (local_start) hp = fmaxf(hp, 0.0f);
            if (free_start && j == 0) hp = fmaxf(hp, 0.0f);
            Hpre[m] = hp;
            // Q = A of lane k + 1; the running max is the local scan
            run = fmaxf(run, hp + cg1[m]);
            inc[m] = run;
        }
        // warp scan of the thread totals
        float x = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, x, off);
            if (lane >= off) x = fmaxf(x, y);
        }
        float excl = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) excl = -CUDART_INF_F;
        if (lane == 31) {
            wtot[warp] = x;
            wx[warp] = LPT > 1 ? fmaxf(excl, inc[LPT > 1 ? LPT - 2 : 0])
                               : excl;
        }
        __syncthreads();
        // carries across warps: max of the warps below, and below that
        float wv = lane < nw ? wtot[lane] : -CUDART_INF_F;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float y = __shfl_up_sync(FULL, wv, off);
            if (lane >= off) wv = fmaxf(wv, y);
        }
        const float c1 = __shfl_sync(FULL, wv, warp > 0 ? warp - 1 : 0);
        const float c2 = __shfl_sync(FULL, wv, warp > 1 ? warp - 2 : 0);
        const float carry = warp > 0 ? c1 : -CUDART_INF_F;
        const float carry2 = warp > 1 ? c2 : -CUDART_INF_F;
        // P at this thread's first lane, then at its other lanes
        const float base = fmaxf(A0, fmaxf(carry, excl));
        float P[LPT];
        P[0] = base;
#pragma unroll
        for (int m = 1; m < LPT; ++m) P[m] = fmaxf(base, inc[m - 1]);
        // P at lane k0 - 1, for the E-extend bit of lane k0
        float Pprev = __shfl_up_sync(FULL, P[LPT - 1], 1);
        if (lane == 0)
            Pprev = warp == 0 ? NEGF
                              : fmaxf(A0, fmaxf(carry2, wx[warp - 1]));

        const int kcol = tlen - i + dmax;
        const size_t row_off = ((size_t)b * g.LS + (size_t)(i - 1)) * W;
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const int k = k0 + m;
            const int j = i - dmax + k;
            const bool ok = k < weff;
            const float E = P[m] + gek[m];
            // dead lanes are masked after the E merge
            const float Hn = ok ? fmaxf(Hpre[m], E) : NEGF;
            const bool valid_j = j >= 0 && j <= tlen && ok;
            if (g.with_dirs) {
                int d = Hn == diag[m] ? 1 : (Hn == E ? 2 : 3);
                if (local_start && Hn == 0.0f && diag[m] < 0.0f) d = 0;
                if (free_start && j == 0 && Hn == 0.0f && Fn[m] < 0.0f)
                    d = 0;
                const float pp = m == 0 ? Pprev : P[m > 0 ? m - 1 : 0];
                const int byte = d + (P[m] == pp ? 4 : 0)
                                 + (Fn[m] == Fx[m] ? 8 : 0);
                g.dirs[row_off + k] = valid_j ? (uint8_t)byte : 0;
            }
            if (track_local) bv[m] = fmaxf(bv[m], Hn);
            if (track_col && k == kcol) bv[m] = fmaxf(bv[m], Hn);
            if (track_end) {
                // step order of a row: local, column, last row
                if (track_local && valid_j && Hn > lb[m]) {
                    lb[m] = Hn;
                    lkey[m] = 3 * i;
                }
                if (track_col && k == kcol && Hn > lb[m]) {
                    lb[m] = Hn;
                    lkey[m] = 3 * i + 1;
                }
                if (track_col && i == slen && valid_j && Hn > lb[m]) {
                    lb[m] = Hn;
                    lkey[m] = 3 * i + 2;
                }
            }
            H[m] = Hn;
            F[m] = Fn[m];
        }
        if (lane == 0) {
            eHG[warp] = H[0] + go;
            eF[warp] = F[0];
        }
        __syncthreads();
    }

    // H holds the pair's last row
    const int kcorner = tlen - slen + dmax;
    float v = -CUDART_INF_F;
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
    const float score = block_max(v, red);
    int ei = g.s_lens[b], ek = kcorner;
    if (track_local || track_col) {
        ei = -1;
        ek = 0;
    }
    if (track_end) {
        float lv = -CUDART_INF_F;
#pragma unroll
        for (int m = 0; m < LPT; ++m) lv = fmaxf(lv, lb[m]);
        const float M = block_max(lv, red);
        unsigned long long key = ~0ull;
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const unsigned long long c =
                ((unsigned long long)lkey[m] << 13) | (unsigned)(k0 + m);
            if (lb[m] == M && c < key) key = c;
        }
        key = block_min(key, redk);
        ei = (int)((key >> 13) / 3);
        ek = (int)(key & 8191);
    }
    if (tid == 0) {
        g.score[b] = score;
        g.ei[b] = ei;
        g.ek[b] = ek;
    }
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches the row sweep over B pairs on `stream` (no synchronisation)
// and returns cudaGetLastError().  All pointers are device pointers;
// W must be a multiple of 128 and at most 4096, A at most 64.  The
// dirs plane [B, LS, W] must be zeroed by the caller: rows past a
// pair's length are not written.
extern "C" int bst_dp_row(const void* s, const void* t, const void* s_lens,
                          const void* t_lens, const void* dmax,
                          const void* w_eff, const void* table, int A,
                          int B, int LS, int LT, int W, int flags,
                          float go, float ge, float gg, void* score,
                          void* ei, void* ek, void* dirs, int with_dirs,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (W < 128 || W % 128 || W > 4096 || A < 1 || A > 64)
        return (int)cudaErrorInvalidValue;
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
    g.with_dirs = with_dirs;
    const size_t smem = sizeof(float) * (5 * 32 + (size_t)A * A)
                        + sizeof(unsigned long long) * 32;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 1024)
        dp_row_kernel<1><<<B, W, smem, st>>>(g);
    else if (W <= 2048)
        dp_row_kernel<2><<<B, W / 2, smem, st>>>(g);
    else
        dp_row_kernel<4><<<B, W / 4, smem, st>>>(g);
    return (int)cudaGetLastError();
}
