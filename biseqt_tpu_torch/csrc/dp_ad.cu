// Antidiagonal dual-pair banded affine-gap DP for Hopper (sm_90a).
//
// Replaces the TPU kernel biseqt_tpu/ops/pallas_dp_ad.py::_kernel
// (launched by _banded_dp_pallas_ad_jit, public banded_dp_pallas_ad).
// The Python wrapper is biseqt_tpu_torch/ops/dp_ad.py, whose plain
// PyTorch twin (_sweep_plain) computes exactly what this kernel does.
//
// What bounds it on this card.  The sweep is a chain of Apad dependent
// antidiagonal steps: every step of a plane row needs the gap values of
// its neighbour lanes from the step before.  Per step and lane the work
// is two byte loads of the sequences, one exchange through shared
// memory and ~40 dependent float and integer operations; the only
// traffic to device memory is the direction plane, half a byte per
// cell, written once and coalesced (~0.8 GB per 512-pair launch at
// W = 256).  So the kernel is bound by instruction issue and by the
// latency of the per-step barrier, not by bytes.
//
// What the design does about it.  One block per plane row (the two
// pairs 2*b2 and 2*b2+1 on complementary parity lanes), one thread per
// lane (two lanes per thread above 1024 lanes, four above 2048).  H, E,
// F and the per-lane maxima stay in registers for the whole sweep; each
// step publishes max(H + go, E), max(H + go, F) and the two gap-extension
// flags to a double-buffered shared array, so one __syncthreads per step
// suffices.  Characters are read straight from the [B, L] code rows
// (no shifted or interleaved streams); the substitution table lives in
// shared memory and serves any alphabet up to 32 letters.  Each thread
// writes its own dirs byte on odd steps, coalesced along the lanes, at
// 64-bit offsets (a plane can pass 2^31 bytes).
//
// Arithmetic follows the reference step for step (drifted state
// H + gd*a, constants absorbing +2*gd, trackers drifting +2*gd per
// update): direction nibbles come from float equality tests, so any
// other rounding would flip ties.  Build with --fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEGF = -1e30f;
constexpr int FREE_START_EDGES = 1;
constexpr int LOCAL_START = 2;
constexpr int FREE_END_EDGES = 4;
constexpr int LOCAL_END = 8;
constexpr int PAD_S = -1;
constexpr int PAD_T = -2;

struct Args {
    const int8_t* s;
    const int8_t* t;
    const int32_t* s_lens;
    const int32_t* t_lens;
    const int32_t* dminq;
    const int32_t* lo;
    const int32_t* hi;
    const float* table;
    int A;
    float pad_sub;
    int B2, LS, LT, W, Apad, R, flags;
    float go, two_gd, rgd;
    double gd;
    float undrift_a, undrift_b;
    float* Ma;
    float* Mb;
    int32_t* Aa;
    int32_t* Ab;
    uint8_t* dirs;
    int with_dirs;
};

template <int LPT>
__global__ void __launch_bounds__(1024)
dp_ad_kernel(Args g) {
    extern __shared__ float smem[];
    const int W = g.W;
    float* sE = smem;                    // [2][W]
    float* sF = sE + 2 * W;              // [2][W]
    float* tab = sF + 2 * W;             // [A * A]
    uint8_t* sFl = reinterpret_cast<uint8_t*>(tab + g.A * g.A);  // [2][W]

    const int b2 = blockIdx.x;
    const int nt = blockDim.x;
    for (int x = threadIdx.x; x < g.A * g.A; x += nt) tab[x] = g.table[x];

    // per-pair scalars as named registers: the pair of a lane changes
    // with the step's parity, and a runtime index into a register array
    // would spill it to local memory
    const int pr0 = 2 * b2, pr1 = 2 * b2 + 1;
    const int dq0 = g.dminq[pr0], dq1 = g.dminq[pr1];
    const int sl0 = g.s_lens[pr0], sl1 = g.s_lens[pr1];
    const int tl0 = g.t_lens[pr0], tl1 = g.t_lens[pr1];
    const int8_t* srow0 = g.s + (size_t)pr0 * g.LS;
    const int8_t* srow1 = g.s + (size_t)pr1 * g.LS;
    const int8_t* trow0 = g.t + (size_t)pr0 * g.LT;
    const int8_t* trow1 = g.t + (size_t)pr1 * g.LT;
    const int sltl0 = sl0 + tl0, sltl1 = sl1 + tl1;
    const int kc0 = sl0 - tl0 - dq0, kc1 = sl1 - tl1 - dq1;
    const bool local_start = g.flags & LOCAL_START;
    const bool free_start = g.flags & FREE_START_EDGES;
    const bool corner_seed = !(local_start || free_start);
    const bool track_local = g.flags & LOCAL_END;
    const bool track_rays = !track_local && (g.flags & FREE_END_EDGES);

    int k[LPT];
    float okf0[LPT], okf1[LPT];   // additive live-lane masks of each pair
    float H2[LPT], H1[LPT], E[LPT], F[LPT], M0[LPT], M1[LPT];
    int A0[LPT], A1[LPT], nib[LPT];
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        k[m] = threadIdx.x + m * nt;
        okf0[m] = (k[m] >= g.lo[pr0] && k[m] < g.hi[pr0]) ? 0.0f : NEGF;
        okf1[m] = (k[m] >= g.lo[pr1] && k[m] < g.hi[pr1]) ? 0.0f : NEGF;
        // (0, 0) = 0 for anchored starts: H2 = -sub(0, 0) at its lane
        H2[m] = (corner_seed && (k[m] == -dq0 || k[m] == -dq1))
                    ? -g.pad_sub : NEGF;
        H1[m] = E[m] = F[m] = M0[m] = M1[m] = NEGF;
        A0[m] = A1[m] = -1;
        nib[m] = 0;
    }
    __syncthreads();

    const size_t row_bytes = (size_t)g.B2 * W;
    for (int a = 0; a < g.Apad; ++a) {
        const int par = a & 1;
        const int c = a / g.R, r = a - c * g.R;
        const float ga0 = (g.gd != 0.0) ? (float)c * g.rgd : 0.0f;
        const float ga = ga0 + (float)(g.gd * (double)r);
        float* bE = sE + par * W;
        float* bF = sF + par * W;
        uint8_t* bFl = sFl + par * W;
        float sub[LPT], HpGo[LPT];
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const int kk = k[m];
            // lane kk of step a holds a cell of pair (a + kk) % 2
            const bool p1 = (a + kk) & 1;
            const int dq = p1 ? dq1 : dq0;
            const int i = (a + dq + kk) >> 1;
            const int j = (a - dq - kk) >> 1;
            const int sc = (i >= 1 && i - 1 < (p1 ? sl1 : sl0))
                               ? __ldg((p1 ? srow1 : srow0) + i - 1) : PAD_S;
            const int tc = (j >= 1 && j - 1 < (p1 ? tl1 : tl0))
                               ? __ldg((p1 ? trow1 : trow0) + j - 1) : PAD_T;
            sub[m] = (sc < 0 || tc < 0) ? g.pad_sub : tab[sc * g.A + tc];
            HpGo[m] = H1[m] + g.go;
            bE[kk] = fmaxf(HpGo[m], E[m]);
            bF[kk] = fmaxf(HpGo[m], F[m]);
            bFl[kk] = (uint8_t)((E[m] >= HpGo[m] ? 1 : 0)
                                | (F[m] >= HpGo[m] ? 2 : 0));
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m < LPT; ++m) {
            const int kk = k[m];
            const bool p1 = (a + kk) & 1;
            const int kr = (kk + 1 == W) ? 0 : kk + 1;   // E-pred lane
            const int kl = (kk == 0) ? W - 1 : kk - 1;    // F-pred lane
            // circular neighbours, NEG on the wrapped band edge: the
            // gap carries are never damped on dead lanes, so a wrapped
            // value would forge a band-crossing path
            E[m] = bE[kr] + ((kk == W - 1) ? NEGF : 0.0f);
            F[m] = bF[kl] + ((kk == 0) ? NEGF : 0.0f);
            const int e4 = (bFl[kr] & 1) ? 4 : 0;
            const int f8 = (bFl[kl] & 2) ? 8 : 0;
            const float diag = H2[m] + sub[m];
            float Hn = fmaxf(fmaxf(diag, E[m]), F[m]);
            if (local_start) Hn = fmaxf(Hn, ga);
            if (free_start) {
                const bool ray = kk == -dq0 - a || kk == a - dq0
                                 || kk == -dq1 - a || kk == a - dq1;
                Hn = fmaxf(Hn, ray ? ga : NEGF);
            }
            if (g.with_dirs) {
                int d = (Hn == diag) ? 1 : ((Hn == E[m]) ? 2 : 3);
                if (local_start && Hn == ga && diag < ga) d = 0;
                const int byte = d + e4 + f8;
                if (par == 0) {
                    nib[m] = byte;
                } else {
                    g.dirs[(size_t)(a >> 1) * row_bytes + (size_t)b2 * W + kk]
                        = (uint8_t)(nib[m] + 16 * byte);
                }
            }
            Hn = Hn + (p1 ? okf1[m] : okf0[m]);
            float tracked;
            if (track_local) {
                tracked = Hn;
            } else if (track_rays) {
                const bool cond =
                    (kk == 2 * sl0 - dq0 - a && a >= sl0 && a <= sltl0)
                    || (kk == a - dq0 - 2 * tl0 && a >= tl0 && a <= sltl0)
                    || (kk == 2 * sl1 - dq1 - a && a >= sl1 && a <= sltl1)
                    || (kk == a - dq1 - 2 * tl1 && a >= tl1 && a <= sltl1);
                tracked = cond ? Hn : NEGF;
            } else {
                const bool cond = (a == sltl0 && kk == kc0)
                                  || (a == sltl1 && kk == kc1);
                tracked = cond ? Hn : NEGF;
            }
            // trackers drift +2 gd per own update
            if (par == 0) {
                const float Ms = M0[m] + g.two_gd;
                if (g.with_dirs && tracked > Ms) A0[m] = a;
                M0[m] = fmaxf(Ms, tracked);
            } else {
                const float Ms = M1[m] + g.two_gd;
                if (g.with_dirs && tracked > Ms) A1[m] = a;
                M1[m] = fmaxf(Ms, tracked);
            }
            H2[m] = H1[m];
            H1[m] = Hn;
        }
    }
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const size_t o = (size_t)b2 * W + k[m];
        g.Ma[o] = M0[m] - g.undrift_a;
        g.Mb[o] = M1[m] - g.undrift_b;
        g.Aa[o] = A0[m];
        g.Ab[o] = A1[m];
    }
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches the sweep over B2 plane rows on `stream` (no synchronisation)
// and returns cudaGetLastError().  All pointers are device pointers;
// W must be even and at most 4096 (a multiple of 4 above 2048), A at
// most 32.
extern "C" int bst_dp_ad(const void* s, const void* t, const void* s_lens,
                         const void* t_lens, const void* dminq,
                         const void* lo, const void* hi, const void* table,
                         int A, float pad_sub, int B2, int LS, int LT, int W,
                         int Apad, int R, int flags, float go, float two_gd,
                         float rgd, double gd, float undrift_a,
                         float undrift_b, void* Ma, void* Mb, void* Aa,
                         void* Ab, void* dirs, int with_dirs, int device,
                         void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (W < 2 || W % 2 || W > 4096 || (W > 2048 && W % 4) || A < 1 || A > 32
        || R < 1)
        return (int)cudaErrorInvalidValue;
    if (B2 == 0 || Apad == 0) return 0;
    Args g;
    g.s = static_cast<const int8_t*>(s);
    g.t = static_cast<const int8_t*>(t);
    g.s_lens = static_cast<const int32_t*>(s_lens);
    g.t_lens = static_cast<const int32_t*>(t_lens);
    g.dminq = static_cast<const int32_t*>(dminq);
    g.lo = static_cast<const int32_t*>(lo);
    g.hi = static_cast<const int32_t*>(hi);
    g.table = static_cast<const float*>(table);
    g.A = A;
    g.pad_sub = pad_sub;
    g.B2 = B2; g.LS = LS; g.LT = LT; g.W = W; g.Apad = Apad; g.R = R;
    g.flags = flags;
    g.go = go; g.two_gd = two_gd; g.rgd = rgd; g.gd = gd;
    g.undrift_a = undrift_a; g.undrift_b = undrift_b;
    g.Ma = static_cast<float*>(Ma);
    g.Mb = static_cast<float*>(Mb);
    g.Aa = static_cast<int32_t*>(Aa);
    g.Ab = static_cast<int32_t*>(Ab);
    g.dirs = static_cast<uint8_t*>(dirs);
    g.with_dirs = with_dirs;
    const size_t smem = sizeof(float) * (4 * (size_t)W + (size_t)A * A)
                        + 2 * (size_t)W;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 1024) {
        dp_ad_kernel<1><<<B2, W, smem, st>>>(g);
    } else if (W <= 2048) {
        dp_ad_kernel<2><<<B2, W / 2, smem, st>>>(g);
    } else {
        // 18 W + 4 A^2 bytes pass the 48 KB default above W ~2700
        err = cudaFuncSetAttribute(dp_ad_kernel<4>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        dp_ad_kernel<4><<<B2, W / 4, smem, st>>>(g);
    }
    return (int)cudaGetLastError();
}
