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
// memory and ~20 dependent float operations; the only traffic to device
// memory is the direction plane, half a byte per cell, written once and
// coalesced (~0.8 GB per 512-pair launch at W = 256).  So the kernel is
// bound by the latency of the per-step chain (exchange, barrier,
// recurrence) and by instruction issue, not by bytes.
//
// What the design does about it.  One block per plane row (the two
// pairs 2*b2 and 2*b2+1 on complementary parity lanes), one thread per
// lane (two lanes per thread above 1024 lanes, four above 2048).  Above
// 4096 lanes a plane row is a thread-block cluster of nb blocks (at most
// 8, or 16 where the card schedules such a cluster), each running the
// same step body on its own contiguous W / nb lanes (2 lanes a thread up
// to 16384 lanes, 4 above); a block's edge lanes read the neighbour
// block's publish array through distributed shared memory and the step's
// barrier is the cluster's.  H, E,
// F and the per-lane maxima stay in registers for the whole sweep; each
// step publishes max(H + go, E), max(H + go, F) and the two gap-extension
// flags to a double-buffered shared array, so one __syncthreads per step
// suffices.  The step loop is unrolled by two: in the even half lane k
// holds pair k & 1, in the odd half the other pair, so each lane's pair
// constants (lengths, code rows, live mask) are set up once and the step
// parity (nibble merge, dirs store, trackers, shared buffer) is static.
// Sequence positions are counters that advance once per pair of steps;
// the drift's chunk index and in-chunk step are counters too (no
// division).  The mode is a template parameter: the main path's local
// mode, with and without directions, has its own instances, every other
// flag set runs on an instance that reads the flags at run time.  At
// the end of step a, after its dependent chain, the substitution score
// of step a + 1 is looked up from codes loaded at the end of step a - 1,
// and the codes of step a + 2 are loaded, so no load or lookup sits
// between a step's publish and its barrier and each load has a whole
// step to arrive (the loads are volatile: left to itself the compiler
// sinks them to their use).  Characters are read straight from the
// [B, L] code rows; the substitution table lives in dynamic shared
// memory, A * A + 1 floats for any alphabet the int8 codes hold (at most
// 127 letters), the pad's score in the extra slot, so the lookup needs
// no branch.  Each thread writes its
// own dirs byte on odd steps, coalesced along the lanes, through a row
// pointer advanced each pair of steps (a plane can pass 2^31 bytes).
//
// How many blocks run at once sets the step's pace: with one block per
// SM the chain's latency binds, with the four that fit at W = 256
// (registers limit them) issue does.  A launch's time per plane row
// still falls past one wave of resident blocks (measured up to four
// waves), so the caller puts as many rows in a launch as memory allows.
//
// Arithmetic follows the reference step for step (drifted state
// H + gd*a, constants absorbing +2*gd, trackers drifting +2*gd per
// update): direction nibbles come from float equality tests, so any
// other rounding would flip ties.  Build with --fmad=false.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEGF = -1e30f;
constexpr int FREE_START_EDGES = 1;
constexpr int LOCAL_START = 2;
constexpr int FREE_END_EDGES = 4;
constexpr int LOCAL_END = 8;
constexpr int WITH_DIRS = 16;
constexpr int RUNTIME_MODE = -1;     // flags and with_dirs read from Args
// the main path (extend_segments): local mode, with and without dirs
constexpr int MAIN_MODE = LOCAL_START | LOCAL_END | WITH_DIRS;
constexpr int MAIN_SCORE_MODE = LOCAL_START | LOCAL_END;
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

// *p where `in` holds, else `pad`; no branch.  The load is volatile so
// that the compiler issues it where the code places it, a step before
// its use, and does not sink it past the barrier to that use.
__device__ __forceinline__ int load_code(const int8_t* p, bool in, int pad) {
    int v = pad;
    asm volatile(
        "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t"
        "@q ld.global.nc.s8 %0, [%1];\n\t}"
        : "+r"(v) : "l"(p), "r"((unsigned)in));
    return v;
}

// The step's barrier: the block's, or the cluster's (release and
// acquire at cluster scope, so the publish arrays of every block of the
// plane row are visible after it).
template <bool CL>
__device__ __forceinline__ void step_barrier() {
    if constexpr (CL)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

// LPT lanes per thread, lane m of thread t is t + m * blockDim.x.  ODD:
// blockDim.x is odd, so lanes m and m + 1 of a thread have opposite
// parities and lane m holds, in half h, the pair lane 0 holds in half
// h ^ (m & 1).  CL: the block is rank r of a cluster of nb = W / Wb
// blocks that share plane row blockIdx.x / nb, and holds its lanes
// [r * Wb, (r + 1) * Wb), Wb = LPT * blockDim.x (even, so a lane's
// parity is its thread's); lane m of thread t is r * Wb + t + m * nt.
template <int LPT, bool ODD, int MODE, bool CL = false>
__global__ void __launch_bounds__(1024)
dp_ad_kernel(Args g) {
    static_assert(!(CL && ODD), "a cluster's blocks have even widths");
    extern __shared__ float smem[];
    const int W = g.W;
    const int nt = blockDim.x;
    const int Wb = CL ? LPT * nt : W;    // the lanes of this block
    float* sE = smem;                    // [2][Wb]
    float* sF = sE + 2 * Wb;             // [2][Wb]
    float* tab = sF + 2 * Wb;            // [A * A + 1]: the pad's last
    const int pad_slot = g.A * g.A;
    uint8_t* sFl = reinterpret_cast<uint8_t*>(tab + pad_slot + 1);  // [2][Wb]

    const int nb = CL ? W / Wb : 1;
    const int b2 = CL ? blockIdx.x / nb : blockIdx.x;
    const int rank = CL ? blockIdx.x - b2 * nb : 0;
    const int k0 = rank * Wb;            // the block's first lane
    const int tid = threadIdx.x;
    for (int x = tid; x < pad_slot; x += nt) tab[x] = g.table[x];
    if (tid == 0) tab[pad_slot] = g.pad_sub;
    // the neighbour blocks' publish arrays (cyclic, as the band's lanes
    // are): the lane above this block's top is lane 0 of rank + 1, the
    // lane below its lane 0 is lane Wb - 1 of rank - 1
    const float* upE = sE;
    const uint8_t* upFl = sFl;
    const float* dnF = sF;
    const uint8_t* dnFl = sFl;
    if constexpr (CL) {
        cg::cluster_group cluster = cg::this_cluster();
        const unsigned up = rank + 1 == nb ? 0 : rank + 1;
        const unsigned dn = rank == 0 ? nb - 1 : rank - 1;
        upE = cluster.map_shared_rank(sE, up);
        upFl = cluster.map_shared_rank(sFl, up);
        dnF = cluster.map_shared_rank(sF, dn) + Wb - 1;
        dnFl = cluster.map_shared_rank(sFl, dn) + Wb - 1;
    }

    const int mode = MODE == RUNTIME_MODE
                         ? g.flags | (g.with_dirs ? WITH_DIRS : 0) : MODE;
    const bool local_start = mode & LOCAL_START;
    const bool free_start = mode & FREE_START_EDGES;
    const bool corner_seed = !(local_start || free_start);
    const bool track_local = mode & LOCAL_END;
    const bool track_rays = !track_local && (mode & FREE_END_EDGES);
    const bool with_dirs = mode & WITH_DIRS;

    const int pr0 = 2 * b2, pr1 = 2 * b2 + 1;
    const int dq0 = g.dminq[pr0], dq1 = g.dminq[pr1];
    // per half h of a pair of steps (step a = 2c + h), the pair that
    // lane 0 of this thread holds, its lengths and its code rows
    int slH[2], tlH[2];
    const int8_t* sH[2];
    const int8_t* tH[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int pr = pr0 + ((h + tid) & 1);
        slH[h] = g.s_lens[pr];
        tlH[h] = g.t_lens[pr];
        sH[h] = g.s + (size_t)pr * g.LS;
        tH[h] = g.t + (size_t)pr * g.LT;
    }
    const int lo0 = g.lo[pr0], hi0 = g.hi[pr0];
    const int lo1 = g.lo[pr1], hi1 = g.hi[pr1];

    // per lane m and half h: the cell of step 2c + h is (i, j) =
    // (c + SI + 1, c + TJ + 1) of the lane's pair; okf is the pair's
    // additive live-lane mask
    int SI[2][LPT], TJ[2][LPT];
    float okf[2][LPT];
    float H2[LPT], H1[LPT], E[LPT], F[LPT], M0[LPT], M1[LPT], sub[LPT];
    int A0[LPT], A1[LPT], nib[LPT], sc[LPT], tc[LPT];
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const int kk = k0 + tid + m * nt;
        const float ok0 = (kk >= lo0 && kk < hi0) ? 0.0f : NEGF;
        const float ok1 = (kk >= lo1 && kk < hi1) ? 0.0f : NEGF;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // lane kk holds pair (a + kk) % 2 at step a; a + dq + kk is
            // then even, so the halvings are exact
            const bool p1 = (h + kk) & 1;
            const int dq = p1 ? dq1 : dq0;
            okf[h][m] = p1 ? ok1 : ok0;
            SI[h][m] = ((h + dq + kk) >> 1) - 1;
            TJ[h][m] = ((h - dq - kk) >> 1) - 1;
        }
        // (0, 0) = 0 for anchored starts: H2 = -sub(0, 0) at its lane
        H2[m] = (corner_seed && (kk == -dq0 || kk == -dq1))
                    ? -g.pad_sub : NEGF;
        H1[m] = E[m] = F[m] = M0[m] = M1[m] = NEGF;
        A0[m] = A1[m] = -1;
        nib[m] = 0;
    }

    // the codes of half h, counter c, lane m (pads outside the pair)
    auto codes = [&](int h, int c, int m, int& s, int& t) {
        const int hh = (ODD && (m & 1)) ? h ^ 1 : h;
        const int si = c + SI[h][m], tj = c + TJ[h][m];
        s = load_code(sH[hh] + si, (unsigned)si < (unsigned)slH[hh], PAD_S);
        t = load_code(tH[hh] + tj, (unsigned)tj < (unsigned)tlH[hh], PAD_T);
    };
    auto lookup = [&](int s, int t) {
        return tab[(s < 0 || t < 0) ? pad_slot : s * g.A + t];
    };
    // in a cluster: every block has started before any reads another's
    // shared memory
    step_barrier<CL>();
    // the substitution score of step 0 and the codes of step 1
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        codes(0, 0, m, sc[m], tc[m]);
        sub[m] = lookup(sc[m], tc[m]);
        codes(1, 0, m, sc[m], tc[m]);
    }

    const size_t row_bytes = (size_t)g.B2 * W;
    uint8_t* drow = g.dirs + (size_t)b2 * W;
    // the drifted zero of step a is ga0 + f32(gd * r) with chunk index
    // cq = a / R and in-chunk step r = a % R; R is even, so r is even
    // on even steps and wraps only after odd ones
    int cq = 0, r = 0;
    float ga0 = 0.0f;
    for (int a = 0, c = 0; a < g.Apad; a += 2, ++c) {
        const float gaH[2] = {ga0 + (float)(g.gd * (double)r),
                              ga0 + (float)(g.gd * (double)(r + 1))};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float* bE = sE + h * Wb;
            float* bF = sF + h * Wb;
            uint8_t* bFl = sFl + h * Wb;
            const float ga = gaH[h];
            float HpGo[LPT];
#pragma unroll
            for (int m = 0; m < LPT; ++m) {
                const int kx = tid + m * nt;
                HpGo[m] = H1[m] + g.go;
                bE[kx] = fmaxf(HpGo[m], E[m]);
                bF[kx] = fmaxf(HpGo[m], F[m]);
                bFl[kx] = (uint8_t)((E[m] >= HpGo[m] ? 1 : 0)
                                    | (F[m] >= HpGo[m] ? 2 : 0));
            }
            step_barrier<CL>();
#pragma unroll
            for (int m = 0; m < LPT; ++m) {
                const int kx = tid + m * nt;
                const int kk = k0 + kx;
                const int hh = (ODD && (m & 1)) ? h ^ 1 : h;
                // circular neighbours, NEG on the wrapped band edge: the
                // gap carries are never damped on dead lanes, so a
                // wrapped value would forge a band-crossing path
                float eN, fN;
                int flE, flF;
                if constexpr (CL) {
                    // only a thread's top lane can be the block's top,
                    // and only its lane 0 the block's lane 0
                    const bool top = m == LPT - 1 && kx + 1 == Wb;
                    const bool bot = m == 0 && kx == 0;
                    eN = top ? upE[h * Wb] : bE[kx + 1];
                    flE = top ? upFl[h * Wb] : bFl[kx + 1];
                    fN = bot ? dnF[h * Wb] : bF[kx - 1];
                    flF = bot ? dnFl[h * Wb] : bFl[kx - 1];
                } else {
                    const int kr = (kk + 1 == W) ? 0 : kk + 1;   // E-pred
                    const int kl = (kk == 0) ? W - 1 : kk - 1;    // F-pred
                    eN = bE[kr];
                    fN = bF[kl];
                    flE = bFl[kr];
                    flF = bFl[kl];
                }
                E[m] = eN + ((kk == W - 1) ? NEGF : 0.0f);
                F[m] = fN + ((kk == 0) ? NEGF : 0.0f);
                const int e4 = (flE & 1) ? 4 : 0;
                const int f8 = (flF & 2) ? 8 : 0;
                const float diag = H2[m] + sub[m];
                float Hn = fmaxf(fmaxf(diag, E[m]), F[m]);
                if (local_start) Hn = fmaxf(Hn, ga);
                // the cell (si + 1, tj + 1) of the lane's pair; only the
                // lane's own pair can meet the ray and end tests (the
                // other pair's lanes have the other parity)
                const int si = c + SI[h][m], tj = c + TJ[h][m];
                if (free_start) {
                    const bool ray = si == -1 || tj == -1;   // i or j 0
                    Hn = fmaxf(Hn, ray ? ga : NEGF);
                }
                if (with_dirs) {
                    int d = (Hn == diag) ? 1 : ((Hn == E[m]) ? 2 : 3);
                    if (local_start && Hn == ga && diag < ga) d = 0;
                    const int byte = d + e4 + f8;
                    if (h == 0) {
                        nib[m] = byte;
                    } else {
                        drow[kk] = (uint8_t)(nib[m] + 16 * byte);
                    }
                }
                Hn = Hn + okf[h][m];
                float tracked;
                if (track_local) {
                    tracked = Hn;
                } else {
                    const int sl = slH[hh], tl = tlH[hh];
                    bool cond;
                    if (track_rays) {
                        // i == len(s) with 0 <= j <= len(t), or the
                        // same with s and t swapped
                        cond = (si == sl - 1
                                && (unsigned)(tj + 1) <= (unsigned)tl)
                               || (tj == tl - 1
                                   && (unsigned)(si + 1) <= (unsigned)sl);
                    } else {
                        cond = si == sl - 1 && tj == tl - 1;
                    }
                    tracked = cond ? Hn : NEGF;
                }
                // trackers drift +2 gd per own update
                if (h == 0) {
                    const float Ms = M0[m] + g.two_gd;
                    if (with_dirs && tracked > Ms) A0[m] = a;
                    M0[m] = fmaxf(Ms, tracked);
                } else {
                    const float Ms = M1[m] + g.two_gd;
                    if (with_dirs && tracked > Ms) A1[m] = a + 1;
                    M1[m] = fmaxf(Ms, tracked);
                }
                H2[m] = H1[m];
                H1[m] = Hn;
            }
            // off the chain: the substitution score of the next step,
            // from codes loaded a step ago, and the codes of the step
            // after it (step a + h + 2: half h, counter c + 1), which
            // have a whole step to arrive
#pragma unroll
            for (int m = 0; m < LPT; ++m) {
                sub[m] = lookup(sc[m], tc[m]);
                codes(h, c + 1, m, sc[m], tc[m]);
            }
        }
        if (with_dirs) drow += row_bytes;
        r += 2;
        if (r == g.R) {
            r = 0;
            ++cq;
            ga0 = (g.gd != 0.0) ? (float)cq * g.rgd : 0.0f;
        }
    }
#pragma unroll
    for (int m = 0; m < LPT; ++m) {
        const size_t o = (size_t)b2 * W + k0 + tid + m * nt;
        g.Ma[o] = M0[m] - g.undrift_a;
        g.Mb[o] = M1[m] - g.undrift_b;
        g.Aa[o] = A0[m];
        g.Ab[o] = A1[m];
    }
    // in a cluster: no block leaves while a neighbour may still read its
    // shared memory
    if constexpr (CL) cg::this_cluster().sync();
}

// The kernel instance for W lanes (and whether it needs more than the
// default 48 KB of shared memory); its block has W / LPT threads.
template <int MODE>
void (*instance(int W))(Args) {
    if (W <= 1024) return dp_ad_kernel<1, false, MODE>;
    if (W <= 2048) return dp_ad_kernel<2, false, MODE>;
    return dp_ad_kernel<4, false, MODE>;
}

void (*odd_instance(int W))(Args) {
    if (W <= 2048) return dp_ad_kernel<2, true, RUNTIME_MODE>;
    return dp_ad_kernel<4, true, RUNTIME_MODE>;
}

int lanes_per_thread(int W) { return W <= 1024 ? 1 : (W <= 2048 ? 2 : 4); }

size_t smem_bytes(int W, int A) {
    return sizeof(float) * (4 * (size_t)W + (size_t)A * A + 1)
           + 2 * (size_t)W;
}

// The instance that a launch of W lanes under `mode` runs.
void (*pick(int W, int mode))(Args) {
    if ((W / lanes_per_thread(W)) & 1) return odd_instance(W);
    if (mode == MAIN_MODE) return instance<MAIN_MODE>(W);
    if (mode == MAIN_SCORE_MODE) return instance<MAIN_SCORE_MODE>(W);
    return instance<RUNTIME_MODE>(W);
}

// Above 4096 lanes: a cluster of nb blocks per plane row, each of
// W / nb lanes at lpt lanes a thread.  2 lanes a thread (no spills)
// while 8 blocks of at most 1024 threads cover W, else 4; the fewest
// blocks whose width is a multiple of 2 * lpt (so that a lane's parity
// is its thread's).  nb 0: no such cluster of at most MAX_CLUSTER.
constexpr int MAX_CLUSTER = 16;      // the card's non-portable limit
constexpr int PORTABLE_CLUSTER = 8;

void cluster_shape(int W, int& lpt, int& nb) {
    for (lpt = 2; lpt <= 4; lpt *= 2) {
        const int cap = lpt == 2 ? PORTABLE_CLUSTER : MAX_CLUSTER;
        for (nb = (W + 1024 * lpt - 1) / (1024 * lpt); nb <= cap; ++nb)
            if (W % (nb * 2 * lpt) == 0) return;
    }
    lpt = 4;
    nb = 0;
}

template <int MODE>
void (*wide_instance(int lpt))(Args) {
    if (lpt == 2) return dp_ad_kernel<2, false, MODE, true>;
    return dp_ad_kernel<4, false, MODE, true>;
}

// The cluster instance that a launch of W > 4096 lanes under `mode` runs.
void (*pick_wide(int lpt, int mode))(Args) {
    if (mode == MAIN_MODE) return wide_instance<MAIN_MODE>(lpt);
    if (mode == MAIN_SCORE_MODE) return wide_instance<MAIN_SCORE_MODE>(lpt);
    return wide_instance<RUNTIME_MODE>(lpt);
}

// W: even, a multiple of 4 above 2048 and of 128 above 4096, with a
// cluster shape; A: what int8 codes hold.
bool bad_shape(int W, int A) {
    if (W < 2 || W % 2 || (W > 2048 && W % 4) || A < 1 || A > 127)
        return true;
    if (W <= 4096) return false;
    int lpt, nb;
    cluster_shape(W, lpt, nb);
    return W % 128 || nb == 0;
}

// The launch of W > 4096 lanes: its kernel, block, shared memory and
// cluster attribute (non-portable sizes allowed above 8 blocks).
cudaError_t wide_config(int W, int A, int mode, int B2, cudaStream_t st,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                        void (*&kernel)(Args)) {
    int lpt, nb;
    cluster_shape(W, lpt, nb);
    kernel = pick_wide(lpt, mode);
    const int Wb = W / nb;
    const size_t smem = smem_bytes(Wb, A);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && nb > PORTABLE_CLUSTER)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)B2 * nb);
    cfg.blockDim = dim3(Wb / lpt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = nb;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return err;
}

}  // namespace

extern "C" const char* bst_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The cluster that a launch of W > 4096 lanes runs (blocks, lanes a
// thread) and how many such clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot run one), or a negative
// CUDA error.  W <= 4096: one block, 0 lanes a thread reported.
extern "C" int bst_dp_ad_cluster(int W, int A, int with_dirs, int device,
                                 int* blocks, int* lanes_per_thread_out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    if (bad_shape(W, A)) return -(int)cudaErrorInvalidValue;
    if (W <= 4096) {
        *blocks = 1;
        *lanes_per_thread_out = 0;
        return 1;
    }
    int lpt, nb;
    cluster_shape(W, lpt, nb);
    *blocks = nb;
    *lanes_per_thread_out = lpt;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    void (*kernel)(Args);
    err = wide_config(W, A, MAIN_MODE & (with_dirs ? ~0 : ~WITH_DIRS), 1,
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

// Launches the sweep over B2 plane rows on `stream` (no synchronisation)
// and returns cudaGetLastError().  All pointers are device pointers;
// W must be even, a multiple of 4 above 2048 and of 128 above 4096
// (there a cluster of blocks a plane row, at most 16), A at most 127,
// R and Apad even.
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
    if (bad_shape(W, A) || R < 2 || R % 2 || Apad % 2)
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
    const int mode = flags | (with_dirs ? WITH_DIRS : 0);
    if (W > 4096) {
        cudaLaunchConfig_t cfg;
        cudaLaunchAttribute attr;
        void (*kernel)(Args);
        err = wide_config(W, A, mode, B2, static_cast<cudaStream_t>(stream),
                          cfg, attr, kernel);
        if (err != cudaSuccess) return (int)err;
        err = cudaLaunchKernelEx(&cfg, kernel, g);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaGetLastError();
    }
    const size_t smem = smem_bytes(W, A);
    void (*kernel)(Args) = pick(W, mode);
    if (smem > 48 * 1024) {
        // 18 W + 4 A^2 bytes pass the 48 KB default above W ~2700
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<B2, W / lanes_per_thread(W), smem,
             static_cast<cudaStream_t>(stream)>>>(g);
    return (int)cudaGetLastError();
}
