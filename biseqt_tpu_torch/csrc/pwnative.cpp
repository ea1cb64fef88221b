// pwnative: host-side affine-gap banded DP engine + FASTA packer.
//
// The native runtime component of biseqt_tpu (the role pwlib's C engine
// played in the reference — rebuilt from the recurrences, not translated):
//  * serves host-side alignment (serving/debug/oracle) at C speed,
//  * provides exact traceback for results the TPU kernel scored,
//  * streams FASTA text into packed int8 code buffers for device upload.
//
// Conventions match biseqt_tpu.ops.banded_dp exactly:
//  * band: diagonals d = i - j in [dmin, dmax]; cell (i, j), i=0..ls,
//    j=0..lt; gap run of length g scores go + g*ge (go <= 0).
//  * modes via flags: FREE_START_EDGES | LOCAL_START | FREE_END_EDGES |
//    LOCAL_END (global = 0); see ModeFlags in the Python engine.
//  * direction bytes: bits 0-1 H-source (0 stop, 1 diag, 2 left/E,
//    3 up/F), bit 2 E-extend, bit 3 F-extend — identical to the lax
//    engine so either producer's bytes feed either walker.
//
// Build: make (g++ -O3 -shared); binding: ctypes (biseqt_tpu/native).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

namespace {
constexpr float NEG = -1e30f;

enum ModeFlags {
    FREE_START_EDGES = 1,
    LOCAL_START = 2,
    FREE_END_EDGES = 4,
    LOCAL_END = 8,
};
}  // namespace

extern "C" {

// ABI version — bump on ANY exported-signature change.  The ctypes
// binding hard-fails on mismatch: loading a stale prebuilt .so against
// a newer argtypes table shifts every subsequent pointer argument
// (silent memory corruption), which a RuntimeWarning cannot prevent.
// History: 1 = round-4 layout (bst_traceback_ad_batch b2_cols,
// bst_traceback_ad row_stride); 2 = round-5 lane-packed sweep
// compactor (bst_compact_sweep_batch_t).
int bst_abi_version() { return 2; }

// Banded (or full: dmin=-lt, dmax=ls) affine-gap DP.
// dirs: optional output, (ls x W) bytes with W = dmax - dmin + 1 (row i
// stored at (i-1)*W); pass nullptr for score-only.
// Returns 0 on success, -1 on invalid arguments.
int bst_align(const int8_t* s, int ls, const int8_t* t, int lt,
              const float* subst, int A, float go, float ge,
              int dmin, int dmax, int flags,
              float* score_out, int* end_i, int* end_j,
              uint8_t* dirs) {
    if (ls < 0 || lt < 0 || A <= 0 || dmin > dmax || go > 0) return -1;
    const int W = dmax - dmin + 1;
    const bool local_start = flags & LOCAL_START;
    const bool free_start = flags & FREE_START_EDGES;
    const bool local_end = flags & LOCAL_END;
    const bool free_end = flags & FREE_END_EDGES;

    // rows indexed by diagonal lane k: d = dmax - k, j = i - dmax + k
    std::vector<float> H(W, NEG), F(W, NEG), Hn(W), Fn(W), E(W);
    for (int k = 0; k < W; ++k) {
        long j = (long)k - dmax;
        if (j < 0 || j > lt) continue;
        if (local_start || free_start) H[k] = 0.0f;
        else H[k] = j > 0 ? go + ge * (float)j : 0.0f;
    }

    float best = NEG;
    int best_i = 0, best_k = 0;
    float corner = NEG;

    for (int i = 1; i <= ls; ++i) {
        const int8_t sc = s[i - 1];
        float e_prev = NEG;  // E at lane k-1 (within-row chain)
        float hp_prev = NEG; // H_pre at lane k-1
        for (int k = 0; k < W; ++k) {
            long j = (long)i - dmax + k;
            if (j < 0 || j > lt) {
                Hn[k] = NEG;
                Fn[k] = NEG;
                if (dirs) dirs[(size_t)(i - 1) * W + k] = 0;
                e_prev = NEG;
                hp_prev = NEG;
                continue;
            }
            // F (up): pred lane k+1 of previous row
            float f_open = (k + 1 < W ? H[k + 1] : NEG) + go + ge;
            float f_ext = (k + 1 < W ? F[k + 1] : NEG) + ge;
            float f = std::max(f_open, f_ext);
            // diag: same lane, previous row
            float diag = NEG;
            if (j >= 1) {
                float sub = subst[(int)sc * A + (int)t[j - 1]];
                diag = H[k] + sub;
            }
            float h_pre = std::max(diag, f);
            if (local_start) h_pre = std::max(h_pre, 0.0f);
            if (free_start && j == 0) h_pre = std::max(h_pre, 0.0f);
            // E (left): within-row chain from lane k-1
            float e_open = hp_prev + go + ge;
            float e_ext = e_prev + ge;
            float e = std::max(e_open, e_ext);
            float h = std::max(h_pre, e);

            if (dirs) {
                uint8_t b;
                if (h == diag) b = 1;
                else if (h == e) b = 2;
                else b = 3;
                if (local_start && h == 0.0f && diag < 0.0f) b = 0;
                if (free_start && j == 0 && h == 0.0f && f < 0.0f) b = 0;
                if (e == e_ext && e > NEG / 2) b |= 4;
                if (f == f_ext && f > NEG / 2) b |= 8;
                dirs[(size_t)(i - 1) * W + k] = b;
            }

            Hn[k] = h;
            Fn[k] = f;
            e_prev = e;
            hp_prev = h_pre;

            if (local_end && h > best) { best = h; best_i = i; best_k = k; }
            if (free_end) {
                if ((j == lt || i == ls) && h > best) {
                    best = h; best_i = i; best_k = k;
                }
            }
            if (i == ls && j == lt) corner = h;
        }
        H.swap(Hn);
        F.swap(Fn);
    }

    float score;
    int ei, ek;
    if (local_end || free_end) { score = best; ei = best_i; ek = best_k; }
    else { score = corner; ei = ls; ek = lt - ls + dmax; }
    if (score_out) *score_out = score;
    if (end_i) *end_i = ei;
    if (end_j) *end_j = (int)((long)ei - dmax + ek);
    return 0;
}

// Traceback over direction bytes (either engine's). ops buffer must hold
// at least ls+lt+2 bytes; returns transcript length, and writes the
// 0-based start coordinates. Boundary handling mirrors the lax walker:
// global-like starts consume the remaining prefix as I/D runs.
int bst_traceback(const uint8_t* dirs, int W, int dmax,
                  const int8_t* s, int ls, const int8_t* t, int lt,
                  int end_i, int end_j, int flags,
                  char* ops, int* start_i, int* start_j) {
    const bool anchored_start =
        !(flags & (LOCAL_START | FREE_START_EDGES));
    int i = end_i, j = end_j;
    int n = 0;
    int state = 0;  // 0 = H, 1 = E, 2 = F
    for (;;) {
        if (state == 0) {
            if (i == 0 || j == 0) break;
            int k = j - i + dmax;
            if (k < 0 || k >= W) return -1;
            uint8_t b = dirs[(size_t)(i - 1) * W + k];
            int src = b & 3;
            if (src == 0) break;
            if (src == 1) {
                ops[n++] = (s[i - 1] == t[j - 1]) ? 'M' : 'S';
                --i; --j;
            } else if (src == 2) state = 1;
            else state = 2;
        } else if (state == 1) {
            int k = j - i + dmax;
            if (i < 1 || k < 0 || k >= W) return -1;
            uint8_t b = dirs[(size_t)(i - 1) * W + k];
            ops[n++] = 'I';
            --j;
            if (!((b >> 2) & 1) || j == 0) state = 0;
        } else {
            int k = j - i + dmax;
            if (i < 1 || k < 0 || k >= W) return -1;
            uint8_t b = dirs[(size_t)(i - 1) * W + k];
            ops[n++] = 'D';
            --i;
            if (!((b >> 3) & 1) || i == 0) state = 0;
        }
    }
    if (anchored_start) {
        while (j > 0) { ops[n++] = 'I'; --j; }
        while (i > 0) { ops[n++] = 'D'; --i; }
    }
    std::reverse(ops, ops + n);
    ops[n] = '\0';
    if (start_i) *start_i = i;
    if (start_j) *start_j = j;
    return n;
}

// Batched traceback: walk B pairs' direction-byte planes in one call —
// the at-scale companion of the TPU kernel's with_dirs output (a Python
// per-pair loop over 256 x 10 kbp walks costs seconds; this is microseconds
// per pair).  dirs: [B, rows_cap, W] contiguous; s/t: [B, ls_cap/lt_cap];
// per-pair lengths/ends/dmax; ops_out: [B, ops_stride] NUL-terminated.
// Returns 0; per-pair transcript lengths in ops_len (-1 = walk error).
int bst_traceback_batch(const uint8_t* dirs, int rows_cap, int W,
                        const int32_t* dmax,
                        const int8_t* s, int ls_cap,
                        const int8_t* t, int lt_cap,
                        const int32_t* s_lens, const int32_t* t_lens,
                        const int32_t* end_i, const int32_t* end_j,
                        int flags, int B, int ops_stride,
                        char* ops_out, int32_t* start_i, int32_t* start_j,
                        int32_t* ops_len) {
    for (int b = 0; b < B; ++b) {
        int si = 0, sj = 0;
        int n = bst_traceback(
            dirs + (size_t)b * rows_cap * W, W, dmax[b],
            s + (size_t)b * ls_cap, s_lens[b],
            t + (size_t)b * lt_cap, t_lens[b],
            end_i[b], end_j[b], flags,
            ops_out + (size_t)b * ops_stride, &si, &sj);
        start_i[b] = si;
        start_j[b] = sj;
        ops_len[b] = n;
    }
    return 0;
}

// Traceback over PACKED antidiagonal-layout direction nibbles (the
// dual-pair Pallas kernel's with_dirs output).  The nibble of cell
// (i, j) lives in byte dirs[((i + j) / 2) * row_stride + ((i - j) -
// dminq)] — low nibble for even antidiagonal a = i + j, high nibble
// for odd — where dminq is the pair's parity-adjusted band start
// (dmin + (pair % 2 - dmin) mod 2); rows_packed = Apad / 2 byte rows
// cover Apad antidiagonal steps.  row_stride is the byte distance
// between consecutive packed rows: the TPU kernel emits the plane
// ROW-MAJOR [a/2, b2, x] (full-tile stores), so a pair's plane is a
// strided column view with row_stride = B2 * W.  The two pairs packed
// into one plane occupy complementary (a + x) parities, so a walk
// never reads the other pair's slots.  Same nibble semantics (bits
// 0-1 H-source, bit 2 E-extend, bit 3 F-extend) and boundary handling
// as bst_traceback.
int bst_traceback_ad(const uint8_t* dirs, int rows_packed,
                     size_t row_stride, int W, int dminq,
                     const int8_t* s, int ls, const int8_t* t, int lt,
                     int end_i, int end_j, int flags,
                     char* ops, int* start_i, int* start_j) {
    const bool anchored_start =
        !(flags & (LOCAL_START | FREE_START_EDGES));
    int i = end_i, j = end_j;
    int n = 0;
    int state = 0;  // 0 = H, 1 = E, 2 = F
    auto byte_at = [&](int ii, int jj, uint8_t* out) -> bool {
        int a = ii + jj, x = (ii - jj) - dminq;
        if (a < 0 || a >= 2 * rows_packed || x < 0 || x >= W)
            return false;
        uint8_t byte = dirs[(size_t)(a >> 1) * row_stride + x];
        *out = (a & 1) ? (uint8_t)(byte >> 4) : (uint8_t)(byte & 0x0F);
        return true;
    };
    uint8_t b;
    for (;;) {
        if (state == 0) {
            if (i == 0 || j == 0) break;
            if (!byte_at(i, j, &b)) return -1;
            int src = b & 3;
            if (src == 0) break;
            if (src == 1) {
                ops[n++] = (s[i - 1] == t[j - 1]) ? 'M' : 'S';
                --i; --j;
            } else if (src == 2) state = 1;
            else state = 2;
        } else if (state == 1) {
            if (i < 1 || !byte_at(i, j, &b)) return -1;
            ops[n++] = 'I';
            --j;
            if (!((b >> 2) & 1) || j == 0) state = 0;
        } else {
            if (i < 1 || !byte_at(i, j, &b)) return -1;
            ops[n++] = 'D';
            --i;
            if (!((b >> 3) & 1) || i == 0) state = 0;
        }
    }
    if (anchored_start) {
        while (j > 0) { ops[n++] = 'I'; --j; }
        while (i > 0) { ops[n++] = 'D'; --i; }
    }
    std::reverse(ops, ops + n);
    ops[n] = '\0';
    if (start_i) *start_i = i;
    if (start_j) *start_j = j;
    return n;
}

// Batched AD-layout traceback: pairs (2*b2, 2*b2 + 1) share plane
// COLUMN b2 of the row-major dirs [rows_packed, b2_cols, W]
// (nibble-packed: rows_packed = Apad/2); dminq / lengths / ends are
// per PAIR (B of them).  Same outputs as bst_traceback_batch.
int bst_traceback_ad_batch(const uint8_t* dirs, int rows_packed,
                           int b2_cols, int W,
                           const int32_t* dminq,
                           const int8_t* s, int ls_cap,
                           const int8_t* t, int lt_cap,
                           const int32_t* s_lens, const int32_t* t_lens,
                           const int32_t* end_i, const int32_t* end_j,
                           int flags, int B, int ops_stride,
                           char* ops_out, int32_t* start_i,
                           int32_t* start_j, int32_t* ops_len) {
    for (int b = 0; b < B; ++b) {
        int si = 0, sj = 0;
        int n = bst_traceback_ad(
            dirs + (size_t)(b / 2) * W, rows_packed,
            (size_t)b2_cols * W, W, dminq[b],
            s + (size_t)b * ls_cap, s_lens[b],
            t + (size_t)b * lt_cap, t_lens[b],
            end_i[b], end_j[b], flags,
            ops_out + (size_t)b * ops_stride, &si, &sj);
        start_i[b] = si;
        start_j[b] = sj;
        ops_len[b] = n;
    }
    return 0;
}

// Resumable AD-layout traceback over one re-solved antidiagonal WINDOW
// (the band-sharded engine's checkpointed traceback: windows are
// re-solved newest-to-oldest and each is walked through in turn).
// dirs here is UNPACKED — [B2, n_steps, W] full bytes, row r =
// antidiagonal a_base + r — window planes are short-lived re-solve
// output, not the kernel's persistent HBM stream, so there is nothing
// to gain from nibble packing.  Per-pair walk cursors (io_i, io_j,
// io_state 0=H/1=E/2=F, io_done) advance in place; a pair walks only
// while its current antidiagonal i + j lies inside
// [a_base, a_base + n_steps) and pauses at the window's lower edge to
// resume in the previous window.  Emitted ops are BACKWARD (end ->
// start) segments; the Python driver concatenates window segments and
// reverses once (and applies the anchored-start I/D tail).
// ops_len[b] = -1 flags a walk that left the plane (wrong geometry or
// corrupted dirs).
int bst_traceback_ad_window_batch(
        const uint8_t* dirs, int n_steps, int W, int a_base,
        const int32_t* dminq,
        const int8_t* s, int ls_cap, const int8_t* t, int lt_cap,
        int B, int ops_stride,
        int32_t* io_i, int32_t* io_j, int32_t* io_state,
        int32_t* io_done, char* ops_out, int32_t* ops_len) {
    for (int b = 0; b < B; ++b) {
        ops_len[b] = 0;
        if (io_done[b]) continue;
        int i = io_i[b], j = io_j[b], state = io_state[b];
        if ((long)i + j >= (long)a_base + n_steps) continue;  // ends above
        const uint8_t* plane = dirs + (size_t)(b / 2) * n_steps * W;
        const int8_t* sb = s + (size_t)b * ls_cap;
        const int8_t* tb = t + (size_t)b * lt_cap;
        char* ops = ops_out + (size_t)b * ops_stride;
        const int dq = dminq[b];
        int n = 0;
        bool bad = false;
        auto byte_at = [&](int ii, int jj, uint8_t* out) -> bool {
            int a = ii + jj, x = (ii - jj) - dq;
            if (a < a_base || a >= a_base + n_steps || x < 0 || x >= W)
                return false;
            *out = plane[(size_t)(a - a_base) * W + x];
            return true;
        };
        uint8_t bt;
        for (;;) {
            if (i + j < a_base) break;          // resume in prior window
            if (state == 0) {
                if (i == 0 || j == 0) { io_done[b] = 1; break; }
                if (!byte_at(i, j, &bt)) { bad = true; break; }
                int src = bt & 3;
                if (src == 0) { io_done[b] = 1; break; }
                if (src == 1) {
                    ops[n++] = (sb[i - 1] == tb[j - 1]) ? 'M' : 'S';
                    --i; --j;
                } else if (src == 2) state = 1;
                else state = 2;
            } else if (state == 1) {
                if (i < 1 || !byte_at(i, j, &bt)) { bad = true; break; }
                ops[n++] = 'I';
                --j;
                if (!((bt >> 2) & 1) || j == 0) state = 0;
            } else {
                if (i < 1 || !byte_at(i, j, &bt)) { bad = true; break; }
                ops[n++] = 'D';
                --i;
                if (!((bt >> 3) & 1) || i == 0) state = 0;
            }
        }
        io_i[b] = i;
        io_j[b] = j;
        io_state[b] = state;
        ops_len[b] = bad ? -1 : n;
    }
    return 0;
}

// Compact the on-device sweep walker's op traces into MSID transcripts
// (biseqt_tpu.ops.pallas_walk.traceback_sweep produces them: per-pair
// 2-BIT op codes packed 4 per byte — antidiagonal a's code sits in
// bits 2*(a % 4) of byte a / 4 of plane row b/2 of trace b%2 — codes
// 0 none / 1 diag / 2 ins / 3 del).  An op emitted at a is the move
// LEAVING the cell on antidiagonal a, and the backward walk visits
// strictly descending a, so an ascending scan from the walk's final
// cursor (fin_i, fin_j) — the alignment START — replays the path
// forward: diag at (i, j) consumes s[i] / t[j].  Anchored modes
// prepend the D^i I^j tail exactly like bst_traceback's post-walk loop
// (reversed: D's first).  fin_i < 0 marks a skipped pair (empty
// transcript).  atr_bytes = trace bytes per plane row (covers
// 4 * atr_bytes antidiagonals).
int bst_compact_sweep_batch(
        const uint8_t* tr0, const uint8_t* tr1, int atr_bytes,
        const int8_t* s, int ls_cap, const int8_t* t, int lt_cap,
        const int32_t* fin_i, const int32_t* fin_j,
        int flags, int B, int ops_stride,
        char* ops_out, int32_t* ops_len) {
    const bool anchored = !(flags & (LOCAL_START | FREE_START_EDGES));
    const long atr = 4L * atr_bytes;
    for (int b = 0; b < B; ++b) {
        char* ops = ops_out + (size_t)b * ops_stride;
        int i = fin_i[b], j = fin_j[b];
        int n = 0;
        if (i < 0 || j < 0) { ops[0] = '\0'; ops_len[b] = 0; continue; }
        const uint8_t* plane =
            ((b & 1) ? tr1 : tr0) + (size_t)(b / 2) * atr_bytes;
        const int8_t* sb = s + (size_t)b * ls_cap;
        const int8_t* tb = t + (size_t)b * lt_cap;
        bool bad = false;
        if (anchored) {
            // same capacity guard as the replay loop: the prefix is
            // fin-cursor-sized and fin cursors come from the device
            // walk today, but a corrupt/foreign cursor must trip the
            // -1 sentinel, not overflow into the next pair's row
            for (int k = 0; k < i && !bad; ++k) {
                if (n >= ops_stride - 1) bad = true;
                else ops[n++] = 'D';
            }
            for (int k = 0; k < j && !bad; ++k) {
                if (n >= ops_stride - 1) bad = true;
                else ops[n++] = 'I';
            }
        }
        for (long a = i + j; a < atr && !bad; ++a) {
            uint8_t op = (plane[a >> 2] >> (2 * (a & 3))) & 3;
            if (op == 0) continue;
            if (n >= ops_stride - 1) { bad = true; break; }
            if (op == 1) {
                ops[n++] = (sb[i] == tb[j]) ? 'M' : 'S';
                ++i; ++j;
            } else if (op == 2) {
                ops[n++] = 'I'; ++j;
            } else {
                ops[n++] = 'D'; ++i;
            }
        }
        ops[n] = '\0';
        ops_len[b] = bad ? -1 : n;
    }
    return 0;
}

// Compact the LANE-PACKED sweep walker's op traces (round 5,
// biseqt_tpu.ops.pallas_walk.traceback_sweep_t) into MSID transcripts.
// Trace layout [2, atr_bytes, b2_cols]: pair b's codes live in plane
// b % 2, COLUMN b / 2 — antidiagonal a's 2-bit op sits in bits
// 2*(a % 4) of byte tr[(b & 1) * atr_bytes * b2_cols +
// (a >> 2) * b2_cols + (b >> 1)].  Same replay semantics as
// bst_compact_sweep_batch (ascending scan from the walk's final
// cursor; anchored D^i I^j tails; fin_i < 0 = skipped pair).
int bst_compact_sweep_batch_t(
        const uint8_t* tr, int atr_bytes, int b2_cols,
        const int8_t* s, int ls_cap, const int8_t* t, int lt_cap,
        const int32_t* fin_i, const int32_t* fin_j,
        int flags, int B, int ops_stride,
        char* ops_out, int32_t* ops_len) {
    const bool anchored = !(flags & (LOCAL_START | FREE_START_EDGES));
    const long atr = 4L * atr_bytes;
    for (int b = 0; b < B; ++b) {
        char* ops = ops_out + (size_t)b * ops_stride;
        int i = fin_i[b], j = fin_j[b];
        int n = 0;
        if (i < 0 || j < 0) { ops[0] = '\0'; ops_len[b] = 0; continue; }
        const uint8_t* plane =
            tr + (size_t)(b & 1) * atr_bytes * b2_cols + (b >> 1);
        const int8_t* sb = s + (size_t)b * ls_cap;
        const int8_t* tb = t + (size_t)b * lt_cap;
        bool bad = false;
        if (anchored) {
            // same capacity guard as the replay loop: the prefix is
            // fin-cursor-sized and fin cursors come from the device
            // walk today, but a corrupt/foreign cursor must trip the
            // -1 sentinel, not overflow into the next pair's row
            for (int k = 0; k < i && !bad; ++k) {
                if (n >= ops_stride - 1) bad = true;
                else ops[n++] = 'D';
            }
            for (int k = 0; k < j && !bad; ++k) {
                if (n >= ops_stride - 1) bad = true;
                else ops[n++] = 'I';
            }
        }
        for (long a = i + j; a < atr && !bad; ++a) {
            uint8_t op =
                (plane[(size_t)(a >> 2) * b2_cols] >> (2 * (a & 3))) & 3;
            if (op == 0) continue;
            if (n >= ops_stride - 1) { bad = true; break; }
            if (op == 1) {
                ops[n++] = (sb[i] == tb[j]) ? 'M' : 'S';
                ++i; ++j;
            } else if (op == 2) {
                ops[n++] = 'I'; ++j;
            } else {
                ops[n++] = 'D'; ++i;
            }
        }
        ops[n] = '\0';
        ops_len[b] = bad ? -1 : n;
    }
    return 0;
}

// ---------------------------------------------------------------------
// FASTA streaming packer
// ---------------------------------------------------------------------

// One shared streaming state machine used by BOTH passes (count and
// pack), so record/letter accounting can never diverge between them.
//
// Semantics are PARITY with the Python reader (database.read_fasta,
// which strips each line then tests startswith('>')):
//   * a '>' begins a header only when every byte since the last
//     newline was whitespace ('>' inside a description or a sequence
//     line is NOT a record start — mid-line '>' in sequence data is an
//     unmapped byte and raises upstream, exactly like Alphabet.parse);
//   * record names are the first space/tab/CR-delimited token after
//     the '>' (leading blanks skipped — "> chr1" names 'chr1'; the
//     '\r' of a CRLF header never enters the name);
//   * bytes before the FIRST header are ignored entirely (the Python
//     reader collects then discards them unparsed), so leading
//     comment/junk lines neither raise nor shift coordinates;
//   * whitespace inside sequence data is skipped; any OTHER unmapped
//     byte is counted in n_unknown and the first one reported (value +
//     file offset) so the binding can raise instead of silently
//     dropping letters — a dropped base SHIFTS every downstream
//     coordinate of the record.
static inline bool fasta_blank(int c) {
    // match Python str whitespace (the pure-Python reader's
    // line.split() semantics): \v and \f count too
    return c == '\r' || c == ' ' || c == '\t' || c == '\v' || c == '\f';
}

struct fasta_counts {
    int64_t n_records, total_len, n_unknown, unknown_pos;
    int first_unknown;
};

// codes/offsets/lengths/header_pos/names_buf may all be NULL (count
// mode).  Returns the record count, or -1 if the file cannot be read.
static int64_t fasta_stream(const char* path, const int8_t* code_map,
                            int8_t* codes, int64_t* offsets,
                            int64_t* lengths, int64_t* header_pos,
                            char* names_buf, int64_t names_cap,
                            int64_t* names_needed, fasta_counts* counts) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t rec = -1, pos = 0, rec_start = 0;
    int64_t name_pos = 0, name_need = 0, fpos = -1, line_start = 0;
    int64_t unknown = 0, upos = -1;
    int c, first = -1;
    bool in_header = false;    // between a header '>' and its '\n'
    bool name_open = false;    // before/inside the name token
    bool name_started = false; // collected at least one name byte
    bool line_blank = true;    // nothing but whitespace since last '\n'
    while ((c = std::fgetc(f)) != EOF) {
        ++fpos;
        if (c == '\n') {
            if (in_header) {
                in_header = false;
                ++name_need;
                if (names_buf && name_pos < names_cap)
                    names_buf[name_pos++] = '\0';
            }
            line_blank = true;
            line_start = fpos + 1;
            continue;
        }
        if (c == '>' && line_blank && !in_header) {
            if (rec >= 0 && lengths) lengths[rec] = pos - rec_start;
            ++rec;
            rec_start = pos;
            if (offsets) offsets[rec] = pos;
            // the header LINE's start (== the '>' offset unless the
            // header is indented) — parity with read_fasta's line_start
            if (header_pos) header_pos[rec] = line_start;
            in_header = true;
            name_open = true;
            name_started = false;
            line_blank = false;
            continue;
        }
        if (!fasta_blank(c)) line_blank = false;
        if (in_header) {
            if (name_open) {
                if (fasta_blank(c)) {
                    if (name_started) name_open = false;
                    // else: leading blank after '>' — skip
                } else {
                    name_started = true;
                    ++name_need;
                    if (names_buf && name_pos + 1 < names_cap)
                        names_buf[name_pos++] = (char)c;
                }
            }
            continue;
        }
        if (rec < 0) continue;  // pre-header junk: discarded unparsed
        int8_t code = code_map[(unsigned char)c];
        if (code >= 0) {
            if (codes) codes[pos] = code;
            ++pos;
        } else if (!fasta_blank(c)) {
            ++unknown;
            if (first < 0) { first = c; upos = fpos; }
        }
    }
    if (rec >= 0 && lengths) lengths[rec] = pos - rec_start;
    if (in_header) {  // header at EOF without a trailing newline
        ++name_need;
        if (names_buf && name_pos < names_cap) names_buf[name_pos++] = '\0';
    }
    std::fclose(f);
    if (names_needed) *names_needed = name_need;
    if (counts) {
        counts->n_records = rec + 1;
        counts->total_len = pos;
        counts->n_unknown = unknown;
        counts->first_unknown = first;
        counts->unknown_pos = upos;
    }
    return rec + 1;
}

// Pass 1: count records and total packed length.
int bst_fasta_scan(const char* path, const int8_t* code_map,
                   int64_t* n_records, int64_t* total_len,
                   int64_t* n_unknown, int* first_unknown,
                   int64_t* unknown_pos) {
    fasta_counts counts;
    if (fasta_stream(path, code_map, nullptr, nullptr, nullptr, nullptr,
                     nullptr, 0, nullptr, &counts) < 0)
        return -1;
    *n_records = counts.n_records;
    *total_len = counts.total_len;
    if (n_unknown) *n_unknown = counts.n_unknown;
    if (first_unknown) *first_unknown = counts.first_unknown;
    if (unknown_pos) *unknown_pos = counts.unknown_pos;
    return 0;
}

// Pass 2: pack codes into a flat buffer; offsets[r] = start of record
// r, lengths[r] = its length; header_pos[r] (optional) = BYTE offset
// of record r's '>' in the file (the DB's source_pos contract); names
// flattened into names_buf separated by '\0' (caller sizes via scan +
// names_cap).  Returns number of records.  Unmapped non-whitespace
// bytes are skipped HERE (the binding raises from the scan before
// packing unless the caller opted into a mapping), so the skip can
// never be hit silently.  names_needed (optional out): bytes required
// to hold every name + its NUL.  When it exceeds names_cap the buffer
// content is TRUNCATED and must not be trusted (a silently dropped
// terminator would shift every later name) — the binding retries with
// the reported size.
int64_t bst_fasta_pack(const char* path, const int8_t* code_map,
                       int8_t* codes, int64_t* offsets, int64_t* lengths,
                       int64_t* header_pos,
                       char* names_buf, int64_t names_cap,
                       int64_t* names_needed) {
    return fasta_stream(path, code_map, codes, offsets, lengths,
                        header_pos, names_buf, names_cap, names_needed,
                        nullptr);
}

}  // extern "C"
