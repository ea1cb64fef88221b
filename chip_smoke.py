"""Smoke run of the PyTorch + CUDA port (biseqt_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's two paths on the card.  The batched path, banded
extension with transcripts (``biseqt_tpu_torch.pipeline.extend_segments(
..., with_transcripts=True, device="cuda")``), runs at the shape of the
JAX package's transcript bench leg: 2048 homologous 10 kbp blocks (10%
substitutions plus short indels that stay within +-50 diagonals, band
100), planted between random spacers of S and T, one Word-Blot-style
segment dict per block, then one narrow launch of 12 segments.  The
pairwise path, ``pw.Aligner(..., backend="pallas_row", device="cuda")``,
aligns a planted 100 kbp DNA pair and a 2,000-residue protein pair.
The experiment probes (``biseqt_tpu_torch.experiments``) run at the
JAX package's probe shapes.

Phases, each of which exits non-zero on failure:

1. builds the five CUDA kernels (``csrc/*.cu``, nvcc, sm_90a, one
   process each, all at once) and the C++ host tier from the
   checkout;
2. runs the main path with the kernels' launch counters set to 0, and
   requires every kernel to have been launched once per launch of the
   pipeline's plan;
3. rescores every transcript with affine gaps in numpy (exactly its
   score) and requires transcripts to cover most of each block;
4. on one full launch of the main path, holds the DP kernel (scores, end
   cells, the dirs plane on its live slots) and the walk kernel (trace
   bytes, cursors) to their plain PyTorch twins on the same CUDA
   tensors, exactly, and the transcripts to the C++ host walker's over
   the same plane;
5. times each kernel and its plain twin with CUDA events at that
   launch's shape, and the replay guard of ``extend_segments`` (the
   trace's moves against the end cells, on the card) as called and
   replayed from a CUDA graph; times K1 on that launch's inputs tiled
   or sliced to 44-1024 plane rows (its time against the rows in
   flight), and counts the SASS instructions of K1's step loop (the
   main path's instance, by ``cuobjdump -sass``);
6. runs the pairwise path, counting the row kernel's launches: the
   100 kbp DNA pair (10% substitutions, short indels within +-50
   diagonals, band (-250, 250)) as B_GLOBAL, B_LOCAL and B_OVERLAP, and
   the protein pair under BLOSUM62 as B_LOCAL.  Each solve and
   traceback must launch the row kernel, give the C++ ``native``
   engine's score and the antidiagonal kernel's (``backend="pallas"``)
   exactly, and return a transcript that rescores to it.  Then, on the
   Aligner's own inputs with directions, the row kernel must equal its
   plain twin exactly (score, end cell, the whole plane) for the protein
   pair and for the DNA pair's first 10 kbp as B_LOCAL (W 512, the
   planner's block per pair); and the DNA pair's time is split into
   kernel (with its microseconds a row), copy and host walk;
7. holds the row kernel to its plain twin at the JAX package's
   score-bench shape (4096 pairs of 10 kbp, band 100, local; the
   planner's warp per pair): score-only on the whole batch, with
   directions on 512 pairs (scores, end cells, the whole plane),
   exactly, and times both;
8. runs the two probes' entry points with their launch counters set to
   0: the transpose probe (PyTorch's transpose of the u8 plane
   [1288, 512, 128], the same through int32, the kernel on the
   [256, 128, 128] sub-plane and on the whole plane) and the int16
   probe (all ten ops at [256, 128] on the probe's input and at
   [65536, 128]), every kernel result equal to its plain version; then
   holds the transpose kernel to its plain version on phase 4's dirs
   plane, exactly, and times both;
9. runs the batched path on bands wider than 2048 lanes, counted: a
   segment whose band buckets to W 3072 on two random 1.2 kbp
   sequences, on the card and on the CPU (the plain twins), which must
   agree exactly and score 13.0; then holds the DP kernel to its plain
   twin at W 3072 (that launch's inputs) and W 4096 (a batch of 1.5 kbp
   pairs whose bands span every lane), exactly, and times both.

Prints a kernels JSON line (per kernel: launches on its path, kernel,
plain and library milliseconds, and the bound: the least time the card
could take for the same work, from this run's bytes and operations),
then the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Fails (exit code not 0, no result)
without a CUDA card or outside the repository.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

N_BLOCKS = 2048
BLOCK = 10_000
BAND = 100
NARROW = 12
GO, GE = -3.0, -1.0
PAIR_LEN = 100_000        # the pairwise path's DNA pair
PAIR_BAND = (-250, 250)
PROTEIN_LEN = 2000
TWIN_PREFIX = 10_000      # rows of the DNA pair held to the row twin
SCORE_BENCH = dict(B=4096, L=10240, n=10000, band=100, W=128)
I16_ROWS = 65536          # the int16 probe's ops where bytes bound them
ROWS_IN_FLIGHT = (44, 128, 256, 512, 1024)   # K1's plane rows, phase 5

# Operations per unit of work, counted from each kernel's source at the
# smoke's settings, for the compute side of its bound.
# dp_ad.cu:144-208, local mode with directions: per band cell 6 float
# adds (H + go, the E and F reads with their wrap, diag, the lane mask,
# the tracker drift), 6 maxes (E, F, H twice, the local floor, the
# tracker) and 7 compares (two gap flags, two source tests, the local
# stop's two, the tracker).
DP_AD_OPS_PER_CELL = 19
# dp_row.cu:318-399, score-only, local: per band cell 5 float adds
# (diag, H + go, F + ge, the scan term, E) and 7 maxes (F, H before E,
# the local floor, the running max, P, H, the tracker).  The shuffles
# of the block scan are not counted: a bound of the recurrence alone.
DP_ROW_OPS_PER_CELL = 12
# walk.cu:174-202: ~50 integer instructions per action (bounds and
# parity tests, the nibble's address and shift, the fused step, the
# trace bit), as one step of the plain walk; the kernel's diagonal runs
# (walk.cu:130-173) do fewer per action.
WALK_OPS_PER_STEP = 50
WIDE_LEN = 1200               # phase 9: the W 3072 segment's sequences
WIDE_SEGMENT = ((-1100, 1100), (1200, 1300))
WIDE_SCORE = 13.0             # its score, as the JAX package gives it
WIDE_4096 = dict(B=8, L=1500)


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def plant(np, rng, alphabet, Sequence):
    """S and T with N_BLOCKS homologous blocks between random spacers,
    and one segment dict per block from the planted coordinates."""
    s_parts, t_parts, segments = [], [], []
    s_pos = t_pos = 0
    half = BAND // 2
    for _ in range(N_BLOCKS):
        gap_s, gap_t = rng.integers(200, 1200, 2)
        core = rng.integers(0, 4, BLOCK).astype(np.int8)
        mut = core.copy()
        hit = rng.random(BLOCK) < 0.10
        mut[hit] = (mut[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        # six short indels: the diagonal drifts by at most 30 < BAND / 2
        pieces, last = [], 0
        for p in np.sort(rng.choice(np.arange(500, BLOCK - 500), 6,
                                    replace=False)):
            n = int(rng.integers(1, 6))
            pieces.append(mut[last:p])
            if rng.random() < 0.5:            # insertion into T
                pieces.append(rng.integers(0, 4, n).astype(np.int8))
                last = p
            else:                             # deletion from T
                last = p + n
        pieces.append(mut[last:])
        mut = np.concatenate(pieces)
        i0, j0 = s_pos + int(gap_s), t_pos + int(gap_t)
        d0 = i0 - j0
        a_lo = i0 + j0
        a_hi = (i0 + BLOCK) + (j0 + len(mut))
        segments.append({"segment": ((d0 - half, d0 + half), (a_lo, a_hi)),
                         "block": (i0, j0, BLOCK, len(mut))})
        s_parts += [rng.integers(0, 4, int(gap_s)).astype(np.int8), core]
        t_parts += [rng.integers(0, 4, int(gap_t)).astype(np.int8), mut]
        s_pos, t_pos = i0 + BLOCK, j0 + len(mut)
    S = Sequence(alphabet, np.concatenate(s_parts))
    T = Sequence(alphabet, np.concatenate(t_parts))
    return S, T, segments


def mutate(np, rng, core, alphabet_size, sub_rate, n_indels, margin):
    """``core`` with ``sub_rate`` substitutions and ``n_indels`` short
    indels (1-5 letters), the diagonal drift kept within 40."""
    mut = core.copy()
    hit = rng.random(len(core)) < sub_rate
    mut[hit] = (mut[hit] + rng.integers(1, alphabet_size, int(hit.sum()))
                ) % alphabet_size
    pieces, last, drift = [], 0, 0
    for p in np.sort(rng.choice(np.arange(margin, len(core) - margin),
                                n_indels, replace=False)):
        n = int(rng.integers(1, 6))
        pieces.append(mut[last:p])
        if drift <= 0:                    # insertion into T
            pieces.append(rng.integers(0, alphabet_size, n).astype(np.int8))
            last, drift = p, drift + n
        else:                             # deletion from T
            last, drift = p + n, drift - n
    pieces.append(mut[last:])
    return np.concatenate(pieces)


def rescore(np, ops, s, t, si, sj, subst):
    """Affine-gap score of an MSID transcript starting at (si, sj), and
    whether its M / S letters agree with the characters."""
    if not ops:
        return 0.0, True
    o = np.frombuffer(ops.encode(), np.uint8)
    diag = (o == ord("M")) | (o == ord("S"))
    ins, dele = o == ord("I"), o == ord("D")
    adv_i = (diag | dele).astype(np.int64)
    adv_j = (diag | ins).astype(np.int64)
    i = si + np.cumsum(adv_i) - adv_i
    j = sj + np.cumsum(adv_j) - adv_j
    cs, ct = s[i[diag]], t[j[diag]]
    letters_ok = bool(np.all((cs == ct) == (o[diag] == ord("M"))))
    prev = np.concatenate([np.zeros(1, np.uint8), o[:-1]])
    opens = ((ins & (prev != ord("I"))).sum()
             + (dele & (prev != ord("D"))).sum())
    score = (subst[cs, ct].astype(np.float64).sum()
             + GE * (ins.sum() + dele.sum()) + GO * opens)
    return float(score), letters_ok


def nbytes(*tensors):
    """Bytes of the given tensors and numpy arrays together."""
    return sum(x.numel() * x.element_size() if hasattr(x, "element_size")
               else x.nbytes for x in tensors)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    from biseqt_tpu_torch import _build, native
    from biseqt_tpu_torch import pipeline, pw
    from biseqt_tpu_torch.experiments import i16_probe, transpose_probe
    from biseqt_tpu_torch.matrices import BLOSUM62, protein_alphabet
    from biseqt_tpu_torch.ops import dp_ad, dp_row, walk
    from biseqt_tpu_torch.ops.banded_dp import ModeFlags, traceback_path
    from biseqt_tpu_torch.profiling import (FP32_OPS_PER_S, INT32_OPS_PER_S,
                                            bound_ms, cuda_ms, cuobjdump_sass,
                                            sass_step_loop)
    from biseqt_tpu_torch.sequence import Alphabet, Sequence

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    kernels = (("dp_ad", dp_ad), ("walk", walk), ("dp_row", dp_row),
               ("transpose_probe", transpose_probe), ("i16_probe", i16_probe))
    def build(name, module):
        t = time.perf_counter()
        _build.load(name, module._declare)
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        builds = [pool.submit(build, name, module)
                  for name, module in kernels]
        host_tier = pool.submit(native.available)
        build_s = [future.result() for future in builds]
        if not host_tier.result():
            fail("the C++ host tier (pwnative.cpp) did not build")
    for name, _ in kernels:
        function = ""
        for line in _build.build_log(name).splitlines():
            if "Function properties for" in line:
                function = line.split("Function properties for")[1].strip()
            elif "registers" in line or "spill" in line:
                print("ptxas %s %s: %s" % (name, function, line.strip()))
    print("build: %.1f s (%d kernels and the C++ tier, in parallel; %s)"
          % (time.perf_counter() - t0, len(kernels),
             ", ".join("%s %.1f s" % (name, s)
                       for (name, _), s in zip(kernels, build_s))))

    # -- data -------------------------------------------------------------
    rng = np.random.default_rng(20261016)
    A4 = Alphabet("ACGT")
    t0 = time.perf_counter()
    S, T, segments = plant(np, rng, A4, Sequence)
    print("planted %d blocks of %d bp: |S| = %d, |T| = %d (%.1f s)"
          % (N_BLOCKS, BLOCK, len(S), len(T), time.perf_counter() - t0))
    subst = np.where(np.eye(4, dtype=bool), 1.0, -1.0).astype(np.float32)
    kw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True,
              device=dev)
    # warm-up: CUDA context, allocator, library loads
    pipeline.extend_segments(S, T, segments[:2], **kw)
    torch.cuda.synchronize()

    # -- 2. the main path, counted ---------------------------------------
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    t0 = time.perf_counter()
    out = pipeline.extend_segments(S, T, segments, **kw)
    e2e = time.perf_counter() - t0
    narrow = pipeline.extend_segments(S, T, segments[:NARROW], **kw)
    counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    cut = [pipeline.cut_segment(seg, len(S), len(T)) for seg in segments]
    launches = pipeline.plan_launches(cut, True)
    n_launches = len(launches) + len(pipeline.plan_launches(cut[:NARROW],
                                                             True))
    print("launches: %d planned, %s counted" % (n_launches, counts))
    if any(c != n_launches for c in counts.values()):
        fail("a kernel was not launched once per launch: %s" % counts)
    cells = sum(seg["band_cells"] for seg in out)
    print("extend_segments: %d segments in %d launches, %.3f s end to end,"
          " %.3f GCUPS (band cells %d)"
          % (len(out), len(launches), e2e, cells / e2e / 1e9, cells))

    # -- 3. every transcript rescores to its score and covers its block -
    s_arr, t_arr = S.to_array(), T.to_array()
    short = 0
    for seg in out + narrow:
        tx = seg["transcript"]
        got, letters_ok = rescore(np, tx, s_arr, t_arr, seg["origin_start"],
                                  seg["mutate_start"], subst)
        if got != seg["score"] or not letters_ok:
            fail("transcript of segment %d rescores to %r, score %r"
                 " (letters ok: %s)" % (seg["source_index"], got,
                                        seg["score"], letters_ok))
        i0, j0, ls, lt = seg["block"]
        consumed_s = tx.count("M") + tx.count("S") + tx.count("D")
        if consumed_s < 0.9 * ls:
            short += 1
    if short:
        fail("%d transcripts cover less than 90%% of their block" % short)
    print("transcripts: %d rescored exactly, all cover >= 90%% of their"
          " block" % len(out + narrow))

    # -- 4. kernels against their plain twins on one full launch --------
    idxs, LS, LT, W = max(launches, key=lambda launch: len(launch[0]))
    x = pipeline.launch_inputs(cut, idxs, LS, LT, W, s_arr, t_arr, True)
    on = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    flags = ModeFlags(local_start=True, local_end=True)
    args = (on["s_codes"], on["t_codes"], on["s_lens"], on["t_lens"],
            on["dmin"])
    dkw = dict(W=W, subst=subst, go=GO, ge=GE, flags=flags,
               w_eff=on["w_eff"], with_dirs=True, device=dev)
    print("full launch: %d pairs (%d real), LS %d, LT %d, W %d"
          % (len(x["dmin"]), len(idxs), LS, LT, W))
    got = dp_ad.banded_dp_ad(*args, **dkw)
    t_plain = time.perf_counter()
    want = dp_ad.banded_dp_ad_reference(*args, **dkw)
    torch.cuda.synchronize()
    dp_plain_ms = (time.perf_counter() - t_plain) * 1e3
    dp_err = float((got.score - want.score).abs().max())
    if not (torch.equal(got.score, want.score)
            and torch.equal(got.end_i, want.end_i)
            and torch.equal(got.end_j, want.end_j)):
        fail("DP kernel scores / end cells differ from the plain twin"
             " (max |d score| %r)" % dp_err)
    low_live, high_live = dp_ad.live_nibbles(on["dmin"], on["w_eff"], W)
    gd, wd = got.dirs, want.dirs
    bad = (((gd ^ wd) & 15).ne(0) & low_live).sum() \
        + (((gd ^ wd) >> 4).ne(0) & high_live).sum()
    if int(bad):
        fail("DP kernel dirs plane differs from the plain twin on %d live"
             " nibbles" % int(bad))
    print("dp_ad kernel == plain twin: scores, end cells, dirs plane on"
          " its live slots")
    dirs4 = got.dirs          # phase 8 transposes this plane

    n = len(idxs)
    real = torch.arange(len(x["dmin"]), device=dev) < n
    ei = torch.where(real, got.end_i, -1)
    ej = torch.where(real, got.end_j, -1)
    w_got = walk.traceback_walk(got.dirs, on["dminq"], ei, ej, W=W,
                                device=dev)
    t_plain = time.perf_counter()
    w_want = walk.traceback_walk_reference(got.dirs, on["dminq"], ei, ej,
                                           W=W, device=dev)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t_plain) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(w_got, w_want)):
        fail("walk kernel trace / cursors differ from the plain twin")
    walk_err = float((w_got[1] - w_want[1]).abs().max()
                     + (w_got[2] - w_want[2]).abs().max())
    print("walk kernel == plain twin: trace bytes and cursors")

    tr, fi, fj = (v.cpu().numpy() for v in w_got)
    ops, si, sj = native.compact_sweep_ops_t(
        tr, fi, fj, x["s_codes"][:n], x["t_codes"][:n], x["s_lens"][:n],
        x["t_lens"][:n], flags)
    h_ops, h_si, h_sj = native.traceback_batch_ad(
        got.dirs.cpu().numpy(), x["dminq"][:n], x["s_codes"][:n],
        x["t_codes"][:n], x["s_lens"][:n], x["t_lens"][:n],
        got.end_i.cpu().numpy()[:n], got.end_j.cpu().numpy()[:n], flags)
    if ops != h_ops or not (np.array_equal(si, h_si)
                            and np.array_equal(sj, h_sj)):
        fail("walk + compaction transcripts differ from the C++ host"
             " walker's over the same plane")
    print("transcripts == C++ host walker's on the full launch (%d pairs)"
          % n)

    # -- 5. kernel times at the launch's shape, beside their bounds -------
    dp_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*args, **dkw), 3)
    walk_ms = cuda_ms(lambda: walk.traceback_walk(
        got.dirs, on["dminq"], ei, ej, W=W, device=dev), 3)

    def guard():
        """extend_segments' check of the walk: its trace's moves against
        the end cells, on the card."""
        di, dj = walk.trace_moves(w_got[0], len(ei))
        return ((ei - w_got[1]) != di) | ((ej - w_got[2]) != dj)

    if bool(guard().any()):
        fail("the walk's moves do not lead from the end cells to its"
             " cursors")
    guard_ms = cuda_ms(guard, 3)
    # the same operations replayed from a CUDA graph: their device time
    # without the host's dispatch of each operation
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        guard()
    guard_device_ms = cuda_ms(graph.replay, 3)
    del graph
    launch_cells = sum(out[k]["band_cells"] for k in idxs)
    # K1 reads the codes, lengths, band and table once and writes the
    # scores, end cells and the plane once
    dp_work = (nbytes(*args, on["w_eff"], subst, *got),
               DP_AD_OPS_PER_CELL * launch_cells)
    dp_bound, dp_bound_by = bound_ms(*dp_work, FP32_OPS_PER_S)
    # the walk reads one plane byte per action (each op, and the stop of
    # each live walker) and writes the trace and cursors once
    tr32 = w_got[0].to(torch.int32)
    steps = int(sum((((tr32 >> s) & 3) != 0).sum() for s in (0, 2, 4, 6)))
    reads = steps + int((ei >= 0).sum())
    walk_work = (reads + nbytes(on["dminq"], ei, ej, *w_got),
                 WALK_OPS_PER_STEP * reads)
    walk_bound, walk_bound_by = bound_ms(*walk_work, INT32_OPS_PER_S)
    print("dp_ad: kernel %.3f ms (%.1f GCUPS on %d band cells), plain %.0f"
          " ms; bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (dp_ms, launch_cells / dp_ms / 1e6, launch_cells, dp_plain_ms,
             dp_bound, dp_bound_by, dp_work[0] / 1e6, dp_work[1] / 1e9))
    print("walk: kernel %.3f ms (%d actions, window depth %d), plain %.0f"
          " ms; bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (walk_ms, reads, walk.DEPTH, walk_plain_ms, walk_bound,
             walk_bound_by, walk_work[0] / 1e6, walk_work[1] / 1e9))
    print("replay guard (trace moves against end cells, on the card):"
          " %.4f ms per launch, %.4f ms replayed from a CUDA graph"
          % (guard_ms, guard_device_ms))

    # K1 against the plane rows in flight: the full launch's inputs
    # tiled or sliced to each row count, at the same LS, LT, W and Apad
    for n_rows in ROWS_IN_FLIGHT:
        pairs = 2 * n_rows

        def tile(v):
            reps = (-(-pairs // len(v)),) + (1,) * (v.dim() - 1)
            return v.repeat(reps)[:pairs]

        targs = [tile(v) for v in args]
        tkw = dict(dkw, w_eff=tile(on["w_eff"]))
        rows_ms = cuda_ms(lambda: dp_ad.banded_dp_ad(*targs, **tkw), 3)
        print("dp_ad rows in flight: %d plane rows (%d pairs), %.3f ms,"
              " %.5f ms per row" % (n_rows, pairs, rows_ms, rows_ms / n_rows))
        del targs, tkw
    # K1's step loop in SASS: instructions from the back-branch's target
    # to the branch, per block barrier (one barrier per step)
    try:
        loop = sass_step_loop(cuobjdump_sass(_build.so_path("dp_ad")),
                              dp_ad.MAIN_KERNEL)
    except (OSError, subprocess.SubprocessError) as e:
        loop, why = None, "cuobjdump failed: %s" % e
    else:
        why = "no step loop found in %s" % dp_ad.MAIN_KERNEL
    if loop is None:
        print("dp_ad SASS step loop: not measured (%s)" % why)
    else:
        print("dp_ad SASS step loop of %s: %d instructions, %d barriers,"
              " %.1f instructions per step"
              % (loop["function"], loop["instructions"], loop["barriers"],
                 loop["instructions"] / loop["barriers"]))

    # -- 6. the pairwise path at real size, counted --------------------
    pairs = []
    core = rng.integers(0, 4, PAIR_LEN).astype(np.int8)
    mut = mutate(np, rng, core, 4, 0.10, 40, 1000)
    for alntype in pw.BANDED_TYPES:
        pairs.append(("dna %s" % alntype, Sequence(A4, core),
                      Sequence(A4, mut), alntype, PAIR_BAND, None, GO, GE))
    prot = rng.integers(0, 20, PROTEIN_LEN).astype(np.int8)
    pmut = mutate(np, rng, prot, 20, 0.15, 6, 100)
    P = protein_alphabet()
    pairs.append(("protein B_LOCAL", Sequence(P, prot), Sequence(P, pmut),
                  pw.B_LOCAL, (-100, 100), BLOSUM62, -11.0, -1.0))
    print("pairwise path: a %d bp DNA pair (|T| = %d), band %s; a %d-residue"
          " protein pair (|T| = %d), BLOSUM62"
          % (PAIR_LEN, len(mut), PAIR_BAND, PROTEIN_LEN, len(pmut)))

    def align(S, T, alntype, band, subst, go, ge, backend, traceback):
        with pw.Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=alntype,
                        diag_range=band, subst_scores=subst, go_score=go,
                        ge_score=ge, backend=backend, device=dev) as aln:
            t0 = time.perf_counter()
            score = aln.solve()             # a host float: synchronised
            t1 = time.perf_counter()
            alignment = aln.traceback() if traceback else None
            t2 = time.perf_counter()
        return score, alignment, aln.subst_scores, t1 - t0, t2 - t1

    # warm-up: the row kernel's first launch, on a small pair
    align(Sequence(A4, core[:500]), Sequence(A4, mut[:500]), pw.B_LOCAL,
          PAIR_BAND, None, GO, GE, "pallas_row", True)
    dp_row.LAUNCHES = 0
    row_out = [align(S, T, alntype, band, psub, go, ge, "pallas_row", True)
               for _, S, T, alntype, band, psub, go, ge in pairs]
    row_launches = dp_row.LAUNCHES
    print("launches of the row kernel on the pairwise path: %d"
          % row_launches)
    if row_launches < 2 * len(pairs):
        fail("the pairwise path did not go through the row kernel: %d"
             " launches for %d solves and tracebacks"
             % (row_launches, 2 * len(pairs)))
    row_err = 0.0
    for (name, S, T, alntype, band, psub, go, ge), got in zip(pairs,
                                                              row_out):
        score, alignment, subst_np, t_solve, t_tb = got
        ref = align(S, T, alntype, band, psub, go, ge, "native", False)
        ad = align(S, T, alntype, band, psub, go, ge, "pallas", False)
        rescored = float(alignment.calculate_score(subst_np, go, ge))
        print("%s: pallas_row %r (solve %.3f s, traceback %.3f s),"
              " native %r (%.3f s), pallas %r (%.3f s), transcript"
              " rescores to %r, %d ops from (%d, %d)"
              % (name, score, t_solve, t_tb, ref[0], ref[3], ad[0], ad[3],
                 rescored, len(alignment.transcript),
                 alignment.origin_start, alignment.mutate_start))
        if not (score == ref[0] == ad[0] == rescored):
            fail("%s: the row kernel's score %r, native %r, pallas %r,"
                 " rescored transcript %r" % (name, score, ref[0], ad[0],
                                             rescored))
        row_err = max(row_err, abs(score - ref[0]))
        if alignment.transcript.origin_len < 0.9 * len(S) \
                and alntype != pw.B_LOCAL:
            fail("%s: the transcript covers too little of S" % name)

    def row_call(S, T, alntype, band, subst, go, ge):
        """The Aligner's own row-kernel call with directions, its inputs
        on the card, and the band's top diagonal."""
        with pw.Aligner(S, T, alnmode=pw.BANDED_MODE, alntype=alntype,
                        diag_range=band, subst_scores=subst, go_score=go,
                        ge_score=ge, backend="pallas_row", device=dev) as aln:
            args, kw = aln._row_args(with_dirs=True)
        on = [torch.as_tensor(np.asarray(a), device=dev) for a in args]
        return on, kw, aln.diag_range[1]

    # where the Aligner's time goes: the kernel score-only and with
    # directions (CUDA events), the plane's copy to the host and the
    # host walk (host clock)
    sms = dp_row.sm_count(dev)
    for name, S, T, alntype, band, psub, go, ge in pairs[:-1]:
        on, kw, dmax = row_call(S, T, alntype, band, psub, go, ge)
        solve_ms = cuda_ms(lambda: dp_row.banded_dp_row(
            *on, **dict(kw, with_dirs=False)), 3)
        dirs_ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, **kw), 3)
        res = dp_row.banded_dp_row(*on, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane = res.dirs[0].cpu().numpy()
        t1 = time.perf_counter()
        traceback_path(plane, S.to_array(), T.to_array(), int(res.end_i[0]),
                       int(res.end_j[0]), banded=True, dmax=dmax,
                       flags=kw["flags"])
        t2 = time.perf_counter()
        # K4 with directions reads the inputs once and writes the plane
        # (a byte per band cell), score and end cell once
        pair_bound, pair_bound_by = bound_ms(
            nbytes(*on, *res), DP_ROW_OPS_PER_CELL * plane.size,
            FP32_OPS_PER_S)
        print("%s: K4 score-only %.3f ms (%.4f us a row; %s), with"
              " directions %.3f ms (%.4f us a row; %s; bound %.4f ms, %s, %d"
              " band cells); plane to the host %.1f ms (%.1f MB), host walk"
              " %.1f ms"
              % (name, solve_ms, solve_ms * 1e3 / len(S),
                 dp_row.plan(1, kw["W"], sms=sms), dirs_ms,
                 dirs_ms * 1e3 / len(S),
                 dp_row.plan(1, kw["W"], True, sms=sms), pair_bound,
                 pair_bound_by,
                 plane.size, (t1 - t0) * 1e3, plane.nbytes / 1e6,
                 (t2 - t1) * 1e3))

    # the row kernel against its twin on the Aligner's own inputs, with
    # directions and score-only (the geometries of traceback and solve):
    # the protein pair whole (the shared-memory table, A 20) and the DNA
    # pair's first TWIN_PREFIX letters (W 512, a block)
    n = TWIN_PREFIX
    twin_cases = [
        pairs[-1],
        ("dna B_LOCAL, first %d bp" % n, Sequence(A4, core[:n]),
         Sequence(A4, mut[:n]), pw.B_LOCAL, PAIR_BAND, None, GO, GE),
    ]
    for name, S, T, alntype, band, psub, go, ge in twin_cases:
        on, kw_dirs, _ = row_call(S, T, alntype, band, psub, go, ge)
        for kw in (kw_dirs, dict(kw_dirs, with_dirs=False)):
            got = dp_row.banded_dp_row(*on, **kw)
            t0 = time.perf_counter()
            want = dp_row.banded_dp_row_reference(*on, **kw)
            torch.cuda.synchronize()
            t_twin = time.perf_counter() - t0
            row_err = max(row_err,
                          float((got.score - want.score).abs().max()))
            geo = dp_row.plan(1, kw["W"], kw["with_dirs"], sms=sms)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail("%s: the row kernel differs from its plain twin on the"
                     " Aligner's inputs (W %d, %s)" % (name, kw["W"], geo))
            print("%s: dp_row kernel == plain twin on the Aligner's inputs,"
                  " W %d, %s (score, end cell%s; twin %.1f s)"
                  % (name, kw["W"], geo,
                     ", the whole plane" if kw["with_dirs"] else "", t_twin))

    # -- 7. the row kernel against its twin at the score-bench shape -----
    sb = SCORE_BENCH
    rr = np.random.default_rng(20261017)
    B = sb["B"]
    host = (rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            rr.integers(0, 4, (B, sb["L"]), dtype=np.int8),
            np.full((B,), sb["n"], np.int32), np.full((B,), sb["n"], np.int32),
            np.full((B,), -(sb["band"] // 2), np.int32))
    on = [torch.from_numpy(v).to(dev) for v in host]
    rkw = dict(W=sb["W"], subst=subst, go=-2.0, ge=-1.0,
               flags=ModeFlags(local_start=True, local_end=True),
               w_eff=torch.full((B,), sb["band"], dtype=torch.int32,
                                device=dev), device=dev)
    got = dp_row.banded_dp_row(*on, **rkw)
    t_plain = time.perf_counter()
    want = dp_row.banded_dp_row_reference(*on, **rkw)
    torch.cuda.synchronize()
    row_plain_ms = (time.perf_counter() - t_plain) * 1e3
    row_err = max(row_err, float((got.score - want.score).abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("row kernel (score-only, %d pairs) differs from its plain twin"
             % B)
    nd = 512
    dkw = dict(rkw, w_eff=rkw["w_eff"][:nd], with_dirs=True)
    got_d = dp_row.banded_dp_row(*[v[:nd] for v in on], **dkw)
    t_plain = time.perf_counter()
    want_d = dp_row.banded_dp_row_reference(*[v[:nd] for v in on], **dkw)
    torch.cuda.synchronize()
    row_plain_dirs_ms = (time.perf_counter() - t_plain) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(got_d, want_d)):
        fail("row kernel (directions, %d pairs) differs from its plain twin"
             % nd)
    if not torch.equal(got_d.score, got.score[:nd]):
        fail("row kernel scores with and without directions differ")
    print("dp_row kernel == plain twin: %d pairs score-only, %d pairs with"
          " directions (scores, end cells, the whole plane; %s)"
          % (B, nd, dp_row.plan(B, sb["W"], sms=sms)))
    row_ms = cuda_ms(lambda: dp_row.banded_dp_row(*on, **rkw), 3)
    row_dirs_ms = cuda_ms(lambda: dp_row.banded_dp_row(
        *[v[:nd] for v in on], **dkw), 3)
    band_cells = B * sb["n"] * sb["band"]
    print("dp_row: kernel %.3f ms (%.1f GCUPS on %d band cells), plain"
          " %.0f ms; with directions on %d pairs: kernel %.3f ms (%.1f"
          " GCUPS), plain %.0f ms"
          % (row_ms, band_cells / row_ms / 1e6, band_cells, row_plain_ms, nd,
             row_dirs_ms, band_cells * nd / B / row_dirs_ms / 1e6,
             row_plain_dirs_ms))
    # K4 score-only reads the codes, lengths, band and table once and
    # writes the scores and end cells once
    row_work = (nbytes(*on, rkw["w_eff"], subst, *got),
                DP_ROW_OPS_PER_CELL * band_cells)
    row_bound, row_bound_by = bound_ms(*row_work, FP32_OPS_PER_S)
    print("dp_row: bound %.4f ms (%s; %.1f MB, %.2f G operations)"
          % (row_bound, row_bound_by, row_work[0] / 1e6, row_work[1] / 1e9))

    # -- 8. the experiment probes, counted -------------------------------
    transpose_probe.LAUNCHES = 0
    i16_probe.LAUNCHES = 0
    tr_legs = transpose_probe.run()
    i16_rows = i16_probe.run(rows=(256, I16_ROWS))
    probe_counts = {"transpose_probe": transpose_probe.LAUNCHES,
                    "i16_probe": i16_probe.LAUNCHES}
    print("launches of the probes' kernels: %s" % probe_counts)
    if not all(probe_counts.values()):
        fail("a probe did not go through its kernel: %s" % probe_counts)
    for leg in tr_legs:
        print("transpose probe: %s %s: ok=%s %.4f ms (%.1f GB/s eff; bound"
              " %.4f ms)" % (leg["leg"], leg["shape"], leg["ok"], leg["ms"],
                             leg["gbps"], leg["bound_ms"]))
    if not all(leg["ok"] for leg in tr_legs):
        fail("a transpose leg differs from the plain version")
    for row in i16_rows:
        if not row["ok"]:
            fail("i16 op %r at %d rows: %s" % (row["op"], row["rows"],
                                               row["error"]))
        print("i16 probe: OK %s [%d, 128]: kernel %.4f ms, plain %.4f ms,"
              " bound %.4f ms" % (row["op"], row["rows"], row["ms"],
                                  row["plain_ms"], row["bound_ms"]))
    # the probe's kernel leg and library leg on the whole probe plane
    tr_kernel, tr_library = (
        next(leg for leg in tr_legs if leg["leg"] == name
             and leg["shape"] == list(transpose_probe.PLANE))
        for name in ("kernel_transpose_u8", "library_transpose_u8"))
    big = [row for row in i16_rows if row["rows"] == I16_ROWS]
    i16_err = max(row["max_abs_err"] for row in i16_rows)

    # the transpose on phase 4's dirs plane, the walk redesign's input
    t_got = transpose_probe.transpose_minor(dirs4, device=dev)
    t_want = transpose_probe.transpose_minor_reference(dirs4, device=dev)
    tr_err = float((torch.maximum(t_got, t_want)
                    - torch.minimum(t_got, t_want)).max())
    if not torch.equal(t_got, t_want):
        fail("transpose kernel differs from the plain version on the dirs"
             " plane %s" % (tuple(dirs4.shape),))
    del t_got, t_want
    plane_ms = cuda_ms(lambda: transpose_probe.transpose_minor(
        dirs4, device=dev), 5)
    plane_library_ms = cuda_ms(
        lambda: transpose_probe.transpose_minor_reference(dirs4, device=dev),
        5)
    print("transpose of phase 4's dirs plane %s (%.1f MB): kernel %.4f ms,"
          " plain (= library) %.4f ms, bound %.4f ms; the walk over it"
          " %.3f ms" % (tuple(dirs4.shape), dirs4.numel() / 1e6, plane_ms,
                        plane_library_ms,
                        transpose_probe.transpose_bound_ms(dirs4), walk_ms))

    # -- 9. bands wider than 2048 lanes, counted -----------------------
    wr = np.random.default_rng(0)
    Sw = Sequence(A4, wr.choice(4, WIDE_LEN))
    Tw = Sequence(A4, wr.choice(4, WIDE_LEN))
    wseg = [{"segment": WIDE_SEGMENT}]
    ekw = dict(subst=subst, go_score=GO, ge_score=GE, with_transcripts=True)
    dp_ad.LAUNCHES = 0
    walk.LAUNCHES = 0
    wide = pipeline.extend_segments(Sw, Tw, wseg, device=dev, **ekw)
    wide_counts = {"dp_ad": dp_ad.LAUNCHES, "walk": walk.LAUNCHES}
    wide_cpu = pipeline.extend_segments(Sw, Tw, wseg, device="cpu", **ekw)
    wcut = [pipeline.cut_segment(seg, WIDE_LEN, WIDE_LEN) for seg in wseg]
    (widx, wLS, wLT, wW), = pipeline.plan_launches(wcut, True)
    print("wide band: W %d, launches %s, score %r, %d ops from (%d, %d)"
          % (wW, wide_counts, wide[0]["score"], len(wide[0]["transcript"]),
             wide[0]["origin_start"], wide[0]["mutate_start"]))
    if wW != 3072 or wide_counts != {"dp_ad": 1, "walk": 1}:
        fail("the wide segment did not run one W 3072 launch of each"
             " kernel: W %d, %s" % (wW, wide_counts))
    got_score, letters_ok = rescore(
        np, wide[0]["transcript"], Sw.to_array(), Tw.to_array(),
        wide[0]["origin_start"], wide[0]["mutate_start"], subst)
    if wide != wide_cpu or wide[0]["score"] != WIDE_SCORE \
            or got_score != WIDE_SCORE or not letters_ok:
        fail("wide band: the card gives %r, the CPU twins %r (rescored %r)"
             % (wide, wide_cpu, got_score))
    wx = pipeline.launch_inputs(wcut, widx, wLS, wLT, wW, Sw.to_array(),
                                Tw.to_array(), True)
    B4, L4 = WIDE_4096["B"], WIDE_4096["L"]
    codes = wr.integers(0, 4, (B4, L4)).astype(np.int8)
    mut = codes.copy()
    hit = wr.random((B4, L4)) < 0.1
    mut[hit] = (mut[hit] + 1) % 4
    w4 = dict(s_codes=codes, t_codes=mut,
              s_lens=np.full((B4,), L4, np.int32),
              t_lens=np.full((B4,), L4, np.int32),
              dmin=np.full((B4,), -2048, np.int32),
              w_eff=np.full((B4,), 4095, np.int32))
    wide_ms = {}
    for Ww, xs in ((wW, wx), (4096, w4)):
        won = {k: torch.from_numpy(np.asarray(v)).to(dev)
               for k, v in xs.items()}
        wargs = (won["s_codes"], won["t_codes"], won["s_lens"],
                 won["t_lens"], won["dmin"])
        wkw = dict(W=Ww, subst=subst, go=GO, ge=GE, flags=flags,
                   w_eff=won["w_eff"], with_dirs=True, device=dev)
        g = dp_ad.banded_dp_ad(*wargs, **wkw)
        t_plain = time.perf_counter()
        want = dp_ad.banded_dp_ad_reference(*wargs, **wkw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t_plain) * 1e3
        lo_live, hi_live = dp_ad.live_nibbles(won["dmin"], won["w_eff"], Ww)
        bad = (((g.dirs ^ want.dirs) & 15).ne(0) & lo_live).sum() \
            + (((g.dirs ^ want.dirs) >> 4).ne(0) & hi_live).sum()
        if not (torch.equal(g.score, want.score)
                and torch.equal(g.end_i, want.end_i)
                and torch.equal(g.end_j, want.end_j)) or int(bad):
            fail("DP kernel at W %d differs from its plain twin" % Ww)
        dp_err = max(dp_err, float((g.score - want.score).abs().max()))
        wide_ms[Ww] = cuda_ms(lambda: dp_ad.banded_dp_ad(*wargs, **wkw), 3)
        print("dp_ad at W %d: %d pairs of %d x %d, kernel == plain twin"
              " (scores, end cells, dirs plane); kernel %.3f ms, plain %.0f"
              " ms" % (Ww, len(xs["dmin"]), wargs[0].shape[1],
                       wargs[1].shape[1], wide_ms[Ww], plain_ms))

    print(json.dumps({"kernels": [
        {"name": "dp_ad", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/dp_ad.cu",
         "replaces": "biseqt_tpu/ops/pallas_dp_ad.py:73",
         "launches": counts["dp_ad"], "max_abs_err": dp_err,
         "ms": dp_ms, "plain_ms": dp_plain_ms, "bound_ms": dp_bound,
         "bound_by": dp_bound_by, "library_ms": None},
        {"name": "walk", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/walk.cu",
         "replaces": "biseqt_tpu/ops/pallas_walk.py:512",
         "launches": counts["walk"], "max_abs_err": walk_err,
         "ms": walk_ms, "plain_ms": walk_plain_ms, "bound_ms": walk_bound,
         "bound_by": walk_bound_by, "library_ms": None},
        {"name": "dp_row", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/dp_row.cu",
         "replaces": "biseqt_tpu/ops/pallas_dp.py:54",
         "launches": row_launches, "max_abs_err": row_err,
         "ms": row_ms, "plain_ms": row_plain_ms, "bound_ms": row_bound,
         "bound_by": row_bound_by, "library_ms": None},
        # the plain version is PyTorch's transpose copy: plain = library
        {"name": "transpose_probe", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/transpose_probe.cu",
         "replaces": "experiments/transpose_probe.py:66",
         "launches": probe_counts["transpose_probe"], "max_abs_err": tr_err,
         "ms": tr_kernel["ms"], "plain_ms": tr_library["ms"],
         "bound_ms": tr_kernel["bound_ms"], "bound_by": "bytes",
         "library_ms": tr_library["ms"]},
        # the ten ops at [I16_ROWS, 128], summed; each plain version is
        # the op's PyTorch call, so plain = library
        {"name": "i16_probe", "route": "cuda",
         "source": "biseqt_tpu_torch/csrc/i16_probe.cu",
         "replaces": "experiments/mosaic_i16_probe.py:21",
         "launches": probe_counts["i16_probe"], "max_abs_err": i16_err,
         "ms": sum(row["ms"] for row in big),
         "plain_ms": sum(row["plain_ms"] for row in big),
         "bound_ms": sum(row["bound_ms"] for row in big), "bound_by": "bytes",
         "library_ms": sum(row["plain_ms"] for row in big)},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
