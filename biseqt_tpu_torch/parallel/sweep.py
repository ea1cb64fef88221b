"""Checkpointed all-vs-all sweeps: deterministic, resumable block runs.

The port of :mod:`biseqt_tpu.parallel.sweep`.  The N x N overlap matrix
is computed in blocks of query rows (:func:`.allvsall.
overlap_stats_block` on ``device``); each block's statistics are written
to disk as soon as they finish, and a restarted sweep skips the blocks
already written: safe against preemption at block granularity, and
bitwise deterministic given the inputs.  The directory layout is the JAX
package's (``manifest.json`` and ``block_%05d.npz`` with the same keys),
so either package resumes a sweep the other left half done.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.banded_dp import _host, on_device, resolve_device
from .allvsall import overlap_stats_block

__all__ = ["checkpointed_overlap_sweep"]

_KEYS = ("num_seeds", "diag", "p", "s0", "olap_len")


def checkpointed_overlap_sweep(codes, lengths, out_dir: str, *,
                               wordlen: int = 8, block: int = 64,
                               alphabet_len: int = 4, bucket: int = 32,
                               max_hits: int = 4, progress=None,
                               device="cuda"):
    """All-vs-all overlap statistics with per-block disk checkpoints.

    Args:
        codes, lengths: packed read batch (host arrays or tensors).
        out_dir: checkpoint directory; blocks land in ``block_%05d.npz``
            and ``manifest.json`` records the sweep's geometry.  A sweep
            restarted with the same inputs resumes after the blocks
            already written; a directory that holds another sweep's
            manifest raises ``ValueError``.
        progress: called as ``progress(blocks_done, n_blocks)`` after
            each block written.

    Returns a dict of [N, N] host arrays assembled from all blocks.
    """
    device = resolve_device(device)
    codes = np.asarray(_host(codes), np.int8)
    lengths = np.asarray(_host(lengths), np.int32)
    N, L = codes.shape
    os.makedirs(out_dir, exist_ok=True)
    manifest_path = os.path.join(out_dir, "manifest.json")
    manifest = {
        "n": N, "l": L, "wordlen": wordlen, "block": block,
        "bucket": bucket, "max_hits": max_hits,
        "alphabet_len": alphabet_len,
    }
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f)
        # manifests written before alphabet_len was recorded lack it
        old.setdefault("alphabet_len", alphabet_len)
        if old != manifest:
            raise ValueError("checkpoint directory %s holds a different "
                             "sweep: %r, not %r" % (out_dir, old, manifest))
    else:
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    n_blocks = (N + block - 1) // block
    t_codes = on_device(codes, torch.int8, device)
    t_lens = on_device(lengths, torch.int32, device)
    for bi in range(n_blocks):
        f = os.path.join(out_dir, "block_%05d.npz" % bi)
        if os.path.exists(f):
            continue
        lo, hi = bi * block, min((bi + 1) * block, N)
        stats = overlap_stats_block(
            t_codes[lo:hi], t_lens[lo:hi], t_codes, t_lens, wordlen=wordlen,
            alphabet_len=alphabet_len, bucket=bucket, max_hits=max_hits,
            device=device)
        tmp = f + ".tmp.npz"
        np.savez_compressed(tmp, **{k: _host(v) for k, v in stats.items()})
        os.replace(tmp, f)  # atomic: a crash never leaves a partial block
        if progress:
            progress(bi + 1, n_blocks)

    out = {k: [] for k in _KEYS}
    for bi in range(n_blocks):
        with np.load(os.path.join(out_dir, "block_%05d.npz" % bi)) as z:
            for k in _KEYS:
                out[k].append(z[k])
    return {k: np.concatenate(v, axis=0)[:N] for k, v in out.items()}
