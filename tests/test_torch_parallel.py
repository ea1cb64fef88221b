"""The port's mesh layer and blockwise all-vs-all engine
(biseqt_tpu_torch.parallel) against the JAX package's, on the same
numpy inputs.

* ``make_mesh``: the (data, band) shapes over a world of one and over a
  ``torch.distributed`` group, and its ``ValueError`` for a mesh that
  does not fit.
* ``overlap_stats_block`` / ``overlap_matrix_sharded`` /
  ``all_vs_all_overlaps``: the cases of ``tests/test_parallel.py``
  through both packages; integer outputs equal, ``p`` and ``s0`` within
  rtol 1e-5, atol 1e-6.
* The two sharded functions on a world of two gloo processes on the CPU
  (``torch.multiprocessing.spawn``, rendezvous through a file under the
  test's ``tmp_path``: no TCP port), against the world of one.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from biseqt_tpu_torch.parallel import make_mesh
from biseqt_tpu_torch.parallel import allvsall as port

RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 240


def _reads(rng, **kw):
    from biseqt_tpu.sequence import pack_sequences
    from test_torch_allvsall import reads_with_overlaps

    reads, starts = reads_with_overlaps(rng, **kw)
    codes, lens = pack_sequences(reads, pad_to=768 if len(reads) == 8
                                 else 640)
    return codes, lens, starts


def _assert_close(got, want, exact):
    for k in exact:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    for k in ("p", "s0"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _host(stats):
    return {k: v.cpu().numpy() for k, v in stats.items()}


def test_mesh_shapes_world_of_one():
    m = make_mesh(device="cpu")
    assert m.shape["data"] == 1 and m.shape["band"] == 1
    assert m.data_rank == 0 and m.data_group is None
    assert m.device == torch.device("cpu")


@pytest.mark.parametrize("n_data,n_band,devices", [
    (2, 1, None), (1, 2, None), (None, 2, None), (0, 1, None),
    (1, 0, None), (2, 1, [0])])
def test_mesh_that_does_not_fit_raises(n_data, n_band, devices):
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(n_data=n_data, n_band=n_band, devices=devices,
                  device="cpu")


def test_overlap_stats_block_matches_jax(rng):
    """``test_overlap_stats_block_finds_true_overlaps``'s reads through
    both packages, and its qualitative checks on the port's result."""
    import jax.numpy as jnp
    from biseqt_tpu.parallel.allvsall import overlap_stats_block

    codes, lens, starts = _reads(rng)
    want = overlap_stats_block(jnp.asarray(codes), jnp.asarray(lens),
                               jnp.asarray(codes), jnp.asarray(lens),
                               wordlen=8)
    got = _host(port.overlap_stats_block(codes, lens, codes, lens,
                                         wordlen=8, device="cpu"))
    _assert_close(got, want, ("num_seeds", "diag", "olap_len"))
    n = len(starts)
    for q in range(n - 1):
        assert got["s0"][q, q + 1] > 25
        assert abs(got["diag"][q, q + 1] - (starts[q + 1] - starts[q])) <= 64
    assert got["s0"][0, n - 1] < 25


@pytest.mark.parametrize("target_chunk", [1, 3, 32])
def test_overlap_stats_block_target_chunks(rng, target_chunk):
    """Targets streamed in chunks (one that does not divide the targets
    among them) give the unchunked block, and a query block against
    all targets gives the whole matrix's rows."""
    codes, lens, _ = _reads(rng, n_reads=11, glen=2400, rlen=500)
    whole = _host(port.overlap_stats_block(codes, lens, codes, lens,
                                           wordlen=8, device="cpu"))
    got = _host(port.overlap_stats_block(codes[3:7], lens[3:7], codes, lens,
                                         wordlen=8,
                                         target_chunk=target_chunk,
                                         device="cpu"))
    for k in whole:
        assert np.array_equal(got[k], whole[k][3:7]), k


def test_overlap_matrix_sharded_matches_jax(rng):
    """The JAX package's 8-device sharded run and the port's world of
    one give the same matrix."""
    from biseqt_tpu.parallel import make_mesh as jax_mesh
    from biseqt_tpu.parallel.allvsall import overlap_matrix_sharded

    codes, lens, _ = _reads(rng)
    want = overlap_matrix_sharded(codes, lens, wordlen=8, mesh=jax_mesh())
    got = port.overlap_matrix_sharded(codes, lens, wordlen=8,
                                      mesh=make_mesh(device="cpu"),
                                      device="cpu")
    assert all(isinstance(v, np.ndarray) for v in got.values())
    _assert_close(got, want, ("num_seeds", "diag", "olap_len"))


@pytest.mark.parametrize("method,kw", [
    ("auto", dict(min_p=0.4)), ("sorted", dict(min_p=0.4)),
    ("blockwise", dict(min_p=0.4)),
    ("sorted", dict(min_p=0.3, min_score=10.0, bucket=64, max_hits=8)),
    ("blockwise", dict(min_p=0.3, min_olap_len=200, max_hits=2))])
def test_all_vs_all_overlaps_matches_jax(rng, method, kw):
    """``test_all_vs_all_overlaps_pairs`` through both packages: the same
    (q, t, diag) pairs, p and s0 within tolerance; adjacent pairs found,
    the far pair not."""
    from biseqt_tpu.parallel import all_vs_all_overlaps

    codes, lens, starts = _reads(rng)
    want = all_vs_all_overlaps(codes, lens, wordlen=8, method=method, **kw)
    got = port.all_vs_all_overlaps(codes, lens, wordlen=8, method=method,
                                   device="cpu", **kw)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    np.testing.assert_allclose([g[3:] for g in got], [w[3:] for w in want],
                               rtol=RTOL, atol=ATOL)
    pairs = {(q, t) for q, t, *_ in got}
    if kw == dict(min_p=0.4):
        assert all((q, q + 1) in pairs for q in range(len(starts) - 1))
        assert (0, len(starts) - 1) not in pairs


def test_all_vs_all_auto_picks_blockwise_with_a_mesh(rng, monkeypatch):
    codes, lens, _ = _reads(rng)
    seen = []
    monkeypatch.setattr(port, "overlap_matrix_sharded",
                        lambda *a, **kw: seen.append(kw) or {
                            k: np.zeros((8, 8)) for k in port.STATS})
    port.all_vs_all_overlaps(codes, lens, mesh=make_mesh(device="cpu"),
                             device="cpu")
    assert seen and seen[0]["mesh"] is not None


def _world_worker(rank, world, store, inputs, out_dir):
    """One rank of a gloo world: the mesh over the group, then both
    sharded functions; results to ``out_dir/rank<r>.npz``."""
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        data = np.load(inputs)
        mesh = make_mesh(device="cpu")
        assert mesh.shape == {"data": world, "band": 1}
        assert mesh.data_rank == rank
        blk = port.overlap_matrix_sharded(data["codes"], data["lens"],
                                          wordlen=8, mesh=mesh, device="cpu")
        srt = port.overlap_matrix_sorted_sharded(
            data["codes"], data["lens"], wordlen=8, bucket=32, mesh=mesh,
            device="cpu")
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank),
                 **{"block_" + k: v for k, v in blk.items()},
                 **{"sorted_" + k: v for k, v in srt.items()})
    finally:
        dist.destroy_process_group()


def _run_world(tmp_path, codes, lens, world=2):
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, codes=codes, lens=lens)
    ctx = mp.spawn(_world_worker,
                   args=(world, str(tmp_path / "store"), inputs,
                         str(tmp_path)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish in %d s"
                        % SPAWN_TIMEOUT_S)
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(str(tmp_path / ("rank%d.npz" % r))))
            for r in range(world)]


@pytest.mark.parametrize("n_reads", [8, 11])
def test_sharded_world_of_two_matches_world_of_one(tmp_path, rng, n_reads):
    """Both sharded functions on two gloo ranks (11 reads: a padded row
    block) give every rank the world of one's whole matrix, exactly."""
    kw = {} if n_reads == 8 else dict(n_reads=11, glen=2400, rlen=500)
    codes, lens, _ = _reads(rng, **kw)
    one = make_mesh(device="cpu")
    want = {}
    for k, v in port.overlap_matrix_sharded(codes, lens, wordlen=8,
                                            mesh=one, device="cpu").items():
        want["block_" + k] = v
    for k, v in port.overlap_matrix_sorted_sharded(
            codes, lens, wordlen=8, bucket=32, mesh=one,
            device="cpu").items():
        want["sorted_" + k] = v
    for got in _run_world(tmp_path, codes, lens):
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (n_reads, n_reads)
            assert np.array_equal(got[k], want[k]), k


def test_sorted_sharded_matches_jax(rng):
    """``test_sorted_sharded_matches_single_device`` through both
    packages: the JAX 8-device sharded run and the port's world of one."""
    from biseqt_tpu.parallel import make_mesh as jax_mesh
    from biseqt_tpu.parallel.allvsall import overlap_matrix_sorted_sharded

    codes, lens, _ = _reads(rng)
    want = overlap_matrix_sorted_sharded(codes, lens, wordlen=8, bucket=32,
                                         mesh=jax_mesh())
    got = port.overlap_matrix_sorted_sharded(codes, lens, wordlen=8,
                                             bucket=32, device="cpu")
    _assert_close(got, want, ("window", "diag", "olap_len"))
