"""The port's host tier: its ctypes loader of its C++ source, its
copy of the sequence module, its profiling timers, and the rule that
the port imports neither jax nor the JAX package.

The loader's results are held to ``biseqt_tpu.native`` on the same
inputs; the sequence copy has to pass the JAX package's own sequence
tests (tests/test_sequence.py), rerun against the copy.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import biseqt_tpu.sequence as ref_sequence
import test_sequence as ref_sequence_tests
from biseqt_tpu import native as ref_native
from biseqt_tpu.ops.banded_dp import ModeFlags as RefFlags
from biseqt_tpu.stochastics import MutationProcess, rand_seq
from biseqt_tpu_torch import _build, native, profiling, sequence
from biseqt_tpu_torch.ops.banded_dp import ModeFlags
from biseqt_tpu_torch.ops.dp_ad import banded_dp_ad, parity_adjusted_dmin
from biseqt_tpu_torch.ops.walk import traceback_walk
from test_torch_cuda import UNIT, mk_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loader_builds_shared_source_into_the_port():
    assert native.available()
    assert native.SOURCE == os.path.join(REPO, "biseqt_tpu_torch", "csrc",
                                         "pwnative.cpp")
    assert os.path.dirname(native._SO) == os.path.join(
        REPO, "biseqt_tpu_torch", "build")
    assert os.path.exists(native._SO)
    assert native._flags_of(ModeFlags(local_start=True, local_end=True)) == \
        ref_native._flags_of(RefFlags(local_start=True, local_end=True))


def test_loader_refuses_other_abi(monkeypatch):
    """A library whose ABI version differs from the binding's must not
    be called through the binding's signatures."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_ABI_VERSION", native._ABI_VERSION + 1)
    assert not native.available()
    with pytest.raises(RuntimeError, match="ABI version"):
        native._load()


@pytest.mark.parametrize("flags", [dict(local_start=True, local_end=True),
                                   dict(),
                                   dict(free_start_edges=True,
                                        free_end_edges=True)])
def test_loader_matches_reference_binding(rng, flags):
    """traceback_batch_ad and compact_sweep_ops_t of the port's loader
    return what the JAX package's binding returns on the same inputs."""
    args, w_eff = mk_batch(rng)
    ss, ts, s_lens, t_lens, dmin = args
    res = banded_dp_ad(*args, W=128, subst=UNIT, go=-2.0, ge=-1.0,
                       flags=ModeFlags(**flags), w_eff=w_eff,
                       with_dirs=True, r_chunk=16, device="cpu")
    B = len(ss)
    dminq = parity_adjusted_dmin(dmin, np.arange(B, dtype=np.int32) % 2)
    dirs, ei, ej = res.dirs.numpy(), res.end_i.numpy(), res.end_j.numpy()
    f = RefFlags(**flags)
    got = native.traceback_batch_ad(dirs, dminq, ss, ts, s_lens, t_lens,
                                    ei, ej, f)
    want = ref_native.traceback_batch_ad(dirs, dminq, ss, ts, s_lens,
                                         t_lens, ei, ej, f)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    live = res.score.numpy() > -1e29
    tr, fi, fj = traceback_walk(res.dirs, dminq, np.where(live, ei, -1),
                                np.where(live, ej, -1), W=128, device="cpu")
    tr, fi, fj = tr.numpy(), fi.numpy(), fj.numpy()
    got = native.compact_sweep_ops_t(tr, fi, fj, ss, ts, s_lens, t_lens, f)
    want = ref_native.compact_sweep_ops_t(tr, fi, fj, ss, ts, f)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_kernel_build_errors_are_raised(monkeypatch, tmp_path):
    """A missing CUDA toolkit and a refused launch both raise: nothing
    falls back to the CPU."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()

    class Lib:
        @staticmethod
        def bst_cuda_error_string(code):
            return b"too many resources requested for launch"

    _build.check(Lib, 0, "launch")
    with pytest.raises(RuntimeError, match="CUDA error 701 .too many"):
        _build.check(Lib, 701, "launch")


SEQUENCE_TESTS = sorted(n for n in dir(ref_sequence_tests)
                        if n.startswith("test_"))


@pytest.mark.parametrize("name", SEQUENCE_TESTS)
def test_sequence_copy_passes_reference_tests(name, rng, monkeypatch):
    """Each test of tests/test_sequence.py, with the JAX package's
    sequence names swapped for the port's copy."""
    for sym in ref_sequence.__all__:
        monkeypatch.setattr(ref_sequence_tests, sym, getattr(sequence, sym),
                            raising=False)
    monkeypatch.setattr(ref_sequence_tests, "A4", sequence.Alphabet("ACGT"))
    fn = getattr(ref_sequence_tests, name)
    kwargs = {"rng": rng} if "rng" in inspect.signature(fn).parameters else {}
    fn(**kwargs)


def test_sequence_copy_has_reference_api():
    assert set(ref_sequence.__all__) <= set(sequence.__all__)
    assert set(sequence.__all__) - set(ref_sequence.__all__) == {
        "from_reference"}
    assert sequence.PAD == ref_sequence.PAD


def test_from_reference_converts_by_duck_typing(rng):
    A4 = ref_sequence.Alphabet("ACGT")
    S = rand_seq(A4, 200, rng=rng)
    T, _ = MutationProcess(A4, subst_probs=0.1, go_prob=0.05, ge_prob=0.2,
                           rng=rng).mutate(S)
    for ref in (S, T):
        got = sequence.from_reference(ref)
        assert type(got) is sequence.Sequence
        assert got.alphabet == sequence.Alphabet("ACGT")
        np.testing.assert_array_equal(got.to_array(), ref.to_array())
        assert str(got) == str(ref) and got.content_id == ref.content_id
    named = sequence.from_reference(ref_sequence.NamedSequence(
        A4, S.to_array(), name="r1"))
    assert type(named) is sequence.NamedSequence and named.name == "r1"
    flags = sequence.from_reference(RefFlags(free_start_edges=True))
    assert flags == ModeFlags(free_start_edges=True)
    assert type(flags) is ModeFlags
    with pytest.raises(TypeError):
        sequence.from_reference(3)


def test_profiling_phase_counts_calls_and_cells():
    profiling.report(reset=True)
    for _ in range(2):
        with profiling.Phase("unit.phase", cells=10 ** 9,
                             result=[np.zeros(1)]):
            pass
    c = profiling.counters()["unit.phase"]
    assert c["calls"] == 2 and c["cells"] == 2 * 10 ** 9
    assert '"phase": "unit.phase"' in profiling.report(reset=True)
    assert profiling.counters() == {}


_REFUSE_JAX = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "biseqt_tpu"):
            raise ImportError("refused: " + name)
        return None

for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "biseqt_tpu"):
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())
import chip_smoke
import biseqt_tpu_torch
from biseqt_tpu_torch import (_build, matrices, native, pipeline, profiling,
                              pw, sequence)
from biseqt_tpu_torch.ops import banded_dp, dp_ad, dp_row, walk
from biseqt_tpu_torch.experiments import i16_probe, transpose_probe
assert native.available()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "biseqt_tpu")]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    """The port and chip_smoke.py import in an interpreter that refuses
    jax and the JAX package (the machine with the card has no jax)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _REFUSE_JAX], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
