"""The port's utilities (biseqt_tpu_torch.utils) against the JAX
package's, on the same calls: cached results, progress lines, the
timer and the loggers.  Exact: the same values, the same bytes written
(times excepted), and pickles one package writes the other reads."""

import io
import re
import time

import pytest

from biseqt_tpu import utils as ref
from biseqt_tpu_torch import utils as port


@pytest.mark.parametrize("writer,reader", [(ref, port), (port, ref),
                                           (port, port)])
def test_with_dumpfile_caches_across_packages(tmp_path, writer, reader):
    calls = []

    def compute(x):
        calls.append(x)
        return {"x": x, "twice": [x, x]}

    p = str(tmp_path / "sub" / "r.pkl")
    first = writer.with_dumpfile(compute)(21, dumpfile=p)
    assert reader.with_dumpfile(compute)(21, dumpfile=p) == first
    assert calls == [21]                  # the second call read the pickle
    assert reader.with_dumpfile(compute)(
        21, dumpfile=p, ignore_existing=True) == first
    assert calls == [21, 21]
    assert reader.with_dumpfile(compute)(5) == {"x": 5, "twice": [5, 5]}


@pytest.mark.parametrize("total", [None, 4])
def test_progress_indicator_writes_the_same_lines(total):
    def lines(mod):
        f = io.StringIO()
        pi = mod.ProgressIndicator(total=total, msg="indexing", f=f,
                                   interval=0.0).start()
        for _ in range(4):
            pi.progress()
        pi.finish()
        # the elapsed time is the one part that may differ
        return re.sub(r"\(\d+\.\ds\)", "(t)", f.getvalue())

    got = lines(port)
    assert got == lines(ref)
    assert got.endswith("\rindexing 4 done (t)\n")


def test_timer_and_loggers():
    for mod in (ref, port):
        with mod.Timer() as t:
            time.sleep(0.01)
        assert t.elapsed >= 0.01
    log = port.get_logger("kmers")
    assert log.name == "biseqt_tpu_torch.kmers"
    assert port.get_logger("kmers") is log and len(log.handlers) == 1
    assert not log.propagate
    assert ref.get_logger("kmers").level == log.level
