"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole, so that biseqt_tpu_torch passes), the reference
imports nothing of the program, and no module reads the JAX package's
benchmark files or the smoke run."""

import ast
import os
import re

from harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "biseqt_tpu"}


def sources(sub=""):
    top = os.path.join(core.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    seen = set()
    for path in sources():
        names = set(imported(path))
        assert not names & FORBIDDEN, path
        seen |= names
    assert "biseqt_tpu_torch" in seen


def test_whole_names_are_compared():
    assert "biseqt_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert set(core.FORBIDDEN) == FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert not set(imported(path)) & (FORBIDDEN | {"biseqt_tpu_torch",
                                                       "harness"}), path


def test_no_module_reads_the_jax_benchmark_or_the_smoke_run():
    words = re.compile(r"chip_smoke|\bbench\.py\b|BENCH_r\d|BASELINE\.|"
                       r"\bexperiments\b")
    for path in sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as f:
            text = f.read()
        assert not words.search(text), path
