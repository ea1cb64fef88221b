"""The metrics of the program's finer spans (plan, gather, rows, K1's
host inputs, the wait on the card, discovery's grid and host assembly,
the seeds' fetch): a small traced run of each cell on the CPU reads
every one of its cell, and each part is no more than the span or
residual it lies in."""

import pytest

import tiny
from harness import core

PARTS = ("plan_ms.extend", "gather_ms.extend", "rows_ms.extend",
         "inputs_ms.extend", "wait_ms.extend", "wait_ms.genome",
         "components_ms.genome", "grid_ms.discover",
         "components_ms.discover", "fetch_ms.discover")
# (parts, whole): the parts' sum is at most the whole, in every cell that
# reports them
WITHIN = [(("inputs_ms.extend",), "dispatch_ms.extend"),
          (("plan_ms.extend", "gather_ms.extend", "rows_ms.extend"),
           "prep_ms.extend"),
          (("wait_ms.genome",), "extend_ms.genome"),
          (("grid_ms.discover", "components_ms.discover"),
           "discover_ms.discover"),
          (("fetch_ms.discover",), "seeds_ms.discover")]
SMALL = {"tx1t.b2048": lambda: (tiny.config(), tiny.traffic("b2048")),
         "tx1t.b16": lambda: (tiny.config(), tiny.traffic("b16")),
         "genome5t.tx": lambda: (tiny.genome(6000), None),
         "genome5t.discover": lambda: (tiny.genome(400_000, 4), None)}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_every_part_is_read_in_its_cells(cell):
    bench = core.benchmark()
    config, traffic = SMALL[cell]()
    if traffic is None:
        traffic = core.read_json(
            "traffic", core.cell_of(bench, cell)["traffic"])
        traffic["trace_calls"] = 1
    result, _ = core.run_cell(bench, cell, 2 ** 31 + 17, 0.0, True, "cpu",
                              0.0, config=config, traffic=traffic)
    assert result["correct"]
    want = [m["name"] for m in core.metrics_of(
        bench, core.cell_of(bench, cell), True) if m["name"] in PARTS]
    assert want
    got = result["metrics"]
    assert all(name in got and got[name]["value"] >= 0.0
               and got[name]["unit"] == "ms" for name in want), got
    for parts, whole in WITHIN:
        if whole in got and parts[0] in got:
            assert sum(got[p]["value"] for p in parts) \
                <= got[whole]["value"] + 1e-9, (parts, whole)
