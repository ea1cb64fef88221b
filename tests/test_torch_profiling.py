"""The port's measurement helpers (biseqt_tpu_torch.profiling) that need
no card: the step-loop count of ``cuobjdump -sass`` output, the bound
of a kernel and the profiler trace context."""

import json
import os

import pytest
import torch

from biseqt_tpu_torch.profiling import bound_ms, sass_step_loop, trace

# cuobjdump -sass as it prints two kernels: branch targets as addresses
# (CUDA 12) or as labels, an encoding line after each instruction, a
# copy loop without a barrier, and a step loop unrolled by two
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_112dp_ad_kernelILi2ELb0ELi26EEEvNS_4ArgsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/              @!P0 BRA 0x10 ;
        /*0030*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_112dp_ad_kernelILi1ELb0ELi26EEEvNS_4ArgsE
        /*0000*/                   S2R R12, SR_TID.X ;
        /*0010*/                   LDG.E R7, desc[UR14][R4.64] ;
        /*0020*/                   STS [R6], R7 ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_7:
        /*0050*/                   FADD R16, R24, UR21 ;
        /*0060*/                   STS [R28], R27 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/                   FMNMX R22, R26, R15, !PT ;
        /*0090*/                   STS [R28], R22 ;
        /*00a0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00b0*/                   FMNMX R22, R23, R22, !PT ;
        /*00c0*/                   ISETP.GE.AND P0, PT, R0, UR4, PT ;
        /*00d0*/              @!P0 BRA `(.L_x_7) ;
        /*00e0*/                   STG.E desc[UR14][R2.64], R22 ;
        /*00f0*/                   EXIT ;
"""


def test_sass_step_loop_finds_the_barrier_loop():
    loop = sass_step_loop(SASS, "dp_ad_kernelILi1ELb0ELi26EE")
    assert loop == {
        "function": "_ZN12_GLOBAL__N_112dp_ad_kernelILi1ELb0ELi26EEEvNS_4ArgsE",
        "instructions": 9, "barriers": 2, "spills": []}


@pytest.mark.parametrize("name,want", [
    ("dp_ad_kernelILi2E", 2),          # a target given as an address
    ("dp_ad_kernelILi4E", None),       # no such function
])
def test_sass_step_loop_addresses_and_missing(name, want):
    loop = sass_step_loop(SASS, name)
    assert (loop and loop["instructions"]) == want
    if want:
        assert loop["barriers"] == 1


def test_sass_step_loop_without_a_barrier():
    """A loop with no block barrier (K4's warp-per-pair row loop) is
    found only when no barrier is asked for."""
    name = "dp_ad_kernelILi1ELb0ELi26EE"
    assert sass_step_loop(SASS, "dp_ad_kernelILi2E", barrier=False) == {
        "function": "_ZN12_GLOBAL__N_112dp_ad_kernelILi2ELb0ELi26EEEvNS_4ArgsE",
        "instructions": 2, "barriers": 1, "spills": []}
    loop = sass_step_loop(SASS.replace("BAR.SYNC", "NOP"), name,
                          barrier=False)
    assert loop["instructions"] == 9 and loop["barriers"] == 0
    assert sass_step_loop(SASS.replace("BAR.SYNC", "NOP"), name) is None


def test_sass_step_loop_places_each_spill():
    """Each local-memory load or store is reported with the length of the
    shortest loop that holds it: 0 before the loops, the outer loop's for
    a reload once an outer iteration, the inner one's inside it."""
    sass = """
		Function : _ZN12_GLOBAL__N_113dp_row_kernelILi8ELb1ELb0ELi10EEEvNS_4ArgsE
        /*0000*/                   STL [R1], R8 ;
        /*0010*/                   LDL R9, [R1] ;
        /*0020*/                   LDL R2, [R1+0x4] ;
        /*0030*/                   FADD R3, R2, R9 ;
        /*0040*/               @P0 BRA 0x20 ;
        /*0050*/                   ISETP.GE.AND P1, PT, R0, UR4, PT ;
        /*0060*/               @P1 BRA 0x10 ;
        /*0070*/                   EXIT ;
"""
    loop = sass_step_loop(sass, "dp_row_kernel", barrier=False)
    assert loop["instructions"] == 6 and loop["barriers"] == 0
    assert loop["spills"] == [0, 6, 3]


def test_bound_ms_takes_the_larger_bound():
    assert bound_ms(3.35e9, 1.0, 1e12) == pytest.approx((1.0, "bytes"))
    ms, kind = bound_ms(1.0, 33.5e9, 33.5e12)
    assert kind == "operations" and ms == pytest.approx(1.0)


def test_trace_writes_a_chrome_trace(tmp_path):
    """With a directory the block is traced into one Chrome trace there
    (the block's operators among its events); without one it is a
    no-op that writes nothing."""
    log_dir = tmp_path / "profile"
    with trace(str(log_dir)) as prof:
        torch.arange(1000).sum()
    assert prof is not None
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    for off in (None, ""):
        with trace(off) as prof:
            torch.ones(3).sum()
        assert prof is None
    assert os.listdir(tmp_path) == ["profile"]
