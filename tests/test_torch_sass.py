"""ising_tpu_torch.sass: SASS instructions by pipe, by source line and in a
kernel's main loop, read from an nvdisasm listing (no nvcc here: a small
listing in nvdisasm's format stands in for one)."""

import pytest

from ising_tpu_torch import sass

NAME = ("_ZN12_GLOBAL__N_118dense_sweep_kernelILi1ELi13ELi4ELb0EEEvPhPKhS3_S3_"
        "iiijjjiN5ising7Table10EjjjNS_7JPlanesE")
CSRC = "/repo/ising_tpu_torch/csrc"
LISTING = f"""
\t.section\t.text.{NAME},"ax",@progbits
{NAME}:
\t//## File "{CSRC}/dense_sweep.cu", line 318
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
\t//## File "{CSRC}/dense_sweep.cu", line 331
        /*0010*/                   ISETP.GE.AND P0, PT, R2, R3, PT ;
\t//## File "/usr/local/cuda/include/sm_32_intrinsics.hpp", line 556 inlined at "{CSRC}/counter_rng.cuh", line 24
\t//## File "{CSRC}/counter_rng.cuh", line 24 inlined at "{CSRC}/counter_rng.cuh", line 61
\t//## File "{CSRC}/counter_rng.cuh", line 61 inlined at "{CSRC}/dense_sweep.cu", line 282
\t//## File "{CSRC}/dense_sweep.cu", line 282
.L_x_1:
        /*0020*/                   SHF.L.W.U32.HI R4, R5, 0xd, R5 ;
        /*0030*/                   IMAD.IADD R6, R4, 0x1, R7 ;
\t//## File "{CSRC}/dense_sweep.cu", line 285
        /*0040*/                   PRMT R8, R9, 0x4440, RZ ;
        /*0050*/                   LDS R8, [R8+UR4] ;
        /*0060*/              @P1  LOP3.LUT R9, R9, 0x80, RZ, 0x3c, !PT ;
        /*0070*/                   NOP ;
        /*0080*/              @P0  BRA `(.L_x_1) ;
\t//## File "{CSRC}/dense_sweep.cu", line 340
        /*0090*/                   IADD3 R2, R2, 0x2, RZ ;
        /*00a0*/                   BRA `(.L_x_0) ;
        /*00b0*/                   EXIT ;
"""


def test_functions_read_lines_labels_and_branches():
    fns = sass.functions(LISTING)
    assert list(fns) == [NAME]
    instrs = fns[NAME]
    assert [op for _, op, _, _ in instrs][:3] == ["LDC", "ISETP.GE.AND",
                                                  "SHF.L.W.U32.HI"]
    assert "NOP" not in [op for _, op, _, _ in instrs]
    # an intrinsic counts where the repo's source calls it, an inlined
    # function where it is written
    where = {op: w for _, op, _, w in instrs}
    assert where["SHF.L.W.U32.HI"] == ("counter_rng.cuh", 24)
    assert where["IMAD.IADD"] == ("counter_rng.cuh", 24)
    assert where["PRMT"] == ("dense_sweep.cu", 285)
    targets = {a: t for a, op, t, _ in instrs if op.startswith("BRA")}
    assert targets == {0x80: 0x20, 0xa0: 0x10}
    assert sass.template_args(NAME) == (1, 13, 4, 0)


def test_main_loop_is_the_longest_innermost_loop():
    instrs = sass.functions(LISTING)[NAME]
    assert sass.main_loop(instrs) == (0x20, 0x80)
    assert sass.main_loop(instrs[:2]) is None


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", "alu"), ("LOP3.LUT", "alu"), ("SHF.L.W.U32.HI", "alu"),
    ("PRMT", "alu"), ("IMAD.IADD", "fma"), ("IMAD.WIDE.U32", "fma"),
    ("LDS", "memory"), ("STG.E", "memory"), ("IMMA.16832.U8.U8", "tensor"),
    ("UIADD3", "uniform"), ("BRA", "control/other")])
def test_pipe_of(op, pipe):
    assert sass.pipe_of(op) == pipe


def test_groups_and_sites_per_pass(tmp_path, capsys):
    path = tmp_path / "listing.txt"
    path.write_text(LISTING)
    assert sass.main(["dense_sweep.cu", "--listing", str(path), "--kernel",
                      "dense_sweep_kernel", "--group",
                      "gen=counter_rng.cuh:1-200", "--group",
                      "accept=dense_sweep.cu:283-288", "--sites",
                      "1,13,4,0=2"]) == 0
    out = capsys.readouterr().out
    assert "[sass] dense_sweep.cu dense_sweep_kernel[1, 13, 4, 0]" in out
    # the loop's branch is written on the accept's line
    assert "main loop gen: alu 1, fma 1\n" in out
    assert "main loop accept: alu 2, control/other 1, memory 1\n" in out
    assert "main loop all: alu 3, control/other 1, fma 1, memory 1\n" in out
    assert ("per site (2 a pass of the loop) accept: alu 1, control/other "
            "0.5, memory 0.5\n") in out
    assert "function other: alu 2, control/other 2, memory 1\n" in out


# Kernel names as a real cubin gives them (the anonymous namespace holds the
# source file's name, so a lazy pattern from the first "bit1_" runs into it).
REAL_NAMES = {
    "_ZN47_GLOBAL__N__bfe8ef1a_14_bit1_planes_cu_78d8582718bit1_planes_kernel"
    "ILi0ELi10ELi24ELi0EEEvPjPKjS3_S3_iijjjijjNS_11AcceptTableEN5ising8"
    "GeometryE": ("bit1_planes", (0, 10, 24, 0)),
    "_ZN46_GLOBAL__N__82535ee7_13_bit1_sweep_cu_0a40ac5717bit1_sweep_kernel"
    "ILi1ELi13ELb0EEEvPjPKjS3_S3_iijjjijjjjjN5ising8GeometryE":
        ("bit1_sweep", (1, 13, 0)),
    "_ZN48_GLOBAL__N__5079c90d_15_packed_sweep_cu_37c7447519packed_sweep_"
    "kernelILi2ELi4ELi2ELb0ELb0EEEvNS_5SweepEN5ising10ThresholdsE":
        ("packed_sweep", (2, 4, 2, 0, 0)),
    "_ZN47_GLOBAL__N__4ee53239_14_dense_sweep_cu_301a425318dense_sweep_kernel"
    "ILi2ELi4ELi1ELb0EEEvPhPKhS3_S3_iiijjjiN5ising7Table10EjjjNS_7JPlanesE":
        ("dense_sweep", (2, 4, 1, 0)),
    "_ZN48_GLOBAL__N__f949c625_15_packed_fused_cu_eb910fd419packed_fused_"
    "kernelILi2ELi4ELi2ELb0EEEvNS_9FusedArgsE": ("packed_fused", (2, 4, 2, 0)),
    "_ZN45_GLOBAL__N__962133e3_12_mxu_sweep_cu_411c4cff16mxu_sweep_kernel"
    "ILi2ELi4ELi2EEEvPhPKhS3_S3_iijjjiN5ising7Table10Ejj":
        ("mxu_sweep", (2, 4, 2)),
    NAME: ("dense_sweep", (1, 13, 4, 0)),
}


@pytest.mark.parametrize("name", sorted(REAL_NAMES))
def test_kernel_key_reads_the_kernels_own_name(name):
    assert sass.kernel_key(name) == REAL_NAMES[name]


def test_kernel_key_skips_other_functions():
    assert sass.kernel_key("_ZN5ising6philoxILi10EEE5uint4jjjjjj") is None
    # a file name with a kernel's stem, without the kernel's own name
    assert sass.kernel_key("_ZN46_GLOBAL__N__82535ee7_13_bit1_sweep_cu_0a40ac57"
                           "4walkILi0ELb0EEEvv") is None
