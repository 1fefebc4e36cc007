"""utils/sass.py on SASS listings in the two forms cuobjdump prints
(branch targets as labels, or as addresses): the outermost loop's body,
its dependent chain, and the kernels found by template arguments."""

import pytest
import torch

from massivevoxelraytracing_torch.utils import sass

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122construct_probe_kernelILi0EEEvPKfS2_PKiPKjS6_iiPfPi
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.AND P0, PT, R0, c[0x0][0x210], PT ;
        /*0030*/              @P0 EXIT ;
.L_x_0:
        /*0040*/                   FMNMX R4, R2, R3, !PT ;
        /*0050*/                   FADD R5, R3, R2 ;
        /*0060*/                   FMNMX R2, R4, R5, PT ;
        /*0070*/                   FMNMX R4, R2, R3, !PT ;
        /*0080*/                   FADD R5, R3, R2 ;
        /*0090*/                   FMNMX R2, R4, R5, PT ;
        /*00a0*/                   IADD3 R6, R6, 0x1, RZ ;
        /*00b0*/                   ISETP.GE.AND P1, PT, R6, c[0x0][0x214], PT ;
        /*00c0*/             @!P1 BRA `(.L_x_0) ;
        /*00d0*/                   STG.E desc[UR4][R8.64], R2 ;
        /*00e0*/                   EXIT ;
.L_x_1:
        /*00f0*/                   BRA `(.L_x_1);
		Function : _ZN12_GLOBAL__N_117walk_probe_kernelILb1EEEvPKjS2_PKfS4_iiPi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   IADD3 R3, R2, 0x2, RZ ;
        /*0030*/                   ISETP.NE.AND P0, PT, R3, RZ, PT ;
        /*0040*/              @P0 BRA 0x20 ;
        /*0050*/                   ISETP.NE.AND P1, PT, R2, RZ, PT ;
        /*0060*/              @P1 BRA 0x10 ;
        /*0064*/                   R2P PR, R2, 0x1e ;
        /*0068*/              @P3 SHF.R.U32.HI R2, RZ, 0x2, R2 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
"""


def test_loop_body_and_chain_from_labels():
    funcs = sass.functions(LISTING)
    name = sass.kernel_name(funcs, "construct_probe_kernel", 0)
    got = sass.loop_counts(funcs, "construct_probe_kernel", 0, repeats=2)
    body = sass.loop_body(funcs[name])
    assert body[0].startswith("FMNMX") and body[-1].endswith("BRA `(.L_x_0)")
    # 6 construct instructions, the counter, its compare and the branch;
    # a repeat's chain is (FMNMX | FADD) -> FMNMX, 2 deep
    assert got == dict(body=9, chain=4, per_repeat=4.5, chain_per_repeat=2.0)


def test_outermost_loop_from_addresses():
    funcs = sass.functions(LISTING)
    body = sass.loop_body(funcs[sass.kernel_name(funcs, "walk_probe_kernel", True)])
    assert len(body) == 6 and body[0].startswith("IADD3 R2")  # 0x10 .. 0x60
    # IADD3 R2 -> IADD3 R3 -> ISETP P0 -> BRA
    assert sass.chain_length(body) == 4
    # R2P writes every predicate: IADD3 R2 -> R2P -> @P3 SHF
    tail = [t for _a, t, _l in funcs[sass.kernel_name(funcs, "walk_probe_kernel", True)]]
    assert sass.chain_length(tail[1:2] + tail[7:9]) == 3


def test_kernel_name_needs_one_match():
    funcs = sass.functions(LISTING)
    with pytest.raises(ValueError):
        sass.kernel_name(funcs, "construct_probe_kernel", 1)
    with pytest.raises(ValueError):
        sass.loop_body([(0, "EXIT", ()), (16, "BRA 0x10", ())])
