"""utils/sass.py on SASS listings in the two forms cuobjdump prints
(branch targets as labels, or as addresses): the outermost loop's body,
its dependent chain, the kernels found by template arguments, and the
pipe floor of a loop body at given rates; the Meter's record beside it."""

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


SLOW_PATHS = """
		Function : _ZN12_GLOBAL__N_118fetch_probe_kernelEPKjPKiiiPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R9+URZ], RZ ;
        /*0020*/              @!P0 BRA 0x100 ;
        /*0030*/                   DEPBAR.LE SB0, 0x0 ;
        /*0040*/                   BRA.DIV UR4, 0x140 ;
        /*0050*/                   IMAD.SHL.U32 R4, R4, 0x8, RZ ;
        /*0060*/                   LDS.64 R12, [R4] ;
        /*0070*/                   LOP3.LUT R4, R13, R12, RZ, 0x3c, !PT ;
        /*0080*/                   ISETP.GE.AND P0, PT, R11, R16, PT ;
        /*0090*/             @!P0 BRA 0x50 ;
        /*00a0*/                   STG.E desc[UR4][R2.64], R10 ;
        /*00b0*/                   EXIT ;
        /*0100*/                   YIELD ;
        /*0110*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R9+URZ], RZ ;
        /*0120*/              @!P0 BRA 0x100 ;
        /*0130*/                   BRA 0x30 ;
        /*0140*/                   WARPSYNC.COLLECTIVE R11, 0x160 ;
        /*0150*/                   BRA 0x50 ;
        /*0160*/                   BRA 0x160;
"""


def test_out_of_line_paths_after_the_last_exit_are_not_the_loop():
    """The branches back from the slow paths that the compiler places past
    the last EXIT (an mbarrier wait's retry, a divergent warp's
    WARPSYNC) span more than the repeat loop; the loop is still the
    repeat loop."""
    funcs = sass.functions(SLOW_PATHS)
    body = sass.loop_body(funcs[sass.kernel_name(funcs, "fetch_probe_kernel")])
    assert len(body) == 5 and body[0].startswith("IMAD.SHL") and body[-1] == "@!P0 BRA 0x50"
    assert sass.loop_counts(funcs, "fetch_probe_kernel")["per_repeat"] == 5


def test_kernel_name_needs_one_match():
    funcs = sass.functions(LISTING)
    with pytest.raises(ValueError):
        sass.kernel_name(funcs, "construct_probe_kernel", 1)
    with pytest.raises(ValueError):
        sass.loop_body([(0, "EXIT", ()), (16, "BRA 0x10", ())])


# A loop body of four classes on three pipes, at made-up rates (warp
# instructions an SM issues a clock)
BODY = ["LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT"] * 4 + ["FMNMX.NAN R1, R2, R3, PT"] * 2 + [
    "IMAD.MOV.U32 R4, RZ, RZ, R5"] * 4 + ["POPC R6, R7"] * 2 + ["BRA 0x10", "PRMT R1, R2, R3, RZ"]
RATES = {"LOP3": 2.0, "FMNMX": 2.0, "IMAD": 2.0, "POPC": 0.5}
PIPES = {"LOP3": "alu", "FMNMX": "alu", "IMAD": "imad", "POPC": "xu"}


@pytest.mark.parametrize("drop, want_pipe, want_clocks", [
    ((), "xu", 2 / 0.5),                    # 2 POPC at 0.5 a clock
    (("POPC",), "alu", (4 + 2) / 2.0),      # LOP3 and FMNMX share their pipe: they add
    (("POPC", "LOP3"), "imad", 4 / 2.0),    # now IMAD's pipe is the busiest
])
def test_pipe_floor_busiest_pipe_wins_and_shared_classes_add(drop, want_pipe, want_clocks):
    body = [t for t in BODY if sass.PIPE_CLASS.get(t.split()[0].split(".")[0]) not in drop]
    got = sass.pipe_floor(body, RATES, PIPES, repeats=2)
    assert got["pipe"] == want_pipe and got["clocks"] == pytest.approx(want_clocks / 2)
    assert got["issue_clocks"] == pytest.approx(len(body) / 2 / 4)
    assert got["unclassified"] == 1.0  # BRA and PRMT: the issue floor only


# Lane kernels: (stage 0) a prologue, a grid-stride loop over lanes holding a
# walk's slot loop behind a forward branch that skips the walk's start and
# its hit's decode, the last EXIT, and a slow path past it that branches
# back; (stage 1) a grid-stride loop left by a predicated EXIT, its branch
# back after it, then a subroutine that a CALL enters (with a loop of its
# own) and the closing branch to itself
LANES = """
		Function : _ZN12_GLOBAL__N_118probe_stage_kernelILi0EEEvNS_11StageParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @P0 EXIT ;
.L_x_0:
        /*0020*/                   LDG.E.EF R2, desc[UR4][R8.64] ;
        /*0030*/                   FADD R3, R2, R2 ;
        /*0040*/                   ISETP.GE.AND P1, PT, R3, RZ, PT ;
        /*0050*/              @P4 BRA `(.L_x_3) ;
        /*0060*/                   IMAD.MOV.U32 R5, RZ, RZ, R3 ;
.L_x_1:
        /*0070*/                   FMNMX R4, R3, R5, PT ;
        /*0080*/                   LOP3.LUT P2, RZ, R6, R7, RZ, 0xc0, !PT ;
        /*0090*/                   FSETP.GEU.AND P3, PT, R4, R9, PT ;
        /*00a0*/              @!P3 BRA `(.L_x_1) ;
        /*00b0*/                   POPC R10, R6 ;
.L_x_3:
        /*00c0*/                   STG.E desc[UR4][R8.64], R10 ;
        /*00d0*/              @!P1 BRA `(.L_x_0) ;
        /*00e0*/                   EXIT ;
.L_x_2:
        /*00f0*/                   MUFU.RCP R11, R2 ;
        /*0100*/                   BRA `(.L_x_0) ;
		Function : _ZN12_GLOBAL__N_118probe_stage_kernelILi1EEEvNS_11StageParamsE
        /*0000*/              @P0 EXIT ;
        /*0010*/                   FADD R3, R2, R2 ;
        /*0020*/              @P1 BRA 0x40 ;
        /*0030*/                   CALL.REL.NOINC 0x70 ;
        /*0040*/                   STG.E desc[UR4][R8.64], R3 ;
        /*0050*/              @P2 EXIT ;
        /*0060*/                   BRA 0x10 ;
        /*0070*/                   MUFU.RCP R11, R2 ;
        /*0080*/              @!P3 BRA P4, 0x70 ;
        /*0090*/                   RET.REL.NODEC R4 0x0 ;
        /*00a0*/                   BRA 0xa0;
"""
LANE_RATES = {"FADD/FMUL": 4.0, "ISETP": 2.0, "FMNMX": 2.0, "LOP3": 2.0, "FSETP": 2.0,
              "IMAD": 2.0, "POPC": 0.5}
LANE_PIPES = {"FADD/FMUL": "fp32", "ISETP": "alu", "FMNMX": "alu", "LOP3": "alu",
              "FSETP": "alu", "IMAD": "imad", "POPC": "xu"}


def lane_kernel(stage):
    funcs = sass.functions(LANES)
    return funcs[sass.kernel_name(funcs, "probe_stage_kernel", stage)]


def ops(texts):
    return [t.split()[0] for t in texts]


def test_lane_split_by_grid_stride_loop_slot_loop_and_guard():
    """The lane body is the grid-stride loop's (without the prologue or the
    slow path past the last EXIT); its slot loop's instructions are apart,
    and so are those its forward branch skips (the guard); without a
    grid-stride loop the body is the kernel up to its last EXIT."""
    instrs = lane_kernel(0)
    assert sass.loops(instrs) == [(2, 13), (7, 10)]
    straight, inner, guards = sass.lane_split(instrs, grid_stride=True)
    assert ops(straight) == ["LDG.E.EF", "FADD", "ISETP.GE.AND", "@P4", "STG.E", "@!P1"]
    assert [ops(b) for b in inner] == [["FMNMX", "LOP3.LUT", "FSETP.GEU.AND", "@!P3"]]
    assert [ops(g) for g in guards] == [["IMAD.MOV.U32", "POPC"]]
    straight, inner, guards = sass.lane_split(instrs, grid_stride=False)
    assert ops(straight) == ["LDC", "@P0", "EXIT"]
    assert [len(b) for b in inner] == [6, 4] and [len(g) for g in guards] == [0, 2]
    with pytest.raises(ValueError):
        sass.lane_split([(0, "FADD R1, R2, R3", ()), (16, "EXIT", ())], grid_stride=True)


def test_a_loop_left_by_a_predicated_exit_ends_before_the_subroutines():
    """A grid-stride loop that leaves by a predicated EXIT ends at its
    branch back; the subroutine a CALL enters past it, with its own loop,
    is not the body's. loop_body keeps its own rule (the loops before the
    last EXIT), so the loop floors that read it do not move."""
    instrs = lane_kernel(1)
    assert sass._last_exit(instrs) == 6 and sass.loops(instrs) == [(1, 6)]
    with pytest.raises(ValueError):
        sass.loop_body(instrs)
    straight, inner, guards = sass.lane_split(instrs, grid_stride=True)
    assert ops(straight) == ["FADD", "@P1", "CALL.REL.NOINC", "STG.E", "@P2", "BRA"]
    assert inner == [] and guards == []


@pytest.mark.parametrize("slots, entries", [(0.0, 0.0), (0.5, 0.25), (2.5, 1.0)])
def test_pipe_floor_of_a_straight_body_with_walk_slots_added(slots, entries):
    """A straight-line body once a warp, the slot loop as many times as the
    warps run it, its guard as often as a warp enters it: each class's
    count adds, the busiest pipe wins."""
    straight, (loop,), (guard,) = sass.lane_split(lane_kernel(0), grid_stride=True)
    got = sass.pipe_floor(straight, LANE_RATES, LANE_PIPES,
                          loops=((loop, slots), (guard, entries)))
    alu = (1 + slots * 3) / 2.0  # ISETP once; FMNMX, LOP3, FSETP a slot
    by = {"fp32": 1 / 4.0, "alu": alu, "imad": entries / 2.0, "xu": entries / 0.5}
    assert got["by_pipe"] == pytest.approx(by)
    assert got["pipe"] == max(by, key=by.get) and got["clocks"] == pytest.approx(max(by.values()))
    assert got["instructions"] == pytest.approx(6 + 4 * slots + 2 * entries)
    assert got["issue_clocks"] == pytest.approx((6 + 4 * slots + 2 * entries) / 4)
    assert got["unclassified"] == pytest.approx(4 + slots)  # LDG, 2 BRA, STG; a slot's BRA
    assert sass.pipe_floor(straight, LANE_RATES, LANE_PIPES)["instructions"] == 6


def test_lane_floor_counts_a_stage_kernels_warp_lanes():
    """common.lane_floor over made-up rates: the stage's loop times and guard
    entries from its warps' slots, the floor over the lanes' warps; a lane
    body whose loops do not match the walks is not measured."""
    from massivevoxelraytracing_torch.scripts import common

    funcs = sass.functions(LANES)
    pipe = dict(rates=LANE_RATES, pipes=LANE_PIPES)
    times, entries = common.stage_loop_times(0, [dict(warp_slots=3 * 64, warps_in=32)], 2, 64)
    got = common.lane_floor(funcs, "probe_stage_kernel", (0,), grid_stride=True, times=times,
                            entries=entries, lanes=64 * 32, pipe=pipe, sms=2, clock=1e9)
    assert (times, entries) == ([3.0], [0.5]) and got["loops"] == 1 and got["straight"] == 6
    assert got["guard_sizes"] == [2] and got["instructions"] == 6 + 12 + 1
    assert got["busiest_pipe"] == "alu"
    assert got["pipe_floor_ms"] == pytest.approx(64 * 5.0 / (2 * 1e9) * 1e3)
    none = common.lane_floor(funcs, "probe_stage_kernel", (0,), grid_stride=True,
                             times=[1.0, 1.0], entries=[1.0, 1.0], lanes=64, pipe=pipe, sms=2,
                             clock=1e9)
    assert none["pipe_floor_ms"] is None and none["loops"] == 1


def test_meter_record_keeps_the_issue_floor_and_adds_pipe_and_launch_fields(monkeypatch):
    """Meter.case on a made-up card: the issue floor as before (warp
    instructions over 4 an SM a clock), the pipe floor and its share, the
    slope shares at full occupancy, an empty launch of the grid at the
    script shape."""
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import common

    meter = common.Meter.__new__(common.Meter)
    meter.device, meter.card, meter.dep_ns, meter.calibrated = torch.device("cuda", 0), "", None, True
    meter.records, meter.funcs, meter.sms, meter.clock = [], sass.functions(LISTING), 2, 1e9
    meter.pipe = {"rates": {"FMNMX": 2.0, "FADD/FMUL": 4.0, "ISETP": 2.0},
                  "pipes": {"FMNMX": "alu", "FADD/FMUL": "alu", "ISETP": "alu"}}
    times = iter([[0.010, 0.018], [0.004], [0.001]])
    monkeypatch.setattr(common, "best_ms", lambda fns, **kw: next(times))
    monkeypatch.setattr(common, "timed", lambda fn, reps=20, warm=True: (None, 7.0))
    monkeypatch.setattr(probes, "empty_launch", lambda *a: None)
    x = torch.zeros(4)
    full = dict(shape="full occupancy", lanes=256, threads=256, k=64)
    rec = meter.case("c", "construct_probe_kernel", (0,), full, lambda k: x, lambda k: x,
                     n_bytes=0, repeats=2)
    # 9 instructions a pass of 2 repeats; the pipe: 4 FMNMX / 2 + 2 FADD / 4 + 1 ISETP / 2
    # (IADD3 has no rate here: the issue floor only)
    assert rec["issue_floor_ms"] == pytest.approx(256 / 32 * 64 * 4.5 / (2 * 4 * 1e9) * 1e3)
    clocks = (4 / 2 + 2 / 4 + 1 / 2) / 2
    assert rec["pipe_clocks_per_repeat"] == pytest.approx(clocks)
    assert rec["pipe_floor_ms"] == pytest.approx(256 / 32 * 64 * clocks / (2 * 1e9) * 1e3)
    assert rec["pipe_share"] == pytest.approx(rec["pipe_floor_ms"] / 0.010)
    assert rec["slope_issue_share"] == pytest.approx(rec["issue_floor_ms"] / 0.008)
    assert rec["slope_pipe_share"] == pytest.approx(rec["pipe_floor_ms"] / 0.008)
    assert rec["bound_ms"] == rec["issue_floor_ms"] and "empty_launch_ms" not in rec
    script = dict(shape="script", lanes=256, threads=256, k=64)
    rec = meter.case("c", "construct_probe_kernel", (0,), script, lambda k: x, lambda k: x,
                     n_bytes=0, repeats=2)
    assert rec["empty_launch_ms"] == 0.001 and rec["plain_ms"] == 7.0
    assert "slope_issue_share" not in rec


# On the card (the library built, cuobjdump beside nvcc): the redesigned
# shared forms' repeat loops, and every other kernel against its SASS at
# commit aca9a3e (the redesigned walk probe kernels have a new signature;
# the construct probe's bit_at and pc64 kernels keep their names).
RECORD = "sass_aca9a3e.json"
REDESIGNED = ("hako_probes.cu:17walk_probe_kernelILb0EEEvPKjS2_PKfS4_iiPi",
              "hako_probes.cu:17walk_probe_kernelILb1EEEvPKjS2_PKfS4_iiPi",
              "hako_probes.cu:22construct_probe_kernelILi6EEEvPKfS2_PKiPKjS6_iiPfPi",
              "hako_probes.cu:22construct_probe_kernelILi7EEEvPKfS2_PKiPKjS6_iiPfPi",
              *(f"hako_probes.cu:18probe_stage_kernelILi{s}EEEvNS_11StageParamsE"
                for s in range(5)))


@pytest.fixture
def built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from massivevoxelraytracing_torch.utils import cuda_build

    cuda_build.load()
    return sass.functions(sass.dump(cuda_build.LIB_PATH))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, targs", [("table_select_shared_kernel", "select"),
                                           ("node_gather_shared_kernel", 128)])
def test_shared_forms_repeat_loop_reads_shared_memory_only(built, kernel, targs):
    """The shared select's and the n = 128 node fetch's repeat loops read
    the staged table only: 3 LDS (32-bit) a repeat (32 word copies) or one
    LDS.128 (record copies), no global, local or generic load."""
    from massivevoxelraytracing_torch.ops import probes

    layout = probes.SELECT_LAYOUT if targs == "select" else probes.gather_layout(targs)
    body = sass.loop_body(built[sass.kernel_name(built, kernel, *layout)])
    ops = [sass._opcode(t)[1] for t in body]
    loads = [op for op in ops if op.split(".")[0] in ("LDS", "LDG", "LD", "LDL")]
    want = ["LDS"] * 3 if layout[0] == 3 else ["LDS.128"]
    assert sorted(loads) == sorted(want * probes.UNROLL), loads


@pytest.mark.cuda
def test_kernels_keep_their_sass_of_aca9a3e(built):
    """Every kernel but the redesigned walk and construct probe forms and
    the probe body's stages has the machine code it had at commit aca9a3e (csrc/earlier/
    sass_aca9a3e.json, digests of that commit's library, recorded with the
    same nvcc): the main path's kernels (hako_mega, the rounds route, the
    sample chain, the frame, the scene build, the walks) and the probes'
    other forms and constructs, the yardsticks the redesigned forms are
    measured against. The redesigned ones are gone or differ."""
    import json
    import os

    from massivevoxelraytracing_torch.utils import cuda_build

    with open(os.path.join(cuda_build.CSRC, "earlier", RECORD)) as f:
        rec = json.load(f)
    assert sass.nvcc_release() == rec["nvcc"], "another nvcc: the record does not apply"
    now = sass.digests(built)
    kept = {k: v for k, v in rec["sass"].items() if k not in REDESIGNED}
    assert len(kept) == len(rec["sass"]) - len(REDESIGNED)
    assert {k: now.get(k) for k in kept} == kept
    assert all(now.get(k) != rec["sass"][k] for k in REDESIGNED)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [False, True])
def test_walk_probe_repeat_loop_runs_the_whole_walk(built, scan):
    """The walk probe's repeat loop holds the planes' multiply by the
    repeat's 1.0 and the walk's start (or the sweep's 64 cells): nothing
    of the walk is hoisted out of it."""
    body = sass.loop_body(built[sass.kernel_name(built, "walk_probe_kernel", scan)])
    counts = sass.class_counts(body)
    assert counts.get("FADD/FMUL", 0) >= 6
    if scan:  # two compares and a predicated IMAD a cell
        assert counts.get("FSETP", 0) >= 2 * 64 and counts.get("IMAD", 0) >= 64
