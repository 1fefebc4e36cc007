"""scripts/stage_ab.py and chip_smoke.py's A/B steps without a card: the
entry point at --device cpu (both input sets' stages through the wrapper on
CPU tensors, the plain versions) and its refusal without a card; the earlier
source it builds holds the parent commit's stage kernel and launcher, and
the header both include is the parent's; the stages' walk slots as warps
run them; the SASS count a warp-lane and pipe floor that the stages' bounds
read; the A/B steps chip_smoke.py takes by its command line."""

import hashlib
import importlib.util
import os

import pytest
import torch

from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import common, issue_ab, stage_ab
from massivevoxelraytracing_torch.utils import cuda_build

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sha256 of the stage kernel's block (StageParams .. probe_stage_kernel) and
# of probe_stage_probe_launch in commit bd00d0e's csrc/hako_probes.cu, and of
# its csrc/hako_device.cuh
PARENT_STAGE_BLOCK = "89053936f743b1c3cc33e2b81056bca73b81f1e145217be41ec6ca8349512d1a"
PARENT_DEVICE_HEADER = "6fc0449248a83857213bdd5187245fc7994bfd3e471dc0ef9824132eefe023ac"


def read(path):
    with open(path) as f:
        return f.read()


def stage_block(text):
    """The stage kernel's block and its launcher in a hako_probes.cu."""
    a = text.index("struct StageParams {")
    b = text.index("// 2D gathers within a tile")
    c = text.index('extern "C" int probe_stage_probe_launch(')
    return text[a:b] + text[c:text.index("\n}\n", c) + 3]


def test_main_runs_the_plain_versions_on_the_cpu():
    got = stage_ab.main(["--device", "cpu"])
    assert list(got) == [f"{s} stage {k}" for s in ("script", "hits") for k in range(5)]
    for key, rec in got.items():
        assert rec["lanes"] == stage_ab.CPU_LANES and "ms" not in rec
        assert rec["T"] == (2 if key.startswith("script") else stage_ab.HIT_T)


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage_ab.main([])


def test_earlier_source_runs_the_parent_stage_kernel():
    """The earlier library the A/B builds (issue_ab.build_earlier) swaps in
    probe_stage_probe_launch, whose source text, with the stage kernel's, is
    the parent commit's; the header it includes is the parent's too, so it
    runs the parent's stage kernel. The current source's launcher takes the
    same arguments."""
    old = read(issue_ab.EARLIER)
    assert stage_ab.ENTRY in issue_ab.SWAPPED and stage_ab.ENTRY in issue_ab.entry_points(old)
    assert hashlib.sha256(stage_block(old).encode()).hexdigest() == PARENT_STAGE_BLOCK
    header = read(os.path.join(cuda_build.CSRC, "hako_device.cuh"))
    assert hashlib.sha256(header.encode()).hexdigest() == PARENT_DEVICE_HEADER
    new = stage_block(read(os.path.join(cuda_build.CSRC, "hako_probes.cu")))
    sig = stage_block(old).split('extern "C" int probe_stage_probe_launch(')[1].split("{")[0]
    assert sig in new and "walk64_hopper<false>" in new and "hako::walk64" not in new


@pytest.mark.parametrize("stage", range(5))
def test_stage_slots_count_the_warps_slowest_lanes(stage):
    """probes.stage_slots on the hits set: each walk's warp slots are the
    sum over 32-lane groups of their slowest lane's (walk_slots_plain), at
    least the lanes' slots over 32 and at most the lanes' slots; the walks
    are stage 3's two and stage 4's T."""
    rays, bounds, root, tabs = stage_ab.hit_inputs(torch.device("cpu"), 100)
    walks = []
    probes.probe_stage_plain(stage, rays, bounds, root, tabs, T=stage_ab.HIT_T, walks=walks)
    for hopper in (False, True):
        got = probes.stage_slots(stage, rays, bounds, root, tabs, T=stage_ab.HIT_T,
                                 hopper=hopper)
        assert len(got) == len(walks) == {3: 2, 4: stage_ab.HIT_T}.get(stage, 1)
        for rec, (lo, hi, vm6, t1, dc, tq) in zip(got, walks):
            s = probes.walk_slots_plain(lo & 0xFFFFFFFF, hi & 0xFFFFFFFF, vm6, t1, dc, tq,
                                        hopper=hopper)
            groups = [s[i:i + 32] for i in range(0, 100, 32)]
            assert rec["warps"] == 4 and rec["lane_slots"] == int(s.sum())
            assert rec["warp_slots"] == sum(int(g.max()) for g in groups)
            assert rec["warps_in"] == sum(int(g.max() > 0) for g in groups)
        assert got[0]["lane_slots"] > 0


def test_stage_loop_times_follow_the_lane_body():
    """Stages 0-3: a walk loop and its guard a walk; stage 4: the level loop
    (T times, entered once), then one walk loop for the T walks."""
    slots = [dict(warp_slots=64, warps_in=16), dict(warp_slots=32, warps_in=8)]
    assert common.stage_loop_times(3, slots, 2, 32) == ([2.0, 1.0], [0.5, 0.25])
    assert common.stage_loop_times(4, slots, 2, 32) == ([2.0, 3.0], [1.0, 0.75])


def test_blocks_per_sm_by_registers():
    assert [stage_ab.blocks_per_sm(r) for r in (16, 32, 40, 48, 64, 128, 255)] == [
        16, 16, 12, 10, 8, 4, 2]
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118probe_stage_kernel"
           "ILi3EEEvNS_11StageParamsE' for 'sm_90a'\nptxas info    : Used 40 registers, "
           "used 0 barriers\n")
    assert stage_ab.ptxas_registers(log) == {3: 40}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_takes_the_ab_steps_only_with_ab():
    """Without --ab the run takes no A/B step (none builds a library from
    csrc/earlier/); with it, all six; any other argument is refused."""
    cs = chip_smoke()
    assert cs.AB is False and cs.ab_field(lambda: 1 / 0) == cs.NOT_RUN
    assert cs.ab_steps([]) == ()
    assert cs.ab_steps(["--ab"]) == cs.AB_STEPS
    assert cs.AB_STEPS == ("render_ab", "row_stage_ab", "table_ab", "issue_ab", "gather_ab",
                           "stage_ab")
    for argv in (["--abc"], ["--ab", "x"], ["ab"]):
        with pytest.raises(SystemExit):
            cs.ab_steps(argv)
