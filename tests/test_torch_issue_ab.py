"""scripts/issue_ab.py and the pipe probe without a card: the entry point
at --device cpu (the cases' plain versions through the wrappers on CPU
tensors) and its refusal without a card; the earlier source it keeps under
csrc/earlier/ defines the entry points it swaps with the arguments the
current wrappers pass; the pipe probe's pairs are the source's, its plain
version steps each class as an independent numpy model does, and the
calibration's pipe pass runs the plain versions; the counting variant's
plain slots of both walks."""

import re

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import common
from massivevoxelraytracing_torch.scripts import hako_kernel_micro as km
from massivevoxelraytracing_torch.scripts import issue_ab as ab

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def read(path):
    with open(path) as f:
        return f.read()


def test_main_runs_the_plain_versions_on_the_cpu():
    got = ab.main(["--device", "cpu"])
    assert list(got["walk_probe"]) == ["walk64 cpu", "scan64 cpu"]
    assert list(got["construct_probe"]) == [f"construct {c} cpu" for c in probes.CONSTRUCTS]
    for rec in (*got["walk_probe"].values(), *got["construct_probe"].values()):
        assert rec["lanes"] == 256 and "ms" not in rec


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab.main([])


@pytest.mark.parametrize("entry", sorted(ab.ENTRY.values()))
def test_earlier_source_takes_the_current_arguments(entry):
    old = read(ab.EARLIER)
    new = read(ab.EARLIER.replace("earlier/hako_probes_aca9a3e.cu", "hako_probes.cu"))

    def params(text):
        head = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in head.split(",")]

    assert entry in ab.entry_points(old) and params(old) == params(new)


def test_pipe_pairs_are_the_sources():
    src = read(ab.EARLIER.replace("earlier/hako_probes_aca9a3e.cu", "hako_probes.cu"))
    enum = re.search(r"enum PipeOp \{(.*?)\};", src, re.S).group(1)
    ops = [o.strip() for o in enum.split(",")]
    assert len(ops) == len(probes.PIPE_CLASSES) + 1  # and kPipeOps
    table = src[src.index("#define PIPE_PAIRS(X)"):src.index("extern \"C\"")]
    pairs = re.findall(r"X\((kPipe\w+), (kPipe\w+)\)", table)
    assert [(probes.PIPE_CLASSES[ops.index(a)], probes.PIPE_CLASSES[ops.index(b)])
            for a, b in pairs] == list(probes.PIPE_PAIRS)


def model_step(op, a, u, ol):
    """One step of a class on a group's 4 chains (numpy uint32 [4, n]) and
    its 2 predicate chains, written from the kernel's description."""
    a = a.copy()
    b, c = np.roll(a, -1, 0), np.roll(a, -3, 0)
    if op == "SHF":
        wide = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
        return (wide >> (c & 31).astype(np.uint64)).astype(np.uint32)
    if op == "IMAD":
        return (a.astype(np.uint64) * b.astype(np.uint64) + c.astype(np.uint64)).astype(np.uint32)
    if op == "LOP3":
        return (a & b) ^ c
    if op == "POPC":
        return np.array([[bin(int(v)).count("1") for v in row] for row in a], np.uint32)
    raise ValueError(op)


@pytest.mark.parametrize("op", ["SHF", "IMAD", "LOP3", "POPC"])
def test_pipe_plain_steps_as_the_model(op):
    rng = np.random.default_rng(3)
    x0 = probes.pipe_inputs(op, op, 16, rng, "cpu")
    got = probes.pipe_probe(op, op, x0, k=2 * probes.PIPE_UNROLL).numpy().view(np.uint32)
    x = x0.numpy().view(np.uint32)
    groups = [x[:4], x[4:]]
    for _o in range(2):
        for u in range(probes.PIPE_UNROLL):
            groups = [model_step(op, g, u, None) for g in groups]
    assert np.array_equal(got[:8], np.concatenate(groups)) and not got[8].any()


def test_pipe_plain_compares_chain_as_the_kernel_describes():
    """q = (the lane's counter > the step's threshold) and not q: ISETP's
    counter a u32 stepped by c * 0x9E3779B1 + 1 a pass and compared as an
    int32 with chain (j + u) % 4 of its group plus u * 0x01000193, FSETP's
    the pass plus in[0] & 1 as a float against an immediate."""
    x0 = torch.as_tensor(np.random.default_rng(5).integers(-2 ** 31, 2 ** 31, (8, 3)),
                         dtype=torch.int32)
    x0[0] = torch.tensor([1, 7, -5], dtype=torch.int32)
    for op in ("ISETP", "FSETP"):
        got = probes.pipe_probe(op, op, x0, k=3 * probes.PIPE_UNROLL)[8]
        want = []
        for start in (1, 7, 2 ** 32 - 5):
            q = [[False, False], [False, False]]
            c, f = start, start & 1
            for _o in range(3):
                for u in range(probes.PIPE_UNROLL):
                    for g in range(2):
                        for j in range(2):
                            t = (g * 2 + j) * probes.PIPE_UNROLL + u
                            th = (int(x0[(j + u) % 4 + 4 * g, len(want)]) % 2 ** 32
                                  + u * 0x01000193) % 2 ** 32
                            ci, thi = (v - 2 ** 32 if v >= 2 ** 31 else v for v in (c, th))
                            hit = ci > thi if op == "ISETP" else f > 0.5 * t + 0.25
                            q[g][j] = (not q[g][j]) and hit
                c, f = (c * 0x9E3779B1 + 1) % 2 ** 32, f + 1
            want.append(sum(int(q[g][j]) << (2 * g + j) for g in range(2) for j in range(2)))
        assert got.tolist() == want, op


def test_pipe_rates_runs_every_pair_on_the_cpu():
    got = common.pipe_rates(torch.device("cpu"))
    assert got["rates"] == {} and got["pairs"] == {}
    with pytest.raises(ValueError):
        probes.pipe_probe("POPC", "SHF", torch.zeros(8, 4, dtype=torch.int32), k=8)
    with pytest.raises(ValueError):
        probes.empty_launch(1, 32, "cpu")


def test_walk_slots_of_both_walks():
    """Both walks stop at the same slot on rays through the unit box, and
    the plain model's passes are each repeat's slowest lane of each warp."""
    rng = np.random.default_rng(4)
    t1, dc = km.ray_planes(64, "cpu", rng)
    lo, hi = km._u32(rng, 64, "cpu"), km._u32(rng, 64, "cpu")
    old = probes.walk_count(lo, hi, t1, dc, iters=3, hopper=False)
    new = probes.walk_count(lo, hi, t1, dc, iters=3, hopper=True)
    assert torch.equal(old["slots"], new["slots"]) and old["passes"] == new["passes"]
    assert old["lane_slots"] == int(old["slots"].sum()) <= 32 * old["passes"]
    assert torch.equal(new["out"], probes.walk_probe_plain(lo, hi, t1, dc, iters=3))
