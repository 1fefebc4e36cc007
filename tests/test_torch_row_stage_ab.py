"""scripts/row_stage_ab.py without a card: the entry point at --device cpu
(the cases' plain versions, the wrappers on CPU tensors, on a small tree
in place of the lattice) and its refusal without a card; the earlier
sources it keeps under csrc/earlier/ define the entry points it swaps,
with the arguments the current wrappers pass; where each design's shared
memory a block is read from; the L2 read probe's plain version and its
wrapper's checks."""

import re

import numpy as np
import pytest
import torch

from massivevoxelraytracing_torch.ops import hako, morton
from massivevoxelraytracing_torch.scripts import row_stage_ab as ab

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def small_tree():
    rng = np.random.default_rng(64)
    c = torch.from_numpy(rng.integers(0, 64, size=(3000, 3)))
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    return hako.build_hako(codes, 64, device="cpu", dps=1.0 / 64)


def test_main_runs_the_plain_versions_on_the_cpu(monkeypatch):
    tree = small_tree()
    monkeypatch.setattr(ab.treecache, "lattice_tree", lambda res, device: tree)
    got = ab.main(["--device", "cpu", "--res", "64", "--width", "32", "--height", "32"])
    dda = got["dda"]
    assert dda["uniq"] == 32 and dda["lanes"] == 2048 and not dda["fat"]
    for order in ("round order", "sorted by row"):
        rec = dda[order]
        assert rec["go_lanes"] > 0 and "ms" not in rec
        # every go-lane's row is among the block's 32 smallest here
        assert rec["cached_lanes"] == rec["go_lanes"]
    assert (dda["sorted by row"]["block_distinct_rows"]
            < dda["round order"]["block_distinct_rows"])
    assert list(got["fetch"]) == ["cpu"] and "ms" not in got["fetch"]["cpu"]


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab.main([])


@pytest.mark.parametrize("which", ["rounds", "probes"])
def test_earlier_source_takes_the_current_arguments(which):
    """The swapped entry point is in the earlier source, takes the
    arguments the current source's does, and launches its kernel."""
    with open(ab.EARLIER[which]) as f:
        old = f.read()
    with open(ab.EARLIER[which].replace(f"earlier/hako_{which}_a33e950.cu",
                                        f"hako_{which}.cu")) as f:
        new = f.read()

    def params(text):
        head = re.search(rf'extern "C" int {ab.ENTRY[which]}\((.*?)\)', text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in head.split(",")]

    assert ab.ENTRY[which] in ab.entry_points(old)
    assert params(old) == params(new)
    assert f"{ab.KERNEL[which]}<" in old or f"{ab.KERNEL[which]}<<<" in old


@pytest.mark.parametrize("which, shim", [("rounds", True), ("probes", False)])
def test_smem_query_of_each_source(which, shim):
    """The launchers' shared memory is read from the sources' own formula:
    the current source exports its query; the earlier rounds source gets
    one appended that answers from its cached_smem_bytes, the earlier
    probes source (a fetch launched with none) gets none."""
    with open(ab.EARLIER[which]) as f:
        old = f.read()
    with open(ab.EARLIER[which].replace(f"earlier/hako_{which}_a33e950.cu",
                                        f"hako_{which}.cu")) as f:
        new = f.read()
    query, formula = ab.SMEM[which]
    assert query in ab.entry_points(new) and ab.smem_shim(which, new) == ""
    extra = ab.smem_shim(which, old)
    assert bool(extra) == shim
    if shim:
        assert ab.entry_points(extra) == [query] and f"return {formula}(v);" in extra


def test_l2_read_plain_and_the_wrappers_checks():
    """Each lane's sum, mod 2^32, of its vectors' word xors over the
    passes, as a loop computes it; the wrapper on a CPU tensor gives it
    and refuses a buffer that is not whole vectors, no blocks and a block
    that is not whole warps."""
    from massivevoxelraytracing_torch.ops import probes

    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.integers(0, 1 << 32, 4 * 45, dtype=np.uint64)
                           .astype(np.uint32).view(np.int32))
    v = buf.numpy().view(np.uint32).reshape(-1, 4).astype(np.uint64)
    x = v[:, 0] ^ v[:, 1] ^ v[:, 2] ^ v[:, 3]
    want = np.array([int(x[g::32].sum()) * 3 % (1 << 32) for g in range(32)],
                    dtype=np.uint64).astype(np.uint32).view(np.int32)
    got = probes.l2_read_probe(buf, passes=3, blocks=1, threads=32)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, probes.l2_read_plain(buf, passes=3, lanes=32))
    for kw in (dict(blocks=0), dict(blocks=1, threads=48)):
        with pytest.raises(ValueError):
            probes.l2_read_probe(buf, passes=1, **kw)
    with pytest.raises(ValueError):
        probes.l2_read_probe(buf[:6], passes=1, blocks=1)
