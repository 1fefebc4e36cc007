"""scripts/table_ab.py without a card: the entry point at --device cpu (the
cases' plain versions through the wrappers on CPU tensors) and its
refusal without a card; the earlier source it keeps under csrc/earlier/
is commit 6fa41fa's probes, defines the entry points it swaps with the
arguments the current wrappers pass, and has no shared-form queries, so
its layouts and shared memory come from its launchers' own formulas;
which kernel each design's shared forms launch, read from a listing."""

import re

import pytest
import torch

from massivevoxelraytracing_torch.ops import probes
from massivevoxelraytracing_torch.scripts import table_ab as ab

# The tensors here are small: one intra-op thread keeps the test runner's
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)


def test_main_runs_the_plain_versions_on_the_cpu():
    got = ab.main(["--device", "cpu"])
    assert list(got["table_select_probe"]) == ["cpu"]
    assert list(got["node_gather_probe"]) == ["n=128 cpu", "n=1024 cpu", "n=4096 cpu"]
    for rec in (*got["table_select_probe"].values(), *got["node_gather_probe"].values()):
        assert rec["lanes"] == 256 and "ms" not in rec


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab.main([])


def read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("entry", sorted(ab.ENTRY.values()))
def test_earlier_source_takes_the_current_arguments(entry):
    """The swapped entry points are in the earlier source and take the
    arguments the current source's do; the earlier source has none of the
    current one's shared-form queries."""
    old = read(ab.EARLIER)
    new = read(ab.EARLIER.replace("earlier/hako_probes_6fa41fa.cu", "hako_probes.cu"))

    def params(text):
        head = re.search(rf'extern "C" int {entry}\((.*?)\)', text, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in head.split(",")]

    assert entry in ab.entry_points(old) and params(old) == params(new)
    assert set(ab.QUERIES) <= set(ab.entry_points(new))
    assert not set(ab.QUERIES) & set(ab.entry_points(old))


class Lib:
    """A stand-in for a loaded library: its entry points, suffixed."""

    def __init__(self, names, suffix=""):
        for name in names:
            setattr(self, name + suffix, lambda *a: 0)


LISTING = {
    "_ZN47_GLOBAL__N__2328bf87_14_hako_probes_cu_c4a0389c24node_gather_probe_kernel"
    "ILi1EEEvPKjiPKiiiPiS5_": [],
    "_ZN47_GLOBAL__N__2328bf87_14_hako_probes_cu_c4a0389c25table_select_probe_kernel"
    "ILi1EEEvPKjPKiiiPi": [],
    "_ZN47_GLOBAL__N__2328bf87_14_hako_probes_cu_c4a0389c26table_select_shared_kernel"
    "ILi3ELi32EEEvPKjPKiiiPi": [],
}


def test_a_design_without_queries_is_the_packed_table():
    """An earlier source without the shared-form queries launches its
    packed table from the kernels' shared instantiation, with 12 n bytes
    (the select: 768 static); a source with the select's query reads its
    layout from its one shared-select instantiation."""
    old = ab.Design(Lib(ab.ENTRY.values(), "_old"), LISTING, "", "_old")
    assert old.layout("node_gather_probe", 4096) == (3, 1)
    assert old.layout("table_select_probe", 64) == (3, 1)
    assert "node_gather_probe_kernelILi1EE" in old.kernel("node_gather_probe", 128)
    assert "table_select_probe_kernelILi1EE" in old.kernel("table_select_probe", 64)
    assert old.smem_bytes("node_gather_probe", 1024) == "12288 B"
    assert old.smem_bytes("table_select_probe", 64) == "768 B static"
    lib = Lib([*ab.ENTRY.values(), "table_select_probe_smem_bytes"])
    lib.table_select_probe_smem_bytes = lambda: 25360
    new = ab.Design(lib, LISTING, "")
    assert new.layout("table_select_probe", 64) == probes.SELECT_LAYOUT
    assert "table_select_shared_kernelILi3ELi32EE" in new.kernel("table_select_probe", 64)
    assert new.smem_bytes("table_select_probe", 64) == "25360 B"
