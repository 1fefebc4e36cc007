"""Device meshes and the two collectives of the multi-device layer (the
port of the JAX package's parallel/mesh.py).

The JAX package runs one controller over a `jax.sharding.Mesh` with two
logical axes:
  'dp'  pixel / ray data parallelism (no collectives)
  'sp'  sample (spp) parallelism, reduced with a psum
and `shard_map` runs the same body on every device. Here one Python
controller runs the body once per mesh entry, in row-major mesh order, on
that entry's device, and the collectives are explicit:
  all_gather  a torch.cat of the shards' tensors on the first shard's
              device, in shard order;
  psum        a sum in ascending shard order: ((x_0 + x_1) + x_2) + ...
              Float addition is not associative, so the order is fixed
              here and the result is the same on every run; it need not
              equal one device's sum over the whole batch bit for bit.
Mesh entry k lives on card k % torch.cuda.device_count(). With one card
every shard runs on it, one after another; their launches still queue
asynchronously on the stream. `device="cpu"` gives CPU entries (the
tests); without a card, a CUDA mesh raises rather than fall back.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A numpy object array of torch.device with one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} axes, names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """The devices in row-major (shard) order."""
        return list(self.devices.reshape(-1))


def mesh_devices(n: int, device="cuda") -> list:
    """n mesh entries of `device`'s type: on CUDA, entry k on card
    (index + k) % device_count (index 0 unless given); on the CPU, n
    entries of the CPU. Raises when a CUDA mesh is asked for and there is
    no card."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card (pass device='cpu' "
                           "for the CPU)")
    count = torch.cuda.device_count()
    first = dev.index or 0
    return [torch.device("cuda", (first + k) % count) for k in range(n)]


def default_sp(n: int) -> int:
    """The JAX package's choice of the sample axis (make_mesh :25-38): the
    largest of 4, 2, 1 dividing n; below 4 devices, 2 if n is even."""
    sp = 1
    for cand in (4, 2, 1):
        if n % cand == 0 and n // cand >= 1:
            sp = cand
            break
    if n < 4:
        sp = 1 if n % 2 else 2
        if n == 1:
            sp = 1
    return sp


def make_mesh(n_devices: int | None = None, sp: int | None = None,
              device="cuda") -> Mesh:
    """A ('dp', 'sp') mesh of n_devices entries (default: every card, or
    one CPU entry)."""
    if n_devices is None:
        n_devices = (1 if torch.device(device).type == "cpu"
                     else max(torch.cuda.device_count(), 1))
    devs = mesh_devices(n_devices, device)
    if sp is None:
        sp = default_sp(n_devices)
    if n_devices % sp:
        raise ValueError(f"sp={sp} does not divide {n_devices} devices")
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n_devices // sp, sp), ("dp", "sp"))


def make_build_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A flat ('dp',) mesh: the build has no sample axis; every entry owns
    a contiguous run of triangle chunks."""
    return Mesh(make_mesh(n_devices, 1, device).devices.reshape(-1), ("dp",))


def all_gather(parts: list) -> torch.Tensor:
    """Concatenate the shards' tensors along dim 0, in shard order, on the
    first shard's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def psum(parts: list) -> torch.Tensor:
    """Sum the shards' tensors in ascending shard order on the first
    shard's device: ((p0 + p1) + p2) + ..."""
    dev = parts[0].device
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc
