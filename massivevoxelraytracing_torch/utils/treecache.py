"""HakoTree disk cache for the shared bench scene (the port's counterpart
of the JAX package's utils/treecache.py).

`load_hako` reads both layouts:
  - the JAX package's npz (`lv0..`, `n_lv`, rows padded to its buckets,
    level tables in a TPU form, color / emission optional), converted by
    ops/hako.from_numpy;
  - the port's own (`layout` = LAYOUT: int32 rows cut to their count,
    plain int32 [n, 3] level tables, color and emission always present).
`save_hako` writes the port's layout under file names of its own
(`cache_path`), so neither package picks up the other's cache by accident:
their builds of the lattice differ by a few cell-boundary voxels. Writes
are atomic (a temporary file, then os.replace): a reader never sees a
partial file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import hako

LAYOUT = "hako-torch-1"
# bump when the cached scene or the port's layout changes incompatibly
SCENE_TAG = "torch_lat64"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "tree_cache")


def cache_path(grid_res: int, cache_dir: str | None = None) -> str:
    """The port's cache file of the lattice at grid_res, named by its tree
    layout (fat: with supernode rows)."""
    layout = "fat" if hako.use_snodes_for(grid_res) else "plain"
    return os.path.join(cache_dir or DEFAULT_DIR,
                        f"hako_tree_{SCENE_TAG}_{grid_res}_{layout}.npz")


def _np_i32(t) -> np.ndarray:
    if t is None:
        return np.zeros(0, np.int32)
    return t.detach().cpu().numpy().astype(np.int32)


def save_hako(tree: hako.HakoTree, path: str) -> None:
    """Write `tree` in the port's layout, atomically."""
    arrs = dict(
        layout=np.array(LAYOUT),
        bricks=_np_i32(tree.bricks[: tree.n_bricks]),
        snodes=_np_i32(None if tree.snodes is None
                       else tree.snodes[: tree.n_snodes]),
        n_lv=len(tree.levels),
        root_mask_lo=tree.root_mask_lo, root_mask_hi=tree.root_mask_hi,
        T=tree.T, res=tree.res, grid_res=tree.grid_res,
        lower=tree.lower.cpu().numpy(), upper=tree.upper.cpu().numpy(),
        dps=tree.dps, n_voxels=tree.n_voxels,
        color=_np_i32(tree.color), emission=_np_i32(tree.emission),
        has_color=tree.color is not None,
        has_emission_table=tree.emission is not None,
        has_emission=bool(tree.has_emission),
    )
    for i, lv in enumerate(tree.levels):
        arrs[f"lv{i}"] = _np_i32(lv)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the temporary name keeps the .npz suffix (np.savez appends it otherwise)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def _load_port(z, device) -> hako.HakoTree:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    levels = tuple(t(z[f"lv{i}"]) for i in range(int(z["n_lv"])))
    n_snodes = int(z["snodes"].shape[0])
    return hako.HakoTree(
        bricks=t(z["bricks"]),
        n_bricks=int(z["bricks"].shape[0]),
        levels=levels,
        n_per_level=tuple(int(lv.shape[0]) for lv in levels),
        root_mask_lo=int(z["root_mask_lo"]),
        root_mask_hi=int(z["root_mask_hi"]),
        T=int(z["T"]), res=int(z["res"]), grid_res=int(z["grid_res"]),
        lower=torch.from_numpy(z["lower"]).to(device),
        upper=torch.from_numpy(z["upper"]).to(device),
        dps=float(z["dps"]),
        snodes=t(z["snodes"]) if n_snodes else None,
        n_snodes=n_snodes,
        color=t(z["color"]) if bool(z["has_color"]) else None,
        emission=t(z["emission"]) if bool(z["has_emission_table"]) else None,
        n_voxels=int(z["n_voxels"]),
        has_emission=bool(z["has_emission"]),
    )


def _jax_fields(z) -> dict:
    """The JAX package's npz as the dict ops/hako.from_numpy takes."""
    n_lv = int(z["n_lv"])
    d = {k: z[k] for k in ("bricks", "n_bricks", "n_per_level", "root_mask_lo",
                           "root_mask_hi", "T", "res", "grid_res", "lower",
                           "upper", "dps", "n_snodes")}
    d["levels"] = [z[f"lv{i}"] for i in range(n_lv)]
    for key in ("snodes", "color", "emission", "has_emission"):
        if key in z.files:
            d[key] = z[key]
    if "n_voxels" in z.files:
        d["n_voxels"] = z["n_voxels"]
    else:  # early caches: count the occupancy bits of the brick rows
        words = np.ascontiguousarray(
            np.asarray(z["bricks"])[: int(z["n_bricks"]), :128], np.uint32)
        d["n_voxels"] = int(np.unpackbits(words.view(np.uint8)).sum())
    return d


def load_hako(path: str, device="cuda") -> hako.HakoTree:
    """A cached tree, in either package's layout, on `device`."""
    with np.load(path, allow_pickle=False) as z:
        if "layout" in z.files:
            if str(z["layout"]) != LAYOUT:
                raise ValueError(f"{path}: unknown layout {z['layout']}")
            return _load_port(z, device)
        return hako.from_numpy(_jax_fields(z), device=device)


def lattice_tree(grid_res: int, device="cuda", cache_dir: str | None = None):
    """Load (or build and cache) the bench lattice's tree at grid_res."""
    from ..models import scene
    from . import meshgen

    path = cache_path(grid_res, cache_dir)
    if os.path.exists(path):
        return load_hako(path, device)
    tri, cols = meshgen.sphere_lattice(6, 4)
    tree = scene.build_scene(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel="hako", chunk_tris=262144, device=device,
    )
    save_hako(tree, path)
    return tree
