"""PyTorch / CUDA port of the massive voxel renderer (Hako).

A second package beside `massivevoxelraytracing_tpu` (the JAX reference).
Module paths and function names mirror the reference, so each counterpart
is found by path: `ops/hako.py` here ports `ops/hako.py` there.

Layout:
  ops/     tensor code: bits, hashing, RNG, PMJ sampling, the HDR
           environment, Morton codes, voxelizer, HakoTree build, the
           traversal's plain tensor version and the legacy round driver
           (hako_kernels), the wrappers of the hand-written CUDA kernels
           (hako_mega, hako_kernels)
  models/  scene build, acceleration-structure dispatch (traversal "mega"
           or "rounds"), primary frames, the path tracer, the host
           oracle of voxrt
  apps/    the command lines: rtcamp, voxpt, voxrt, launch_frames,
           dcn_frames, and their scenes
           (`python -m massivevoxelraytracing_torch.apps.X`)
  parallel/  the multi-device layer: meshes and ordered collectives, the
           sharded build, the sharded frame and path-trace step, and
           scene-memory sharding (bigscene)
  entry.py entry() and dryrun_multichip(n)
  config.py  EngineConfig
  csrc/    CUDA C++ sources (sm_90a) and host C++ (triangle split, PMJ
           table, HDR / OBJ decoders), compiled at first use
  utils/   nvcc / g++ builds + ctypes bindings of csrc/, mesh generation
           and preparation, image / mesh / Alembic I/O, the tree cache,
           timers, the wireframe overlay

The port imports nothing of `massivevoxelraytracing_tpu` (nor `jax`):
where it needs host code of the reference that imports no JAX (mesh
generation, the triangle split, the PMJ generator, the apps' I/O), it
keeps its own copy.

Types: Morton codes are one int64 (63 bits). Every u32 word that reaches
the kernel (brick and supernode rows, node masks, packed colors) is held
as an int32 bit pattern; arithmetic that needs headroom or a logical shift
runs in int64 and is masked with 0xFFFFFFFF before the cast back.
"""
