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
           or "rounds"), primary frames, the path tracer
  csrc/    CUDA C++ sources (sm_90a) and host C++ (triangle split, PMJ
           table), compiled at first use
  utils/   nvcc / g++ builds + ctypes bindings of csrc/, mesh generation
           and mesh preparation

The port imports nothing of `massivevoxelraytracing_tpu` (nor `jax`):
where it needs host code of the reference that imports no JAX (mesh
generation, the triangle split, the PMJ generator), it keeps its own copy.

Types: Morton codes are one int64 (63 bits). Every u32 word that reaches
the kernel (brick and supernode rows, node masks, packed colors) is held
as an int32 bit pattern; arithmetic that needs headroom or a logical shift
runs in int64 and is masked with 0xFFFFFFFF before the cast back.
"""
