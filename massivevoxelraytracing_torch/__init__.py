"""PyTorch / CUDA port of the massive voxel renderer (Hako).

A second package beside `massivevoxelraytracing_tpu` (the JAX reference).
Module paths and function names mirror the reference, so each counterpart
is found by path: `ops/hako.py` here ports `ops/hako.py` there.

Layout:
  ops/     tensor code: bits, Morton codes, voxelizer, HakoTree build,
           the traversal's plain tensor version (hako_kernels) and the
           wrapper of the hand-written CUDA megakernel (hako_mega)
  models/  scene build, acceleration-structure dispatch, primary frames
  csrc/    CUDA C++ sources (sm_90a), compiled at first use
  utils/   nvcc build + ctypes binding of csrc/

Host code that imports no JAX (mesh generation, mesh preparation, PNG)
is shared from `massivevoxelraytracing_tpu.utils`, not copied. Nothing in
this package imports `jax`.

Types: Morton codes are one int64 (63 bits). Every u32 word that reaches
the kernel (brick and supernode rows, node masks, packed colors) is held
as an int32 bit pattern; arithmetic that needs headroom or a logical shift
runs in int64 and is masked with 0xFFFFFFFF before the cast back.
"""
