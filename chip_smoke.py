#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ab]

Every phase drives its path and holds every kernel against its plain
version. With --ab, each redesigned kernel is also timed in turns against
its parent commit's kernels (the A/B steps below, scripts/render_ab.py,
row_stage_ab.py, table_ab.py, issue_ab.py, gather_ab.py and stage_ab.py,
which build those libraries from csrc/earlier/); without it none of them
runs, nothing is built from csrc/earlier/, and the kernels line's A/B
fields read "not run (--ab)". Any other argument is refused.

Phases (any failure raises, and the script exits non-zero):
  1. build the CUDA kernels from massivevoxelraytracing_torch/csrc (one
     nvcc per source, all at once) and the host library (g++);
  2. hold the hako_mega kernel against its plain PyTorch version on the
     card: random-voxel trees at 64^3 and 256^3 (plain top levels) and a
     512^3 tree with supernodes (T = 1, the 1024^3 layout), primary and
     shadow rays; hit mask, nmajor and vrank must be equal, t within
     rtol 3e-7 (bit-exact is expected; the ulp difference is printed);
  2b. the round driver on the same trees: intersect_rays_hako (one
     cooperative launch of hako_rounds a call, the round loop on the card)
     against its plain version, the two-launch driver (hako_probe and
     hako_dda_merge a round, a host nonzero between) and the megakernel,
     bit for bit, with the same rounds; then round by round with every
     kernel of the earlier drivers against its plain version (hako_probe;
     hako_dda and hako_merge, the unfused stage; and hako_dda_merge on a
     copy of the state, equal to the unfused stage's);
  3. the main path's primary frame: build_scene of the bench lattice at
     1024^3 (the scene build's three kernels' counts set to 0 just before
     and read just after: each must launch) and 1920x1080 frames with the
     bench camera through the megakernel and the frame's kernels (their
     counts and hako_mega's set to 0 just before the counted frame: each
     must launch), then kernel vs plain version on 16,384 rays sampled
     across that frame; the frame's kernels (models/raycast.py,
     csrc/frame.cu): frame_raygen and frame_shade (normals and colours,
     un-tiled and flat) against their plain stages on the same card
     tensors, bit for bit, on the frame and on a 1000x700 band from row
     256; each kernel's ms, its plain stage's ms and its bytes bound
     (scripts/common.raygen_bound / shade_bound) and share; with --ab,
     frame_raygen in turns with the parent commit's kernel
     (scripts/render_ab.py, both == the plain stage first); the frame through stages="plain" (the
     route before these kernels) and through the kernels, timed and
     profiled (device kernels, busy, idle; a trace must hold every launch
     the frame's wrappers and hako_mega counted, common.profile_counted,
     else "not measured"), parent route first, both images and depths
     equal to the frame's, and frame_raygen's share by that trace;
  3c. the scene build's kernels (ops/voxelize.py, csrc/vox_build.cu): the
     lattice's split triangles to the card from pageable and from pinned
     memory (ms, GB/s); vox_count, vox_emit, vox_run_heads and
     vox_unique_reduce each against its plain stage on the lattice's one
     group, on the same card tensors, bit for bit (the counts, the dump
     buffers, each tile's run heads, the unique stream in its three
     modes), with its ms, the plain stage's ms, its bound on the call's
     data (scripts/common.vox_bound; the count's and emit's on the units
     and slab-clipped cells the kernels test, common.vox_tested_cells,
     whose valid cells must equal the count's, with the bound on the bbox
     cells beside it; the reduce's the unique stage's, with the earlier
     design's boundary flags and segment ids beside it) and share, the reduce's
     library call (index_add_ of the segment sums alone), the sort alone
     and the unique stage after it (run heads, cumsum, readback, reduce)
     against the stage bound; then
     the lattice built through the plain stages and through the kernels
     (route_builds: each build's split and peak memory, a profiled build
     of each route with its device kernels and idle share), every tree
     == phase 3's field for field;
  3b. the same frame through the round driver: once through the
     two-launch driver with hako_dda_merge held against its plain version
     at every call; then through hako_rounds (one launch a frame) and the
     two-launch driver, each counted (launches, rounds, host syncs as
     torch.cuda.set_sync_debug_mode("warn") reports them), timed in turns
     and traced by scripts/rounds_trace in a child process (late in this
     one the profiler drops device events: scripts/profile_window.py; a
     trace must hold every round kernel launch, else "not measured"),
     beside an idle share estimated from CUDA events and synced walls;
     every image and depth equal to the megakernel's;
     then hako_rounds alone on the frame's rays beside hako_mega and the
     two-launch driver in turns, its co-resident grid, its bound (the
     function's on these rays, phase 3's frame bound) and beside it the
     bytes of the call's rounds (scripts/common.rounds_counts /
     rounds_bound);
  4. the path tracer: PMJ table build; a warm 16-spp step and 2 timed
     steps at 1024^3 / 1080p through the megakernel (PT Mrays/s counted
     as bench.py does, mean radiance within 1% of the JAX package's
     bench run), a profiled step (device idle share, top device ops; the
     trace must hold every hako_mega and sample-chain launch the wrappers
     counted, taken again with other idle pads until it does, else "not
     measured": scripts/common.profile_or_none),
     steps through the round driver from the same state: hako_rounds, the
     two-launch driver, hako_rounds (host clock, launches, rounds, the
     hako_rounds step's host syncs; accumulators bit-equal); the sample chain
     (ops/pt_chain.py, csrc/pt_chain.cu): its five kernels' launches a
     step (each must launch), one step through its plain stages on the
     card from the same state (accumulator bit-equal to the kernels'), both
     routes profiled, each trace held to its counts (device kernels a
     step, busy ms, idle share; where both are measured, the kernel route
     must launch at most a tenth of the plain route's device kernels),
     and each kernel against its plain stage on every stage call
     of the first packet, recorded in the warm step, bit for bit, with its
     ms, plain ms and bytes bound on the bounce-1 call (the bounce sample
     also through the sats HDRI backend, with its bound, and through both
     backends in turns with the parent commit's kernel with --ab,
     scripts/render_ab.py);
     and on one packet's full
     bounce-1 BSDF and NEE batches (the inputs the step gives the
     kernels): each of hako_probe / hako_dda / hako_merge / hako_dda_merge
     against its plain version, round by round, hako_rounds against the
     megakernel with the checked driver's rounds, and hako_mega against its
     plain version. Every kernel's time, plain time and bound are taken on
     that BSDF batch (hako_rounds' in turns with hako_mega and the
     two-launch driver, its bound hako_mega's on the batch, the bytes of the
     batch's rounds beside it), and a line prints
     hako_rounds beside hako_mega on the frame and the batch;
     hako_dda_merge's beside the unfused stage it
     replaces on the same inputs (as one train and by part: kernel B on
     the supernode and the brick rows, the hand-off's tensor ops, the
     merge);
  counters: hako_mega's counting variant (equal outputs) on the frame and
     both batches;
  5. the probes (row chase, walk vs fetch), each held against its plain
     version before its rate is printed, and the frame's and batches'
     latency and walk floors from them;
  5b. the issue-cost probes through their scripts'
     main(argv) with the probe and round kernels' counts set to 0 just
     before the phase and read just after it (each must have launched):
     scripts/hako_kernel_micro.py (calib_probe, walk64 / scan64,
     node_gather_probe in global / shared / constant memory at 128, 1024
     and 4096 nodes, table_select_probe from constant / shared /
     registers, fetch_probe) and scripts/construct_micro.py
     (construct_probe, 8 constructs) on one meter, so calibrated once;
     every case held bit for bit against its plain version at each
     launch shape (one warp an SM, full occupancy, the JAX scripts' 64 x
     2048 lanes) and at each repeat count that is timed, with its ns per
     dependent repeat,
     G repeats/s and the SASS instructions of its loop a repeat
     (cuobjdump -sass of the built library); then
     scripts/hako_phase_timing.py on bumpy_sphere at 256^3 (plain top
     levels) and 1024^3 (fat: the supernode stage) and on the phase-3
     lattice: each round kernel alone on its first quarter of the
     frame's blocks (hako_dda_merge among them), equal to its plain
     version, the host round work, one round's wall with the unfused
     and the fused stage, and the full frame's rounds through hako_rounds,
     the two-launch driver and the unfused stage, with each wall split
     into kernel and host time; the runs' launches (the
     isolated phases' among them) must add up to the phase's; then, with
     --ab, its launches not counted, scripts/row_stage_ab.fetch_ab: the redesigned
     fetch_probe (the lanes' rows staged in shared memory) in turns with
     the parent commit's kernel (csrc/earlier/hako_probes_a33e950.cu,
     built there first) at the meter's three launch shapes, each == its
     plain version, with both designs' SASS floors, the staging's bound
     at the card's L2 read rate (l2_read_probe, == its plain version)
     and the kernels' ptxas registers; and scripts/table_ab.run: the
     redesigned shared forms of node_gather_probe (n = 128, 1024, 4096)
     and table_select_probe in turns with commit 6fa41fa's kernels
     (csrc/earlier/hako_probes_6fa41fa.cu) at the same three shapes, each
     == its plain version at k and 2k, with both designs' SASS floors,
     each case's shared-memory wavefronts under both layouts, the
     3-wavefront floor, the staged tables at the L2 read rate, the
     kernels' ptxas registers and which probe kernels kept their SASS;
     the meter's calibration now first measures the SM's pipes
     (common.pipe_rates: pipe_probe, each instruction class alone and in
     pairs at full occupancy, == its plain version at k and 2k), and every
     case prints its pipe floor and share beside the issue floor (the slope
     share at full occupancy, an empty launch of the grid at the script
     shape); then (--ab) scripts/issue_ab.run: the Hopper forms of walk_probe
     (walk64, scan64) and construct_probe (the eight constructs) in turns
     with commit aca9a3e's kernels (csrc/earlier/hako_probes_aca9a3e.cu) at
     the same three shapes, each == its plain version at k and 2k, with
     both designs' SASS a repeat, issue and pipe floors, the walks' slots
     (warps against lanes, the counting variant walk_count) and
     hako_mega's loop against both floors;
  5c. this slice's path, with the probe and round kernels' counts set to
     0 just before and read just after (each must have launched, and the
     scripts' own counts must add up to the phase's):
     scripts/hako_shell_micro.py --staged (kernel A's I/O shell in both
     layouts with torch.add beside it, each into a new output a call and
     both into one fixed set of outputs, the shell + ray preamble, the real
     kernel A at 1 and 2 probes, the probe body unrolled and by stage, on
     the reference's 524,288 lanes and 256^3 tree) and
     scripts/r3_phase_split.run on the phase-3 lattice (kernel A,
     supernode rows, kernel B uncached and through the row cache of
     hako_dda_cached in the round's order and sorted by row, the sort
     alone, the distinct rows a block, the bookkeeping, the fused row
     stage, one round on the device with the unfused and the fused stage
     (kernel A and the stage on a preset state, CUDA events, beside the
     sum of their kernels' bytes bounds) and the host's wall of
     drive(max_rounds=1) for both, the full frame); every case held bit
     for bit against its plain version before it is timed, the shell
     micro's timed from HBM, its preamble's and stages' bounds the larger
     of their bytes and their pipe floors at phase 5b's pipe rates; then,
     with --ab, their launches not counted, scripts/row_stage_ab.dda_ab:
     the redesigned hako_dda_cached (rows staged by bulk copy) in turns
     with the parent commit's kernel (csrc/earlier/hako_rounds_a33e950.cu,
     built there first) on the lattice round's brick rows in the round's
     order and sorted by row, hako_dda in the same turns, each == its plain
     version; and scripts/stage_ab.run: the redesigned probe_stage_probe
     (every stage) in turns with commit aca9a3e's kernel on the shell
     micro's lanes and on lanes whose walks find cells, each == its plain
     version, with both designs' grids, registers, SASS a warp-lane and
     pipe floors;
  5d. this slice's path, with the probe kernels' counts set to 0 just
     before and read just after (each must have launched, and the
     scripts' own counts must add up to the phase's):
     scripts/dyngather_probe2.run (take_along_probe: the reference's four
     take_along_axis bodies in each form, shared memory / warp shuffles /
     L1, on one tile and on 8 tiles an SM, every timed launch reading its
     inputs from HBM, beside torch.gather, the copy shell on the same
     bytes and the bytes bound on the sectors the indices reach) and scripts/gather_probe3.main with
     every probe (the torch chase loops; a0small, whose 1024-row table the
     shared form refuses; smem_alloc_probe up to the opt-in limit, which
     must launch, and one row more, which must be refused; ohg_probe from
     shared memory, through L1 and on the tensor cores at 128 and 1024
     rows, k and 2k hops, beside its torch.matmul yardstick); every case
     held bit for bit against its plain version before it is timed; then,
     with --ab, its launches not counted, scripts/gather_ab.run: the redesigned
     ohg_probe mma mode and take_along_probe<0, SHARED> in turns with the
     parent commit's kernels (csrc/earlier/hako_probes_5ace4b1.cu, built
     there first), each == its plain version, with torch.matmul (one CUDA
     graph of the 32 hops, and launched a call at a time) / torch.gather
     in the same turns and each kernel's ptxas registers;
  6. the apps on the card, each through its main(argv) into build/:
     rtcamp (the animated lattice, frames 0-2 of 24 at 1440x900, a full
     rebuild a frame at 512^3 then 1024^3, one 16-spp step; every PNG
     read back, the last frame bit-equal to a PathTracer driven directly
     on the same tree and camera), voxrt (torus 256^3, 640x360, voxel
     colors, --oracle: the app fails past 2% disagreeing pixels) and voxpt
     (torus 256^3, 640x360, at its default packet of 2^21 lanes: 3 steps
     with --checkpoint, then --resume for a 4th, bit-equal to 4
     uninterrupted steps; then one step at EngineConfig's 65,536-lane
     packet and one at the default, accumulators bit for bit, both
     timed). hako_mega's counter is set to 0
     just before each app and read just after: each must launch it; the
     scene build's counts around the phase (each must launch); then
     rtcamp's last build again through both routes (route_builds), each
     tree == the app's;
  7. the other structures and the streamed build: (a) the bench lattice
     at 1024^3 built as a brick tree and as an octree (DAG on, then off):
     voxels equal to the hako build's, nodes, bytes, build time, a 1080p
     frame through each (the walk kernels, csrc/walks.cu: its walk kernel
     and the frame's kernels counted from 0, one launch each), timed
     through the kernels and through stages="plain" (the eager walks),
     images equal; the walk kernel against the plain walk on all 2,211,840
     frame rays, bit for bit, each timed alone, with its bound
     (scripts/common.walk_rows / walk_bound: the rays, outputs and rows
     reached) and share; every ray held against the megakernel's frame up
     to classified ties, grazes and plane drifts (utils/tiecheck.py),
     16,384 sampled rays on the card equal to the CPU's; one 16-spp PT step
     through the brick tree and one through the octree (DAG) at 640x360
     (cut from 1080p; their brick_walk / octree_walk launches counted),
     each timed beside the megakernel's step and its mean within 1% of
     it, and every structure's walk kernel against its plain walk on the
     brick step's recorded bounce-1 BSDF and NEE (shadow) batches, bit for
     bit, each then timed with its bound, and the octree walk likewise on
     the octree step's own bounce-1 batches; beside the brick walk's times
     the cells it tests a visit (walk_rows: the set bits a selection over
     the whole mask scans, the crossed and occupied cells the current one
     scans at most), beside the octree walk's the plain walk's decisions
     (descends, hits, empty first visits that pop, return visits, stays
     behind the origin), the occupied and the crossed-and-occupied
     octants a visit, and the kernel's loop trips a ray against the plain
     walk's iterations (walk_rows through traverse2.fold_counts);
     (b) the terrain shell through the streamed build: park="device" ==
     park="host" at 2048^3, then apps/scale_shell.py at 16384^3 (the JAX
     package's a1 = 0.0395 run): n_voxels == the column pass, build time,
     rows, peak memory, a 1920x1088 frame, hako_mega on it with its bytes
     bound, and the kernel against its plain version on 16,384 sampled
     rays of that frame (T = 3); (c) voxrt through the brick tree and the
     octree with --oracle, voxmesh (the PLY read back) and voxtriangle
     (the PNG read back);
  8. this slice's path, the multi-device layer, on the one card (every
     mesh entry on it, one after another), each part through its entry
     point with the kernels' counts set to 0 just before and read just
     after: (a) the lattice built by parallel/build.py over 2 and 8
     shards, every field bit for bit phase 3's tree, with the build split
     and peak memory beside build_scene's; (b) the 1080p frame over 8
     bands (make_sharded_render), image and depth == phase 3's, one
     hako_mega launch a band; (c) a 16-spp step over dp 2 x sp 4
     (make_sharded_pt_step, 4 spp an entry), within rtol / atol 2e-5 of
     phase 4's single-device step from zero, with its time, peak memory
     and a profiled step's device idle share (its trace held to the
     step's counts, else "not measured"); (d) the tree as 4
     brick-range shards (parallel/bigscene.py) on the frame's rays,
     primary, shadow and shaded, against the whole tree (one hako_rounds
     launch a shard and call, counted; hako_dda_merge held against its
     plain version at every call of a primary run through the two-launch
     driver; the primary frame's rounds and host syncs through both
     drivers, timed in turns with the two-launch driver, bit-equal); (e)
     apps/dcn_frames.py, 2 processes on the card, checksum == one
     process's; (f) rtcamp --build-devices 2 on phase 6's last
     frame, PNG == phase 6's; (g) entry.dryrun_multichip(8) and entry()'s
     function (== its plain version). hako_rounds' `launches` in the
     kernels line is the rounds PT step's plus phase 8's parts
     (`launches_by_path`); the earlier drivers' kernels, off the route,
     count the two-launch step's and frame's (hako_probe, hako_dda_merge)
     and phases 5b and 5c's (all four);
  9. the last modules' scripts through their run(), with hako_mega's
     count set to 0 just before each script that launches it and read
     just after (hako_mega's `launches_by_path` adds them): (a)
     scripts/microbench.py, the four Morton codecs (the torch codec and the
     bit loop on the card, the host C++ and the host tensor codec) held
     equal bit for bit, then in s / 100M encodes; (b)
     scripts/pt_step_timing.py on the bumpy sphere at 256^3 and on the
     lattice at 1024^3 (utils/treecache), 640x360; (c)
     scripts/pt_phase_attrib.py at its defaults (the lattice at 1024^3,
     960x540, cells b0 b1 b2 b4 b8 b8_nosky b8_nocompact, a profiled step
     of b0, b8 and b8_nocompact with the sample chain's kernels' ms in
     it, its trace held to the step's counts, else "not measured"): b8 ==
     b8_nocompact bit for bit, b8_nosky's mean 0, b0's and
     b8's means the values every run has printed (21.283392, 37.108360),
     every mean finite, and the step's split by the cells' differences;
     (d) scripts/scale_demo.py at 2048^3: the lattice's build with its
     split and peak memory, its voxels within the tie band of the JAX
     package's 54.4M (rounded), 1920x1088 frames, hako_mega's ms on the
     frame's rays and its bound, the PNG read back, and hako_mega against
     its plain version on 65,536 rays sampled across the frame; (e)
     scripts/rebuild_timing.py at 2048^3: 3 builds of the 7^3 lattice
     (7.0M triangles) in one process, the first cold, each with its split
     and peak memory; the scene build's counts around the phase (each must
     launch); then the last rebuild again through both routes
     (route_builds), each tree == the script's; each build kernel's
     launches in the kernel route's profiled build, its ms there and its
     bound on that build's calls (route_kernel_bounds: on the units and
     slab-clipped cells the kernels test, beside the bbox cells' yardstick;
     the count's bbox and slab-clipped cells; the unique stage's two
     kernels against the stage bound).
  The scene build's, the frame's and the walks' kernels' counts are also
  read around phases 6, 7a, 7c, 8 and 9 (launches_by_path in the kernels
  line: the frame kernels' main path is phase 3's counted frame and 7a's
  three, the walks' 7a's frames and brick PT step; then phases 6, 7c, 8
  and 9, each counted from 0). Phase 8b also requires one launch of each
  frame kernel a band.

Prints the card's name and power limit beside every timing, a JSON line
of the probes' numbers (phase 5b's under "slice", 5c's under "split", 5d's
under "gather"),
one JSON line of
kernel results, one entry for each hand-written kernel (take_along_probe
one for each reference body it runs; the sample chain's five kernels; the
scene build's three, with phase 3c's copy and routes under "build"; the
frame's two, with both frame routes, and the two walks, with each
structure's frame and walk numbers;
phase 4's two chain routes under "pt"; with the apps' numbers, phase 8's
under "parallel", phase 7's under "accel" and "shell" and phase 9's under
"scale"), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs a CUDA device and the repository around it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 7
# the timings in turns of each redesigned kernel against its parent commit's
# kernels (scripts/*_ab.py), taken only with --ab: they build the parents'
# libraries from csrc/earlier/ and repeat findings already recorded
AB_STEPS = ("render_ab", "row_stage_ab", "table_ab", "issue_ab", "gather_ab", "stage_ab")
NOT_RUN = "not run (--ab)"
AB = False  # whether this run takes AB_STEPS (main sets it from the command line)
GRID = 1024
WIDTH, HEIGHT = 1920, 1080
TIMED_FRAMES = 5
SAMPLE_RAYS = 16384
JAX_N_VOXELS = 13_645_209  # the JAX package's build of this scene
TIE_BAND = 0.015           # voxelizer float-tie band (test_parallel_build)
HIT_BAND = (0.62, 0.64)
# mean of accum[:, :3] after 3 16-spp steps, the JAX package's bench run
# of the same scene, camera and sky (BENCH_r05.json); the estimator and
# its samples are the same, so the port's must agree within 1%
JAX_PT_MEAN = 37.1021
PT_MEAN_RTOL = 0.01
REPO = os.path.dirname(os.path.abspath(__file__))
APPS_OUT = os.path.join(REPO, "build", "chip_smoke_apps")
RTCAMP_ARGV = ["--scene", "lattice", "--frames", "24", "--frame-range", "0", "3",
               "--width", "1440", "--height", "900", "--steps", "1",
               "--from-res", "512", "--to-res", "1024", "--hdri", "procedural"]
VOXRT_ARGV = ["--scene", "torus", "--res", "256", "--width", "640", "--height",
              "360", "--mode", "color", "--oracle"]
VOXPT_ARGV = ["--scene", "torus", "--res", "256", "--width", "640", "--height",
              "360", "--snapshot-every", "0"]
STRUCTURES = (("brick", dict(accel="brick")), ("octree", dict(accel="octree")),
              ("octree_nodag", dict(accel="octree", dag=False)))
TIE_SHARE = 0.01           # classified ties allowed across structures
PT7_W, PT7_H = 640, 360    # the brick PT step's frame (cut from 1920x1080)
SHELL_RES = 16384          # the reference's headline scale
SHELL_A1 = 0.0395          # the JAX package's 16384^3 run (docs/logs/r5_scale16k.log)
PARK_RES = 2048            # park="device" vs park="host", bit for bit
SHELL_W, SHELL_H = 1920, 1088
VOXRT7_ARGV = ["--scene", "torus", "--res", "256", "--width", "640", "--height",
               "360", "--mode", "color", "--oracle"]
# pt_phase_attrib's means at its defaults, as every run since the script's
# port has printed them (bit-equal through either route of the chain)
ATTRIB_MEANS = {"b0": "21.283392", "b8": "37.108360"}
CHAIN_STAGES = ("lane_init", "primary_shade", "bounce_sample", "bounce_shade",
                "compact_gather")
# the reference's jitted pt_sample lines each chain kernel takes over (XLA
# fused them; no pallas_call)
CHAIN_REPLACES = {
    "pt_lane_init": "models/pathtracer.py:113-193 (sampling.py:83, hashing.py, bits.py, "
                    "rng.py:23-62)",
    "pt_primary_shade": "models/pathtracer.py:196-203 (hdri.py:189)",
    "pt_bounce_sample": "models/pathtracer.py:267-299 (hdri.py:239-334, sampling.py:83-126)",
    "pt_bounce_shade": "models/pathtracer.py:308-347, 232-236",
    "pt_compact_gather": "models/pathtracer.py:232-265",
}
# the reference's jitted lines each scene-build kernel takes over (XLA
# fused them; no pallas_call)
VOX_REPLACES = {
    "vox_count": "ops/voxelize.py:266-349 (voxelize_dense's valid mask, count_voxels); "
                 "models/scene.py:160-161",
    "vox_emit": "ops/voxelize.py:266-343 (voxelize_dense); models/scene.py:36-49 "
                "(_chunk_emit)",
    "vox_run_heads": "ops/voxelize.py:366-374, 416-424, 475-483 (the boundary flags, their "
                     "cumsum and n_unique)",
    "vox_unique_reduce": "ops/voxelize.py:351-506 (sort_and_unique_sums :352, "
                         "merge_unique_sums :407, sort_and_unique :456)",
}
# the reference's jitted lines each frame and walk kernel takes over (XLA
# fused them; no pallas_call)
FRAME_REPLACES = {
    "frame_raygen": "models/raycast.py:159-185 (_gen_rays_band)",
    "frame_shade": "models/raycast.py:30-41 (_shade_flat), 188-216 (_shade_untile_band)",
    "brick_walk": "ops/bricktree.py:240-437 (the walk's while_loop and set-up)",
    "octree_walk": "ops/traverse2.py:54-273 (the v2 walk's while_loop and set-up)",
}
FRAME_SOURCES = {"frame_raygen": "frame.cu", "frame_shade": "frame.cu",
                 "brick_walk": "walks.cu", "octree_walk": "walks.cu"}
BAND = (1000, 700, 256, 2)  # width, height, py0, tile rows: a band past row 0
VOXPT_EC_PACKET = 65536     # EngineConfig.ray_packet, voxpt's default before 2^21
BUILD_CHUNK = 262144       # phase 3's chunk_tris: the plain stages' unit
COPY_REPS = 4
ROW_BYTES = 164 * 4
HOT_ROWS = 4096            # the row chase's L2-resident table (2.7 MB)
LATENCY_HOPS = 256
RATE_HOPS = 32
PROBE_ITERS = 32


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 3, warm: bool = True):
    """(result, ms per call): scripts/common.timed, 3 calls by default."""
    from massivevoxelraytracing_torch.scripts import common

    return common.timed(fn, reps, warm)


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): scripts/common.bound."""
    from massivevoxelraytracing_torch.scripts import common

    return common.bound(n_bytes, n_ops)


def compare(kern, plain, what: str) -> dict:
    """Kernel vs plain outputs: discrete exact, t within rtol 3e-7."""
    tk, nk, vk = (x.cpu().numpy() for x in kern)
    tp, np_, vp = (x.cpu().numpy() for x in plain[:3])
    hk, hp = tk < 1e37, tp < 1e37
    if not np.array_equal(hk, hp):
        raise AssertionError(f"{what}: {int((hk != hp).sum())} hit-mask mismatches")
    if not np.array_equal(nk, np_):
        raise AssertionError(f"{what}: {int((nk != np_).sum())} nmajor mismatches")
    if not np.array_equal(vk, vp):
        raise AssertionError(f"{what}: {int((vk != vp).sum())} vrank mismatches")
    if not np.all(np.isfinite(tk)):
        raise AssertionError(f"{what}: non-finite t")
    err = np.abs(tk[hk] - tp[hk]) if hk.any() else np.zeros(1, np.float32)
    ulp = np.abs(tk[hk].view(np.int32).astype(np.int64)
                 - tp[hk].view(np.int32).astype(np.int64)) if hk.any() else err
    np.testing.assert_allclose(tk[hk], tp[hk], rtol=3e-7, atol=0, err_msg=what)
    return dict(max_abs_err=float(err.max()), max_ulp=int(ulp.max()),
                hits=int(hk.sum()), n=int(hk.size))


def assert_bits_equal(a, b, what: str) -> None:
    import torch

    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: output {i} differs")


def random_tree(grid_res: int, n: int, rng, device, snodes_above=None):
    from massivevoxelraytracing_torch.ops import hako, morton

    c = torch_from(rng.integers(0, grid_res, size=(n, 3)), device)
    codes = morton.encode(c[:, 0], c[:, 1], c[:, 2]).unique()
    old = hako.USE_SNODES_ABOVE
    if snodes_above is not None:
        hako.USE_SNODES_ABOVE = snodes_above
    try:
        tree = hako.build_hako(codes, grid_res, device=device,
                               dps=1.0 / grid_res)
    finally:
        hako.USE_SNODES_ABOVE = old
    return tree, codes


def torch_from(a, device):
    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def mixed_rays(codes, grid_res: int, n: int, rng):
    """Half random rays, half aimed at voxel centers (numpy seed)."""
    from massivevoxelraytracing_torch.ops import morton

    ro = rng.uniform(-1.0, 2.0, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    pick = codes.cpu()[rng.integers(0, codes.shape[0], n // 2)]
    xyz = np.stack([c.numpy() for c in morton.decode(pick)], -1)
    target = (xyz + 0.5) / grid_res
    rd[: n // 2] = (target - ro[: n // 2]
                    + rng.normal(size=(n // 2, 3)) * 2e-4).astype(np.float32)
    return ro, rd


def tree_args(tree, ro, rd, device):
    from massivevoxelraytracing_torch.ops import hako_mega

    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    ro_t = torch_from(ro, device).float().contiguous()
    rd_t = torch_from(rd, device).float().contiguous()
    return (bricks, snodes, tabs, root, tree.lower, tree.upper, ro_t, rd_t), T


def kernel_vs_plain(tree, ro, rd, shadow: bool, what: str, device):
    """Launch the megakernel through its wrapper and the plain version
    directly, on the same device tensors. Returns (stats, kernel ms,
    plain ms)."""
    from massivevoxelraytracing_torch.ops import hako_mega

    args, T = tree_args(tree, ro, rd, device)
    kern, k_ms = timed(lambda: hako_mega.intersect_rays_hako_mega(
        *args, T=T, shadow=shadow))
    plain, p_ms = timed(lambda: hako_mega.intersect_rays_hako_mega_plain(
        *args, T=T, shadow=shadow), reps=1, warm=False)
    if int(plain[3].item()) != 0:
        raise AssertionError(f"{what}: plain version left lanes unresolved")
    counted = hako_mega.intersect_rays_hako_mega_counted(*args, T=T, shadow=shadow)
    assert_bits_equal(counted[:3], kern, f"{what}: counting variant vs kernel")
    return compare(kern, plain, what), k_ms, p_ms


def rounds_vs_plain(tree, ro, rd, shadow: bool, what: str, device) -> int:
    """The round driver through its kernel (intersect_rays_hako: one
    hako_rounds launch), against its plain version, the two-launch driver
    (hako_probe, hako_dda_merge a round) and the megakernel, bit for bit,
    with the same rounds and no lane unresolved; then round by round
    through Checked (every kernel of the two-launch and unfused drivers
    against its plain version). Returns the rounds it took."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega

    args, T = tree_args(tree, ro, rd, device)
    hk.reset_counters()
    got = hk.intersect_rays_hako(*args, T=T, shadow=shadow)
    launches, rounds = dict(hk.LAUNCHES), hk.rounds_run()
    unresolved = hk.unresolved_lanes()
    want = hk.intersect_rays_hako_plain(*args, T=T, shadow=shadow)
    two = two_launch(args, T, shadow)
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    torch_sync()
    assert_bits_equal(got, want[:3], f"{what}: hako_rounds vs plain")
    assert_bits_equal(got, two[:3], f"{what}: hako_rounds vs the two-launch driver")
    assert_bits_equal(got, mega, f"{what}: hako_rounds vs megakernel")
    if unresolved or int(want[3].item()) or int(two[3].item()):
        raise AssertionError(f"{what}: rounds left lanes unresolved")
    if not rounds == want[4] == two[4]:
        raise AssertionError(f"{what}: {rounds} rounds against the plain driver's {want[4]} "
                             f"and the two-launch driver's {two[4]}")
    check_route_launches(launches, 1, what)
    checked_rounds(tree, args[6], args[7], shadow, what)
    _, syncs = host_syncs(lambda: hk.intersect_rays_hako(*args, T=T, shadow=shadow))
    _, two_syncs = host_syncs(lambda: two_launch(args, T, shadow))
    turns = in_turns({"hako_rounds": lambda: hk.hako_rounds(*args, T=T, shadow=shadow),
                      "two_launch": lambda: two_launch(args, T, shadow)})
    print(f"[phase2b] {what}: a call in turns (CUDA events, ms): hako_rounds "
          f"{turns['hako_rounds']}, two-launch {turns['two_launch']}; launches 1 / "
          f"{2 * rounds}, host syncs {syncs} / {two_syncs}, {rounds} rounds", flush=True)
    return rounds


def two_launch(args, T: int, shadow: bool):
    """The two-launch driver (drive with hako_probe and hako_dda_merge, a
    host nonzero a round) on tree_args' args: (t, nmaj, vrank, unresolved,
    rounds)."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    return hk.drive((hk.hako_probe, hk.hako_dda_merge), *args, T=T, shadow=shadow,
                    max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
                    max_rounds=hk.default_max_rounds(args[1], T, hk.PROBES, hk.DDA_ITERS))


def check_route_launches(launches: dict, calls: int, what: str) -> None:
    """The route's counts: one hako_rounds launch a call, and none of the
    two-launch or unfused drivers' kernels."""
    if launches["hako_rounds"] != calls or any(
            v for k, v in launches.items() if k != "hako_rounds"):
        raise AssertionError(f"{what}: not one hako_rounds launch a call and nothing "
                             f"else: {launches} over {calls} calls")


def check_two_launches(launches: dict, rounds: int, what: str) -> None:
    """The two-launch driver's counts: hako_probe and hako_dda_merge once a
    round, and nothing else."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    if not rounds or any(launches[k] != rounds for k in hk.TWO_LAUNCH) or any(
            v for k, v in launches.items() if k not in hk.TWO_LAUNCH):
        raise AssertionError(f"{what}: not one hako_probe and one hako_dda_merge launch "
                             f"a round: {launches} over {rounds} rounds")


@contextlib.contextmanager
def route_driver(probe, stage):
    """intersect_rays_hako (which render_frame, the path tracer and
    bigscene look up when they run) replaced by the host loop of rounds,
    drive, with (probe, stage): the two-launch driver with the wrappers
    (hako_probe, hako_dda_merge), or with a checked row stage. The rounds
    and unresolved lanes go to the same accumulators."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    real = hk.intersect_rays_hako

    def driven(bricks, snodes, tabs, root_mask, lower, upper, ro, rd, *, T, shadow=False,
               max_probes=hk.PROBES, max_dda=hk.DDA_ITERS, max_rounds=None):
        if max_rounds is None:
            max_rounds = hk.default_max_rounds(snodes, T, max_probes, max_dda)
        t, nmaj, vrank, unresolved, rounds = hk.drive(
            (probe, stage), bricks, snodes, tabs, root_mask, lower, upper, ro, rd, T=T,
            shadow=shadow, max_probes=max_probes, max_dda=max_dda, max_rounds=max_rounds)
        acc = hk._acc(ro.device)
        acc[0] += rounds
        acc[1] += unresolved[0]
        return t, nmaj, vrank

    hk.intersect_rays_hako = driven
    try:
        yield
    finally:
        hk.intersect_rays_hako = real


def two_launch_route():
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    return route_driver(hk.hako_probe, hk.hako_dda_merge)


def host_syncs(fn) -> tuple:
    """(fn()'s result, the host syncs torch reports in it: the warnings of
    torch.cuda.set_sync_debug_mode("warn"), less the one that calls the
    mode a prototype)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                    for w in seen)


def in_turns(fns: dict, reps: int = 2) -> dict:
    """Each fn timed with CUDA events (timed, `reps` calls after a warm
    one), in turns: a, b, b, a. Returns {name: [ms, ms]}."""
    names = list(fns)
    order = names + names[::-1]
    out = {k: [] for k in names}
    for k in order:
        out[k].append(timed(fns[k], reps=reps)[1])
    return out


def unfused():
    """The route's stage before it was one launch: kernel B and the merge
    apart, the supernode hand-off's tensor ops between them."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    return hk.unfused_stage(hk.hako_dda, hk.hako_merge)


class CheckedStage:
    """The row stage's kernel through its wrapper, held against its plain
    version on the same inputs at every call (the state bit for bit), the
    driver going on with the kernel's state."""

    def __init__(self):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        self.kernel = hk.hako_dda_merge
        self.calls = 0

    def __call__(self, state, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        want = tuple(x.clone() for x in state)
        self.kernel(state, *a, **k)
        hk.hako_dda_merge_plain(want, *a, **k)
        assert_bits_equal(state, want, f"hako_dda_merge call {self.calls}")
        self.calls += 1


def torch_sync():
    import torch

    torch.cuda.synchronize()


def phase_kernel_cases(device, smi: str, rng) -> float:
    """Phases 2 and 2b. Returns the largest |t_kernel - t_plain|."""
    worst = 0.0
    for grid_res, n_vox in ((64, 1536), (256, 6144), (512, 8000)):
        fat_above = 128 if grid_res == 512 else None
        tree, codes = random_tree(grid_res, n_vox, rng, device, fat_above)
        layout = f"fat T={tree.T}" if tree.snodes is not None else f"plain T={tree.T}"
        ro, rd = mixed_rays(codes, grid_res, 4096, rng)
        for shadow in (False, True):
            what = f"{grid_res}^3 {layout} {'shadow' if shadow else 'primary'}"
            st, k_ms, p_ms = kernel_vs_plain(tree, ro, rd, shadow, what, device)
            worst = max(worst, st["max_abs_err"])
            print(f"[phase2] {what}: equal on {st['n']} rays ({st['hits']} hits), "
                  f"max |dt| {st['max_abs_err']:.3g}, max ulp {st['max_ulp']}; "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms [{smi}]",
                  flush=True)
            rounds = rounds_vs_plain(tree, ro, rd, shadow, what, device)
            print(f"[phase2b] {what}: round driver == plain version == "
                  f"megakernel bit for bit, {rounds} rounds", flush=True)
    return worst


def bench_camera():
    """bench.py's camera for the lattice (origin 0, extent 1):
    scripts/common.script_camera."""
    from massivevoxelraytracing_torch.scripts import common

    return common.script_camera(np.zeros(3, np.float32), 1.0)


def phase_main_path(device, smi: str, rng):
    """Phase 3: build the lattice, render frames, then hold the kernel
    against the plain version on rays sampled across the frame."""
    import torch

    from massivevoxelraytracing_torch.models import accel, raycast, scene
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.scripts import common
    from massivevoxelraytracing_torch.utils import meshgen

    grid_res, width, height, frames = GRID, WIDTH, HEIGHT, TIMED_FRAMES
    tri, cols = meshgen.sphere_lattice(6, 4)
    cam = bench_camera()

    t0 = time.time()
    tree, vox_launches = vox_counted(lambda: scene.build_scene(
        tri, cols, origin=np.zeros(3, np.float32), dps=1.0 / grid_res,
        grid_res=grid_res, accel="hako", chunk_tris=BUILD_CHUNK, device=device,
    ), "phase 3's build_scene")
    build_s = time.time() - t0
    img, depth = raycast.render_frame(tree, cam, width, height, device=device)
    _, frame_ms = timed(lambda: raycast.render_frame(
        tree, cam, width, height, device=device), reps=frames)
    hako_mega.reset_counters()
    raycast.reset_counters()
    img, depth = raycast.render_frame(tree, cam, width, height, device=device)
    torch.cuda.synchronize(device)
    launches = hako_mega.LAUNCHES
    frame_launches = dict(raycast.LAUNCHES)
    unresolved = hako_mega.unresolved_lanes()

    st = tree.build_stats
    n_vox = tree.n_voxels
    d_vox = n_vox - JAX_N_VOXELS
    hit = depth < 1e37
    hit_frac = float(hit.float().mean())
    mrays = width * height / (frame_ms * 1e-3) / 1e6
    print(f"[phase3] lattice {grid_res}^3: {st['n_triangles']} triangles -> "
          f"{st['n_dumped']} dumped -> {n_vox} voxels (JAX build "
          f"{JAX_N_VOXELS}, diff {d_vox:+d} = {d_vox / JAX_N_VOXELS:+.4%}), "
          f"{tree.n_nodes} nodes (JAX build 90128), T={tree.T}, "
          f"fat={tree.snodes is not None}", flush=True)
    print(f"[phase3] build {build_s:.3f} s: split {st['t_split_s']*1e3:.1f} ms, "
          f"count {st['t_count_s']*1e3:.1f} ms, unique {st['t_unique_s']*1e3:.1f} ms, "
          f"accel {st['t_accel_s']*1e3:.1f} ms (first build in this process); the "
          f"build's kernels launched {vox_launches} [{smi}]", flush=True)
    print(f"[phase3] frame {width}x{height}: {frame_ms:.3f} ms = {mrays:.2f} Mrays/s "
          f"(mean of {frames}), hit fraction {hit_frac:.4f}, kernel launches "
          f"{launches}, frame kernels {frame_launches}, unresolved lanes {unresolved} "
          f"[{smi}]", flush=True)
    if min(frame_launches.values()) < 1:
        raise AssertionError(f"the main path's frame launched no frame kernel: "
                             f"{frame_launches}")

    if tuple(img.shape) != (height, width, 3) or tuple(depth.shape) != (height, width):
        raise AssertionError(f"frame shapes {tuple(img.shape)} {tuple(depth.shape)}")
    if not bool(torch.isfinite(depth[hit]).all()) or bool((depth[hit] <= 0).any()):
        raise AssertionError("hit depths must be finite and positive")
    if launches < 1:
        raise AssertionError("the main path launched no hako_mega kernel")
    if unresolved != 0:
        raise AssertionError(f"{unresolved} lanes unresolved at max_rounds")
    if abs(d_vox) > TIE_BAND * JAX_N_VOXELS:
        raise AssertionError(f"n_voxels {n_vox} outside the tie band")
    if not HIT_BAND[0] <= hit_frac <= HIT_BAND[1]:
        raise AssertionError(f"hit fraction {hit_frac} outside {HIT_BAND}")

    # kernel vs plain on rays sampled across the frame
    ro, rd = camera_rays(cam, width, height, device)
    kind, T, meta, root = accel.accel_args(tree)
    _, frame_kernel_ms = timed(lambda: accel.intersect_with(
        kind, T, meta, root, tree.lower, tree.upper, ro, rd), reps=frames)
    idx = np.sort(rng.choice(ro.shape[0], size=SAMPLE_RAYS, replace=False))
    sample = (ro[idx].cpu().numpy(), rd[idx].cpu().numpy())
    st2, k_ms, p_ms = kernel_vs_plain(
        tree, *sample, False, f"{grid_res}^3 lattice frame sample", device)
    print(f"[phase3] kernel vs plain on {st2['n']} frame rays ({st2['hits']} hits): "
          f"equal, max |dt| {st2['max_abs_err']:.3g}, max ulp {st2['max_ulp']}; "
          f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms; kernel alone on the full "
          f"frame {frame_kernel_ms:.3f} ms [{smi}]", flush=True)

    # the frame's bound, from the rows its traversal reads, and the kernel's
    # counters on every frame ray
    args = (*meta, tree.lower, tree.upper, ro, rd)
    ref = hako_mega.intersect_rays_hako_mega(*args, T=T)
    fb = common.frame_bound(tree, ro, rd)
    print(f"[phase3] frame bound: {fb['rays']} rays, {fb['distinct_rows']} distinct rows, "
          f"{fb['row_visits']} row visits: {fb['bytes']} bytes, {fb['ops']} float ops -> "
          f"{fb['bound_ms']:.4f} ms ({fb['bound_by']})", flush=True)
    counters = counter_summary(args, T, False, ref, "1080p frame", smi)
    result = dict(launches=launches, max_abs_err=st2["max_abs_err"],
                  frame_kernel_ms=frame_kernel_ms, frame_ms=frame_ms,
                  frame_bound=(fb["bound_ms"], fb["bound_by"]),
                  frame_rows=(fb["distinct_rows"], fb["row_visits"]),
                  counters=counters, frame_args=args, vox_launches=vox_launches,
                  frame_launches=frame_launches)
    return tree, cam, img, depth, result


# ---------------------------------------------------------------------------
# phase 3 (frame): the frame's kernels (models/raycast.py, csrc/frame.cu)
# ---------------------------------------------------------------------------

def plain_rays(cam_dev, py0: int, width: int, height: int, rows: int):
    """_gen_rays_band on camera tensors already on the card: the plain
    stage frame_raygen replaces."""
    from massivevoxelraytracing_torch.models import raycast

    return raycast._gen_rays_band(*cam_dev, py0, width=width, height=height,
                                  band_tile_rows=rows)


def phase_frame_kernels(tree, cam, img, depth, device, smi: str) -> dict:
    """Phase 3, the frame's kernels: frame_raygen and frame_shade (both
    colourings, un-tiled and flat) against their plain stages on the same
    card tensors, bit for bit, on the 1080p lattice frame and on a band
    past row 0 whose width is not a multiple of 128; each kernel's ms, its
    plain stage's ms and its bytes bound on the frame; then the frame
    through stages="plain" (the route before these kernels) and through
    the kernels, timed and profiled in turns, parent route first, image
    and depth equal to phase 3's."""
    import torch

    from massivevoxelraytracing_torch.models import accel, raycast
    from massivevoxelraytracing_torch.scripts import common, render_ab

    kind, T, meta, root = accel.accel_args(tree)
    table = raycast._color_table(tree)
    camv = raycast.camera_of(cam)
    cam_dev = (*(torch.from_numpy(v).to(device) for v in camv[:4]),
               torch.tensor(camv[4], dtype=torch.float32, device=device))
    err = {"frame_raygen": 0.0, "frame_shade": 0.0}
    out = {}
    for label, (w, h, py0, rows) in (("1080p frame", (WIDTH, HEIGHT, 0, -(-HEIGHT // 128))),
                                     (f"{BAND[0]}x{BAND[1]} band from row {BAND[2]}", BAND)):
        rays = raycast.gen_rays(camv, py0, width=w, height=h, band_tile_rows=rows,
                                device=device)
        want = plain_rays(cam_dev, py0, w, h, rows)
        err["frame_raygen"] = max(err["frame_raygen"], max_float_diff(rays, want))
        assert_bits_equal(rays, want, f"phase 3: frame_raygen on the {label}")
        ro, rd = rays
        t, nmaj, vidx = accel.intersect_with(kind, T, meta, root, tree.lower, tree.upper,
                                             ro, rd)
        rows_out = min(h - py0, rows * 128)
        untile = dict(width=w, band_tile_rows=rows, rows_out=rows_out)
        for show_color in (False, True):
            args = (table, rd, t, nmaj, vidx)
            for got, want in (
                    (raycast.shade(*args, show_color=show_color, **untile),
                     raycast._shade_untile_band(*args, show_color=show_color, **untile)),
                    (raycast.shade(*args, show_color=show_color),
                     raycast._shade_flat(*args, show_color=show_color))):
                err["frame_shade"] = max(err["frame_shade"], max_float_diff(got, want))
                assert_bits_equal(got, want, f"phase 3: frame_shade (colour {show_color}) "
                                             f"on the {label}")
        print(f"[phase3] frame kernels == plain stages bit for bit on the {label} "
              f"({ro.shape[0]} lanes): frame_raygen; frame_shade normals and colours, "
              f"un-tiled and flat [{smi}]", flush=True)
        if py0 == 0:
            live = ro[:, 0] < 1e8  # the lanes of the frame's pixels
            n_pad = ro.shape[0]
            k_ms = {"frame_raygen": timed(lambda: raycast.gen_rays(
                camv, 0, width=w, height=h, band_tile_rows=rows, device=device), 20)[1]}
            p_ms = {"frame_raygen": timed(lambda: plain_rays(cam_dev, 0, w, h, rows), 5)[1]}
            bnd = {"frame_raygen": common.raygen_bound(n_pad)}
            for show_color, name in ((False, "frame_shade"), (True, "frame_shade_colour")):
                args = (table, rd, t, nmaj, vidx)
                k_ms[name] = timed(lambda: raycast.shade(
                    *args, show_color=show_color, **untile), 20)[1]
                p_ms[name] = timed(lambda: raycast._shade_untile_band(
                    *args, show_color=show_color, **untile), 5)[1]
                bnd[name] = common.shade_bound(t, nmaj, vidx, show_color, table, live)
            for name in k_ms:
                print(f"[phase3] {name} on the 1080p frame: {k_ms[name]:.4f} ms vs plain "
                      f"stage on the card {p_ms[name]:.3f} ms; bound {bnd[name][0]:.4f} ms "
                      f"({bnd[name][1]}), share {bnd[name][0] / k_ms[name]:.0%} [{smi}]",
                      flush=True)
            out["timing"] = {name: dict(ms=k_ms[name], plain_ms=p_ms[name],
                                        bound_ms=bnd[name][0], bound_by=bnd[name][1],
                                        share=bnd[name][0] / k_ms[name]) for name in k_ms}
            # with --ab, frame_raygen in turns with the parent commit's
            # kernel (scripts/render_ab.py), both == the plain stage first
            if AB:
                render_ab.build_earlier()  # both parents' libraries, built together
                ab = render_ab.raygen_ab(render_ab.parent("frame_raygen"), camv, w, h,
                                         device, smi)
                print(f"[phase3] frame_raygen in turns with its parent's kernel (CUDA "
                      f"events, {render_ab.REPS} calls a turn): current {fmt_ms(ab['ms'])} "
                      f"ms, parent {fmt_ms(ab['old_ms'])} ms; share current "
                      f"{ab['share']:.1%}, parent {ab['old_share']:.1%} of "
                      f"{ab['bound_ms']:.4f} ms; faster in every turn: {ab['faster']} "
                      f"[{smi}]", flush=True)
                out["timing"]["frame_raygen"]["ab"] = ab

    # the frame through both routes, in turns, the parent's route first
    def frame(stages):
        return raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=device, stages=stages)

    routes = {}
    for label, stages in (("plain", "plain"), ("kernels", None)):
        got = frame(stages)
        if not torch.equal(got[0], img) or not torch.equal(got[1], depth):
            raise AssertionError(f"phase 3: the frame through the {label} route differs")
        ms = timed(lambda: frame(stages), reps=TIMED_FRAMES)[1]
        routes[label] = dict(ms=ms)
        note = "not measured (8 profiles missed a launch the wrappers counted)"
        try:  # a trace that holds every launch of the frame and its traversal
            prof = common.profile_counted(lambda: frame(stages),
                                          common.LiveCounts(raycast.LAUNCHES))
        except AssertionError:
            prof = None
        if prof is not None:
            routes[label].update(kernels=prof["kernels"], busy_ms=prof["busy_ms"],
                                 idle_share=prof["idle_share"], wall_ms=prof["wall_ms"],
                                 mega_ms=prof["mega_ms"], frame=prof["frame"],
                                 profile_tries=prof["tries"])
            note = (f"{prof['kernels']} device kernels, busy {prof['busy_ms']:.3f} ms, "
                    f"hako_mega {prof['mega_ms']:.3f} ms, frame kernels {prof['frame']}, "
                    f"idle {prof['idle_share']:.3f} (every counted launch traced, try "
                    f"{prof['tries']})")
        print(f"[phase3] frame route {label}: {ms:.3f} ms (mean of {TIMED_FRAMES}, CUDA "
              f"events) = {WIDTH * HEIGHT / (ms * 1e-3) / 1e6:.1f} Mrays/s; profiled: {note}; "
              f"image and depth == phase 3's [{smi}]", flush=True)
    kr = routes["kernels"]
    if "frame" in kr:
        raygen_ms = kr["frame"]["frame_raygen"][0]
        tm = out["timing"]["frame_raygen"]
        tm.update(profiled_ms=raygen_ms, profiled_share=tm["bound_ms"] / raygen_ms)
        print(f"[phase3] frame_raygen in the counted profile: {raygen_ms:.4f} ms device time, "
              f"share {tm['profiled_share']:.1%} of {tm['bound_ms']:.4f} ms [{smi}]", flush=True)
    else:
        print(f"[phase3] frame_raygen in the counted profile: not measured [{smi}]", flush=True)
    out.update(err=err, routes=routes)
    return out


def fmt_ms(values) -> str:
    return " / ".join(f"{v:.4f}" for v in values)


# ---------------------------------------------------------------------------
# phase 3c: the scene build's kernels (ops/voxelize.py, csrc/vox_build.cu)
# ---------------------------------------------------------------------------

def vox_counted(fn, what: str, need: bool = True):
    """fn() with the scene build's, the frame's and the walks' kernel counts
    set to 0 just before it and read just after: (result, {kernel:
    launches}); with `need`, each scene-build kernel must have launched."""
    import torch

    from massivevoxelraytracing_torch.models import raycast
    from massivevoxelraytracing_torch.ops import traverse
    from massivevoxelraytracing_torch.ops import voxelize as vox

    torch.cuda.synchronize()
    for mod in (vox, raycast, traverse):
        mod.reset_counters()
    out = fn()
    torch.cuda.synchronize()
    got = dict(vox.LAUNCHES)
    if need and min(got.values()) < 1:
        raise AssertionError(f"{what}: a scene-build kernel was not launched: {got}")
    got.update(raycast.LAUNCHES, **traverse.LAUNCHES)
    return out, got


def max_int_diff(a, b) -> int:
    """The largest |a - b| of two integer tensors of one shape (measured
    before they are held equal)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def held_equal(got, want, what: str) -> int:
    """Every tensor of `got` == `want`'s bit for bit; returns the largest
    difference found before the check."""
    import torch

    err = 0
    for i, (x, y) in enumerate(zip(got, want)):
        err = max(err, max_int_diff(x, y))
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: output {i} differs")
    return err


def copy_timing(arrays, device) -> dict:
    """The split triangle arrays to the card, COPY_REPS times each way in
    turns, host clock to a sync: from pageable memory, and pinned first as
    scene.upload does (the pin, a host copy into the caching host
    allocator's blocks, timed with it; the copy from pinned memory alone
    beside it). Phase 3's build has already pinned blocks of these sizes
    once: every rep here is a rebuild's."""
    import torch

    n_bytes = sum(a.nbytes for a in arrays)
    pageable, pinned, pinned_copy = [], [], []
    for _ in range(COPY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = [torch.from_numpy(a).to(device) for a in arrays]
        torch.cuda.synchronize()
        pageable.append(time.perf_counter() - t0)
        del got
        t0 = time.perf_counter()
        host = [torch.from_numpy(a).pin_memory() for a in arrays]
        t1 = time.perf_counter()
        got = [h.to(device, non_blocking=True) for h in host]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pinned.append(t2 - t0)
        pinned_copy.append(t2 - t1)
        del got, host
    return dict(bytes=n_bytes, pageable_ms=[x * 1e3 for x in pageable],
                pinned_ms=[x * 1e3 for x in pinned],
                pinned_copy_ms=[x * 1e3 for x in pinned_copy],
                pageable_gbs=n_bytes / min(pageable) / 1e9,
                pinned_gbs=n_bytes / min(pinned) / 1e9,
                pinned_copy_gbs=n_bytes / min(pinned_copy) / 1e9)


def vox_stage_timing(arrays, origin, dps, device, smi: str) -> dict:
    """Each scene-build kernel against its plain stage on the lattice's one
    group (the inputs phase 3's build gives them), on the same card
    tensors: equal bit for bit (count; the dump buffers, emitted into
    buffers prefilled with a sentinel; the unique stream in its three
    modes, the merge on two groups' sums), then the kernel's ms (CUDA
    events, common.timed), the plain stage's ms (BUILD_CHUNK triangles at a
    time, as the plain route runs it), the bound on the call's data and,
    for the reduce, index_add_ of the sorted entries' seven int64 columns
    (the segment sums alone) as the library call; the reduce alone
    (reduce_tiles) beside the unique stage after the sort (unique_reduce)
    and the sort alone."""
    import torch

    from massivevoxelraytracing_torch.ops import voxelize as vox
    from massivevoxelraytracing_torch.scripts import common

    t, c, e = (torch.from_numpy(a).to(device) for a in arrays)
    kw = dict(grid_res=GRID, six_separating=True, cap=4)
    T = t.shape[0]
    runs = [(a, min(a + BUILD_CHUNK, T)) for a in range(0, T, BUILD_CHUNK)]
    n_cells = common.vox_cells(t, origin, dps, GRID, 4)
    tested = common.vox_tested_cells(t, origin, dps, GRID, 4)
    out = {}

    def record(name, kern, plain, bnd, err, library_ms=None, **extra):
        _, ms = timed(kern, reps=5)
        _, plain_ms = timed(plain, reps=1)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                         share=bnd[0] / ms, max_abs_err=err, library_ms=library_ms, **extra)
        lib = "" if library_ms is None else f", library call {library_ms:.4f} ms"
        print(f"[phase3c] {name} == its plain stage bit for bit: {ms:.4f} ms vs plain "
              f"{plain_ms:.2f} ms on the card{lib}; bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"share {bnd[0] / ms:.1%}; {extra} [{smi}]", flush=True)

    counts = vox.count(t, origin, dps, **kw)
    plain_counts = lambda: torch.cat([vox.count_plain(t[a:b], origin, dps, **kw)  # noqa: E731
                                      for a, b in runs])
    err = held_equal((counts,), (plain_counts(),), "vox_count")
    record("vox_count", lambda: vox.count(t, origin, dps, **kw), plain_counts,
           common.vox_bound("vox_count", n_tri=T, n_cells=n_cells, walk=tested), err,
           triangles=T, cells=n_cells, tested_cells=tested["cells"], units=tested["units"],
           bbox_bound_ms=common.vox_bound("vox_count", n_tri=T, n_cells=n_cells)[0])
    if tested["valid"] != int(counts.sum()):
        raise AssertionError(f"the enumeration's valid cells {tested['valid']} are not the "
                             f"count's {int(counts.sum())}")

    end = torch.cumsum(counts, 0, dtype=torch.int64)
    start = end - counts
    n = int(end[-1])

    def buffers():
        return (torch.full((n,), -1, dtype=torch.int64, device=device),
                torch.full((n,), 7, dtype=torch.int32, device=device),
                torch.full((n,), 7, dtype=torch.int32, device=device))

    dump, want = buffers(), buffers()

    def plain_emit(bufs):
        for a, b in runs:
            vox.emit_plain(t[a:b], c[a:b], e[a:b], start[a:b], origin, dps, bufs, **kw)
        return bufs

    vox.emit(t, c, e, start, origin, dps, dump, **kw)
    err = held_equal(dump, plain_emit(want), "vox_emit (the dump buffers)")
    if bool((dump[0] < 0).any()):
        raise AssertionError("vox_emit left a dump buffer entry unwritten")
    del want
    record("vox_emit", lambda: vox.emit(t, c, e, start, origin, dps, dump, **kw),
           lambda: plain_emit(dump),
           common.vox_bound("vox_emit", n_tri=T, n_cells=n_cells, n_dumped=n, walk=tested),
           err, dumped=n, cells=n_cells, tested_cells=tested["cells"],
           bbox_bound_ms=common.vox_bound("vox_emit", n_tri=T, n_cells=n_cells,
                                          n_dumped=n)[0])
    del t, c, e

    code, color, emission = dump
    _, sort_ms = timed(lambda: torch.sort(code, stable=True), reps=3)
    s_key, perm = torch.sort(code, stable=True)
    attrs = (color, emission)
    errs = []
    for mode in ("means", "sums"):
        got, n_u = vox.unique_reduce(s_key, perm, attrs, mode=mode)
        plain, n_plain = vox.unique_reduce_plain(s_key, perm, attrs, mode=mode)
        if n_u != n_plain:
            raise AssertionError(f"vox_unique_reduce ({mode}): {n_u} unique, plain {n_plain}")
        errs.append(held_equal(common.flat_tensors(got), common.flat_tensors(plain),
                               f"vox_unique_reduce ({mode})"))
    parts = [vox.sort_and_unique_sums(code[sl], color[sl], emission[sl])[0]
             for sl in (slice(0, n // 3), slice(n // 3, n))]
    m_key, m_perm = torch.sort(torch.cat([p[0] for p in parts]), stable=True)
    m_attrs = (*[torch.cat([p[1][i] for p in parts]) for i in range(6)],
               torch.cat([p[2] for p in parts]))
    got, plain = (f(m_key, m_perm, m_attrs, mode="merge")
                  for f in (vox.unique_reduce, vox.unique_reduce_plain))
    if got[1] != plain[1]:
        raise AssertionError(f"vox_unique_reduce (merge): {got[1]} unique, plain {plain[1]}")
    errs.append(held_equal(got[0], plain[0], "vox_unique_reduce (merge)"))
    del parts, m_key, m_perm, m_attrs, got, plain
    heads = vox.run_heads(s_key)
    err = held_equal((heads,), (vox.run_heads_plain(s_key),), "vox_run_heads")
    record("vox_run_heads", lambda: vox.run_heads(s_key), lambda: vox.run_heads_plain(s_key),
           common.vox_bound("vox_run_heads", n_sorted=n), err,
           sorted=n, tiles=len(heads))
    ends = torch.cumsum(heads, 0)
    # the stage after the sort (the run heads, their cumsum, n_unique's
    # readback, the reduce) beside the reduce alone
    _, stage_ms = timed(lambda: vox.unique_reduce(s_key, perm, attrs, mode="means"), reps=5)
    seg = vox._segments(s_key)[1]
    cols7 = torch.stack([*vox.unpack_rgb8(color[perm]), *vox.unpack_rgb8(emission[perm]),
                         torch.ones_like(perm)], 1)
    _, library_ms = timed(lambda: torch.zeros((n_u + 1, 7), dtype=torch.int64,
                                              device=device).index_add_(0, seg, cols7), reps=5)
    del cols7, seg
    bnd = common.vox_bound("vox_unique_reduce", n_sorted=n, n_unique=n_u, mode="means")
    record("vox_unique_reduce",
           lambda: vox.reduce_tiles(s_key, perm, attrs, ends, n_u, mode="means"),
           lambda: vox.unique_reduce_plain(s_key, perm, attrs, mode="means"),
           bnd, max(errs), library_ms=library_ms, sorted=n, unique=n_u, sort_ms=sort_ms,
           stage_ms=stage_ms, stage_share=bnd[0] / stage_ms,
           segments_bound_ms=common.vox_bound("vox_unique_reduce", n_sorted=n,
                                              n_unique=n_u, mode="means",
                                              segments=True)[0],
           modes_equal=list(vox.MODES))
    print(f"[phase3c] the unique stage after the sort: {stage_ms:.4f} ms (the run heads, "
          f"their cumsum, n_unique read back, the reduce) against the stage bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / stage_ms:.1%}; the sort alone "
          f"{sort_ms:.4f} ms [{smi}]", flush=True)
    return out


def route_builds(args, kwargs, want, what: str, smi: str) -> dict:
    """One build through the plain stages and one through the kernels, in
    that order (host clock to the build's end, its split and peak memory),
    every tree == `want` field for field; then each profiled, the kernels'
    route first (device kernels, busy ms, idle share, the build kernels'
    ms and calls beside the launches their wrappers counted)."""
    import torch

    from massivevoxelraytracing_torch.entry import trees_equal
    from massivevoxelraytracing_torch.models import scene
    from massivevoxelraytracing_torch.scripts import common

    def build(stages):
        return scene.build_scene(*args, **dict(kwargs, stages=stages))

    out = {}
    for route, stages in (("plain", "plain"), ("kernels", None)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = build(stages)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        if not trees_equal(tree, want):
            raise AssertionError(f"{what}: the {route} route's tree differs")
        out[route] = dict(wall_s=wall, split_s=tree.build_stats["t_split_s"],
                          count_s=tree.build_stats["t_count_s"],
                          unique_s=tree.build_stats["t_unique_s"],
                          accel_s=tree.build_stats["t_accel_s"], peak_gib=peak)
        del tree
    # profiled, the kernel route first (its tree held again); a profile
    # that misses a launch the wrappers counted is taken again, once, and
    # what it still misses is recorded beside the device kernels it saw
    for route, stages in (("kernels", None), ("plain", "plain")):
        for tries in (1, 2):
            kept = []
            prof, launched = vox_counted(lambda: common.profile_call(
                lambda: kept.append(build(stages))), what, need=False)
            launched = {k: launched[k] for k in prof["vox"]}
            tree = kept.pop()
            if not trees_equal(tree, want):
                raise AssertionError(f"{what}: the {route} route's profiled tree differs")
            n_unique = tree.build_stats["n_unique"]
            del tree
            seen = {k: calls for k, (_, calls) in prof["vox"].items()}
            if seen == launched:
                break
        out[route].update(device_kernels=prof["kernels"], busy_ms=prof["busy_ms"],
                          profiled_wall_ms=prof["wall_ms"], idle_share=prof["idle_share"],
                          vox_ms=prof["vox"], top=prof["top"][:4], profile_tries=tries,
                          launches=launched, n_unique=n_unique,
                          profile_missed={k: launched[k] - seen[k] for k in launched})
    for route in ("plain", "kernels"):
        r = out[route]
        print(f"[{what}] {route} route: {r['wall_s']:.3f} s (split {r['split_s']:.3f}, count "
              f"{r['count_s']:.3f}, unique {r['unique_s']:.3f}, accel {r['accel_s']:.3f}), "
              f"peak {r['peak_gib']:.2f} GiB; profiled ({r['profile_tries']} tries, "
              f"launches the trace missed {r['profile_missed']}): "
              f"{r['device_kernels']} device kernels, busy {r['busy_ms']:.1f} of "
              f"{r['profiled_wall_ms']:.1f} ms (idle {r['idle_share']:.3f}), the build "
              f"kernels (ms, calls) "
              f"{ {k: (round(v[0], 3), v[1]) for k, v in r['vox_ms'].items()} }; tree == "
              f"the kernel route's [{smi}]", flush=True)
    if out["kernels"]["device_kernels"] >= out["plain"]["device_kernels"]:
        raise AssertionError(f"{what}: the kernel route launched no fewer device kernels "
                             f"than the plain route")
    return out


def route_kernel_bounds(args, kwargs, routes: dict, what: str, smi: str) -> dict:
    """Each build kernel's launches in the kernel route's profiled build
    (route_builds: its wrapper's count), its ms there, and its bound on that
    build's calls (common.vox_bound with the kernels' walk; the bbox cells'
    count beside it, the yardstick of the designs with a bbox cell loop):
    the count on all triangles, the emit on each group's, the unique
    reduce on each group's dump (the means, or the sums and the merge).
    The sizes come from the build's triangles split again as build_scene
    splits them, counted, grouped (scene.chunk_offsets, dump_groups), each
    group emitted and sorted; these launches are outside any counted run."""
    import inspect

    import numpy as np
    import torch

    from massivevoxelraytracing_torch.models import scene
    from massivevoxelraytracing_torch.ops import voxelize as vox
    from massivevoxelraytracing_torch.ops.octree import bucket
    from massivevoxelraytracing_torch.scripts import common
    from massivevoxelraytracing_torch.utils import meshprep

    a = inspect.signature(scene.build_scene).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    r = routes["kernels"]
    launched, prof = r["launches"], r["vox_ms"]
    tri = np.asarray(a["tri_verts"], np.float32).reshape(-1, 3, 3)
    split = meshprep.split_to_cap(tri, np.ones_like(tri), np.zeros_like(tri), a["origin"],
                                  a["dps"], a["grid_res"], a["cap"])
    del tri
    dev = torch.device(a["device"])
    t, c, e = (torch.from_numpy(x).to(dev) for x in split)
    del split
    T = len(t)
    origin = torch.as_tensor(np.asarray(a["origin"], np.float32), device=dev)
    dps = torch.tensor(a["dps"], dtype=torch.float32, device=dev)
    kw = dict(grid_res=a["grid_res"], six_separating=a["six_separating"], cap=a["cap"])
    counts = vox.count(t, origin, dps, **kw)
    end = torch.cumsum(counts, 0, dtype=torch.int64)
    start = end - counts
    del counts
    chunk = min(a["chunk_tris"], bucket(T, floor=1024))
    offsets = scene.chunk_offsets(end, chunk)
    groups = scene.dump_groups(offsets)
    out = {k: dict(calls=launched[k], bound_ms=0.0, bbox_bound_ms=0.0, bound_by=set())
           for k in vox.KERNELS}

    def add(name, walk=None, **sizes):
        rec = out[name]
        bnd = common.vox_bound(name, walk=walk, **sizes)
        rec["bound_ms"] += bnd[0]
        rec["bound_by"].add(bnd[1])
        # the earlier designs' yardsticks: the bbox cells (count, emit), the
        # boundary flags and segment ids (the unique reduce)
        rec["bbox_bound_ms"] += common.vox_bound(
            name, segments=name == "vox_unique_reduce", **sizes)[0]

    total = dict(units=0, cells=0, valid=0)
    n_cells = 0
    uniques = []
    for ka, kb in groups:
        ga, gb = ka * chunk, min(kb * chunk, T)
        off0 = int(offsets[ka])
        n = int(offsets[kb]) - off0
        bufs = (torch.empty(n, dtype=torch.int64, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
        vox.emit(t[ga:gb], c[ga:gb], e[ga:gb], start[ga:gb] - off0, origin, dps, bufs, **kw)
        uniques.append(vox._segments(torch.sort(bufs[0], stable=True)[0])[2])
        del bufs
        cells = common.vox_cells(t[ga:gb], origin, dps, a["grid_res"], a["cap"])
        walk = common.vox_tested_cells(t[ga:gb], origin, dps, a["grid_res"], a["cap"],
                                       a["six_separating"])
        if walk["valid"] != n:
            raise AssertionError(f"{what}: the enumeration's valid cells {walk['valid']} "
                                 f"are not the group's dumped {n}")
        n_cells += cells
        total = {k: total[k] + walk[k] for k in total}
        add("vox_emit", walk, n_tri=gb - ga, n_cells=cells, n_dumped=n)
        mode = "means" if len(groups) == 1 else "sums"
        add("vox_run_heads", n_sorted=n)
        add("vox_unique_reduce", n_sorted=n, n_unique=uniques[-1], mode=mode)
    if len(groups) > 1:
        add("vox_run_heads", n_sorted=sum(uniques))
        add("vox_unique_reduce", n_sorted=sum(uniques), n_unique=r["n_unique"], mode="merge")
    add("vox_count", total, n_tri=T, n_cells=n_cells)
    del t, c, e, end, start
    want = dict(vox_count=1, vox_emit=len(groups),
                vox_run_heads=len(groups) + (len(groups) > 1),
                vox_unique_reduce=len(groups) + (len(groups) > 1))
    if {k: launched[k] for k in want} != want:
        raise AssertionError(f"{what}: the kernel route launched {launched}, its groups "
                             f"need {want}")
    out["vox_count"].update(triangles=T, cells=n_cells, tested_cells=total["cells"],
                            units=total["units"])
    for name, rec in out.items():
        ms, profiled_calls = prof[name]
        rec.update(ms=ms, profiled_calls=profiled_calls, share=rec["bound_ms"] / ms,
                   bound_by="/".join(sorted(rec["bound_by"])))
        cells = (f"; {rec['triangles']} triangles, bbox cells {rec['cells']}, slab-clipped "
                 f"cells tested {rec['tested_cells']} in {rec['units']} units"
                 if name == "vox_count" else "")
        yard = {"vox_run_heads": None, "vox_unique_reduce": "with the earlier design's "
                "boundary flags and segment ids"}.get(name, "on the bbox cells")
        bbox = ("" if yard is None else f" ({yard} {rec['bbox_bound_ms']:.4f} ms, "
                f"{rec['bbox_bound_ms'] / ms:.1%})")
        print(f"[{what}] kernel route {name}: {rec['calls']} launches a build, {ms:.3f} ms "
              f"in the profiled build ({profiled_calls} calls); bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_by']}), share {rec['share']:.1%}{bbox}{cells} [{smi}]",
              flush=True)
    heads, red = out["vox_run_heads"], out["vox_unique_reduce"]
    print(f"[{what}] kernel route unique stage: the run heads and the reduce "
          f"{heads['ms'] + red['ms']:.3f} ms in {heads['calls'] + red['calls']} launches against "
          f"the stage bound {red['bound_ms']:.4f} ms, share "
          f"{red['bound_ms'] / (heads['ms'] + red['ms']):.1%} [{smi}]", flush=True)
    return out


def phase_build_stages(tree, device, smi: str) -> dict:
    """Phase 3c: the lattice's split arrays to the card from pageable and
    from pinned memory; each scene-build kernel against its plain stage
    (vox_stage_timing); the lattice built through the plain stages and the
    kernels (route_builds), each tree == phase 3's."""
    import torch

    from massivevoxelraytracing_torch.utils import meshgen, meshprep

    tri, cols = meshgen.sphere_lattice(6, 4)
    origin = np.zeros(3, np.float32)
    arrays = [np.ascontiguousarray(a) for a in meshprep.split_to_cap(
        tri, cols, np.zeros_like(tri), origin, 1.0 / GRID, GRID, 4)]
    cp = copy_timing(arrays, device)
    print(f"[phase3c] the split triangles to the card ({cp['bytes'] / 1e9:.3f} GB): pageable "
          f"{', '.join(f'{x:.1f}' for x in cp['pageable_ms'])} ms ({cp['pageable_gbs']:.2f} "
          f"GB/s at best); pinned first {', '.join(f'{x:.1f}' for x in cp['pinned_ms'])} ms "
          f"({cp['pinned_gbs']:.2f} GB/s), of it the copy "
          f"{', '.join(f'{x:.1f}' for x in cp['pinned_copy_ms'])} ms "
          f"({cp['pinned_copy_gbs']:.2f} GB/s) [{smi}]", flush=True)
    stages = vox_stage_timing(arrays, torch.from_numpy(origin).to(device),
                              torch.tensor(1.0 / GRID, dtype=torch.float32, device=device),
                              device, smi)
    del arrays
    torch.cuda.empty_cache()
    routes = route_builds((tri, cols), dict(origin=origin, dps=1.0 / GRID, grid_res=GRID,
                                            accel="hako", chunk_tris=BUILD_CHUNK,
                                            device=device), tree, "phase3c", smi)
    return dict(copy=cp, stages=stages, routes=routes)


def phase_rounds_frame(tree, cam, img_mega, depth_mega, frame_args, frame_bound, device,
                       smi: str):
    """Phase 3b: the same 1080p frame through the round driver: once
    through the two-launch driver with hako_dda_merge held against its
    plain version at every round; then through hako_rounds (one launch a
    frame) and the two-launch driver, each counted (launches, rounds,
    host syncs) and timed in turns, and traced in a child process
    (scripts/rounds_trace); every image and depth equal to the
    megakernel's. Then hako_rounds alone on the frame's rays beside
    the two-launch driver and hako_mega in turns, with its bound: the
    function's on these rays (`frame_bound`, phase 3's
    common.frame_bound), and beside it the bytes of this call's rounds
    (scripts/common.rounds_counts / rounds_bound)."""
    import torch

    from massivevoxelraytracing_torch.models import raycast
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.scripts import common

    def frame():
        return raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=device,
                                    traversal="rounds")

    def equal_mega(out, what):
        if not torch.equal(out[0], img_mega) or not torch.equal(out[1], depth_mega):
            raise AssertionError(f"rounds frame ({what}) differs from the megakernel frame")

    chk = CheckedStage()
    with route_driver(hk.hako_probe, chk):
        equal_mega(frame(), "two-launch, checked stage")
    frame()
    counts = {}
    for name, route in (("hako_rounds", contextlib.nullcontext), ("two_launch", two_launch_route)):
        with route():
            frame()
            hk.reset_counters()
            out, syncs = host_syncs(frame)
            counts[name] = dict(launches={k: v for k, v in hk.LAUNCHES.items() if v},
                                rounds=hk.rounds_run(), unresolved=hk.unresolved_lanes(),
                                host_syncs=syncs)
            equal_mega(out, name)
            if counts[name]["unresolved"]:
                raise AssertionError(f"rounds frame ({name}): lanes unresolved")
    check_route_launches(hk_launches(counts["hako_rounds"]), 1, "rounds frame")
    rounds = counts["hako_rounds"]["rounds"]
    check_two_launches(hk_launches(counts["two_launch"]), rounds,
                       "rounds frame, two-launch driver")
    if counts["two_launch"]["rounds"] != rounds:
        raise AssertionError("rounds frame: the two drivers ran other rounds")

    def two_frame():
        with two_launch_route():
            return frame()

    turns = in_turns({"hako_rounds": frame, "two_launch": two_frame})
    _, mega_syncs = host_syncs(lambda: raycast.render_frame(tree, cam, WIDTH, HEIGHT,
                                                             device=device))
    # the host walls of synced frames, and an estimate of the idle share
    # beside the trace's: the device's time from CUDA events (the frame
    # queued behind a spin kernel) against a synced frame's host wall
    walls = {}
    for name, fn in (("hako_rounds", frame), ("two_launch", two_frame)):
        walls[name] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    events_idle = {k: 1 - min(turns[k]) / min(v) for k, v in walls.items()}
    # the trace, from a process of its own (late in this one the profiler
    # drops device events: scripts/profile_window.py)
    child = subprocess.run(
        [sys.executable, "-m", "massivevoxelraytracing_torch.scripts.rounds_trace",
         "--res", str(GRID)], cwd=REPO, capture_output=True, text=True, timeout=600)
    for ln in child.stdout.splitlines():
        if ln.startswith("[rounds trace]"):
            print(f"[phase3b] {ln}", flush=True)
    if child.returncode != 0:
        raise AssertionError(f"scripts/rounds_trace failed ({child.returncode}): "
                             f"{child.stderr[-2000:]}")
    trace = json.loads(child.stdout.strip().splitlines()[-1])["rounds_trace"]

    # the traversal alone on the frame's rays: hako_rounds, the two-launch
    # driver and hako_mega in turns, and hako_rounds' bound on these rounds
    args = frame_args
    T = tree.T
    kern = hk.hako_rounds(*args, T=T)
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T)
    two = two_launch(args, T, False)
    assert_bits_equal(kern[:3], mega, "hako_rounds vs hako_mega on the frame's rays")
    assert_bits_equal(two[:3], mega, "two-launch vs hako_mega on the frame's rays")
    if kern[3].tolist() != [rounds, 0]:
        raise AssertionError(f"hako_rounds on the frame's rays: info {kern[3].tolist()}")
    alone = in_turns({"hako_rounds": lambda: hk.hako_rounds(*args, T=T),
                      "hako_mega": lambda: hako_mega.intersect_rays_hako_mega(*args, T=T),
                      "two_launch": lambda: two_launch(args, T, False)})
    rc = common.rounds_counts(*args, T=T)
    rb = common.rounds_bound(rc)
    per_sm, sms = hk.rounds_grid(device, tree.snodes is not None, False)
    # a round's fixed cost: 32 of the frame's hitting rays through many
    # capped rounds (one probe, one sub-brick visit a round) on the full
    # co-resident grid and on one block; the difference a round is the
    # grid barrier (and the idle warps' pass over an empty list)
    pick = torch.nonzero(mega[0] < 1e37)[:32, 0]
    fargs = (*args[:6], args[6][pick].contiguous(), args[7][pick].contiguous())
    fkw = dict(T=T, max_probes=1, max_dda=1)
    r_full, ms_full = timed(lambda: hk.hako_rounds(*fargs, _blocks=per_sm * sms, **fkw),
                            reps=10)
    r_one, ms_one = timed(lambda: hk.hako_rounds(*fargs, _blocks=1, **fkw), reps=10)
    assert_bits_equal(r_full[:3], r_one[:3], "hako_rounds on the full grid vs one block")
    tail_rounds = int(r_full[3][0].item())
    barrier_us = (ms_full - ms_one) / tail_rounds * 1e3
    fk, fo = counts["hako_rounds"], counts["two_launch"]
    print(f"[phase3b] rounds frame {WIDTH}x{HEIGHT}: image and depth == megakernel "
          f"bit for bit through hako_rounds and the two-launch driver (hako_dda_merge == "
          f"its plain version at each of {chk.calls} calls); "
          f"{rounds} rounds, unresolved lanes 0 [{smi}]", flush=True)
    print(f"[phase3b] rounds frame ms in turns (CUDA events, mean of 2 each): hako_rounds "
          f"{turns['hako_rounds']}, two-launch {turns['two_launch']}; a frame: launches "
          f"{fk['launches']} / {fo['launches']}, host syncs {fk['host_syncs']} / "
          f"{fo['host_syncs']}; traced (scripts/rounds_trace in its own process, lines "
          f"above): idle share of the frame through hako_rounds "
          f"{trace['frame'].get('idle_share', 'not measured')}, of the frame's rays "
          f"through hako_rounds {trace['rays_hako_rounds'].get('idle_share', 'not measured')} "
          f"and through the two-launch driver "
          f"{trace['rays_two_launch'].get('idle_share', 'not measured')} [{smi}]", flush=True)
    print(f"[phase3b] the traversal alone on the frame's {args[6].shape[0]} rays, in turns: "
          f"hako_rounds {alone['hako_rounds']} ms, hako_mega {alone['hako_mega']} ms, the "
          f"two-launch driver {alone['two_launch']} ms; hako_rounds' grid {per_sm} blocks "
          f"an SM x {sms} SMs; its bound (the function's on these rays) "
          f"{frame_bound[0]:.4f} ms ({frame_bound[1]}), share "
          f"{frame_bound[0] / min(alone['hako_rounds']):.1%}; the schedule's bytes "
          f"(each round's lanes, resume keys and rows, summed over "
          f"{len(rc['rounds'])} rounds: {sum(r[0] for r in rc['rounds'])} lane-rounds, "
          f"{sum(r[3] for r in rc['rounds'])} rows) {rb[0]:.4f} ms ({rb[1]}), share "
          f"{rb[0] / min(alone['hako_rounds']):.1%}; lanes a round "
          f"{[r[0] for r in rc['rounds']]} [{smi}]", flush=True)
    print(f"[phase3b] a round's fixed cost: 32 hitting rays, {tail_rounds} capped rounds, "
          f"{ms_full:.4f} ms on the full grid ({per_sm * sms} blocks) against "
          f"{ms_one:.4f} ms on one block: {barrier_us:.2f} us a round; the frame's "
          f"{rounds} barriers ~{barrier_us * rounds / 1e3:.3f} ms; synced frame walls "
          f"hako_rounds {walls['hako_rounds']} ms, two-launch {walls['two_launch']} ms: idle "
          f"share estimated from CUDA events {events_idle['hako_rounds']:.3f} / "
          f"{events_idle['two_launch']:.3f}; host syncs of the megakernel "
          f"frame {mega_syncs} [{smi}]", flush=True)
    return dict(frame_ms=turns["hako_rounds"], two_launch_frame_ms=turns["two_launch"],
                rounds=rounds, counts=counts, traced=trace, synced_wall_ms=walls,
                events_idle_share=events_idle, launches=hk_launches(fk),
                two_launch_launches=hk_launches(fo), checked_calls=chk.calls,
                alone_ms=alone, bound=frame_bound, schedule_bound=rb, grid=(per_sm, sms),
                round_fixed_us=barrier_us, mega_frame_syncs=mega_syncs)


def hk_launches(count: dict) -> dict:
    """A counted run's launches with every round kernel's key."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk

    return {k: count["launches"].get(k, 0) for k in hk.LAUNCHES}


class Checked:
    """The round driver's kernels, each launched through its wrapper and
    run as its plain version on the same inputs every round, compared
    (discrete outputs exact, floats bit-equal; max |float diff| kept), and
    continued with the kernel's outputs: kernel A, then the row stage
    unfused (kernel B and the merge, each against its plain version) and
    fused (hako_dda_merge on a copy of the state, held equal to the
    unfused stage's state, which is its plain version's: the plain version
    is the composition of the unfused plain versions, each of which the
    kernels equalled on the same inputs). Records the first round's inputs
    of each kernel and of the hand-off (for timing) and the rows B reads."""

    def __init__(self):
        self.err = {"hako_probe": 0.0, "hako_dda": 0.0, "hako_merge": 0.0,
                    "hako_dda_merge": 0.0}
        self.first = {}
        self.rows = {}
        self.snode_out = None

    def _diff(self, name, got, want):
        import torch

        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype.is_floating_point and g.numel():
                self.err[name] = max(self.err[name], float((g - w).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: output {i} differs from the plain version")

    def probe(self, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        self.first.setdefault("hako_probe", (a, k))
        got = hk.hako_probe(*a, **k)
        self._diff("hako_probe", got, hk.hako_probe_plain(*a, **k))
        return got

    def dda(self, rows, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        self.first.setdefault(("hako_dda", k["leaf"]), ((rows, *a), k))
        got = hk.hako_dda(rows, *a, **k)
        self._diff("hako_dda", got, hk.hako_dda_plain(rows, *a, **k))
        go, child = a[4], a[5]
        self.rows.setdefault(k["leaf"], []).append(child[go].long())
        if not k["leaf"]:
            self.snode_out = got
        return got

    def merge(self, state, *a):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        if "hako_merge" not in self.first:
            self.first["hako_merge"] = (tuple(x.clone() for x in state), a)
        want = tuple(x.clone() for x in state)
        hk.hako_merge(state, *a)
        hk.hako_merge_plain(want, *a)
        self._diff("hako_merge", state, want)

    def stage(self, state, *a, **k):
        from massivevoxelraytracing_torch.ops import hako_kernels as hk

        fused = tuple(x.clone() for x in state)
        if "hako_dda_merge" not in self.first:
            self.first["hako_dda_merge"] = (tuple(x.clone() for x in state), a, k)
        hk.hako_dda_merge(fused, *a, **k)
        hk.unfused_stage(self.dda, self.merge)(state, *a, **k)
        if a[1] is not None and "handoff" not in self.first:
            self.first["handoff"] = (a[6], a[8], a[10], self.snode_out)  # emit, bt1, tqn
        self._diff("hako_dda_merge", fused, state)

    def distinct_rows(self) -> int:
        import torch

        return sum(int(torch.unique(torch.cat(v)).numel())
                   for v in self.rows.values() if v)

    def row_visits(self) -> int:
        return sum(int(x.numel()) for v in self.rows.values() for x in v)


def checked_rounds(tree, ro, rd, shadow: bool, what: str) -> Checked:
    """Run the round loop with Checked kernels and hold its result against
    the megakernel's."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega

    chk = Checked()
    (bricks, snodes, tabs, root), T = hako_mega.hako_mega_args(tree)
    args = (bricks, snodes, tabs, root, tree.lower, tree.upper, ro, rd)
    out = hk.drive((chk.probe, chk.stage), *args, T=T, shadow=shadow,
                   max_probes=hk.PROBES, max_dda=hk.DDA_ITERS,
                   max_rounds=hk.default_max_rounds(snodes, T, hk.PROBES,
                                                    hk.DDA_ITERS))
    if int(out[3].item()) != 0:
        raise AssertionError(f"{what}: lanes unresolved")
    mega = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
    assert_bits_equal(out[:3], mega, f"{what}: checked rounds vs megakernel")
    chk.rounds = out[4]
    return chk


def time_round_kernels(chk: Checked, smi: str, what: str) -> dict:
    """Each kernel on its first-round inputs: ms (CUDA events), plain ms,
    and its bound from these inputs (scripts/common.probe_bound,
    dda_bound, merge_bound)."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.scripts import common

    out = {}
    a, k = chk.first["hako_probe"]
    n = int(a[7].shape[0])  # idx
    ms = common.event_ms_each(lambda _: hk.hako_probe(*a, **k), lambda: None)
    _, p_ms = timed(lambda: hk.hako_probe_plain(*a, **k), reps=1, warm=False)
    out["hako_probe"] = dict(ms=ms, plain_ms=p_ms, n=n, bound=common.probe_bound(
        n, 0 if a[0] is None else a[0].numel()), ops_ms=common.ops_ms(common.walk_ops(n, 0)))
    a, k = chk.first[("hako_dda", True)]
    n = int(a[4].shape[0])
    n_go, rows = common.dda_counts(a[5], a[6])
    ms = common.event_ms_each(lambda _: hk.hako_dda(*a, **k), lambda: None)
    _, p_ms = timed(lambda: hk.hako_dda_plain(*a, **k), reps=1, warm=False)
    out["hako_dda"] = dict(ms=ms, plain_ms=p_ms, n=n, rows=rows, n_go=n_go,
                           bound=common.dda_bound(n, n_go, rows),
                           ops_ms=common.ops_ms(common.walk_ops(n_go, n_go)))
    state0, a = chk.first["hako_merge"]
    idx, emit, _bt1, _tqn, _exh, hit, _t, _nm, _vr, more, _tqr = a
    counts = common.merge_counts(state0, idx, emit, hit, more)
    n, n_hit = counts[0], counts[4]
    ms = common.event_ms_each(lambda s: hk.hako_merge(s, *a),
                    lambda: tuple(x.clone() for x in state0))
    _, p_ms = timed(lambda: hk.hako_merge_plain(
        tuple(x.clone() for x in state0), *a), reps=1, warm=False)
    out["hako_merge"] = dict(ms=ms, plain_ms=p_ms, n=n, n_hit=n_hit,
                             bound=common.merge_bound(*counts),
                             ops_ms=common.ops_ms(3 * counts[1]))
    out.update(time_row_stage(chk, out))
    for name, v in out.items():
        extra = "".join(f", {v[key]} {label}" for key, label in (
            ("n_go", "go lanes"), ("n_emit", "emitting lanes"), ("row_walks", "row walks"),
            ("rows", "distinct rows"), ("n_hit", "hit lanes"))
            if key in v)
        print(f"[phase4] {name} on the first round of {what} ({v['n']} lanes{extra}): "
              f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.2f} ms, bound "
              f"{v['bound'][0]:.4f} ms ({v['bound'][1]}; operations {v['ops_ms']:.5f} ms) "
              f"[{smi}]", flush=True)
    v = out["hako_dda_merge"]
    print(f"[phase4] hako_dda_merge {v['ms']:.4f} ms against the unfused stage it "
          f"replaces on the same inputs: {v['unfused_ms']:.4f} ms as one train, parts "
          f"{ {p: round(x, 4) for p, x in v['unfused_parts_ms'].items()} } ms (sum "
          f"{v['unfused_parts_sum_ms']:.4f}, bounds' sum {v['unfused_bound_sum_ms']:.4f} "
          f"ms) [{smi}]", flush=True)
    return out


def time_rounds_kernel(args, T: int, fn_bound: tuple, what: str, smi: str) -> dict:
    """hako_rounds on a batch beside hako_mega and the two-launch driver,
    in turns (CUDA events); its plain version's ms (the plain driver, once);
    its bound `fn_bound`, the function's on the batch (mega_bound: both
    kernels compute it), and beside it the bytes of the batch's rounds
    (scripts/common.rounds_counts / rounds_bound)."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.scripts import common

    alone = in_turns({"hako_rounds": lambda: hk.hako_rounds(*args, T=T),
                      "hako_mega": lambda: hako_mega.intersect_rays_hako_mega(*args, T=T),
                      "two_launch": lambda: two_launch(args, T, False)})
    want, p_ms = timed(lambda: hk.intersect_rays_hako_plain(*args, T=T), reps=1, warm=False)
    assert_bits_equal(hk.hako_rounds(*args, T=T)[:3], want[:3], f"{what}: hako_rounds vs plain")
    rc = common.rounds_counts(*args, T=T)
    rb = common.rounds_bound(rc)
    ops = common.walk_ops(sum(r[0] for r in rc["rounds"]), sum(r[2] for r in rc["rounds"]))
    print(f"[phase4] hako_rounds on {what} ({args[6].shape[0]} lanes, {len(rc['rounds'])} "
          f"rounds, {sum(r[0] for r in rc['rounds'])} lane-rounds, "
          f"{sum(r[3] for r in rc['rounds'])} rows) in turns: hako_rounds "
          f"{alone['hako_rounds']} ms, hako_mega {alone['hako_mega']} ms, the two-launch "
          f"driver {alone['two_launch']} ms; plain {p_ms:.1f} ms; bound (the function's) "
          f"{fn_bound[0]:.4f} ms ({fn_bound[1]}), share "
          f"{fn_bound[0] / min(alone['hako_rounds']):.1%}; the schedule's bytes "
          f"{rb[0]:.4f} ms ({rb[1]}), share {rb[0] / min(alone['hako_rounds']):.1%}; lanes "
          f"a round {[r[0] for r in rc['rounds']]} [{smi}]", flush=True)
    return dict(ms=min(alone["hako_rounds"]), plain_ms=p_ms, bound=fn_bound,
                schedule_bound=rb, ops_ms=common.ops_ms(ops), alone_ms=alone,
                rounds=len(rc["rounds"]))


def time_row_stage(chk: Checked, parts: dict) -> dict:
    """The fused row stage on its first-round inputs, held against its
    plain version, beside what it replaces on the same inputs: the unfused
    stage as one train of launches and its parts (kernel B on the
    supernode rows, the hand-off's tensor ops, kernel B on the brick rows
    timed in `parts`, the merge), each queued behind a spin kernel."""
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.scripts import common

    state0, a, k = chk.first["hako_dda_merge"]

    def fresh():
        return tuple(x.clone() for x in state0)

    got, want = fresh(), fresh()
    hk.hako_dda_merge(got, *a, **k)
    _, p_ms = timed(lambda: hk.hako_dda_merge_plain(want, *a, **k), reps=1, warm=False)
    assert_bits_equal(got, want, "hako_dda_merge on the first round")
    ms = common.event_ms_each(lambda st: hk.hako_dda_merge(st, *a, **k), fresh, calls=4)
    stage = unfused()
    unfused_ms = common.event_ms_each(lambda st: stage(st, *a, **k), fresh, calls=4)
    fat = a[1] is not None
    idx, emit = a[5], a[6]
    leaf_a, _ = chk.first[("hako_dda", True)]
    walks = [(leaf_a[5], leaf_a[6])]
    split = {"leaf": parts["hako_dda"]["ms"], "merge": parts["hako_merge"]["ms"]}
    bounds = [parts["hako_dda"]["bound"][0], parts["hako_merge"]["bound"][0]]
    if fat:
        sn_a, sn_k = chk.first[("hako_dda", False)]
        walks.insert(0, (sn_a[5], sn_a[6]))
        split["supernodes"] = common.event_ms_each(lambda _: hk.hako_dda(*sn_a, **sn_k),
                                                   lambda: None)
        bounds.append(common.dda_bound(int(sn_a[4].shape[0]),
                                       *common.dda_counts(sn_a[5], sn_a[6]))[0])
        h = chk.first["handoff"]
        split["handoff"] = common.event_ms_each(lambda _: hk.supernode_handoff(*h),
                                                lambda: None, calls=2)
    hit = chk.first["hako_merge"][1][5]
    counts = common.dda_merge_counts(state0, idx, emit, walks, hit)
    return {"hako_dda_merge": dict(
        ms=ms, plain_ms=p_ms, n=counts[0], n_emit=counts[2], row_walks=counts[3],
        rows=counts[4], n_hit=counts[5], bound=common.dda_merge_bound(*counts),
        ops_ms=common.ops_ms(common.walk_ops(counts[2], counts[3])),
        unfused_ms=unfused_ms, unfused_parts_ms=split,
        unfused_parts_sum_ms=sum(split.values()), unfused_bound_sum_ms=sum(bounds))}


def bench_sky():
    """bench.py's procedural sky (64 x 128): scripts/common.sky_img."""
    from massivevoxelraytracing_torch.scripts import common

    return common.sky_img()


def phase_pt(tree, cam, device, smi: str) -> dict:
    """Phase 4: the path tracer at 1024^3 / 1080p."""
    import torch

    from massivevoxelraytracing_torch.models import accel, pathtracer
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega, pt_chain, sampling
    from massivevoxelraytracing_torch.scripts import common

    t0 = time.time()
    table = sampling.make_pmj_table()
    pmj_s = time.time() - t0
    print(f"[phase4] PMJ table {table.shape} built on the host in {pmj_s * 1e3:.1f} ms",
          flush=True)

    pt = pathtracer.PathTracer(width=WIDTH, height=HEIGHT, device=device)
    pt.pmj_table = torch.from_numpy(table)
    pt.setup()
    pt.load_hdri(bench_sky())
    pt.update_scene(tree)

    # warm step; record the first packet's traversal batches and sample-chain
    # stage calls (name, args, kwargs, outputs) on the way
    calls, stage_calls = [], []
    real = accel.intersect_with
    real_stages = {name: getattr(pt_chain, name) for name in CHAIN_STAGES}

    def recording(kind, depth, meta, root, lower, upper, ro, rd, *, shadow=False):
        if len(calls) < 1 + 2 * pathtracer.MAX_BOUNCES:
            calls.append((ro, rd, shadow))
        return real(kind, depth, meta, root, lower, upper, ro, rd, shadow=shadow)

    packets = [0]

    def recording_stage(name):
        def rec(*a, **k):
            out = real_stages[name](*a, **k)
            packets[0] += name == "lane_init"
            if packets[0] == 1:
                stage_calls.append((name, a, k, out))
            return out
        return rec

    accel.intersect_with = recording
    for name in CHAIN_STAGES:
        setattr(pt_chain, name, recording_stage(name))
    try:
        t0 = time.time()
        pt.step(cam)
        torch.cuda.synchronize()
        first_s = time.time() - t0
    finally:
        accel.intersect_with = real
        for name, fn in real_stages.items():
            setattr(pt_chain, name, fn)

    state_spp = pt.spp_done
    state_accum = pt.accum.clone()
    torch.cuda.reset_peak_memory_stats(device)
    hako_mega.reset_counters()
    pt_chain.reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    pt.step(cam)
    after_one = pt.accum.clone()
    pt.step(cam)
    stop.record()
    torch.cuda.synchronize()
    step_s = start.elapsed_time(stop) / 2 / 1e3
    mega_launches = hako_mega.LAUNCHES // 2
    chain_launches = {k: v // 2 for k, v in pt_chain.LAUNCHES.items()}
    if min(chain_launches.values()) < 1:
        raise AssertionError(f"PT step: sample-chain kernels {chain_launches}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 2**30
    n_spp = pt.n_batch_spp
    rays = WIDTH * HEIGHT * n_spp * (1 + 2 * pathtracer.MAX_BOUNCES)
    mrays = rays / step_s / 1e6
    mean = float(pt.accum[:, :3].mean())
    unresolved = hako_mega.unresolved_lanes()
    print(f"[phase4] PT mega {WIDTH}x{HEIGHT} {n_spp} spp: {step_s:.3f} s/step "
          f"(mean of 2, CUDA events; warm step {first_s:.1f} s) = {mrays:.2f} "
          f"PT Mrays/s ({rays} rays/step), {mega_launches} hako_mega launches "
          f"per step, peak memory {peak_gb:.2f} GiB, accum mean {mean:.4f} "
          f"after 3 steps (JAX bench {JAX_PT_MEAN}), unresolved {unresolved} "
          f"[{smi}]", flush=True)
    if not np.isfinite(mean) or abs(mean / JAX_PT_MEAN - 1.0) > PT_MEAN_RTOL:
        raise AssertionError(f"PT mean radiance {mean} outside {PT_MEAN_RTOL:.0%} "
                             f"of {JAX_PT_MEAN}")
    if not bool(torch.isfinite(pt.accum).all()):
        raise AssertionError("non-finite radiance")
    if mega_launches < 1 or unresolved:
        raise AssertionError("PT mega step: no launch or unresolved lanes")

    # a trace that holds every hako_mega and sample-chain launch of the step
    prof = common.profile_or_none(lambda: pt.step(cam), common.step_counts(),
                                  "[phase4] profiled mega step", smi)
    busy_ms = wall_ms = mega_ms = None
    if prof is not None:
        busy_ms, wall_ms, top, mega_ms, n_kernels = (
            prof[k] for k in ("busy_ms", "wall_ms", "top", "mega_ms", "kernels"))
        print(f"[phase4] profiled mega step: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms in {n_kernels} device kernels, idle share "
              f"{1 - busy_ms / wall_ms:.3f}, hako_mega kernels {mega_ms:.1f} ms (every "
              f"counted launch traced, try {prof['tries']}); top device kernels: [{smi}]",
              flush=True)
        for name, ms, count in top:
            print(f"[phase4]   {ms:9.2f} ms  {count:6d} calls  {name}", flush=True)

    # steps through the round driver from the state after the warm step:
    # hako_rounds, the two-launch driver, hako_rounds again
    rpt = pathtracer.PathTracer(width=WIDTH, height=HEIGHT, device=device,
                                traversal="rounds")
    rpt.pmj_table = pt.pmj_table
    rpt.env = pt.env
    rpt.update_scene(tree)

    def rounds_step(route, what):
        rpt.accum = state_accum.clone()
        rpt.spp_done = state_spp
        with route():
            hk.reset_counters()
            t0 = time.time()
            rpt.step(cam)
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = dict(s=wall, launches=dict(hk.LAUNCHES), rounds=hk.rounds_run())
        if not torch.equal(rpt.accum, after_one):
            d = (rpt.accum - after_one).abs()
            raise AssertionError(f"rounds PT step ({what}) differs from the megakernel's: "
                                 f"{int((d > 0).sum())} values, max {float(d.max())}")
        if hk.unresolved_lanes():
            raise AssertionError(f"rounds PT step ({what}): unresolved lanes")
        return got

    steps = [rounds_step(route, name) for name, route in (
        ("hako_rounds", contextlib.nullcontext), ("two-launch", two_launch_route),
        ("hako_rounds", contextlib.nullcontext))]
    rounds = steps[0]["rounds"]
    launches, two_launches = steps[0]["launches"], steps[1]["launches"]
    n_calls = launches["hako_rounds"]
    check_route_launches(launches, n_calls, "rounds PT step")
    check_two_launches(two_launches, rounds, "rounds PT step, two-launch driver")
    if not steps[1]["rounds"] == steps[2]["rounds"] == rounds or steps[2]["launches"] != launches:
        raise AssertionError("rounds PT steps: the drivers ran other rounds or launches")
    rpt.accum = state_accum.clone()
    rpt.spp_done = state_spp
    _, syncs = host_syncs(lambda: rpt.step(cam))
    rounds_s = [steps[0]["s"], steps[2]["s"]]
    two_s = steps[1]["s"]
    n = WIDTH * HEIGHT
    pix_packet = max(min(pt.packet // (n_spp * 2), 1 << (n - 1).bit_length()), 1024)
    calls_per_step = (pt._pixel_perm(pix_packet)[2] // pix_packet
                      * (1 + 2 * pathtracer.MAX_BOUNCES))
    if n_calls != mega_launches:
        raise AssertionError(f"rounds PT step: {n_calls} hako_rounds launches against "
                             f"{mega_launches} hako_mega launches a step")
    print(f"[phase4] PT rounds step: accumulator == megakernel step bit for bit through "
          f"hako_rounds and the two-launch driver; in turns (host "
          f"clock): hako_rounds {rounds_s[0]:.3f} s, two-launch {two_s:.2f} s, hako_rounds "
          f"{rounds_s[1]:.3f} s; {rounds} rounds over {calls_per_step} traversal calls; "
          f"launches {launches['hako_rounds']} hako_rounds / two-launch "
          f"{ {k: v for k, v in two_launches.items() if v} }; host syncs in a hako_rounds "
          f"step {syncs} (the two-launch driver adds one nonzero a round and one a call: "
          f"{rounds + calls_per_step}) [{smi}]", flush=True)

    chain = phase_chain(pt, cam, stage_calls, state_accum, state_spp, after_one, prof,
                        chain_launches, step_s, smi)
    del stage_calls

    # every kernel vs its plain version on the first packet's full bounce-1
    # BSDF and NEE batches, the inputs the step gives them; the BSDF batch
    # is also the one each kernel is timed on
    (ro_b, rd_b, sb), (ro_s, rd_s, ss) = calls[3], calls[4]
    if sb or not ss:
        raise AssertionError("recorded batches are not BSDF then NEE")
    err = {"hako_mega": 0.0, "hako_probe": 0.0, "hako_dda": 0.0, "hako_merge": 0.0,
           "hako_dda_merge": 0.0, "hako_rounds": 0.0}
    counters, lanes = {}, {}
    for ro, rd, shadow, name in ((ro_b, rd_b, False, "BSDF"), (ro_s, rd_s, True, "NEE")):
        what = f"bounce-1 {name} batch"
        chk = checked_rounds(tree, ro, rd, shadow, what)
        st, k_ms, p_ms = kernel_vs_plain(tree, ro, rd, shadow, what, device)
        args, T = tree_args(tree, ro, rd, device)
        ref = hako_mega.intersect_rays_hako_mega(*args, T=T, shadow=shadow)
        counters[name] = counter_summary(args, T, shadow, ref, what, smi)
        lanes[name] = int(ro.shape[0])
        for k, v in chk.err.items():
            err[k] = max(err[k], v)
        err["hako_mega"] = max(err["hako_mega"], st["max_abs_err"])
        print(f"[phase4] {what} ({st['n']} lanes, {st['hits']} hits): "
              f"hako_probe / hako_dda / hako_merge / hako_dda_merge == plain versions "
              f"round by round "
              f"over {chk.rounds} rounds, max |diff| {chk.err}; hako_mega == plain "
              f"version, max |dt| {st['max_abs_err']:.3g}, max ulp {st['max_ulp']}; "
              f"hako_mega {k_ms:.3f} ms, plain {p_ms:.1f} ms [{smi}]", flush=True)
        rounds_kernel = hk.hako_rounds(*args, T=T, shadow=shadow)
        assert_bits_equal(rounds_kernel[:3], ref, f"{what}: hako_rounds vs hako_mega")
        if rounds_kernel[3].tolist() != [chk.rounds, 0]:
            raise AssertionError(f"{what}: hako_rounds info {rounds_kernel[3].tolist()}, "
                                 f"the checked driver's {chk.rounds} rounds")
        if not shadow:
            timing = time_round_kernels(chk, smi, f"one packet's {what}")
            timing["hako_mega"] = dict(ms=k_ms, plain_ms=p_ms,
                                       bound=mega_bound(tree, chk, st["n"]))
            timing["hako_rounds"] = time_rounds_kernel(args, T, timing["hako_mega"]["bound"],
                                                       what, smi)
    return dict(first_accum=state_accum, env=pt.env, pmj=pt.pmj_table,
                step_s=step_s, mrays=mrays, mean=mean, peak_gb=peak_gb,
                mega_launches=mega_launches, rounds_launches=launches,
                two_launch_launches=two_launches, two_launch_s=two_s, host_syncs=syncs,
                rounds=rounds, rounds_s=rounds_s, timing=timing, err=err,
                busy_ms=busy_ms, wall_ms=wall_ms, mega_ms=mega_ms,
                counters=counters, lanes=lanes, chain=chain)


def max_float_diff(a, b) -> float:
    import torch

    from massivevoxelraytracing_torch.scripts.common import flat_tensors

    d = [float((x - y).abs().max()) for x, y in zip(flat_tensors(a), flat_tensors(b))
         if x.dtype == torch.float32 and x.numel()]
    return max(d, default=0.0)


def phase_chain(pt, cam, stage_calls, state_accum, state_spp, after_one, prof,
                chain_launches, step_s, smi: str) -> dict:
    """Phase 4's sample chain: one step through the plain stages on the
    card from the warm step's state (bit-equal to the kernels' step), both
    routes' device kernels, busy and idle share under the profiler; then
    each kernel against its plain stage on the first packet's recorded
    inputs, bit for bit, and on the bounce-1 call (the only call of the
    lane setup and the primary shade) its ms, its plain stage's ms and its
    bound; the bounce sample on that call also through the sats HDRI
    backend, kernel against plain stage."""
    import dataclasses

    import torch

    from massivevoxelraytracing_torch.models import pathtracer
    from massivevoxelraytracing_torch.ops import pt_chain
    from massivevoxelraytracing_torch.scripts import common, render_ab
    from massivevoxelraytracing_torch.scripts.common import flat_tensors

    ppt = pathtracer.PathTracer(width=WIDTH, height=HEIGHT, device=pt.device)
    ppt.pmj_table, ppt.env = pt.pmj_table, pt.env
    ppt.update_scene(pt.tree)
    ppt.accum, ppt.spp_done = state_accum.clone(), state_spp
    pt_chain.reset_counters()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    ppt.step(cam, chain="plain")
    stop.record()
    torch.cuda.synchronize()
    plain_s = start.elapsed_time(stop) / 1e3
    if any(pt_chain.LAUNCHES.values()):
        raise AssertionError(f"plain-chain step launched {pt_chain.LAUNCHES}")
    if not torch.equal(ppt.accum, after_one):
        d = (ppt.accum - after_one).abs()
        raise AssertionError(f"plain-chain step differs from the kernels' step: "
                             f"{int((d > 0).sum())} values, max {float(d.max())}")
    pprof = common.profile_or_none(lambda: ppt.step(cam, chain="plain"), common.step_counts(),
                                   "[phase4] profiled plain-chain step", smi)
    del ppt
    routes = {}
    for route, r, s in (("kernels", prof, step_s), ("plain", pprof, plain_s)):
        if r is None:
            routes[route] = dict(s_per_step=s, profile="not measured")
            print(f"[phase4] chain={route}: {s:.3f} s/step (CUDA events), profiled step not "
                  f"measured [{smi}]", flush=True)
            continue
        routes[route] = dict(s_per_step=s, device_kernels=r["kernels"], busy_ms=r["busy_ms"],
                             wall_ms=r["wall_ms"], idle_share=r["idle_share"],
                             mega_ms=r["mega_ms"], chain=r["chain"], profile_tries=r["tries"])
        print(f"[phase4] chain={route}: {s:.3f} s/step (CUDA events), profiled step "
              f"{r['kernels']} device kernels, busy {r['busy_ms']:.1f} of "
              f"{r['wall_ms']:.1f} ms, idle share {r['idle_share']:.3f}, hako_mega "
              f"{r['mega_ms']:.1f} ms (every counted launch traced, try {r['tries']}) "
              f"[{smi}]", flush=True)
    # the kernel route's device kernels against the plain route's, where
    # both traces hold every counted launch
    if prof is not None and pprof is not None and (
            routes["kernels"]["device_kernels"] * 10 > routes["plain"]["device_kernels"]):
        raise AssertionError(f"the kernel route launches {routes['kernels']['device_kernels']}"
                             f" device kernels a step, over a tenth of the plain route's "
                             f"{routes['plain']['device_kernels']}")

    # each kernel vs its plain stage on every recorded call; timed on bounce 1
    names = [c[0] for c in stage_calls]
    timed_at = {"lane_init": 0, "primary_shade": names.index("primary_shade"),
                "bounce_sample": [i for i, n in enumerate(names) if n == "bounce_sample"][1],
                "bounce_shade": [i for i, n in enumerate(names) if n == "bounce_shade"][1],
                "compact_gather": names.index("compact_gather")}
    def bits_equal(got, want) -> bool:
        got_t, want_t = flat_tensors(got), flat_tensors(want)
        return len(got_t) == len(want_t) and all(
            g.dtype == w.dtype and g.shape == w.shape
            and torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                            w.view(torch.int32) if w.dtype == torch.float32 else w)
            for g, w in zip(got_t, want_t))

    out = {}
    for i, (name, a, k, rec) in enumerate(stage_calls):
        kern = getattr(pt_chain, name)(*a, **k)
        plain = getattr(pt_chain, name + "_plain")(*a, **k)
        torch.cuda.synchronize()
        e = out.setdefault(f"pt_{name}", dict(calls_checked=0, max_abs_err=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], max_float_diff(kern, plain))
        for what, want in (("its plain stage", plain), ("the step's own call", rec)):
            if not bits_equal(kern, want):
                raise AssertionError(f"pt_{name} call {i} differs from {what} (max |diff| "
                                     f"{max_float_diff(kern, want)})")
        e["calls_checked"] += 1
        if i == timed_at[name]:
            _r, e["ms"] = common.timed(lambda: getattr(pt_chain, name)(*a, **k), 20)
            _r, e["plain_ms"] = common.timed(lambda: getattr(pt_chain, name + "_plain")(*a, **k), 3)
            e["bound_ms"], e["bound_by"] = common.chain_bound(name, a, k, kern)
            e["lanes"] = int(flat_tensors(kern)[0].shape[0])
        if i == timed_at[name] and name == "bounce_sample":
            # the sats HDRI backend (not the main path's): the same call
            sats = (dataclasses.replace(a[0], use_alias=False), *a[1:])
            n0 = pt_chain.LAUNCHES["pt_bounce_sample"]
            skern = pt_chain.bounce_sample(*sats, **k)
            if (pt_chain.LAUNCHES["pt_bounce_sample"] != n0 + 1
                    or not bits_equal(skern, pt_chain.bounce_sample_plain(*sats, **k))):
                raise AssertionError("pt_bounce_sample (sats) differs from its plain stage")
            _r, e["sats_ms"] = common.timed(lambda: pt_chain.bounce_sample(*sats, **k), 20)
            _r, e["sats_plain_ms"] = common.timed(
                lambda: pt_chain.bounce_sample_plain(*sats, **k), 3)
            e["sats_bound_ms"], e["sats_bound_by"] = common.chain_bound(
                "bounce_sample", sats, k, skern)
            del skern
            # with --ab, both backends in turns with the parent commit's
            # kernel (scripts/render_ab.py), both == the plain stage first
            for backend in ("sats", "alias") if AB else ():
                ab = render_ab.bounce_ab(render_ab.parent("pt_bounce_sample"), a, k,
                                         backend, smi)
                e[f"{backend}_ab"] = ab
                print(f"[phase4] pt_bounce_sample ({backend}) in turns with its parent's "
                      f"kernel (CUDA events, {render_ab.REPS} calls a turn): current "
                      f"{fmt_ms(ab['ms'])} ms, parent {fmt_ms(ab['old_ms'])} ms; share "
                      f"current {ab['share']:.1%}, parent {ab['old_share']:.1%} of "
                      f"{ab['bound_ms']:.4f} ms; faster in every turn: {ab['faster']} "
                      f"[{smi}]", flush=True)
        del kern, plain
    for name, e in out.items():
        ms_step, calls_step = prof["chain"][name]
        e.update(launches=chain_launches[name], ms_a_step=ms_step,
                 profiled_launches=calls_step, share=e["bound_ms"] / e["ms"])
        print(f"[phase4] {name} == its plain stage bit for bit on {e['calls_checked']} "
              f"calls of the first packet; timed call ({e['lanes']} lanes) {e['ms']:.4f} ms, "
              f"plain {e['plain_ms']:.2f} ms, bound {e['bound_ms']:.4f} ms "
              f"({e['bound_by']}), share {e['share']:.2f}; {e['launches']} launches a step, "
              f"{ms_step:.2f} ms a profiled step [{smi}]", flush=True)
        if "sats_ms" in e:
            print(f"[phase4] {name} with the sats HDRI backend == its plain stage bit for "
                  f"bit on the timed call: {e['sats_ms']:.4f} ms, plain "
                  f"{e['sats_plain_ms']:.2f} ms, bound {e['sats_bound_ms']:.4f} ms "
                  f"({e['sats_bound_by']}), share {e['sats_bound_ms'] / e['sats_ms']:.2f} "
                  f"[{smi}]", flush=True)
    return dict(routes=routes, kernels=out)


def mega_bound(tree, chk: Checked, n: int) -> tuple:
    """hako_mega's bound on n rays (ops/hako_mega.traversal_traffic), with
    the distinct rows and row visits of the checked round driver run `chk`
    on the same rays (both routes walk the same rows)."""
    from massivevoxelraytracing_torch.ops import hako_mega

    return bound(*hako_mega.traversal_traffic(
        n, chk.distinct_rows(), chk.row_visits(),
        sum(t.shape[0] for t in tree.levels)))


def quantile(v, q: float) -> float:
    import torch

    return float(torch.quantile(v, q))


def counter_summary(args, T, shadow: bool, ref, what: str, smi: str) -> dict:
    """The kernel's counting variant on these rays: its outputs must equal
    `ref`; returns (and prints) the means and 99th percentiles of the
    per-ray counters, and per warp the SIMT efficiency of the round loop
    and of the probe / DDA loops (active lanes over 32 x passes), the share
    of the warp's clock64 life its lanes spent before their rays resolved,
    its life and its passes."""
    from massivevoxelraytracing_torch.ops import hako_mega

    out = hako_mega.intersect_rays_hako_mega_counted(*args, T=T, shadow=shadow)
    assert_bits_equal(out[:3], ref, f"{what}: counting variant")
    counts = out[3].double()
    ws = out[4][out[4][:, 1] > 0].double()
    summary = {name: dict(mean=float(counts[k].mean()), p99=quantile(counts[k], 0.99))
               for k, name in enumerate(hako_mega.RAY_COUNTS)}
    life = ws[:, 3] - ws[:, 2]
    inner = ws[ws[:, 6] > 0]
    for name, v in (("simt_efficiency", ws[:, 0] / (32 * ws[:, 1])),
                    ("inner_simt_efficiency", inner[:, 5] / (32 * inner[:, 6])),
                    ("lane_busy_share", ws[:, 4] / (32 * life)),
                    ("warp_life_cycles", life), ("warp_passes", ws[:, 1])):
        summary[name] = dict(mean=float(v.mean()), p1=quantile(v, 0.01),
                             p99=quantile(v, 0.99))
    summary["warps"] = int(ws.shape[0])
    text = ", ".join(f"{k} {v['mean']:.3f} (p99 {v['p99']:.3f})"
                     for k, v in summary.items() if isinstance(v, dict))
    print(f"[counters] {what}, {summary['warps']} warps: {text} "
          f"[{smi}]", flush=True)
    return summary


def flush_l2(device) -> None:
    """Overwrite the 50 MB L2 with a 128 MB buffer."""
    import torch

    torch.empty(32 << 20, dtype=torch.float32, device=device).fill_(1.0)


def phase_probes(tree, ro, rd, device, smi: str) -> dict:
    """Phase 5: the Hopper ports of the TPU probes the traversal's design
    asks about, each checked against its plain version before its time is
    taken. Row chase: a table of the lattice tree's row count (above the
    L2, flushed before each timed launch) and an L2-resident hot set; three
    read widths; 1, 2, 4 chains a thread; one warp an SM (ns per dependent
    hop) and full occupancy (rows/s). Walk vs fetch at the frame's lanes."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import common

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(SEED)
    n_rows = tree.bricks.shape[0] + (0 if tree.snodes is None else tree.snodes.shape[0])
    chase = []
    for table, rows_n in (("lattice", n_rows), ("hot", HOT_ROWS)):
        rows = torch.from_numpy(probes.make_chase_table(rows_n, rng)).to(device)
        cold = table == "lattice"
        for mode in probes.CHASE_MODES:
            for chains in (1, 2, 4):
                for shape, blocks, threads, hops in (
                        ("one warp an SM", sms, 32, LATENCY_HOPS),
                        ("full occupancy", sms * 8, 256, RATE_HOPS)):
                    n = probes.chase_chains(mode, chains, blocks, threads)
                    start = torch.from_numpy(
                        rng.integers(0, rows_n, n).astype(np.int32)).to(device)
                    kw = dict(hops=hops, mode=mode, chains=chains, blocks=blocks,
                              threads=threads)
                    got = probes.row_chase(rows, start, **kw)
                    want = probes.row_chase_plain(rows, start, hops=hops, mode=mode)
                    if not torch.equal(got, want):
                        raise AssertionError(f"row chase {table} {mode} x{chains}: "
                                             "differs from the plain version")
                    ms = common.event_ms_each(lambda _: probes.row_chase(rows, start, **kw),
                                    (lambda: flush_l2(device)) if cold else (lambda: None),
                                    reps=5)
                    rec = dict(table=table, mode=mode, chains=chains,
                               shape=shape, n_chains=n, hops=hops, ms=ms,
                               ns_per_hop=ms * 1e6 / hops,
                               rows_per_s=n * hops / (ms * 1e-3))
                    if (table, mode, chains, shape) == ("lattice", "16B", 1,
                                                        "full occupancy"):
                        # the kernels line's case: the plain version's time;
                        # the bound: each hop's 16 bytes and each chain's
                        # start and end read or written once
                        _, rec["plain_ms"] = timed(lambda: probes.row_chase_plain(
                            rows, start, hops=hops, mode=mode), reps=1, warm=False)
                        rec["bound"] = bound(n * hops * 16 + n * 8, 0)
                    chase.append(rec)
                    print(f"[phase5] row chase, {table} table ({rows_n} rows, "
                          f"{rows_n * ROW_BYTES / 1e6:.1f} MB), {mode}, {chains} "
                          f"chain(s), {shape} ({n} chains x {hops} hops): == plain "
                          f"version; {ms:.4f} ms, {ms * 1e6 / hops:.1f} ns per "
                          f"dependent hop, {n * hops / (ms * 1e-3) / 1e9:.3f} G rows/s "
                          f"[{smi}]", flush=True)
        del rows
    n = ro.shape[0]
    _t0, t1, dt, _vm6, _ok = hk._ray_preamble(tree.lower, tree.upper, ro, rd)
    t1 = t1.contiguous()
    dc = (dt * 0.25).contiguous()

    def words(size):
        return torch.from_numpy(rng.integers(0, 1 << 32, size, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(device)

    lo, hi = words(n), words(n)
    got = probes.walk_probe(lo, hi, t1, dc, iters=PROBE_ITERS)
    if not torch.equal(got, probes.walk_probe_plain(lo, hi, t1, dc, iters=PROBE_ITERS)):
        raise AssertionError("walk probe differs from the plain version")
    _, walk_ms = timed(lambda: probes.walk_probe(lo, hi, t1, dc, iters=PROBE_ITERS),
                       reps=5)
    row_of = torch.from_numpy(rng.integers(0, tree.bricks.shape[0], n)
                              .astype(np.int32)).to(device)
    got = probes.fetch_probe(tree.bricks, row_of, iters=PROBE_ITERS)
    if not torch.equal(got, probes.fetch_probe_plain(tree.bricks, row_of,
                                                     iters=PROBE_ITERS)):
        raise AssertionError("fetch probe differs from the plain version")
    fetch_ms = common.event_ms_each(
        lambda _: probes.fetch_probe(tree.bricks, row_of, iters=PROBE_ITERS),
        lambda: flush_l2(device), reps=5)
    per = n * PROBE_ITERS
    print(f"[phase5] walk vs fetch on {n} lanes x {PROBE_ITERS} (== plain versions): "
          f"walk64 {walk_ms:.4f} ms = {walk_ms * 1e6 / per:.4f} ns per lane-walk "
          f"over the card; row-word fetch, the lanes' rows staged in shared memory (L2 "
          f"flushed first, so the staging reads HBM) {fetch_ms:.4f} ms = "
          f"{fetch_ms * 1e6 / per:.4f} ns per lane-fetch [{smi}]", flush=True)
    return dict(chase=chase, walk_ms=walk_ms, fetch_ms=fetch_ms,
                walk_ns=walk_ms * 1e6 / per, fetch_ns=fetch_ms * 1e6 / per,
                lanes=n, iters=PROBE_ITERS, sms=sms)


SLICE_KERNELS = ("construct_probe", "node_gather_probe", "table_select_probe",
                 "calib_probe", "walk_probe", "fetch_probe", "pipe_probe")


def phase_slice(tree, cam, smi: str) -> dict:
    """Phase 5b: the issue-cost probe scripts and the round phase timing,
    through their entry points, with the kernels' counts set to 0 just
    before and read just after."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import (common, construct_micro,
                                                      hako_kernel_micro,
                                                      hako_phase_timing, issue_ab,
                                                      row_stage_ab, table_ab)

    t0 = time.time()
    # with --ab, the earlier probes library for issue_ab and stage_ab, built
    # by nvcc while the card measures
    build = concurrent.futures.ThreadPoolExecutor(1)
    earlier = build.submit(issue_ab.build_earlier, issue_ab.EARLIER) if AB else None
    meter = common.Meter(torch.device("cuda", 0))  # one calibration for both scripts
    torch.cuda.synchronize()
    probes.reset_counters()
    hk.reset_counters()
    hako_kernel_micro.main([], meter=meter)
    records = construct_micro.main([], meter=meter)
    timing = [hako_phase_timing.main(["--res", str(res)]) for res in (256, GRID)]
    timing.append(hako_phase_timing.run(tree, cam, WIDTH, 1088,
                                        label=f"lattice {GRID}^3", card=smi))
    torch.cuda.synchronize()
    launches = {k: probes.LAUNCHES[k] for k in SLICE_KERNELS}
    round_launches = {k: hk.LAUNCHES[k] for k in hk.LAUNCHES if k != "hako_dda_cached"}
    for name, n in {**launches, **round_launches}.items():
        if n < 1:
            raise AssertionError(f"phase 5b launched no {name} kernel")
    if hk.LAUNCHES["hako_dda_cached"]:
        raise AssertionError("phase 5b launched hako_dda_cached")
    cases = [(r["name"], r["shape"]) for r in records]
    if len(set(cases)) != len(cases):
        raise AssertionError("phase 5b measured a probe case twice")
    if not timing[1]["fat"] or timing[0]["fat"]:
        raise AssertionError("phase timing: 256^3 must be plain and 1024^3 fat")
    if sum(sum(t["launches"].values()) for t in timing) != sum(round_launches.values()):
        raise AssertionError("phase timing: its runs' launches do not add up to the "
                             "phase's")
    # the isolated phases' own launches (the reference's kernel A alone,
    # its :91, and kernel B alone, its :137), summed over the three runs
    isolated = {k: sum(rec["launches"][k] for t in timing for rec in t["phases"].values())
                for k in round_launches}
    for t in timing:
        t.pop("outputs")
    print(f"[phase5b] {len(records)} probe cases == plain versions; launches "
          f"{launches}, round kernels {round_launches} (of them in the isolated "
          f"phases {isolated}); {time.time() - t0:.1f} s [{smi}]", flush=True)
    out = dict(records=records, timing=timing, launches=launches,
               round_launches=round_launches, isolated_launches=isolated, pipe=meter.pipe,
               funcs=meter.funcs, earlier=earlier)
    build.shutdown(wait=False)
    # with --ab, the redesigned kernels in turns with their parent commits'
    # (their launches are not counted): the fetch (scripts/row_stage_ab.py,
    # which builds a33e950's library first), the shared forms of the node
    # fetch and the select (scripts/table_ab.py, 6fa41fa's), the walk probe
    # and construct probe (scripts/issue_ab.py, aca9a3e's, at the meter's
    # pipe rates)
    if not AB:
        return out
    t1 = time.time()
    with row_stage_ab.counts_kept():
        out["ab"] = row_stage_ab.fetch_ab(torch.device("cuda", 0), card=smi)
    report_ab("phase5b", "fetch_probe", out["ab"],
              ("one warp an SM", "full occupancy", "script"), smi)
    print(f"[phase5b] fetch_probe in turns with the parent's kernel: "
          f"{time.time() - t1:.1f} s [{smi}]", flush=True)
    t2 = time.time()
    out["table_ab"] = tab = table_ab.run(torch.device("cuda", 0), card=smi)
    for name in table_ab.ENTRY:
        report_ab("phase5b", name, tab[name], tuple(tab[name]), smi)
    print(f"[phase5b] the shared node fetch and select in turns with 6fa41fa's "
          f"kernels: {time.time() - t2:.1f} s [{smi}]", flush=True)
    t3 = time.time()
    out["issue_ab"] = iss = issue_ab.run(torch.device("cuda", 0), card=smi,
                                         pipe=meter.pipe, funcs=meter.funcs,
                                         earlier=earlier.result())
    for name in issue_ab.ENTRY:
        report_ab("phase5b", name, iss[name], tuple(iss[name]), smi)
    print(f"[phase5b] the walk and construct probes in turns with aca9a3e's kernels: "
          f"{time.time() - t3:.1f} s [{smi}]", flush=True)
    return out


def report_ab(phase: str, kernel: str, ab: dict, cases, smi: str) -> None:
    """A line for each case of scripts/row_stage_ab.py or table_ab.py whose
    redesigned kernel is not faster than the parent's in every turn."""
    for case in cases:
        if ab[case]["faster"] != "current":
            print(f"[{phase}] {kernel} {case}: the redesigned kernel is not faster in "
                  f"every turn ({ab[case]['faster']}) [{smi}]", flush=True)


SHELL_KERNELS = ("shell_copy_probe", "preamble_probe", "probe_stage_probe")


def phase_split(tree, smi: str, meter: dict) -> dict:
    """Phase 5c: kernel A's fixed cost (scripts/hako_shell_micro.py, both
    parts, its preamble's and stages' pipe floors at phase 5b's pipe rates,
    meter["pipe"], from the SASS meter["funcs"]) and the round's phases
    with the row-cached kernel B (scripts/r3_phase_split.run on the
    phase-3 lattice under the script's camera), through their entry
    points, with the kernels' counts set to 0 just before and read just
    after; with --ab, the row cache and the probe body's stages in turns
    with their parents' kernels (meter["earlier"]: aca9a3e's library, built
    during phase 5b)."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import (hako_shell_micro, r3_phase_split,
                                                      row_stage_ab, stage_ab)

    t0 = time.time()
    torch.cuda.synchronize()
    probes.reset_counters()
    hk.reset_counters()
    shell = hako_shell_micro.main(["--staged"], pipe=meter["pipe"], funcs=meter["funcs"])
    split = r3_phase_split.run(tree, r3_phase_split.script_camera(tree), WIDTH, 1088,
                               label=f"lattice {GRID}^3", card=smi)
    torch.cuda.synchronize()
    launches = {k: probes.LAUNCHES[k] for k in SHELL_KERNELS}
    round_launches = dict(hk.LAUNCHES)
    for name, n in {**launches, **round_launches}.items():
        if n < 1:
            raise AssertionError(f"phase 5c launched no {name} kernel")
    counted = sum(r["launches"] for r in shell["cases"])
    if counted != sum(launches.values()) + shell_probe_launches(shell):
        raise AssertionError("phase 5c: the shell cases' launches do not add up")
    if sum(split["launches"].values()) + shell_probe_launches(shell) != sum(
            round_launches.values()):
        raise AssertionError("phase 5c: the split's launches do not add up")
    split.pop("outputs")
    print(f"[phase5c] {len(shell['cases'])} shell cases and {len(split['phases'])} round "
          f"phases == plain versions; launches {launches}, round kernels "
          f"{round_launches}; {time.time() - t0:.1f} s [{smi}]", flush=True)
    out = dict(shell=shell, split=split, launches=launches, round_launches=round_launches)
    if not AB:
        return out
    # with --ab, the redesigned kernels in turns with their parent commits'
    # (their launches are not counted): the row cache (scripts/row_stage_ab.py,
    # which builds a33e950's library first) and the probe body's stages
    # (scripts/stage_ab.py, aca9a3e's library, at the meter's pipe rates)
    t1 = time.time()
    with row_stage_ab.counts_kept():
        out["ab"] = row_stage_ab.dda_ab(tree, r3_phase_split.script_camera(tree), WIDTH,
                                        1088, card=smi)
    report_ab("phase5c", "hako_dda_cached", out["ab"], ("round order", "sorted by row"), smi)
    print(f"[phase5c] hako_dda_cached in turns with the parent's kernel: "
          f"{time.time() - t1:.1f} s [{smi}]", flush=True)
    t2 = time.time()
    out["stage_ab"] = sab = stage_ab.run(torch.device("cuda", 0), card=smi,
                                         pipe=meter["pipe"], funcs=meter["funcs"],
                                         earlier=meter["earlier"].result())
    report_ab("phase5c", "probe_stage_probe", sab,
              [k for k in sab if k not in ("designs", "pipe")], smi)
    print(f"[phase5c] the probe body's stages in turns with aca9a3e's kernel: "
          f"{time.time() - t2:.1f} s [{smi}]", flush=True)
    return out


def phase_gather(smi: str, sl: dict) -> dict:
    """Phase 5d: the 2D gather probes (scripts/dyngather_probe2.run and
    scripts/gather_probe3.main with every probe), through their entry
    points, with the probe kernels' counts set to 0 just before and read
    just after; the one-hot chase's latency floors from phase 5b's
    dependent node fetches of this run; then the tensor-core one-hot
    gather and the shared axis-0 take-along in turns with the parent
    commit's kernels (scripts/gather_ab.py, which first builds the
    parent's library)."""
    import torch

    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import (common, dyngather_probe2, gather_ab,
                                                      gather_probe3)

    t0 = time.time()
    device = torch.device("cuda", 0)
    torch.cuda.synchronize()
    probes.reset_counters()
    dyn = dyngather_probe2.run(device, card=smi)
    g3 = gather_probe3.main(list(gather_probe3.ALL))
    torch.cuda.synchronize()
    launches = {k: probes.LAUNCHES[k] for k in common.GATHER_CASE_KERNELS}
    for name in probes.GATHER_KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"phase 5d launched no {name} kernel")
    cases = (dyn["cases"] + g3["a0small"]["cases"] + g3["ohg"]["cases"]
             + g3["ohg1k"]["cases"])
    counted = sum(r["launches"] for r in cases) + g3["vmem"]["launches"]
    if counted != sum(launches.values()):
        raise AssertionError(f"phase 5d: the scripts' launches ({counted}) do not add up "
                             f"to the phase's {launches}")
    cap = g3["vmem"]
    if (cap["largest_launched_bytes"] != cap["optin_bytes"]
            or cap["refused_rows"] != cap["optin_rows"] + 1):
        raise AssertionError(f"phase 5d: capacity {cap['largest_launched_bytes']} B launched, "
                             f"{cap['first_refused_bytes']} B refused, against the "
                             f"opt-in limit {cap['optin_bytes']} B")
    # the latency floor of k dependent loads: the least ns of a dependent
    # node fetch at one warp an SM (phase 5b, node_gather_probe)
    fetch_ns = {space: min(r["ns_per_repeat"] for r in sl["records"]
                           if r["name"].startswith(f"gather {space} ")
                           and r["shape"] == "one warp an SM")
                for space in ("shared", "global")}
    for rec in g3["ohg"]["cases"] + g3["ohg1k"]["cases"]:
        if rec["mode"] in fetch_ns and not rec["refused"]:
            rec["latency_floor_ms"] = rec["k"] * fetch_ns[rec["mode"]] * 1e-6
            print(f"[phase5d] {rec['name']}: latency floor {rec['latency_floor_ms'] * 1e3:.3f} "
                  f"us ({rec['k']} x {fetch_ns[rec['mode']]:.2f} ns) against "
                  f"{rec['ms'] * 1e3:.3f} us [{smi}]", flush=True)
    print(f"[phase5d] {len(cases)} gather cases == plain versions; capacity "
          f"{cap['largest_launched_bytes']} B (the opt-in limit), {cap['refused_rows']} rows "
          f"refused; launches {launches}; {time.time() - t0:.1f} s [{smi}]", flush=True)
    out = dict(dyngather=dyn, gather_probe3=g3, launches=launches, fetch_ns=fetch_ns)
    if not AB:
        return out
    # with --ab, the two redesigned kernels in turns with the parent
    # commit's (scripts/gather_ab.py; its launches are not counted)
    out["ab"] = ab = gather_ab.run(card=smi)
    for key in ("ohg 128", "ohg 1024", "k_taa0t", "a0small 128"):
        if ab[key]["faster"] != "current":
            print(f"[phase5d] {key}: the redesigned kernel is not faster in every turn "
                  f"({ab[key]['faster']}) [{smi}]", flush=True)
    for n in (128, 1024):
        r = ab[f"ohg {n}"]
        lib = r["torch.matmul_ms"]
        print(f"[phase5d] ohg {n} rows: the tensor-core kernel {min(r['ms']):.4f}-"
              f"{max(r['ms']):.4f} ms against torch.matmul in one CUDA graph "
              f"{min(lib):.4f}-{max(lib):.4f} ms in the same turns: "
              f"{'faster' if max(r['ms']) < min(lib) else 'not faster'} [{smi}]", flush=True)
    print(f"[phase5d] in turns with the parent's kernels: {time.time() - t0:.1f} s [{smi}]",
          flush=True)
    return out


def gather_entries(gp: dict, src: str) -> list:
    """Phase 5d's kernels line entries: take_along_probe once for each
    reference body (the four dyngather bodies in the shared form on the
    card-filling batch, each beside its own bound; a0small's tables, one
    tile, in the shared form or, where that is refused, through L1), with
    that body's launches over every form and batch; smem_alloc_probe at
    the largest allocation; ohg_probe's tensor-core mode summed over its
    128- and 1024-row tables."""
    dyn = gp["dyngather"]["cases"]
    a0 = gp["gather_probe3"]["a0small"]["cases"]
    mma = [r for name in ("ohg", "ohg1k") for r in gp["gather_probe3"][name]["cases"]
           if r["mode"] == "mma"]
    cap = gp["gather_probe3"]["vmem"]

    def total(recs, key):
        return sum(r[key] for r in recs)

    def brief(recs, keys):
        return {f"{r['name']} {r['form'] if 'form' in r else r['mode']} B={r.get('batch', 1)}":
                {k: r.get(k) for k in keys} for r in recs}

    keys = ("ms", "plain_ms", "library_ms", "shell_ms", "bound_ms", "bytes", "refused",
            "take_along_launches")
    taa = []
    lines = {"k_taa1": 41, "k_taa1w": 52, "k_taa0": 59, "k_taa0t": 70}
    bodies = [(r["body"], f"scripts/dyngather_probe2.py:19 ({r['body']} :{lines[r['body']]})",
               [c for c in dyn if c["body"] == r["body"]],
               r["batch"]) for r in dyn if r["form"] == "shared" and r["batch"] > 1]
    bodies += [(f"a0small n_rows={n}", "scripts/gather_probe3.py:70",
                [c for c in a0 if c["n_rows"] == n], 1)
               for n in dict.fromkeys(r["n_rows"] for r in a0)]
    ab_keys = ("old_ms", "ms", "share", "old_share", "faster", "torch.gather_ms",
               "sliced_ms")
    for body, replaces, recs, batch in bodies:
        e = next(r for r in recs if r["batch"] == batch and not r["refused"]
                 and r["form"] in ("shared", "global"))
        key = body.replace("a0small n_rows=", "a0small ")
        taa.append(dict(
            name=f"take_along_probe {body}", kernel="take_along_probe", route="cuda",
            source=src + "hako_probes.cu", replaces=replaces,
            launches=total(recs, "take_along_launches"), max_abs_err=0.0, form=e["form"], batch=batch,
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"], shell_ms=e["shell_ms"],
            bytes=e["bytes"], cases=brief(recs, keys),
            **({"in_turns": ab_field(lambda key=key: {
                k: gp["ab"][key][k] for k in ab_keys if k in gp["ab"][key]})}
               if not AB or key in gp["ab"] else {})))
    if total(taa, "launches") != gp["launches"]["take_along_probe"]:
        raise AssertionError("phase 5d: the take-along bodies' launches do not add up")
    ohg_keys = ("ms", "ms_2k", "us_per_hop", "plain_ms", "library_ms", "library_host_bound_ms",
                "bound_ms", "bound_by", "latency_floor_ms", "refused", "launches", "cluster")
    ohg = gp["gather_probe3"]["ohg"]["cases"] + gp["gather_probe3"]["ohg1k"]["cases"]
    return taa + [
        dict(name="smem_alloc_probe", route="cuda", source=src + "hako_probes.cu",
             replaces="scripts/gather_probe3.py:101",
             launches=gp["launches"]["smem_alloc_probe"], max_abs_err=0.0, ms=cap["ms"],
             plain_ms=cap["plain_ms"], bound_ms=cap["bound_ms"], bound_by=cap["bound_by"],
             library_ms=None, optin_bytes=cap["optin_bytes"],
             largest_launched_bytes=cap["largest_launched_bytes"],
             first_refused_bytes=cap["first_refused_bytes"]),
        dict(name="ohg_probe", route="cuda", source=src + "hako_probes.cu",
             replaces="scripts/gather_probe3.py:147", launches=gp["launches"]["ohg_probe"],
             max_abs_err=0.0, ms=total(mma, "ms"), plain_ms=total(mma, "plain_ms"),
             bound_ms=total(mma, "bound_ms"), bound_by="operations",
             library_ms=total(mma, "library_ms"),
             library_host_bound_ms=total(mma, "library_host_bound_ms"),
             cases=brief(ohg, ohg_keys),
             in_turns=ab_field(lambda: {
                 f"{n} rows": {k: gp["ab"][f"ohg {n}"][k]
                               for k in ab_keys[:5] + ("torch.matmul_ms",
                                                       "torch.matmul host-bound_ms")}
                 for n in (128, 1024)})),
    ]


def shell_probe_launches(shell: dict) -> int:
    """The shell micro's kernel A launches (its real kernel A cases)."""
    return sum(r["launches"] for r in shell["cases"] if r["kernel"] == "hako_probe")


def shell_entry(shell: dict, kernel: str) -> dict:
    """A kernel's numbers summed over its shell-micro cases (the shell's
    library call: torch.add into a new output a call, as the kernel; its
    times into fixed outputs, the kernel's and torch.add's, under
    variants_ms)."""
    recs = [r for r in shell["cases"] if r["kernel"] == kernel]
    lib = [r["library_ms"] for r in recs if r["library_ms"] is not None]
    b_ms = sum(r["bound_ms"] for r in recs)
    variants = {}
    for r in recs:
        for label, ms in r["variants_ms"].items():
            variants[label] = variants.get(label, 0.0) + ms
    return dict(ms=sum(r["ms"] for r in recs), plain_ms=sum(r["plain_ms"] for r in recs),
                bound_ms=b_ms,
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in recs)
                else "operations",
                library_ms=sum(lib) if lib else None, variants_ms=variants,
                cases={r["name"]: {k: r[k] for k in ("ms", "us_per_block", "plain_ms",
                                                     "bound_ms", "library_ms",
                                                     "variants_ms")}
                       for r in recs})


def split_entries(sp: dict, src: str) -> list:
    """Phase 5c's kernels line entries: kernel A's shell, preamble and
    stages (the shell micro's 524,288 lanes, summed over each kernel's
    cases), and the row-cached kernel B on the lattice round's brick rows
    in the round's order (the uncached and sorted times beside it)."""
    out = []
    for name, replaces in (
            ("shell_copy_probe", "scripts/hako_shell_micro.py:64,78"),
            ("preamble_probe", "scripts/hako_shell_micro.py:102"),
            ("probe_stage_probe", "scripts/hako_shell_micro.py:200,287")):
        out.append(dict(name=name, route="cuda", source=src + "hako_probes.cu",
                        replaces=replaces, launches=sp["launches"][name], max_abs_err=0.0,
                        **shell_entry(sp["shell"], name)))
    # the stages in turns with aca9a3e's kernel (stage_ab)
    out[-1]["ab"] = ab_field(lambda: {k: v for k, v in sp["stage_ab"].items() if k != "pipe"})
    spl = sp["split"]
    u = spl["uniq"]
    ph = spl["phases"]
    rec = ph[f"B cached U={u}, round order"]
    rows = spl["rows"]
    from massivevoxelraytracing_torch.scripts import common

    b_ms, b_by = common.dda_bound(spl["lanes"], rows["round order"]["go_lanes"],
                                  rows["distinct_rows_round"])
    out.append(dict(
        name="hako_dda_cached", route="cuda", source=src + "hako_rounds.cu",
        replaces="scripts/r3_phase_split.py:212",
        launches=sp["round_launches"]["hako_dda_cached"], max_abs_err=0.0, ms=rec["ms"],
        plain_ms=rec["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
        row_cache=u, uncached_ms=ph["B rows, round order"]["ms"],
        sorted_ms=ph[f"B cached U={u}, sorted by row"]["ms"],
        sorted_uncached_ms=ph["B rows, sorted by row"]["ms"],
        sort_ms=ph["sort, gathers, scatter back"]["ms"], rows=rows,
        ab=ab_field(lambda: {
            k: sp["ab"][k] for k in ("round order", "sorted by row", "smem", "ptxas")})))
    return out


def split_round(sp: dict) -> dict:
    """Phase 5c's one lattice round (r3_phase_split, the top rung): on the
    device with the unfused and the fused stage, each beside its kernels'
    bytes bounds, and the host's wall of drive(max_rounds=1) for both."""
    from massivevoxelraytracing_torch.scripts import r3_phase_split as r3

    ph = sp["split"]["phases"]
    out = {}
    for key, name in (("device_unfused", r3.DEVICE_ROUND_UNFUSED),
                      ("device_fused", r3.DEVICE_ROUND_FUSED),
                      ("host_wall_unfused", r3.HOST_WALL_UNFUSED),
                      ("host_wall_fused", r3.HOST_WALL_FUSED)):
        out[key] = ph[name]["ms"]
        if "bound_ms" in ph[name]:
            out[key + "_bound"] = ph[name]["bound_ms"]
    return out


def slice_entry(sl: dict, prefix) -> dict:
    """A kernel's numbers on the JAX scripts' shape, summed over its cases
    (names starting with `prefix`, a string or a tuple of them): ms, plain
    ms, bound; the largest error over every shape."""
    recs = [r for r in sl["records"] if r["name"].startswith(prefix)]
    script = [r for r in recs if r["shape"] == "script"]
    ops = sum(r["issue_floor_ms"] for r in script)
    byt = sum(r["bytes_floor_ms"] for r in script)
    return dict(ms=sum(r["ms"] for r in script),
                plain_ms=sum(r["plain_ms"] for r in script),
                bound_ms=max(ops, byt), bound_by="operations" if ops >= byt else "bytes",
                max_abs_err=max(r["max_abs_err"] for r in recs),
                cases=sorted({r["name"] for r in recs}))


def pipe_entry(sl: dict, src: str) -> dict:
    """The pipe probe's kernels-line entry: its pairs at full occupancy and
    k repeats, summed (ms, plain ms, the larger of the issue and bytes
    floors), the launch count of phase 5b (the pairs, and the empty launches
    beside the script-shape cases), each class's rate."""
    pairs = sl["pipe"]["pairs"].values()
    ops = sum(r["issue_floor_ms"] for r in pairs)
    byt = sum(r["bytes_floor_ms"] for r in pairs)
    return dict(name="pipe_probe", route="cuda", source=src + "hako_probes.cu",
                replaces="scripts/hako_kernel_micro.py:188 (calibrate; the per-class rates "
                         "have no counterpart there)",
                launches=sl["launches"]["pipe_probe"], max_abs_err=0.0,
                ms=sum(r["ms_k"] for r in pairs), plain_ms=sum(r["plain_ms"] for r in pairs),
                bound_ms=max(ops, byt), bound_by="operations" if ops >= byt else "bytes",
                library_ms=None, rates=sl["pipe"]["rates"], pairs=len(sl["pipe"]["pairs"]))


def floors(counters: dict, n_rays: int, pr: dict) -> dict:
    """Time floors of a traversal of n_rays from its counters and the
    probes: the latency floor (each ray's row loads as a chain of
    dependent 16-byte hops at the one-chain hop time, over every thread
    the SMs can hold, 2048 each), from the hot (L2) and lattice (HBM)
    tables; and the walk floor (its walk64 calls at the walk probe's time
    per lane-walk over the whole card)."""
    hop = {c["table"]: c["ns_per_hop"] for c in pr["chase"]
           if c["mode"] == "16B" and c["chains"] == 1 and c["shape"] == "one warp an SM"}
    slots = pr["sms"] * 2048
    loads = counters["row_loads"]["mean"] * n_rays
    return dict(latency_floor_l2_ms=loads * hop["hot"] / slots * 1e-6,
                latency_floor_hbm_ms=loads * hop["lattice"] / slots * 1e-6,
                walk_floor_ms=counters["walks"]["mean"] * n_rays * pr["walk_ns"] * 1e-6)


def flag(argv: list, name: str) -> str:
    return argv[argv.index(name) + 1]


def app_launches(what: str, fn):
    """fn() with hako_mega's launch counter set to 0 just before it and
    read just after; the app must have launched the kernel."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_mega

    torch.cuda.synchronize()
    hako_mega.reset_counters()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = hako_mega.LAUNCHES
    if n < 1:
        raise AssertionError(f"{what} launched no hako_mega kernel")
    if hako_mega.unresolved_lanes():
        raise AssertionError(f"{what}: unresolved lanes")
    return out, n, wall


def phase_apps(smi: str, device: str = "cuda") -> dict:
    """Phase 6: rtcamp, voxrt and voxpt on `device` through main(argv)."""
    import torch

    from massivevoxelraytracing_torch.apps import rtcamp, voxpt, voxrt
    from massivevoxelraytracing_torch.models import pathtracer, scene
    from massivevoxelraytracing_torch.utils import hdr, png

    shutil.rmtree(APPS_OUT, ignore_errors=True)
    out = {}
    dev = ["--device", device]

    # rtcamp: keep the last frame's tree for the direct tracer
    kept = []
    real_build = scene.build_scene

    def build(*a, **k):
        kept[:] = [real_build(*a, **k)]
        CAPTURED["rtcamp"] = (a, k, kept[0])
        return kept[0]

    rt_dir = os.path.join(APPS_OUT, "rtcamp")
    scene.build_scene = build
    try:
        records, n, wall = app_launches(
            "rtcamp", lambda: rtcamp.main(RTCAMP_ARGV + dev + ["--out", rt_dir]))
    finally:
        scene.build_scene = real_build
    frames = []
    for r in records:
        st = r["build_stats"]
        frames.append(dict(frame=r["frame"], grid_res=r["grid_res"],
                           update_s=r["update_s"], render_s=r["render_s"],
                           n_voxels=st["n_unique"], n_triangles=st["n_triangles"],
                           split_s=st["t_split_s"], count_s=st["t_count_s"],
                           unique_s=st["t_unique_s"], accel_s=st["t_accel_s"]))
        print(f"[phase6] rtcamp frame {r['frame']}: grid {r['grid_res']}^3, "
              f"update {r['update_s']:.3f} s (split {st['t_split_s']:.3f}, count "
              f"{st['t_count_s']:.3f}, unique {st['t_unique_s']:.3f}, accel "
              f"{st['t_accel_s']:.3f}; {st['n_triangles']} triangles -> "
              f"{st['n_unique']} voxels), render {r['render_s']:.3f} s [{smi}]",
              flush=True)
    width, height = int(flag(RTCAMP_ARGV, "--width")), int(flag(RTCAMP_ARGV, "--height"))
    for r in records:
        img = png.read(os.path.join(rt_dir, f"{r['frame']:03d}.png"))
        if img.shape != (height, width, 3) or img.min() == img.max():
            raise AssertionError(f"rtcamp frame {r['frame']}: image {img.shape}, "
                                 f"values {img.min()}..{img.max()}")
    last = records[-1]
    pt = pathtracer.PathTracer(width=width, height=height, device=device)
    pt.setup()
    env = hdr.procedural_sky(512, 256)
    pt.load_hdri(env, env)
    pt.update_scene(kept[0])
    pt.clear_frame_buffer()
    for _ in range(int(flag(RTCAMP_ARGV, "--steps"))):
        pt.step(last["cam"])
    direct = pt.resolve()
    if not np.array_equal(direct, png.read(os.path.join(rt_dir, f"{last['frame']:03d}.png"))):
        raise AssertionError("rtcamp's last frame differs from the PathTracer driven directly")
    del kept[:], pt
    print(f"[phase6] rtcamp: {len(records)} frames in {wall:.1f} s, every PNG "
          f"{height}x{width}x3 and not constant, the last == PathTracer driven "
          f"directly bit for bit; {n} hako_mega launches [{smi}]", flush=True)
    out["rtcamp"] = dict(frames=frames, wall_s=wall, launches=n)

    # voxrt: the app itself fails past 2% disagreeing oracle pixels
    st, n, wall = app_launches("voxrt", lambda: voxrt.main(
        VOXRT_ARGV + dev + ["--out", os.path.join(APPS_OUT, "voxrt")]))
    print(f"[phase6] voxrt: build {st['build_s'] * 1e3:.1f} ms, frame "
          f"{st['render_s'] * 1e3:.3f} ms (first in its process), oracle "
          f"{st['oracle_agree']}/{st['oracle_checked']} pixels agree; {n} "
          f"hako_mega launches; {wall:.1f} s in all [{smi}]", flush=True)
    out["voxrt"] = dict(build_ms=st["build_s"] * 1e3, frame_ms=st["render_s"] * 1e3,
                        oracle_agree=st["oracle_agree"],
                        oracle_checked=st["oracle_checked"], wall_s=wall, launches=n)

    # voxpt: 3 steps + checkpoint, resume for a 4th == 4 uninterrupted steps
    # (at voxpt's default packet, the PathTracer's 2^21 lanes)
    vp = os.path.join(APPS_OUT, "voxpt")
    ck = os.path.join(vp, "ck.npz")
    _, n1, wall1 = app_launches("voxpt 3 steps", lambda: voxpt.main(
        VOXPT_ARGV + dev + ["--steps", "3", "--checkpoint", ck,
                            "--out", os.path.join(vp, "part")]))
    resumed, n2, wall2 = app_launches("voxpt resume", lambda: voxpt.main(
        VOXPT_ARGV + dev + ["--steps", "4", "--resume", ck,
                            "--out", os.path.join(vp, "part")]))
    with StepTimer() as timer:
        full, n3, wall3 = app_launches("voxpt 4 steps", lambda: voxpt.main(
            VOXPT_ARGV + dev + ["--steps", "4", "--out", os.path.join(vp, "full")]))
    if not torch.equal(resumed.accum, full.accum) or resumed.spp_done != 64:
        raise AssertionError("voxpt: resumed run differs from 4 uninterrupted steps")
    with open(os.path.join(vp, "part", "render_final.png"), "rb") as a, \
            open(os.path.join(vp, "full", "render_final.png"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("voxpt: resumed render_final.png differs")
    if not os.path.exists(os.path.join(vp, "full", "render_first.png")):
        raise AssertionError("voxpt wrote no render_first.png")
    step_ms = timer.ms
    # one step at EngineConfig's 65,536-lane packets and one at voxpt's
    # default (2^21): the accumulators bit for bit
    packet_ms, packet_acc = {}, {}
    for label, extra in (("ec_65536", ["--ray-packet", str(VOXPT_EC_PACKET)]),
                         ("default_2097152", [])):
        with StepTimer() as timer:
            run, n4, _wall = app_launches(f"voxpt {label}", lambda: voxpt.main(
                VOXPT_ARGV + extra + dev + ["--steps", "1",
                                            "--out", os.path.join(vp, label)]))
        packet_ms[label] = timer.ms[0]
        packet_acc[label] = run.accum
        if label == "default_2097152" and run.packet != pathtracer.RAY_PACKET:
            raise AssertionError(f"voxpt's default packet is {run.packet}")
    if not torch.equal(packet_acc["ec_65536"], packet_acc["default_2097152"]):
        raise AssertionError("voxpt: a step at 65,536-lane packets differs from one at "
                             "2^21")
    print(f"[phase6] voxpt 640x360 at 256^3: resume after 3 steps == 4 uninterrupted "
          f"steps bit for bit; steps at the default {pathtracer.RAY_PACKET}-lane packets "
          f"{', '.join(f'{x:.1f}' for x in step_ms)} ms (CUDA events; the 4-step "
          f"run {wall3:.1f} s in all); one step at EngineConfig's {VOXPT_EC_PACKET}-lane "
          f"packets {packet_ms['ec_65536']:.1f} ms, one at the default "
          f"{packet_ms['default_2097152']:.1f} ms, accumulators bit for bit; hako_mega "
          f"launches {n1} / {n2} / {n3} [{smi}]", flush=True)
    out["voxpt"] = dict(step_ms=step_ms, ec_packet_step_ms=packet_ms["ec_65536"],
                        default_packet_step_ms=packet_ms["default_2097152"],
                        wall_4_steps_s=wall3, launches=[n1, n2, n3])
    return out


# ---------------------------------------------------------------------------
# phase 7: the brick tree and the octree on the main scene, the streamed
# shell, the apps of slice 5
# ---------------------------------------------------------------------------

def tree_to(tree, device):
    """A copy of a tree (any structure) with every tensor on `device`."""
    import dataclasses

    import torch

    kw = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            v = tuple(x.to(device) for x in v)
        kw[f.name] = v
    return type(tree)(**kw)


def camera_rays(cam, width: int, height: int, device):
    """The tile-major rays render_frame traces for this camera
    (scripts/common.camera_rays)."""
    from massivevoxelraytracing_torch.scripts import common

    return common.camera_rays(cam, width, height, device)


def trace(tree, ro, rd, shadow: bool = False):
    from massivevoxelraytracing_torch.models import accel

    kind, depth, meta, root = accel.accel_args(tree)
    return accel.intersect_with(kind, depth, meta, root, tree.lower, tree.upper,
                                ro, rd, shadow=shadow)


def card_vs_cpu(tree, ro, rd, what: str) -> int:
    """The same traversal on the card and on a CPU copy of the tree: the
    discrete outputs must be equal. Returns the largest t difference in
    ulps (0 expected: the same ops in the same order)."""
    got = [x.cpu().numpy() for x in trace(tree, ro, rd)]
    want = [x.numpy() for x in trace(tree_to(tree, "cpu"), ro.cpu(), rd.cpu())]
    hit = want[0] < 1e37
    if not np.array_equal(got[0] < 1e37, hit):
        raise AssertionError(f"{what}: hit masks differ between card and CPU")
    for i, name in ((1, "nmajor"), (2, "vrank")):
        if not np.array_equal(got[i], want[i]):
            raise AssertionError(f"{what}: {name} differs between card and CPU")
    return int(np.abs(got[0][hit].view(np.int32).astype(np.int64)
                      - want[0][hit].view(np.int32)).max()) if hit.any() else 0


def walk_vs_plain(tree, ro, rd, shadow: bool, what: str) -> tuple:
    """The structure's walk kernel (through models/accel) against its plain
    walk on the same card tensors, bit for bit: (max |dt|, hits)."""
    from massivevoxelraytracing_torch.models import accel

    kind, depth, meta, root = accel.accel_args(tree)
    args = (kind, depth, meta, root, tree.lower, tree.upper, ro, rd)
    got = accel.intersect_with(*args, shadow=shadow)
    want = accel.intersect_with(*args, shadow=shadow, stages="plain")
    err = max_float_diff(got, want)
    assert_bits_equal(got, want, f"{what}: walk kernel vs plain walk")
    return err, int((want[0] < 1e37).sum())


WALK_OF = {"brick": "brick_walk", "octree": "octree_walk", "octree_nodag": "octree_walk"}


def cells_a_visit(reach: dict) -> dict:
    """What a walk tests, off common.walk_rows. The brick walk: the set
    bits a selection over the whole mask scans a visit, and the crossed and
    occupied cells the current one scans at most. The octree walk: the
    occupied octants a visit (what a scan of every occupied octant tests), the crossed and
    occupied ones, the plain walk's iterations and the kernel's loop trips
    a ray that enters, and the plain walk's decisions."""
    from massivevoxelraytracing_torch.ops import traverse2

    v = max(reach["visits"], 1)
    if "bits" in reach:
        return dict(bits_a_visit=reach["bits"] / v, cells_a_visit=reach["cells"] / v)
    rays = max(reach["entered"], 1)
    return dict(occupied_a_visit=reach["occupied"] / v, crossed_a_visit=reach["crossed"] / v,
                iterations_a_ray=reach["visits"] / rays, trips_a_ray=reach["trips"] / rays,
                fold={k: reach[k] for k in traverse2.FOLD_DECISIONS})


def cells_note(reach: dict) -> str:
    from massivevoxelraytracing_torch.scripts import common

    return "; " + common.visit_note(reach)


def phase_structures(hako_tree, cam, mega_img, device, smi: str, rng) -> dict:
    """Phase 7a: the bench lattice at 1024^3 as a brick tree and an octree
    (DAG on, then off), on the card: voxels, nodes, bytes, build; a 1080p
    frame through each (counted: its walk kernel and the frame's kernels
    launch), timed through the kernels and through stages="plain" (the
    eager walks); the walk kernel against the plain walk on all the
    frame's rays, bit for bit, each alone timed, with its bound (the rows
    the rays reach, read off the plain walk); every ray held against the
    megakernel's frame up to classified ties; 16,384 sampled rays on the
    card == on the CPU; one 16-spp PT step through the brick tree at
    640x360 (counted), its bounce-1 BSDF and NEE batches recorded and
    every structure's walk kernel held against its plain walk on them."""
    import torch

    from massivevoxelraytracing_torch.models import accel, pathtracer, raycast, scene
    from massivevoxelraytracing_torch.ops import hako, traverse
    from massivevoxelraytracing_torch.scripts import common
    from massivevoxelraytracing_torch.utils import meshgen
    from massivevoxelraytracing_torch.utils.tiecheck import classify_structures

    tri, cols = meshgen.sphere_lattice(6, 4)
    ro, rd = camera_rays(cam, WIDTH, HEIGHT, device)
    ro_np, rd_np = ro.cpu().numpy(), rd.cpu().numpy()
    mega = [x.cpu().numpy() for x in trace(hako_tree, ro, rd)]
    codes = hako.voxels_from_tree(hako_tree).astype(np.int64)
    idx = torch.as_tensor(np.sort(rng.choice(ro.shape[0], SAMPLE_RAYS, replace=False)),
                          device=device)
    out, trees, frame_launches = {}, {}, {}
    for name, kw in STRUCTURES:
        torch.cuda.synchronize()
        t0 = time.time()
        tree = scene.build_scene(tri, cols, origin=np.zeros(3, np.float32),
                                 dps=1.0 / GRID, grid_res=GRID, chunk_tris=262144,
                                 device=device, **kw)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        if tree.n_voxels != hako_tree.n_voxels:
            raise AssertionError(f"{name}: {tree.n_voxels} voxels, the hako build "
                                 f"{hako_tree.n_voxels}")
        # the main path: one frame, its kernels counted from 0
        traverse.reset_counters()
        raycast.reset_counters()
        img, depth = raycast.render_frame(tree, cam, WIDTH, HEIGHT, device=device)
        torch.cuda.synchronize()
        n = frame_launches[name] = {**traverse.LAUNCHES, **raycast.LAUNCHES}
        if n[WALK_OF[name]] != 1 or min(raycast.LAUNCHES.values()) != 1:
            raise AssertionError(f"{name} frame: launches {n}")
        (img, depth), frame_ms = timed(lambda: raycast.render_frame(
            tree, cam, WIDTH, HEIGHT, device=device), reps=TIMED_FRAMES)
        (p_img, p_depth), plain_frame_ms = timed(lambda: raycast.render_frame(
            tree, cam, WIDTH, HEIGHT, device=device, stages="plain"), reps=1)
        if not torch.equal(img, p_img) or not torch.equal(depth, p_depth):
            raise AssertionError(f"{name}: the frame differs between the routes")
        # the walk alone on every frame ray, kernel vs plain
        err, hits = walk_vs_plain(tree, ro, rd, False, f"{name} 1080p frame")
        kind, depth_, meta, root = accel.accel_args(tree)
        plain_args = (kind, depth_, meta, root, tree.lower, tree.upper, ro, rd)
        got, walk_ms = timed(lambda: trace(tree, ro, rd), reps=TIMED_FRAMES)
        _, walk_plain_ms = timed(lambda: accel.intersect_with(*plain_args, stages="plain"),
                                 reps=1, warm=False)
        reach = common.walk_rows(*plain_args[:6], ro, rd)
        entered, rows, visits = reach["entered"], reach["rows"], reach["visits"]
        b_ms, b_by = common.walk_bound(kind, ro.shape[0], rows, visits)
        got = [x.cpu().numpy() for x in got]
        kinds = classify_structures(*mega, *got, codes, (0.0, 0.0, 0.0), 1.0 / GRID,
                                    1.0, ro_np, rd_np)
        n_tie = sum(kinds.values())
        n_px = int((img != mega_img).any(-1).sum())
        if n_tie > TIE_SHARE * ro.shape[0] or n_px > n_tie:
            raise AssertionError(f"{name}: {kinds} classified, {n_px} pixels differ")
        max_ulp = card_vs_cpu(tree, ro[idx], rd[idx], f"{name} sample")
        st = tree.build_stats
        out[name] = dict(n_voxels=tree.n_voxels, n_nodes=tree.n_nodes,
                         bytes=tree.memory_bytes(), build_s=build_s,
                         accel_s=st["t_accel_s"], frame_ms=frame_ms,
                         plain_frame_ms=plain_frame_ms, walk_ms=walk_ms,
                         walk_plain_ms=walk_plain_ms, bound_ms=b_ms, bound_by=b_by,
                         share=b_ms / walk_ms, rays=int(ro.shape[0]), entered=entered,
                         rows=rows, visits=visits, hits=hits, max_abs_err=err,
                         classified=kinds, pixels_differ=n_px, sample_max_ulp=max_ulp,
                         frame_launches=n, **cells_a_visit(reach))
        print(f"[phase7] {name} {GRID}^3 lattice: {tree.n_voxels} voxels, "
              f"{tree.n_nodes} nodes, {tree.memory_bytes()} bytes; build "
              f"{build_s:.3f} s (accel {st['t_accel_s'] * 1e3:.1f} ms); frame "
              f"{WIDTH}x{HEIGHT} {frame_ms:.3f} ms through the kernels (mean of "
              f"{TIMED_FRAMES}) vs {plain_frame_ms:.1f} ms through the plain walk and "
              f"stages, images equal; launches {n}; vs the megakernel "
              f"frame, of {ro.shape[0]} rays: {kinds['tie']} ties, {kinds['graze']} "
              f"grazes, {kinds['drift']} plane drifts (classified), {n_px} "
              f"pixels differ; {SAMPLE_RAYS} sampled rays card == CPU (t max "
              f"ulp {max_ulp}) [{smi}]", flush=True)
        print(f"[phase7] {WALK_OF[name]} kernel == plain walk bit for bit on the "
              f"{ro.shape[0]} frame rays ({hits} hits, {entered} entering): "
              f"{walk_ms:.3f} ms vs plain walk on the card {walk_plain_ms:.1f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {rows} distinct rows, {visits} visits), "
              f"share {b_ms / walk_ms:.1%}{cells_note(reach)} [{smi}]", flush=True)
        trees[name] = tree
        del img, depth, p_img, p_depth

    # one 16-spp PT step through the brick tree and one through the octree
    # (DAG) (their walks counted, their bounce-1 BSDF and NEE batches
    # recorded), and the same step through the megakernel for its mean, at
    # a frame cut to 640x360
    means, calls = {}, {"brick": [], "octree": []}
    real = accel.intersect_with

    def recording(into):
        def call(*a, **k):
            if len(into) < 5:
                into.append((a[6], a[7], k.get("shadow", False)))
            return real(*a, **k)
        return call

    for name, tree in (("brick", trees["brick"]), ("octree", trees["octree"]),
                       ("hako", hako_tree)):
        pt = pathtracer.PathTracer(width=PT7_W, height=PT7_H, device=device)
        pt.setup()
        pt.load_hdri(bench_sky())
        pt.update_scene(tree)
        torch.cuda.synchronize()
        traverse.reset_counters()
        if name in calls:
            accel.intersect_with = recording(calls[name])
        try:
            t0 = time.time()
            pt.step(cam)
            torch.cuda.synchronize()
            step_s = time.time() - t0
        finally:
            accel.intersect_with = real
        note = ""
        if name in calls:
            walk = WALK_OF[name]
            out[f"pt_{name}_launches"] = traverse.LAUNCHES[walk]
            if out[f"pt_{name}_launches"] < 1:
                raise AssertionError(f"the {name} PT step launched no {walk} kernel")
            note = f", {walk} launches {out[f'pt_{name}_launches']}"
        if not bool(torch.isfinite(pt.accum).all()):
            raise AssertionError(f"{name} PT step: non-finite radiance")
        means[name] = float(pt.accum[:, :3].mean())
        out[f"pt_{name}_s"] = step_s
        print(f"[phase7] PT {name} {PT7_W}x{PT7_H} 16 spp: {step_s:.3f} s/step, "
              f"mean radiance {means[name]:.6f}{note} [{smi}]", flush=True)
        del pt
    for name in calls:
        rel = abs(means[name] - means["hako"]) / means["hako"]
        if rel > PT_MEAN_RTOL:
            raise AssertionError(f"{name} PT mean {means[name]} vs hako {means['hako']}")
    out["pt_mean"] = means

    def bounce1(recorded):
        (ro_b, rd_b, sb), (ro_s, rd_s, ss) = recorded[3], recorded[4]
        if sb or not ss:
            raise AssertionError("recorded batches are not BSDF then NEE")
        return (("BSDF", ro_b, rd_b, False), ("NEE", ro_s, rd_s, True))

    # every structure on the brick step's batches; the octree (DAG) also on
    # its own step's
    runs = [(name, tree, "", "the brick PT step's", bounce1(calls["brick"]))
            for name, tree in trees.items()]
    runs.append(("octree", trees["octree"], "pt_step_", "the octree PT step's",
                 bounce1(calls["octree"])))
    for name, tree, prefix, whose, batches in runs:
        kind, depth_, meta, root = accel.accel_args(tree)
        for label, r_o, r_d, shadow in batches:
            err, hits = walk_vs_plain(tree, r_o, r_d, shadow, f"{name} {whose} bounce-1 {label}")
            _, ms = timed(lambda: trace(tree, r_o, r_d, shadow), reps=TIMED_FRAMES)
            reach = common.walk_rows(kind, depth_, meta, root, tree.lower, tree.upper, r_o, r_d,
                                     shadow=shadow)
            b_ms, b_by = common.walk_bound(kind, r_o.shape[0], reach["rows"], reach["visits"],
                                           shadow=shadow)
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
            out[name][f"{prefix or 'pt_'}{label}"] = dict(
                rays=int(r_o.shape[0]), hits=hits, ms=ms, bound_ms=b_ms, bound_by=b_by,
                share=b_ms / ms, visits=reach["visits"], rows=reach["rows"],
                **cells_a_visit(reach))
            print(f"[phase7] {WALK_OF[name]} ({name}) == plain walk bit for bit on {whose} "
                  f"bounce-1 {label} batch ({r_o.shape[0]} lanes, {hits} hits, "
                  f"shadow {shadow}): {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
                  f"{reach['rows']} distinct rows, {reach['visits']} visits), share "
                  f"{b_ms / ms:.1%}{cells_note(reach)} [{smi}]", flush=True)
    del trees
    torch.cuda.empty_cache()
    return out


def phase_shell(device, smi: str, rng) -> dict:
    """Phase 7b: the terrain shell through the streamed build; park="device"
    == park="host" at 2048^3; apps/scale_shell.py at SHELL_RES (n_voxels ==
    the column pass, a 1920x1088 frame); hako_mega on the shell frame, its
    bytes bound, and the kernel against its plain version on 16,384
    sampled frame rays."""
    import torch

    from massivevoxelraytracing_torch.apps import scale_shell
    from massivevoxelraytracing_torch.ops import hako_mega, hako_stream
    from massivevoxelraytracing_torch.scripts import common
    from massivevoxelraytracing_torch.utils import png, shellgen

    terrain = shellgen.Terrain(PARK_RES, device=device)
    on_dev = hako_stream.build_hako_stream(terrain.chunks(), PARK_RES, park="device")
    on_host = hako_stream.build_hako_stream(terrain.chunks(), PARK_RES, park="host")
    assert_bits_equal([x for x in (on_dev.bricks, on_dev.snodes, *on_dev.levels)
                       if x is not None],
                      [x for x in (on_host.bricks, on_host.snodes, *on_host.levels)
                       if x is not None], f"{PARK_RES}^3 shell, park device vs host")
    if (on_dev.n_voxels, on_dev.root_mask_lo, on_dev.root_mask_hi) != (
            on_host.n_voxels, on_host.root_mask_lo, on_host.root_mask_hi):
        raise AssertionError("park device vs host: counts or root differ")
    print(f"[phase7] shell {PARK_RES}^3: park device == park host bit for bit "
          f"({on_dev.n_voxels} voxels, {on_dev.n_bricks} bricks)", flush=True)
    del on_dev, on_host
    torch.cuda.empty_cache()

    path = os.path.join(APPS_OUT, "scale_shell.png")
    torch.cuda.synchronize()
    hako_mega.reset_counters()
    st = scale_shell.main(["--res", str(SHELL_RES), "--a1", str(SHELL_A1),
                           "--width", str(SHELL_W), "--height", str(SHELL_H),
                           "--device", str(device), "--out", path])
    torch.cuda.synchronize()
    launches = hako_mega.LAUNCHES
    if launches < 1 or hako_mega.unresolved_lanes():
        raise AssertionError(f"shell frame: {launches} launches, unresolved lanes")
    tree = st["tree"]
    img = png.read(path)
    if img.shape != (SHELL_H, SHELL_W, 3) or img.min() == img.max():
        raise AssertionError(f"shell PNG {img.shape}, values {img.min()}..{img.max()}")
    ro, rd = camera_rays(st["cam"], SHELL_W, SHELL_H, device)
    args, T = tree_args(tree, ro, rd, device)
    _, kernel_ms = timed(lambda: hako_mega.intersect_rays_hako_mega(*args, T=T))
    fb = common.frame_bound(tree, ro, rd)
    sb, distinct, visits = (fb["bound_ms"], fb["bound_by"]), fb["distinct_rows"], fb["row_visits"]
    idx = torch.as_tensor(np.sort(rng.choice(ro.shape[0], SAMPLE_RAYS, replace=False)),
                          device=device)
    chk, k_ms, p_ms = kernel_vs_plain(tree, ro[idx], rd[idx], False,
                                      f"{SHELL_RES}^3 shell frame sample", device)
    out = dict(res=SHELL_RES, n_voxels=tree.n_voxels, analytic=st["analytic"],
               n_bricks=tree.n_bricks, n_snodes=tree.n_snodes,
               levels=list(tree.n_per_level), T=tree.T, build_s=st["build_s"],
               rows_gb=st["rows_bytes"] / 1e9, peak_gib=(st["peak_bytes"] or 0) / 2**30,
               frame_ms=st["frame_ms"], hit=st["hit"], launches=launches,
               kernel_ms=kernel_ms, bound_ms=sb[0], bound_by=sb[1],
               rows=(distinct, visits), max_abs_err=chk["max_abs_err"],
               sample_hits=chk["hits"])
    print(f"[phase7] shell {SHELL_RES}^3 (T={tree.T}, {tree.n_snodes} supernodes, "
          f"levels {tree.n_per_level}): {tree.n_voxels} voxels == the column pass, "
          f"{tree.n_bricks} bricks, rows {out['rows_gb']:.3f} GB; streamed build "
          f"{st['build_s']:.1f} s (park device), peak {out['peak_gib']:.2f} GiB; "
          f"frame {SHELL_W}x{SHELL_H} {st['frame_ms']:.2f} ms (mean of 4, hit "
          f"{st['hit']:.3f}), hako_mega {kernel_ms:.3f} ms on its {ro.shape[0]} "
          f"rays (bound {sb[0]:.4f} ms, {sb[1]}; {distinct} distinct rows, {visits} "
          f"visits), {launches} launches; kernel == plain on {chk['n']} sampled rays "
          f"({chk['hits']} hits, max |dt| {chk['max_abs_err']:.3g}; kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.1f} ms) [{smi}]", flush=True)
    del st, tree, args
    torch.cuda.empty_cache()
    return out


def phase_apps7(smi: str, device: str = "cuda") -> dict:
    """Phase 7c: voxrt through the brick tree and the octree (the app fails
    past 2% disagreeing oracle pixels), voxmesh (the PLY read back) and
    voxtriangle (the PNG read back)."""
    import torch

    from massivevoxelraytracing_torch.apps import voxmesh, voxrt, voxtriangle
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.utils import png

    out = {}
    dev = ["--device", device]
    for name, extra in (("voxrt_brick", ["--accel", "brick"]),
                        ("voxrt_octree", ["--accel", "octree", "--dag", "1"])):
        torch.cuda.synchronize()
        hako_mega.reset_counters()
        t0 = time.time()
        st = voxrt.main(VOXRT7_ARGV + extra + dev
                        + ["--out", os.path.join(APPS_OUT, name)])
        wall = time.time() - t0
        out[name] = dict(build_ms=st["build_s"] * 1e3, frame_ms=st["render_s"] * 1e3,
                         n_nodes=st["n_nodes"], bytes=st["accel_bytes"],
                         oracle_agree=st["oracle_agree"],
                         oracle_checked=st["oracle_checked"], wall_s=wall,
                         hako_mega_launches=hako_mega.LAUNCHES)
        print(f"[phase7] {name}: build {st['build_s'] * 1e3:.1f} ms, frame "
              f"{st['render_s'] * 1e3:.1f} ms, {st['n_nodes']} nodes, oracle "
              f"{st['oracle_agree']}/{st['oracle_checked']} pixels agree; "
              f"{wall:.1f} s in all [{smi}]", flush=True)
    ply = os.path.join(APPS_OUT, "voxmesh", "voxels.ply")
    t0 = time.time()
    st = voxmesh.main(dev + ["--out", ply])
    with open(ply, "rb") as f:
        head = f.read(4096).split(b"end_header")[0].decode()
    n_vert = int(head.split("element vertex ")[1].split()[0])
    if n_vert <= 0:
        raise AssertionError("voxmesh wrote no vertices")
    out["voxmesh"] = dict(n_voxels=st["n_voxels"], vertices=n_vert,
                          wall_s=time.time() - t0)
    t0 = time.time()
    st = voxtriangle.main(dev + ["--out", os.path.join(APPS_OUT, "voxtriangle")])
    img = png.read(st["path"])
    if img.min() == img.max():
        raise AssertionError("voxtriangle wrote a constant PNG")
    out["voxtriangle"] = dict(counts=st["counts"], shape=list(img.shape),
                              wall_s=time.time() - t0)
    print(f"[phase7] voxmesh: {out['voxmesh']['n_voxels']} voxels -> {n_vert} PLY "
          f"vertices; voxtriangle: {st['counts']} voxels, PNG {img.shape} not "
          f"constant [{smi}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8: the multi-device layer on the one card (parallel/, dcn_frames,
# --build-devices, the entry points)
# ---------------------------------------------------------------------------

def camera_args(cam, device) -> tuple:
    """(cam_o, cam_right, cam_up, cam_front, tan_half_fovy) as f32 tensors."""
    import torch

    return (*(torch_from(np.asarray(v, np.float32), device)
              for v in (cam.o, cam.right, cam.up, cam.front)),
            torch.tensor(np.float32(cam.tan_half_fovy), device=device))


def counted(fn, kernels: tuple):
    """fn() with the named kernels' counts set to 0 just before it and read
    just after: (result, {kernel: launches}, host seconds)."""
    import torch

    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega

    torch.cuda.synchronize()
    hako_mega.reset_counters()
    hk.reset_counters()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = {k: hako_mega.LAUNCHES if k == "hako_mega" else hk.LAUNCHES[k]
           for k in kernels}
    if min(got.values()) < 1:
        raise AssertionError(f"a kernel of {kernels} was not launched: {got}")
    if hako_mega.unresolved_lanes() or hk.unresolved_lanes():
        raise AssertionError("unresolved lanes")
    return out, got, wall


def phase_parallel_build(tree, device, smi: str) -> dict:
    """Phase 8a: the lattice built over 2 and 8 shards on the one card,
    each bit for bit phase 3's tree; build_scene once more beside them for
    its peak memory."""
    import torch

    from massivevoxelraytracing_torch.entry import trees_equal
    from massivevoxelraytracing_torch.models import scene
    from massivevoxelraytracing_torch.parallel import build as pbuild
    from massivevoxelraytracing_torch.utils import meshgen

    tri, cols = meshgen.sphere_lattice(6, 4)
    kw = dict(origin=np.zeros(3, np.float32), dps=1.0 / GRID, grid_res=GRID,
              accel="hako", chunk_tris=262144, device=device)
    out = {}
    for label, build in (
            ("build_scene", lambda: scene.build_scene(tri, cols, **kw)),
            ("sharded_2", lambda: pbuild.build_scene_sharded(tri, cols, n_devices=2, **kw)),
            ("sharded_8", lambda: pbuild.build_scene_sharded(tri, cols, n_devices=8, **kw))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        built = build()
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        if not trees_equal(built, tree):
            raise AssertionError(f"phase 8a: the {label} tree differs from phase 3's")
        st = built.build_stats
        out[label] = dict(wall_s=wall, split_s=st["t_split_s"], count_s=st["t_count_s"],
                          unique_s=st["t_unique_s"], accel_s=st["t_accel_s"],
                          peak_gib=peak, n_voxels=built.n_voxels,
                          n_dumped=st["n_dumped"], n_devices=st.get("n_devices", 1))
        print(f"[phase8] {label}: {built.n_voxels} voxels, every field == phase 3's "
              f"tree; {wall:.3f} s (split {st['t_split_s'] * 1e3:.1f} ms, count "
              f"{st['t_count_s'] * 1e3:.1f} ms, unique {st['t_unique_s'] * 1e3:.1f} ms, "
              f"accel {st['t_accel_s'] * 1e3:.1f} ms), {st['n_dumped']} dumped, peak "
              f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB already held [{smi}]",
              flush=True)
        del built
    return out


def phase_parallel(tree, cam, img, depth, pt, device, smi: str) -> dict:
    """Phase 8: this slice's path on the one card, each part through the
    entry points a user calls, each part's kernels counted around it."""
    import argparse
    import contextlib
    import io

    import torch

    from massivevoxelraytracing_torch import entry
    from massivevoxelraytracing_torch.apps import dcn_frames, rtcamp
    from massivevoxelraytracing_torch.models import accel, raycast
    from massivevoxelraytracing_torch.ops import hako_kernels as hk
    from massivevoxelraytracing_torch.ops import hako_mega
    from massivevoxelraytracing_torch.parallel import bigscene
    from massivevoxelraytracing_torch.parallel import mesh as pmesh
    from massivevoxelraytracing_torch.parallel import render as prender
    from massivevoxelraytracing_torch.parallel.render import _on
    from massivevoxelraytracing_torch.scripts import common

    t_phase = time.time()
    part_s = {}

    def lap(part):
        part_s[part] = time.time() - t_phase - sum(part_s.values())

    out = {"build": phase_parallel_build(tree, device, smi)}
    lap("build")
    launches = {}
    kind, T, meta, root = accel.accel_args(tree)
    cam_t = camera_args(cam, device)

    # 8b: the 1080p frame over 8 bands
    render = prender.make_sharded_render(pmesh.make_mesh(8, device=device),
                                         width=WIDTH, height=HEIGHT, kind=kind, depth=T)
    args = (meta, root, tree.lower, tree.upper, raycast._color_table(tree), *cam_t)
    render(*args)
    raycast.reset_counters()
    (img8, depth8), n, _ = counted(lambda: render(*args), ("hako_mega",))
    if raycast.LAUNCHES != dict.fromkeys(raycast.KERNELS, 8):
        raise AssertionError(f"phase 8b: frame kernels {raycast.LAUNCHES}, not 8 each")
    launches["frame"] = n
    _, frame_ms = timed(lambda: render(*args), reps=TIMED_FRAMES)
    if not torch.equal(img8, img) or not torch.equal(depth8, depth):
        raise AssertionError("phase 8b: the sharded frame differs from phase 3's")
    if n["hako_mega"] != 8:
        raise AssertionError(f"phase 8b: {n['hako_mega']} hako_mega launches, not 8")
    print(f"[phase8] sharded frame {WIDTH}x{HEIGHT} over 8 bands: image and depth == "
          f"phase 3's bit for bit; {frame_ms:.3f} ms (mean of {TIMED_FRAMES}), "
          f"hako_mega launches {n['hako_mega']} [{smi}]", flush=True)
    out["frame"] = dict(ms=frame_ms, launches=n["hako_mega"])
    lap("frame")

    # 8c: the 16-spp step over dp 2 x sp 4, 4 spp an entry
    mesh = pmesh.make_mesh(8, device=device)
    dp, sp = mesh.devices.shape
    spd = 16 // sp
    n_pix = WIDTH * HEIGHT
    step = prender.make_sharded_pt_step(
        mesh, stack_depth=T, spp_per_device=spd, width=WIDTH, height=HEIGHT,
        n_pixels=n_pix, has_emission=tree.has_emission,
        hdri_enabled=pt["env"].scale > 0, accel_kind=kind)
    zero_i = torch.zeros(1, dtype=torch.int32, device=device)

    def f32(v):
        return torch.tensor(np.float32(v), device=device)

    step_args = (meta, root, tree.lower, tree.upper,
                 tree.color if tree.color is not None else zero_i,
                 tree.emission if tree.emission is not None else zero_i,
                 pt["pmj"], pt["env"], *cam_t[:4], f32(cam.tan_half_fovy),
                 f32(cam.lens_r), f32(cam.focus))

    def one_step():
        return step(*step_args, torch.zeros((n_pix, 4), dtype=torch.float32,
                                            device=device), 0)

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    acc, n, first_s = counted(one_step, ("hako_mega",))
    peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    launches["pt_step"] = n
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    again = one_step()
    stop.record()
    torch.cuda.synchronize()
    step_s = start.elapsed_time(stop) / 1e3
    prof = common.profile_or_none(one_step, common.step_counts(),
                                  "[phase8] profiled sharded step", smi)
    want = pt["first_accum"]
    if not torch.equal(acc, again):
        raise AssertionError("phase 8c: two sharded steps from zero differ")
    if not torch.equal(acc[:, 3], want[:, 3]) or not bool((acc[:, 3] == 16).all()):
        raise AssertionError("phase 8c: sample counts differ")
    if not bool(torch.isfinite(acc).all()):
        raise AssertionError("phase 8c: non-finite radiance")
    diff = (acc[:, :3] - want[:, :3]).abs()
    rel = float((diff / want[:, :3].abs().clamp(min=1e-30)).max())
    if not torch.allclose(acc[:, :3], want[:, :3], rtol=2e-5, atol=2e-5):
        raise AssertionError(f"phase 8c: accumulator outside rtol 2e-5 / atol 2e-5 "
                             f"(max |diff| {float(diff.max())})")
    mean, mean1 = float(acc[:, :3].mean()), float(want[:, :3].mean())
    if abs(mean / mean1 - 1) > 0.01:
        raise AssertionError(f"phase 8c: mean {mean} vs {mean1}")
    lanes = n_pix // dp * spd
    print(f"[phase8] sharded PT step {WIDTH}x{HEIGHT} 16 spp over dp={dp} x sp={sp} "
          f"({spd} spp an entry, {dp * sp} calls of {lanes} lanes): {step_s:.3f} s/step "
          f"(CUDA events; first {first_s:.3f} s host clock), accumulator within rtol "
          f"2e-5 of phase 4's single-device step (max |diff| {float(diff.max()):.3g}, "
          f"max rel {rel:.3g}, {int((diff > 0).sum())} of {diff.numel()} values "
          f"differ), mean {mean:.4f} vs {mean1:.4f}; peak {peak:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB already held; hako_mega launches "
          f"{n['hako_mega']} [{smi}]", flush=True)
    out["pt_step"] = dict(s_per_step=step_s, first_s=first_s, peak_gib=peak,
                          max_abs_diff=float(diff.max()), max_rel_diff=rel,
                          mean=mean, single_mean=mean1, launches=n["hako_mega"],
                          lanes_per_call=lanes, profile="not measured")
    if prof is not None:
        print(f"[phase8] profiled sharded step: wall {prof['wall_ms']:.1f} ms, device busy "
              f"{prof['busy_ms']:.1f} ms in {prof['kernels']} device kernels, idle share "
              f"{prof['idle_share']:.3f}, hako_mega kernels {prof['mega_ms']:.1f} ms (every "
              f"counted launch traced, try {prof['tries']}) [{smi}]", flush=True)
        out["pt_step"].update(busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                              idle_share=prof["idle_share"], mega_ms=prof["mega_ms"],
                              device_kernels=prof["kernels"], profile_tries=prof["tries"])
        del out["pt_step"]["profile"]
    del acc, again, want
    lap("pt_step")

    # 8d: the lattice's tree as 4 brick-range shards, the frame's rays
    shards = bigscene.shard_hako_tree(tree, 4)
    ro, rd = camera_rays(cam, WIDTH, HEIGHT, device)
    ref = hk.intersect_hako(tree, ro, rd)
    ref_shadow = hk.intersect_hako(tree, ro, rd, shadow=True)[0]
    assert_bits_equal(ref, hako_mega.intersect_hako_mega(tree, ro, rd),
                      "phase 8d: the whole tree through hako_rounds vs hako_mega")
    ref_img, ref_t = raycast.render_rays(tree, ro, rd)

    def sharded_all():
        return (bigscene.intersect_sharded(shards, ro, rd),
                bigscene.intersect_sharded(shards, ro, rd, shadow=True)[0],
                bigscene.render_rays_sharded(shards, ro, rd))

    chk = CheckedStage()
    with route_driver(hk.hako_probe, chk):
        checked = bigscene.intersect_sharded(shards, ro, rd)
    (prim, shadow_t, (simg, st_)), n, big_s = counted(sharded_all, hk.ROUTE_KERNELS)
    launches["bigscene"] = n
    big_calls = 3 * len(shards)  # primary, shadow and shading, a call a shard
    check_route_launches(dict(hk.LAUNCHES), big_calls, "phase 8d")
    big_rounds = hk.rounds_run()
    assert_bits_equal(checked, prim, "phase 8d: two-launch checked stage vs counted run")
    t, nmaj, vidx, win = prim
    hit = ref[0] < 1e37
    if not torch.equal(t < 1e37, hit) or not torch.equal(shadow_t < 1e37,
                                                           ref_shadow < 1e37):
        raise AssertionError("phase 8d: hit sets differ from the whole tree's")
    if not torch.allclose(t[hit], ref[0][hit], rtol=1e-6, atol=0):
        raise AssertionError("phase 8d: t outside rtol 1e-6")
    if not torch.equal(nmaj[hit], ref[1][hit]) or not torch.equal(vidx[hit], ref[2][hit]):
        raise AssertionError("phase 8d: nmajor or global voxel index differ")
    if not torch.equal(simg, ref_img) or not torch.equal(st_, ref_t):
        raise AssertionError("phase 8d: sharded shading differs from render_rays")
    winners = torch.bincount(win[hit], minlength=len(shards)).tolist()
    if sum(1 for w in winners if w) < 2:
        raise AssertionError(f"phase 8d: hits won by one shard only {winners}")
    def primary_two():
        with two_launch_route():
            return bigscene.intersect_sharded(shards, ro, rd)

    hk.reset_counters()
    _, big_syncs = host_syncs(lambda: bigscene.intersect_sharded(shards, ro, rd))
    big_rounds_primary = hk.rounds_run()
    hk.reset_counters()
    two_out, two_syncs = host_syncs(primary_two)
    two_big = {k: v for k, v in hk.LAUNCHES.items() if v}
    check_two_launches(dict(hk.LAUNCHES), big_rounds_primary, "phase 8d, two-launch driver")
    assert_bits_equal(two_out, prim, "phase 8d: two-launch driver vs hako_rounds")
    big_turns = in_turns({"hako_rounds": lambda: bigscene.intersect_sharded(shards, ro, rd),
                          "two_launch": primary_two})
    big_ms = min(big_turns["hako_rounds"])
    exact_t = bool(torch.equal(t, ref[0]))
    per_shard = [dict(bricks=sh.n_bricks, voxels=sh.n_voxels, bytes=sh.memory_bytes(),
                      voxel_base=sh.voxel_base) for sh in shards]
    print(f"[phase8] bigscene: 4 shards of {tree.n_bricks} bricks / {tree.n_voxels} "
          f"voxels / {tree.memory_bytes()} B: " + "; ".join(
              f"{p['bricks']} bricks, {p['voxels']} voxels, {p['bytes']} B"
              for p in per_shard) + f" [{smi}]", flush=True)
    print(f"[phase8] bigscene on {ro.shape[0]} frame rays: hit sets (primary and "
          f"shadow), nmajor and global voxel index == the whole tree's, t "
          f"{'bit-equal' if exact_t else 'within rtol 1e-6'}, shading == render_rays; "
          f"hits won by shard {winners}; through the two-launch driver hako_dda_merge == "
          f"its plain version at each of {chk.calls} calls; primary frame in turns (CUDA "
          f"events, mean of 2 each): hako_rounds {big_turns['hako_rounds']} ms, the "
          f"two-launch driver {big_turns['two_launch']} ms, bit-equal; a primary frame: "
          f"{len(shards)} hako_rounds "
          f"launches, {big_rounds_primary} rounds, host syncs {big_syncs} (two-launch: "
          f"launches {two_big}, host syncs {two_syncs}); primary + shadow + shading "
          f"{big_s:.3f} s host clock, {big_rounds} rounds; launches {n} [{smi}]", flush=True)
    out["bigscene"] = dict(shards=per_shard, ms=big_ms, ms_turns=big_turns,
                           all_s=big_s, winners=winners,
                           t_bit_equal=exact_t, launches=n, rounds=big_rounds,
                           rounds_primary=big_rounds_primary, host_syncs=big_syncs,
                           two_launch=dict(launches=two_big, host_syncs=two_syncs),
                           checked_calls=chk.calls, whole_bytes=tree.memory_bytes())
    del shards, ro, rd, ref, ref_shadow, ref_img, ref_t, prim, shadow_t, simg, st_
    del checked
    lap("bigscene")

    # 8e: dcn_frames, 2 processes on the card, against one process
    torch.cuda.empty_cache()
    dcn_out = os.path.join(APPS_OUT, "dcn")
    shutil.rmtree(dcn_out, ignore_errors=True)
    dcn_kw = dict(scene="bumpy", frames=4, res=128, width=320, height=200)
    argv = ["--procs", "2", "--device", str(device.type), "--out", dcn_out]
    for k, v in dcn_kw.items():
        argv += [f"--{k}", str(v)]
    t0 = time.time()
    job = dcn_frames.main(argv)
    dcn_s = time.time() - t0
    sums = dcn_frames.render_frames(argparse.Namespace(out=None, **dcn_kw), 0, 4, device)
    want_sum = dcn_frames.checksum(sums)
    if job != dict(frames=4, checksum=want_sum):
        raise AssertionError(f"phase 8e: dcn job {job} != one process {want_sum}")
    if sorted(os.listdir(dcn_out)) != [f"{i:03d}.png" for i in range(4)]:
        raise AssertionError("phase 8e: dcn frames missing")
    print(f"[phase8] dcn_frames: 2 processes on the card, 4 frames of bumpy at "
          f"128^3 / 320x200 in {dcn_s:.1f} s (spawn included); depth checksum "
          f"{job['checksum']!r} == one process's [{smi}]", flush=True)
    out["dcn"] = dict(wall_s=dcn_s, checksum=job["checksum"], frames=job["frames"])
    lap("dcn")

    # 8f: rtcamp --build-devices 2, the last frame of phase 6's run
    fr = RTCAMP_ARGV.index("--frame-range")
    last = int(RTCAMP_ARGV[fr + 2]) - 1
    argv = (RTCAMP_ARGV[:fr] + ["--frame-range", str(last), str(last + 1)]
            + RTCAMP_ARGV[fr + 3:] + ["--build-devices", "2", "--device",
                                      str(device.type), "--out",
                                      os.path.join(APPS_OUT, "rtcamp_bd2")])
    rec, n, rt_s = counted(lambda: rtcamp.main(argv), ("hako_mega",))
    launches["rtcamp"] = n
    name = f"{last:03d}.png"
    with open(os.path.join(APPS_OUT, "rtcamp", name), "rb") as a, \
            open(os.path.join(APPS_OUT, "rtcamp_bd2", name), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("phase 8f: --build-devices 2 PNG differs")
    if rec[0]["build_stats"]["n_devices"] != 2:
        raise AssertionError("phase 8f: the build was not sharded")
    print(f"[phase8] rtcamp --build-devices 2, frame {last}: PNG == phase 6's byte for "
          f"byte; build {rec[0]['update_s']:.3f} s, {rt_s:.1f} s in all; hako_mega "
          f"launches {n['hako_mega']} [{smi}]", flush=True)
    out["rtcamp"] = dict(update_s=rec[0]["update_s"], wall_s=rt_s,
                         launches=n["hako_mega"])
    lap("rtcamp")

    # 8g: the entry points
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, n, dry_s = counted(lambda: entry.dryrun_multichip(8, device),
                                 ("hako_mega",))
    ok = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[dryrun]")]
    for ln in ok:
        print(f"[phase8] {ln}", flush=True)
    if sum(ln.startswith("[dryrun] ok:") for ln in ok) != 3:
        raise AssertionError("phase 8g: dryrun_multichip printed no three ok lines")
    launches["dryrun"] = n
    fn, eargs = entry.entry(device)
    got, n, _ = counted(lambda: fn(*eargs), ("hako_mega",))
    launches["entry"] = n
    st = compare(got, fn(*_on(torch.device("cpu"), *eargs)), "entry()")
    print(f"[phase8] entry(): {st['n']} rays ({st['hits']} hits) == plain version, "
          f"max ulp {st['max_ulp']}; dryrun_multichip(8) {dry_s:.1f} s; hako_mega "
          f"launches {launches['dryrun']['hako_mega']} / {n['hako_mega']} [{smi}]",
          flush=True)
    out["entry"] = dict(dryrun_s=dry_s, max_ulp=st["max_ulp"])
    lap("entry")

    total = {}
    for per in launches.values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    out["launches"] = launches
    out["launch_totals"] = total
    out["wall_s"] = time.time() - t_phase
    out["part_s"] = part_s
    print(f"[phase8] launches by part {launches}, in all {total}; "
          f"{out['wall_s']:.1f} s in all, by part (s) "
          f"{ {k: round(v, 1) for k, v in part_s.items()} } [{smi}]", flush=True)
    return out


SCALE_RES = 2048           # the reference's scale (scripts/scale_demo.py)
# the lattice's unique voxels at 2048^3 as the JAX package states them,
# rounded ("54.4M unique voxels at 2048^3", utils/meshgen.sphere_lattice)
JAX_SCALE_VOXELS = 54_400_000
SCALE_SAMPLE_RAYS = 65536
REBUILDS = 3


def _plain_record(rec: dict) -> dict:
    """A script's record without its tensors, trees and cameras (for the
    JSON line)."""
    skip = ("tree", "cam", "img", "depth", "accum")
    out = {}
    for k, v in rec.items():
        if k in skip:
            continue
        out[k] = _plain_record(v) if isinstance(v, dict) else v
    return out


def phase_scale(device, smi: str, rng) -> dict:
    """Phase 9: the last modules' scripts through their run(), in order:
    scripts/microbench.py (the four Morton codecs, equal before they are
    timed), scripts/pt_step_timing.py (the bumpy sphere at 256^3 and the
    lattice at 1024^3, 640x360), scripts/pt_phase_attrib.py at its
    defaults (the seven cells at 1024^3, 960x540; b8 == b8_nocompact bit
    for bit, b8_nosky's mean 0, every mean finite), scripts/scale_demo.py
    at 2048^3 (voxels within the tie band of the JAX package's 54.4M, the
    PNG read back, hako_mega == its plain version on 65,536 rays sampled
    across the frame) and scripts/rebuild_timing.py at 2048^3 (REBUILDS
    builds, the first cold). hako_mega's count is set to 0 just before each
    script that launches it and read just after (each must launch it)."""
    import torch

    from massivevoxelraytracing_torch.scripts import (
        microbench, pt_phase_attrib, pt_step_timing, rebuild_timing, scale_demo)
    from massivevoxelraytracing_torch.utils import png

    t9 = time.time()
    part_s, launches = {}, {}
    out = {}

    t0 = time.time()
    out["microbench"] = microbench.run(device=device, card=smi)
    part_s["microbench"] = time.time() - t0

    out["pt_step_timing"] = {}
    for label, kw in (("bumpy256", {}), ("lattice1024", dict(scene="lattice", res=GRID))):
        rec, got, part_s[f"pt_step_timing_{label}"] = counted(
            lambda kw=kw: pt_step_timing.run(device=device, card=smi, **kw), ("hako_mega",))
        if not np.isfinite(rec["mean"]) or not bool(torch.isfinite(rec["accum"]).all()):
            raise AssertionError(f"pt_step_timing {label}: non-finite radiance")
        if got["hako_mega"] != rec["launches_a_step"] * (rec["iters"] + 1):
            raise AssertionError(f"pt_step_timing {label}: {got} launches, not its steps'")
        launches[f"pt_step_timing_{label}"] = got["hako_mega"]
        out["pt_step_timing"][label] = _plain_record(rec)
        print(f"[phase9] pt_step_timing {label}: {rec['s_per_step']:.3f} s/step, mean "
              f"{rec['mean']:.9e}, {got['hako_mega']} hako_mega launches [{smi}]", flush=True)

    attrib, got, part_s["pt_phase_attrib"] = counted(
        lambda: pt_phase_attrib.run(device=device, card=smi), ("hako_mega",))
    cells = attrib["cells"]
    if not torch.equal(cells["b8"]["accum"], cells["b8_nocompact"]["accum"]):
        raise AssertionError("pt_phase_attrib: b8 and b8_nocompact differ")
    if cells["b8_nosky"]["mean"] != 0.0:
        raise AssertionError(f"pt_phase_attrib: b8_nosky's mean is {cells['b8_nosky']['mean']}")
    if not all(np.isfinite(c["mean"]) for c in cells.values()):
        raise AssertionError("pt_phase_attrib: a non-finite mean")
    for cell, want in ATTRIB_MEANS.items():
        if f"{cells[cell]['mean']:.6f}" != want:
            raise AssertionError(f"pt_phase_attrib: {cell}'s mean {cells[cell]['mean']:.6f}, "
                                 f"not {want}")
    # a warm step, the timed steps and the profiled ones (a try each) in
    # the profiled cells
    steps = sum(c["launches_a_step"] * (attrib["steps"] + 1 + c.get("profiled_steps", 0))
                for c in cells.values())
    if got["hako_mega"] != steps:
        raise AssertionError(f"pt_phase_attrib: {got} launches, its cells' steps {steps}")
    launches["pt_phase_attrib"] = got["hako_mega"]
    out["pt_phase_attrib"] = _plain_record(attrib)
    print(f"[phase9] pt_phase_attrib: 7 cells, b8 == b8_nocompact bit for bit, b8_nosky "
          f"mean 0, {got['hako_mega']} hako_mega launches [{smi}]", flush=True)

    path = os.path.join(APPS_OUT, "scale_demo.png")
    demo, got, part_s["scale_demo"] = counted(lambda: scale_demo.run(
        res=SCALE_RES, out=path, device=device, card=smi), ("hako_mega",))
    launches["scale_demo"] = got["hako_mega"]
    tree = demo["tree"]
    d_vox = tree.n_voxels - JAX_SCALE_VOXELS
    if abs(d_vox) > TIE_BAND * JAX_SCALE_VOXELS:
        raise AssertionError(f"{SCALE_RES}^3 lattice: {tree.n_voxels} voxels outside the "
                             f"tie band of {JAX_SCALE_VOXELS}")
    # one a frame: the warm and the timed frames, then the kernel timed alone
    # (common.timed: a warm call and the timed ones)
    if demo["launches_a_frame"] != 1 or got["hako_mega"] != 2 * (scale_demo.ITERS + 1):
        raise AssertionError(f"scale_demo: {demo['launches_a_frame']} launches a frame, "
                             f"{got} in all")
    img = png.read(path)
    if not np.array_equal(img, demo["img"].cpu().numpy()) or img.min() == img.max():
        raise AssertionError("scale_demo: the PNG is not the frame")
    w, h = demo["width"], demo["height"]
    ro, rd = camera_rays(demo["cam"], w, h, device)
    idx = torch.as_tensor(np.sort(rng.choice(ro.shape[0], SCALE_SAMPLE_RAYS, replace=False)),
                          device=device)
    chk, k_ms, p_ms = kernel_vs_plain(tree, ro[idx], rd[idx], False,
                                      f"{SCALE_RES}^3 lattice frame sample", device)
    sd = _plain_record(demo)
    sd.update(sample=dict(chk, kernel_ms=k_ms, plain_ms=p_ms), d_voxels=d_vox)
    out["scale_demo"] = sd
    st = demo["build_stats"]
    print(f"[phase9] scale_demo {SCALE_RES}^3: {tree.n_voxels} voxels (JAX {JAX_SCALE_VOXELS}, "
          f"rounded; diff {d_vox:+d} = {d_vox / JAX_SCALE_VOXELS:+.4%}), {tree.n_bricks} "
          f"bricks, {tree.n_snodes} supernodes, T={tree.T}; build {demo['build_s']:.3f} s "
          f"(split {st['t_split_s']:.3f}, count {st['t_count_s']:.3f}, unique "
          f"{st['t_unique_s']:.3f}, accel {st['t_accel_s']:.3f}; {st['n_triangles']} "
          f"triangles, {st['n_dumped']} dumped), peak {demo['peak_build_bytes'] / 2**30:.2f} "
          f"GiB; frame {w}x{h} {demo['frame_ms']:.3f} ms, hako_mega {demo['kernel_ms']:.3f} "
          f"ms (bound {demo['bound']['bound_ms']:.4f} ms, {demo['bound']['bound_by']}); "
          f"kernel == plain on {chk['n']} sampled rays ({chk['hits']} hits, max |dt| "
          f"{chk['max_abs_err']:.3g}, max ulp {chk['max_ulp']}; kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.1f} ms) [{smi}]", flush=True)
    del demo, tree, ro, rd, idx
    torch.cuda.empty_cache()

    t0 = time.time()
    with capture_builds("rebuild_timing"):
        rb = rebuild_timing.run(res=SCALE_RES, n=REBUILDS, device=device, card=smi)
    part_s["rebuild_timing"] = time.time() - t0
    if len(rb["builds"]) < 2 or min(b["n_voxels"] for b in rb["builds"]) < 1:
        raise AssertionError(f"rebuild_timing: {rb['builds']}")
    out["rebuild_timing"] = rb
    torch.cuda.empty_cache()

    out.update(launches=launches, launch_total=sum(launches.values()), part_s=part_s,
               wall_s=time.time() - t9)
    print(f"[phase9] hako_mega launches by script {launches}; {out['wall_s']:.1f} s in "
          f"all, by part (s) { {k: round(v, 1) for k, v in part_s.items()} } [{smi}]",
          flush=True)
    return out


CAPTURED = {}  # a path's last build_scene call: (args, kwargs, tree)


@contextlib.contextmanager
def capture_builds(key: str):
    """scene.build_scene, while installed, keeps its last call's arguments
    and tree in CAPTURED[key] (for route_builds after the path's run)."""
    from massivevoxelraytracing_torch.models import scene

    real = scene.build_scene

    def build(*a, **k):
        CAPTURED.pop(key, None)
        tree = real(*a, **k)
        CAPTURED[key] = (a, k, tree)
        return tree

    scene.build_scene = build
    try:
        yield
    finally:
        scene.build_scene = real


class StepTimer:
    """Times each PathTracer.step while installed (CUDA events around the
    step, then a sync: the apps sync after each step anyway)."""

    def __init__(self):
        from massivevoxelraytracing_torch.models import pathtracer

        self.cls = pathtracer.PathTracer
        self.real = self.cls.step
        self.ms = []

    def __enter__(self):
        import torch

        real, ms = self.real, self.ms

        def step(pt, *a, **k):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            real(pt, *a, **k)
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop))

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.real


def frame_walk_entries(frame3: dict, structures: dict, main_path: dict, vox_paths: dict,
                       src: str) -> list:
    """The kernels line's entries of the frame's kernels (phase 3) and the
    walks (phase 7a): launches by path are the main path's counted runs
    (phase 3's frame; 7a's frames and brick PT step), then the other paths
    that run them (phases 6, 7c, 8 and 9, each counted from 0)."""
    kernels = []
    others = {path: got for path, got in vox_paths.items()
              if path not in ("build_scene", "structures")}
    for name in FRAME_REPLACES:
        if name.startswith("frame"):
            tm = frame3["timing"][name]
            by_path = {"frame": main_path["frame_launches"][name],
                       "structure_frames": sum(v["frame_launches"][name] for k, v in
                                               structures.items() if k in WALK_OF)}
            extra = dict(share=tm["share"], frame_routes=frame3["routes"])
            if name == "frame_raygen":
                extra.update(ab=ab_field(lambda: tm["ab"]), profiled_ms=tm.get("profiled_ms"),
                             profiled_share=tm.get("profiled_share"))
            if name == "frame_shade":
                c = frame3["timing"]["frame_shade_colour"]
                extra.update(colour_ms=c["ms"], colour_plain_ms=c["plain_ms"],
                             colour_bound_ms=c["bound_ms"])
            err = frame3["err"][name]
        else:
            names = [k for k, v in WALK_OF.items() if v == name]
            tm = structures[names[0]]
            tm = dict(ms=tm["walk_ms"], plain_ms=tm["walk_plain_ms"], bound_ms=tm["bound_ms"],
                      bound_by=tm["bound_by"])
            by_path = {f"{k}_frame": structures[k]["frame_launches"][name] for k in names}
            pt_of = "brick" if name == "brick_walk" else "octree"
            by_path[f"pt_{pt_of}_step"] = structures[f"pt_{pt_of}_launches"]
            extra = dict(share=tm["bound_ms"] / tm["ms"], structures={
                k: {f: structures[k][f] for f in (
                    "frame_ms", "plain_frame_ms", "walk_ms", "walk_plain_ms", "bound_ms",
                    "bound_by", "share", "rays", "entered", "rows", "visits", "hits",
                    "pt_BSDF", "pt_NEE", "pt_step_BSDF", "pt_step_NEE", "bits_a_visit",
                    "cells_a_visit", "occupied_a_visit", "crossed_a_visit",
                    "iterations_a_ray", "trips_a_ray", "fold")
                    if f in structures[k]}
                for k in names}, pt_step_s={k: structures[f"pt_{k}_s"] for k in (
                    pt_of, "hako")})
            err = max(structures[k]["max_abs_err"] for k in names)
        by_path.update({path: got[name] for path, got in others.items() if got.get(name)})
        kernels.append(dict(
            name=name, route="cuda", source=src + FRAME_SOURCES[name],
            replaces=f"massivevoxelraytracing_tpu/{FRAME_REPLACES[name]} (XLA-fused, "
                     f"no pallas_call)",
            launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=err,
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
            bound_by=tm["bound_by"], library_ms=None, **extra))
    return kernels


def ptxas_summary(lines: list, kernel: str) -> list:
    """The ptxas report's registers and spills of each instantiation of
    `kernel` (phase 1's lines)."""
    out, inside = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            inside = ln.split("'")[1] if kernel in ln else None
        elif inside and ("registers" in ln or "spill" in ln):
            out.append(f"{inside}: {ln.split('info    :')[-1].strip()}")
    return out


def ab_field(pick):
    """A kernels-line field read from the A/B steps' results: pick() with
    --ab; NOT_RUN without (no step ran)."""
    return pick() if AB else NOT_RUN


def ab_steps(argv: list) -> tuple:
    """The A/B steps a command line asks for: all of AB_STEPS with --ab,
    none without; any other argument is refused (SystemExit)."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py",
                                 description="Smoke run of the PyTorch / CUDA port on one "
                                             "NVIDIA GPU.")
    ap.add_argument("--ab", action="store_true",
                    help="also time each redesigned kernel in turns against its parent "
                         "commit's kernels (scripts/*_ab.py), building their libraries from "
                         "csrc/earlier/")
    return AB_STEPS if ap.parse_args(argv).ab else ()


def main(argv=None) -> int:
    import torch

    global AB
    steps = ab_steps(sys.argv[1:] if argv is None else argv)
    AB = bool(steps)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from massivevoxelraytracing_torch.utils import cuda_build, host_build

    device = torch.device("cuda", 0)
    smi = card()
    rng = np.random.default_rng(SEED)

    t0 = time.time()
    cuda_build.load()
    regs = [ln.strip() for ln in cuda_build.last_build_log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    host_build.load()
    print(f"[phase1] built {os.path.relpath(cuda_build.LIB_PATH)} and "
          f"{os.path.relpath(host_build.LIB_PATH)} in {time.time() - t0:.1f} s "
          f"(nvcc {cuda_build.last_build_seconds}, g++ "
          f"{host_build.last_build_seconds}) [{smi}]", flush=True)
    for ln in regs:
        print(f"[phase1] ptxas: {ln}")
    print(f"[phase1] A/B steps: {', '.join(steps) or NOT_RUN}", flush=True)

    t_main = time.time()

    def lap(what):
        print(f"[time] {what} done at {time.time() - t_main:.1f} s", flush=True)

    worst = phase_kernel_cases(device, smi, rng)
    lap("phases 2, 2b")
    tree, cam, img, depth, main_path = phase_main_path(device, smi, rng)
    lap("phase 3")
    frame3 = phase_frame_kernels(tree, cam, img, depth, device, smi)
    lap("phase 3 frame kernels")
    build3c = phase_build_stages(tree, device, smi)
    vox_paths = {"build_scene": main_path["vox_launches"]}
    lap("phase 3c")
    rframe = phase_rounds_frame(tree, cam, img, depth, main_path["frame_args"],
                                main_path["frame_bound"], device, smi)
    lap("phase 3b")
    pt = phase_pt(tree, cam, device, smi)
    fa, ba = rframe["alone_ms"], pt["timing"]["hako_rounds"]["alone_ms"]
    print(f"[rounds vs mega] the same rays, in turns (CUDA events, ms): 1080p frame "
          f"hako_rounds {fa['hako_rounds']} against hako_mega {fa['hako_mega']} (ratio "
          f"{min(fa['hako_rounds']) / min(fa['hako_mega']):.2f}); bounce-1 BSDF batch "
          f"hako_rounds {ba['hako_rounds']} against hako_mega {ba['hako_mega']} (ratio "
          f"{min(ba['hako_rounds']) / min(ba['hako_mega']):.2f}) [{smi}]", flush=True)
    frame_args = main_path["frame_args"]
    lap("phase 4")
    from massivevoxelraytracing_torch.ops import probes
    from massivevoxelraytracing_torch.scripts import issue_ab, table_ab

    probes.reset_counters()
    pr = phase_probes(tree, frame_args[6], frame_args[7], device, smi)
    torch.cuda.synchronize()
    chase_launches = probes.LAUNCHES["row_chase"]
    floor = {}
    for label, cnt, n in (("frame", main_path["counters"], int(frame_args[6].shape[0])),
                          ("BSDF", pt["counters"]["BSDF"], pt["lanes"]["BSDF"]),
                          ("NEE", pt["counters"]["NEE"], pt["lanes"]["NEE"])):
        floor[label] = floors(cnt, n, pr)
        print(f"[phase5] {label}: floors {floor[label]} [{smi}]", flush=True)
    lap("phase 5")
    sl = phase_slice(tree, cam, smi)
    meter = dict(pipe=sl["pipe"], funcs=sl.pop("funcs"), earlier=sl.pop("earlier"))
    pr["slice"] = sl
    lap("phase 5b")
    sp = phase_split(tree, smi, meter)
    pr["split"] = sp
    lap("phase 5c")
    gp = phase_gather(smi, sl)
    pr["gather"] = gp
    lap("phase 5d")
    apps, vox_paths["apps"] = vox_counted(lambda: phase_apps(smi), "phase 6")
    rt_args, rt_kwargs, rt_tree = CAPTURED.pop("rtcamp")
    apps["rtcamp"]["routes"] = route_builds(rt_args, rt_kwargs, rt_tree, "phase6", smi)
    del rt_tree
    lap("phase 6")
    par, vox_paths["parallel"] = vox_counted(
        lambda: phase_parallel(tree, cam, img, depth, pt, device, smi), "phase 8")
    lap("phase 8")
    t7 = time.time()
    structures, vox_paths["structures"] = vox_counted(
        lambda: phase_structures(tree, cam, img, device, smi, rng), "phase 7a")
    del tree
    torch.cuda.empty_cache()
    shell = phase_shell(device, smi, rng)
    structures["apps"], vox_paths["apps7"] = vox_counted(
        lambda: phase_apps7(smi, str(device)), "phase 7c", need=False)
    print(f"[phase7] {time.time() - t7:.1f} s in all [{smi}]", flush=True)
    lap("phase 7")
    scale, vox_paths["scale"] = vox_counted(lambda: phase_scale(device, smi, rng), "phase 9")
    rb_args, rb_kwargs, rb_tree = CAPTURED.pop("rebuild_timing")
    scale["rebuild_timing"]["routes"] = route_builds(rb_args, rb_kwargs, rb_tree, "phase9",
                                                     smi)
    scale["rebuild_timing"]["kernels"] = route_kernel_bounds(
        rb_args, rb_kwargs, scale["rebuild_timing"]["routes"], "phase9", smi)
    del rb_tree
    torch.cuda.empty_cache()

    lap("phase 9")
    loaded = [m for m, v in sys.modules.items() if v is not None
              and m.split(".")[0] in ("jax", "jaxlib", "massivevoxelraytracing_tpu")]
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    src = "massivevoxelraytracing_torch/csrc/"
    ref = "massivevoxelraytracing_tpu/ops/"
    table = [("hako_mega", "hako_mega.cu", "hako_mega.py:471",
              pt["mega_launches"], main_path["launches"])]
    for name, replaces in (("hako_probe", "hako_kernels.py:1218,1681"),
                           ("hako_dda_merge", "hako_kernels.py:1252,1700,1735"),
                           ("hako_dda", "hako_kernels.py:1252,1700"),
                           ("hako_merge", "hako_kernels.py:1735"),
                           ("hako_rounds", "hako_kernels.py:1985,2010 (the while_loop of "
                                           "rounds, jnp.nonzero compaction :1407,1805) with "
                                           "kernel A :1218,1681, kernel B :1252,1700 and the "
                                           "merge :1735 in it")):
        table.append((name, "hako_rounds.cu", replaces,
                      pt["rounds_launches"][name], rframe["launches"][name]))
    # ms, plain_ms, bound and the PT part of max_abs_err come from the same
    # inputs (the bounce-1 batches); max_abs_err also covers phases 2-3
    earlier_err = {"hako_mega": max(worst, main_path["max_abs_err"],
                                    scale["scale_demo"]["sample"]["max_abs_err"])}
    kernels = []
    for name, source, replaces, launches, frame_launches in table:
        tm = pt["timing"][name]
        # the main path's PT step, then the paths of later slices (phase 8,
        # part by part; phase 9, script by script)
        scripts = scale["launches"] if name == "hako_mega" else {}
        by_path = {"pt_step": launches, **{
            f"parallel_{part}": per[name] for part, per in par["launches"].items()
            if name in per}, **scripts}
        if sum(by_path.values()) != (launches + par["launch_totals"].get(name, 0)
                                     + (scale["launch_total"] if scripts else 0)):
            raise AssertionError(f"{name}: launches by path do not add up")
        if name in ("hako_probe", "hako_dda_merge", "hako_dda", "hako_merge"):
            # off the route since it runs in one launch (and, for kernel B and
            # the merge, since the row stage is one launch): the paths that
            # still run them are the two-launch driver's step and frame
            # (hako_probe, hako_dda_merge) and the phase scripts (all four)
            by_path.update(phase5b=sl["round_launches"][name],
                           phase5c=sp["round_launches"][name])
            if name in ("hako_probe", "hako_dda_merge"):
                by_path.update(pt_step_two_launch=pt["two_launch_launches"][name],
                               frame_two_launch=rframe["two_launch_launches"][name])
            if min(by_path[k] for k in by_path if k != "pt_step") < 1:
                raise AssertionError(f"{name}: a path that runs it launched it no time")
        kernels.append(dict(
            name=name, route="cuda", source=src + source, replaces=ref + replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(earlier_err.get(name, 0.0), pt["err"][name]),
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1], library_ms=None, bound_ops_ms=tm.get("ops_ms"),
            frame_launches=frame_launches,
        ))
    # the probes: the row chase (phase 5) and the issue-cost probes (phase
    # 5b; the JAX scripts' shape, summed over each kernel's cases)
    chase = next(c for c in pr["chase"] if "bound" in c)
    kernels.append(dict(
        name="row_chase", route="cuda", source=src + "hako_probes.cu",
        replaces="scripts/dma_gather_probe3.py:87", launches=chase_launches,
        max_abs_err=0.0, ms=chase["ms"], plain_ms=chase["plain_ms"],
        bound_ms=chase["bound"][0], bound_by=chase["bound"][1], library_ms=None))
    for name, prefix, replaces in (
            ("walk_probe", ("walk64", "scan64"),
             "scripts/hako_kernel_micro.py:52 (k_walk :77, scan64 :90)"),
            ("fetch_probe", ("fetch",), "scripts/hako_kernel_micro.py:52 (k_words :147)"),
            ("construct_probe", ("construct",), "scripts/construct_micro.py:42"),
            ("node_gather_probe", ("gather",),
             "scripts/hako_kernel_micro.py:52 (k_gflat :100, k_gsplit :113)"),
            ("table_select_probe", ("select",),
             "scripts/hako_kernel_micro.py:52 (k_fold :127)"),
            ("calib_probe", ("calib",), "scripts/hako_kernel_micro.py:188")):
        e = slice_entry(sl, prefix)
        kernels.append(dict(
            name=name, route="cuda", source=src + "hako_probes.cu",
            replaces=replaces, launches=sl["launches"][name],
            max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None,
            cases=e["cases"]))
        # the redesigned ones in turns with their parents' kernels (--ab):
        # the fetch (row_stage_ab), the shared forms (table_ab), the Hopper
        # forms (issue_ab)
        for key, names in (("ab", ("fetch_probe",)), ("table_ab", table_ab.ENTRY),
                           ("issue_ab", issue_ab.ENTRY)):
            if name in names:
                kernels[-1]["ab"] = ab_field(
                    lambda key=key: sl[key] if key == "ab" else sl[key][name])
        if name == "walk_probe":
            kernels[-1]["walk_slots"] = ab_field(lambda: sl["issue_ab"]["walk_slots"])
    kernels.append(pipe_entry(sl, src))
    for k in kernels[1:5]:
        k["replaces"] += {"hako_probe": "; scripts/hako_phase_timing.py:91; "
                          "scripts/r3_phase_split.py:130; scripts/hako_shell_micro.py:134",
                          "hako_dda_merge": "", "hako_dda": "; scripts/hako_phase_timing.py:137",
                          "hako_merge": ""}[k["name"]]
        k["phase_timing_launches"] = sl["round_launches"][k["name"]]
        k["phase_timing_isolated_launches"] = sl["isolated_launches"][k["name"]]
        k["split_launches"] = sp["round_launches"][k["name"]]
    rk = kernels[5]
    rk.update(registers=ptxas_summary(regs, "hako_rounds_kernel"),
              grid_blocks_per_sm=rframe["grid"][0], sms=rframe["grid"][1],
              share=rk["bound_ms"] / rk["ms"], rounds_batch=pt["timing"]["hako_rounds"]["rounds"],
              alone_ms={"bsdf_batch": pt["timing"]["hako_rounds"]["alone_ms"],
                        "frame": rframe["alone_ms"]},
              frame_bound_ms=rframe["bound"][0], frame_bound_by=rframe["bound"][1],
              frame_share=rframe["bound"][0] / min(rframe["alone_ms"]["hako_rounds"]),
              schedule_bound_ms=pt["timing"]["hako_rounds"]["schedule_bound"][0],
              frame_schedule_bound_ms=rframe["schedule_bound"][0],
              phase_timing_launches=sl["round_launches"]["hako_rounds"],
              split_launches=sp["round_launches"]["hako_rounds"],
              replaces_scripts="scripts/hako_phase_timing.py and scripts/r3_phase_split.py "
                               "full frames")
    fused = kernels[2]
    tm = pt["timing"]["hako_dda_merge"]
    fused.update(unfused_ms=tm["unfused_ms"], unfused_parts_ms=tm["unfused_parts_ms"],
                 unfused_parts_sum_ms=tm["unfused_parts_sum_ms"],
                 unfused_bound_sum_ms=tm["unfused_bound_sum_ms"],
                 split_round_ms=split_round(sp),
                 checked_calls={"frame": rframe["checked_calls"],
                                "parallel_bigscene": par["bigscene"]["checked_calls"]})
    kernels += split_entries(sp, src)
    kernels += gather_entries(gp, src)
    # the sample chain (phase 4): the main path's PT step, launches a step
    for name, e in pt["chain"]["kernels"].items():
        kernels.append(dict(
            name=name, route="cuda", source=src + "pt_chain.cu",
            replaces=f"massivevoxelraytracing_tpu/{CHAIN_REPLACES[name]} (XLA-fused, "
                     f"no pallas_call)",
            launches=e["launches"], launches_by_path={"pt_step": e["launches"]},
            max_abs_err=e["max_abs_err"], ms=e["ms"], plain_ms=e["plain_ms"],
            bound_ms=e["bound_ms"], bound_by=e["bound_by"], library_ms=None,
            share=e["share"], lanes=e["lanes"], ms_a_step=e["ms_a_step"],
            calls_checked=e["calls_checked"],
            **{k: e[k] for k in ("sats_ms", "sats_plain_ms", "sats_bound_ms", "sats_bound_by")
               if k in e},
            **({f"{b}_ab": ab_field(lambda b=b: e[f"{b}_ab"]) for b in ("sats", "alias")}
               if name == "pt_bounce_sample" else {})))
    # the scene build (phase 3c): launches by path, each counted from 0
    for name, e in build3c["stages"].items():
        by_path = {path: got[name] for path, got in vox_paths.items()}
        kernels.append(dict(
            name=name, route="cuda", source=src + "vox_build.cu",
            replaces=f"massivevoxelraytracing_tpu/{VOX_REPLACES[name]} (XLA-fused, "
                     f"no pallas_call)",
            launches=sum(by_path.values()), launches_by_path=by_path,
            **{k: v for k, v in e.items()}))
    kernels += frame_walk_entries(frame3, structures, main_path, vox_paths, src)
    kernels[0].update(
        frame_kernel_ms=main_path["frame_kernel_ms"],
        frame_bound_ms=main_path["frame_bound"][0],
        frame_bound_by=main_path["frame_bound"][1],
        frame_rows=main_path["frame_rows"],
        counters={"frame": main_path["counters"], **pt["counters"]},
        floors=floor,
        apps_launches={k: apps[k]["launches"] for k in ("rtcamp", "voxrt", "voxpt")},
        scale_frame_ms=scale["scale_demo"]["frame_ms"],
        scale_frame_kernel_ms=scale["scale_demo"]["kernel_ms"],
        scale_frame_bound_ms=scale["scale_demo"]["bound"]["bound_ms"],
        scale_frame_bound_by=scale["scale_demo"]["bound"]["bound_by"])
    print(json.dumps({"probes": pr}))
    print(json.dumps({"kernels": kernels, "pt": {
        "s_per_step": pt["step_s"], "mrays": pt["mrays"], "mean": pt["mean"],
        "peak_gib": pt["peak_gb"], "rounds_step_s": pt["rounds_s"],
        "rounds_step_two_launch_s": pt["two_launch_s"],
        "rounds_step_host_syncs": pt["host_syncs"],
        "rounds_frame_ms": rframe["frame_ms"],
        "rounds_frame_two_launch_ms": rframe["two_launch_frame_ms"],
        "rounds_frame_counts": rframe["counts"], "rounds_frame_traced": rframe["traced"],
        "rounds_frame_events_idle_share": rframe["events_idle_share"],
        "rounds_per_step": pt["rounds"], "device_busy_ms": pt["busy_ms"],
        "device_mega_ms": pt["mega_ms"], "profiled_wall_ms": pt["wall_ms"],
        "chain_routes": pt["chain"]["routes"]},
        "build": {"copy": build3c["copy"], "routes": build3c["routes"]},
        "apps": apps, "parallel": par,
        "accel": structures, "shell": shell, "scale": scale}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
