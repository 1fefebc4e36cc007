// Hopper microbenchmarks of the questions the megakernel's design asks,
// ports of the reference's Pallas probes in scripts/:
//
// * row chase (gather_probe3.py "chase" / "chase_rows", dma_gather_probe3.py:
//   each gather's index comes from the row the gather before it read):
//   chains of dependent 656-byte brick-row reads, the next row taken from
//   word 0 (4 B a thread), from the xor of words 0-3 (one 16-byte load a
//   thread) or from the xor of all 164 words (a warp reads the row as 41
//   16-byte vectors and xor-reduces it). CHAINS independent chains a
//   thread (a warp, for the whole-row read) are interleaved, so their loads
//   are in flight together. Launched with one warp an SM it gives the time
//   of one dependent hop; at full occupancy, the rate of independent rows.
// * walk / scan vs fetch (hako_kernel_micro.py k_walk :77, scan64 :90,
//   k_words): walk64 (or the 64-cell sweep) alone on masks held in
//   registers (the masks step through an LCG, and the planes are remade
//   each repeat, so nothing is hoisted), and the row-word fetch alone
//   (words 2s, 2s+1 of the lane's row, s taken from the words read
//   before), each looped in the kernel; the fetch reads the lane's row
//   words from shared memory, staged first (fetch_probe_kernel). The walk
//   and the sweep are Hopper forms, bit-equal to hako_device.cuh's walk64
//   and the reference's sweep (walk64_hopper, scan64_cell below). What
//   bounds them is the SM's integer / compare / min-max / select pipe (2
//   warp instructions an SM a clock): a repeat of the sweep is 329 SASS,
//   82 SM-clocks a warp-repeat of issue and 112 on that pipe (a sweep with
//   a compare, a select and a bit test a cell: 512 SASS, 128 and 260), the sweep built as a valid-cell mask (two
//   chained FSETP a cell, its bit added by a predicated IMAD, the lowest
//   valid cell by the cells' order along the ray); the walk's 167 static
//   SASS are 42 clocks of issue and 37 on that pipe, but its warps run
//   their slowest lane's slots (its slots predicated, no branch but the
//   loop's: fewer instructions a slot on that pipe than hako::walk64's,
//   the same slots). At the JAX script's 131,072 lanes a launch's fixed cost is
//   that of an empty grid, 2.2 us on an H100 (PERF.md section 6).
// * l2_read_probe (no counterpart in the reference): streaming reads of an
//   L2-resident buffer, the L2 read rate that bounds the fetch's staging.
// * construct_probe<C> (construct_micro.py :42 run): K dependent repeats
//   of one vector construct a lane, each written the way Hopper computes
//   it (fminf / fmaxf, a select, integer ops, a variable shift, the literal
//   5-step barrel shift, int <-> float converts, and bit_at and pc64_below
//   in Hopper forms). The six literal constructs keep their bodies and
//   their SASS: at full occupancy their slopes run near their pipe floors
//   (PERF.md section 6), and at the script's shape the launch's 2.2 us is
//   most of what is left.
//   bit_at_hopper is one 64-bit funnel shift (SHF.R.U64) and its low bit:
//   4.4 SASS a repeat, 1.6 SM-clocks a warp-repeat on the integer pipe
//   against hako_device.cuh's 7.4 and 2.6; pc64_below_hopper shifts (hi:lo)
//   left by 64 - cell (two SHF) and adds its two popcounts: 7.4 SASS a
//   repeat against 11.5, but both designs issue 2 POPC a repeat, and POPC
//   runs at 0.5 a clock an SM: 4 SM-clocks a warp-repeat bind both.
// * pipe_probe<A, B> (no counterpart in the reference: the rates behind the
//   pipe floor): see its note below; empty_probe_kernel, a grid that does
//   nothing, gives the script shape's fixed cost of a launch.
// * walk_count_kernel (the walk probe's counting variant: the slots a warp
//   runs against the slots its lanes need, both walks), walk_form_kernel
//   and bit_form_kernel (the forms side by side for the card tests).
// * node_gather_probe<SPACE> (hako_kernel_micro.py k_gflat / k_gsplit): a
//   chain of dependent node fetches (mask_lo, mask_hi, base) from a table
//   in global memory (__ldg), in shared memory or in constant memory
//   (uploaded on the launch stream). The shared form
//   (node_gather_shared_kernel; the reference's node fetch of a level held
//   in SMEM) stages the table by one bulk copy a block in a layout whose
//   copies put a warp's lanes in distinct banks where they fit, by table
//   size: bound by shared memory's wavefronts (3 a warp-repeat at least, at
//   128 B a clock an SM), its issue and, at the script's shape, by the
//   staging's bytes at the L2 read rate (see the note at Staged).
// * table_select_probe<FORM> (hako_kernel_micro.py k_fold, fold_select
//   over 64 x 3 words in SMEM): the 64-entry select from constant memory,
//   from shared memory, or from registers across the warp (each word of
//   the 64 entries as 2 registers a lane) with __shfl_sync. The shared form
//   (table_select_shared_kernel) stages 32 word copies, 3 conflict-free
//   LDS.32 a select: bound by its 3 wavefronts and its issue.
// * calib_probe<KIND> (hako_kernel_micro.py calibrate): K dependent
//   a * 1.0000001f + b (a separate multiply and add under -fmad=false;
//   the reference's K = 1024) against 8 independent chains of K (128).
// * shell_copy_probe<AOS> (hako_shell_micro.py :64 and :78): kernel A's
//   I/O without its work, o = i + 1 over 8 float arrays of a lane each
//   (8 separate streams in and 8 out, kernel A's own layout) or over one
//   consolidated [G, 8, L] array. The TPU question was the per-grid-step
//   cost of 16 pipelined VMEM blocks; here it is what 16 streams cost
//   against one array of the same bytes. Bound: bytes, each input read
//   and each output written once (33.5 MB, 0.0100 ms at 3.35 TB/s, on
//   the script's 524,288 lanes). Both layouts run one streaming design:
//   every thread has 8 independent 16-byte loads in flight before its
//   first store (one float4 of each of the 8 arrays, or 8 float4s of the
//   one array, each load instruction coalesced over the warp), with an
//   evict-first hint on the inputs, read once, in one wave of 128-thread
//   blocks at most (a grid-stride loop past it), so neither layout pays
//   a last partial wave of short blocks.
// * preamble_probe (hako_shell_micro.py :102): the shell plus
//   hako::ray_preamble on the unit box, 6 arrays in (the ray's SoA
//   origin and direction, read straight into the preamble's value
//   overload: no [n, 3] interleave) and its 8 outputs (t0 + t1 an axis,
//   dt an axis, vm6 and enter_ok as floats).
// * probe_stage_probe<STAGE> (hako_shell_micro.py :200 k_body and :287
//   staged): kernel A's probe body cut into stages, from the device
//   functions the traversal runs (ray_preamble, coords, plane) in the Hopper
//   forms of its walk and rank (walk64_hopper, pc64_below_hopper; bit-equal
//   to hako_device.cuh's walk64 and pc64_below_clipped) and the level-table
//   fetch. STAGE 0: preamble + the root walk; 1: + the cell's coords, exit
//   planes and rank; 2: + the node fetch at the rank (clipped to [0,
//   clip], the reference's literal); 3: + the walk of the fetched node.
//   STAGE 4: the body unrolled over the T levels, no probe loop. Where a
//   walk finds no cell (c = 64) the reference still ranks c ^ vm6
//   (64-127) with its shifts clipped, and fetches child indices past a
//   level: the clipped rank gives cell 63's count and level_node the node
//   its table form gives (a clipped index or zeros past the level's
//   nodes). One wave of blocks streams the lanes (a grid-stride loop, the
//   next lane's 7 inputs loaded, evict-first, before the current lane's
//   body). Bound: its bytes (40 B a lane, 60 for stage 4) where most rays
//   miss the box, as on the script's lanes; the integer pipe where the
//   walks find cells (PERF.md section 6, rows 19-20).
// * take_along_probe<AXIS, FORM> (dyngather_probe2.py :19, its k_taa1 /
//   k_taa1w / k_taa0 / k_taa0t, and gather_probe3.py :70 probe_a0small):
//   take_along_axis within a tile, out[i, j] = t[i, idx[i, j] % mod] (axis
//   1) or t[idx[i, j] % mod, j] (axis 0), on a batch of independent tiles,
//   a block a tile. The TPU question was which 2D dynamic gathers Mosaic
//   lowers along lanes and sublanes; here it is what a block's gather
//   within its tile costs three ways: FORM SHARED stages the tile in shared
//   memory with coalesced 16-byte loads, then gathers from it (a tile over
//   the block's opt-in shared memory is refused by the wrapper); along
//   columns (axis 0) a block takes a slice of a tile's columns and
//   stages only the 32-byte sectors of it that its indices reach
//   (take_along_a0_kernel), but where its indices reach every sector of
//   a card-filling batch or of a 4 KB tile, a tile a block; FORM SHFL (axis 1) holds a row in a warp, C /
//   32 registers a lane, and gathers with one __shfl_sync a register and a
//   select (a shuffle reaches 32 lanes only); FORM GLOBAL gathers through
//   L1 (__ldg). Bound: bytes (the
//   sectors the indices reach, the indices and the output once); one tile
//   is launch-bound, which is why the batch exists.
// * smem_alloc_probe (gather_probe3.py :101 probe_vmem, the largest single
//   VMEM scratch): n rows of 128 floats of dynamic shared memory, after
//   cudaFuncSetAttribute raises the block's limit to them; 2x goes into
//   row 0 and into row n - 1, and the output is row 0 + row n - 1 = 4x for
//   every n. The reference never writes its last row, so its output is
//   undefined (NaN when interpreted); writing it defines the output and
//   proves the far end of the allocation is addressable. No bound: a
//   capacity probe, answered by the largest n that launches.
// * ohg_probe<MODE> (gather_probe3.py :147 probe_ohg): the dependent chase
//   idx = (idx + flat[idx]) & (n - 1) over an int32 [n_rows, 128] table,
//   k hops a lane. MODE SHARED stages the table in shared memory, MODE
//   GLOBAL loads through L1 / L2: both are bound by the latency of k
//   dependent loads. MODE MMA is the reference's MXU gather on the tensor
//   cores (ohg_mma_kernel): each hop the full one-hot product of every
//   lane's row with the table's three byte planes (values < 2^24) by
//   mma.sync m16n8k32 u8 x u8 -> s32, over every 32-row chunk and 8-column
//   tile, as the reference computes it. The planes are split once a call
//   while a block stages them in shared memory in the B fragments' order;
//   a cluster of blocks splits the table's rows where it exceeds what one
//   block holds, and a lane's column is combined across the cluster
//   through distributed shared memory. Bound: operations (2 x lanes x
//   n_rows x 128 x 3 int8 operations a hop).
//
// What bounds them is what they measure: load latency (the chase, the
// gathers; the fetch's from shared memory, after its staging's L2 reads)
// and issue rate, the busiest pipe (pipe_probe's rates, utils/sass.
// pipe_floor) or dependent-op latency (the walk, the constructs, the
// selects, the calibration). The shell and the preamble are bound by their
// bytes (16 and 14 floats a lane, each read or written once); so are the
// stages where most rays miss the box (a missing ray's walk ends at its
// first test), else by the walks' pipe; the L2 read probe by the L2's
// read rate. The repeat loops keep every repeat data-dependent; the outer
// loop is `#pragma unroll 1` around a fixed inner unroll of kUnroll, so the
// outer loop body's SASS instructions over kUnroll are the cost of one
// repeat.
// Plain PyTorch versions that compute the same outputs are in
// ops/probes.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hako_device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <int MODE, int CHAINS>
__global__ void row_chase_kernel(const uint32_t* rows, const int* start,
                                 int* end, int n_chains, int hops) {
  using hako::kRowWords;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int owner = MODE == 2 ? t >> 5 : t;  // a thread, or a warp
  int idx[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int k = owner * CHAINS + c;
    idx[c] = k < n_chains ? start[k] : 0;
  }
  for (int h = 0; h < hops; ++h) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const uint32_t* row = rows + static_cast<size_t>(idx[c]) * kRowWords;
      if (MODE == 0) {
        idx[c] = static_cast<int>(__ldg(row));
      } else if (MODE == 1) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
        idx[c] = static_cast<int>(v.x ^ v.y ^ v.z ^ v.w);
      } else {
        const int lane = threadIdx.x & 31;
        const uint4* r4 = reinterpret_cast<const uint4*>(row);
        const uint4 a = __ldg(r4 + lane);
        uint32_t x = a.x ^ a.y ^ a.z ^ a.w;
        if (lane < kRowWords / 4 - 32) {
          const uint4 b = __ldg(r4 + 32 + lane);
          x ^= b.x ^ b.y ^ b.z ^ b.w;
        }
        idx[c] = static_cast<int>(__reduce_xor_sync(kFull, x));
      }
    }
  }
  if (MODE == 2 && (threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    const int k = owner * CHAINS + c;
    if (k < n_chains) end[k] = idx[c];
  }
}

template <int MODE>
int launch_chase(const uint32_t* rows, const int* start, int* end,
                 int n_chains, int hops, int chains, int blocks, int threads,
                 cudaStream_t s) {
  switch (chains) {
    case 1:
      row_chase_kernel<MODE, 1><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    case 2:
      row_chase_kernel<MODE, 2><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    case 4:
      row_chase_kernel<MODE, 4><<<blocks, threads, 0, s>>>(rows, start, end, n_chains, hops);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Hopper forms of the walk, the 64-cell sweep, bit_at and pc64_below, bit-equal
// to hako_device.cuh's (which hako_mega and the round kernels keep running).
// What bounds them is the SM's pipes: an SM sub-partition issues one warp
// instruction a clock, but its integer / logic / compare / min-max / select
// pipe is 16 lanes wide, so each such instruction holds it 2 clocks, and
// POPC and conversions hold theirs longer (pipe_probe measures the rates;
// utils/sass.pipe_floor turns a loop's SASS into its busiest pipe's clocks).
// The forms below spend fewer instructions on that pipe, and move what they
// can to the FP32 and IMAD pipes.
// ---------------------------------------------------------------------------

// acc + bit where a < b and c < d, else acc: two chained compares
// (FSETP, FSETP.AND) and a predicated multiply-add on the IMAD pipe (one: a
// 1 the compiler does not fold into an ALU add).
__device__ __forceinline__ uint32_t add_if_both_lt(uint32_t acc, float a, float b, float c,
                                                   float d, uint32_t one, uint32_t bit) {
  asm("{\n\t.reg .pred p, q;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "setp.lt.and.f32 q, %3, %4, p;\n\t"
      "@q mad.lo.u32 %0, %5, %6, %0;\n\t}"
      : "+r"(acc) : "f"(a), "f"(b), "f"(c), "f"(d), "r"(one), "r"(bit));
  return acc;
}

// The 64-bit mask (hi:lo) with its bits permuted by index: bit c of the
// result is bit c ^ vm6 of the input (the occupancy of cell c seen through
// the ray's mirror); no work for vm6 = 0.
__device__ __forceinline__ void mirror64(uint32_t& lo, uint32_t& hi, int vm6) {
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if (vm6 & (1 << b)) {
      const int s = 1 << b;
      const uint32_t keep = b == 0 ? 0x55555555u : b == 1 ? 0x33333333u : b == 2 ? 0x0F0F0F0Fu
                            : b == 3 ? 0x00FF00FFu : 0x0000FFFFu;
      lo = ((lo >> s) & keep) | ((lo & keep) << s);
      hi = ((hi >> s) & keep) | ((hi & keep) << s);
    }
  }
  if (vm6 & 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
}

// The sweep's cell (the reference's _scan64_impl's c): a cell is valid
// where it is occupied, en < ex and ex > max(t_q, 0), i.e. where
// max(en, max(t_q, 0)) < ex; of the valid cells the sweep takes the one of
// least entry (the lowest index on equal entries). Valid cells exist only
// where every axis's planes rise with k (dc > 0), and then two valid cells
// are ordered along the ray on every axis at once, so the one of least entry
// is also the one of lowest index: the answer is the lowest set bit of the
// valid mask. The mask is built without a select a cell: with the pair
// entry A = max(x, y entries) and exit B = min(x, y exits) over (cx, cy),
// shared by the 4 cells along z, and Z0 = max(z entry, t_q), Z1 = the z
// exit, max(A, Z0) < min(B, Z1) is A < Z1 and Z0 < B once A < B is folded
// into A (+inf where not) and Z0 < Z1 into Z1 (-inf where not): a cell costs
// two chained FSETP and a predicated IMAD that adds its bit; the occupancy
// is applied to the whole mask. `one` is 1 (a value the probe's repeat loop
// makes from its data, so that the add stays on the IMAD pipe).
__device__ __forceinline__ int scan64_cell(uint32_t lo, uint32_t hi, int vm6,
                                           const float t1[3], const float dc[3],
                                           float t_q, uint32_t one = 1u) {
  using hako::jmax;
  using hako::jmin;
  const float tq0 = jmax(t_q, 0.0f);
  float tb[3][5];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 5; ++k) tb[a][k] = hako::plane(t1[a], dc[a], k);
  }
  const float inf = __int_as_float(0x7f800000);
  float z0[4], z1[4];
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    z0[z] = jmax(tb[2][z], tq0);
    z1[z] = z0[z] < tb[2][z + 1] ? tb[2][z + 1] : -inf;
  }
  uint32_t k_lo = 0, k_hi = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int cx = p & 3, cy = p >> 2;
    const float en_xy = jmax(tb[0][cx], tb[1][cy]);
    const float ex_xy = jmin(tb[0][cx + 1], tb[1][cy + 1]);
    const float a = en_xy < ex_xy ? en_xy : inf;
#pragma unroll
    for (int cz = 0; cz < 4; ++cz) {
      const int c = hako::cell_of(cx, cy, cz);
      if (c < 32) {
        k_lo = add_if_both_lt(k_lo, a, z1[cz], z0[cz], ex_xy, one, 1u << c);
      } else {
        k_hi = add_if_both_lt(k_hi, a, z1[cz], z0[cz], ex_xy, one, 1u << (c - 32));
      }
    }
  }
  mirror64(lo, hi, vm6);
  const uint32_t v_lo = k_lo & lo, v_hi = k_hi & hi;
  return v_lo ? __ffs(v_lo) - 1 : (v_hi ? 31 + __ffs(v_hi) : 64);
}

// The delta of the occupancy bit's position within its 32-bit word for each
// step of one axis (bytes c = 0, 1, 2: the step from c to c + 1), the cell
// index's bits of that axis (dilated: x bits 0 and 3, y 1 and 4, z 2 and 5)
// seen through the mirror vm6; mod 32, so that a funnel rotate takes it
// whatever its sign (the z step from 1 to 2 also flips bit 5: the word).
// Bytes c = 0..3 of axis_offsets: the axis's bits of the index at c.
__device__ __forceinline__ uint32_t axis_offsets(int a, int vm6) {
  const uint32_t dilated = a == 0 ? 0x09080100u : (a == 1 ? 0x12100200u : 0x24200400u);
  const uint32_t bits = a == 0 ? 9u : (a == 1 ? 18u : 36u);
  return dilated ^ (static_cast<uint32_t>(vm6) & bits) * 0x01010101u;
}

__device__ __forceinline__ uint32_t step_deltas(int a, int vm6) {
  const uint32_t m = axis_offsets(a, vm6);
  // bytewise (m >> 8) - m without borrows across bytes, then mod 32
  return (((m >> 8) | 0x80808080u) - m) & 0x001F1F1Fu;
}

// walk64 (hako_device.cuh) for the planes of a mirrored ray (dc >= 0 on every
// axis, as ray_preamble and every descent give them): the same Walk{en, ex,
// c}. The start cell and its planes are walk64's. Then a slot costs two
// FMNMX for its exit, one LOP3 for its occupancy (the cell's bit kept as a
// one-hot word b over the 32-bit half w of the mask that holds it), one
// FSETP for the hit and one for the end; the axis to step is the one whose
// plane is the exit (x, then y on ties), and the step, predicated, rotates b
// by the axis's next delta (a funnel shift), shifts the axis's delta bytes
// and computes its next plane as plane() does (FADD / FMUL / FADD on the
// FP32 pipe; f counts 4 - (c + 1) down), with no branch but the loop's. The
// walk ends at the first occupied cell with en < ex, or at the first slot
// whose exit reaches the node's exit: no later slot of walk64 can hit (its
// entry is then at or past every plane that bounds its exit), and walk64's
// slot and coordinate limits are never reached before. WP counts the slots a
// warp runs, `slots` the lane's own.
template <bool COUNT>
__device__ __forceinline__ hako::Walk walk64_hopper(uint32_t lo, uint32_t hi, int vm6,
                                                    const float t1[3], const float dc[3],
                                                    float t_q, hako::WarpPass* wp = nullptr,
                                                    int* slots = nullptr) {
  using hako::jmax;
  using hako::jmin;
  using hako::plane;
  const hako::Walk none{hako::kMaxFloat, hako::kMaxFloat, 64};
  const float tq0 = jmax(t_q, 0.0f);
  const float node_en = hako::max3(plane(t1[0], dc[0], 0), plane(t1[1], dc[1], 0),
                                   plane(t1[2], dc[2], 0));
  const float node_ex = hako::min3(t1[0], t1[1], t1[2]);
  const float t_start = jmax(node_en, tq0);
  if (!(t_start < node_ex)) return none;
  float e[3], nxt[3], f[3];
  uint32_t dq[3];
  int m = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int c = (plane(t1[a], dc[a], 1) <= t_start) + (plane(t1[a], dc[a], 2) <= t_start) +
                  (plane(t1[a], dc[a], 3) <= t_start);
    const float fc = static_cast<float>(4 - c);
    e[a] = t1[a] - dc[a] * fc;       // plane(t1, dc, c)
    f[a] = fc - 1.0f;                // 4 - (c + 1)
    nxt[a] = t1[a] - dc[a] * f[a];   // plane(t1, dc, c + 1)
    m |= static_cast<int>(__byte_perm(axis_offsets(a, vm6), 0u, 0x4440u + static_cast<uint32_t>(c)));
    dq[a] = step_deltas(a, vm6) >> (8 * c);
  }
  float en = hako::max3(e[0], e[1], e[2]);
  uint32_t b = 1u << (m & 31);
  const uint32_t flip = lo ^ hi;
  uint32_t w = (m & 32) ? hi : lo;
  float ex;
  bool hit;
  while (true) {
    if (COUNT) {
      hako::count_pass(wp);
      ++*slots;
    }
    ex = jmin(nxt[0], jmin(nxt[1], nxt[2]));
    hit = (w & b) != 0u && en < ex;
    if (hit || !(ex < node_ex)) break;
    en = ex;
    const bool sx = nxt[0] == ex;
    const bool sy = !sx && nxt[1] == ex;
    if (sx) {
      b = __funnelshift_l(b, b, dq[0]);
      dq[0] >>= 8;
      f[0] = f[0] - 1.0f;
      nxt[0] = t1[0] - dc[0] * f[0];
    }
    if (sy) {
      b = __funnelshift_l(b, b, dq[1]);
      dq[1] >>= 8;
      f[1] = f[1] - 1.0f;
      nxt[1] = t1[1] - dc[1] * f[1];
    }
    if (!sx && !sy) {
      b = __funnelshift_l(b, b, dq[2]);
      dq[2] >>= 8;
      f[2] = f[2] - 1.0f;
      nxt[2] = t1[2] - dc[2] * f[2];
      if (f[2] == 1.0f) w ^= flip;  // z went from 1 to 2: the other word
    }
  }
  if (!hit) return none;
  const int half = (f[2] <= 1.0f ? 32 : 0) ^ (vm6 & 32);
  return hako::Walk{en, ex, (half | (31 - __clz(b))) ^ vm6};
}

// hako::walk64 as it is, with WarpPass counting at the top of each slot and
// a lane's own slot count (the slots hako_mega's walk runs, for the
// counting variant).
__device__ __forceinline__ hako::Walk walk64_counted(uint32_t lo, uint32_t hi, int vm6,
                                                     const float t1[3], const float dc[3],
                                                     float t_q, hako::WarpPass* wp,
                                                     int* slots) {
  using namespace hako;
  const Walk none{kMaxFloat, kMaxFloat, 64};
  const float tq0 = jmax(t_q, 0.0f);
  const float node_en = max3(plane(t1[0], dc[0], 0), plane(t1[1], dc[1], 0),
                             plane(t1[2], dc[2], 0));
  const float node_ex = min3(t1[0], t1[1], t1[2]);
  const float t_start = jmax(node_en, tq0);
  if (!(t_start < node_ex)) return none;
  int cx = (plane(t1[0], dc[0], 1) <= t_start) + (plane(t1[0], dc[0], 2) <= t_start) +
           (plane(t1[0], dc[0], 3) <= t_start);
  int cy = (plane(t1[1], dc[1], 1) <= t_start) + (plane(t1[1], dc[1], 2) <= t_start) +
           (plane(t1[1], dc[1], 3) <= t_start);
  int cz = (plane(t1[2], dc[2], 1) <= t_start) + (plane(t1[2], dc[2], 2) <= t_start) +
           (plane(t1[2], dc[2], 3) <= t_start);
  float en = max3(plane(t1[0], dc[0], cx), plane(t1[1], dc[1], cy), plane(t1[2], dc[2], cz));
  float nx = plane(t1[0], dc[0], min(cx + 1, 4));
  float ny = plane(t1[1], dc[1], min(cy + 1, 4));
  float nz = plane(t1[2], dc[2], min(cz + 1, 4));
  for (int slot = 0; slot < 10; ++slot) {
    count_pass(wp);
    ++*slots;
    const float ex = min3(nx, ny, nz);
    const int cell = cell_of(cx, cy, cz);
    if (bit_at(lo, hi, cell ^ vm6) && en < ex && ex > tq0) return Walk{en, ex, cell};
    if (slot == 9) break;
    en = ex;
    if (nx <= ny && nx <= nz) {
      if (++cx >= 4) break;
      nx = plane(t1[0], dc[0], min(cx + 1, 4));
    } else if (ny <= nz) {
      if (++cy >= 4) break;
      ny = plane(t1[1], dc[1], min(cy + 1, 4));
    } else {
      if (++cz >= 4) break;
      nz = plane(t1[2], dc[2], min(cz + 1, 4));
    }
  }
  return none;
}

// bit_at for a cell in [0, 64): the 64-bit (hi:lo) shifted right by the cell
// in one funnel shift (shr.b64 clamps its count), then its low bit.
__device__ __forceinline__ bool bit_at_hopper(uint32_t lo, uint32_t hi, int cell) {
  uint64_t v;
  asm("mov.b64 %0, {%1, %2};" : "=l"(v) : "r"(lo), "r"(hi));
  asm("shr.b64 %0, %0, %1;" : "+l"(v) : "r"(cell));
  return (static_cast<uint32_t>(v) & 1u) != 0u;
}

// pc64_below for a cell in [0, 64): (hi:lo) shifted left by 64 - cell keeps
// exactly the bits below the cell (none for cell 0: shl.b64 clamps its
// count at 64), and its two words' popcounts add.
__device__ __forceinline__ uint32_t pc64_below_hopper(uint32_t lo, uint32_t hi, int cell) {
  uint64_t v;
  asm("mov.b64 %0, {%1, %2};" : "=l"(v) : "r"(lo), "r"(hi));
  asm("shl.b64 %0, %0, %1;" : "+l"(v) : "r"(64 - cell));
  return __popc(static_cast<uint32_t>(v)) + __popc(static_cast<uint32_t>(v >> 32));
}

// The walk probe: walk64's Hopper form (or the sweep's) on masks stepped by
// an LCG. Each repeat multiplies the planes by a 1.0f made from the repeat's
// mask and `zero` (0, from the launcher: a value the compiler cannot know),
// so the whole walk or sweep runs in every repeat and none of it is hoisted
// out of the repeat loop, as in the traversal, where every call has a node
// of its own (left to itself the compiler keeps the planes, and the sweep
// its cells' entries and exits, out of the loop); exact, and one LOP3 and
// six FMUL a repeat. Replaces hako_kernel_micro.py's k_walk (:77) and
// scan64 (:90). A warp-repeat's floors: the walk 42 SM-clocks of issue and
// 37 on the integer pipe for its static SASS (its warps run their slowest
// lane's slots), the sweep 82 and 112: it is pipe-bound; at the script's
// shape each launch also pays an empty grid's ~2.2 us.
template <bool SCAN>
__global__ void walk_probe_kernel(const uint32_t* lo0, const uint32_t* hi0,
                                  const float* t1, const float* dc, int n,
                                  int iters, uint32_t zero, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t lo = lo0[i], hi = hi0[i];
  const float t1v[3] = {t1[i], t1[n + i], t1[2 * n + i]};
  const float dcv[3] = {dc[i], dc[n + i], dc[2 * n + i]};
  int acc = 0;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    const uint32_t unit = 1u | (lo & zero);
    const float one = __uint_as_float(0x3f800000u | (lo & zero));
    const float t1k[3] = {t1v[0] * one, t1v[1] * one, t1v[2] * one};
    const float dck[3] = {dcv[0] * one, dcv[1] * one, dcv[2] * one};
    acc += SCAN ? scan64_cell(lo, hi, 0, t1k, dck, 0.0f, unit)
                : walk64_hopper<false>(lo, hi, 0, t1k, dck, 0.0f).c;
    lo = lo * 1664525u + 1013904223u;
    hi = hi * 22695477u + 1u;
  }
  out[i] = acc;
}

// The walk probe's counting variant (the Hopper walk or walk64 as it is):
// out[0][i] / out[1][i] the warp passes and active lanes this lane counted
// (the lowest active lane of each pass counts it: the sums over a launch's
// lanes are its warps' passes and lane-slots), out[2][i] the lane's own
// slots; and the same checksum as the probe in out[3][i].
template <bool HOPPER>
__global__ void walk_count_kernel(const uint32_t* lo0, const uint32_t* hi0, const float* t1,
                                  const float* dc, int n, int iters, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t lo = lo0[i], hi = hi0[i];
  const float t1v[3] = {t1[i], t1[n + i], t1[2 * n + i]};
  const float dcv[3] = {dc[i], dc[n + i], dc[2 * n + i]};
  hako::WarpPass wp{0, 0};
  int slots = 0, acc = 0;
  for (int k = 0; k < iters; ++k) {
    acc += HOPPER ? walk64_hopper<true>(lo, hi, 0, t1v, dcv, 0.0f, &wp, &slots).c
                  : walk64_counted(lo, hi, 0, t1v, dcv, 0.0f, &wp, &slots).c;
    lo = lo * 1664525u + 1013904223u;
    hi = hi * 22695477u + 1u;
  }
  out[i] = static_cast<int>(wp.passes);
  out[n + i] = static_cast<int>(wp.popc);
  out[2 * n + i] = slots;
  out[3 * n + i] = acc;
}

// The forms side by side for the card tests: FORM 0 hako::walk64, 1 the
// Hopper walk, 2 the sweep's cell (en, ex left at FLT_MAX), each once a lane
// on its own vm6 and t_q.
template <int FORM>
__global__ void walk_form_kernel(const uint32_t* lo, const uint32_t* hi, const int* vm6,
                                 const float* t1, const float* dc, const float* tq, int n,
                                 float* en, float* ex, int* c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t1v[3] = {t1[i], t1[n + i], t1[2 * n + i]};
  const float dcv[3] = {dc[i], dc[n + i], dc[2 * n + i]};
  hako::Walk w{hako::kMaxFloat, hako::kMaxFloat, 64};
  if (FORM == 0) {
    w = hako::walk64(lo[i], hi[i], vm6[i], t1v, dcv, tq[i]);
  } else if (FORM == 1) {
    w = walk64_hopper<false>(lo[i], hi[i], vm6[i], t1v, dcv, tq[i]);
  } else {
    w.c = scan64_cell(lo[i], hi[i], vm6[i], t1v, dcv, tq[i]);
  }
  en[i] = w.en;
  ex[i] = w.ex;
  c[i] = w.c;
}

// bit_at / pc64_below in both forms for every cell of each lane's mask:
// out[f][i][cell], f = hako::bit_at, bit_at_hopper, hako::pc64_below,
// pc64_below_hopper.
__global__ void bit_form_kernel(const uint32_t* lo, const uint32_t* hi, int n, int* out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 64) return;
  const int i = t >> 6, cell = t & 63;
  const size_t plane = static_cast<size_t>(n) * 64;
  out[t] = hako::bit_at(lo[i], hi[i], cell);
  out[plane + t] = bit_at_hopper(lo[i], hi[i], cell);
  out[2 * plane + t] = static_cast<int>(hako::pc64_below(lo[i], hi[i], cell));
  out[3 * plane + t] = static_cast<int>(pc64_below_hopper(lo[i], hi[i], cell));
}

// fetch_probe: the lane's row words from shared memory, as the reference's
// k_words selected among words already on chip (its lanes' BRICK_WORDS
// words a VMEM block, brought in by the grid pipeline's DMA). A repeat
// reads words 2s, 2s+1 with s <= 63, so a lane needs words 0-127 of its
// row (512 B). Each warp stages its 32 lanes' words with coalesced 16-byte
// cp.async copies, a row an instruction (lane l copies bytes 16l..16l+15
// of row r), waits for them, and then runs the `iters` dependent fetches
// from shared memory (LDS.64) instead of from L2. A lane's words sit at a
// stride of kFetchStride words (528 B: 16-byte aligned for the copies, and
// lanes at one s fall in different banks). A block stages at most
// kFetchBuffers warps at once (16.5 KB each); a warp past them takes the
// buffer of the warp kFetchBuffers before it when that warp is done with
// it (an mbarrier that warp arrives on, used once). The repeat loop is the
// only loop before the kernel's last EXIT but for that wait (whose retry
// and a divergent warp's sync sit past it), so utils/sass.py reads the
// repeat loop's body. Every repeat still reads both words of
// the row and xors them: folding the table (w0 ^ w1 a row) or reading one
// word would remove the work the probe measures.
constexpr int kFetchWords = 128;               // words 0-127 of a row: s <= 63
constexpr int kFetchStride = kFetchWords + 4;  // a lane's staged words, padded
constexpr int kFetchBuffers = 4;               // warps a block stages at once

size_t fetch_smem_bytes(int threads) {
  const int warps = threads / 32;
  const int bufs = warps < kFetchBuffers ? warps : kFetchBuffers;
  return static_cast<size_t>(bufs) * 32 * kFetchStride * 4 + (warps - bufs) * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void fetch_probe_kernel(const uint32_t* rows, const int* row_of,
                                   int n, int iters, int* out) {
  extern __shared__ uint4 s_fetch[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bufs = warps < kFetchBuffers ? warps : kFetchBuffers;
  uint32_t* words = reinterpret_cast<uint32_t*>(s_fetch) + (warp % bufs) * 32 * kFetchStride;
  // bars[w]: warp w is done with its buffer (for warp w + bufs)
  const uint32_t bars = smem_addr(reinterpret_cast<uint32_t*>(s_fetch) + bufs * 32 * kFetchStride);
  if (warps > bufs) {
    if (lane == 0 && warp < warps - bufs) {  // one lane a warp: no per-thread addresses
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bars + 8 * warp), "r"(1u)
                   : "memory");
    }
    __syncthreads();
  }
  if (warp >= bufs) {
    uint32_t done;
    do {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bars + 8 * (warp - bufs)), "r"(0u) : "memory");
    } while (!done);
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int first = i - lane;  // the warp's lane 0
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    if (first + r < n) {
      const int row = __ldg(row_of + first + r);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   ::"r"(smem_addr(words + r * kFetchStride + 4 * lane)),
                   "l"(rows + static_cast<size_t>(row) * hako::kRowWords + 4 * lane)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  const uint32_t mine = smem_addr(words + lane * kFetchStride);
  uint32_t s = i & 63, acc = 0;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
    uint32_t w0, w1;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(w0), "=r"(w1) : "r"(mine + 8u * s));
    acc ^= w0 ^ w1;
    s = (w0 ^ w1 ^ static_cast<uint32_t>(k)) & 63u;
  }
  __syncwarp();
  if (lane == 0 && warp + bufs < warps) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bars + 8 * warp) : "memory");
  }
  if (i < n) out[i] = static_cast<int>(acc);
}

// l2_read_probe: the card's L2 read rate, the rate at which the fetch's
// staging reads its rows (scripts/row_stage_ab.py): a grid that fills the
// card reads an L2-resident buffer of 16-byte vectors `passes` times, grid
// stride, with ld.global.cg (past L1; volatile, so that no pass is folded
// into another), four independent loads in flight a thread where the
// buffer gives them, and writes one sum a thread: out[g] = the sum over the
// passes and the vectors g, g + G, ... (G the grid's threads) of
// x ^ y ^ z ^ w, mod 2^32. It reads each byte once a pass and writes 4 B a
// thread.
__device__ __forceinline__ uint32_t ldcg_xor(const uint4* p) {
  uint32_t x, y, z, w;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "l"(p));
  return x ^ y ^ z ^ w;
}

__global__ void l2_read_probe_kernel(const uint4* buf, long long n_vec, int passes,
                                     uint32_t* out) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  uint32_t acc = 0;
  for (int p = 0; p < passes; ++p) {
    long long i = g;
    for (; i + 3 * stride < n_vec; i += 4 * stride) {
      const uint32_t a = ldcg_xor(buf + i), b = ldcg_xor(buf + i + stride);
      const uint32_t c = ldcg_xor(buf + i + 2 * stride), d = ldcg_xor(buf + i + 3 * stride);
      acc += a + b + c + d;
    }
    for (; i < n_vec; i += stride) acc += ldcg_xor(buf + i);
  }
  out[g] = acc;
}

constexpr int kUnroll = 8;  // repeats in one pass of a probe's outer loop

enum Construct { kMinMax, kCmpSel, kInt, kVShift, kBarrel, kI2F, kBitAt, kPc64 };

// One lane: K = outer * kUnroll dependent repeats of construct C
// (construct_micro.py :42). fa / fb f32, ia i32, ua / ub u32 inputs; fout
// (f32 constructs) or iout. bitat and pc64 are the Hopper forms
// (bit_at_hopper, pc64_below_hopper): a repeat of bitat 1.1 SM-clocks of
// issue and 1.6 on the integer pipe a warp, of pc64 1.8 of issue and 4 on
// the POPC pipe (its 2 POPC); at the script's shape each launch also pays
// an empty grid's ~2.2 us.
template <int C>
__global__ void construct_probe_kernel(const float* fa, const float* fb,
                                       const int* ia, const uint32_t* ua,
                                       const uint32_t* ub, int n, int outer,
                                       float* fout, int* iout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (C == kMinMax || C == kCmpSel) {
    float x = fa[i];
    const float y = fb[i];
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (C == kMinMax) {
          x = fminf(fmaxf(x, y), y + x);
        } else {
          x = x < y ? x + y : y;
        }
      }
    }
    fout[i] = x;
  } else if constexpr (C == kI2F) {
    int x = ia[i];
    float acc = 0.0f;
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc = acc + static_cast<float>(x & 255);
        x = x ^ static_cast<int>(acc);
      }
    }
    fout[i] = acc;
  } else {
    // integer chains in u32 (wrap-around adds); >> 3 of kInt is arithmetic
    uint32_t x = static_cast<uint32_t>(ia[i]);
    const uint32_t m0 = C == kInt ? 0u : ua[i];
    const uint32_t m1 = (C == kBitAt || C == kPc64) ? ub[i] : 0u;
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if constexpr (C == kInt) {
          x = ((x + 7u) & 0x7FFFFFFu) ^
              static_cast<uint32_t>(static_cast<int>(x) >> 3);
        } else if constexpr (C == kVShift) {
          x += (m0 >> (x & 31u)) & 1u;
        } else if constexpr (C == kBarrel) {
          const uint32_t sh = x & 31u;
          uint32_t v = m0;
          v = (sh & 1u) ? v >> 1 : v;
          v = (sh & 2u) ? v >> 2 : v;
          v = (sh & 4u) ? v >> 4 : v;
          v = (sh & 8u) ? v >> 8 : v;
          v = (sh & 16u) ? v >> 16 : v;
          x += v & 1u;
        } else if constexpr (C == kBitAt) {
          x += bit_at_hopper(m0, m1, static_cast<int>(x & 63u)) ? 1u : 0u;
        } else {
          x += pc64_below_hopper(m0, m1, static_cast<int>(x & 63u));
        }
      }
    }
    iout[i] = static_cast<int>(x);
  }
}

template <int C>
int launch_construct(const float* fa, const float* fb, const int* ia,
                     const uint32_t* ua, const uint32_t* ub, int n, int outer,
                     void* out, int threads, cudaStream_t s) {
  construct_probe_kernel<C><<<(n + threads - 1) / threads, threads, 0, s>>>(
      fa, fb, ia, ua, ub, n, outer, static_cast<float*>(out),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

enum Space { kGlobal, kShared, kConstant };
constexpr int kMaxNodes = 4096;  // 4096 x 12 B = 48 KB of constant memory
__constant__ uint32_t c_nodes[3 * kMaxNodes];
__constant__ uint32_t c_select[3 * 64];

// One lane: K dependent node fetches, idx = (idx0 + acc) & (n_nodes - 1),
// acc = (acc + base) & 31, fold ^= mask_lo ^ mask_hi, from the table in
// global memory (__ldg) or in constant memory (the shared form is
// node_gather_shared_kernel below).
template <int SPACE>
__global__ void node_gather_probe_kernel(const uint32_t* table, int n_nodes,
                                         const int* idx0, int n, int outer,
                                         int* acc_out, int* fold_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  const uint32_t wrap = static_cast<uint32_t>(n_nodes - 1);
  uint32_t acc = 0, fold = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t w = 3u * ((start + acc) & wrap);
      uint32_t lo, hi, base;
      if constexpr (SPACE == kGlobal) {
        lo = __ldg(table + w);
        hi = __ldg(table + w + 1);
        base = __ldg(table + w + 2);
      } else {
        lo = c_nodes[w];
        hi = c_nodes[w + 1];
        base = c_nodes[w + 2];
      }
      acc = (acc + base) & 31u;
      fold ^= lo ^ hi;
    }
  }
  if (live) {
    acc_out[i] = static_cast<int>(acc);
    fold_out[i] = static_cast<int>(fold);
  }
}

// The shared forms (node_gather_shared_kernel, table_select_shared_kernel):
// a table of 3-word entries (the reference's node: mask_lo, mask_hi, base;
// or a select entry) staged in shared memory, then K dependent fetches of
// an entry a lane. What bounds them on an H100: shared memory serves a
// warp's load in wavefronts of at most one 4-byte word a bank (32 banks,
// 128 B a clock an SM; a word asked for by several lanes is broadcast), so
// 3 words a lane are at least 3 wavefronts a warp-repeat (0.0249 ms for the
// Meter's 270,336 lanes x 256 repeats at the 1.98 GHz clock), beside the
// loop's issue floor; random entries of the packed table (stride 3 words)
// put several distinct words in a bank: 6.0 / 8.4 / 10.3 / 10.5 wavefronts
// a warp-repeat at 64 / 128 / 1,024 / 4,096 entries
// (scripts/common.smem_wavefronts), and commit 6fa41fa's kernels ran at that
// wavefront rate, not at their issue rate. And the staging: every block
// reads the whole table from L2 (48 KB at 4,096 nodes: 25 MB for the JAX
// script's 512 blocks, 3.8 us at the 6.6-6.8 TB/s that l2_read_probe reads),
// which 6fa41fa's blocks copied a word a thread at a time.
// What the design does: the layout <REC, COPIES> gives the lanes of a warp
// copies in distinct banks where they fit. REC 3 keeps an entry's 3 words
// packed, each word repeated COPIES times side by side, lane l reading copy
// l % COPIES: with 32 copies every lane has a bank of its own, 3 wavefronts
// a warp-repeat (3 LDS.32). REC 4 pads an entry to a 16-byte record,
// COPIES records side by side, lane l reading copy (l % 8) % COPIES: a
// 16-byte load is served a quarter-warp (8 lanes, 128 B) at a time, so 4
// copies halve a phase's conflicts (1 LDS.128). <3, 1> is the packed
// table. The table comes in by one bulk copy (cp.async.bulk, issued by one
// thread, completing on one mbarrier a block; where the table or its bytes
// are not 16-byte aligned every thread copies words instead), and a layout
// with copies is written out of it with 16-byte stores. (A cluster of 2
// or 4 blocks multicasting it read less from L2 and was slower: PERF.md
// section 6, the node fetch's shared form.)
template <int REC, int COPIES>
struct Staged {
  static_assert((REC == 3 && (COPIES == 1 || COPIES % 4 == 0)) || REC == 4,
                "3 packed words, 1 or 4k copies; or a 16-byte record");
  static constexpr bool kPacked = REC == 3 && COPIES == 1;
  // 32-bit words of a staged table of n entries
  __host__ __device__ static constexpr uint32_t words(int n) {
    return static_cast<uint32_t>(n) * REC * COPIES;
  }
  // the words of staged chunk q (16 bytes) from the packed table
  __device__ static uint4 chunk(const uint32_t* raw, uint32_t q) {
    if constexpr (REC == 4) {
      const uint32_t* e = raw + 3u * (q / COPIES);
      return make_uint4(e[0], e[1], e[2], 0u);
    } else {
      const uint32_t x = raw[4u * q / COPIES];
      return make_uint4(x, x, x, x);
    }
  }
};

// The dynamic shared memory of a staged table of n entries: the staged
// words, the packed table where the layout has copies (the bulk copy's
// destination), and the mbarrier, each 16-byte aligned.
template <int REC, int COPIES>
size_t staged_smem_bytes(int n) {
  const size_t out = (Staged<REC, COPIES>::words(n) * 4 + 15) / 16 * 16;
  const size_t raw =
      Staged<REC, COPIES>::kPacked ? 0 : (static_cast<size_t>(n) * 12 + 15) / 16 * 16;
  return out + raw + 16;
}

// Stages the packed table src (n entries of 3 words) in layout <REC,
// COPIES> at the start of the dynamic shared memory s, as set out above;
// every thread of the block calls it, and it ends with the table in place
// for all of them.
template <int REC, int COPIES>
__device__ void stage_table(const uint32_t* src, int n, uint32_t* s) {
  using L = Staged<REC, COPIES>;
  const uint32_t words = 3u * static_cast<uint32_t>(n);
  uint32_t* raw = L::kPacked ? s : s + (L::words(n) + 3u) / 4u * 4u;
  uint32_t* bar = raw + (words + 3u) / 4u * 4u;
  const uint32_t bar_a = smem_addr(bar);
  const uint32_t bytes = 4u * words;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && bytes % 16u == 0) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar_a), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_a), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(raw)), "l"(src), "r"(bytes), "r"(bar_a) : "memory");
    }
    uint32_t done;
    do {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar_a), "r"(0u) : "memory");
    } while (!done);
  } else {
#pragma unroll 1
    for (uint32_t j = threadIdx.x; j < words; j += blockDim.x) raw[j] = __ldg(src + j);
    __syncthreads();
  }
  if constexpr (!L::kPacked) {
    uint4* out = reinterpret_cast<uint4*>(s);
#pragma unroll 4
    for (uint32_t q = threadIdx.x; q < L::words(n) / 4u; q += blockDim.x) {
      out[q] = L::chunk(raw, q);
    }
    __syncthreads();
  }
}

// Entry e's 3 words for this lane from a table staged in layout <REC,
// COPIES> at s: one multiply-add gives the lane's address, then 3 LDS.32
// at immediate offsets (REC 3) or one LDS.128 (REC 4).
template <int REC, int COPIES>
struct StagedReader {
  uint32_t mine;  // the lane's copy of entry 0, a shared-window byte address
  __device__ StagedReader(const uint32_t* s, int lane)
      : mine(smem_addr(s) + 4u * (REC == 4 ? 4 * ((lane & 7) % COPIES) : lane % COPIES)) {}
  __device__ __forceinline__ void operator()(uint32_t e, uint32_t& w0, uint32_t& w1,
                                             uint32_t& w2) const {
    const uint32_t a = mine + e * (4u * REC * COPIES);
    if constexpr (REC == 4) {
      uint32_t pad;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(pad) : "r"(a));
    } else {
      asm volatile("ld.shared.u32 %0, [%1];" : "=r"(w0) : "r"(a));
      asm volatile("ld.shared.u32 %0, [%1+%2];" : "=r"(w1) : "r"(a), "n"(4 * COPIES));
      asm volatile("ld.shared.u32 %0, [%1+%2];" : "=r"(w2) : "r"(a), "n"(8 * COPIES));
    }
  }
};

// node_gather_probe<kShared> (hako_kernel_micro.py k_gflat / k_gsplit; the
// node fetch of a level the reference holds in SMEM, _gather_node_smem):
// the fetches of node_gather_probe_kernel from the table staged in layout
// <REC, COPIES> (the launcher picks it from n_nodes alone, gather_plan).
// Every thread runs the loop.
template <int REC, int COPIES>
__global__ void node_gather_shared_kernel(const uint32_t* table, int n_nodes,
                                          const int* idx0, int n, int outer,
                                          int* acc_out, int* fold_out) {
  extern __shared__ uint4 s_dyn[];
  uint32_t* s = reinterpret_cast<uint32_t*>(s_dyn);
  stage_table<REC, COPIES>(table, n_nodes, s);
  const StagedReader<REC, COPIES> fetch(s, threadIdx.x & 31);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  const uint32_t wrap = static_cast<uint32_t>(n_nodes - 1);
  uint32_t acc = 0, fold = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t lo, hi, base;
      fetch((start + acc) & wrap, lo, hi, base);
      acc = (acc + base) & 31u;
      fold ^= lo ^ hi;
    }
  }
  if (live) {
    acc_out[i] = static_cast<int>(acc);
    fold_out[i] = static_cast<int>(fold);
  }
}

enum Form { kSelConstant, kSelShared, kSelShuffle };

// One lane: K dependent selects from 64 entries of 3 words,
// sel = (idx0 + acc) & 63, acc = (acc + (w0 ^ w1 ^ w2)) & 31, from
// constant memory or from registers across the warp (the shared form is
// table_select_shared_kernel below). Every thread runs the loop (the
// shuffle form needs the whole warp).
template <int FORM>
__global__ void table_select_probe_kernel(const uint32_t* tab, const int* idx0,
                                          int n, int outer, int* out) {
  constexpr unsigned kFull = 0xffffffffu;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  uint32_t reg[3][2];
  if constexpr (FORM == kSelShuffle) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      reg[j][0] = __ldg(tab + 3 * lane + j);
      reg[j][1] = __ldg(tab + 3 * (lane + 32) + j);
    }
  }
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  uint32_t acc = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t sel = (start + acc) & 63u;
      uint32_t w[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if constexpr (FORM == kSelConstant) {
          w[j] = c_select[3 * sel + j];
        } else {
          const uint32_t a = __shfl_sync(kFull, reg[j][0], sel & 31u);
          const uint32_t b = __shfl_sync(kFull, reg[j][1], sel & 31u);
          w[j] = (sel & 32u) ? b : a;
        }
      }
      acc = (acc + (w[0] ^ w[1] ^ w[2])) & 31u;
    }
  }
  if (live) out[i] = static_cast<int>(acc);
}

// table_select_probe<kSelShared> (hako_kernel_micro.py k_fold:
// _fold_select over 64 x 3 words in SMEM): the selects of
// table_select_probe_kernel from the 768-byte table staged in layout
// <REC, COPIES> (kSelRec, kSelCopies: 32 word copies).
template <int REC, int COPIES>
__global__ void table_select_shared_kernel(const uint32_t* tab, const int* idx0, int n,
                                           int outer, int* out) {
  extern __shared__ uint4 s_dyn[];
  uint32_t* s = reinterpret_cast<uint32_t*>(s_dyn);
  stage_table<REC, COPIES>(tab, 64, s);
  const StagedReader<REC, COPIES> fetch(s, threadIdx.x & 31);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const uint32_t start = live ? static_cast<uint32_t>(idx0[i]) : 0u;
  uint32_t acc = 0;
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t w0, w1, w2;
      fetch((start + acc) & 63u, w0, w1, w2);
      acc = (acc + (w0 ^ w1 ^ w2)) & 31u;
    }
  }
  if (live) out[i] = static_cast<int>(acc);
}

enum Calib { kChain, kPar8 };

// kChain: K dependent x = x * 1.0000001f + b (the reference: K = 1024);
// kPar8: 8 independent chains of K (the reference: 128) from x_j = a + j
// with b = a, then summed in order.
template <int KIND>
__global__ void calib_probe_kernel(const float* a, const float* b, int n,
                                   int outer, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c = 1.0000001f;
  if constexpr (KIND == kChain) {
    float x = a[i];
    const float y = b[i];
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = x * c + y;
    }
    out[i] = x;
  } else {
    const float y = a[i];
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = a[i] + static_cast<float>(j);
#pragma unroll 1
    for (int o = 0; o < outer; ++o) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = x[j] * c + y;
      }
    }
    float r = x[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) r = r + x[j];
    out[i] = r;
  }
}

// pipe_probe<A, B> (no counterpart in the reference; it extends the
// calibration): the rate at which an SM issues one class of warp
// instruction, and whether two classes issue side by side. A lane runs two
// groups of chains, group 0 class A and group 1 class B (A == B: one class
// alone), kPipeUnroll steps of each a pass. A group is 4 register chains, a
// step's new value of chain j read from chains j, j + 1 and j + 3 (mod 4) of
// the step before (so that no step folds into another; min / max of chains
// j and j + 1, through asm), or, for the compares, 2
// predicate chains, q = (a compare against the step's own immediate) and
// not q, which no reassociation splits: FSETP compares a float pass counter
// (the pass plus in[0] & 1), ISETP a u32 that an IMAD steps each pass (ol =
// ol * 0x9E3779B1 + 1 from in[0]) against the group's chain j + u (mod 4)
// plus u * 0x01000193, both as ints (against immediates the compiler solved
// the chain without a loop); the one-input classes (POPC, I2F, F2I) and FADD /
// FMUL step each chain alone. in: u32 [8, n], group 0's chains then group
// 1's; out: int32 [9, n], the chains' final values and the predicate bits
// (group g's chain j at bit 2 g + j). At full occupancy the k-to-2k slope
// gives a class's warp instructions a clock an SM (the loop's own compare
// and branch are 2 of a pass's 66 or more).
enum PipeOp { kPipeFp32, kPipeFMnMx, kPipeFSetp, kPipeISetp, kPipeLop3, kPipeShf, kPipeSel,
              kPipeFSel, kPipeIAdd3, kPipeIMad, kPipePopc, kPipeI2F, kPipeF2I, kPipeOps };
constexpr int kPipeUnroll = 8;

template <int OP>
__device__ __forceinline__ void pipe_step(uint32_t (&a)[4], bool (&q)[2], const float (&y)[4],
                                          int ol, float ofl, int u, int g, bool p) {
  if constexpr (OP == kPipeFSetp || OP == kPipeISetp) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = (g * 2 + j) * kPipeUnroll + u;
      // ISETP's threshold: a chain's (unchanging) value and the step
      const int th = static_cast<int>(a[(j + u) & 3] + static_cast<uint32_t>(u) * 0x01000193u);
      q[j] = !q[j] && (OP == kPipeFSetp ? ofl > 0.5f * static_cast<float>(t) + 0.25f : ol > th);
    }
  } else if constexpr (OP == kPipeFp32 || OP == kPipePopc || OP == kPipeI2F ||
                       OP == kPipeF2I) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (OP == kPipeFp32) {
        a[j] = __float_as_uint(__uint_as_float(a[j]) * 1.0000001f + y[j]);
      } else if constexpr (OP == kPipePopc) {
        a[j] = static_cast<uint32_t>(__popc(a[j]));
      } else if constexpr (OP == kPipeI2F) {
        a[j] = __float_as_uint(static_cast<float>(static_cast<int>(a[j])));
      } else {
        a[j] = static_cast<uint32_t>(__float2int_rz(__uint_as_float(a[j])));
      }
    }
  } else {
    uint32_t r[4];
    const bool pu = (u & 1) ? !p : p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t x = a[j], b = a[(j + 1) & 3], c = a[(j + 3) & 3];
      if constexpr (OP == kPipeFMnMx) {
        float v;
        if (u & 1) {
          asm("min.f32 %0, %1, %2;" : "=f"(v) : "f"(__uint_as_float(x)), "f"(__uint_as_float(b)));
        } else {
          asm("max.f32 %0, %1, %2;" : "=f"(v) : "f"(__uint_as_float(x)), "f"(__uint_as_float(b)));
        }
        r[j] = __float_as_uint(v);
      } else if constexpr (OP == kPipeLop3) {
        r[j] = (x & b) ^ c;
      } else if constexpr (OP == kPipeShf) {
        r[j] = __funnelshift_r(x, b, c);
      } else if constexpr (OP == kPipeSel) {
        asm("{\n\t.reg .pred s;\n\tsetp.ne.u32 s, %3, 0;\n\tselp.b32 %0, %1, %2, s;\n\t}"
            : "=r"(r[j]) : "r"(b), "r"(c), "r"(static_cast<uint32_t>(pu)));
      } else if constexpr (OP == kPipeFSel) {
        float v;
        asm("{\n\t.reg .pred s;\n\tsetp.ne.u32 s, %3, 0;\n\tselp.f32 %0, %1, %2, s;\n\t}"
            : "=f"(v) : "f"(__uint_as_float(b)), "f"(__uint_as_float(c)),
              "r"(static_cast<uint32_t>(pu)));
        r[j] = __float_as_uint(v);
      } else if constexpr (OP == kPipeIAdd3) {
        r[j] = x + b + c;
      } else {
        r[j] = x * b + c;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = r[j];
  }
}

template <int A, int B>
__global__ void pipe_probe_kernel(const uint32_t* in, int n, int outer, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a0[4], a1[4];
  float y0[4], y1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a0[j] = in[j * n + i];
    a1[j] = in[(4 + j) * n + i];
    y0[j] = __uint_as_float(a0[j]);
    y1[j] = __uint_as_float(a1[j]);
  }
  uint32_t ol = a0[0];
  bool q0[2] = {false, false}, q1[2] = {false, false};
  float ofl = static_cast<float>(a0[0] & 1u);
#pragma unroll 1
  for (int o = 0; o < outer; ++o) {
    const bool p = (o & 1) != 0;
#pragma unroll
    for (int u = 0; u < kPipeUnroll; ++u) {
      pipe_step<A>(a0, q0, y0, static_cast<int>(ol), ofl, u, 0, p);
      pipe_step<B>(a1, q1, y1, static_cast<int>(ol), ofl, u, 1, p);
    }
    ofl = ofl + 1.0f;
    ol = ol * 0x9E3779B1u + 1u;
  }
  const int bits = (q0[0] ? 1 : 0) | (q0[1] ? 2 : 0) | (q1[0] ? 4 : 0) | (q1[1] ? 8 : 0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j * n + i] = static_cast<int>(a0[j]);
    out[(4 + j) * n + i] = static_cast<int>(a1[j]);
  }
  out[8 * n + i] = bits;
}

// A launch that does nothing: the fixed cost of a grid (start and drain),
// beside the probes at the JAX scripts' shape.
__global__ void empty_probe_kernel() {}

// The pairs pipe_probe_launch takes (ops/probes.py PIPE_PAIRS): each class
// alone, each beside LOP3, beside IMAD, and the slow classes beside each
// other.
#define PIPE_PAIRS(X)                                                                  \
  X(kPipeFp32, kPipeFp32) X(kPipeFMnMx, kPipeFMnMx) X(kPipeFSetp, kPipeFSetp)          \
  X(kPipeISetp, kPipeISetp) X(kPipeLop3, kPipeLop3) X(kPipeShf, kPipeShf)              \
  X(kPipeSel, kPipeSel) X(kPipeFSel, kPipeFSel) X(kPipeIAdd3, kPipeIAdd3)              \
  X(kPipeIMad, kPipeIMad) X(kPipePopc, kPipePopc) X(kPipeI2F, kPipeI2F)                \
  X(kPipeF2I, kPipeF2I)                                                                \
  X(kPipeFp32, kPipeLop3) X(kPipeFMnMx, kPipeLop3) X(kPipeFSetp, kPipeLop3)            \
  X(kPipeISetp, kPipeLop3) X(kPipeShf, kPipeLop3) X(kPipeSel, kPipeLop3)               \
  X(kPipeFSel, kPipeLop3) X(kPipeIAdd3, kPipeLop3) X(kPipeIMad, kPipeLop3)             \
  X(kPipePopc, kPipeLop3) X(kPipeI2F, kPipeLop3) X(kPipeF2I, kPipeLop3)                \
  X(kPipeFp32, kPipeIMad) X(kPipeFMnMx, kPipeIMad) X(kPipeFSetp, kPipeIMad)            \
  X(kPipeIAdd3, kPipeIMad) X(kPipeShf, kPipeIMad) X(kPipePopc, kPipeIMad)              \
  X(kPipeI2F, kPipeIMad) X(kPipeFp32, kPipeFMnMx) X(kPipeFp32, kPipePopc)              \
  X(kPipePopc, kPipeI2F) X(kPipePopc, kPipeF2I) X(kPipeI2F, kPipeF2I)

constexpr int kShellArrays = 8;
constexpr int kShellThreads = 128;  // the shell's block
constexpr int kShellLoads = 8;      // float4 loads a thread has in flight before it stores
constexpr int kLaneThreads = 128;  // the round kernels' block
constexpr int kMaxStageLevels = 8;  // must match utils/cuda_build.py MAX_LEVELS

struct ShellParams {
  const float* in[kShellArrays];
  float* out[kShellArrays];
  int n;  // floats an array
};

__device__ __forceinline__ float4 plus_one(float4 v) {
  return make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
}

// o = i + 1 over the first ARRAYS arrays of n floats, streamed: a
// grid-stride loop over tiles of kShellThreads x U float4s of each array
// (U = kShellLoads / ARRAYS), every thread issuing its kShellLoads
// independent 16-byte loads before its first store. The loads are
// evict-first (ld.global.cs: each input is read once); the stores are
// plain, so a caller that writes the same outputs again finds their
// lines still in L2 (on an H100 SXM, evict-first stores were no faster
// into new outputs and up to 7% slower into the same ones). A partial
// last tile checks each float4, and block 0's first threads take the
// n % 4 floats past the last whole float4.
template <int ARRAYS>
__global__ void __launch_bounds__(kShellThreads) shell_copy_kernel(const ShellParams p) {
  constexpr int U = kShellLoads / ARRAYS;
  constexpr int kTile = kShellThreads * U;  // float4s of each array a block-step
  const int n4 = p.n / 4;
  for (int base = blockIdx.x * kTile; base < n4; base += gridDim.x * kTile) {
    const bool whole = base + kTile <= n4;
    float4 v[ARRAYS][U];
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) {
      const float4* in = reinterpret_cast<const float4*>(p.in[a]) + base + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (whole || base + u * kShellThreads + static_cast<int>(threadIdx.x) < n4)
          v[a][u] = __ldcs(in + u * kShellThreads);
      }
    }
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) {
      float4* out = reinterpret_cast<float4*>(p.out[a]) + base + threadIdx.x;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (whole || base + u * kShellThreads + static_cast<int>(threadIdx.x) < n4)
          out[u * kShellThreads] = plus_one(v[a][u]);
      }
    }
  }
  const int k = 4 * n4 + static_cast<int>(threadIdx.x);
  if (blockIdx.x == 0 && k < p.n) {
#pragma unroll
    for (int a = 0; a < ARRAYS; ++a) p.out[a][k] = p.in[a][k] + 1.0f;
  }
}

struct PreambleParams {
  const float* ray[6];  // ox, oy, oz, dx, dy, dz [n]
  const float* bounds;  // lower[3], upper[3]
  int n;
  float* out[8];
};

__global__ void __launch_bounds__(kLaneThreads) preamble_probe_kernel(const PreambleParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const float o[3] = {p.ray[0][i], p.ray[1][i], p.ray[2][i]};
  const float d[3] = {p.ray[3][i], p.ray[4][i], p.ray[5][i]};
  const hako::Ray r = hako::ray_preamble(p.bounds, o, d);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p.out[a][i] = r.t0[a] + r.t1[a];
    p.out[3 + a][i] = r.dt[a];
  }
  p.out[6][i] = static_cast<float>(r.vm6);
  p.out[7][i] = r.enter_ok ? 1.0f : 0.0f;
}

// The reference's node-table forms (hako_kernels._gather_node_any), which
// decide what a child index past a level fetches.
enum NodeForm { kFormSmem, kFormTaa, kFormSplit };

struct StageParams {
  const float* ray[7];  // ox, oy, oz, dx, dy, dz, tq [n]
  const float* bounds;
  uint32_t root_lo, root_hi;
  const uint32_t* levels;  // root-down (mask_lo, mask_hi, base) triples
  int level_off[kMaxStageLevels], level_n[kMaxStageLevels];
  int level_form[kMaxStageLevels], level_rows[kMaxStageLevels];
  int T, clip, n;
  int* out_i[3];    // child, cell, rank (stages 0-3: child)
  float* out_f[5];  // en, ex, exit planes x y z (stages 0-3: en, ex)
};

// The node the reference's gather gives for `child` at root-down level d:
// the smem form clips the index to [0, 63], the taa form its row to
// [0, rows - 1]; every form reads zeros past the level's nodes.
__device__ __forceinline__ void level_node(const StageParams& p, int d, int child,
                                           uint32_t& lo, uint32_t& hi, uint32_t& base) {
  int i = child;
  if (p.level_form[d] == kFormSmem) {
    i = min(max(child, 0), 63);
  } else if (p.level_form[d] == kFormTaa) {
    i = min(max(child >> 7, 0), p.level_rows[d] - 1) * 128 + (child & 127);
  }
  if (i < 0 || i >= p.level_n[d]) {
    lo = hi = base = 0u;
    return;
  }
  const uint32_t* node = p.levels + 3 * (p.level_off[d] + i);
  lo = node[0];
  hi = node[1];
  base = node[2];
}

// pc64_below_clipped (hako_device.cuh) in pc64_below_hopper's form: a cell
// in [0, 128), one of 63 or more giving cell 63's count, as the
// reference's clipped shifts give it.
__device__ __forceinline__ uint32_t pc64_below_clipped_hopper(uint32_t lo, uint32_t hi,
                                                              int cell) {
  return pc64_below_hopper(lo, hi, min(cell, 63));
}

// One lane of the probe body by stage: the ray preamble on the box held in
// registers, then the Hopper walk and rank where hako_device.cuh has walk64
// and pc64_below_clipped (bit-equal: see walk64_hopper; every walk here is
// of a mirrored ray's planes, dc >= 0 or NaN). x: the lane's origin,
// direction and t_q.
template <int STAGE>
__device__ __forceinline__ void stage_lane(const StageParams& p, const float (&box)[6], int i,
                                           const float (&x)[7]) {
  using namespace hako;
  const float o[3] = {x[0], x[1], x[2]};
  const float d[3] = {x[3], x[4], x[5]};
  const Ray r = ray_preamble(box, o, d);
  const float tq = x[6];
  float cur[3] = {r.t1[0], r.t1[1], r.t1[2]};
  float dc[3] = {r.dt[0] * 0.25f, r.dt[1] * 0.25f, r.dt[2] * 0.25f};
  if constexpr (STAGE == 4) {
    uint32_t mlo = p.root_lo, mhi = p.root_hi, base = 0u;
    Walk w{kMaxFloat, kMaxFloat, 64};
    float nt1[3] = {0.0f, 0.0f, 0.0f};
    int rank = 0, child = 0;
    for (int depth = 0; depth < p.T; ++depth) {
      w = walk64_hopper<false>(mlo, mhi, r.vm6, cur, dc, tq);
      int cx, cy, cz;
      coords(w.c, cx, cy, cz);
      nt1[0] = plane(cur[0], dc[0], min(cx + 1, 4));
      nt1[1] = plane(cur[1], dc[1], min(cy + 1, 4));
      nt1[2] = plane(cur[2], dc[2], min(cz + 1, 4));
      rank = static_cast<int>(pc64_below_clipped_hopper(mlo, mhi, w.c ^ r.vm6));
      child = static_cast<int>(base) + rank;
      if (depth < p.T - 1) {
        level_node(p, depth, child, mlo, mhi, base);
        for (int a = 0; a < 3; ++a) {
          cur[a] = nt1[a];
          dc[a] = dc[a] * 0.25f;
        }
      }
    }
    p.out_i[0][i] = child;
    p.out_i[1][i] = w.c;
    p.out_i[2][i] = rank;
    p.out_f[0][i] = w.en;
    p.out_f[1][i] = w.ex;
    p.out_f[2][i] = nt1[0];
    p.out_f[3][i] = nt1[1];
    p.out_f[4][i] = nt1[2];
  } else {
    const Walk w = walk64_hopper<false>(p.root_lo, p.root_hi, r.vm6, cur, dc, tq);
    int child = w.c;
    if constexpr (STAGE >= 1) {
      int cx, cy, cz;
      coords(w.c, cx, cy, cz);
      const float nt1[3] = {plane(cur[0], dc[0], min(cx + 1, 4)),
                            plane(cur[1], dc[1], min(cy + 1, 4)),
                            plane(cur[2], dc[2], min(cz + 1, 4))};
      const int rank =
          static_cast<int>(pc64_below_clipped_hopper(p.root_lo, p.root_hi, w.c ^ r.vm6));
      child = rank;
      if constexpr (STAGE >= 2) {
        uint32_t ml2, mh2, b2;
        level_node(p, 0, min(max(child, 0), p.clip), ml2, mh2, b2);
        child = static_cast<int>(b2) + rank;
        if constexpr (STAGE >= 3) {
          const float dc2[3] = {dc[0] * 0.25f, dc[1] * 0.25f, dc[2] * 0.25f};
          child = child + walk64_hopper<false>(ml2, mh2, r.vm6, nt1, dc2, tq).c;
        }
      }
    }
    p.out_i[0][i] = child;
    p.out_f[0][i] = w.en;
    p.out_f[1][i] = w.ex;
  }
}

// A lane's 7 inputs, read once: evict-first loads (ld.global.cs).
__device__ __forceinline__ void stage_inputs(const StageParams& p, int i, float (&x)[7]) {
#pragma unroll
  for (int a = 0; a < 7; ++a) x[a] = __ldcs(p.ray[a] + i);
}

// A streaming shell around stage_lane: one wave of blocks (the launcher's
// grid: the SMs x the blocks an SM holds at the kernel's registers, fewer
// where the lanes are fewer) and a grid-stride loop over the lanes, each
// thread issuing its next lane's 7 loads before it runs the current lane's
// body, so a warp's loads are in flight while it computes and no partial
// last wave of short blocks is left. The box is read once a thread.
template <int STAGE>
__global__ void __launch_bounds__(kLaneThreads) probe_stage_kernel(const StageParams p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int stride = gridDim.x * blockDim.x;
  float box[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) box[a] = p.bounds[a];
  float x[7];
  stage_inputs(p, i, x);
  while (true) {
    const bool more = i < p.n - stride;
    float y[7];
    if (more) stage_inputs(p, i + stride, y);
    stage_lane<STAGE>(p, box, i, x);
    if (!more) break;
    i += stride;
#pragma unroll
    for (int a = 0; a < 7; ++a) x[a] = y[a];
  }
}

// ---------------------------------------------------------------------------
// 2D gathers within a tile, shared-memory capacity, the one-hot gather
// ---------------------------------------------------------------------------

constexpr int kTaaThreads = 256;  // a block a tile (16 x 128 outputs: 8 a thread)
enum TaaForm { kTaaShared, kTaaShfl, kTaaGlobal };

struct TaaParams {
  const int* t;    // [B, R, C]
  const int* idx;  // [B, r, Ci]
  int* out;        // [B, r, c_out]
  int R, C, r, Ci, c_out;
  int mask;        // the reference's modulus - 1 (a power of two), or -1: none
};

// One tile: out[i, j] = src[i, idx[i, j] & mask] (AXIS 1) or
// src[idx[i, j] & mask, j] (AXIS 0), four outputs a thread a pass (one
// 16-byte index load, one 16-byte store); src in shared memory, or the
// tile in global memory read through L1.
template <int AXIS, bool LDG>
__device__ __forceinline__ void gather_tile(const TaaParams& p, const int* src, int b) {
  const int quads = p.c_out / 4;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out;
  for (int v = threadIdx.x; v < p.r * quads; v += blockDim.x) {
    const int i = v / quads;
    const int j = (v - i * quads) * 4;
    const int4 x = __ldg(reinterpret_cast<const int4*>(idx + i * p.Ci + j));
    int o[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = o[q] & p.mask;
      const int at = AXIS == 1 ? i * p.C + m : m * p.C + j + q;
      o[q] = LDG ? __ldg(src + at) : src[at];
    }
    *reinterpret_cast<int4*>(out + i * p.c_out + j) = make_int4(o[0], o[1], o[2], o[3]);
  }
}

// One tile along axis 1, a warp a row: lane l holds t[i, l + 32 q] for
// q < Q (Q = C / 32), and takes column c as the shuffle of register c / 32
// from lane c % 32 (every register is shuffled; a select keeps the one).
template <int Q>
__device__ __forceinline__ void shfl_rows(const TaaParams& p, int b) {
  const int lane = threadIdx.x & 31;
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out;
  for (int i = threadIdx.x >> 5; i < p.r; i += blockDim.x >> 5) {
    int reg[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) reg[q] = __ldg(tile + i * p.C + 32 * q + lane);
    for (int j = lane; j < p.c_out; j += 32) {  // c_out % 32 == 0: warp-uniform
      const int c = __ldg(idx + i * p.Ci + j) & p.mask;
      int v = 0;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = __shfl_sync(kFull, reg[q], c & 31);
        v = (c >> 5) == q ? s : v;
      }
      out[i * p.c_out + j] = v;
    }
  }
}

template <int AXIS, int FORM>
__global__ void __launch_bounds__(kTaaThreads) take_along_probe_kernel(const TaaParams p) {
  extern __shared__ int4 s_taa_tile[];
  const int b = blockIdx.x;
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  if constexpr (FORM == kTaaShared) {
    const int4* t4 = reinterpret_cast<const int4*>(tile);
    for (int v = threadIdx.x; v < p.R * p.C / 4; v += blockDim.x) s_taa_tile[v] = __ldg(t4 + v);
    __syncthreads();
    gather_tile<AXIS, false>(p, reinterpret_cast<const int*>(s_taa_tile), b);
  } else if constexpr (FORM == kTaaGlobal) {
    gather_tile<AXIS, true>(p, tile, b);
  } else {
    static_assert(AXIS == 1, "the shuffle form gathers along a row");
    if (p.C == 128) {
      shfl_rows<4>(p, b);
    } else {
      shfl_rows<8>(p, b);
    }
  }
}

// Axis 0 from shared memory (the SHARED form along columns), a block a
// slice of `slice` columns of one tile (a multiple of 8: a 32-byte sector
// of a row lies in one slice; the tile's last slice may be narrower, a
// multiple of 4). Output column j reads column j of the tile alone, so a
// block stages only the sectors of its slice that its indices reach: (1)
// it loads its indices, kTaaQuads 16-byte loads a thread in flight (the
// first of them kept in registers for step 3), and marks in shared memory
// each (row, sector) they reach (any writer of the 1 wins); (2) after a
// barrier it stages the marked sectors, kTaaStage 16-byte loads a thread
// in flight before their stores; (3) after a barrier it gathers from the
// slice. An index outside the tile (mod 0 takes idx as it is) is not
// marked and reads the tile through L1, as the GLOBAL form does. Bound:
// bytes (the reached sectors, the indices and the output once); the
// slices of one tile spread its loads over several SMs, and several
// small blocks an SM overlap one block's staging with another's gather.
// The wrapper picks the slice (ops/probes.taa0_slice), takes whole tiles
// instead (take_along_probe_kernel<0, SHARED>) where the indices reach
// nearly every sector of a batch that fills the card or of a tile a
// block stages in one load a thread (ops/probes.taa0_whole: k_taa0's
// batch, a0small's 8-row tile), and keeps the whole-tile
// refusal (a tile over a block's opt-in shared memory), as the
// reference's FAIL.
constexpr int kTaa0Threads = 128;  // 256 took 1.6x k_taa0's time (PERF.md §6)
constexpr int kTaaSector = 8;    // int32 columns of a 32-byte sector
constexpr int kTaaQuads = 2;     // 16-byte index loads a thread has in flight
constexpr int kTaaStage = 4;     // 16-byte staging loads a thread has in flight

// Registers: at most 40 a thread (12 blocks of 128 an SM).
__global__ void __launch_bounds__(kTaa0Threads, 12)
    take_along_a0_kernel(const TaaParams p, int slice, int slices) {
  extern __shared__ int4 s_taa_slice[];
  int* s_cols = reinterpret_cast<int*>(s_taa_slice);  // [R][slice]
  const int b = blockIdx.x / slices;
  const int j0 = (blockIdx.x - b * slices) * slice;
  const int w = min(slice, p.C - j0);                  // columns of this slice
  const int nsec = (w + kTaaSector - 1) / kTaaSector;
  const int quads = w / 4;
  const int n_quads = p.r * quads;
  const int step = blockDim.x * kTaaQuads;
  unsigned char* s_mark = reinterpret_cast<unsigned char*>(s_cols + p.R * slice);  // [R][nsec]
  const int* tile = p.t + static_cast<size_t>(b) * p.R * p.C;
  const int* idx = p.idx + static_cast<size_t>(b) * p.r * p.Ci + j0;
  int* out = p.out + static_cast<size_t>(b) * p.r * p.c_out + j0;
  const unsigned rows = static_cast<unsigned>(p.R);
  auto load = [&](int base, int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int i = v / quads;
        x[u] = __ldg(reinterpret_cast<const int4*>(idx + i * p.Ci + 4 * (v - i * quads)));
      }
    }
  };
  auto mark = [&](int base, const int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int q = v - v / quads * quads;
        const int m[4] = {x[u].x & p.mask, x[u].y & p.mask, x[u].z & p.mask, x[u].w & p.mask};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (static_cast<unsigned>(m[e]) < rows)
            s_mark[m[e] * nsec + (4 * q + e) / kTaaSector] = 1;
        }
      }
    }
  };
  auto gather = [&](int base, const int4 (&x)[kTaaQuads]) {
#pragma unroll
    for (int u = 0; u < kTaaQuads; ++u) {
      const int v = base + u * blockDim.x + threadIdx.x;
      if (v < n_quads) {
        const int i = v / quads;
        const int q = v - i * quads;
        int o[4] = {x[u].x & p.mask, x[u].y & p.mask, x[u].z & p.mask, x[u].w & p.mask};
        if (p.mask >= 0) {  // a modulus (at most R): every index lies in the tile
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = s_cols[o[e] * slice + 4 * q + e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[e] = static_cast<unsigned>(o[e]) < rows
                       ? s_cols[o[e] * slice + 4 * q + e]
                       : __ldg(tile + static_cast<long long>(o[e]) * p.C + j0 + 4 * q + e);
          }
        }
        *reinterpret_cast<int4*>(out + i * p.c_out + 4 * q) = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
  };
  int4 first[kTaaQuads];
  load(0, first);
  for (int v = threadIdx.x; v < p.R * nsec; v += blockDim.x) s_mark[v] = 0;
  __syncthreads();
  mark(0, first);
  for (int base = step; base < n_quads; base += step) {
    int4 x[kTaaQuads];
    load(base, x);
    mark(base, x);
  }
  __syncthreads();
  const int halves = p.R * nsec * 2;  // 16-byte halves of the slice's sectors
  for (int base = 0; base < halves; base += blockDim.x * kTaaStage) {
    int4 v[kTaaStage];
    int at[kTaaStage];
#pragma unroll
    for (int u = 0; u < kTaaStage; ++u) {
      const int h = base + u * blockDim.x + threadIdx.x;
      at[u] = -1;
      if (h < halves) {
        const int sec = h >> 1;
        const int row = sec / nsec;
        const int jj = (sec - row * nsec) * kTaaSector + 4 * (h & 1);
        if (jj < w && s_mark[sec]) {
          at[u] = row * slice + jj;
          v[u] = __ldg(reinterpret_cast<const int4*>(tile + static_cast<size_t>(row) * p.C +
                                                     j0 + jj));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTaaStage; ++u) {
      if (at[u] >= 0) *reinterpret_cast<int4*>(s_cols + at[u]) = v[u];
    }
  }
  __syncthreads();
  gather(0, first);
  for (int base = step; base < n_quads; base += step) {
    int4 x[kTaaQuads];
    load(base, x);
    gather(base, x);
  }
}

// Raise a kernel's dynamic shared memory limit where `bytes` needs it; on a
// refusal, clear the error so that the next launch's check is not blamed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <int AXIS, int FORM>
int launch_taa(const TaaParams& p, int B, cudaStream_t s) {
  const size_t smem = FORM == kTaaShared ? static_cast<size_t>(p.R) * p.C * sizeof(int) : 0;
  const cudaError_t e = allow_smem(take_along_probe_kernel<AXIS, FORM>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  take_along_probe_kernel<AXIS, FORM><<<B, kTaaThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// slice: 0 for whole tiles, a block a tile (ops/probes.taa0_whole), else
// a positive multiple of the sector (ops/probes.taa0_slice).
int launch_taa0_shared(const TaaParams& p, int B, int slice, cudaStream_t s) {
  if (slice == 0) return launch_taa<0, kTaaShared>(p, B, s);
  if (slice < 0 || slice % kTaaSector) return cudaErrorInvalidValue;
  const int slices = (p.C + slice - 1) / slice;
  if (static_cast<long long>(B) * slices > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t marks = (static_cast<size_t>(p.R) * (slice / kTaaSector) + 15) / 16 * 16;
  const size_t smem = static_cast<size_t>(p.R) * slice * sizeof(int) + marks;
  const cudaError_t e = allow_smem(take_along_a0_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  take_along_a0_kernel<<<B * slices, kTaa0Threads, smem, s>>>(p, slice, slices);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSmemRowFloats = 128;  // the reference's scratch row

__global__ void smem_alloc_probe_kernel(const float* x, float* out, int n_rows) {
  extern __shared__ float s_alloc_rows[];  // n_rows x 128
  const int j = threadIdx.x;
  const size_t last = static_cast<size_t>(n_rows - 1) * kSmemRowFloats + j;
  const float v = x[j] * 2.0f;
  s_alloc_rows[j] = v;
  s_alloc_rows[last] = v;
  __syncthreads();
  out[j] = s_alloc_rows[j] + s_alloc_rows[last];
}

enum OhgMode { kOhgShared, kOhgGlobal, kOhgMma };
constexpr int kOhgCols = 128;   // the table's row
constexpr int kOhgGroup = 16;   // lanes an mma's A fragment holds (its M)
constexpr int kOhgPlanes = 3;   // byte planes of a table value (< 2^24)
constexpr int kOhgChunk = 32;   // table rows an mma takes (its K)
constexpr int kOhgTiles = kOhgCols / 8;          // 8-column n-tiles of a row: a warp each
constexpr int kOhgMmaThreads = 32 * kOhgTiles;   // 512
constexpr int kOhgChunkFrags = kOhgTiles * kOhgPlanes * 32;  // B fragments (uint2) of a chunk
constexpr int kOhgBatch = 4;    // 16-lane groups whose accumulators a warp holds at once

// Byte p of four words, packed from the low byte up: a B register of
// byte plane p.
__device__ __forceinline__ uint32_t byte_plane(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3, int p) {
  const uint32_t sel = static_cast<uint32_t>(p) | (static_cast<uint32_t>(p + 4) << 4);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// The one-hot byte of an A register: byte d (0-3) set to 1, or none.
__device__ __forceinline__ uint32_t one_hot(int d) {
  return static_cast<unsigned>(d) < 4u ? 1u << (8 * d) : 0u;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// SHARED / GLOBAL: k hops of idx = (idx + flat[idx]) & (n_rows * 128 - 1),
// a thread a lane, kUnroll hops a pass of the outer loop.
template <int MODE>
__global__ void ohg_probe_kernel(const int* table, int n_rows, const int* idx0, int n,
                                 int k, int* out) {
  const uint32_t wrap = static_cast<uint32_t>(n_rows) * kOhgCols - 1u;
  extern __shared__ int4 s_ohg_table[];
  const int* s_tab = reinterpret_cast<const int*>(s_ohg_table);
  if constexpr (MODE == kOhgShared) {
    const int4* t4 = reinterpret_cast<const int4*>(table);
    for (int v = threadIdx.x; v < n_rows * kOhgCols / 4; v += blockDim.x)
      s_ohg_table[v] = __ldg(t4 + v);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x = i < n ? static_cast<uint32_t>(idx0[i]) : 0u;
#pragma unroll 1
  for (int o = 0; o < k / kUnroll; ++o) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = MODE == kOhgShared ? s_tab[x] : __ldg(table + x);
      x = (x + static_cast<uint32_t>(w)) & wrap;
    }
  }
  if (i < n) out[i] = static_cast<int>(x);
}

// What a warp of the MMA mode's block needs of its place: its block's B
// fragments and first chunk, its n-tile (its warp), its lane (g, t) and
// its block's rank in the cluster.
struct OhgWarp {
  const uint2* frag;
  int chunks, c0, nt, lane, g, t, rank;
};

// One hop of a cluster's G 16-lane groups: this block's partial of the
// one-hot product at each lane's column, into slot `rank` of the lane in
// `part` ([CL][16 G]) of every block of the cluster. Each
// row's one-hot A registers (row g and g + 8 of a group; bytes at
// columns 4t..4t+3 and 16+4t..16+4t+3 of its 32-row chunk) are built
// once, with the block's chunk that holds the row: every other chunk's
// registers are 0, and its mma runs all the same.
template <int CL, int G>
__device__ __forceinline__ void ohg_partials(const OhgWarp& w, const uint32_t (&xa)[G],
                                             const uint32_t (&xb)[G], int* part) {
  constexpr int kLanes = kOhgGroup * G;
  constexpr int kB = G < kOhgBatch ? G : kOhgBatch;
  auto put = [&](int at, int v) {
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int r = 0; r < CL; ++r) cluster.map_shared_rank(part, r)[w.rank * kLanes + at] = v;
    } else {
      part[at] = v;
    }
  };
#pragma unroll
  for (int gb = 0; gb < G; gb += kB) {
    int acc[kB][kOhgPlanes][4] = {};
    uint32_t a[kB][4];
    int ka[kB], kb[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const int ra = static_cast<int>(xa[gb + u] >> 7), rb = static_cast<int>(xb[gb + u] >> 7);
      ka[u] = (ra >> 5) - w.c0;
      kb[u] = (rb >> 5) - w.c0;
      const int oa = (ra & (kOhgChunk - 1)) - 4 * w.t, ob = (rb & (kOhgChunk - 1)) - 4 * w.t;
      a[u][0] = one_hot(oa);
      a[u][1] = one_hot(ob);
      a[u][2] = one_hot(oa - 16);
      a[u][3] = one_hot(ob - 16);
    }
#pragma unroll 2
    for (int kc = 0; kc < w.chunks; ++kc) {
      const uint2* bp = w.frag + (kc * kOhgTiles + w.nt) * kOhgPlanes * 32 + w.lane;
      const uint2 b[kOhgPlanes] = {bp[0], bp[32], bp[64]};
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const uint32_t a0 = kc == ka[u] ? a[u][0] : 0u, a2 = kc == ka[u] ? a[u][2] : 0u;
        const uint32_t a1 = kc == kb[u] ? a[u][1] : 0u, a3 = kc == kb[u] ? a[u][3] : 0u;
#pragma unroll
        for (int p = 0; p < kOhgPlanes; ++p) mma_u8(acc[u][p], a0, a1, a2, a3, b[p].x, b[p].y);
      }
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      int v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = acc[u][0][r] + (acc[u][1][r] << 8) + (acc[u][2][r] << 16);
      const int ca = static_cast<int>(xa[gb + u] & 127u), cb = static_cast<int>(xb[gb + u] & 127u);
      const int at = kOhgGroup * (gb + u) + w.g;
      if ((ca >> 3) == w.nt && ((ca & 7) >> 1) == w.t) put(at, (ca & 1) ? v[1] : v[0]);
      if ((cb >> 3) == w.nt && ((cb & 7) >> 1) == w.t) put(at + 8, (cb & 1) ? v[3] : v[2]);
    }
  }
}

// Every group's step: idx += the sum of the cluster's slots, masked.
template <int CL, int G>
__device__ __forceinline__ void ohg_step(uint32_t (&xa)[G], uint32_t (&xb)[G], const int* part,
                                         int g, uint32_t wrap) {
  constexpr int kLanes = kOhgGroup * G;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    uint32_t sa = 0u, sb = 0u;
#pragma unroll
    for (int r = 0; r < CL; ++r) {
      sa += static_cast<uint32_t>(part[r * kLanes + kOhgGroup * gi + g]);
      sb += static_cast<uint32_t>(part[r * kLanes + kOhgGroup * gi + g + 8]);
    }
    xa[gi] = (xa[gi] + sa) & wrap;
    xb[gi] = (xb[gi] + sb) & wrap;
  }
}

// MMA: the reference's MXU gather on the tensor cores, k dependent hops
// of the full one-hot product a hop. A cluster of CL blocks chases 16 G
// lanes; block `rank` holds table rows [rank, rank + 1) x n_rows / CL as
// their three byte planes (values < 2^24), split from the words once a
// call while they are staged, stored in the order mma.sync m16n8k32 u8
// reads its B fragments: s_frag[(kc * 16 + nt) * 3 + p][lane] = (b0, b1),
// the bytes of rows 32 kc + 4t..4t+3 and 32 kc + 16 + 4t..16 + 4t+3 at
// column 8 nt + g (g = lane / 4, t = lane % 4). Warp nt of each block
// computes n-tile nt (8 columns) for every lane: each hop it builds the
// one-hot A fragments of the lanes' rows and runs one mma a chunk, plane
// and group over EVERY chunk the block holds, zero one-hot or not, and
// every n-tile of the row: the probe measures the full product, as the
// reference computes it (a gather would skip the zero chunks and the
// other tiles). Its int8 operations are 2 x lanes x n_rows x 128 x 3 a
// hop. The block's partial p0 + (p1 << 8) + (p2 << 16) at each lane's
// column (exact: at most one non-zero term a sum) goes to every block of
// the cluster through distributed shared memory, one slot a block and
// lane, double-buffered by the hop's parity; after the cluster barrier (a
// block barrier for CL = 1) every thread sums the slots of its lanes and
// steps their indices. No B fragment is loaded from global memory or split
// in the hop loop. Bound:
// operations, int8 on the tensor cores; the design spreads 2,048 lanes
// over 128 blocks of 16 warps (128 / CL clusters, as many as the card
// holds at once for CL <= 2) and keeps the table in shared memory, split
// across the cluster where it exceeds one SM's. wgmma's m64 tile would
// give a block 64 lanes, half the blocks: measured so (A in registers, B
// from shared memory), it was 17% slower at 128 rows and 4% faster at
// 1024 (PERF.md §6).
template <int CL, int G>
__global__ void __launch_bounds__(kOhgMmaThreads, 1)
    ohg_mma_kernel(const int* table, int n_rows, const int* idx0, int n, int k, int* out) {
  constexpr int kLanes = kOhgGroup * G;  // a cluster's lanes: each of its blocks holds all
  extern __shared__ uint2 s_ohg_frag[];
  OhgWarp w;
  w.frag = s_ohg_frag;
  w.chunks = n_rows / kOhgChunk / CL;  // 32-row chunks this block holds
  int* s_part = reinterpret_cast<int*>(s_ohg_frag + w.chunks * kOhgChunkFrags);  // [2][CL][kLanes]
  w.lane = threadIdx.x & 31;
  w.nt = threadIdx.x >> 5;
  w.g = w.lane >> 2;
  w.t = w.lane & 3;
  w.rank = 0;
  if constexpr (CL > 1) w.rank = static_cast<int>(cg::this_cluster().block_rank());
  w.c0 = w.rank * w.chunks;
  const int first = blockIdx.x / CL * kLanes;
  const uint32_t wrap = static_cast<uint32_t>(n_rows) * kOhgCols - 1u;
  for (int v = threadIdx.x; v < w.chunks * kOhgTiles * 32; v += blockDim.x) {
    const int fl = v & 31, ft = (v >> 5) % kOhgTiles, kc = v / (32 * kOhgTiles);
    const int* col = table +
                     static_cast<size_t>((w.c0 + kc) * kOhgChunk + 4 * (fl & 3)) * kOhgCols +
                     8 * ft + (fl >> 2);
    uint32_t word[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      word[j] = static_cast<uint32_t>(__ldg(col + j * kOhgCols));
      word[4 + j] = static_cast<uint32_t>(__ldg(col + (16 + j) * kOhgCols));
    }
    uint2* dst = s_ohg_frag + (kc * kOhgTiles + ft) * kOhgPlanes * 32 + fl;
#pragma unroll
    for (int p = 0; p < kOhgPlanes; ++p) {
      dst[p * 32] = make_uint2(byte_plane(word[0], word[1], word[2], word[3], p),
                               byte_plane(word[4], word[5], word[6], word[7], p));
    }
  }
  uint32_t xa[G], xb[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int la = first + kOhgGroup * gi + w.g;
    xa[gi] = la < n ? static_cast<uint32_t>(idx0[la]) : 0u;
    xb[gi] = la + 8 < n ? static_cast<uint32_t>(idx0[la + 8]) : 0u;
  }
  if constexpr (CL > 1) {
    cg::this_cluster().sync();  // the fragments staged, every block of the cluster running
  } else {
    __syncthreads();
  }
#pragma unroll 1
  for (int h = 0; h < k; ++h) {
    int* part = s_part + (h & 1) * CL * kLanes;
    ohg_partials<CL, G>(w, xa, xb, part);
    if constexpr (CL > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    ohg_step<CL, G>(xa, xb, part, w.g, wrap);
  }
  if (w.rank == 0 && w.nt == 0 && w.t == 0) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const int la = first + kOhgGroup * gi + w.g;
      if (la < n) out[la] = static_cast<int>(xa[gi]);
      if (la + 8 < n) out[la + 8] = static_cast<int>(xb[gi]);
    }
  }
}

// One cluster of CL blocks a 16 CL lanes (G = CL groups); the launch
// carries the cluster shape (cudaLaunchKernelEx).
template <int CL>
cudaLaunchConfig_t ohg_mma_config(int n_rows, int n, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kOhgGroup * CL - 1) / (kOhgGroup * CL) * CL);
  cfg.blockDim = dim3(kOhgMmaThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_rows / kOhgChunk / CL) * kOhgChunkFrags *
                             sizeof(uint2) + 2 * CL * kOhgGroup * CL * sizeof(int);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CL>
int launch_ohg_mma(const int* tab, int n_rows, const int* start, int n, int k, int* o,
                   cudaStream_t s) {
  if (n_rows / kOhgChunk < CL) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = ohg_mma_config<CL>(n_rows, n, s, &attr);
  if (CL == 1) cfg.numAttrs = 0;
  void (*kernel)(const int*, int, const int*, int, int, int*) = ohg_mma_kernel<CL, CL>;
  cudaError_t e = allow_smem(kernel, cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, kernel, tab, n_rows, start, n, k, o);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// The clusters of CL blocks the card holds at once (cudaOccupancyMaxActiveClusters),
// or minus the CUDA error.
template <int CL>
int ohg_mma_clusters(int n_rows) {
  if (n_rows / kOhgChunk < CL) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ohg_mma_config<CL>(n_rows, kOhgGroup * CL, nullptr, &attr);
  void (*kernel)(const int*, int, const int*, int, int, int*) = ohg_mma_kernel<CL, CL>;
  cudaError_t e = allow_smem(kernel, cfg.dynamicSmemBytes);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return clusters;
}

inline int lane_blocks(int n) { return (n + kLaneThreads - 1) / kLaneThreads; }

void (*stage_kernel(int stage))(StageParams) {
  switch (stage) {
    case 0: return probe_stage_kernel<0>;
    case 1: return probe_stage_kernel<1>;
    case 2: return probe_stage_kernel<2>;
    case 3: return probe_stage_kernel<3>;
    case 4: return probe_stage_kernel<4>;
    default: return nullptr;
  }
}

constexpr int kStages = 5;
constexpr int kMaxDevices = 64;

// One wave of the stage kernel's blocks at most: the SMs x the blocks an SM
// holds at its registers, fewer where n's lanes fill fewer. The wave is
// asked once a device and stage (a device past kMaxDevices, or a query that
// failed, asks again at the next launch); stage is one of 0..kStages - 1.
int stage_blocks(int stage, int n) {
  static int waves[kMaxDevices][kStages] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = -1;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  int wave = kept ? waves[dev][stage] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    const bool asked =
        dev >= 0 &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_kernel(stage),
                                                      kLaneThreads, 0) == cudaSuccess &&
        sms * per_sm > 0;
    wave = asked ? sms * per_sm : 1;
    if (kept && asked) waves[dev][stage] = wave;
  }
  return lane_blocks(n) < wave ? lane_blocks(n) : wave;
}

bool launch_shape_ok(int n, int k, int threads) {
  return n > 0 && k > 0 && k % kUnroll == 0 && threads > 0 && threads <= 1024 &&
         threads % 32 == 0;
}

}  // namespace

// C entries for ctypes; device pointers. Each returns cudaGetLastError()
// after its launch (or an invalid-value code for a shape it does not take).
extern "C" int row_chase_launch(const void* rows, const void* start, void* end,
                                int n_chains, int hops, int mode, int chains,
                                int blocks, int threads, void* stream) {
  if (n_chains <= 0 || hops < 0 || blocks <= 0 || threads <= 0 || threads % 32)
    return cudaErrorInvalidValue;
  const auto* r = static_cast<const uint32_t*>(rows);
  const auto* st = static_cast<const int*>(start);
  auto* e = static_cast<int*>(end);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_chase<0>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    case 1: return launch_chase<1>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    case 2: return launch_chase<2>(r, st, e, n_chains, hops, chains, blocks, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int walk_probe_launch(const void* lo, const void* hi, const void* t1,
                                 const void* dc, int n, int iters, int scan,
                                 int threads, void* out, void* stream) {
  if (n <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const auto* l = static_cast<const uint32_t*>(lo);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* a = static_cast<const float*>(t1);
  const auto* d = static_cast<const float*>(dc);
  auto* o = static_cast<int*>(out);
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scan) {
    walk_probe_kernel<true><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, 0u, o);
  } else {
    walk_probe_kernel<false><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, 0u, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of fetch_probe_kernel launches with.
extern "C" size_t fetch_probe_smem_bytes(int threads) { return fetch_smem_bytes(threads); }

extern "C" int fetch_probe_launch(const void* rows, const void* row_of, int n,
                                  int iters, int threads, void* out, void* stream) {
  if (n <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const size_t bytes = fetch_smem_bytes(threads);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fetch_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(fetch_smem_bytes(1024)));
    if (e != cudaSuccess) {
      cudaGetLastError();  // leave no error for the next launch's check
      return static_cast<int>(e);
    }
  }
  fetch_probe_kernel<<<(n + threads - 1) / threads, threads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const int*>(row_of), n,
      iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int l2_read_probe_launch(const void* buf, long long n_vec, int passes,
                                    int blocks, int threads, void* out, void* stream) {
  if (n_vec <= 0 || passes < 0 || blocks <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32)
    return cudaErrorInvalidValue;
  l2_read_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n_vec, passes, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int construct_probe_launch(int kind, const void* fa, const void* fb,
                                      const void* ia, const void* ua,
                                      const void* ub, int n, int k, void* out,
                                      int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* a = static_cast<const float*>(fa);
  const auto* b = static_cast<const float*>(fb);
  const auto* x = static_cast<const int*>(ia);
  const auto* m0 = static_cast<const uint32_t*>(ua);
  const auto* m1 = static_cast<const uint32_t*>(ub);
  const int outer = k / kUnroll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kMinMax: return launch_construct<kMinMax>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kCmpSel: return launch_construct<kCmpSel>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kInt: return launch_construct<kInt>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kVShift: return launch_construct<kVShift>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kBarrel: return launch_construct<kBarrel>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kI2F: return launch_construct<kI2F>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kBitAt: return launch_construct<kBitAt>(a, b, x, m0, m1, n, outer, out, threads, s);
    case kPc64: return launch_construct<kPc64>(a, b, x, m0, m1, n, outer, out, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

namespace {

// The shared select's layout: 32 word copies (24 KB a block).
constexpr int kSelRec = 3, kSelCopies = 32;

// The shared node fetch's layout <rec, copies> for a table of n_nodes, by
// n_nodes alone, as the turns with the earlier kernel and the other
// layouts favoured it (PERF.md section 6): 32 word copies where
// they fit 48 KB (n_nodes <= 128; 3 wavefronts a warp-repeat), 4 copies of
// 16-byte records up to 1,024 nodes (64 KB: ~7.8 wavefronts where the
// packed table takes ~10.3), and the packed table beyond (48 KB at 4,096
// nodes; no layout that fits takes fewer wavefronts).
struct GatherPlan {
  int rec, copies;
};

GatherPlan gather_plan(int n_nodes) {
  if (n_nodes <= 128) return {3, 32};
  if (n_nodes <= 1024) return {4, 4};
  return {3, 1};
}

size_t gather_smem_bytes(int n_nodes) {
  switch (gather_plan(n_nodes).copies) {
    case 32: return staged_smem_bytes<3, 32>(n_nodes);
    case 4: return staged_smem_bytes<4, 4>(n_nodes);
    default: return staged_smem_bytes<3, 1>(n_nodes);
  }
}

template <int REC, int COPIES>
int launch_gather_shared(const uint32_t* tab, int n_nodes, const int* start, int n, int outer,
                         int* a, int* f, int threads, cudaStream_t s) {
  const size_t bytes = staged_smem_bytes<REC, COPIES>(n_nodes);
  const cudaError_t e = allow_smem(node_gather_shared_kernel<REC, COPIES>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  node_gather_shared_kernel<REC, COPIES><<<(n + threads - 1) / threads, threads, bytes, s>>>(
      tab, n_nodes, start, n, outer, a, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The shared node fetch's layout for a table of n_nodes (out[2]: rec,
// copies) and the dynamic shared memory a block of it launches with.
extern "C" void node_gather_probe_plan(int n_nodes, int* out) {
  const GatherPlan p = gather_plan(n_nodes);
  out[0] = p.rec;
  out[1] = p.copies;
}

extern "C" size_t node_gather_probe_smem_bytes(int n_nodes) { return gather_smem_bytes(n_nodes); }

// The dynamic shared memory a block of the shared select launches with.
extern "C" size_t table_select_probe_smem_bytes() {
  return staged_smem_bytes<kSelRec, kSelCopies>(64);
}

// table: int32 [n_nodes, 3] on the device, n_nodes a power of two <= 4096.
extern "C" int node_gather_probe_launch(int space, const void* table,
                                        int n_nodes, const void* idx0, int n,
                                        int k, void* acc, void* fold,
                                        int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads) || n_nodes <= 0 || n_nodes > kMaxNodes ||
      (n_nodes & (n_nodes - 1)))
    return cudaErrorInvalidValue;
  const auto* tab = static_cast<const uint32_t*>(table);
  const auto* start = static_cast<const int*>(idx0);
  auto* a = static_cast<int*>(acc);
  auto* f = static_cast<int*>(fold);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (space) {
    case kGlobal:
      node_gather_probe_kernel<kGlobal><<<blocks, threads, 0, s>>>(
          tab, n_nodes, start, n, outer, a, f);
      break;
    case kShared:
      switch (gather_plan(n_nodes).copies) {
        case 32:
          return launch_gather_shared<3, 32>(tab, n_nodes, start, n, outer, a, f, threads, s);
        case 4:
          return launch_gather_shared<4, 4>(tab, n_nodes, start, n, outer, a, f, threads, s);
        default:
          return launch_gather_shared<3, 1>(tab, n_nodes, start, n, outer, a, f, threads, s);
      }
    case kConstant: {
      const size_t bytes = static_cast<size_t>(n_nodes) * 3 * sizeof(uint32_t);
      const cudaError_t e = cudaMemcpyToSymbolAsync(
          c_nodes, tab, bytes, 0, cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      node_gather_probe_kernel<kConstant><<<blocks, threads, 0, s>>>(
          tab, n_nodes, start, n, outer, a, f);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// tab: int32 [64, 3] on the device.
extern "C" int table_select_probe_launch(int form, const void* tab,
                                         const void* idx0, int n, int k,
                                         void* out, int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* t = static_cast<const uint32_t*>(tab);
  const auto* start = static_cast<const int*>(idx0);
  auto* o = static_cast<int*>(out);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kSelConstant: {
      const cudaError_t e = cudaMemcpyToSymbolAsync(
          c_select, t, sizeof(c_select), 0, cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return static_cast<int>(e);
      table_select_probe_kernel<kSelConstant><<<blocks, threads, 0, s>>>(t, start, n, outer, o);
      break;
    }
    case kSelShared: {
      const size_t bytes = staged_smem_bytes<kSelRec, kSelCopies>(64);
      table_select_shared_kernel<kSelRec, kSelCopies><<<blocks, threads, bytes, s>>>(
          t, start, n, outer, o);
      break;
    }
    case kSelShuffle:
      table_select_probe_kernel<kSelShuffle><<<blocks, threads, 0, s>>>(t, start, n, outer, o);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int calib_probe_launch(int kind, const void* a, const void* b, int n,
                                  int k, void* out, int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads)) return cudaErrorInvalidValue;
  const auto* x = static_cast<const float*>(a);
  const auto* y = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  const int outer = k / kUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kChain: calib_probe_kernel<kChain><<<blocks, threads, 0, s>>>(x, y, n, outer, o); break;
    case kPar8: calib_probe_kernel<kPar8><<<blocks, threads, 0, s>>>(x, y, n, outer, o); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// pipe_probe<a, b> on in u32 [8, n] into out int32 [9, n]; a pair
// PIPE_PAIRS does not list is refused.
extern "C" int pipe_probe_launch(int a, int b, const void* in, int n, int k, void* out,
                                 int threads, void* stream) {
  if (!launch_shape_ok(n, k, threads) || k % kPipeUnroll != 0) return cudaErrorInvalidValue;
  const auto* x = static_cast<const uint32_t*>(in);
  auto* o = static_cast<int*>(out);
  const int outer = k / kPipeUnroll;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PIPE_CASE(A, B)                                                        \
  if (a == A && b == B) {                                                      \
    pipe_probe_kernel<A, B><<<blocks, threads, 0, s>>>(x, n, outer, o);        \
    return static_cast<int>(cudaGetLastError());                               \
  }
  PIPE_PAIRS(PIPE_CASE)
#undef PIPE_CASE
  return cudaErrorInvalidValue;
}

extern "C" int empty_probe_launch(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024 || threads % 32) return cudaErrorInvalidValue;
  empty_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The walk probe's counting variant (hopper 1: the Hopper walk; 0: walk64 as
// it is) into out int32 [4, n].
extern "C" int walk_count_launch(int hopper, const void* lo, const void* hi, const void* t1,
                                 const void* dc, int n, int iters, void* out, int threads,
                                 void* stream) {
  if (n <= 0 || iters < 0 || threads <= 0 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const auto* l = static_cast<const uint32_t*>(lo);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* a = static_cast<const float*>(t1);
  const auto* d = static_cast<const float*>(dc);
  auto* o = static_cast<int*>(out);
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hopper) {
    walk_count_kernel<true><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, o);
  } else {
    walk_count_kernel<false><<<blocks, threads, 0, s>>>(l, h, a, d, n, iters, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// The walk forms side by side (form 0 hako::walk64, 1 the Hopper walk, 2 the
// sweep's cell), one call a lane: en / ex f32 [n], c int32 [n].
extern "C" int walk_form_launch(int form, const void* lo, const void* hi, const void* vm6,
                                const void* t1, const void* dc, const void* tq, int n,
                                void* en, void* ex, void* c, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const auto* l = static_cast<const uint32_t*>(lo);
  const auto* h = static_cast<const uint32_t*>(hi);
  const auto* v = static_cast<const int*>(vm6);
  const auto* a = static_cast<const float*>(t1);
  const auto* d = static_cast<const float*>(dc);
  const auto* q = static_cast<const float*>(tq);
  auto* e0 = static_cast<float*>(en);
  auto* e1 = static_cast<float*>(ex);
  auto* cc = static_cast<int*>(c);
  const int blocks = (n + 127) / 128;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: walk_form_kernel<0><<<blocks, 128, 0, s>>>(l, h, v, a, d, q, n, e0, e1, cc); break;
    case 1: walk_form_kernel<1><<<blocks, 128, 0, s>>>(l, h, v, a, d, q, n, e0, e1, cc); break;
    case 2: walk_form_kernel<2><<<blocks, 128, 0, s>>>(l, h, v, a, d, q, n, e0, e1, cc); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// bit_at / pc64_below in both forms for all 64 cells of n masks: out int32
// [4, n, 64].
extern "C" int bit_form_launch(const void* lo, const void* hi, int n, void* out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  bit_form_kernel<<<(n * 64 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi), n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// in / out: host arrays of 8 device pointers (AOS: the first of each);
// n floats an array. One wave of blocks at most (the SMs x the blocks an
// SM holds), fewer where the tiles are fewer.
extern "C" int shell_copy_probe_launch(int aos, const void* const* in,
                                       void* const* out, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  ShellParams p{};
  for (int a = 0; a < (aos ? 1 : kShellArrays); ++a) {
    p.in[a] = static_cast<const float*>(in[a]);
    p.out[a] = static_cast<float*>(out[a]);
  }
  p.n = n;
  void (*kernel)(ShellParams) = aos ? &shell_copy_kernel<1> : &shell_copy_kernel<kShellArrays>;
  const int tile = kShellThreads * (aos ? kShellLoads : kShellLoads / kShellArrays);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kShellThreads, 0);
  const int tiles = (n / 4 + tile - 1) / tile;
  const int wave = sms * per_sm > 0 ? sms * per_sm : 1;
  const int blocks = tiles < 1 ? 1 : (tiles < wave ? tiles : wave);
  kernel<<<blocks, kShellThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ray: host array of 6 device pointers, out of 8; bounds a device [6].
extern "C" int preamble_probe_launch(const void* const* ray, const void* bounds,
                                     int n, void* const* out, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  PreambleParams p{};
  for (int a = 0; a < 6; ++a) p.ray[a] = static_cast<const float*>(ray[a]);
  for (int a = 0; a < 8; ++a) p.out[a] = static_cast<float*>(out[a]);
  p.bounds = static_cast<const float*>(bounds);
  p.n = n;
  preamble_probe_kernel<<<lane_blocks(n), kLaneThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ray: host array of 7 device pointers (origin, direction, tq); out_i of
// 3 and out_f of 5 (stages 0-3 write the first 1 and 2); levels a device
// table, the per-level arrays host arrays of n_levels ints.
extern "C" int probe_stage_probe_launch(
    int stage, const void* const* ray, const void* bounds, unsigned root_lo,
    unsigned root_hi, const void* levels, const int* level_off,
    const int* level_n, const int* level_form, const int* level_rows,
    int n_levels, int T, int clip, int n, void* const* out_i,
    void* const* out_f, void* stream) {
  if (n <= 0 || n_levels < 0 || n_levels > kMaxStageLevels ||
      (stage == 4 ? T - 1 > n_levels || T < 1 : stage >= 2 && n_levels < 1))
    return cudaErrorInvalidValue;
  StageParams p{};
  for (int a = 0; a < 7; ++a) p.ray[a] = static_cast<const float*>(ray[a]);
  p.bounds = static_cast<const float*>(bounds);
  p.root_lo = root_lo;
  p.root_hi = root_hi;
  p.levels = static_cast<const uint32_t*>(levels);
  for (int d = 0; d < n_levels; ++d) {
    p.level_off[d] = level_off[d];
    p.level_n[d] = level_n[d];
    p.level_form[d] = level_form[d];
    p.level_rows[d] = level_rows[d];
  }
  p.T = T;
  p.clip = clip;
  p.n = n;
  for (int a = 0; a < 3; ++a) p.out_i[a] = static_cast<int*>(out_i[a]);
  for (int a = 0; a < 5; ++a) p.out_f[a] = static_cast<float*>(out_f[a]);
  void (*kernel)(StageParams) = stage_kernel(stage);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  kernel<<<stage_blocks(stage, n), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks probe_stage_probe_launch gives stage `stage` on n lanes (0
// for a stage that does not exist).
extern "C" int probe_stage_probe_blocks(int stage, int n) {
  return stage_kernel(stage) == nullptr || n <= 0 ? 0 : stage_blocks(stage, n);
}

// The shared memory a block can opt in to (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// or -1 if the device does not answer.
extern "C" int smem_optin_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return v;
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// t int32 [B, R, C], idx int32 [B, r, Ci], out int32 [B, r, c_out], all
// 16-byte aligned; mod 0 (none) or a power of two. Axis 1: r <= R, c_out
// <= Ci; axis 0: c_out == C <= Ci. SHFL: axis 1, C 128 or 256, c_out % 32
// == 0, mod <= C. SHARED: R x C x 4 bytes of shared memory along rows; along
// columns the same with `slice` 0 (whole tiles), else a slice of R x `slice`
// (a multiple of 8), only the sectors the indices reach.
extern "C" int take_along_probe_launch(int axis, int form, const void* t, const void* idx,
                                       void* out, int B, int R, int C, int r, int Ci,
                                       int c_out, int mod, int slice, void* stream) {
  const bool shapes = B > 0 && R > 0 && C > 0 && r > 0 && c_out > 0 && C % 4 == 0 &&
                      Ci % 4 == 0 && c_out % 4 == 0 && mod >= 0 && (mod & (mod - 1)) == 0 &&
                      (axis == 1 ? r <= R && c_out <= Ci : axis == 0 && c_out == C && C <= Ci);
  const bool shfl_ok = axis == 1 && (C == 128 || C == 256) && c_out % 32 == 0 && mod <= C;
  if (!shapes || form < kTaaShared || form > kTaaGlobal || (form == kTaaShfl && !shfl_ok))
    return cudaErrorInvalidValue;
  const TaaParams p{static_cast<const int*>(t), static_cast<const int*>(idx),
                    static_cast<int*>(out), R, C, r, Ci, c_out, mod ? mod - 1 : -1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    switch (form) {
      case kTaaShared: return launch_taa<1, kTaaShared>(p, B, s);
      case kTaaShfl: return launch_taa<1, kTaaShfl>(p, B, s);
      default: return launch_taa<1, kTaaGlobal>(p, B, s);
    }
  }
  return form == kTaaShared ? launch_taa0_shared(p, B, slice, s)
                            : launch_taa<0, kTaaGlobal>(p, B, s);
}

// x, out: f32 [128]. Returns the CUDA error of a refused allocation (of
// the attribute or of the launch), cleared.
extern "C" int smem_alloc_probe_launch(const void* x, void* out, int n_rows, void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(n_rows) * kSmemRowFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(smem_alloc_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess) {
    smem_alloc_probe_kernel<<<1, kSmemRowFloats, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n_rows);
    e = cudaGetLastError();
  } else {
    cudaGetLastError();
  }
  return static_cast<int>(e);
}

// table int32 [n_rows, 128] (n_rows a power of two, at least 32 for MMA),
// idx0 / out int32 [n]; k a multiple of kUnroll (any k >= 1 for MMA).
// SHARED / GLOBAL: `threads` lanes a block. MMA: clusters of `cluster`
// blocks (1, 2, 4 or 8, at most n_rows / 32), 16 x cluster lanes each.
extern "C" int ohg_probe_launch(int mode, const void* table, int n_rows, const void* idx0,
                                int n, int k, void* out, int threads, int cluster,
                                void* stream) {
  if (n <= 0 || k <= 0 || threads <= 0 || threads > 1024 || threads % 32 || n_rows <= 0 ||
      (n_rows & (n_rows - 1)) || (mode == kOhgMma ? n_rows < kOhgChunk : k % kUnroll != 0))
    return cudaErrorInvalidValue;
  const auto* tab = static_cast<const int*>(table);
  const auto* start = static_cast<const int*>(idx0);
  auto* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kOhgShared: {
      const size_t bytes = static_cast<size_t>(n_rows) * kOhgCols * sizeof(int);
      const cudaError_t e = allow_smem(ohg_probe_kernel<kOhgShared>, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      ohg_probe_kernel<kOhgShared><<<(n + threads - 1) / threads, threads, bytes, s>>>(
          tab, n_rows, start, n, k, o);
      break;
    }
    case kOhgGlobal:
      ohg_probe_kernel<kOhgGlobal><<<(n + threads - 1) / threads, threads, 0, s>>>(
          tab, n_rows, start, n, k, o);
      break;
    case kOhgMma:
      switch (cluster) {
        case 1: return launch_ohg_mma<1>(tab, n_rows, start, n, k, o, s);
        case 2: return launch_ohg_mma<2>(tab, n_rows, start, n, k, o, s);
        case 4: return launch_ohg_mma<4>(tab, n_rows, start, n, k, o, s);
        case 8: return launch_ohg_mma<8>(tab, n_rows, start, n, k, o, s);
        default: return cudaErrorInvalidValue;
      }
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// The clusters of the MMA mode (`cluster` blocks each, on a table of
// n_rows) that the card runs at once; minus the CUDA error where it
// refuses the shape.
extern "C" int ohg_mma_max_clusters(int n_rows, int cluster) {
  switch (cluster) {
    case 1: return ohg_mma_clusters<1>(n_rows);
    case 2: return ohg_mma_clusters<2>(n_rows);
    case 4: return ohg_mma_clusters<4>(n_rows);
    case 8: return ohg_mma_clusters<8>(n_rows);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
