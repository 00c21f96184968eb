// Fused EK-PNP-thermal LBM step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of ekpnp/pallas/fused_step.py (build_fused_step,
// its `kernel` closure and the pl.pallas_call) in its five forms.  One
// step of every active population: fluid f, ions h / hn, temperature g,
// and the Poisson RHS, plain or transformed along x.
//
// The time loop cuts a chunk of n steps at the stream: one collide_kernel,
// n - 1 fused_pass_kernel launches, one stream_bc_kernel (on a shard
// stream_bc_halo_kernel), a solve after each collide or pass; on one
// device (kernels/step.py _chunk) and per shard of a mesh
// (parallel/halo.py make_halo_multi_step).
//
//   collide_kernel    one thread per node (x fastest); the block first
//                     copies its 128 nodes' populations into shared memory
//                     (a slot of the block is 128 consecutive values of one
//                     direction: aligned 16-byte cp.async pieces), then
//                     each thread collides its node from there:
//                     moments -> E = -grad(phi) from phi's six neighbours
//                     (periodic in x, y; Ez[0] = Ez[1], Ez[NZ-1] = Ez[NZ-2])
//                     -> Coulomb + external + buoyancy force -> half-force
//                     velocity (z=0: -numer(z=1) / rho(z=0), plane 1
//                     recomputed by the z=0 thread) -> TRT + Guo for the
//                     fluid, TRT with drift u + K E for the ions, TRT (+
//                     Joule source) for the temperature.  It writes the
//                     post-collision populations; at z=0 and NZ-1 the
//                     fluid's reflected PRE-collision populations instead
//                     (moving-wall term at the top).  It also writes the
//                     Poisson RHS -kappa (c+ - c-) / eps for z = 1..NZ-2
//                     from the pre-collision ion moments.  A chunk's first
//                     launch.
//   fused_pass_kernel one thread per node: the stream of step k-1 and the
//                     collide of step k.  It pulls step k-1's post-collision
//                     set into the node by stream_bc_kernel's rules (Pulled)
//                     -- step k's pre-collision populations -- and runs
//                     collide_kernel's body on them with phi_k: step k's
//                     post-collision set and the RHS of its pre-collision
//                     moments.  Exact, because that RHS and the phi the
//                     collide takes are the two-launch step's; every node
//                     runs the same operations in the same order, so a
//                     chunk equals its two-launch steps bit for bit.
//   fused_pass_halo_kernel  the same pass on a shard (below).
//   stream_bc_kernel  one thread per 4 nodes of a row in f32 (2 in f64;
//                     one where NX is no multiple): pull post[d, z-ez,
//                     y-ey, x-ex] through the pass's pull tables (PullSrc),
//                     16-byte loads at x and the value across x from the
//                     neighbour lane, with periodic wrap in all three axes
//                     (the fluid's z-wrap through the reflected wall planes
//                     is the reference semantics), then the scalar wall BCs
//                     from
//                     the post-collision values at the same node: ion
//                     noflux / injection / zerograd-top, temperature
//                     anti-bounce-back.  zerograd-top: every ion read of
//                     post plane NZ-1 takes plane NZ-2, and the top plane
//                     is post[d, NZ-2, y-ey, x-ex] for every d.  A chunk's
//                     last launch.
//   hartley_rows_kernel  the TPU kernel's x-Hartley products
//                     (fused_step.py:247-268, :680-696, :984-990) as a
//                     product of its own: out[r, :] = in[r, :] @ H
//                     (+ lift(z(r))), H[j, k] = cas(2 pi j k / NX), over M
//                     contiguous rows of NX values.  The wrapper composes
//                     the two x-Hartley forms from it and the collide (or
//                     the fused pass): <hartley_x> the plain RHS into a
//                     scratch (NZ-2, NY, NX), then the product on the RHS
//                     rows; <phi_hx> the product with lift decodes psi_hx
//                     into a phi scratch (NZ, NY, NX), each row once (a
//                     shard's two psi halo rows too), the collide or pass
//                     reads that phi, then the product on the RHS rows.
//
// The sharded forms (the TPU kernel's halo=True, fused_step.py:240-245,
// :516-520, and shard_x, :294-318; host side ekpnp_torch/parallel/halo.py) run
// on one shard's local (Q, NZ, NYl, NXl) block, with the neighbours' edge
// data in small halo buffers in place of the local wrap; a chunk is a
// collide, n - 1 passes and a stream per shard, as on one device:
//   - collide_kernel and the pass read phi at y = -1 and y = NYl from two
//     rows (NZ, NXl) of the y-neighbours (decoded from psi_hx rows by
//     hartley_rows_kernel on the phi_hx route), and on a pencil shard at
//     x = -1 and x = NXl from two columns (NZ, NYl) of the x-neighbours
//     (PhiSrc; null halos wrap, so one collide_kernel serves one device and
//     shards);
//   - the shard pass (fused_pass_halo_kernel) pulls across a y
//     edge from the neighbour's POST-collision edge row, exchanged after
//     the collide or pass and holding only the directions that pull across
//     that edge: 9 of 27 (D3Q27), 5 of 19, 1 of 7, in direction order
//     (edge_slot).  On a slab x wraps locally.  On a pencil it pulls across
//     an x edge from the x-neighbour's post-collision column (x_slot), all
//     NZ planes (the ions' top plane under zerograd-top pulls from plane
//     NZ-2); the host exchanges the columns first and cuts each row from
//     the sender's block widened by the two columns it received, so a row
//     is NXl + 2 wide and its end values are the diagonal shard's corners.
//     A pulled value is collided in registers at once, so nothing repairs
//     the columns after a pass: they must be right when pulled.  Its own
//     kernel, the one-device pass's body with another source: the edge
//     selects in the one-device pass would cost it (as they cost the
//     one-device stream 8-12 %, PERF.md); interior nodes stage through
//     PullSrc's tables, only edge nodes through the selects;
//   - stream_bc_halo_kernel, a chunk's last launch, pulls across the y
//     edges from the rows (PostSrc); x wraps locally and on a pencil the
//     host repairs the two wrap columns afterwards (fix_x_columns).
// This is not the TPU's data flow (pre-collision 8-row halo blocks, halo
// rows collided again, DMA-aligned): post-collision rows and columns
// travel instead, on a side stream while the solve runs.  The one-device
// pass and stream keep their own instantiations.
//
// Bound: device-memory bytes.  A fused pass moves 872 B/node with every
// field on D3Q27 in f32 (step k-1's post-collision set read, step k's
// written, phi read, rhs written), 392 B with D3Q7 scalars; the collide +
// stream pair it replaces moved 1736 / 776 B (a post-collision scratch set
// written and read back).  Each value is pulled once; the pass reads it
// twice (the moments, then the TRT), so fused_pass_kernel stages what each
// thread pulls into shared memory first (StagedSrc: cp.async of single
// elements, since a pull is misaligned by ex; 128 nodes x 108 values =
// 55 KB a block all-D3Q27 f32, dynamic shared memory), which puts all of a
// thread's loads in flight without holding registers and serves both reads
// from shared memory.  A direct version reading device memory twice took
// nearly twice as long (PERF.md); the collide stages its values too.
// Constants are folded in double on the host and cast to T, as the TPU
// kernel's cst() does.  The x-Hartley products add 2 NX operations per RHS
// value and per decoded phi value, and each sends its rows through device
// memory once more (in and out: 2 x 67 MB per product at 256^3 in f32):
// on the TPU the products ride the idle MXU inside the step kernel, but on
// Hopper holding whole rows in the collide's block cost it its occupancy
// and decoded every phi row 3.75 times (PERF.md).  hartley_rows_kernel is
// a register-tiled product on the FMA pipes (no tensor cores: TF32 would
// leave the 1e-5 tolerance of f32, and each output is summed over x in
// order 0..NX-1 with explicit fused multiply-adds, as the plain version's
// kernels were, so f64 stays at 0 / <= 1e-12).  A shard moves the same
// bytes per node plus its halo: two phi rows (and columns), two post rows
// of 9 / 5 / 1 directions per field (and on a pencil two columns).  The
// halo reads select a pointer and an index (PhiSrc, ShardPulled, pull) and
// the slot comes from a table (edge_slot, x_slot): a first version with a
// branch per read and a counting loop per slot had nvcc still compiling
// after 14 minutes.
//
// Plain C interface for ctypes; every entry point returns the
// cudaGetLastError() of its launch (or -1 for an unsupported lattice pair,
// -2 for a row-product tile or grid the kernel was not built with, -3 for
// a call in the other element type).  One library per element type: built
// with -DEKPNP_REAL=float and -DEKPNP_REAL=double, two nvcc processes side
// by side (kernels/fused_step.py build).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// Host-side constant blocks, field order identical to _INTS / _CONSTS in
// ekpnp_torch/kernels/fused_step.py.
struct HostInts {
  int nx, ny, nz, qf, qs;
  int ek, nspec, thermal, cbc;  // cbc: 0 noflux, 1 injection, 2 zerograd-top
  int joule_on;                 // Joule source active (joule != 0 and EK)
  int wneg[3];                  // wall reflection negated: h, hn, g
};

struct HostConsts {
  double inv_cfl, half_dt, dt;
  double kappa, rhs_scale, ext_field, exf, buoy;
  double hdx, hdy, hdz;
  double f_tscale, f_ics2, f_op, f_om, f_splus, f_sminus;
  double s_tscale, s_ics2;
  double h_op, h_om, K, hn_op, hn_om, Kn, g_op, g_om, joule;
  double wf[27], ws[27], mw[27], gjw[27], fwics2[27];
  double wadd[3][2][27];        // [h, hn, g][z=0, z=NZ-1][d] added at the wall
};

template <typename T>
struct Params {
  int nx, ny, nz, ek, nspec, thermal, cbc, joule_on;
  int wneg[3];
  T inv_cfl, half_dt, dt, kappa, rhs_scale, ext_field, exf, buoy, hdx, hdy, hdz;
  T f_tscale, f_ics2, f_op, f_om, f_splus, f_sminus;
  T s_tscale, s_ics2, h_op, h_om, K, hn_op, hn_om, Kn, g_op, g_om, joule;
  T wf[27], ws[27], mw[27], gjw[27], fwics2[27];
  T wadd[3][2][27];
};

template <typename T>
Params<T> make_params(const HostInts& I, const HostConsts& C) {
  Params<T> P;
  P.nx = I.nx; P.ny = I.ny; P.nz = I.nz; P.ek = I.ek; P.nspec = I.nspec;
  P.thermal = I.thermal; P.cbc = I.cbc; P.joule_on = I.joule_on;
  for (int k = 0; k < 3; ++k) P.wneg[k] = I.wneg[k];
  P.inv_cfl = T(C.inv_cfl); P.half_dt = T(C.half_dt); P.dt = T(C.dt);
  P.kappa = T(C.kappa); P.rhs_scale = T(C.rhs_scale);
  P.ext_field = T(C.ext_field); P.exf = T(C.exf); P.buoy = T(C.buoy);
  P.hdx = T(C.hdx); P.hdy = T(C.hdy); P.hdz = T(C.hdz);
  P.f_tscale = T(C.f_tscale); P.f_ics2 = T(C.f_ics2);
  P.f_op = T(C.f_op); P.f_om = T(C.f_om);
  P.f_splus = T(C.f_splus); P.f_sminus = T(C.f_sminus);
  P.s_tscale = T(C.s_tscale); P.s_ics2 = T(C.s_ics2);
  P.h_op = T(C.h_op); P.h_om = T(C.h_om); P.K = T(C.K);
  P.hn_op = T(C.hn_op); P.hn_om = T(C.hn_om); P.Kn = T(C.Kn);
  P.g_op = T(C.g_op); P.g_om = T(C.g_om); P.joule = T(C.joule);
  for (int d = 0; d < 27; ++d) {
    P.wf[d] = T(C.wf[d]); P.ws[d] = T(C.ws[d]);
    P.mw[d] = T(C.mw[d]); P.gjw[d] = T(C.gjw[d]);
    P.fwics2[d] = T(C.fwics2[d]);
    for (int k = 0; k < 3; ++k)
      for (int s = 0; s < 2; ++s) P.wadd[k][s][d] = T(C.wadd[k][s][d]);
  }
  return P;
}

// D3Q27 directions (ex, ey, ez); D3Q19 and D3Q7 are its prefixes.  The
// opposite of d >= 1 is d + 1 for odd d, d - 1 for even d.
__device__ __forceinline__ int dir_e(int d, int a) {
  const int tab[27][3] = {
      {0, 0, 0},   {1, 0, 0},   {-1, 0, 0},  {0, 1, 0},   {0, -1, 0},
      {0, 0, 1},   {0, 0, -1},  {1, 1, 0},   {-1, -1, 0}, {1, 0, 1},
      {-1, 0, -1}, {0, 1, 1},   {0, -1, -1}, {1, -1, 0},  {-1, 1, 0},
      {1, 0, -1},  {-1, 0, 1},  {0, 1, -1},  {0, -1, 1},  {1, 1, 1},
      {-1, -1, -1}, {1, 1, -1}, {-1, -1, 1}, {1, -1, 1},  {-1, 1, -1},
      {-1, 1, 1},  {1, -1, -1}};
  return tab[d][a];
}

__device__ __forceinline__ int dir_opp(int d) {
  return d == 0 ? 0 : ((d & 1) ? d + 1 : d - 1);
}

template <typename T>
__device__ __forceinline__ T edot(int d, T ax, T ay, T az) {
  T acc = T(0);
  const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
  if (ex > 0) acc += ax; else if (ex < 0) acc -= ax;
  if (ey > 0) acc += ay; else if (ey < 0) acc -= ay;
  if (ez > 0) acc += az; else if (ez < 0) acc -= az;
  return acc;
}

template <typename T>
__device__ __forceinline__ T ld(const T* __restrict__ p, int64_t i) {
  return __ldg(p + i);
}

// BYTES from gmem to smem, asynchronously; zeros where !ok (gmem is then
// not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(gmem), "n"(BYTES), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <int Q, typename T, typename V>
__device__ __forceinline__ T moment0(const Params<T>& P, const V& v) {
  T m = T(0);
#pragma unroll
  for (int d = 0; d < Q; ++d) m += v(P, d);
  return m;
}

// Where the collide reads a node's pre-collision populations.  A source's
// view(P, k, z, y, x, N) is field k's (0 f, 1 h, 2 hn, 3 g) populations at
// node (z, y, x); a view's (P, d) reads direction d.  The collide body
// (node_macro, trt_field, collide_node) is the same for every source.
//   StateSrc  the state itself, at the node (collide_kernel's plane-1
//             reads for the z=0 wall velocity; its node's own values come
//             from SlotSrc, the block's copy in shared memory).
//   PullSrc   the previous step's post-collision set, streamed into the
//             node as stream_bc_kernel streams it (the one-device
//             fused_pass_kernel's plane-1 reads for the z=0 wall velocity).
//   ShardSrc  the same on a shard: across a y edge from the y-neighbours'
//             exchanged post-collision rows, and on a pencil across an x
//             edge from the x-neighbours' columns, in place of the wrap
//             (fused_pass_halo_kernel's plane-1 reads).
//   StagedSrc (fused_pass_kernel): the values a PullSrc view gives,
//             copied by the thread into its shared-memory slots first;
//             ShardStagedSrc (fused_pass_halo_kernel) the same for the
//             values of PullSrc (interior nodes) or ShardSrc views.
template <typename T>
struct AtNode {
  const T* p;
  int64_t N, idx;
  __device__ __forceinline__ T operator()(const Params<T>&, int d) const {
    return ld(p, d * N + idx);
  }
};

template <typename T>
struct StateSrc {
  const T* pop[4];
  __device__ __forceinline__ AtNode<T> view(const Params<T>& P, int k, int z,
                                            int y, int x, int64_t N) const {
    return AtNode<T>{pop[k], N, ((int64_t)z * P.ny + y) * P.nx + x};
  }
};

// Direction d of one field at one node after the stream (stream_bc_kernel's
// rules, read in place): post[d, z - ez, y - ey, x - ex] with the periodic
// wrap -- the fluid everywhere (its z wrap passes through the reflected
// wall planes the collide wrote), a scalar off its walls; zerograd-top: an
// ion read of plane NZ-1 takes NZ-2, and the ions' top plane pulls every
// direction from NZ-2.  At a scalar's wall node the reflected post value
// at the node, (-)post[opp d, z, y, x] + wadd (scalar_wall).  One select
// of the index per read and one of the value, no branch.
template <typename T>
struct Pulled {
  const T* p;
  int64_t N, idx;
  int64_t zo[3];     // offset of the source plane, by ez + 1
  int yo[3], xo[3];  // of the source row (y NX), column, by ey + 1, ex + 1
  bool wall;         // a scalar's wall node: reflected at the node
  int k, s;          // scalar field (0 h, 1 hn, 2 g), wall (0 z=0, 1 top)
  __device__ __forceinline__ int64_t src(int d) const {
    const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
    return wall ? dir_opp(d) * N + idx
                : d * N + zo[ez + 1] + yo[ey + 1] + xo[ex + 1];
  }
  // the wall rule on the value read at src(d)
  __device__ __forceinline__ T fix(const Params<T>& P, int d, T v) const {
    return wall ? (P.wneg[k] != 0 ? -v : v) + P.wadd[k][s][d] : v;
  }
  __device__ __forceinline__ T operator()(const Params<T>& P, int d) const {
    return fix(P, d, ld(p, src(d)));
  }
  __device__ __forceinline__ const T* at(int d) const { return p + src(d); }
};

template <typename T>
struct PullSrc {
  const T* post[4];
  __device__ __forceinline__ Pulled<T> view(const Params<T>& P, int k, int z,
                                            int y, int x, int64_t N) const {
    const int64_t plane = (int64_t)P.ny * P.nx;
    const bool top = z == P.nz - 1;
    const bool zg = (k == 1 || k == 2) && P.cbc == 2;
    Pulled<T> v;
    v.p = post[k];
    v.N = N;
    v.idx = z * plane + (int64_t)y * P.nx + x;
    v.wall = k > 0 && (z == 0 || top) && !(zg && top);
    v.k = k > 0 ? k - 1 : 0;
    v.s = z == 0 ? 0 : 1;
    const int zs[3] = {top ? 0 : z + 1, z, z == 0 ? P.nz - 1 : z - 1};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v.zo[i] = (zg && (top || zs[i] == P.nz - 1) ? P.nz - 2 : zs[i]) * plane;
    v.yo[0] = (y == P.ny - 1 ? 0 : y + 1) * P.nx;
    v.yo[1] = y * P.nx;
    v.yo[2] = (y == 0 ? P.ny - 1 : y - 1) * P.nx;
    v.xo[0] = x == P.nx - 1 ? 0 : x + 1;
    v.xo[1] = x;
    v.xo[2] = x == 0 ? P.nx - 1 : x - 1;
    return v;
  }
};

// Slot of direction d among the directions of its y-component (ey = +1 or
// ey = -1) in direction order: its row in a PostSrc lo / hi buffer.  An
// opposite pair (d, d+1) shares its slot; directions with ey = 0 have
// none (0 here, never read).  The same for every Q: D3Q19 and D3Q7 are
// prefixes of the D3Q27 table.  A table, like dir_e: counting the earlier
// directions in a loop made every unrolled read a nested loop.
__device__ __forceinline__ int edge_slot(int d) {
  const int tab[27] = {0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 2, 2, 3,
                       3, 0, 0, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8};
  return tab[d];
}

// The same along x: the slot of d among the directions with its ex (+1 or
// -1), its row in a pencil shard's x-halo column buffer.
__device__ __forceinline__ int x_slot(int d) {
  const int tab[27] = {0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 0, 0, 3,
                       3, 4, 4, 0, 0, 5, 5, 6, 6, 7, 7, 8, 8};
  return tab[d];
}

// One field's post-collision set on a shard and the neighbours' edge data
// its pulls read across the shard's edges, each (n, NZ, ...) holding only
// the n directions that pull across that edge, in direction order (slots
// edge_slot / x_slot):
//   lo / hi    rows y = -1 / y = NY (the directions with ey = +1 / -1) of
//              the y-neighbours, (n, NZ, RW);
//   xlo / xhi  on a pencil, columns x = -1 / x = NX (ex = +1 / -1) of the
//              x-neighbours, (n, NZ, NY); null on a slab, where x wraps.
// A pencil's rows are RW = NX + 2 wide, columns -1 .. NX: the sender built
// them from its block widened by the two columns it had received, so the
// row carries the diagonal shard's corner values; a slab's are NX wide.
template <typename T>
struct ShardEdges {
  const T* post;
  const T* lo;
  const T* hi;
  const T* xlo;
  const T* xhi;
};

// Direction d of one field at one shard node after the stream: Pulled's
// rules, with the source row y - ey in -1 .. NY and the column x - ex in
// -1 .. NX (pencil) or wrapped (slab).  A read outside the block takes the
// row buffer if its row is out (corners included), else the column
// buffer: selects of the pointer and the index, as PhiSrc's, no branch.
// The three candidate indices are sums of per-view tables, as Pulled's
// (the two buffers' in 32 bits: they hold a few rows).
template <typename T>
struct ShardPulled {
  ShardEdges<T> e;
  int64_t N, idx;
  int64_t zo[3];        // in post: offset of the source plane, by ez + 1
  int yo[3], xo[3];     // of the source row (y NX), column, by ey + 1, ex + 1
  int rz[3], rx[3];     // in a row buffer: plane (z RW), column (x + xoff)
  int cz[3], cy[3];     // in a column buffer: plane (z NY), row (y)
  int rs, cs;           // a slot's stride in the row / column buffers
  bool ylo, yhi;        // row -1 / NY is a halo row (y == 0 / y == NY-1)
  bool xlo, xhi;        // column -1 / NX is a halo column (pencil)
  bool wall;            // a scalar's wall node: reflected at the node
  int k, s;             // scalar field (0 h, 1 hn, 2 g), wall (0 z=0, 1 top)
  __device__ __forceinline__ const T* at(int d) const {
    const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
    const bool yout = ey > 0 ? ylo : (ey < 0 ? yhi : false);
    const bool xout = ex > 0 ? xlo : (ex < 0 ? xhi : false);
    const int64_t in = d * N + zo[ez + 1] + yo[ey + 1] + xo[ex + 1];
    const int row = edge_slot(d) * rs + rz[ez + 1] + rx[ex + 1];
    const int col = x_slot(d) * cs + cz[ez + 1] + cy[ey + 1];
    const T* p = yout ? (ey > 0 ? e.lo : e.hi)
                      : (xout ? (ex > 0 ? e.xlo : e.xhi) : e.post);
    const int64_t i = yout ? (int64_t)row : (xout ? (int64_t)col : in);
    return wall ? e.post + (dir_opp(d) * N + idx) : p + i;
  }
  // the wall rule on the value read at at(d)
  __device__ __forceinline__ T fix(const Params<T>& P, int d, T v) const {
    return wall ? (P.wneg[k] != 0 ? -v : v) + P.wadd[k][s][d] : v;
  }
  __device__ __forceinline__ T operator()(const Params<T>& P, int d) const {
    return fix(P, d, __ldg(at(d)));
  }
};

// A shard pass's source: the four fields' ShardEdges.
template <typename T>
struct ShardSrc {
  ShardEdges<T> e[4];
  __device__ __forceinline__ ShardPulled<T> view(const Params<T>& P, int k,
                                                 int z, int y, int x,
                                                 int64_t N) const {
    const int64_t plane = (int64_t)P.ny * P.nx;
    const bool top = z == P.nz - 1;
    const bool zg = (k == 1 || k == 2) && P.cbc == 2;
    const bool pencil = e[k].xlo != nullptr;
    const int rw = pencil ? P.nx + 2 : P.nx, xoff = pencil ? 1 : 0;
    ShardPulled<T> v;
    v.e = e[k];
    v.N = N;
    v.idx = z * plane + (int64_t)y * P.nx + x;
    v.wall = k > 0 && (z == 0 || top) && !(zg && top);
    v.k = k > 0 ? k - 1 : 0;
    v.s = z == 0 ? 0 : 1;
    const int raw[3] = {top ? 0 : z + 1, z, z == 0 ? P.nz - 1 : z - 1};
    const int xs[3] = {!pencil && x == P.nx - 1 ? 0 : x + 1, x,
                       !pencil && x == 0 ? P.nx - 1 : x - 1};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int zs = zg && (top || raw[i] == P.nz - 1) ? P.nz - 2 : raw[i];
      v.zo[i] = zs * plane;
      v.yo[i] = (y + 1 - i) * P.nx;
      v.xo[i] = xs[i];
      v.rz[i] = zs * rw;
      v.rx[i] = xs[i] + xoff;
      v.cz[i] = zs * P.ny;
      v.cy[i] = y + 1 - i;
    }
    v.rs = P.nz * rw;
    v.cs = P.nz * P.ny;
    v.ylo = y == 0;
    v.yhi = y == P.ny - 1;
    v.xlo = pencil && x == 0;
    v.xhi = pencil && x == P.nx - 1;
    return v;
  }
  // a node that pulls nothing across an edge (PullSrc's tables serve it:
  // its y wrap is never taken there, and x wraps on a slab)
  __device__ __forceinline__ bool interior(const Params<T>& P, int y,
                                           int x) const {
    return y > 0 && y < P.ny - 1
           && (e[0].xlo == nullptr || (x > 0 && x < P.nx - 1));
  }
  __device__ __forceinline__ PullSrc<T> inner() const {
    return PullSrc<T>{{e[0].post, e[1].post, e[2].post, e[3].post}};
  }
};

constexpr int kThreads = 128;

// The thread's own slots in shared memory: slot (base + d) of field k at
// stride kThreads (a warp reads 32 consecutive words), holding the value
// read at src(d); the wall rule applies on the read.
template <typename T>
struct Staged {
  Pulled<T> at;
  T* s;
  __device__ __forceinline__ T operator()(const Params<T>& P, int d) const {
    return at.fix(P, d, s[d * kThreads]);
  }
};

// First slot of field k: f, then h, hn, g as active.
template <typename T, int QF, int QS>
__device__ __forceinline__ int slot_base(const Params<T>& P, int k) {
  const int nh = P.ek ? QS : 0, nhn = P.nspec == 2 ? QS : 0;
  return k == 0 ? 0 : (k == 1 ? QF : (k == 2 ? QF + nh : QF + nh + nhn));
}

template <typename T, int QF, int QS>
struct StagedSrc {
  PullSrc<T> pull;
  T* slots;  // this thread's first slot
  __device__ __forceinline__ Staged<T> view(const Params<T>& P, int k, int z,
                                            int y, int x, int64_t N) const {
    return Staged<T>{pull.view(P, k, z, y, x, N),
                     slots + slot_base<T, QF, QS>(P, k) * kThreads};
  }
};

// A shard pass's staged view: its slots and the wall rule alone (the
// pull tables are spent once the values are staged).
struct WallRule {
  bool wall;  // a scalar's wall node: reflected at the node
  int k, s;   // scalar field (0 h, 1 hn, 2 g), wall (0 z=0, 1 top)
  template <typename T>
  __device__ __forceinline__ WallRule(const Params<T>& P, int k_, int z) {
    const bool top = z == P.nz - 1;
    const bool zg = (k_ == 1 || k_ == 2) && P.cbc == 2;
    wall = k_ > 0 && (z == 0 || top) && !(zg && top);
    k = k_ > 0 ? k_ - 1 : 0;
    s = z == 0 ? 0 : 1;
  }
  template <typename T>
  __device__ __forceinline__ T fix(const Params<T>& P, int d, T v) const {
    return wall ? (P.wneg[k] != 0 ? -v : v) + P.wadd[k][s][d] : v;
  }
};

template <typename T>
struct ShardStaged {
  WallRule w;
  T* s;
  __device__ __forceinline__ T operator()(const Params<T>& P, int d) const {
    return w.fix(P, d, s[d * kThreads]);
  }
};

template <typename T, int QF, int QS>
struct ShardStagedSrc {
  T* slots;  // this thread's first slot
  __device__ __forceinline__ ShardStaged<T> view(const Params<T>& P, int k,
                                                 int z, int, int,
                                                 int64_t) const {
    return ShardStaged<T>{WallRule(P, k, z),
                          slots + slot_base<T, QF, QS>(P, k) * kThreads};
  }
};

// Pre-collision macroscopic state of one node.
template <typename T>
struct NodeMacro {
  T rho, nx, ny, nz;     // density and velocity numerator (mom/CFL + dt F/2)
  T fx, fy, fz;          // body force
  T c, cn, tm;           // ion concentrations and temperature
  T Ex, Ey, Ez;          // E = -grad(phi)
};

// phi read from device memory.  The E stencil reads z +- 1 in range (at)
// and x +- 1, y +- 1 across the block's edge: there a shard reads its halo
// -- the rows ylo / yhi (NZ, NX) at y = -1 / NY, the columns xlo / xhi
// (NZ, NY) at x = -1 / NX -- and one device, whose halo pointers are null,
// wraps.  Each edge read is one compare and selects of the pointer and the
// index, so the collide stays straight-line code (branches per read made
// nvcc's build of this file run away).
template <typename T>
struct PhiHalo {
  const T* ylo;
  const T* yhi;
  const T* xlo;
  const T* xhi;
};

template <typename T>
struct PhiSrc {
  const T* phi;
  const T* ylo;
  const T* yhi;
  const T* xlo;
  const T* xhi;
  int ny, nx;
  __device__ __forceinline__ PhiSrc(const T* p, const PhiHalo<T>& h, int ny_,
                                    int nx_)
      : phi(p), ylo(h.ylo), yhi(h.yhi), xlo(h.xlo), xhi(h.xhi), ny(ny_),
        nx(nx_) {}
  __device__ __forceinline__ T at(int z, int y, int x) const {
    return ld(phi, ((int64_t)z * ny + y) * nx + x);
  }
  // the neighbour of (z, y, x) at y + DY (DY = -1 / +1)
  template <int DY>
  __device__ __forceinline__ T y_off(int z, int y, int x) const {
    const bool edge = DY < 0 ? y == 0 : y == ny - 1;
    const T* halo = DY < 0 ? ylo : yhi;
    const bool use = edge && halo != nullptr;
    const int wy = edge ? (DY < 0 ? ny - 1 : 0) : y + DY;
    return ld(use ? halo : phi, use ? (int64_t)z * nx + x
                                    : ((int64_t)z * ny + wy) * nx + x);
  }
  template <int DX>
  __device__ __forceinline__ T x_off(int z, int y, int x) const {
    const bool edge = DX < 0 ? x == 0 : x == nx - 1;
    const T* halo = DX < 0 ? xlo : xhi;
    const bool use = edge && halo != nullptr;
    const int wx = edge ? (DX < 0 ? nx - 1 : 0) : x + DX;
    return ld(use ? halo : phi, use ? (int64_t)z * ny + y
                                    : ((int64_t)z * ny + y) * nx + wx);
  }
};

template <typename T, int QF, int QS, typename Src, typename Phi>
__device__ __forceinline__ void node_macro(
    const Params<T>& P, const Src& src, const Phi& phi, int z, int y, int x,
    int64_t N, NodeMacro<T>& o) {
  const auto vf = src.view(P, 0, z, y, x, N);
  T rho = T(0), mx = T(0), my = T(0), mz = T(0);
#pragma unroll
  for (int d = 0; d < QF; ++d) {
    const T v = vf(P, d);
    rho += v;
    const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
    if (ex > 0) mx += v; else if (ex < 0) mx -= v;
    if (ey > 0) my += v; else if (ey < 0) my -= v;
    if (ez > 0) mz += v; else if (ez < 0) mz -= v;
  }
  T fx, fy, fz;
  o.c = o.cn = o.tm = T(0);
  o.Ex = o.Ey = o.Ez = T(0);
  if (P.ek) {
    // across the block's edge the phi source wraps or reads its halo
    const int zc = z == 0 ? 1 : (z == P.nz - 1 ? P.nz - 2 : z);
    o.Ex = (phi.template x_off<-1>(z, y, x)
            - phi.template x_off<1>(z, y, x)) * P.hdx;
    o.Ey = (phi.template y_off<-1>(z, y, x)
            - phi.template y_off<1>(z, y, x)) * P.hdy;
    o.Ez = (phi.at(zc - 1, y, x) - phi.at(zc + 1, y, x)) * P.hdz;
    o.c = moment0<QS>(P, src.view(P, 1, z, y, x, N));
    if (P.nspec == 2) o.cn = moment0<QS>(P, src.view(P, 2, z, y, x, N));
    const T q = P.kappa * (o.c - o.cn);
    fx = q * (o.Ex + P.ext_field) + P.exf;
    fy = q * o.Ey;
    fz = q * o.Ez;
  } else {
    fx = P.exf;
    fy = T(0);
    fz = T(0);
  }
  if (P.thermal) {
    o.tm = moment0<QS>(P, src.view(P, 3, z, y, x, N));
    fz = fz + P.buoy * o.tm;
  }
  o.rho = rho;
  o.fx = fx; o.fy = fy; o.fz = fz;
  o.nx = mx * P.inv_cfl + P.half_dt * fx;
  o.ny = my * P.inv_cfl + P.half_dt * fy;
  o.nz = mz * P.inv_cfl + P.half_dt * fz;
}

// Second-order equilibrium of direction d, in the plain version's operation
// order: (w m) (omusq + t (1 + t/2)), t = (e . v) tscale.
template <typename T>
__device__ __forceinline__ T feq_dir(int d, T wm, T omusq, T vx, T vy, T vz,
                                     T tscale) {
  const T t = edot(d, vx, vy, vz) * tscale;
  return wm * (omusq + t * (T(1) + T(0.5) * t));
}

// Guo forcing population of fluid direction d:
// (w / cs^2) [ (e/CFL - u) . F + (e.u)(e.F) / (CFL^2 cs^2) ].
template <typename T>
__device__ __forceinline__ T guo_dir(int d, const Params<T>& P, T ux, T uy,
                                     T uz, T fx, T fy, T fz) {
  const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
  const T c = P.inv_cfl;
  const T cu = (ex > 0 ? c : (ex < 0 ? -c : T(0))) - ux;
  const T cv = (ey > 0 ? c : (ey < 0 ? -c : T(0))) - uy;
  const T cw = (ez > 0 ? c : (ez < 0 ? -c : T(0))) - uz;
  const T eu = edot(d, ux, uy, uz) * P.inv_cfl;
  const T eF = edot(d, fx, fy, fz) * P.inv_cfl;
  const T core = ((cu * fx + cv * fy) + cw * fz) + (eu * eF) * P.f_ics2;
  return P.fwics2[d] * core;
}

// TRT update of one field at one node, pair by pair (d, opp d), in the
// plain version's operation order (ekpnp_torch/ops/collide.py _trt_update):
//   out = p - (op (p+ - feq+) + om (p- - feq-))  [+ dt (s+ S+ + s- S-)]
//         [+ dt w S_iso].
// Built with --fmad=false, so the f64 kernel repeats the plain version's
// roundings and the golden values hold through it.
template <int Q, bool FORCE, bool ISO, typename T, typename V>
__device__ __forceinline__ void trt_field(
    const V& in, T* __restrict__ out, int64_t N, int64_t idx,
    const T* w, T m, T vx, T vy, T vz, T tscale, T ics2, T op, T om,
    const Params<T>& P, T fx, T fy, T fz, T S) {
  const T omusq = T(1) - (T(0.5) * ((vx * vx + vy * vy) + vz * vz)) * ics2;

  const T p0 = in(P, 0);
  T o0 = p0 - op * (p0 - feq_dir(0, w[0] * m, omusq, vx, vy, vz, tscale));
  if (FORCE) o0 = o0 + P.dt * (P.f_splus * guo_dir(0, P, vx, vy, vz, fx, fy, fz));
  if (ISO) o0 = o0 + P.gjw[0] * S;
  out[idx] = o0;
#pragma unroll
  for (int i = 1; i < Q; i += 2) {
    const int j = i + 1;
    const T pi = in(P, i), pj = in(P, j);
    const T wm = w[i] * m;
    const T fi = feq_dir(i, wm, omusq, vx, vy, vz, tscale);
    const T fj = feq_dir(j, wm, omusq, vx, vy, vz, tscale);
    const T a = op * (T(0.5) * (pi + pj) - T(0.5) * (fi + fj));
    const T b = om * (T(0.5) * (pi - pj) - T(0.5) * (fi - fj));
    T oi = pi - (a + b);
    T oj = pj - (a - b);
    if (FORCE) {
      const T gi = guo_dir(i, P, vx, vy, vz, fx, fy, fz);
      const T gj = guo_dir(j, P, vx, vy, vz, fx, fy, fz);
      const T sp = P.f_splus * (T(0.5) * (gi + gj));
      const T sm = P.f_sminus * (T(0.5) * (gi - gj));
      oi = oi + P.dt * (sp + sm);
      oj = oj + P.dt * (sp - sm);
    }
    if (ISO) {
      const T iso = P.gjw[i] * S;
      oi = oi + iso;
      oj = oj + iso;
    }
    out[i * N + idx] = oi;
    out[j * N + idx] = oj;
  }
}

// Collide one node: writes its post-collision populations (the reflected
// pre-collision fluid at the plates) and returns its plain Poisson RHS
// value -kappa (c+ - c-) / eps (0 without EK).  `src` gives the node's
// pre-collision populations, `src1` those of plane 1 for the z=0 thread's
// wall velocity.
template <typename T, int QF, int QS, typename Src, typename Src1,
          typename Phi>
__device__ __forceinline__ T collide_node(
    const Params<T>& P, const Src& src, const Src1& src1, const Phi& phi,
    T* __restrict__ pf, T* __restrict__ ph, T* __restrict__ phn,
    T* __restrict__ pg, int z, int y, int x, int64_t N, int64_t idx) {
  NodeMacro<T> m;
  node_macro<T, QF, QS>(P, src, phi, z, y, x, N, m);
  T ux, uy, uz;
  if (z == 0) {
    // wall velocity extrapolated from plane 1's numerator, local wall rho
    NodeMacro<T> m1;
    node_macro<T, QF, QS>(P, src1, phi, 1, y, x, N, m1);
    ux = -m1.nx / m.rho;
    uy = -m1.ny / m.rho;
    uz = -m1.nz / m.rho;
  } else {
    ux = m.nx / m.rho;
    uy = m.ny / m.rho;
    uz = m.nz / m.rho;
  }

  const auto vf = src.view(P, 0, z, y, x, N);
  if (z == 0 || z == P.nz - 1) {
    // fluid bounce-back of the pre-collision populations (+ moving wall)
    const bool top = z == P.nz - 1;
#pragma unroll
    for (int d = 0; d < QF; ++d) {
      T v = vf(P, dir_opp(d));
      if (top) v = v + P.mw[d];
      pf[d * N + idx] = v;
    }
  } else {
    trt_field<QF, true, false>(vf, pf, N, idx, P.wf, m.rho, ux, uy, uz,
                               P.f_tscale, P.f_ics2, P.f_op, P.f_om, P,
                               m.fx, m.fy, m.fz, T(0));
  }

  T rhs_v = T(0);
  if (P.ek) {
    trt_field<QS, false, false>(src.view(P, 1, z, y, x, N), ph, N, idx, P.ws,
                                m.c, ux + P.K * m.Ex, uy + P.K * m.Ey,
                                uz + P.K * m.Ez, P.s_tscale, P.s_ics2, P.h_op,
                                P.h_om, P, T(0), T(0), T(0), T(0));
    if (P.nspec == 2)
      trt_field<QS, false, false>(src.view(P, 2, z, y, x, N), phn, N, idx,
                                  P.ws, m.cn, ux + P.Kn * m.Ex,
                                  uy + P.Kn * m.Ey, uz + P.Kn * m.Ez,
                                  P.s_tscale, P.s_ics2, P.hn_op, P.hn_om, P,
                                  T(0), T(0), T(0), T(0));
    rhs_v = -(P.rhs_scale * (m.c - m.cn));
  }
  if (P.thermal) {
    const auto vg = src.view(P, 3, z, y, x, N);
    if (P.joule_on) {
      const T S = (P.joule * (m.c + m.cn))
                  * (m.Ex * m.Ex + m.Ey * m.Ey + m.Ez * m.Ez);
      trt_field<QS, false, true>(vg, pg, N, idx, P.ws, m.tm, ux, uy, uz,
                                 P.s_tscale, P.s_ics2, P.g_op, P.g_om, P,
                                 T(0), T(0), T(0), S);
    } else {
      trt_field<QS, false, false>(vg, pg, N, idx, P.ws, m.tm, ux, uy, uz,
                                  P.s_tscale, P.s_ics2, P.g_op, P.g_om, P,
                                  T(0), T(0), T(0), T(0));
    }
  }
  return rhs_v;
}

// The collide's staged view: the node's pre-collision populations in the
// thread's shared-memory slots (slot_base order, stride kThreads), as the
// state holds them: a collide reflects no scalar, so no wall rule.  Its
// own types: fused_pass_kernel keeps StagedSrc as it is (sharing staging
// types with the pass changed the pass's registers, PERF.md).
template <typename T>
struct AtSlot {
  const T* s;
  __device__ __forceinline__ T operator()(const Params<T>&, int d) const {
    return s[d * kThreads];
  }
};

template <typename T, int QF, int QS>
struct SlotSrc {
  const T* slots;  // this thread's first slot
  __device__ __forceinline__ AtSlot<T> view(const Params<T>& P, int k, int,
                                            int, int, int64_t) const {
    return AtSlot<T>{slots + slot_base<T, QF, QS>(P, k) * kThreads};
  }
};

// Active population slots of a node: f, then h, hn, g as active.
template <typename T, int QF, int QS>
__device__ __forceinline__ int slot_count(const Params<T>& P) {
  return slot_base<T, QF, QS>(P, 3) + (P.thermal ? QS : 0);
}

// Copy the block's pre-collision populations into shared memory: slot s
// of node n0 + t at smem[s kThreads + t].  A slot of the block is kThreads
// consecutive values of one direction in the state (x fastest), so the
// block copies it in pieces of W values, one cp.async each: 16 bytes where
// N is a multiple of W and the fields are 16-byte aligned (then every
// piece is), else W = 1 (each thread its own node's values).  Pieces past
// N are zero-filled and never read.
template <int W, int QF, int QS, typename T>
__device__ __forceinline__ void stage_block(const Params<T>& P,
                                            const StateSrc<T>& pops,
                                            int64_t n0, int64_t N, T* smem) {
  constexpr int PER = kThreads / W;  // pieces per slot
  const int b1 = slot_base<T, QF, QS>(P, 1), b2 = slot_base<T, QF, QS>(P, 2),
            b3 = slot_base<T, QF, QS>(P, 3);
  const int n = slot_count<T, QF, QS>(P) * PER;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const int s = c / PER, j = (c % PER) * W;
    // the field and direction of slot s (slot_base's order)
    const int k = s < QF ? 0 : (s < b2 ? 1 : (s < b3 ? 2 : 3));
    const int d = s - (k == 0 ? 0 : (k == 1 ? b1 : (k == 2 ? b2 : b3)));
    const T* const p = k == 0 ? pops.pop[0]
                              : (k == 1 ? pops.pop[1]
                                        : (k == 2 ? pops.pop[2] : pops.pop[3]));
    const bool ok = n0 + j < N;
    cp_async<(int)(W * sizeof(T))>(smem + s * kThreads + j,
                                   ok ? p + d * N + n0 + j : pops.pop[0], ok);
  }
}

// The collide, every form: one thread per node, flat 128-thread blocks;
// the plain RHS (the x-Hartley forms take it through hartley_rows_kernel).
// `phi` carries the halo rows and columns of a shard (null on one device).
// The block first copies its nodes' populations into shared memory
// (stage_block: one read of each value, aligned; vec: in 16-byte pieces),
// then each thread collides its node from its slots (SlotSrc): the moments,
// the TRT and the fluid bounce-back read shared memory, not device memory
// twice or three times.  The z=0 thread's plane-1 reads for the wall
// velocity stay device-memory reads (StateSrc), as the pass keeps its own.
// Dynamic shared memory: slot_count x kThreads values.
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(kThreads) collide_kernel(
    const Params<T> P, const StateSrc<T> pops, const T* __restrict__ phi_,
    const PhiHalo<T> halo, int vec, T* __restrict__ pf, T* __restrict__ ph,
    T* __restrict__ phn, T* __restrict__ pg, T* __restrict__ rhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t n0 = (int64_t)blockIdx.x * kThreads;
  if (vec)
    stage_block<(int)(16 / sizeof(T)), QF, QS>(P, pops, n0, N, smem);
  else
    stage_block<1, QF, QS>(P, pops, n0, N, smem);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // a thread reads slots other threads copied
  const int64_t idx = n0 + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  const SlotSrc<T, QF, QS> src{smem + threadIdx.x};
  const PhiSrc<T> phi(phi_, halo, P.ny, P.nx);
  const T r = collide_node<T, QF, QS>(P, src, pops, phi, pf, ph, phn, pg,
                                      z, y, x, N, idx);
  if (P.ek && z >= 1 && z <= P.nz - 2) rhs[idx - plane] = r;
}

// ---------------------------------------------------------------------------
// The x-Hartley row product: out[r, :] = in[r, :] @ H (+ lift(z(r))) for M
// contiguous rows of NX values (the RHS rows of the hartley_x form, psi_hx
// rows decoded to phi on the phi_hx form).
//
// One block of 256 threads computes a BM x BN tile of the output; thread
// (ty, tx) = (t / 16, t % 16) holds TM x 2W of it in registers: the rows
// ty + 16 i (i < TM) and the columns tx W + c, BN / 2 + tx W + c (c < W).
// The K loop walks x in tiles of BK: the block's rows of `in` (As, row
// major, padded by W so the two rows a warp reads sit in other banks) and
// H's rows (Bs) arrive by cp.async in a ring of kRowsStages tiles, two in
// flight while the third is read as float4 / double2.  Per W values of x a
// thread reads TM + 2W vectors from shared memory for TM 2W W fused
// multiply-adds.  Every output is summed over x in order 0..NX-1 with
// explicit fmadd (no split of x, no tree): one order whatever the tile or
// grid, which keeps f64 at 0 against the plain version on every case and
// the golden values with it.  Tiles past NX (and rows past M) are
// zero-filled, and their 0 * 0 adds change no sum.  VEC: rows of NX values start 16-byte
// aligned (NX % W == 0, aligned pointers), so one cp.async moves a vector;
// otherwise one element.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// Output tile of one block (BM rows, BN columns), x tile BK, rows per
// thread TM, vector width W (16 bytes); BN = 2 x 16 x W.  Mirrored by
// ROWS_TILE in kernels/fused_step.py.
template <typename T>
struct RowsTile;
template <>
struct RowsTile<float> {
  static constexpr int BM = 128, BN = 128, BK = 16, TM = 8, W = 4;
};
template <>
struct RowsTile<double> {
  static constexpr int BM = 128, BN = 64, BK = 16, TM = 8, W = 2;
};

constexpr int kRowsThreads = 256;
constexpr int kRowsStages = 3;

template <typename T>
constexpr size_t rows_smem_bytes() {
  using R = RowsTile<T>;
  return (size_t)kRowsStages * (R::BM * (R::BK + R::W) + R::BK * R::BN)
         * sizeof(T);
}

// W contiguous values from shared memory as one 16-byte load, and back
__device__ __forceinline__ void ld_vec(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld_vec(double* v, const double* p) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// lift: add volt + (volt2 - volt) z / (nz - 1), z = r / rows_per_z, folded
// in double and cast to T, as the plain version's lifting profile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kRowsThreads, 2) hartley_rows_kernel(
    const T* __restrict__ in, const T* __restrict__ H, T* __restrict__ out,
    int64_t m, int nx, int lift, int rows_per_z, int nz, double volt,
    double volt2) {
  using R = RowsTile<T>;
  constexpr int BM = R::BM, BN = R::BN, BK = R::BK, TM = R::TM, W = R::W;
  constexpr int LDA = BK + W;          // As row stride
  constexpr int LW = VEC ? W : 1;      // elements per cp.async
  constexpr int A_CH = BM * BK / LW / kRowsThreads;
  constexpr int B_CH = BK * BN / LW / kRowsThreads;
  static_assert(BN == 32 * W && BM == 16 * TM, "thread tile layout");
  static_assert(A_CH * LW * kRowsThreads == BM * BK
                && B_CH * LW * kRowsThreads == BK * BN, "copy split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const As = reinterpret_cast<T*>(smem_raw);   // [stage][BM][LDA]
  T* const Bs = As + kRowsStages * BM * LDA;       // [stage][BK][BN]

  const int ncol = (nx + BN - 1) / BN;
  const int64_t m0 = (int64_t)(blockIdx.x / ncol) * BM;
  const int n0 = (int)(blockIdx.x % ncol) * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nkt = (nx + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    const int k0 = kt * BK;
    T* const as = As + slot * BM * LDA;
    T* const bs = Bs + slot * BK * BN;
#pragma unroll
    for (int j = 0; j < A_CH; ++j) {
      const int c = tid + j * kRowsThreads;
      const int r = c / (BK / LW), kc = (c % (BK / LW)) * LW;
      const bool ok = m0 + r < m && k0 + kc < nx;
      cp_async<(int)(LW * sizeof(T))>(as + r * LDA + kc,
                               ok ? in + (m0 + r) * nx + k0 + kc : in, ok);
    }
#pragma unroll
    for (int j = 0; j < B_CH; ++j) {
      const int c = tid + j * kRowsThreads;
      const int k = c / (BN / LW), nc = (c % (BN / LW)) * LW;
      const bool ok = k0 + k < nx && n0 + nc < nx;
      cp_async<(int)(LW * sizeof(T))>(
          bs + k * BN + nc, ok ? H + (int64_t)(k0 + k) * nx + n0 + nc : H,
          ok);
    }
  };

  T acc[TM][2 * W];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * W; ++j) acc[i][j] = T(0);

#pragma unroll
  for (int s = 0; s < kRowsStages - 1; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kRowsStages - 2>();  // tile kt has landed
    __syncthreads();                   // and every thread is done with kt-1
    const int next = kt + kRowsStages - 1;
    if (next < nkt) load(next, next % kRowsStages);
    cp_async_commit();
    const int slot = kt % kRowsStages;
    const T* const as = As + slot * BM * LDA + ty * LDA;
    const T* const bs = Bs + slot * BK * BN + tx * W;
#pragma unroll
    for (int kb = 0; kb < BK; kb += W) {
      T a[TM][W];
#pragma unroll
      for (int i = 0; i < TM; ++i) ld_vec(a[i], as + i * 16 * LDA + kb);
#pragma unroll
      for (int kk = 0; kk < W; ++kk) {
        T b[2 * W];
        ld_vec(b, bs + (kb + kk) * BN);
        ld_vec(b + W, bs + (kb + kk) * BN + BN / 2);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 2 * W; ++j)
            acc[i][j] = fmadd(a[i][kk], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= m) break;  // rows ascend with i
    T lv = T(0);
    if (lift) {
      const int z = (int)(r / rows_per_z);
      lv = T(volt + ((volt2 - volt) * (double)z) / (double)(nz - 1));
    }
    T* const o = out + r * nx;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = n0 + hf * (BN / 2) + tx * W;
      T v[W];
#pragma unroll
      for (int c = 0; c < W; ++c)
        v[c] = lift ? acc[i][hf * W + c] + lv : acc[i][hf * W + c];
      if (VEC) {
        if (col < nx) st_vec(o + col, v);
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c)
          if (col + c < nx) o[col + c] = v[c];
      }
    }
  }
}

// Post-collision populations of one field on a shard.  lo / hi: the
// y-neighbours' post-collision rows y = -1 / y = NY, holding only the
// directions with ey = +1 / ey = -1 (those that pull across that edge), in
// direction order, (n, NZ, NX) each.
template <typename T>
struct PostSrc {
  const T* post;
  const T* lo;
  const T* hi;
};

// The halo rows of the four fields (f, h, hn, g), as the kernel takes them.
template <typename T>
struct PostRows {
  const T* lo[4];
  const T* hi[4];
};

// A scalar field's wall node (z = 0 or NZ-1, but not the zerograd top):
// the post-collision populations reflected at the same node.
template <int Q, typename T>
__device__ __forceinline__ void scalar_wall(
    const Params<T>& P, const T* __restrict__ post, T* __restrict__ out,
    int k, int z, int64_t N, int64_t idx) {
  const int s = z == 0 ? 0 : 1;
  const bool neg = P.wneg[k] != 0;
#pragma unroll
  for (int d = 0; d < Q; ++d) {
    const T v = ld(post, dir_opp(d) * N + idx);
    out[d * N + idx] = (neg ? -v : v) + P.wadd[k][s][d];
  }
}

// W values from device memory as one 16-byte load (read-only path)
__device__ __forceinline__ void ldg_vec(float* v, const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldg_vec(double* v, const double* p) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = t.x; v[1] = t.y;
}

// Directions a thread of stream_bc_kernel loads before it stores them
// (a third of D3Q27 per batch)
constexpr int kStreamBatch = 9;

// One device: stream one field into the W nodes x .. x + W - 1 of a row
// through its pull view v (PullSrc, built at x: the pass's pull tables and
// wall rule, one statement of the pull for both kernels).  W = 1: one
// value a direction, read at v.src(d).  W > 1 (16 bytes; NX a multiple
// of W, aligned fields): direction d's W sources are row (z - ez, y - ey)
// at x - ex .. x - ex + W - 1, so the thread loads the aligned W values at
// x of that row and takes the one it lacks across x from its neighbour
// lane (ex = +1: lane - 1's last; ex = -1: lane + 1's first), or loads it
// where the neighbour is no row-mate (lane 0 / 31, or the row's first /
// last W nodes: the wrap); a scalar's wall node reads its own W nodes of
// the opposite direction, and the wall rule applies to each value.
// Loads go out kStreamBatch directions at a time before their stores.
// `live`: the thread's nodes exist (with W > 1, threads past N take part
// in the shuffles and store nothing; with W = 1 they have returned).
template <int Q, int W, typename T>
__device__ __forceinline__ void stream_field(const Params<T>& P,
                                             const Pulled<T>& v,
                                             T* __restrict__ out, int x,
                                             bool live) {
  const int64_t N = v.N;
  if constexpr (W == 1) {
    T r[Q];
#pragma unroll
    for (int d = 0; d < Q; ++d) r[d] = v(P, d);
#pragma unroll
    for (int d = 0; d < Q; ++d) out[d * N + v.idx] = r[d];
  } else {
    const int lane = threadIdx.x & 31;
    const int xm = x == 0 ? P.nx - 1 : x - 1;
    const int xp = x + W == P.nx ? 0 : x + W;
#pragma unroll
    for (int d0 = 0; d0 < Q; d0 += kStreamBatch) {
      T a[kStreamBatch][W];
      int64_t row[kStreamBatch];
#pragma unroll
      for (int i = 0; i < kStreamBatch; ++i) {
        const int d = d0 + i;
        if (d >= Q) break;
        row[i] = d * N + v.zo[dir_e(d, 2) + 1] + v.yo[dir_e(d, 1) + 1];
        ldg_vec(a[i], v.p + (v.wall ? dir_opp(d) * N + v.idx : row[i] + x));
      }
#pragma unroll
      for (int i = 0; i < kStreamBatch; ++i) {
        const int d = d0 + i;
        if (d >= Q) break;
        const int ex = dir_e(d, 0);
        T o[W];
#pragma unroll
        for (int j = 0; j < W; ++j) o[j] = a[i][j];
        if (ex > 0) {
          T e = __shfl_up_sync(0xffffffffu, a[i][W - 1], 1);
          if (lane == 0 || x == 0) e = ld(v.p, row[i] + xm);
          if (!v.wall) {
#pragma unroll
            for (int j = W - 1; j > 0; --j) o[j] = a[i][j - 1];
            o[0] = e;
          }
        } else if (ex < 0) {
          T e = __shfl_down_sync(0xffffffffu, a[i][0], 1);
          if (lane == 31 || xp == 0) e = ld(v.p, row[i] + xp);
          if (!v.wall) {
#pragma unroll
            for (int j = 0; j < W - 1; ++j) o[j] = a[i][j + 1];
            o[W - 1] = e;
          }
        }
#pragma unroll
        for (int j = 0; j < W; ++j) o[j] = v.fix(P, d, o[j]);
        if (live) st_vec(out + d * N + v.idx, o);
      }
    }
  }
}

// One device: one thread per W nodes of a row (x fastest), reading through
// the pass's pull tables (PullSrc) at each field: the source planes, rows
// and columns and the wall rule are worked out once per node and field,
// not per direction.  W = 16 / sizeof(T) where NX is a multiple of it and
// the fields are 16-byte aligned (every load and store a 16-byte vector),
// else 1.
template <typename T, int QF, int QS, int W>
__global__ void __launch_bounds__(kThreads) stream_bc_kernel(
    const Params<T> P, const PullSrc<T> post, T* __restrict__ f1,
    T* __restrict__ h1, T* __restrict__ hn1, T* __restrict__ g1) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = g * W < N;
  if (W == 1 && !live) return;  // no shuffles: nothing to take part in
  const int64_t idx = (live ? g : N / W - 1) * W;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  stream_field<QF, W>(P, post.view(P, 0, z, y, x, N), f1, x, live);
  if (P.ek) {
    stream_field<QS, W>(P, post.view(P, 1, z, y, x, N), h1, x, live);
    if (P.nspec == 2)
      stream_field<QS, W>(P, post.view(P, 2, z, y, x, N), hn1, x, live);
  }
  if (P.thermal)
    stream_field<QS, W>(P, post.view(P, 3, z, y, x, N), g1, x, live);
}

// A shard's pull of post[d, sz, y - ey, sx], sz and sx in range.
// INTERIOR (rows 0 < y < NY-1) and directions with ey = 0 read row y - ey,
// in range.  EDGE (rows 0 and NY-1): row -1 or NY is the neighbour's edge
// row, a slot of PostSrc lo / hi, picked by selects of the pointer and the
// index, as PhiSrc does.  Only two rows of the shard take EDGE.
template <bool EDGE, typename T>
__device__ __forceinline__ T pull(const Params<T>& P, const PostSrc<T>& s,
                                  int d, int sz, int y, int sx, int64_t N) {
  const int ey = dir_e(d, 1), sy = y - ey;
  const int64_t at = d * N + ((int64_t)sz * P.ny + sy) * P.nx + sx;
  if (!EDGE || ey == 0) return ld(s.post, at);
  const bool out = sy < 0 || sy >= P.ny;
  const T* halo = sy < 0 ? s.lo : s.hi;
  return ld(out ? halo : s.post,
            out ? ((int64_t)edge_slot(d) * P.nz + sz) * P.nx + sx : at);
}

// A shard's scalar field at node (z, y, x), periodic in x, with the
// neighbours' edge rows in place of the y wrap, and its wall BC.  k: 0 =
// h, 1 = hn, 2 = g;  ion = the charge BC applies (k < 2).
template <int Q, bool EDGE, typename T>
__device__ __forceinline__ void stream_scalar_halo(
    const Params<T>& P, const PostSrc<T>& src, T* __restrict__ out, int k,
    bool ion, int z, int y, int x, int64_t N, int64_t idx) {
  const bool zg = ion && P.cbc == 2;
  const bool wall = z == 0 || z == P.nz - 1;
  if (wall && !(zg && z == P.nz - 1)) {
    scalar_wall<Q>(P, src.post, out, k, z, N, idx);
    return;
  }
#pragma unroll
  for (int d = 0; d < Q; ++d) {
    const int ex = dir_e(d, 0), ez = dir_e(d, 2);
    int sz = z - ez;
    if (zg && (z == P.nz - 1 || sz == P.nz - 1)) sz = P.nz - 2;
    const int sx = (x - ex + P.nx) % P.nx;
    out[d * N + idx] = pull<EDGE>(P, src, d, sz, y, sx, N);
  }
}

template <bool EDGE, typename T, int QF, int QS>
__device__ __forceinline__ void stream_node_halo(
    const Params<T>& P, const PostSrc<T> (&src)[4], T* __restrict__ f1,
    T* __restrict__ h1, T* __restrict__ hn1, T* __restrict__ g1, int z, int y,
    int x, int64_t N, int64_t idx) {
#pragma unroll
  for (int d = 0; d < QF; ++d) {
    const int ex = dir_e(d, 0), ez = dir_e(d, 2);
    const int sz = (z - ez + P.nz) % P.nz;
    const int sx = (x - ex + P.nx) % P.nx;
    f1[d * N + idx] = pull<EDGE>(P, src[0], d, sz, y, sx, N);
  }
  if (P.ek) {
    stream_scalar_halo<QS, EDGE>(P, src[1], h1, 0, true, z, y, x, N, idx);
    if (P.nspec == 2)
      stream_scalar_halo<QS, EDGE>(P, src[2], hn1, 1, true, z, y, x, N, idx);
  }
  if (P.thermal)
    stream_scalar_halo<QS, EDGE>(P, src[3], g1, 2, false, z, y, x, N, idx);
}

// A shard: one thread per node; rows: the neighbours' post-collision edge
// rows of each field (PostSrc lo / hi).  Its own kernel: the edge-row
// selects, compiled into the one-device kernel, cost that ~8-12 % on the
// H100 (PERF.md).
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(kThreads) stream_bc_halo_kernel(
    const Params<T> P, const T* __restrict__ pf, const T* __restrict__ ph,
    const T* __restrict__ phn, const T* __restrict__ pg,
    const PostRows<T> rows, T* __restrict__ f1, T* __restrict__ h1,
    T* __restrict__ hn1, T* __restrict__ g1) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  const PostSrc<T> src[4] = {{pf, rows.lo[0], rows.hi[0]},
                             {ph, rows.lo[1], rows.hi[1]},
                             {phn, rows.lo[2], rows.hi[2]},
                             {pg, rows.lo[3], rows.hi[3]}};
  if (y > 0 && y < P.ny - 1)
    stream_node_halo<false, T, QF, QS>(P, src, f1, h1, hn1, g1, z, y, x, N,
                                       idx);
  else
    stream_node_halo<true, T, QF, QS>(P, src, f1, h1, hn1, g1, z, y, x, N,
                                      idx);
}

// Copy the Q values a Staged view reads into its slots (cp.async).
template <int Q, typename T>
__device__ __forceinline__ void stage(const Staged<T>& v) {
#pragma unroll
  for (int d = 0; d < Q; ++d)
    cp_async<(int)sizeof(T)>(v.s + d * kThreads, v.at.p + v.at.src(d), true);
}

// One pass of the one-device time loop: the stream of step k-1 and the
// collide of step k at each node.  `post`: step k-1's post-collision set;
// phi: phi_k; out: step k's post-collision set and the plain RHS of step
// k's pre-collision ion moments.  Each thread first copies the values it
// pulls into its shared-memory slots (StagedSrc: cp.async, one element
// each, since a pull is misaligned by ex), so all of them are in flight at
// once without holding a register, and both reads of the collide (the
// moments, then the TRT) come from shared memory.  The z=0 thread pulls
// plane 1 for its wall velocity straight from device memory (PullSrc).
// `post` and the outputs must not alias.
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(kThreads) fused_pass_kernel(
    const Params<T> P, const PullSrc<T> post, const T* __restrict__ phi_,
    T* __restrict__ pf, T* __restrict__ ph, T* __restrict__ phn,
    T* __restrict__ pg, T* __restrict__ rhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  const StagedSrc<T, QF, QS> src{
      post, reinterpret_cast<T*>(smem_raw) + threadIdx.x};
  stage<QF>(src.view(P, 0, z, y, x, N));
  if (P.ek) {
    stage<QS>(src.view(P, 1, z, y, x, N));
    if (P.nspec == 2) stage<QS>(src.view(P, 2, z, y, x, N));
  }
  if (P.thermal) stage<QS>(src.view(P, 3, z, y, x, N));
  cp_async_commit();
  cp_async_wait<0>();  // the thread reads only its own slots
  const PhiSrc<T> phi(phi_, PhiHalo<T>{nullptr, nullptr, nullptr, nullptr},
                      P.ny, P.nx);
  const T r = collide_node<T, QF, QS>(P, src, post, phi, pf, ph, phn, pg, z,
                                      y, x, N, idx);
  if (P.ek && z >= 1 && z <= P.nz - 2) rhs[idx - plane] = r;
}

// Copy the Q values a pull view (Pulled, ShardPulled) reads into the
// slots from s on (cp.async).
template <int Q, typename T, typename V>
__device__ __forceinline__ void stage_view(const V& v, T* s) {
#pragma unroll
  for (int d = 0; d < Q; ++d)
    cp_async<(int)sizeof(T)>(s + d * kThreads, v.at(d), true);
}

// Stage every active field of node (z, y, x), pulled through `src`
// (PullSrc or ShardSrc), into the thread's slots.
template <int QF, int QS, typename T, typename Src>
__device__ __forceinline__ void stage_fields(const Params<T>& P,
                                             const Src& src, int z, int y,
                                             int x, int64_t N, T* slots) {
  auto at = [&](int k) { return slots + slot_base<T, QF, QS>(P, k) * kThreads; };
  stage_view<QF>(src.view(P, 0, z, y, x, N), at(0));
  if (P.ek) {
    stage_view<QS>(src.view(P, 1, z, y, x, N), at(1));
    if (P.nspec == 2) stage_view<QS>(src.view(P, 2, z, y, x, N), at(2));
  }
  if (P.thermal) stage_view<QS>(src.view(P, 3, z, y, x, N), at(3));
}

// The pass on a shard (fused_pass_kernel's .halo / .shard_x forms): the
// same pass, pulling step k-1's post-collision set through ShardSrc, with
// the shard's phi halo.  A node off the shard's edges stages through
// PullSrc's tables, an edge node through ShardSrc's selects (a branch per
// thread: on a pencil each row's first and last warp hold one x-edge
// node, and a whole warp through the selects cost more than the two
// sequences; PERF.md).  The z=0 thread's plane-1 reads go through
// ShardSrc.  `post`, its edge buffers and the outputs must not alias.
// f32: at least 4 blocks an SM, the most the all-D3Q27 pass's 55 KB of
// shared memory a block allows.  The edge selects and ShardSrc's plane-1
// reads took the kernel past 128 registers (3 blocks); capped at 128 it
// spills up to 140 B a thread and still runs faster, the pencil's most
// (PERF.md).  f64 asks for the 2 blocks its shared memory allows.
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
fused_pass_halo_kernel(
    const Params<T> P, const ShardSrc<T> post, const T* __restrict__ phi_,
    const PhiHalo<T> halo, T* __restrict__ pf, T* __restrict__ ph,
    T* __restrict__ phn, T* __restrict__ pg, T* __restrict__ rhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  T* const slots = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  if (post.interior(P, y, x))
    stage_fields<QF, QS>(P, post.inner(), z, y, x, N, slots);
  else
    stage_fields<QF, QS>(P, post, z, y, x, N, slots);
  cp_async_commit();
  cp_async_wait<0>();  // the thread reads only its own slots
  const ShardStagedSrc<T, QF, QS> src{slots};
  const PhiSrc<T> phi(phi_, halo, P.ny, P.nx);
  const T r = collide_node<T, QF, QS>(P, src, post, phi, pf, ph, phn, pg, z,
                                      y, x, N, idx);
  if (P.ek && z >= 1 && z <= P.nz - 2) rhs[idx - plane] = r;
}

inline unsigned blocks_for(const HostInts& I) {
  const int64_t n = (int64_t)I.nx * I.ny * I.nz;
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// phi's halo as the host passes it: {phi, ylo, yhi, xlo, xhi}, null
// where absent
template <typename T>
PhiHalo<T> make_halo(const void* const* p) {
  return PhiHalo<T>{(const T*)p[1], (const T*)p[2], (const T*)p[3],
                    (const T*)p[4]};
}

// the edge rows of {post, lo, hi} x {f, h, hn, g}
template <typename T>
PostRows<T> make_rows(const void* const* p) {
  PostRows<T> r;
  for (int k = 0; k < 4; ++k) {
    r.lo[k] = (const T*)p[3 * k + 1];
    r.hi[k] = (const T*)p[3 * k + 2];
  }
  return r;
}

inline bool aligned16(const void* p) {
  return (uintptr_t)p % 16 == 0;  // null (an inactive field) passes
}

// Slots per node of a staged launch: one per active population.
inline int slots_of(const HostInts& I, int qf, int qs) {
  return qf + (I.ek ? I.nspec * qs : 0) + (I.thermal ? qs : 0);
}

// Dynamic shared memory: one slot per active population and thread.
template <typename T, int QF, int QS>
int launch_collide(const HostInts& I, const HostConsts& C, const void* f,
                   const void* h, const void* hn, const void* g,
                   const void* const* phi, void* pf, void* ph, void* phn,
                   void* pg, void* rhs, cudaStream_t s) {
  const StateSrc<T> pops{{(const T*)f, (const T*)h, (const T*)hn,
                          (const T*)g}};
  const int64_t n = (int64_t)I.nx * I.ny * I.nz;
  const int vec = n % (int64_t)(16 / sizeof(T)) == 0 && aligned16(f)
                  && aligned16(h) && aligned16(hn) && aligned16(g);
  const size_t smem = (size_t)slots_of(I, QF, QS) * kThreads * sizeof(T);
  auto kern = collide_kernel<T, QF, QS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks_for(I), kThreads, smem, s>>>(
      make_params<T>(I, C), pops, (const T*)phi[0], make_halo<T>(phi), vec,
      (T*)pf, (T*)ph, (T*)phn, (T*)pg, (T*)rhs);
  return (int)cudaGetLastError();
}

// One fused pass: post {f, h, hn, g} of step k-1 (null where inactive),
// phi_k; out: step k's post-collision set and plain RHS.  Dynamic shared
// memory: one slot per active population and thread.
template <typename T, int QF, int QS>
int launch_fused_pass(const HostInts& I, const HostConsts& C,
                      const void* const* post, const void* phi, void* pf,
                      void* ph, void* phn, void* pg, void* rhs,
                      cudaStream_t s) {
  const PullSrc<T> src{{(const T*)post[0], (const T*)post[1],
                        (const T*)post[2], (const T*)post[3]}};
  const size_t smem = (size_t)slots_of(I, QF, QS) * kThreads * sizeof(T);
  auto kern = fused_pass_kernel<T, QF, QS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks_for(I), kThreads, smem, s>>>(
      make_params<T>(I, C), src, (const T*)phi, (T*)pf, (T*)ph, (T*)phn,
      (T*)pg, (T*)rhs);
  return (int)cudaGetLastError();
}

// A shard's pass: post {post, lo, hi, xlo, xhi} per field (ShardEdges;
// xlo, xhi null on a slab), phi {phi, ylo, yhi, xlo, xhi}.
template <typename T, int QF, int QS>
int launch_fused_pass_halo(const HostInts& I, const HostConsts& C,
                           const void* const* post, const void* const* phi,
                           void* pf, void* ph, void* phn, void* pg, void* rhs,
                           cudaStream_t s) {
  ShardSrc<T> src;
  for (int k = 0; k < 4; ++k)
    src.e[k] = ShardEdges<T>{(const T*)post[5 * k], (const T*)post[5 * k + 1],
                             (const T*)post[5 * k + 2],
                             (const T*)post[5 * k + 3],
                             (const T*)post[5 * k + 4]};
  const size_t smem = (size_t)slots_of(I, QF, QS) * kThreads * sizeof(T);
  auto kern = fused_pass_halo_kernel<T, QF, QS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks_for(I), kThreads, smem, s>>>(
      make_params<T>(I, C), src, (const T*)phi[0], make_halo<T>(phi),
      (T*)pf, (T*)ph, (T*)phn, (T*)pg, (T*)rhs);
  return (int)cudaGetLastError();
}

// One row-product launch; bm, bn, blocks: the tile and grid the wrapper
// computed (kernels/fused_step.py hartley_rows_grid), -2 unless they are
// this build's.  in, out: m contiguous rows of nx values, not aliased.
template <typename T>
int launch_hartley_rows(int bm, int bn, int64_t blocks, const void* in,
                        const void* H, void* out, int64_t m, int nx,
                        int lift, int rows_per_z, int nz, double volt,
                        double volt2, cudaStream_t s) {
  using R = RowsTile<T>;
  const int64_t want = ((m + R::BM - 1) / R::BM) * ((nx + R::BN - 1) / R::BN);
  if (bm != R::BM || bn != R::BN || blocks != want || blocks < 1
      || blocks > 0x7fffffff || (lift && rows_per_z < 1))
    return -2;
  const auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool vec = nx % R::W == 0 && al(in) && al(H) && al(out);
  auto kern = vec ? hartley_rows_kernel<T, true>
                  : hartley_rows_kernel<T, false>;
  const size_t smem = rows_smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)blocks, kRowsThreads, smem, s>>>(
      (const T*)in, (const T*)H, (T*)out, m, nx, lift, rows_per_z, nz, volt,
      volt2);
  return (int)cudaGetLastError();
}

template <typename T, int QF, int QS>
int launch_stream_bc(const HostInts& I, const HostConsts& C,
                     const void* const* post, void* f1, void* h1, void* hn1,
                     void* g1, cudaStream_t s) {
  const T *pf = (const T*)post[0], *ph = (const T*)post[3],
          *phn = (const T*)post[6], *pg = (const T*)post[9];
  if (post[1] != nullptr) {  // a shard: the f field's rows (all or none)
    stream_bc_halo_kernel<T, QF, QS><<<blocks_for(I), kThreads, 0, s>>>(
        make_params<T>(I, C), pf, ph, phn, pg, make_rows<T>(post), (T*)f1,
        (T*)h1, (T*)hn1, (T*)g1);
    return (int)cudaGetLastError();
  }
  constexpr int W = (int)(16 / sizeof(T));
  const PullSrc<T> src{{pf, ph, phn, pg}};
  const bool vec = I.nx % W == 0 && aligned16(pf) && aligned16(ph)
                   && aligned16(phn) && aligned16(pg) && aligned16(f1)
                   && aligned16(h1) && aligned16(hn1) && aligned16(g1);
  const int64_t n = (int64_t)I.nx * I.ny * I.nz;
  const int64_t threads = vec ? n / W : n;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (vec)
    stream_bc_kernel<T, QF, QS, W><<<blocks, kThreads, 0, s>>>(
        make_params<T>(I, C), src, (T*)f1, (T*)h1, (T*)hn1, (T*)g1);
  else
    stream_bc_kernel<T, QF, QS, 1><<<blocks, kThreads, 0, s>>>(
        make_params<T>(I, C), src, (T*)f1, (T*)h1, (T*)hn1, (T*)g1);
  return (int)cudaGetLastError();
}

// (fluid Q, scalar Q) pairs the configurations can produce
#define EKPNP_LATTICE_PAIRS(X) \
  X(27, 27) X(27, 19) X(27, 7) X(19, 19) X(19, 27) X(19, 7)

template <typename T>
int collide_any(const HostInts& I, const HostConsts& C, const void* f,
                const void* h, const void* hn, const void* g,
                const void* const* phi, void* pf, void* ph, void* phn,
                void* pg, void* rhs, cudaStream_t s) {
#define EKPNP_CASE(QF_, QS_)                                               \
  if (I.qf == QF_ && I.qs == QS_)                                          \
    return launch_collide<T, QF_, QS_>(I, C, f, h, hn, g, phi, pf, ph, phn, \
                                       pg, rhs, s);
  EKPNP_LATTICE_PAIRS(EKPNP_CASE)
#undef EKPNP_CASE
  return -1;
}

template <typename T>
int fused_pass_any(const HostInts& I, const HostConsts& C,
                   const void* const* post, const void* phi, void* pf,
                   void* ph, void* phn, void* pg, void* rhs, cudaStream_t s) {
#define EKPNP_CASE(QF_, QS_)                                               \
  if (I.qf == QF_ && I.qs == QS_)                                          \
    return launch_fused_pass<T, QF_, QS_>(I, C, post, phi, pf, ph, phn,    \
                                          pg, rhs, s);
  EKPNP_LATTICE_PAIRS(EKPNP_CASE)
#undef EKPNP_CASE
  return -1;
}

template <typename T>
int fused_pass_halo_any(const HostInts& I, const HostConsts& C,
                        const void* const* post, const void* const* phi,
                        void* pf, void* ph, void* phn, void* pg, void* rhs,
                        cudaStream_t s) {
#define EKPNP_CASE(QF_, QS_)                                               \
  if (I.qf == QF_ && I.qs == QS_)                                          \
    return launch_fused_pass_halo<T, QF_, QS_>(I, C, post, phi, pf, ph,    \
                                               phn, pg, rhs, s);
  EKPNP_LATTICE_PAIRS(EKPNP_CASE)
#undef EKPNP_CASE
  return -1;
}

template <typename T>
int stream_bc_any(const HostInts& I, const HostConsts& C,
                  const void* const* post, void* f1, void* h1, void* hn1,
                  void* g1, cudaStream_t s) {
#define EKPNP_CASE(QF_, QS_)                                              \
  if (I.qf == QF_ && I.qs == QS_)                                         \
    return launch_stream_bc<T, QF_, QS_>(I, C, post, f1, h1, hn1, g1, s);
  EKPNP_LATTICE_PAIRS(EKPNP_CASE)
#undef EKPNP_CASE
  return -1;
}

}  // namespace

#ifndef EKPNP_REAL
#error "build with -DEKPNP_REAL=float or -DEKPNP_REAL=double"
#endif
using Real = EKPNP_REAL;
constexpr int kIsF64 = sizeof(Real) == sizeof(double);

extern "C" {

// Sizes of the two constant blocks, for the Python side to check its
// packing against.
int ekpnp_abi(int* n_ints, int* n_consts) {
  *n_ints = (int)(sizeof(HostInts) / sizeof(int));
  *n_consts = (int)(sizeof(HostConsts) / sizeof(double));
  return 0;
}

// phi: {phi, ylo, yhi, xlo, xhi}, the halo entries null on one device
// (PhiSrc); a pencil shard passes all four, a slab shard the two rows.
int ekpnp_collide(int is_f64, const int* ints, const double* consts,
                  const void* f, const void* h, const void* hn, const void* g,
                  const void* const* phi, void* pf, void* ph, void* phn,
                  void* pg, void* rhs, void* stream) {
  const HostInts& I = *reinterpret_cast<const HostInts*>(ints);
  const HostConsts& C = *reinterpret_cast<const HostConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_f64 != kIsF64) return -3;
  return collide_any<Real>(I, C, f, h, hn, g, phi, pf, ph, phn, pg, rhs, s);
}

// out[r, :] = in[r, :] @ H (+ lift) over m rows of nx values, H the
// (nx, nx) cas matrix; all three in the tensors' type.  lift != 0: add
// volt + (volt2 - volt) z / (nz - 1), z = r / rows_per_z.  bm, bn, blocks:
// the wrapper's tile and grid, checked against this build's (-2).
int ekpnp_hartley_rows(int is_f64, int bm, int bn, long long blocks,
                       const void* in, const void* H, void* out, long long m,
                       int nx, int lift, int rows_per_z, int nz, double volt,
                       double volt2, void* stream) {
  if (is_f64 != kIsF64) return -3;
  return launch_hartley_rows<Real>(bm, bn, blocks, in, H, out, m, nx, lift,
                                   rows_per_z, nz, volt, volt2,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// post: {post, lo, hi} for f, h, hn, g in turn (PostSrc), lo / hi null
// on one device.
int ekpnp_stream_bc(int is_f64, const int* ints, const double* consts,
                    const void* const* post, void* f1, void* h1, void* hn1,
                    void* g1, void* stream) {
  const HostInts& I = *reinterpret_cast<const HostInts*>(ints);
  const HostConsts& C = *reinterpret_cast<const HostConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_f64 != kIsF64) return -3;
  return stream_bc_any<Real>(I, C, post, f1, h1, hn1, g1, s);
}

// post: {f, h, hn, g} of step k-1 (post-collision), null where inactive;
// phi: phi_k (real); pf..pg, rhs: step k's post-collision set and plain
// RHS.
int ekpnp_fused_pass(int is_f64, const int* ints, const double* consts,
                     const void* const* post, const void* phi, void* pf,
                     void* ph, void* phn, void* pg, void* rhs, void* stream) {
  const HostInts& I = *reinterpret_cast<const HostInts*>(ints);
  const HostConsts& C = *reinterpret_cast<const HostConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_f64 != kIsF64) return -3;
  return fused_pass_any<Real>(I, C, post, phi, pf, ph, phn, pg, rhs, s);
}

// A shard's pass: post {post, lo, hi, xlo, xhi} for f, h, hn, g in turn
// (ShardEdges; all null for an inactive field, xlo / xhi null on a slab);
// phi {phi, ylo, yhi, xlo, xhi} as ekpnp_collide takes it.
int ekpnp_fused_pass_shard(int is_f64, const int* ints, const double* consts,
                           const void* const* post, const void* const* phi,
                           void* pf, void* ph, void* phn, void* pg,
                           void* rhs, void* stream) {
  const HostInts& I = *reinterpret_cast<const HostInts*>(ints);
  const HostConsts& C = *reinterpret_cast<const HostConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_f64 != kIsF64) return -3;
  return fused_pass_halo_any<Real>(I, C, post, phi, pf, ph, phn, pg, rhs, s);
}

}  // extern "C"
