// Fused EK-PNP-thermal LBM step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel of ekpnp/pallas/fused_step.py (build_fused_step,
// its `kernel` closure and the pl.pallas_call) in its five forms.  One
// step of every active population: fluid f, ions h / hn, temperature g.
//
//   collide_kernel    one thread per node (x fastest, so a warp reads
//                     contiguous x for every direction):
//                     moments -> E = -grad(phi) from phi's six neighbours
//                     (periodic in x, y; Ez[0] = Ez[1], Ez[NZ-1] = Ez[NZ-2])
//                     -> Coulomb + external + buoyancy force -> half-force
//                     velocity (z=0: -numer(z=1) / rho(z=0), plane 1
//                     recomputed by the z=0 thread) -> TRT + Guo for the
//                     fluid, TRT with drift u + K E for the ions, TRT (+
//                     Joule source) for the temperature.  It writes the
//                     post-collision populations into a scratch set; at
//                     z=0 and NZ-1 the fluid's reflected PRE-collision
//                     populations instead (moving-wall term at the top).
//                     It also writes the Poisson RHS -kappa (c+ - c-) / eps
//                     for z = 1..NZ-2 from the pre-collision ion moments.
//   stream_bc_kernel  one thread per node: pull post[d, z-ez, y-ey, x-ex]
//                     with periodic wrap in all three axes (the fluid's
//                     z-wrap through the reflected wall planes is the
//                     reference semantics), then the scalar wall BCs from
//                     the post-collision values at the same node: ion
//                     noflux / injection / zerograd-top, temperature
//                     anti-bounce-back.  zerograd-top: every ion read of
//                     post plane NZ-1 takes plane NZ-2, and the top plane
//                     is post[d, NZ-2, y-ey, x-ex] for every d.
//   collide_rows_kernel  the TPU kernel's x-Hartley forms, the same
//                     per-node collide launched one block per (z, tile of
//                     up to 8 y rows):
//                     <FORM 1> hartley_x (fused_step.py:247-259, :984-990):
//                     the RHS rows are collected in shared memory and
//                     written as rows @ H, H[j, k] = cas(2 pi j k / NX);
//                     <FORM 2> phi_hx (fused_step.py:261-268, :680-696):
//                     the phi argument is psi_hx; the block decodes the
//                     psi rows its E stencil reads into a shared-memory
//                     window (psi @ H + lifting) before the collide, and
//                     emits the RHS as FORM 1 does.  Either form is one
//                     launch in place of collide_kernel; stream_bc_kernel
//                     follows unchanged, so a step stays two launches.
//
// The sharded forms (the TPU kernel's halo=True, fused_step.py:240-245,
// :516-520, and shard_x, :294-318; host side ekpnp_torch/parallel/halo.py) run
// on one shard's local (Q, NZ, NYl, NXl) block, with the neighbours' edge
// data in small halo buffers in place of the local wrap:
//   - every collide form reads phi (psi_hx for FORM 2) at y = -1 and y = NYl
//     from two rows (NZ, NXl) of the y-neighbours, and a pencil shard's
//     plain-RHS collide reads x = -1 and x = NXl from two columns (NZ, NYl)
//     of the x-neighbours (PhiSrc; null halos wrap, so collide_kernel and
//     FORM 2 serve one device and shards alike, and FORM 1 is instantiated
//     for each, PhiGlobal on one device);
//   - stream_bc_halo_kernel pulls across a y edge from the neighbour's
//     POST-collision edge row, exchanged after the collide and holding only
//     the directions that pull across that edge: 9 of 27 (D3Q27), 5 of 19,
//     1 of 7, in direction order (PostSrc).  x wraps locally; on a pencil
//     the host code repairs the two wrap columns afterwards (fix_x_columns).
// This is not the TPU's data flow (pre-collision 8-row halo blocks, halo
// rows collided again, DMA-aligned): the two-launch split lets the post
// rows travel instead, while the solve runs.  The one-device kernels keep
// their own code where the shard's reads cost them time (stream, FORM 1).
//
// Bound: device-memory bytes.  The pair moves 1736 B/node per step with
// every field on D3Q27 in f32 (collide: populations read + post written,
// phi read, rhs written; stream: post read + populations written), 776 B
// with D3Q7 scalars -- twice the population traffic of one fused pass.
// Fusing the two launches into one pass is the first item of the perf
// queue (ROADMAP.md).  Constants are folded in double on the host and cast
// to T, as the TPU kernel's cst() does.  The x-Hartley forms add 2 NX
// operations per RHS value and per decoded phi value (30 rows decoded per
// 8-row tile); each block reads H (NX^2 values) from L2 once per product.
// They are built for being right first: no tensor cores, no register
// tiling.  On an H100 SXM (700 W) the row products run at ~6-10 TFLOP/s in
// f32, bound by one broadcast shared-memory read per multiply-add, so the
// phi_hx decode costs more than the solve's x stages it removes (PERF.md).
// A shard moves the same bytes per node plus its halo: two phi rows (and
// columns) for the collide, two post rows of 9 / 5 / 1 directions per
// field for the stream.  The halo reads select a pointer and an index
// (PhiSrc, pull) and the slot comes from a table (edge_slot): a first
// version with a branch per read and a counting loop per slot had nvcc
// still compiling after 14 minutes; this one takes about one per element
// type.
//
// Plain C interface for ctypes; every entry point returns the
// cudaGetLastError() of its launch (or -1 for an unsupported lattice pair,
// -2 for a row-block height whose shared memory does not fit, -3 for a
// call in the other element type).  One library per element type: built
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
  double volt, volt2;           // plate potentials (phi_hx lifting profile)
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
  double volt, volt2;
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
  P.volt = C.volt; P.volt2 = C.volt2;
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

template <int Q, typename T>
__device__ __forceinline__ T moment0(const T* __restrict__ a, int64_t N,
                                     int64_t idx) {
  T m = T(0);
#pragma unroll
  for (int d = 0; d < Q; ++d) m += ld(a, d * N + idx);
  return m;
}

// Pre-collision macroscopic state of one node.
template <typename T>
struct NodeMacro {
  T rho, nx, ny, nz;     // density and velocity numerator (mom/CFL + dt F/2)
  T fx, fy, fz;          // body force
  T c, cn, tm;           // ion concentrations and temperature
  T Ex, Ey, Ez;          // E = -grad(phi)
};

// phi (or psi_hx) read from device memory (plain and hartley_x forms, and
// FORM 2's staging).  The E stencil reads z +- 1 in range (at) and x +- 1,
// y +- 1 across the block's edge: there a shard reads its halo -- the rows
// ylo / yhi (NZ, NX) at y = -1 / NY, the columns xlo / xhi (NZ, NY) at
// x = -1 / NX -- and one device, whose halo pointers are null, wraps, as
// the plain-RHS collide always did.  Each edge read is one compare and
// selects of the pointer and the index, so the collide stays straight-line
// code (branches per read made nvcc's build of this file run away).
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
  // row yy in -1..NY (FORM 2's staging)
  __device__ __forceinline__ T row(int z, int yy, int x) const {
    return yy < 0 ? y_off<-1>(z, 0, x)
                  : (yy >= ny ? y_off<1>(z, ny - 1, x) : at(z, yy, x));
  }
};

// phi read from device memory on one device, periodic in x and y: the
// hartley_x form's source there (the shard's PhiSrc, compiled into the
// row-block kernel, cost it ~6 % on the H100, PERF.md).  Takes the
// halo argument only to be built as PhiSrc is; it has none.
template <typename T>
struct PhiGlobal {
  const T* __restrict__ phi;
  int64_t plane;
  int ny, nx;
  __device__ __forceinline__ PhiGlobal(const T* p, const PhiHalo<T>&, int ny_,
                                       int nx_)
      : phi(p), plane((int64_t)ny_ * nx_), ny(ny_), nx(nx_) {}
  __device__ __forceinline__ T at(int z, int y, int x) const {
    return ld(phi, z * plane + (int64_t)y * nx + x);
  }
  template <int DY>
  __device__ __forceinline__ T y_off(int z, int y, int x) const {
    return at(z, DY < 0 ? (y == 0 ? ny - 1 : y - 1)
                        : (y == ny - 1 ? 0 : y + 1), x);
  }
  template <int DX>
  __device__ __forceinline__ T x_off(int z, int y, int x) const {
    return at(z, y, DX < 0 ? (x == 0 ? nx - 1 : x - 1)
                           : (x == nx - 1 ? 0 : x + 1));
  }
};

// phi read from the block's decoded shared-memory window (phi_hx form):
// planes w0..w0+2, window row r holding phi row y0 - 1 + r; x wraps (x is
// whole wherever this form runs).
template <typename T>
struct PhiWindow {
  const T* win;
  int w0, y0, nx, wrows;
  __device__ __forceinline__ T at(int z, int y, int x) const {
    return win[((z - w0) * wrows + (y - y0 + 1)) * nx + x];
  }
  template <int DY>
  __device__ __forceinline__ T y_off(int z, int y, int x) const {
    return at(z, y + DY, x);
  }
  template <int DX>
  __device__ __forceinline__ T x_off(int z, int y, int x) const {
    return at(z, y, DX < 0 ? (x == 0 ? nx - 1 : x - 1)
                           : (x == nx - 1 ? 0 : x + 1));
  }
};

template <typename T, int QF, int QS, typename Phi>
__device__ __forceinline__ void node_macro(
    const Params<T>& P, const T* __restrict__ f, const T* __restrict__ h,
    const T* __restrict__ hn, const T* __restrict__ g,
    const Phi& phi, int z, int y, int x, int64_t N,
    NodeMacro<T>& o) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t idx = z * plane + (int64_t)y * P.nx + x;
  T rho = T(0), mx = T(0), my = T(0), mz = T(0);
#pragma unroll
  for (int d = 0; d < QF; ++d) {
    const T v = ld(f, d * N + idx);
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
    o.c = moment0<QS>(h, N, idx);
    if (P.nspec == 2) o.cn = moment0<QS>(hn, N, idx);
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
    o.tm = moment0<QS>(g, N, idx);
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
template <int Q, bool FORCE, bool ISO, typename T>
__device__ __forceinline__ void trt_field(
    const T* __restrict__ in, T* __restrict__ out, int64_t N, int64_t idx,
    const T* w, T m, T vx, T vy, T vz, T tscale, T ics2, T op, T om,
    const Params<T>& P, T fx, T fy, T fz, T S) {
  const T omusq = T(1) - (T(0.5) * ((vx * vx + vy * vy) + vz * vz)) * ics2;

  const T p0 = ld(in, idx);
  T o0 = p0 - op * (p0 - feq_dir(0, w[0] * m, omusq, vx, vy, vz, tscale));
  if (FORCE) o0 = o0 + P.dt * (P.f_splus * guo_dir(0, P, vx, vy, vz, fx, fy, fz));
  if (ISO) o0 = o0 + P.gjw[0] * S;
  out[idx] = o0;
#pragma unroll
  for (int i = 1; i < Q; i += 2) {
    const int j = i + 1;
    const T pi = ld(in, i * N + idx), pj = ld(in, j * N + idx);
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
// value -kappa (c+ - c-) / eps (0 without EK).
template <typename T, int QF, int QS, typename Phi>
__device__ __forceinline__ T collide_node(
    const Params<T>& P, const T* __restrict__ f, const T* __restrict__ h,
    const T* __restrict__ hn, const T* __restrict__ g, const Phi& phi,
    T* __restrict__ pf, T* __restrict__ ph, T* __restrict__ phn,
    T* __restrict__ pg, int z, int y, int x, int64_t N, int64_t idx) {
  NodeMacro<T> m;
  node_macro<T, QF, QS>(P, f, h, hn, g, phi, z, y, x, N, m);
  T ux, uy, uz;
  if (z == 0) {
    // wall velocity extrapolated from plane 1's numerator, local wall rho
    NodeMacro<T> m1;
    node_macro<T, QF, QS>(P, f, h, hn, g, phi, 1, y, x, N, m1);
    ux = -m1.nx / m.rho;
    uy = -m1.ny / m.rho;
    uz = -m1.nz / m.rho;
  } else {
    ux = m.nx / m.rho;
    uy = m.ny / m.rho;
    uz = m.nz / m.rho;
  }

  if (z == 0 || z == P.nz - 1) {
    // fluid bounce-back of the pre-collision populations (+ moving wall)
    const bool top = z == P.nz - 1;
#pragma unroll
    for (int d = 0; d < QF; ++d) {
      T v = ld(f, dir_opp(d) * N + idx);
      if (top) v = v + P.mw[d];
      pf[d * N + idx] = v;
    }
  } else {
    trt_field<QF, true, false>(f, pf, N, idx, P.wf, m.rho, ux, uy, uz,
                               P.f_tscale, P.f_ics2, P.f_op, P.f_om, P,
                               m.fx, m.fy, m.fz, T(0));
  }

  T rhs_v = T(0);
  if (P.ek) {
    trt_field<QS, false, false>(h, ph, N, idx, P.ws, m.c, ux + P.K * m.Ex,
                                uy + P.K * m.Ey, uz + P.K * m.Ez, P.s_tscale,
                                P.s_ics2, P.h_op, P.h_om, P, T(0), T(0),
                                T(0), T(0));
    if (P.nspec == 2)
      trt_field<QS, false, false>(hn, phn, N, idx, P.ws, m.cn,
                                  ux + P.Kn * m.Ex, uy + P.Kn * m.Ey,
                                  uz + P.Kn * m.Ez, P.s_tscale, P.s_ics2,
                                  P.hn_op, P.hn_om, P, T(0), T(0), T(0), T(0));
    rhs_v = -(P.rhs_scale * (m.c - m.cn));
  }
  if (P.thermal) {
    if (P.joule_on) {
      const T S = (P.joule * (m.c + m.cn))
                  * (m.Ex * m.Ex + m.Ey * m.Ey + m.Ez * m.Ez);
      trt_field<QS, false, true>(g, pg, N, idx, P.ws, m.tm, ux, uy, uz,
                                 P.s_tscale, P.s_ics2, P.g_op, P.g_om, P,
                                 T(0), T(0), T(0), S);
    } else {
      trt_field<QS, false, false>(g, pg, N, idx, P.ws, m.tm, ux, uy, uz,
                                  P.s_tscale, P.s_ics2, P.g_op, P.g_om, P,
                                  T(0), T(0), T(0), T(0));
    }
  }
  return rhs_v;
}

// Plain-RHS form: one thread per node, flat 128-thread blocks.  `phi`
// carries the halo rows and columns of a shard (null on one device).
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(128) collide_kernel(
    const Params<T> P, const T* __restrict__ f, const T* __restrict__ h,
    const T* __restrict__ hn, const T* __restrict__ g,
    const T* __restrict__ phi_, const PhiHalo<T> halo, T* __restrict__ pf,
    T* __restrict__ ph, T* __restrict__ phn, T* __restrict__ pg,
    T* __restrict__ rhs) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);
  const PhiSrc<T> phi(phi_, halo, P.ny, P.nx);
  const T r = collide_node<T, QF, QS>(P, f, h, hn, g, phi, pf, ph, phn, pg,
                                      z, y, x, N, idx);
  if (P.ek && z >= 1 && z <= P.nz - 2) rhs[idx - plane] = r;
}

// ---------------------------------------------------------------------------
// The x-Hartley forms: one block per (z, tile of up to kRowsMax y rows),
// threads striding over the tile's nodes, x fastest, so the block holds
// whole x rows and can take their product with the (NX, NX) cas matrix H.
// ---------------------------------------------------------------------------

constexpr int kRowsMax = 8;                        // y rows per block
constexpr int kWinRowsMax = 3 * (kRowsMax + 2);    // decoded phi rows
constexpr size_t kSmemMax = 232448;                // 227 KB per block

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// store(r, k, sum_x src[r][x] H[x][k]) for rows r < nrows of the
// shared-memory block src (row stride nx); thread t takes columns
// k = t, t + blockDim, ...  H is symmetric, so H[x][k] is read coalesced
// over k, once per block for all rows; src[r][x] is one shared-memory
// read broadcast to the warp per multiply-add.  Explicit fused
// multiply-adds: the sum is not the plain version's einsum order in any
// case.
template <int RMAX, typename T, typename Store>
__device__ __forceinline__ void rows_times_h(const T* src, int nrows,
                                             const T* __restrict__ H, int nx,
                                             Store store) {
  for (int k = threadIdx.x; k < nx; k += blockDim.x) {
    T acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = T(0);
    for (int x = 0; x < nx; ++x) {
      const T hk = ld(H, (int64_t)x * nx + k);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < nrows) acc[r] = fmadd(src[r * nx + x], hk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < nrows) store(r, k, acc[r]);
  }
}

// Shared memory of a row-block launch, in elements of T: the RHS rows
// (hartley_x); for phi_hx the psi staging rows (reused for the RHS rows)
// and the decoded phi window.
inline size_t rows_smem_elems(int form, int rb, int nx) {
  return (size_t)(form == 2 ? 2 * 3 * (rb + 2) : rb) * nx;
}

// FORM 1 (hartley_x): phi from device memory; the RHS rows of the tile are
// collected in shared memory and written as rows @ H.
// FORM 2 (phi_hx, implies hartley_x): `phi` is psi_hx.  The block first
// stages the psi rows its E stencil reads -- planes w0..w0+2 (z-1..z+1,
// clamped to 0..2 at z = 0, where plane 1's macro is recomputed, and to
// NZ-3..NZ-1 at the top), rows y0-1..y0+rb (at most NY: the rows past the
// tile's last one + 1 are never read) -- and decodes them as
// psi @ H + lift(z), lift(z) = V + (V2 - V) z / (NZ-1) in double, as the
// plain version's lifting profile.  Every node then reads phi from there.
// On a slab shard the rows y0-1 = -1 and NY come from psi's halo rows:
// the decode is per row, so psi rows travel and are decoded here.
// Src: FORM 1's phi source (PhiGlobal on one device, PhiSrc on a shard);
// FORM 2 stages psi through PhiSrc either way.
template <typename T, int QF, int QS, int FORM, typename Src>
__global__ void __launch_bounds__(128) collide_rows_kernel(
    const Params<T> P, const T* __restrict__ f, const T* __restrict__ h,
    const T* __restrict__ hn, const T* __restrict__ g,
    const T* __restrict__ phi_, const PhiHalo<T> halo,
    const T* __restrict__ H, T* __restrict__ pf, T* __restrict__ ph,
    T* __restrict__ phn, T* __restrict__ pg, T* __restrict__ rhs, int rb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int nx = P.nx, ny = P.ny, nz = P.nz;
  const int64_t plane = (int64_t)ny * nx;
  const int64_t N = plane * nz;
  const int z = blockIdx.y;
  const int y0 = blockIdx.x * rb;
  const int nrow = min(rb, ny - y0);
  const int wrows = rb + 2;
  const int w0 = min(max(z - 1, 0), nz - 3);
  T* const win = sm;
  T* const stage = FORM == 2 ? sm + 3 * wrows * nx : sm;

  if constexpr (FORM == 2) {
    const PhiSrc<T> phi(phi_, halo, ny, nx);
    for (int i = threadIdx.x; i < 3 * wrows * nx; i += blockDim.x) {
      const int x = i % nx, pr = i / nx;
      const int p = pr / wrows;
      stage[i] = phi.row(w0 + p, min(y0 - 1 + pr % wrows, ny), x);
    }
    __syncthreads();
    rows_times_h<kWinRowsMax>(stage, 3 * wrows, H, nx,
                              [&](int r, int k, T v) {
      const int zz = w0 + r / wrows;
      const double lift = P.volt + ((P.volt2 - P.volt) * (double)zz)
                                   / (double)(nz - 1);
      win[r * nx + k] = v + T(lift);
    });
    __syncthreads();
  }

  for (int i = threadIdx.x; i < nrow * nx; i += blockDim.x) {
    const int r = i / nx, x = i % nx, y = y0 + r;
    const int64_t idx = z * plane + (int64_t)y * nx + x;
    T v;
    if constexpr (FORM == 2) {
      const PhiWindow<T> src{win, w0, y0, nx, wrows};
      v = collide_node<T, QF, QS>(P, f, h, hn, g, src, pf, ph, phn, pg, z, y,
                                  x, N, idx);
    } else {
      const Src src(phi_, halo, ny, nx);
      v = collide_node<T, QF, QS>(P, f, h, hn, g, src, pf, ph, phn, pg, z, y,
                                  x, N, idx);
    }
    stage[i] = v;
  }
  __syncthreads();
  if (z >= 1 && z <= nz - 2) {
    T* const out = rhs + (int64_t)(z - 1) * plane + (int64_t)y0 * nx;
    rows_times_h<kRowsMax>(stage, nrow, H, nx,
                           [&](int r, int k, T v) { out[r * nx + k] = v; });
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

// One device: stream one scalar field into node (z, y, x), periodic in
// every axis, and apply its wall BC.  k: 0 = h, 1 = hn, 2 = g;  ion = the
// charge BC applies (k < 2).
template <int Q, typename T>
__device__ __forceinline__ void stream_scalar(
    const Params<T>& P, const T* __restrict__ post, T* __restrict__ out,
    int k, bool ion, int z, int y, int x, int64_t N, int64_t idx) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const bool zg = ion && P.cbc == 2;
  const bool wall = z == 0 || z == P.nz - 1;
  if (wall && !(zg && z == P.nz - 1)) {
    scalar_wall<Q>(P, post, out, k, z, N, idx);
    return;
  }
#pragma unroll
  for (int d = 0; d < Q; ++d) {
    const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
    int sz = z - ez;
    if (zg && (z == P.nz - 1 || sz == P.nz - 1)) sz = P.nz - 2;
    const int sy = (y - ey + P.ny) % P.ny, sx = (x - ex + P.nx) % P.nx;
    out[d * N + idx] = ld(post, d * N + sz * plane + (int64_t)sy * P.nx + sx);
  }
}

// One device: one thread per node.
template <typename T, int QF, int QS>
__global__ void __launch_bounds__(128) stream_bc_kernel(
    const Params<T> P, const T* __restrict__ pf, const T* __restrict__ ph,
    const T* __restrict__ phn, const T* __restrict__ pg, T* __restrict__ f1,
    T* __restrict__ h1, T* __restrict__ hn1, T* __restrict__ g1) {
  const int64_t plane = (int64_t)P.ny * P.nx;
  const int64_t N = plane * P.nz;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int x = (int)(idx % P.nx);
  const int y = (int)((idx / P.nx) % P.ny);
  const int z = (int)(idx / plane);

#pragma unroll
  for (int d = 0; d < QF; ++d) {
    const int ex = dir_e(d, 0), ey = dir_e(d, 1), ez = dir_e(d, 2);
    const int sz = (z - ez + P.nz) % P.nz;
    const int sy = (y - ey + P.ny) % P.ny, sx = (x - ex + P.nx) % P.nx;
    f1[d * N + idx] = ld(pf, d * N + sz * plane + (int64_t)sy * P.nx + sx);
  }
  if (P.ek) {
    stream_scalar<QS>(P, ph, h1, 0, true, z, y, x, N, idx);
    if (P.nspec == 2) stream_scalar<QS>(P, phn, hn1, 1, true, z, y, x, N, idx);
  }
  if (P.thermal) stream_scalar<QS>(P, pg, g1, 2, false, z, y, x, N, idx);
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

// A shard's scalar field at node (z, y, x): stream_scalar with the
// neighbours' edge rows in place of the y wrap.
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
__global__ void __launch_bounds__(128) stream_bc_halo_kernel(
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

constexpr int kThreads = 128;

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

template <typename T, int QF, int QS>
int launch_collide(const HostInts& I, const HostConsts& C, const void* f,
                   const void* h, const void* hn, const void* g,
                   const void* const* phi, void* pf, void* ph, void* phn,
                   void* pg, void* rhs, cudaStream_t s) {
  collide_kernel<T, QF, QS><<<blocks_for(I), kThreads, 0, s>>>(
      make_params<T>(I, C), (const T*)f, (const T*)h, (const T*)hn,
      (const T*)g, (const T*)phi[0], make_halo<T>(phi), (T*)pf, (T*)ph,
      (T*)phn, (T*)pg, (T*)rhs);
  return (int)cudaGetLastError();
}

// Row-block launch of the x-Hartley forms, rb rows per block (the wrapper
// picks rb, kernels/fused_step.py row_block_rows); -2 where rb is out of
// range or its shared memory does not fit.
template <typename T, int QF, int QS, int FORM, typename Src>
int launch_collide_rows(int rb, const HostInts& I, const HostConsts& C,
                        const void* f, const void* h, const void* hn,
                        const void* g, const void* const* phi, const void* H,
                        void* pf, void* ph, void* phn, void* pg, void* rhs,
                        cudaStream_t s) {
  const size_t smem = rows_smem_elems(FORM, rb, I.nx) * sizeof(T);
  if (rb < 1 || rb > kRowsMax || smem > kSmemMax) return -2;
  auto kern = collide_rows_kernel<T, QF, QS, FORM, Src>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((I.ny + rb - 1) / rb), (unsigned)I.nz);
  kern<<<grid, kThreads, smem, s>>>(
      make_params<T>(I, C), (const T*)f, (const T*)h, (const T*)hn,
      (const T*)g, (const T*)phi[0], make_halo<T>(phi), (const T*)H, (T*)pf,
      (T*)ph, (T*)phn, (T*)pg, (T*)rhs, rb);
  return (int)cudaGetLastError();
}

template <typename T, int QF, int QS>
int launch_stream_bc(const HostInts& I, const HostConsts& C,
                     const void* const* post, void* f1, void* h1, void* hn1,
                     void* g1, cudaStream_t s) {
  const T *pf = (const T*)post[0], *ph = (const T*)post[3],
          *phn = (const T*)post[6], *pg = (const T*)post[9];
  if (post[1] != nullptr)  // a shard: the f field's rows (all or none)
    stream_bc_halo_kernel<T, QF, QS><<<blocks_for(I), kThreads, 0, s>>>(
        make_params<T>(I, C), pf, ph, phn, pg, make_rows<T>(post), (T*)f1,
        (T*)h1, (T*)hn1, (T*)g1);
  else
    stream_bc_kernel<T, QF, QS><<<blocks_for(I), kThreads, 0, s>>>(
        make_params<T>(I, C), pf, ph, phn, pg, (T*)f1, (T*)h1, (T*)hn1,
        (T*)g1);
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
int collide_rows_any(int form, int rb, const HostInts& I, const HostConsts& C,
                     const void* f, const void* h, const void* hn,
                     const void* g, const void* const* phi, const void* H,
                     void* pf, void* ph, void* phn, void* pg, void* rhs,
                     cudaStream_t s) {
  // a shard passes phi's halo rows
  const bool halo = phi[1] != nullptr;
#define EKPNP_CASE(QF_, QS_)                                                 \
  if (I.qf == QF_ && I.qs == QS_) {                                          \
    if (form == 2)                                                           \
      return launch_collide_rows<T, QF_, QS_, 2, PhiSrc<T>>(                 \
          rb, I, C, f, h, hn, g, phi, H, pf, ph, phn, pg, rhs, s);           \
    return halo ? launch_collide_rows<T, QF_, QS_, 1, PhiSrc<T>>(            \
                      rb, I, C, f, h, hn, g, phi, H, pf, ph, phn, pg, rhs, s) \
                : launch_collide_rows<T, QF_, QS_, 1, PhiGlobal<T>>(         \
                      rb, I, C, f, h, hn, g, phi, H, pf, ph, phn, pg, rhs,   \
                      s);                                                    \
  }
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

// form 1: hartley_x, form 2: phi_hx (`phi` is psi_hx); rb y rows per
// block.  H: the (NX, NX) cas matrix in the tensors' type.  phi as for
// ekpnp_collide, with no x halo (x is whole).  Returns -2 if rb is out of
// range or its shared memory does not fit.
int ekpnp_collide_rows(int is_f64, int form, int rb, const int* ints,
                       const double* consts, const void* f, const void* h,
                       const void* hn, const void* g, const void* const* phi,
                       const void* H, void* pf, void* ph, void* phn, void* pg,
                       void* rhs, void* stream) {
  const HostInts& I = *reinterpret_cast<const HostInts*>(ints);
  const HostConsts& C = *reinterpret_cast<const HostConsts*>(consts);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (form != 1 && form != 2) return -1;
  if (is_f64 != kIsF64) return -3;
  return collide_rows_any<Real>(form, rb, I, C, f, h, hn, g, phi, H, pf, ph,
                                phn, pg, rhs, s);
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

}  // extern "C"
