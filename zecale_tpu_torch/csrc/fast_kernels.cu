// Every kernel of the port, on the fast field core (field_fast.cuh): TPI
// threads a point or a segment (K1, K2, K4, K6) or one warp a point (K3,
// K5):
//
//   K1 zt_bucket_reduce:  out[s] = the sum of the points named by
//                         ent[seg[s]..seg[s + 1]), affine rows by the mixed
//                         RCB add or projective rows by the full one
//                         (curve.cuh reduce_segment), canonical outputs;
//   K2 zt_proj_add:       out[i] = p[i] + q[i], the complete RCB add
//                         (curve.cuh proj_add), canonical outputs;
//   K3 zt_proj_dbl_chain: out[i] = 2^k p[i], k complete RCB doublings
//                         (curve.cuh proj_dbl_side);
//   K4 zt_jac_add:        out[i] = p[i] + q[i], the unified Jacobian add
//                         (curve.cuh jac_add), canonical outputs, the
//                         reference's triple in every case;
//   K5 zt_jac_dbl_chain:  out[i] = 2^k p[i], k doublings dbl-2009-l
//                         (curve.cuh jac_dbl_side);
//   K6 zt_aff_add:        out[i] = a[i] + b[i] for affine (x, y) rows with
//                         one infinity flag (a byte) per point, a Jacobian
//                         result (curve.cuh aff_add), the reference's
//                         triple in every case.
//
// Replace zecale_tpu/ec/msm4.py:bucket_reduce_pallas (543-652) and
// zecale_tpu/ec/ec_pallas.py:_KernelFamily.proj_add (573-594),
// proj_dbl_chain (596-619), jac_add (473-493), jac_dbl (495) /
// jac_dbl_chain (514-541) and aff_add (543-569).  The TPU kernels
// transposed a block of points into (ew, bt) limb planes so that the VPU's
// lanes ran across points, and the bucket reduce carried its sums across a
// sequential grid axis of slot strips over a padded int8 bucket matrix.
// Here a group of TPI neighbouring threads owns one point or one segment:
// each holds a slice of every coordinate and the group law runs in
// registers; a segment's group walks its sorted entries and reads the
// points straight from the query array, with no bucket matrix and no
// padding.
//
// Bound: operations.  An add is 12 Montgomery products plus two b3
// multiplies (K2; 11 with Z2 = 1 in K1's mixed add) or 16 products (K4,
// 11M + 5S; K6 4M + 2S); over Fq2 each product is three base products
// (and the twist b3 a full Fq2 product).  A product is
// 2 N^2 32x32-bit multiply-adds, each a lo and a hi instruction, against
// 9 x 4N bytes of traffic per point: far below the card's memory rate.
//
// What held the per-thread kernels of field.cuh (one thread a point, ~21-23%
// of the operations bound at Fq 24; ~70 us a 24-limb doubling) and what
// this design does about it:
//   1. 64-bit emulation: fp_mul computed (uint64_t)a*b + t + c, ~5
//      instructions a 32x32 product.  Here every product is a mad.lo /
//      madc.hi pair on a carry chain, even and odd limbs on two chains.
//   2. Runtime-indexed arrays: the rolled CIOS loop read b[i] at a runtime
//      index and fp_geq looped with an early exit, which put operands in
//      local memory.  Here every loop is unrolled, the moduli are
//      compile-time immediates and the compare is the borrow of t - p.
//   3. Occupancy: one thread of ~255 registers a point, 8 warps an SM.
//      With TPI lanes a thread holds N / TPI words of each element, so the
//      registers a thread needs fall with TPI and more warps fit.  Lanes
//      cost instructions (shuffles, votes, carries between lanes); to keep
//      their shuffles and votes plain, not convergence regions, they name
//      the whole warp, which therefore runs one path: K2 has no branch on
//      the data, and K4 over lanes computes the generic sum (and the
//      doubling where any point of the warp needs it) and selects
//      (curve.cuh jac_add_warp), and no thread leaves early.
//   4. Latency of small launches (the Horner adds, msm8's scan 2, the
//      setup's 16,384-lane chunks): a lone thread ran a 24-limb product as
//      one dependent chain.  TPI lanes split each CIOS step N / TPI ways.
//   5. Uncoalesced rows: one thread walked its 3N-word row.  Here lane l
//      reads its slice of each coordinate with 16- or 8-byte loads, so a
//      group reads contiguous bytes.
// The wrappers (ec/proj_curve.py, ec/jac_curve.py) pick TPI by kernel,
// form and batch size from a table measured on the card
// (utils/build.py:ADD_TPI).
//
// K1 and K6 follow the same design.  K1's group of TPI lanes owns a
// segment of at most msm.SEG entries and loops over it, one mixed or full
// add an entry.  Its shuffles and votes name the whole warp, so the warp
// runs one trip count, its longest segment (a warp-wide max), and a group
// past its own end adds a valid operand and keeps its sum by a select
// (curve.cuh reduce_segment).  The MSM's bucket levels (tens of thousands
// of segments) are throughput-bound like K2's big rounds; its subset-sum
// levels (hundreds to a few thousand segments of dependent adds) are
// latency-bound, where more lanes a segment shorten each add.  K6 over
// lanes computes the generic sum, and the doubling where any point of the
// warp has P = Q, and selects (curve.cuh aff_add_warp); at one thread a
// point it keeps the branches of aff_add, as K4 does.  The wrappers
// (ec/msm.py, ec/jac_curve.py) pick TPI by kernel, form and the launch's
// entries or batch from a table measured on the card
// (utils/build.py:SUM_TPI).
//
// The doubling chains (K3, K5) are the MSMs' Horner folds: k doublings of
// one point, each a chain of dependent products (K3: 8 and a b3 multiply
// of small constant, K5: 7; three base products each over Fq2).  Bound:
// operations, a few hundred thousand multiply-adds a launch, far below
// a microsecond of the card; on one point the time is the chain's
// latency.  So one warp owns a point and runs its products side by side:
// the 32 / TPI groups of the warp each hold the point and compute one
// independent product of a step (curve.cuh proj_dbl_side, jac_dbl_side;
// field_fast.cuh mul_side_by_side), then pass the results round by
// whole-warp shuffles.  K3's 8 products become 2 steps plus b3 and K5's 7
// become 3 where the warp has four groups or more (TPI <= 8); over Fq2
// the three base products of each Fq2 product are the units spread over
// the groups.  The point stays in registers across the k doublings.  The
// wrappers pick TPI by kernel and form from a table measured on the card
// (utils/build.py:DBL_TPI).  A group of TPI lanes a point running the
// products one after another (proj_dbl, jac_dbl over the fast core) was
// slower at every batch the paths send (PERF.md section 6).
// No thread leaves early: the tail repeats the last point and does not
// store it, and only group 0 of a warp stores.
//
// One source, built per (form, TPI): -DZT_LIMBS=12 (BLS12-377 Fq) or 24
// (BW6-761 Fq) or -DZT_FQ2=1 (BLS12-377 Fq2), and -DZT_TPI=1|2|4|8.  The
// launchers take no field constants and return the CUDA error code of the
// launch (0 on success).
#include <cuda_runtime.h>
#include <string.h>

#include "field_fast.cuh"
#include "curve.cuh"

#if !defined(ZT_TPI) || !(defined(ZT_LIMBS) || defined(ZT_FQ2))
#error "build with -DZT_TPI=1|2|4|8 and -DZT_LIMBS=12|24 or -DZT_FQ2=1"
#endif

// Uniform: the shuffles and votes of the field ops name the whole warp,
// which then runs one path: K2, K3 and K5 have no branch on the data, K1
// loops to the warp's longest segment, and K4 and K6 over lanes take
// jac_add_warp / aff_add_warp (curve.cuh), which select their case at the
// end.  At one thread a point K4 and K6 keep the branches of jac_add /
// aff_add.
#if defined(ZT_FQ2)
template <bool Uniform>
using AddField = Fq2F<ZT_TPI, Uniform>;
#elif ZT_LIMBS == 12
template <bool Uniform>
using AddField = FqF<Bls377Fq, ZT_TPI, Uniform>;
#elif ZT_LIMBS == 24
template <bool Uniform>
using AddField = FqF<Bw6Fq, ZT_TPI, Uniform>;
#else
#error "ZT_LIMBS must be 12 or 24"
#endif

namespace {

constexpr int kThreads = 128;

// the point of this thread's group (past the end of the batch for the
// tail of the last block)
template <class Fld>
__device__ __forceinline__ long long group_of() {
  return ((long long)blockIdx.x * blockDim.x + threadIdx.x) / Fld::kTpi;
}

// no thread of a Uniform field leaves early: the tail repeats the last
// point and does not store it, so every shuffle finds the whole warp
template <class Fld>
__global__ void __launch_bounds__(kThreads)
    proj_add_kernel(const uint32_t* __restrict__ p,
                    const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                    int n, typename Fld::B3Arg b3) {
  const long long g = group_of<Fld>();
  const typename Fld::Params F = Fld::params();
  const typename Fld::B3 B = Fld::b3_lane(b3);
  const size_t row = (size_t)(g < n ? g : n - 1) * 3 * Fld::ROW;
  Proj<Fld> a, b;
  proj_load<Fld>(a, p + row);
  proj_load<Fld>(b, q + row);
  proj_add<Fld>(a, a, b, B, F);
  if (g < n) proj_store<Fld>(out + row, a);
}

template <class Fld>
__global__ void __launch_bounds__(kThreads)
    jac_add_kernel(const uint32_t* __restrict__ p,
                   const uint32_t* __restrict__ q, uint32_t* __restrict__ out,
                   int n) {
  const long long g = group_of<Fld>();
  if (!Fld::kUniform && g >= n) return;
  const typename Fld::Params F = Fld::params();
  const size_t row = (size_t)(g < n ? g : n - 1) * 3 * Fld::ROW;
  Jac<Fld> a, b;
  proj_load<Fld>(a, p + row);
  proj_load<Fld>(b, q + row);
  jac_add<Fld>(a, a, b, F);
  if (g < n) proj_store<Fld>(out + row, a);
}

// K1: a segment a group, the warp to its longest segment
template <class Fld, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    bucket_reduce_kernel(const uint32_t* __restrict__ pts,
                         const int32_t* __restrict__ ent,
                         const int32_t* __restrict__ seg, int nseg,
                         uint32_t* __restrict__ out,
                         typename Fld::B3Arg b3) {
  const typename Fld::Params F = Fld::params();
  const typename Fld::B3 B = Fld::b3_lane(b3);
  reduce_segment<Fld, AFFINE>(out, pts, ent, seg, nseg, group_of<Fld>(), B,
                              F);
}

template <class Fld>
__global__ void __launch_bounds__(kThreads)
    aff_add_kernel(const uint32_t* __restrict__ a,
                   const uint8_t* __restrict__ ainf,
                   const uint32_t* __restrict__ b,
                   const uint8_t* __restrict__ binf,
                   uint32_t* __restrict__ out, int n) {
  constexpr int W = Fld::W;
  const long long g = group_of<Fld>();
  if (!Fld::kUniform && g >= n) return;
  const typename Fld::Params F = Fld::params();
  const long long i = g < n ? g : n - 1;
  const size_t row = (size_t)i * 2 * Fld::ROW;
  uint32_t x1[W], y1[W], x2[W], y2[W];
  Fld::load(x1, a + row, 0);
  Fld::load(y1, a + row, 1);
  Fld::load(x2, b + row, 0);
  Fld::load(y2, b + row, 1);
  Jac<Fld> r;
  aff_add<Fld>(r, x1, y1, ainf[i] != 0, x2, y2, binf[i] != 0, F);
  if (g < n) proj_store<Fld>(out + (size_t)i * 3 * Fld::ROW, r);
}

// K3 and K5: 2^k p[i], one warp a point, the products of each step side
// by side
__device__ __forceinline__ long long warp_of() {
  return ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
}

template <class Fld>
__global__ void __launch_bounds__(kThreads)
    proj_dbl_chain_kernel(const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int n, int k,
                          typename Fld::B3Arg b3) {
  const long long g = warp_of();
  const typename Fld::Params F = Fld::params();
  const typename Fld::B3 B = Fld::b3_lane(b3);
  const size_t row = (size_t)(g < n ? g : n - 1) * 3 * Fld::ROW;
  Proj<Fld> a;
  proj_load<Fld>(a, p + row);
#pragma unroll 1
  for (int j = 0; j < k; ++j) proj_dbl_side<Fld>(a, a, B, F);
  if (g < n && Fld::Lane::group() == 0) proj_store<Fld>(out + row, a);
}

template <class Fld>
__global__ void __launch_bounds__(kThreads)
    jac_dbl_chain_kernel(const uint32_t* __restrict__ p,
                         uint32_t* __restrict__ out, int n, int k) {
  const long long g = warp_of();
  const typename Fld::Params F = Fld::params();
  const size_t row = (size_t)(g < n ? g : n - 1) * 3 * Fld::ROW;
  Jac<Fld> a;
  proj_load<Fld>(a, p + row);
#pragma unroll 1
  for (int j = 0; j < k; ++j) jac_dbl_side<Fld>(a, a, F);
  if (g < n && Fld::Lane::group() == 0) proj_store<Fld>(out + row, a);
}

// blocks for n points at ``per`` threads a point
int blocks_for(int n, int per = ZT_TPI) {
  return (int)(((long long)n * per + kThreads - 1) / kThreads);
}

}  // namespace

// b3: the kernel's b3 bytes (an int32 over Fq, 2 x 12 Montgomery limbs over
// Fq2), as ec/curve_torch.py:kernel_consts gives them.  affine: 1 for (x,
// y) rows added by the mixed add, 0 for (x, y, z) rows.
extern "C" int zt_bucket_reduce(const void* pts, const void* ent,
                                const void* seg, int nseg, void* out,
                                int affine, const void* b3, void* stream) {
  if (nseg <= 0) return 0;
  using Fld = AddField<true>;
  typename Fld::B3Arg b3v;
  memcpy(&b3v, b3, sizeof(b3v));
  auto* kernel = affine ? bucket_reduce_kernel<Fld, true>
                        : bucket_reduce_kernel<Fld, false>;
  kernel<<<blocks_for(nseg), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pts), static_cast<const int32_t*>(ent),
      static_cast<const int32_t*>(seg), nseg, static_cast<uint32_t*>(out),
      b3v);
  return (int)cudaGetLastError();
}

extern "C" int zt_proj_add(const void* p, const void* q, void* out, int n,
                           const void* b3, void* stream) {
  if (n <= 0) return 0;
  typename AddField<true>::B3Arg b3v;
  memcpy(&b3v, b3, sizeof(b3v));
  proj_add_kernel<AddField<true>>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
          static_cast<uint32_t*>(out), n, b3v);
  return (int)cudaGetLastError();
}

extern "C" int zt_jac_add(const void* p, const void* q, void* out, int n,
                          void* stream) {
  if (n <= 0) return 0;
  jac_add_kernel<AddField<(ZT_TPI > 1)>>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<const uint32_t*>(q),
          static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int zt_proj_dbl_chain(const void* p, void* out, int n, int k,
                                 const void* b3, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  using Fld = AddField<true>;
  typename Fld::B3Arg b3v;
  memcpy(&b3v, b3, sizeof(b3v));
  proj_dbl_chain_kernel<Fld>
      <<<blocks_for(n, 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n, k,
          b3v);
  return (int)cudaGetLastError();
}

extern "C" int zt_jac_dbl_chain(const void* p, void* out, int n, int k,
                                void* stream) {
  if (n <= 0 || k <= 0) return 0;
  jac_dbl_chain_kernel<AddField<true>>
      <<<blocks_for(n, 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n, k);
  return (int)cudaGetLastError();
}

// ainf, binf: one byte a point (a torch bool tensor)
extern "C" int zt_aff_add(const void* a, const void* ainf, const void* b,
                          const void* binf, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  aff_add_kernel<AddField<(ZT_TPI > 1)>>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint8_t*>(ainf),
          static_cast<const uint32_t*>(b), static_cast<const uint8_t*>(binf),
          static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
