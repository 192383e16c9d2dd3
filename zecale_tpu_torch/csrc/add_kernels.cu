// K2 and K4 on the fast field core (field_fast.cuh), TPI threads per point:
//
//   K2 zt_proj_add: out[i] = p[i] + q[i], the complete RCB add (curve.cuh
//                   proj_add), canonical outputs;
//   K4 zt_jac_add:  out[i] = p[i] + q[i], the unified Jacobian add
//                   (curve.cuh jac_add), canonical outputs, the reference's
//                   triple in every case.
//
// Replace zecale_tpu/ec/ec_pallas.py:_KernelFamily.proj_add (573-594) and
// _KernelFamily.jac_add (473-493).  The TPU kernels transposed a block of
// points into (ew, bt) limb planes so that the VPU's lanes ran across
// points.  Here a group of TPI neighbouring threads owns one point: each
// holds a slice of every coordinate and the group law runs in registers.
//
// Bound: operations.  An add is 12 Montgomery products plus two b3
// multiplies (K2) or 16 products (K4, 11M + 5S); over Fq2 each product is
// three base products (and K2's twist b3 a full Fq2 product).  A product is
// 2 N^2 32x32-bit multiply-adds, each a lo and a hi instruction, against
// 9 x 4N bytes of traffic per point: far below the card's memory rate.
//
// What held the per-thread kernels of field.cuh (one thread a point, ~21-23%
// of the operations bound at Fq 24) and what this design does about it:
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
// One source, built per (form, TPI): -DZT_LIMBS=12 (BLS12-377 Fq) or 24
// (BW6-761 Fq) or -DZT_FQ2=1 (BLS12-377 Fq2), and -DZT_TPI=1|2|4|8.  Both
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
// which then runs one path: K2's law has no branch on the data, and K4
// over lanes takes jac_add_warp (curve.cuh), which selects its case at the
// end.  At one thread a point there are no shuffles, and K4 keeps the
// branches of jac_add.
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

int blocks_for(int n) {
  return (int)(((long long)n * ZT_TPI + kThreads - 1) / kThreads);
}

}  // namespace

// b3: the kernel's b3 bytes (an int32 over Fq, 2 x 12 Montgomery limbs over
// Fq2), as ec/curve_torch.py:kernel_consts gives them
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
