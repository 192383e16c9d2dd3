// The Jacobian engine's affine-add kernel (ec/jac_curve.py, ec/msm_jac.py):
//
//   K6 zt_aff_add: out[i] = a[i] + b[i] for affine (x, y) rows with one
//                  infinity flag (a byte) per point, a Jacobian result
//                  (curve.cuh aff_add).
//
// K4 jac_add and K5 jac_dbl_chain, which this source held until they were
// redesigned, are in fast_kernels.cu on the fast field core
// (field_fast.cuh).
//
// Replaces zecale_tpu/ec/ec_pallas.py:_KernelFamily.aff_add (543-569).
// The TPU kernel transposed a block of bt points into (ew, bt) limb planes
// so that the VPU's lanes ran across points, and computed the generic
// sum, the doubling and the infinity cases for every lane before
// selecting.  Here one thread owns one point: it reads its rows (x | y,
// the layout of the torch tensors), branches to the one case its point is
// in, and writes the Jacobian row.
//
// Bound: operations.  An add is 6 Montgomery products; over Fq2 each
// product is three base products.  Each product is 2 NB^2 32x32->64-bit
// multiply-adds against 2 x 2 W words of traffic in and 3 W out, far
// below the card's memory rate.
//
// One source, built once per field form (-DZT_LIMBS=12 BLS12-377 Fq,
// -DZT_LIMBS=24 BW6-761 Fq, -DZT_FQ2=1 BLS12-377 Fq2: three nvcc
// processes), each exporting the launcher with a plain C interface that
// returns the CUDA error code of the launch (0 on success).
#include <cuda_runtime.h>

#include "curve.cuh"

#if !(defined(ZT_LIMBS) || defined(ZT_FQ2))
#error "build with -DZT_LIMBS=12|24 or -DZT_FQ2=1"
#endif

namespace {

constexpr int kThreads = 128;

template <class Fld>
__global__ void __launch_bounds__(kThreads)
    aff_add_kernel(const uint32_t* __restrict__ a,
                   const uint8_t* __restrict__ ainf,
                   const uint32_t* __restrict__ b,
                   const uint8_t* __restrict__ binf,
                   uint32_t* __restrict__ out, int n,
                   typename Fld::Params F) {
  constexpr int W = Fld::W;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = (size_t)i * 2 * W;
  uint32_t x1[W], y1[W], x2[W], y2[W];
  Fld::copy(x1, a + row);
  Fld::copy(y1, a + row + W);
  Fld::copy(x2, b + row);
  Fld::copy(y2, b + row + W);
  Jac<Fld> r;
  aff_add<Fld>(r, x1, y1, ainf[i] != 0, x2, y2, binf[i] != 0, F);
  proj_store<Fld>(out + (size_t)i * 3 * W, r);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int zt_aff_add(const void* a, const void* ainf, const void* b,
                          const void* binf, void* out, int n,
                          const void* prime, const void* one, unsigned pinv,
                          void* stream) {
  if (n <= 0) return 0;
  aff_add_kernel<ZtField>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(a), static_cast<const uint8_t*>(ainf),
          static_cast<const uint32_t*>(b), static_cast<const uint8_t*>(binf),
          static_cast<uint32_t*>(out), n,
          field_params<ZtField>(prime, one, pinv));
  return (int)cudaGetLastError();
}
