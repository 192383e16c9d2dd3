// The msm8 engine's doubling kernel (ec/proj_curve.py, ec/msm8.py):
//
//   K3 zt_proj_dbl_chain: out[i] = 2^k p[i], k RCB doublings (curve.cuh
//                         proj_dbl) inside the thread, one launch per chain.
//
// K2 proj_add, which this source held until it was redesigned, is now in
// add_kernels.cu on the fast field core (field_fast.cuh).
//
// Replaces zecale_tpu/ec/ec_pallas.py:_KernelFamily.proj_dbl_chain
// (596-619).  The TPU kernel transposed a block of bt points into (ew, bt)
// limb planes so that the VPU's lanes ran across points.  Here one thread
// owns one point: it reads its row of 3 W words (x | y | z, the layout of
// the torch tensors), runs the doublings in registers and writes the row
// back.  There is no block of lanes to pad to and no sequential grid; a
// dbl chain is a loop inside the thread, so the point never leaves
// registers between doublings.
//
// Bound: operations.  A doubling is 8 products plus one b3 multiply (over
// Fq2 each product is 3 base products, and the twist b3 is a full Fq2
// product).  Each product is 2 NB^2 32x32->64-bit multiply-adds against
// 3 W words of traffic per point, far below the card's memory rate.  A
// chain on one point (the MSM's Horner fold) is one thread's dependent
// products: latency-bound.  __launch_bounds__(128) as in bucket_reduce.cu.
//
// One source, built once per field form (-DZT_LIMBS=12 BLS12-377 Fq,
// -DZT_LIMBS=24 BW6-761 Fq, -DZT_FQ2=1 BLS12-377 Fq2: three nvcc
// processes), each exporting its launcher with a plain C interface that
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
    proj_dbl_chain_kernel(const uint32_t* __restrict__ p,
                          uint32_t* __restrict__ out, int n, int k,
                          typename Fld::Params F, typename Fld::B3 b3) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = (size_t)i * 3 * Fld::W;
  Proj<Fld> a;
  proj_load<Fld>(a, p + row);
#pragma unroll 1
  for (int j = 0; j < k; ++j) proj_dbl<Fld>(a, a, b3, F);
  proj_store<Fld>(out + row, a);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int zt_proj_dbl_chain(const void* p, void* out, int n, int k,
                                 const void* prime, const void* one,
                                 unsigned pinv, const void* b3,
                                 void* stream) {
  if (n <= 0) return 0;
  proj_dbl_chain_kernel<ZtField>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<uint32_t*>(out), n, k,
          field_params<ZtField>(prime, one, pinv), field_b3<ZtField>(b3));
  return (int)cudaGetLastError();
}
