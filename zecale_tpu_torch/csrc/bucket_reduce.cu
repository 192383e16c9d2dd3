// Bucket reduce for the Pippenger MSM (ec/msm.py): each thread sums one
// segment of a point-index array sorted by bucket, with the complete RCB
// addition of curve.cuh, and writes one projective partial.
//
// Replaces zecale_tpu/ec/msm4.py:bucket_reduce_pallas (543-652).  The TPU
// kernel carried an accumulator across a sequential grid axis of slot
// strips over a padded int8 (C, 2ew, KW) bucket matrix.  Here blocks run in
// no order, so a thread owns its segment outright: it walks the sorted
// entries and reads the points straight from the query array, with no
// bucket matrix and no slot padding.  The caller (ec/msm.py) cuts long
// bucket runs into segments of at most SEG points and sums the partials
// with a second launch, so a bucket that holds half the witness (scalars
// 0/1 land in one bucket) does not serialise the MSM on one thread.
//
// Bound: operations.  One add at N limbs is 11-12 Montgomery products of
// 2 N^2 32x32->64-bit multiply-adds each; the points (2N or 3N limbs) are
// read once per entry, far below the card's memory rate.  A 24-limb add
// keeps ~10 field elements live (>250 registers), so the kernel spills to
// L1-backed local memory; __launch_bounds__(128) caps a block at 128
// threads so that 128 x 255 registers fit the SM's 65,536.
//
// The Fq2 form (BLS12-377 G2, the G2 query of a nested BLS12-377 proof)
// runs the same body over field2.cuh; its b3 is the twist constant, passed
// as an argument like the small b3 of the Fq forms.
//
// Built once per field form and input form (-DZT_LIMBS=12|24 or
// -DZT_FQ2=1, with -DZT_AFFINE=1|0: six nvcc processes side by side, since
// one 24-limb variant alone takes most of the build) into zt_bucket_reduce:
// a C interface loaded with ctypes by utils/build.py, returning the CUDA
// error code of the launch (0 on success).
#include <cuda_runtime.h>

#include "curve.cuh"

#if !defined(ZT_AFFINE) || !(defined(ZT_LIMBS) || defined(ZT_FQ2))
#error "build with -DZT_LIMBS=12|24 or -DZT_FQ2=1, and -DZT_AFFINE=1|0"
#endif

namespace {

constexpr int kThreads = 128;

template <class Fld, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    bucket_reduce_kernel(const uint32_t* __restrict__ pts,
                         const int32_t* __restrict__ ent,
                         const int32_t* __restrict__ seg, int nseg,
                         uint32_t* __restrict__ out,
                         typename Fld::Params F, typename Fld::B3 b3) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  reduce_segment<Fld, AFFINE>(out + (size_t)s * 3 * Fld::W, pts, ent,
                              seg[s], seg[s + 1], b3, F);
}

}  // namespace

extern "C" int zt_bucket_reduce(const void* pts, const void* ent,
                                const void* seg, int nseg, void* out,
                                const void* p, const void* one,
                                unsigned pinv, const void* b3,
                                void* stream) {
  if (nseg <= 0) return 0;
  const int blocks = (nseg + kThreads - 1) / kThreads;
  bucket_reduce_kernel<ZtField, ZT_AFFINE != 0>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(pts), static_cast<const int32_t*>(ent),
          static_cast<const int32_t*>(seg), nseg, static_cast<uint32_t*>(out),
          field_params<ZtField>(p, one, pinv), field_b3<ZtField>(b3));
  return (int)cudaGetLastError();
}
