// PyTorch binding of the C launchers in kernels.h: the one source that
// includes the PyTorch headers. Arguments are checked by the Python
// wrappers (arseg_tpu_torch/ops/creff_kernel.py, warp_kernel.py); this file
// passes pointers and the current stream and checks the launch.
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

int dtype_code(const at::Tensor& t) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK(false, "unsupported dtype ", t.scalar_type());
  return -1;
}

void creff_qkv_fused(at::Tensor out, at::Tensor lr_up, at::Tensor ref, at::Tensor taps,
                     at::Tensor bias, int64_t kh, int64_t kw) {
  const c10::cuda::CUDAGuard guard(out.device());
  const int rc = arseg_creff_qkv_fused(
      out.data_ptr(), lr_up.data_ptr(), ref.data_ptr(), taps.data_ptr<float>(),
      bias.data_ptr<float>(), static_cast<int>(lr_up.size(0)), static_cast<int>(lr_up.size(1)),
      static_cast<int>(lr_up.size(2)), static_cast<int>(lr_up.size(3)), static_cast<int>(kh),
      static_cast<int>(kw), dtype_code(out), c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void warp_bilinear(at::Tensor out, at::Tensor src, at::Tensor fx, at::Tensor fy,
                   bool align_corners) {
  const c10::cuda::CUDAGuard guard(out.device());
  const int rc = arseg_warp_bilinear(
      out.data_ptr(), src.data_ptr(), fx.data_ptr<float>(), fy.data_ptr<float>(),
      static_cast<int>(out.size(0)), static_cast<int>(src.size(0)),
      static_cast<int>(out.size(1)), static_cast<int>(out.size(2)),
      static_cast<int>(out.size(3)), align_corners ? 1 : 0, dtype_code(out),
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("creff_qkv_fused", &creff_qkv_fused, "fused CReFF module (csrc/creff_qkv_fused.cu)");
  m.def("warp_bilinear", &warp_bilinear, "bilinear MV warp (csrc/warp_bilinear.cu)");
}
