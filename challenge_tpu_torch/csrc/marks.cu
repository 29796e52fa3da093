// Phase and layer marks: one empty kernel for each name of
// challenge_tpu_torch/utils/profiling.py MARKS, then of LAYER_MARKS, in the
// same order.
//
// A step launches them where its phases begin and end (the batch's
// features, the forward and loss, the backward, the update, the validation
// forward; utils.profiling.mark), and a model where one of its layers runs
// (the se cascade's U-Net forward, and where the U-Net's backward begins).
// A CUDA graph captures them with the rest of the step, so every replay
// runs them, and a profiler trace of a replay, which the host sees as one
// launch, shows on the device where each phase begins and ends. Each kernel is extern "C", so its name in a trace is its
// plain name. A mark reads and writes nothing: one block of one thread
// that returns, under 1 us of device time a launch on an H100.
//
// launch_mark(id, stream) launches mark `id` on `stream` and returns the
// launch's CUDA error code (0 on success).

#include <cuda_runtime.h>

#define MARKS(X)             \
  X(mark_input_begin)        \
  X(mark_input_end)          \
  X(mark_val_input_begin)    \
  X(mark_val_input_end)      \
  X(mark_forward_begin)      \
  X(mark_forward_end)        \
  X(mark_backward_begin)     \
  X(mark_backward_end)       \
  X(mark_update_begin)       \
  X(mark_update_end)         \
  X(mark_val_forward_begin)  \
  X(mark_val_forward_end)    \
  X(mark_unet_begin)         \
  X(mark_unet_end)           \
  X(mark_unet_backward_begin)

#define MARK_KERNEL(NAME) extern "C" __global__ void NAME() {}
MARKS(MARK_KERNEL)

namespace {
#define MARK_ENTRY(NAME) reinterpret_cast<const void*>(&NAME),
const void* const kMarks[] = {MARKS(MARK_ENTRY)};
constexpr int kCount = sizeof(kMarks) / sizeof(kMarks[0]);
}  // namespace

extern "C" int launch_mark(int id, void* stream) {
  if (id < 0 || id >= kCount) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaLaunchKernel(kMarks[id], dim3(1), dim3(1),
                                           nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}
