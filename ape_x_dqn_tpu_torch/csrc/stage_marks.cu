// Stage markers: one empty kernel per stage of a learner step, so a
// device trace can split a captured step's kernels by stage.
//
// Replaces no TPU kernel. A CUDA graph replays device work only, so a
// host-side range put inside a captured step runs once, at capture,
// and is gone at replay. A kernel launched at each stage boundary is
// recorded into the graph like any other, replays with it, and shows
// in a profiler trace under its own plain name (`extern "C"`, so the
// name is not mangled): apex_stage_<stage>. A stage runs from its
// marker to the next marker on the same device.
//
// What bounds it: nothing but the launch. One block of one thread that
// reads and writes no memory; inside a graph a node costs the card
// about a microsecond or two, and the host nothing at replay.
//
// Built into the same shared library as frame_gather.cu, in the same
// nvcc call (ape_x_dqn_tpu_torch/ops/frame_gather.py), and launched
// through ctypes (ape_x_dqn_tpu_torch/obs/stages.py). The stage numbers
// are the positions in obs/stages.py's STAGES.

#include <cuda_runtime.h>

extern "C" __global__ void apex_stage_sample() {}
extern "C" __global__ void apex_stage_gather() {}
extern "C" __global__ void apex_stage_loss() {}
extern "C" __global__ void apex_stage_backward() {}
extern "C" __global__ void apex_stage_optimizer() {}
extern "C" __global__ void apex_stage_diag() {}
extern "C" __global__ void apex_stage_writeback() {}
extern "C" __global__ void apex_stage_exchange() {}
extern "C" __global__ void apex_stage_end() {}

namespace {

void (*const kMarks[])() = {
    apex_stage_sample,    apex_stage_gather,    apex_stage_loss,
    apex_stage_backward,  apex_stage_optimizer, apex_stage_diag,
    apex_stage_writeback, apex_stage_exchange,  apex_stage_end,
};

constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launch stage `stage`'s marker on `stream` (a cudaStream_t of the
// current device). Returns a cudaError_t: cudaErrorInvalidValue for a
// stage number out of range, else the launch's own error.
extern "C" int stage_mark_launch(int stage, void* stream) {
  if (stage < 0 || stage >= kNumMarks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kMarks[stage]), dim3(1), dim3(1),
      nullptr, 0, static_cast<cudaStream_t>(stream)));
}
