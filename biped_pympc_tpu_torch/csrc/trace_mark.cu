// Phase marks of the closed loop: one empty kernel per phase, launched on
// the current stream where that phase starts (`utils/tracing.mark`).
//
// A captured CUDA graph replays thousands of small kernels whose names do
// not say which part of the program issued them. A mark is a node of the
// graph like any other, so a device trace of a replay holds the marks in
// the order the capture recorded them, and the kernel's name carries the
// phase: every operation up to the next mark belongs to that phase. The
// kernels read and write nothing, so a mark changes no bits of any output;
// it costs one launch of a one-thread block.
//
// The order of the kernels is the order of `tracing.PHASES`, whose index
// `trace_mark` takes; a new phase is appended, so every phase keeps its
// index.

#include <cuda_runtime.h>

extern "C" {

__global__ void trace_mark_obs() {}
__global__ void trace_mark_ingest() {}
__global__ void trace_mark_assembly() {}
__global__ void trace_mark_lowlevel() {}
__global__ void trace_mark_plant() {}
__global__ void trace_mark_carry() {}
__global__ void trace_mark_hybrid_condensed() {}
__global__ void trace_mark_hybrid_rank() {}
__global__ void trace_mark_hybrid_resolve() {}
__global__ void trace_mark_hybrid_merge() {}
__global__ void trace_mark_hybrid_done() {}

// Launch the mark of phase `phase` (an index into `tracing.PHASES`) on
// `stream`. Returns a cudaError_t; an unknown phase launches nothing.
int trace_mark(int phase, void* stream) {
  static void (*const marks[])() = {trace_mark_obs,
                                    trace_mark_ingest,
                                    trace_mark_assembly,
                                    trace_mark_lowlevel,
                                    trace_mark_plant,
                                    trace_mark_carry,
                                    trace_mark_hybrid_condensed,
                                    trace_mark_hybrid_rank,
                                    trace_mark_hybrid_resolve,
                                    trace_mark_hybrid_merge,
                                    trace_mark_hybrid_done};
  if (phase < 0 || phase >= static_cast<int>(sizeof(marks) / sizeof(marks[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(marks[phase]), dim3(1),
                                           dim3(1), nullptr, 0,
                                           static_cast<cudaStream_t>(stream)));
}

const char* trace_mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
