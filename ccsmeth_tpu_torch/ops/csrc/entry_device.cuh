// The device of a C entry.
//
// Each kernel library links nvcc's static CUDA runtime, whose current device
// is its own per-thread state: nothing makes it follow PyTorch's. The
// dynamic shared-memory limit that the entries raise with
// cudaFuncSetAttribute is a per-device setting, and a launch goes to the
// current device. So every extern "C" entry takes the ordinal of its
// tensors' device as its last argument and calls USE_DEVICE(device) before
// anything else. The check reads the runtime's current device each call
// (no cached ordinal, which another runtime's cudaSetDevice on the same
// thread could make stale) and sets it only when it differs.
#pragma once

#include <cuda_runtime.h>

static inline cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

#define USE_DEVICE(device)                                      \
  do {                                                          \
    const cudaError_t use_device_err = use_device(device);      \
    if (use_device_err != cudaSuccess) return (int)use_device_err; \
  } while (0)
