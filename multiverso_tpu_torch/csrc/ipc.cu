// Card-to-card staging of the device window transport
// (multiverso_tpu_torch/parallel/device_wire.py), for the ranks of one host.
//
// No kernel: this file binds the CUDA runtime's IPC calls and one copy to a
// plain C interface that device_wire.py loads with ctypes. It replaces no
// Pallas kernel. It is the port's counterpart of the placement the JAX
// package does with XLA collectives (multiverso_tpu/parallel/mesh.py
// place_parts): a rank writes its deferred Add values into a staging slot
// it owns (mvt_ipc_alloc, one cudaMalloc a slot, so an IPC handle covers the
// slot and nothing else), exports the slot's handle once
// (mvt_ipc_get_handle), and its peers open it (mvt_ipc_open) and copy the
// values they need straight out of it (mvt_ipc_copy: cudaMemcpyAsync on the
// caller's stream, peer to peer or within one card). A peer closes its
// mapping (mvt_ipc_close) before the owner frees the slot (mvt_ipc_free).
//
// Bound: a copy moves its bytes once over the card's memory (3.35 TB/s on
// an H100 SXM) when both ranks share the card, or over NVLink between two
// cards; nothing here computes.
//
// Every function returns the CUDA error code (0 = success) and makes the
// given device current only for the call, restoring the caller's.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

// Makes `dev` current for the scope of one call when it is not already.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~DeviceScope() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

int mvt_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

const char* mvt_ipc_error(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

int mvt_ipc_alloc(int dev, size_t bytes, void** out) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  *out = nullptr;
  return (int)cudaMalloc(out, bytes);
}

int mvt_ipc_free(int dev, void* ptr) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaFree(ptr);
}

int mvt_ipc_get_handle(int dev, void* ptr, unsigned char* out) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaIpcMemHandle_t h;
  cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) std::memcpy(out, &h, sizeof(h));
  return (int)rc;
}

int mvt_ipc_open(int dev, const unsigned char* handle, void** out) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  *out = nullptr;
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int mvt_ipc_close(int dev, void* ptr) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)cudaIpcCloseMemHandle(ptr);
}

// dst and src may be device pointers (a slot, a peer's opened slot, a
// tensor) or a host pointer; the unified address space picks the direction.
int mvt_ipc_copy(int dev, void* dst, const void* src, size_t bytes,
                 void* stream) {
  DeviceScope scope(dev);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (bytes == 0) return 0;
  return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                              (cudaStream_t)stream);
}

}  // extern "C"
