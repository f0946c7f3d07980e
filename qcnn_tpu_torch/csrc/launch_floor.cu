// launch_floor: an empty kernel at a given grid, block and dynamic shared
// memory. What it takes under a timer is what a launch of that shape pays
// before its first instruction and after its last: the floor beside which
// the times of the small kernels (pq_lut_gather at batch 1, pq_decode) are
// read. It replaces no TPU kernel and no path of the port launches it.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int empty_launch(int grid_x, int grid_y, int grid_z, int threads,
                            int smem_bytes, cudaStream_t stream) {
  static int smem_set = 0;
  if (smem_bytes > 48 * 1024 && smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem_bytes;
  }
  empty_kernel<<<dim3(grid_x, grid_y, grid_z), threads, smem_bytes, stream>>>();
  return (int)cudaGetLastError();
}
