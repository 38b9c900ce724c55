// Host cost of what the bf16 flash-attention launcher does on every call
// besides the launch: encoding its three TMA tensor maps (q, k, v at the
// Qwen2-1.5B prefill shape, B 4, H 12, KV 2, S 512, D 128) and querying the
// device for its SM count and L2 size.  Prints microseconds a call, three
// times over 200000 calls.  On a machine with an sm_90a GPU, from the root
// of the repository:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tensormap_cost tools/tensormap_cost.cu && build/tensormap_cost

#include <chrono>
#include <cstdio>

#include "../src/repro_torch/csrc/hopper.cuh"

int main() {
  void* buf = nullptr;
  if (cudaMalloc(&buf, 64 << 20) != cudaSuccess) return 1;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return 1;
  CUtensorMap map[3];
  constexpr int N = 200000;
  for (int rep = 0; rep < 3; ++rep) {
    const auto t0 = std::chrono::steady_clock::now();
    bool ok = true;
    for (int i = 0; i < N; ++i) {
      ok &= hopper::encode_bf16_map(&map[0], encode, buf, 128, 512, 12, 4,
                                    12 * 128, 128, 512 * 12 * 128, 128);
      ok &= hopper::encode_bf16_map(&map[1], encode, buf, 128, 512, 2, 4,
                                    2 * 128, 128, 512 * 2 * 128, 64);
      ok &= hopper::encode_bf16_map(&map[2], encode, buf, 128, 512, 2, 4,
                                    2 * 128, 128, 512 * 2 * 128, 64);
    }
    const auto t1 = std::chrono::steady_clock::now();
    int dev = 0, sms = 0, l2 = 0;
    for (int i = 0; i < N; ++i) {
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    }
    const auto t2 = std::chrono::steady_clock::now();
    if (!ok) return 1;
    std::printf(
        "three tensor maps %.3f us a call; device queries %.3f us a call "
        "(%d SMs, L2 %d B)\n",
        std::chrono::duration<double, std::micro>(t1 - t0).count() / N,
        std::chrono::duration<double, std::micro>(t2 - t1).count() / N, sms,
        l2);
  }
  cudaFree(buf);
  return 0;
}
