// The add step of the wide histogram's phase C, alone, in the two designs
// that spread one slot's sums over a thread-block cluster
// (lightgbm_tpu_torch/csrc/grouped_hist.cuh, phase_hist_cluster):
//
//   local   every add lands in the block's own tile (the add step of the
//           tiled read that the cluster replaced, once per tile walk);
//   remote  (a) each lane adds its row's S stats into the block that owns
//           the bin's tile, through distributed shared memory (a native
//           shared add where that is the block itself): the design the
//           kernel takes;
//   queue   (b) each lane writes the adds for another block's tile into a
//           per-destination queue in its own shared memory; after a
//           cluster barrier every block drains the queues addressed to it
//           from its peers (distributed shared memory reads) and adds them
//           locally, then a second barrier frees the queues.  Queues sized
//           for the worst case of one entry a warp between barriers (every
//           lane of the block to one destination), in shared memory that
//           the real kernel would need for its bins tiles;
//   grouped (a) with each lane's remote adds issued one destination
//           block at a time (a loop over the cluster's blocks).
//
// Every warp takes `rows` entries; lane f's bin of entry e is a hash,
// uniform over the cluster's C x bin_tile bins (random bins, every row a
// run of its own: the root call's worst case).  Prints one line:
//   design acc C threads bin_tile S clusters rows_per_warp ms entries
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace cg = cooperative_groups;

constexpr int kMaxS = 5;

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <typename Acc>
__device__ __forceinline__ Acc value(uint32_t h) {
  return static_cast<Acc>(static_cast<int>(h & 7u) - 3);
}

template <typename Acc>
struct Stride {
  static constexpr int k = 33;
};
template <>
struct Stride<float> {
  static constexpr int k = 32;
};

// design 0 local, 1 remote (a), 2 queue (b), 3 remote (a) issued one
// destination block at a time
template <typename Acc, int kDesign>
__global__ void __launch_bounds__(1024)
    adds(int bin_tile, int S, int rows, int qcap, Acc* out) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  constexpr int st = Stride<Acc>::k;
  Acc* sh = reinterpret_cast<Acc*>(smem);
  const int words = bin_tile * S * st;
  // queue (b): counters [8], then C - 1 queues of qcap records of 1 + S
  // words
  int* cnt = smem + words;
  int* queues = cnt + 8;
  const int rec = 1 + S;
  for (int i = threadIdx.x; i < words; i += blockDim.x) sh[i] = Acc(0);
  if (threadIdx.x < 8) cnt[threadIdx.x] = 0;
  cluster.sync();
  const int nbins = kDesign == 0 ? bin_tile : C * bin_tile;
  const unsigned lt = (1u << lane) - 1u;
  for (int e = 0; e < rows; ++e) {
    const uint32_t h = mix((blockIdx.x * nw + warp) * 0x9e3779b9u
                           + e * 0x85ebca6bu + lane);
    int bin = static_cast<int>(h % static_cast<uint32_t>(nbins));
    int owner = 0;
    while (bin >= bin_tile) {
      bin -= bin_tile;
      ++owner;
    }
    if (kDesign == 0 || owner == rank) {
      for (int s = 0; s < S; ++s)
        atomicAdd(sh + (bin * S + s) * st + lane, value<Acc>(h >> s));
    } else if (kDesign == 1) {
      Acc* dst = cluster.map_shared_rank(sh, owner);
      for (int s = 0; s < S; ++s)
        atomicAdd(dst + (bin * S + s) * st + lane, value<Acc>(h >> s));
    } else if (kDesign == 3) {
      // the same adds, issued one destination block at a time
      for (int d = 0; d < C; ++d) {
        if (d == rank || owner != d) continue;
        Acc* dst = cluster.map_shared_rank(sh, d);
        for (int s = 0; s < S; ++s)
          atomicAdd(dst + (bin * S + s) * st + lane, value<Acc>(h >> s));
      }
    }
    if (kDesign == 2) {
      const int to = owner == rank ? -1 : owner;
      const unsigned peers = __match_any_sync(0xffffffffu, to);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (to >= 0 && lane == leader) base = atomicAdd(cnt + to, __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (to >= 0) {
        // the queues of the C - 1 peers, in rank order without this one
        const int qi = to < rank ? to : to - 1;
        int* r = queues + (qi * qcap + base + __popc(peers & lt)) * rec;
        r[0] = bin * S * st + lane;
        for (int s = 0; s < S; ++s) {
          const Acc v = value<Acc>(h >> s);
          r[1 + s] = *reinterpret_cast<const int*>(&v);
        }
      }
      cluster.sync();
      for (int p = 0; p < C; ++p) {
        if (p == rank) continue;
        const int* pc = cluster.map_shared_rank(cnt, p);
        const int* pq = cluster.map_shared_rank(queues, p)
                        + (rank < p ? rank : rank - 1) * qcap * rec;
        const int n = pc[rank];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const int w = pq[i * rec];
          for (int s = 0; s < S; ++s) {
            const int b = pq[i * rec + 1 + s];
            atomicAdd(sh + w + s * st, *reinterpret_cast<const Acc*>(&b));
          }
        }
      }
      cluster.sync();
      if (threadIdx.x < 8) cnt[threadIdx.x] = 0;
      __syncthreads();
    }
  }
  cluster.sync();
  // keep the sums alive
  Acc t = Acc(0);
  for (int i = threadIdx.x; i < words; i += blockDim.x) t += sh[i];
  atomicAdd(out, t);
}

template <typename Acc, int kDesign>
int run(int C, int threads, int bin_tile, int S, long long entries) {
  auto* fn = adds<Acc, kDesign>;
  const int words = bin_tile * S * Stride<Acc>::k;
  const int qcap = threads;  // one entry a warp: every lane to one peer
  // the sums, the 8 counter words, and for (b) the queues
  size_t smem = 4ull * (words + 8);
  if (kDesign == 2) smem += 4ull * (C - 1) * qcap * (1 + S);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    printf("refused %s %d bytes\n", cudaGetErrorString(err), (int)smem);
    return 1;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int ncl = 0;
  err = cudaOccupancyMaxActiveClusters(&ncl, fn, &cfg);
  if (err != cudaSuccess || ncl < 1) {
    printf("refused occupancy %s\n", cudaGetErrorString(err));
    return 1;
  }
  cfg.gridDim = dim3(ncl * C);
  const long long warps = 1ll * ncl * C * (threads / 32);
  const int rows = (int)((entries + warps - 1) / warps);
  Acc* out;
  cudaMalloc(&out, sizeof(Acc));
  cudaLaunchKernelEx(&cfg, fn, bin_tile, S, rows, qcap, out);
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("failed %s\n", cudaGetErrorString(err));
    return 1;
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int reps = 10;
  cudaEventRecord(e0);
  for (int r = 0; r < reps; ++r)
    cudaLaunchKernelEx(&cfg, fn, bin_tile, S, rows, qcap, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const char* names[] = {"local", "remote", "queue", "grouped"};
  printf("%s %s %d %d %d %d %d %d %.6f %lld\n", names[kDesign],
         sizeof(Acc) == 4 && Acc(0.5) != Acc(0) ? "f32" : "i32", C, threads,
         bin_tile, S, ncl, rows, ms / reps, warps * rows);
  cudaFree(out);
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s local|remote|queue|grouped f32|i32 C threads "
            "bin_tile S [entries]\n",
            argv[0]);
    return 2;
  }
  const int C = atoi(argv[3]), threads = atoi(argv[4]);
  const int bt = atoi(argv[5]), S = atoi(argv[6]);
  const long long entries = argc > 7 ? atoll(argv[7]) : (1ll << 20);
  const bool f = strcmp(argv[2], "f32") == 0;
  const int d = strcmp(argv[1], "local") == 0     ? 0
                : strcmp(argv[1], "remote") == 0  ? 1
                : strcmp(argv[1], "grouped") == 0 ? 3
                                                  : 2;
  if (S < 1 || S > kMaxS || C < 1 || C > 8) return 2;
  if (f) {
    if (d == 0) return run<float, 0>(C, threads, bt, S, entries);
    if (d == 1) return run<float, 1>(C, threads, bt, S, entries);
    if (d == 3) return run<float, 3>(C, threads, bt, S, entries);
    return run<float, 2>(C, threads, bt, S, entries);
  }
  if (d == 0) return run<int, 0>(C, threads, bt, S, entries);
  if (d == 1) return run<int, 1>(C, threads, bt, S, entries);
  if (d == 3) return run<int, 3>(C, threads, bt, S, entries);
  return run<int, 2>(C, threads, bt, S, entries);
}
