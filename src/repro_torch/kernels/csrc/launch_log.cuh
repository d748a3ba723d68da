// Launch records and resource queries of one kernel library.
//
// Each .cu file of the port is one library (one translation unit, see
// kernels/build.py). Every launch site records its kernel's name, the
// template instantiation's number (`variant`, named in
// repro_torch.analysis.contracts.VARIANTS), the function, and the grid,
// threads and dynamic shared memory it launched with: a table of the
// distinct configurations, each with its count and the sequence number of
// its last launch. The table lives in an anonymous namespace, so each
// library keeps its own. Records are kept only while the library's
// recording is on (LIB_launch_enable, which repro_torch.analysis.launches
// switches with its notes); off, a launch pays one relaxed atomic load.
// On, a record costs a lock and a scan of the table beside a launch of
// microseconds; it is read only by the queries below, which the analysis
// layer (repro_torch.analysis.card) calls after the launches it checks: the function's attributes (registers, static shared
// memory, local bytes, max threads), the runtime's occupancy at a thread
// count and dynamic shared memory, and the last launch of a kernel's
// variant. A query never runs inside a CUDA graph capture.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace {
namespace launch_log {

constexpr int kMaxConfigs = 4096;

struct Config {
  const char* kernel;  // the __global__ function's name (a literal)
  const void* func;    // its instantiation
  int variant;
  long long grid, threads, smem, count, seq;
};

struct Log {
  std::mutex mu;
  Config c[kMaxConfigs];
  int n = 0;
  long long seq = 0, dropped = 0;
};

Log g_log;
std::atomic<bool> g_on{false};

// Record one launch (host side, next to the <<<>>> or the cooperative
// launch that it describes).
inline void record(const char* kernel, int variant, const void* func,
                   long long grid, long long threads, long long smem) {
  if (!g_on.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> lock(g_log.mu);
  const long long seq = ++g_log.seq;
  for (int i = 0; i < g_log.n; ++i) {
    Config& c = g_log.c[i];
    if (c.func == func && c.grid == grid && c.threads == threads &&
        c.smem == smem) {
      ++c.count;
      c.seq = seq;
      return;
    }
  }
  if (g_log.n == kMaxConfigs) {
    ++g_log.dropped;
    return;
  }
  g_log.c[g_log.n++] = Config{kernel, func, variant, grid, threads, smem, 1,
                              seq};
}

// Dynamic shared memory opt-ins, per function and device. The limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize) belongs to the function, not
// to a launch: host threads that launch one kernel at different sizes (the
// threads of a replica pool, at different bucket lengths) would race if each
// set its own, one lowering it between another's set and launch, which then
// fails with cudaErrorLaunchOutOfResources. So a limit only rises, under a
// lock, and once it is high enough no call is made (a launch may be captured
// into a CUDA graph).
constexpr int kMaxOptins = 256;

struct Optin {
  const void* func;
  int dev;
  long long bytes;  // the function's limit on `dev`
};

struct Optins {
  std::mutex mu;
  Optin o[kMaxOptins];
  int n = 0;
};

Optins g_optins;

// Let `func` launch with `smem` bytes of dynamic shared memory on the
// current device. `max_shared` also asks for the largest shared memory
// carveout, once a function and device.
inline cudaError_t optin_smem(const void* func, long long smem,
                              bool max_shared = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_optins.mu);
  Optin* o = nullptr;
  for (int i = 0; i < g_optins.n && o == nullptr; ++i)
    if (g_optins.o[i].func == func && g_optins.o[i].dev == dev)
      o = &g_optins.o[i];
  if (o == nullptr) {
    if (g_optins.n == kMaxOptins) return cudaErrorInvalidValue;
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, func);
    if (err == cudaSuccess && max_shared)
      err = cudaFuncSetAttribute(func,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    o = &g_optins.o[g_optins.n++];
    *o = Optin{func, dev, a.maxDynamicSharedSizeBytes};
  }
  if (smem <= o->bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  o->bytes = smem;
  return cudaSuccess;
}

// The resources of `kernel`'s `variant` and its last launch: out[0..9] =
// registers a thread, static shared memory, local bytes a thread, max
// threads a CTA, the runtime's CTAs an SM at (threads, smem), the last
// launch's grid, threads and dynamic shared memory, the variant's launches
// (all configurations), and its distinct configurations. Returns 0, -1 if
// the variant has not launched here (nothing is written), or a CUDA error.
inline int query(const char* kernel, int variant, int threads,
                 long long smem, long long* out) {
  const void* func = nullptr;
  long long last = -1, count = 0, configs = 0;
  Config best{};
  {
    std::lock_guard<std::mutex> lock(g_log.mu);
    for (int i = 0; i < g_log.n; ++i) {
      const Config& c = g_log.c[i];
      if (c.variant != variant || strcmp(c.kernel, kernel) != 0) continue;
      func = c.func;
      count += c.count;
      ++configs;
      if (c.seq > last) {
        last = c.seq;
        best = c;
      }
    }
  }
  if (func == nullptr) return -1;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, func);
  if (err != cudaSuccess) return err;
  // the occupancy asked about may exceed what the last launch opted in to
  err = optin_smem(func, smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, func, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = (long long)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = occ;
  out[5] = best.grid;
  out[6] = best.threads;
  out[7] = best.smem;
  out[8] = count;
  out[9] = configs;
  return 0;
}

// The i-th distinct configuration: out[0..4] = variant, grid, threads,
// dynamic shared memory, launches. Returns the kernel's name, or NULL past
// the last (then out[0] is the count of configurations and out[1] the
// launches not recorded because the table was full).
inline const char* config(int i, long long* out) {
  std::lock_guard<std::mutex> lock(g_log.mu);
  if (i < 0 || i >= g_log.n) {
    out[0] = g_log.n;
    out[1] = g_log.dropped;
    return nullptr;
  }
  const Config& c = g_log.c[i];
  out[0] = c.variant;
  out[1] = c.grid;
  out[2] = c.threads;
  out[3] = c.smem;
  out[4] = c.count;
  return c.kernel;
}

// Forget every record (before a run whose launches are to be checked).
inline void reset() {
  std::lock_guard<std::mutex> lock(g_log.mu);
  g_log.n = 0;
  g_log.dropped = 0;
}

}  // namespace launch_log
}  // namespace

// The exported query of one __global__ function (see launch_log::query).
#define LAUNCH_LOG_QUERY(KERNEL)                                           \
  extern "C" int KERNEL##_query(int variant, int threads, long long smem, \
                                long long* out) {                         \
    return launch_log::query(#KERNEL, variant, threads, smem, out);       \
  }

// The exported configuration table, reset and recording switch of one
// library.
#define LAUNCH_LOG_LIBRARY(LIB)                                    \
  extern "C" const char* LIB##_launch_config(int i, long long* out) { \
    return launch_log::config(i, out);                             \
  }                                                                \
  extern "C" void LIB##_launch_reset() { launch_log::reset(); }    \
  extern "C" void LIB##_launch_enable(int on) {                    \
    launch_log::g_on.store(on != 0, std::memory_order_relaxed);    \
  }
