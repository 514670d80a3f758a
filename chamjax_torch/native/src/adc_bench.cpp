// Copied verbatim from chamjax/native/src/adc_bench.cpp (the port keeps its own copy).
// ADC micro-benchmark: host-CPU LUT-sum scan throughput baseline.
//
// Parity with the reference's SIMD micro-test
// (Chameleon/Faiss_experiments/my_simd_test/simd_test.cpp): how fast can a
// CPU core do the inner ADC loop (dist[r] = sum_m LUT[m][code[r][m]])?
// Used to sanity-check the TPU kernel's speedup claims and to size the
// CPU fallback path.  Three variants: scalar, m-unrolled, and
// structure-of-arrays (the TPU kernel's transposed layout).
//
// Build & run:
//   g++ -O3 -march=native -o /tmp/adc_bench chamjax/native/src/adc_bench.cpp
//   /tmp/adc_bench [n_rows] [m]

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

using clk = std::chrono::steady_clock;

static double bench(const char* name, int iters, double rows,
                    float (*fn)(), float* sink) {
  // warmup
  *sink += fn();
  auto t0 = clk::now();
  for (int i = 0; i < iters; ++i) *sink += fn();
  double s = std::chrono::duration<double>(clk::now() - t0).count() / iters;
  double mrps = rows / s / 1e6;
  std::printf("%-12s %8.3f ms/scan  %8.1f Mrows/s\n", name, s * 1e3, mrps);
  return mrps;
}

static int N = 1 << 20;
static int M = 16;
static std::vector<uint8_t> codes;      // (N, M) row-major (AoS)
static std::vector<uint8_t> codes_t;    // (M, N) transposed (SoA)
static std::vector<float> lut;          // (M, 256)
static std::vector<float> dist;

static float scan_scalar() {
  float best = 1e30f;
  for (int r = 0; r < N; ++r) {
    float d = 0.f;
    const uint8_t* c = &codes[static_cast<size_t>(r) * M];
    for (int m = 0; m < M; ++m) d += lut[m * 256 + c[m]];
    dist[r] = d;
    if (d < best) best = d;
  }
  return best;
}

static float scan_unrolled() {
  float best = 1e30f;
  for (int r = 0; r < N; ++r) {
    const uint8_t* c = &codes[static_cast<size_t>(r) * M];
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    int m = 0;
    for (; m + 4 <= M; m += 4) {
      d0 += lut[(m + 0) * 256 + c[m + 0]];
      d1 += lut[(m + 1) * 256 + c[m + 1]];
      d2 += lut[(m + 2) * 256 + c[m + 2]];
      d3 += lut[(m + 3) * 256 + c[m + 3]];
    }
    float d = d0 + d1 + d2 + d3;
    for (; m < M; ++m) d += lut[m * 256 + c[m]];
    dist[r] = d;
    if (d < best) best = d;
  }
  return best;
}

static float scan_soa() {
  // SoA sweep: accumulate one sub-quantizer across all rows per pass —
  // the memory-order twin of the TPU kernel's (m, n) layout.
  for (int r = 0; r < N; ++r) dist[r] = 0.f;
  for (int m = 0; m < M; ++m) {
    const uint8_t* c = &codes_t[static_cast<size_t>(m) * N];
    const float* l = &lut[m * 256];
    for (int r = 0; r < N; ++r) dist[r] += l[c[r]];
  }
  float best = 1e30f;
  for (int r = 0; r < N; ++r)
    if (dist[r] < best) best = dist[r];
  return best;
}

int main(int argc, char** argv) {
  if (argc > 1) N = std::atoi(argv[1]);
  if (argc > 2) M = std::atoi(argv[2]);
  std::mt19937 rng(0);
  codes.resize(static_cast<size_t>(N) * M);
  for (auto& c : codes) c = static_cast<uint8_t>(rng());
  codes_t.resize(codes.size());
  for (int r = 0; r < N; ++r)
    for (int m = 0; m < M; ++m)
      codes_t[static_cast<size_t>(m) * N + r] =
          codes[static_cast<size_t>(r) * M + m];
  lut.resize(M * 256);
  std::uniform_real_distribution<float> uf(0.f, 1.f);
  for (auto& v : lut) v = uf(rng);
  dist.resize(N);

  std::printf("ADC scan: N=%d rows, M=%d (code bytes/row)\n", N, M);
  float sink = 0.f;
  bench("scalar", 5, N, scan_scalar, &sink);
  bench("unrolled", 5, N, scan_unrolled, &sink);
  bench("soa", 5, N, scan_soa, &sink);
  std::printf("(sink %.3f)\n", sink);
  return 0;
}
