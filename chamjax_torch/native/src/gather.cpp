// Copied verbatim from chamjax/native/src/gather.cpp (the port keeps its own copy).
// Native window-slab gather for the host-streamed serving tier.
//
// The host half of the FPGA's PQ-code streamer (the reference keeps codes
// in U250 DRAM and streams only the probed lists through the ADC pipeline,
// SRC/DRAM_utils.hpp:104-185): given the device-planned window table
// (starts, lens), copy each probed window's code/id rows out of the
// host-RAM/memmap-resident packed arrays into the staging slab that is
// uploaded to HBM.  Windows are contiguous row ranges of the row-major
// (n_pad, m) code array, so each window is one memcpy — the Python
// fallback (chamjax/streamed.py::HostStreamedSearcher._stage) pays ~5 us
// of interpreter overhead per window on top, which dominates at 32 KB
// slabs and caps the gather near 2 GB/s; this loop runs at memcpy speed.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstring>

extern "C" {

// Gather bw windows of up to `seg` rows each.
//   codes:      (n_pad, m) uint8, row-major
//   ids:        (n_pad,) int32
//   starts/lens:(bw,) int32 — global row offsets / row counts.  lens only
//               gates skipping (lens <= 0 -> whole window filled); when
//               lens > 0 the copy is min(seg, n_pad - start) rows — full
//               window slabs including rows past lens, which the device
//               kernel masks by length (identical to the Python loop)
//   slab_codes: (bw, seg, m) uint8 out — tail rows zero-filled
//   slab_ids:   (bw, seg) int32 out — tail rows set to -1
// Returns total rows copied, or -1 on bad arguments.
long long cham_gather_windows(const uint8_t* codes, const int32_t* ids,
                              long long n_pad, int m, int seg,
                              const int32_t* starts, const int32_t* lens,
                              long long bw, uint8_t* slab_codes,
                              int32_t* slab_ids) {
  if (!codes || !ids || !starts || !lens || !slab_codes || !slab_ids ||
      n_pad < 0 || m <= 0 || seg <= 0 || bw < 0) {
    return -1;
  }
  const size_t row_bytes = static_cast<size_t>(m);
  const size_t win_bytes = static_cast<size_t>(seg) * row_bytes;
  long long total = 0;
  for (long long w = 0; w < bw; ++w) {
    uint8_t* out_c = slab_codes + static_cast<size_t>(w) * win_bytes;
    int32_t* out_i = slab_ids + static_cast<size_t>(w) * seg;
    const long long ln = lens[w];
    const long long s = starts[w];
    long long rows = 0;
    if (ln > 0 && s >= 0 && s < n_pad) {
      rows = n_pad - s;
      if (rows > seg) rows = seg;
      std::memcpy(out_c, codes + static_cast<size_t>(s) * row_bytes,
                  static_cast<size_t>(rows) * row_bytes);
      std::memcpy(out_i, ids + s, static_cast<size_t>(rows) * sizeof(int32_t));
      total += rows;
    }
    if (rows < seg) {  // tail fill (skipped windows fill entirely)
      std::memset(out_c + static_cast<size_t>(rows) * row_bytes, 0,
                  static_cast<size_t>(seg - rows) * row_bytes);
      std::memset(out_i + rows, 0xFF,
                  static_cast<size_t>(seg - rows) * sizeof(int32_t));
    }
  }
  return total;
}

// Codes-only variant: the round-4 streamed tier never uploads id slabs —
// the device returns top-k POSITIONS into the staged slab and the host
// maps them back through its own (any-dtype, possibly int64/memmap) id
// array, so ids never cross the link and no int32 shadow copy exists.
long long cham_gather_codes(const uint8_t* codes, long long n_pad, int m,
                            int seg, const int32_t* starts,
                            const int32_t* lens, long long bw,
                            uint8_t* slab_codes) {
  if (!codes || !starts || !lens || !slab_codes ||
      n_pad < 0 || m <= 0 || seg <= 0 || bw < 0) {
    return -1;
  }
  const size_t row_bytes = static_cast<size_t>(m);
  const size_t win_bytes = static_cast<size_t>(seg) * row_bytes;
  long long total = 0;
  for (long long w = 0; w < bw; ++w) {
    uint8_t* out_c = slab_codes + static_cast<size_t>(w) * win_bytes;
    const long long ln = lens[w];
    const long long s = starts[w];
    long long rows = 0;
    if (ln > 0 && s >= 0 && s < n_pad) {
      rows = n_pad - s;
      if (rows > seg) rows = seg;
      std::memcpy(out_c, codes + static_cast<size_t>(s) * row_bytes,
                  static_cast<size_t>(rows) * row_bytes);
      total += rows;
    }
    if (rows < seg) {
      std::memset(out_c + static_cast<size_t>(rows) * row_bytes, 0,
                  static_cast<size_t>(seg - rows) * row_bytes);
    }
  }
  return total;
}

}  // extern "C"
