// Measurement variants of the ADC scan body for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of benchmarks/kernel_variants.py:
//
//   run_variant        (body _kernel)       -> chamjax_run_variant
//   run_block_variant  (body _kernel_block) -> chamjax_run_block_variant
//
// The TPU variants are the production scan's pipeline (double-buffered
// window copies started one window ahead) with one step changed, so that
// "production minus variant" prices that step.  Here every variant is the
// production scan's staged body (adc_scan_stage.cuh: 16-byte cp.async.cg
// staging of the code columns and the LUT row issued before any wait, two
// code slots so item i+1 is in flight while item i is summed, 32-bit reads
// of the staged rows with a funnel shift where a row is misaligned, four
// rows a thread, fp32 sums in order over j, 128 threads, registers for 12
// CTAs an SM) with the same one step changed, through the header's body
// hooks.  None reads `lens`: every window is seg rows.  For window w, L =
// LUT row lut_idx[w], c[j, r] = code at column starts[w] + r of code row j:
//
//   f32            the production body, f32 LUT (m, 256)        baseline
//   i32codes       codes int32 in memory and in the slots (a chunk of 256
//                  columns keeps a slot's bytes); no byte unpack  u8 unpack
//   bf16           packed LUT, 4-op decode                      decode ops
//   bf16_trim      the production body, packed LUT (3-op decode)
//   bf16_nodecode  sum_j f32 bits of the packed word c>>1        decode cost
//   bf16_trim_w4   four row quads a thread, 16 sums (64 registers)
//   bf16_trim_nodma  the LUT staged, no code copy issued; code 0 from
//                  q * never (never = 0, unknown to the compiler) code traffic
//   bf16_min       lane_l1's pass, min only, (bW, 128) out       output writes
//   bf16_mxu       pass 1 decodes an item (512 columns) into shared memory,
//                  pass 2 sums it over m                     decode vs reduce
//   nosum          L[0, c[0,r] & 127]; rows j > 0 gathered, XORed into a
//                  sink stored only if never != 0                the sum
//   nogather       sum_j c[j,r] as f32 (integer adds)            the gather
//   dma_only       out[w, r] = c[0, r % 128]; every code copied  code traffic
//   bytes_f32/_bf16     the same word reads, permuted store
//                  out[w, b*(seg/4) + f] = dist(row 4f + b)    output order
//   i32view_f32/_bf16   the same, codes given as an (m, n/4) int32 view
//   block_bf16t    the staged ring over the seg-tiled (n/seg, m, seg)
//                  layout (adc_scan_tiles' route), packed LUT, tile
//                  starts[w]/seg
//   contig_bf16t   the same, the whole contiguous (m, seg) tile in ONE
//                  bulk copy (cp.async.bulk, the TMA's non-tensor form)
//                  completed on an mbarrier, then the compute  ring vs one copy
//
// The bf16_mxu reduction is plain shared-memory sums, in order over j (the
// TPU twin's MXU dot with a ones row; an mma.sync with a ones operand
// would sum the 16 entries of m in the tensor core's order instead).
// SASS (chamjax_torch/benchmarks/sass_report.py --match adc_scan_variants):
// no variant loads codes with byte-wide global loads (LDG.E.U8): the code
// bytes arrive by LDGSTS.128, or by one UBLKCP for contig_bf16t (with the
// SYNCS mbarrier ops); bf16_trim_nodma issues only the LUT row's copies.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32; benchmarks/
// bounds.py::variant_bound): what each function needs, each byte once.  At
// the study's full width (bW 4096, m 16, seg 2048, random windows over a
// 16M-column slab, 4096 LUT rows) the f32 body reads 134 MB of codes, 64
// MB of distinct LUT rows and writes 34 MB: 0.0539 ms; block_bf16t 0.0475
// (its distinct tiles, packed rows); the 134M adds take 2 us.  Bound by
// bytes.  The smoke's phase-2 shape (a 2^20-column slab) repeats columns,
// so its bounds are lower: 0.0275 and 0.0213 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan_stage.cuh"
#include "launch.cuh"

namespace {

using namespace chamjax_stage;

enum Variant : int {
  kF32 = 0,
  kI32Codes = 1,
  kBf16 = 2,
  kBf16Trim = 3,
  kBf16NoDecode = 4,
  kBf16TrimW4 = 5,
  kBf16TrimNoDma = 6,
  kBf16Min = 7,
  kBf16Mxu = 8,
  kNoSum = 9,
  kNoGather = 10,
  kDmaOnly = 11,
  kBytesF32 = 12,
  kBytesBf16 = 13,
  kI32ViewF32 = 14,
  kI32ViewBf16 = 15,
  kContigBf16t = 16,
  kBlockBf16t = 17,
};

bool word_strides(int v) {
  return v == kBytesF32 || v == kBytesBf16 || v == kI32ViewF32 ||
         v == kI32ViewBf16;
}

using LaunchFn = cudaError_t (*)(StageArgs, cudaStream_t);

// The staged body of a variant: <packed LUT, output, body, flat layout>,
// lens unread.
template <bool kPacked, int kOut, int kBody, bool kFlat>
constexpr LaunchFn kStudy = &launch_staged<kPacked, kOut, kBody, kFlat, false>;

LaunchFn pick(int v) {
  switch (v) {
    case kF32:           return kStudy<false, kOutF32, kBodyAdc, true>;
    case kI32Codes:      return kStudy<false, kOutF32, kBodyI32, true>;
    case kBf16:          return kStudy<true, kOutF32, kBodyDecode4, true>;
    case kBf16Trim:      return kStudy<true, kOutF32, kBodyAdc, true>;
    case kBf16NoDecode:  return kStudy<true, kOutF32, kBodyNoDecode, true>;
    case kBf16TrimW4:    return kStudy<true, kOutF32, kBodyW4, true>;
    case kBf16TrimNoDma: return kStudy<true, kOutF32, kBodyNoDma, true>;
    case kBf16Min:       return kStudy<true, kOutMin, kBodyAdc, true>;
    case kBf16Mxu:       return kStudy<true, kOutF32, kBodyMxu, true>;
    case kNoSum:         return kStudy<false, kOutF32, kBodyNoSum, true>;
    case kNoGather:      return kStudy<false, kOutF32, kBodyNoGather, true>;
    case kDmaOnly:       return kStudy<false, kOutF32, kBodyDmaOnly, true>;
    case kBytesF32:
    case kI32ViewF32:    return kStudy<false, kOutPermuted, kBodyAdc, true>;
    case kBytesBf16:
    case kI32ViewBf16:   return kStudy<true, kOutPermuted, kBodyAdc, true>;
    case kContigBf16t:   return kStudy<true, kOutF32, kBodyContig, false>;
    case kBlockBf16t:    return kStudy<true, kOutF32, kBodyAdc, false>;
    default:             return nullptr;
  }
}

int run(const void* codes, long long stride, const void* starts,
        const void* lut_idx, const void* luts, void* out, int bw, int m,
        int seg, int variant, int never, void* stream) {
  const LaunchFn go = pick(variant);
  if (!go || bw <= 0 || m <= 0 || seg <= 0 || seg % kLanes ||
      ((variant == kBf16TrimW4 || word_strides(variant)) && seg % 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StageArgs a{};
  a.codes = static_cast<const uint8_t*>(codes);
  // the flat row stride in codes (bytes_* and i32view_* give it in words)
  a.n_cols = word_strides(variant) ? 4 * stride : stride;
  a.where = static_cast<const int32_t*>(starts);
  a.lut_idx = static_cast<const int32_t*>(lut_idx);
  a.luts = static_cast<const uint32_t*>(luts);
  a.out = out;
  a.bw = bw;
  a.m = m;
  a.width = seg;
  a.never = never;
  return static_cast<int>(go(a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; each launch goes on `stream` and does not synchronise.  Each
// returns a cudaError_t (0 = success).  `never` must be 0.

// codes: (m, n) uint8, (m, n) int32 for i32codes, (m, n/4) int32 for
// i32view_*, (n/seg, m, seg) uint8 for contig_bf16t.  `stride` is the row
// stride of the flat layouts in elements: n, or n/4 for bytes_* and
// i32view_*, whose rows are read as 32-bit words.
extern "C" int chamjax_run_variant(const void* codes, long long stride,
                                   const void* starts, const void* lut_idx,
                                   const void* luts, void* out, int bw, int m,
                                   int seg, int variant, int never,
                                   void* stream) {
  if (variant == kBlockBf16t) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes, stride, starts, lut_idx, luts, out, bw, m, seg, variant,
             never, stream);
}

// codes_tiled: (n/seg, m, seg) uint8; starts are row starts (multiples of
// seg), tile = starts[w] / seg.
extern "C" int chamjax_run_block_variant(const void* codes_tiled,
                                         const void* starts,
                                         const void* lut_idx,
                                         const void* luts, void* out, int bw,
                                         int m, int seg, int never,
                                         void* stream) {
  return run(codes_tiled, 0, starts, lut_idx, luts, out, bw, m, seg,
             kBlockBf16t, never, stream);
}
