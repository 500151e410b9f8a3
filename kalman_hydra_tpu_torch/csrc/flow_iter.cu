// K2 and K6: one fine-level Farneback iteration with the select-sum warp,
// for one frame pair (K2) or for B pairs of one frame stack (K6).
//
// Replaces kalman_hydra_tpu/kernels/flow_iter_pallas.py::flow_iter
// (_flow_iter_kernel, _tile_body, _box_solve) and ::flow_iter_pairs
// (_flow_iter_pairs_kernel). The per-pixel math is csrc/flow_iter.cuh, the
// tile body csrc/flow_tile.cuh. K2 is K6 with one pair: both launch the
// same kernel, so a batched launch equals its per-pair launches bit for
// bit. Pair b reads frames p and p + 1 of the stack, p = b + b / ppc when
// ppc (pairs per clip) chains clips end to end, else p = b; both frames
// are read in place, with no gathered copy.
//
// Bound on Hopper: memory. At 1080p bf16 one iteration must move 20 B/px
// of planes and 16 B/px of flow in and out (75 MB, 22 us at 3.35 TB/s);
// the function needs ~136 FLOPs per pixel with the box window as sliding
// sums (0.28 GFLOP, 4 us at 67 TFLOP/s f32), well below that. This code
// sums every tap (~420 FLOPs per pixel at winsize 15, 13 us at the f32
// rate), because K5, K8 and K13 sum the same taps in the same order and
// all of them must agree bit for bit.
//
// Design: ONE launch per iteration, grid = (column tiles, row tiles,
// pairs), one block of 256 threads per 32 x 64 output tile (two blocks an
// SM), the three steps fused in shared memory (flow_tile.cuh's
// pairs_tile_kernel with the select-sum SelectSumM, the kernel K8 runs
// with the exact gather): M and its
// vertical pass never reach device memory, so a call moves the 36 B/px
// the function needs plus the halo's reads, which hit L1/L2. The price is
// recomputing M on the halo: (TH + 2 bw)(TW + 2 bw) / (TH TW), 1.75x at
// 32 x 64 and winsize 15. The kernel runs far above both bounds: its time
// goes to M's 29 loads a pixel (20 of them gathers of R1), times the
// halo (PERF.md). The warp is two
// clamped indexed loads per tap instead of the TPU's (2D+2)-term select
// chain (gathers are cheap here; the chain was a workaround for TPU
// gathers). The window's taps are the launch's parameters, a build for
// 15 taps (every configuration's winsize) and one for any other count;
// a window wider than 61 takes a smaller tile or, from winsize 101, M in
// device memory (flow_tile.cuh).
#include "flow_tile.cuh"

// Pair b (b < pairs) reads R0 + p * 5hw and R1 + p * 5hw (p as above;
// K2 passes pairs = 1, ppc = 0, K6 passes R1 = R0 + 5hw; row0 and img_h
// K2's band mode, the planes and flow a row slab whose row 0 is row row0
// of an image img_h rows tall (flow_tile.cuh::SelectSumM; a full frame
// passes row0 = 0, img_h = h). Planes bf16
// [bf16 = 1] or f32; flow (pairs, 2, h, w) f32; wts (taps,) f32 in HOST
// memory (copied into the launch's parameters) and, past 61 taps, in
// device memory too (wts_dev, else null); shape, the tile of
// kernels/flow_iter.py::tile_plan (0: 32 x 64; 1 ... 4 smaller, past 61
// taps; -1: M in device memory, in scratch (2, pairs, 5, h, w) f32, else
// null) and smem, one tile's dynamic shared memory in bytes, as the plan
// computes them; out (pairs, 2, h, w) f32.
KH_API int kh_flow_iter(const void* R0, const void* R1, int bf16, int pairs,
                        int ppc, const void* flow, int h, int w, int D,
                        int row0, int img_h, const void* wts,
                        const void* wts_dev, int taps, float post_scale,
                        int shape, int smem, void* scratch, void* out,
                        void* stream) {
  // the slab must hold at least one of the image's rows
  if (h <= 0 || w <= 0 || !kh::fi::window_ok(taps, wts_dev) || D < 0 ||
      pairs <= 0 || ppc < 0 || pairs > 65535 || img_h <= 0 ||
      row0 >= img_h || row0 + h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return kh::fi::run_pairs(
      R0, R1, bf16, pairs, ppc, flow, h, w,
      kh::fi::SelectSumM{static_cast<float>(D), row0, img_h},
      kh::fi::make_window(wts, taps, post_scale, wts_dev), shape, smem,
      scratch, out, static_cast<cudaStream_t>(stream));
}
