// K8: one exact-warp Farneback iteration, the bilinear gather of R1 by the
// prior flow included: R0 and the UNWARPED R1 (5, h, w), the flow
// (2, h, w) -> the new absolute flow (2, h, w) f32.
//
// Replaces the reference's _warp_poly_planar + flow_update pair
// (kalman_hydra_tpu/ops/farneback.py:525-528): the Pallas kernel
// kalman_hydra_tpu/kernels/flow_update_pallas.py::flow_update
// (_flow_update_kernel) takes R1 already warped, because the TPU's
// gathers are slow and the reference leaves the gather to XLA. Here the
// gather runs inside the kernel, on R1 read in place. Per pixel: R1
// sampled at (r + dy, c + dx) by flow_iter.cuh::exact_warp (clamped to the
// image, no displacement clamp, each step rounded on its own as the plain
// gather ops/warp.py::warp_poly_planar rounds it), M from R0, that sample
// and the flow, damped by OpenCV's 5-px border taper; the window (K8's own
// taps: float32(1/n) for the box, the cv2 Gaussian otherwise, no
// post-scale) over M with a replicate border, where the TPU kernel reads
// edge-padded slabs; then the solve. Planes bf16 or f32, widened on load;
// flow, M and all arithmetic f32.
//
// Bound on Hopper: memory. Each call must read R0, R1 (5 planes each) and
// the flow (2) and write the new flow (2): 56 B/px in f32, 116 MB at
// 1080x1920 (35 us at 3.35 TB/s). The function needs ~67 FLOPs per pixel
// for the gather, ~39 for M, ~21 for the solve and, with the box as
// sliding sums, 20 for the window (0.31 GFLOP, 5 us at 67 TFLOP/s f32),
// well below that; this code sums every tap.
//
// Design: ONE launch per iteration, the fused tile body of K2
// (flow_tile.cuh's pairs_tile_kernel: 32 x 64 output tiles, 256 threads,
// two blocks an SM, M on the tile and its window halo in shared memory,
// the vertical window in place, the horizontal window and solve from
// registers) with the exact gather as phase 1's source of M (ExactM). R1w,
// M, Mv and the gather's corner stacks never reach device memory; a call
// moves the 56 B/px the function needs plus the halo's and the gathers'
// reads, which hit L1/L2 (the kernel asks for the shared-memory carveout
// of two blocks, so that the rest of the SM stays L1). It replaces a
// design of four passes: the gather as ~40 plain torch ops (four corner
// stacks in device memory), then three launches with M and Mv through
// device memory. The gather follows the flow with no clamp, so its
// locality (L1 hits) depends on the flow.
//
// K8-pairs, the port's own pair variant (no TPU kernel: it replaces the
// reference's vmapped plain-XLA update_matrices_p, its exact gather
// included, and update_flow_p of the pair-batched exact warp,
// kalman_hydra_tpu/ops/farneback.py:633-640): the same kernel with the
// pair index in blockIdx.z, as K6 is K2's. Pair b reads R0 at frame p =
// b + b / ppc (ppc > 0 chains clips) or p = b of the plane stack and R1 at
// frame p + 1, both in place (no gathered copy), and its own flow and
// output. With round_m M is computed without fused multiply-adds
// (flow_iter.cuh::normal_eqs_exact) and rounded to bf16 (and back to f32),
// where the reference's update_matrices_p stores M in the bf16 plane
// dtype; the window and the solve stay f32 as there. K8 is the one-pair
// launch with two plane pointers and no rounding, so per-pair K8 equals
// K8-pairs (round_m = 0) bit for bit.
#include "flow_tile.cuh"

// K8: R0, R1 (5, h, w) bf16 [bf16 = 1] or f32, flow (2, h, w) f32; wts
// (taps,) f32 in HOST memory and, past 61 taps, in device memory too
// (wts_dev, else null); shape, smem and scratch ((2, 5, h, w) f32 at
// shape -1, else null) as kernels/flow_iter.py::tile_plan plans them
// (flow_tile.cuh::run_pairs); out (2, h, w) f32.
KH_API int kh_flow_update(const void* R0, const void* R1, int bf16,
                          const void* flow, int h, int w, const void* wts,
                          const void* wts_dev, int taps, int shape, int smem,
                          void* scratch, void* out, void* stream) {
  if (h < 2 || w < 2 || !kh::fi::window_ok(taps, wts_dev))
    return static_cast<int>(cudaErrorInvalidValue);
  return kh::fi::run_pairs(R0, R1, bf16, 1, 0, flow, h, w,
                           kh::fi::ExactM{0},
                           kh::fi::make_window(wts, taps, 1.f, wts_dev),
                           shape, smem, scratch, out,
                           static_cast<cudaStream_t>(stream));
}

// K8-pairs: pair b reads frames p, p + 1 of Rall (N, 5, h, w), p = b + b /
// ppc when ppc chains clips, else b; flow (pairs, 2, h, w); M rounded to
// bf16 where round_m; the rest as K8's (scratch (2, pairs, 5, h, w)).
KH_API int kh_flow_update_pairs(const void* Rall, int bf16, int pairs,
                                int ppc, const void* flow, int h, int w,
                                const void* wts, const void* wts_dev,
                                int taps, int round_m, int shape, int smem,
                                void* scratch, void* out, void* stream) {
  if (h < 2 || w < 2 || !kh::fi::window_ok(taps, wts_dev) ||
      pairs <= 0 || pairs > 65535 || ppc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* R1 = static_cast<const char*>(Rall) +
                   5L * h * w * (bf16 ? 2 : 4);       // frame 1
  return kh::fi::run_pairs(Rall, R1, bf16, pairs, ppc, flow, h, w,
                           kh::fi::ExactM{round_m != 0},
                           kh::fi::make_window(wts, taps, 1.f, wts_dev),
                           shape, smem, scratch, out,
                           static_cast<cudaStream_t>(stream));
}
