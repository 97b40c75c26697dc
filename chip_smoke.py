"""Chip smoke test of the PyTorch / H100 port (``kornia_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kornia_tpu_torch/csrc`` with nvcc
(sm_90a), then:

1. holds each kernel of the two-view path against its plain PyTorch
   version on random CUDA tensors at the path's shapes, each blur on the
   route ROUTES names, and the patch kernel (both modes) also on streams
   that are ragged, at 4-byte offsets, one sample long or empty;
2. drives ``two_view_pose`` on the benchmark's input (a blurred random
   480x640 image and its 4 px shift, 1024 features) on the card, with every
   launch counter reset just before and read just after, checks the pose,
   the launch list and the route (tiled kernel or two passes) each blur
   took, and times pairs and stages, and the device's busy share of a pair
   (with ``--profile-out DIR``, the profiler's table goes to
   DIR/twoview_profile.txt); every kernel call of a pair is captured and
   held against its plain version, each kernel's device time a pair is
   set beside the sum of its launches' bounds, and the kernels line times
   kernel, plain version and (where one exists) the single PyTorch call
   that computes the same function on the pair's largest call of each
   kernel: device time summed by torch.profiler, the L2 flushed before
   each call. Every later step builds its entries of the kernels line the
   same way (counted_run, device_profile, capture_launches,
   check_captured, path_kernel_times, captured_entry);
3. runs the port at 256x256 with 512 features on the card and on the CPU
   with the same injected RANSAC noise and compares the results;
4. train: five Adam steps (lr 1e-2) on the SSIM loss at (8, 3, 480, 640),
   then one backward of the squared DoG levels through ScalePyramid at
   480x640, counting the blur adjoints' launches and routes; the card's
   gradients against the CPU's, each adjoint kernel against its plain
   adjoint at the SSIM shape and at every octave, with its route;
5. match: the streaming SMNN matcher on two 8192x128 descriptor sets, its
   peak memory, its result against the dense matcher on the card, and the
   streaming kernel against its plain version;
6. fast_patches: ``two_view_pose`` with ``SIFTFeature(fast_patches=True)``
   (bf16 patch sampling), the pose check of step 2, its per-pair device
   time of each kernel, each captured call against its plain version, and
   the bf16 kernel against the exact kernel;
7. backend: the SLAM optimisation back end, which runs no kernel of its
   own: dense LM bundle adjustment at bench.py's configuration (50
   cameras, 2,000 points, 10,000 observations; iterations/s reckoned as
   bench.py does, peak memory, the device's idle share, no host sync
   inside the loop, the same call on the CPU), sparse-Schur BA on the same
   problem and at SfM scale (100 / 20,000 / 120,000, every point at least
   DIST_MIN_DEPTH in front of the cameras that see it) against the dense
   path, each LM run's last cost at least DIST_FALL_RTOL below its first
   step's, the Se3 and Sim3 pose graphs on a 2,048-pose ring (a 256-pose
   ring against the CPU), pnp_ransac on 2,000 points with 30% outliers,
   and incremental_sfm at 12 views x 2,000 points (against the CPU). It
   prints one JSON line of its own;
8. planar: ``HomographyTracker(num_features=512)`` (GFTT corners, RootSIFT,
   SMNN, homography RANSAC) tracks the 480x640 benchmark image through 8
   frames warped by a fixed, seeded sequence of homographies: every frame
   must succeed with its estimated homography within 1 px (mean) and 2 px
   (max) of the true one at the image corners; the first two frames run on
   the CPU port too, with the same injected RANSAC noise; ms per frame,
   stages, the device's busy share, each ported kernel's device time per
   frame beside its bound, and the structure tensor's blurs (depth 6, every
   octave) and SIFTFeatureScaleSpace's 960x1280 octave against their plain
   versions on their named routes. It prints one JSON line of its own;
9. vo: visual odometry and loop closure (BASELINE config 3). A room
   (tex_size 512) is made and rendered on the card; the walk (100 frames of
   ``walk_trajectory``, degraded) runs through ``VisualOdometry(num_features=
   512, ransac_iters=32, ransac_batch=256, incremental_ba=False,
   global_ba_passes=6)`` with ``refine=True``: frames/s over the whole run,
   the tracking time of each frame, the global BA's time, keyframes and
   the ATE (at most 5% of the path). The tracking step's stages are timed
   on its first frames; the closed circuit (48 frames of
   ``loop_trajectory``) runs and ``close_loops`` must accept an edge 12 or
   more frames apart without raising the ATE by more than 0.05 m; the first
   4 frames run on the CPU port too with the same injected noise (the same
   keyframes and branch choices, rotations within 1e-3 rad, inlier counts
   within 2%); 5 tracked frames are profiled (device busy, idle share, each
   ported kernel's device time a frame beside its bound), and each kernel
   is held against its plain version on a rendered frame. It prints one
   JSON line of its own;
10. learned: learned local features and dense matching. (a) BASELINE
   config 2: ``two_view_pose`` with SIFTFeature's DoG detector, the gradient
   orientation (19²) and HardNet on 32² patches, at 480x640/1024f, RANSAC
   256 x 32: ms per pair, stages, the device's busy share and kernels per
   pair, each kernel's launches, device time and bound per pair, the pose
   (for information: the weights are untrained); (b) GFTTAffNetHardNet and
   HesAffNetHardNet through ``match_pair`` at 480x640/1024f with autograd
   on; each kernel call of (a) and (b) captured and held against its plain
   version; (c) ``LoFTR(LoFTRConfig())`` (coarse 256, fine 128, 4 + 1 layer
   pairs, 8 heads, top_k 512) on the same pair: ms per pair, peak memory,
   busy share, valid matches and their essential-RANSAC pose (for
   information); then config 2 and GFTTAffNetHardNet at 256x256/512f on the
   card and on the CPU port with the same injected noise (the same
   keypoints, LAFs within 1e-4 of their largest entry, descriptors of the
   same LAFs within 1e-4, 99% of matches equal, inlier counts within 2%),
   and LoFTR at 240x320 on both (maps, tokens and confidences within 1e-4
   of their largest entry; the fine stage fed the CPU's coarse matches,
   keypoints within 1e-3 px). It prints one JSON line of its own;
11. keynet_stereo: (a) ``KeyNetAffNetHardNet(2048)`` (Key.Net's published
   width: 8 filters, 3 levels, kernel 5; the default detector config: 4
   pyramid levels, 1 up level, NMS 15) through ``two_view_pose`` at 480x640,
   RANSAC 256 x 32, and ``KeyNetHardNet(2048)`` through ``match_pair`` with
   autograd on: ms per pair, stages, busy share, kernels and each kernel's
   launches, device time and bound per pair, every kernel call captured and
   held against its plain version on the route ROUTES lists; card vs CPU
   at 256x256/512f (Key.Net's response, keypoints, LAFs, descriptors of the
   same LAFs, matches). (b) stereo depth on a rendered rectified pair
   (the room of step 9, f = 0.8 W, 0.12 m baseline) at 480x640:
   ``undistort_image`` with a fixed Brown-Conrady distortion (timed, card
   vs CPU), both distortion models' round trips on the pixel grid (1e-3
   px), then ``stereo_matching`` (D = 64, window 9, soft-argmin, LR check),
   ``disparity_to_depth``, the Q-matrix points, ``depth_to_3d``,
   ``depth_to_normals`` and ``warp_frame_depth``: ms per stage and whole,
   peak memory, the LR-valid share and the median disparity error against
   the renderer's depth (the winner's within 2 px); card vs CPU at 120x160,
   D = 16. (c) ``ImageStitcher()`` on two 480x640 views 280 px apart: ms,
   the homography within 1 px of the true shift, the left view kept, the
   right view's columns within 1% of the source. It prints one JSON line of
   its own;
12. distributed: the communication runtime (``kornia_tpu_torch.parallel``,
   BASELINE config 5) over SPMD ranks: one NCCL rank in this process, and
   2 and 4 gloo ranks sharing the card (``spmd.spawn``; NCCL refuses two
   ranks on one card, so one card shows equivalence, not scaling). Each row
   reports the backend, the world size, ms per LM iteration (per forward for
   LoFTR) and iterations/s, the bytes all-reduced per iteration, the share
   of a call spent inside collectives, and every rank's peak memory: (a)
   dense distributed BA at benchmarks/scaling_bench.py:39-80's protocol (C
   = 8, 64 points a rank, 6 iterations) at D = 1, 2, 4, its costs falling,
   D = 4's RMS within 0.05 px of the single-device call's, every rank's
   state bitwise rank 0's; (b) sparse distributed BA at 100 / 20,000 /
   120,000 (point_chunk 512, λ 0.1, 3 iterations) at D = 1 and 4, costs
   falling, the first reduced camera systems within 1e-4 of the largest
   entry; (c) at D = 4 the dense and streaming pose graphs on a 256-pose
   circuit (agreeing with each other and with ``optimize_pose_graph``:
   translations 1e-3, |q·q'| 1e-5 of 1) and the streaming one on a
   2,048-pose circuit, which the dense path must refuse; (d) LoFTR's
   context-parallel coarse stage at 4,800 tokens (``LoFTRConfig()``) at D =
   1 and 4 within 1e-4 of ``_transformer``; (e) ``run_restartable`` over 6
   dense-BA LM steps stopped at step 5 and resumed from ``step_4``, within
   1e-5 of an uninterrupted run, and a bitwise checkpoint round trip. It
   prints one JSON line of its own;
13. tracking_io: (a) ``ByteTracker()`` at its defaults (capacity 128)
   over a seeded synthetic stream with MOT17-02's geometry (1920x1080, 600
   frames, about 60 pedestrians alive, 8 false positives a frame, rows
   padded to 128): every update under ``no_host_sync``, ms a frame (median
   and 90th percentile), frames/s, kernels a frame, the device's busy
   share over 20 frames, peak memory; the first 150 frames against the
   CPU port (the same ids and valid masks, boxes within 1e-3 of the largest
   coordinate) and an identity check against the stream's ground truth.
   (b) ``BoxTracker`` with a detector that returns (a)'s detections, with
   and without ``visualize`` on a 1080x1920 frame for 60 frames, its draw
   equal to the CPU port's. (c) A 30-frame TUM RGB-D sequence and a
   10-frame KITTI odometry sequence rendered from step 9's room, written
   to a temporary directory and read back through ``TUMSequence`` and
   ``KittiOdometrySequence`` (decoded frames bit for bit, poses within
   1e-6; the decoder used and ms a window), then ``two_view_pose`` on two
   decoded frames, equal to the same call on the frames before they were
   written, every kernel call captured and held against its plain version
   on its ROUTES route. It prints one JSON line of its own;
14. image_ops: the image-op layer (``ops/`` and ``core/``). (a)
   benchmarks/per_op.py:73-116's sweep of 33 ops with its arguments at its
   regime (32 x 3 x 256 x 256, uniform on [0, 1) from a seeded generator):
   per op the device time from a cold L2, the synchronised host time, img/s
   and GB/s as per_op.py:139-142 reckons them (from the host time), the
   peak memory; the geomean img/s (per_op_geomean_throughput, and from the
   device times) and the device's busy share of one whole sweep; canny's
   hysteresis steps and host reads a call. (b) the rest of the slice at the
   shapes its users run: CLAHE (8x8, clip 40) both modes and the JPEG codec
   at quality 50 with one backward on (a)'s batch; the antialiased resize
   to 540x960 and 256x256, nearest resize, bicubic grid_sample with
   reflection, elastic_transform2d at its defaults, a 16-point thin-plate
   spline and a 5x5 median on one 1080x1920 frame; deform_conv2d at
   ALIKED-n16's DCN shapes (60x80: 32 -> 64, 64 -> 64; 15x20: 64 -> 128);
   warp_affine3d and rotate3d on a (1, 1, 64, 128, 128) volume; non-flat
   5x5 dilation and erosion and a 4-level Laplacian pyramid on (a)'s batch;
   a colour map on a 1080x1920 depth map: device and host ms and peak
   memory each. (c) each op of (a) and (b) on the batch's first two images
   (or the whole frame or volume) on the CPU port too, at the CPU tests'
   tolerances (canny's edges bit for bit), and card-vs-CPU gradients of the
   JPEG codec, bilateral_blur, warp_affine, the antialiased resize and
   deform_conv2d at 1e-4 of the largest. (d) every fused blur of (a) and
   (b), and every band adjoint of the JPEG codec's backward, captured and
   held against its plain version on its ROUTES route, their device time
   and bound. It prints one JSON line of its own;
15. registration_eval: the rest of geometry, the losses, metrics and
   contrib operators. (a) ``ImageRegistrator("homography", 300, 1e-2, 3)``
   (tests/test_registration_vo.py:22-23) registers a 480x640 RGB frame of
   step 9's room to the same frame warped by 5° about its centre and 2 px
   (ibid. :16-20): the photometric error below 0.35 of the initial one
   (ibid. :29), ms a registration, ms, kernels and busy share of an Adam
   iteration at each level (a level replays one captured step as a CUDA
   graph; a step makes no host read), the busy share of a registration,
   peak memory, and the coarsest level's first 5 steps against the CPU
   port (1e-4) with the mask pixels that differ. (b) five Adam steps on
   ``ms_ssim_loss`` at (8, 3, 480, 640), the card's gradient against the
   CPU's. (c) the confusion matrix and IoU with 19 classes on (4, 1024,
   2048) labels (Cityscapes), ``aepe`` on (4, 2, 436, 1024) flows
   (MPI-Sintel), the three disparity errors on (4, 375, 1242) (KITTI 2015)
   and mAP of 100 boxes against 20 in 80 classes, card against the CPU
   port (integer results bit for bit, 1e-5 relative elsewhere). (d) the
   distance transform at 1080x1920 (1,920 steps, no host read; against
   the CPU port at 270x480), connected components (100 steps), the
   Hausdorff loss (4 classes, 256x256), ``KMeans(8)`` on the frame's
   pixels from injected initial centres and the 3-D quadratic fit and NMS
   of a (1, 1, 5, 480, 640) DoG stack, against the CPU port. Every fused
   blur (the pyramid's, MS-SSIM's five scales) and band adjoint (MS-SSIM's
   backward) of the path captured and held against its plain version on
   its ROUTES route. It prints one JSON line of its own;
16. augmentation: the augmentation layer and the dissolving diffusion
   model, on the training-data pipelines its users run, each timed on the
   host clock around synchronised calls (median of 5) with items a second,
   the device's busy share, kernels a call and peak memory: (a) two
   SimCLR views (RandomResizedCrop 224, flip, ColorJiggle(0.8, 0.8, 0.8,
   0.2, p=0.8), grey p=0.2, Gaussian blur 23 p=0.5, solarize p=0.2,
   ImageNet normalisation) of 256 x 3 x 256 x 256 from a device generator,
   the forward under no_host_sync; (b) a detection and segmentation batch
   (16 x 3 x 512 x 512, a label mask, 20 boxes and 50 keypoints an image)
   through flip, affine, perspective, elastic, box blur and JPEG with every
   data key, then its inverse: the forward under no_host_sync, the
   keypoints mapped back within 1e-2 px; (c) RandAugment(2, 10),
   TrivialAugment and AutoAugment (imagenet, cifar10) at 64 x 3 x 224 x
   224; (d) VideoSequential on 8 x 3 x 16 x 112 x 112 clips (one matrix a
   clip) and PatchSequential (4 x 4) at 32 x 3 x 224 x 224; (e) the
   volumetric ops at 4 x 1 x 64 x 128 x 128; (f) ADA at p = 0.6 with a
   backward and an update, and a differentiable box blur, jitter, affine
   and JPEG pipeline with its backward at 64 x 3 x 256 x 256, Operation's
   magnitude gradients card vs CPU; (g) MixUp, CutMix, Mosaic, Jigsaw and
   transplantation at 64 x 3 x 224 x 224; (h) RandomDissolving at 4 x 3 x
   256 x 256 with the default configuration and SD 1.5's widths (seeded
   weights). Then every exported class, the containers and dispatchers,
   ADA, the policies and the diffusion model on the card and on the CPU
   port at 8 x 3 x 64 x 64 (volumes 2 x 1 x 16 x 32 x 32) with the same
   params, at the CPU tests' tolerances (the integer and selection ops bit
   for bit, each op's gradient in (f) at 1e-4 of the largest); the chains
   op by op on the CPU's input to each op, and the SimCLR view and (f)'s
   gradient end to end at the limits AUG_CHAIN_GAIN and
   AUG_CHAIN_GRAD_RTOL set out beside them. Every fused blur and band
   adjoint of (b)'s forward and inverse, (d)'s clips and (f)'s step
   captured and held against its plain version on its ROUTES route. It
   prints one JSON line of its own;
17. descriptors_matchers: the patch descriptors and matchers on bench.py's
   480x640 pair, each timed on the host clock around synchronised calls
   (median of 5) with stages, the device's busy share, kernels a call and
   peak memory. (a) ``SIFTFeature(num_features=1024)``'s LAFs; at them,
   ``get_laf_descriptors`` (32² patches) with HardNet8, TFeat, SOSNet,
   HyNet (published widths, seeded weights), MKDDescriptor without
   whitening and with 'pcawt' on a seeded whitening model, and
   SIFTDescriptor(32), each followed by ``match_smnn`` and the AdaLAM and
   FGINN ``GeometryAwareDescriptorMatcher``; LAFAffineShapeEstimator(32) on
   the LAFs and DenseSIFTDescriptor on both frames. (b) DISK (n = 2048,
   window 5) on the pair as RGB, then ``LightGlue(LightGlueConfig("disk"))``
   (9 layers, 256 wide, 4 heads) directly and through LightGlueMatcher.
   (c) ``LightGlue("doghardnet")`` on (a)'s HardNet8 descriptors with the
   LAFs' scales and orientations. Then the card against the CPU port on
   the same inputs: descriptors of the same patches within 1e-4, SMNN's
   matches 99% equal, AdaLAM's keep mask equal on the CPU's inputs to it,
   DISK's heatmap within 1e-4 of max(1, its largest) and its valid
   keypoints equal but at near ties (the top-n cut or the NMS window),
   LightGlue's log assignment within 1e-3 of its largest and its matches
   99% equal. Every patch_sample, fused blur and multi-level blur of (a)'s
   detection and description captured and held against its plain version
   on its ROUTES route. It prints one JSON line of its own.

Each of steps 2, 4, 5, 6, 8, 9, 10 (its paths (a) and (b)), 11 (each of
its paths), 13 (c), 14, 15, 16 and 17 resets the launch counters just before it
drives its path and reads them just after; every kernel must have launched on its path. Every failure exits non-zero.
The last lines are one JSON object with the kernels' numbers and
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2 before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, float32
# outside the tensor cores (the rate of the port's f32 blur and patch
# kernels) and dense TF32 on the tensor cores (the matcher's 3xTF32 split)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12
# more than the H100's 50 MB L2: written before each timed call, so that
# the call reads its inputs from HBM, as the byte bounds assume
L2_FLUSH_BYTES = 256 * 2**20

BLUR_ATOL = 1e-5   # [0, 1] images; f32 sums in another order and with FMA
PATCH_ATOL = 1e-5  # four-tap bilinear; FMA contraction only
BF16_ATOL = 1e-6   # bf16 kernel vs its plain version: the same roundings
BF16_VS_EXACT = 4e-3  # bf16 keeps 8 bits of the weights and the texels
GRAD_RTOL = 1e-4   # card vs CPU gradients, relative to the largest
MATCH_ATOL = 1e-5  # distances (at most 2 for unit rows) and ratios
TIE_RTOL = 1e-5    # rows whose two nearest lie this close may swap them
FAST_AGREE = 0.9   # share of matches that bf16 patches leave unchanged
H, W, NF = 480, 640, 1024  # bench.py's main two-view configuration
XH, XW, XNF = 256, 256, 512  # bench.py's second configuration
TRAIN_SHAPE, TRAIN_STEPS = (8, 3, 480, 640), 5
MATCH_N, MATCH_D = 8192, 128  # exhaustive SfM-style matching
SEED = 0
# the back end (step 7). Card and CPU sum in other orders (index_add_ with
# atomics, cuBLAS/cuSOLVER against LAPACK), and LM's accept/reject can take
# another path, so the back end's card-vs-CPU checks are tolerances:
BA_COST_RTOL = 1e-3    # final costs: card vs CPU port; sparse vs dense
BA_SYSTEM_RTOL = 1e-4  # the reduced camera systems of the sparse and the
#                        dense path from one state, of their largest entry
BA_QUAT_ATOL = 1e-4    # poses, card vs CPU: rotations, and camera centres
BA_CENTRE_ATOL = 1e-4  # after a Sim3 alignment (one fixed camera leaves
#                        the scale free: translations differ by about 1%)
PG_RING, PG_XCHECK = 2048, 256  # pose-graph ring sizes
PG_COST_ATOL = 1e-6    # of the first cost: costs at the rounding floor
PNP_MAX_DEG = 0.5      # pnp_ransac's rotation error, degrees
SFM_RMS_MAX, SFM_ATE_MAX = 0.8, 0.05  # tests/test_sfm.py:20,31
SFM_RMS_ATOL, SFM_CENTRE_ATOL = 1e-3, 1e-3  # incremental_sfm card vs CPU
# the planar tracker (step 8)
PLANAR_FRAMES, PLANAR_NF = 8, 512
PLANAR_XCHECK = 2      # frames also tracked by the CPU port (chained)
CORNER_MEAN_PX, CORNER_MAX_PX = 1.0, 2.0  # estimated vs true H at corners
XCHECK_CORNER_PX = 0.5     # card vs CPU port: corners, and inlier counts
XCHECK_INLIER_RTOL = 0.05  # within 5% of each other
ML_ATOL = 2e-6   # multi-level blur vs plain, as the multi-level legs hold it
GFTT_LEVELS = 6  # an octave's levels, folded into the structure tensor batch
# the route (csrc/banded_blur.cu: the tiled kernel, or two passes through
# device memory) each blur wrapper takes at each shape of its path, as
# PERF.md names them: (wrapper, height, width) -> route. The fused blur and
# its band adjoint are tiled at every path shape; the multi-level blur
# keeps the passes on the octaves whose tiled grid has under one block per
# SM; the multi-level adjoint (a block per tile, levels summed in it) is
# tiled where its grid fills the card at least as far as
# kornia_tpu_torch/ops/kernels.py::_ADJOINT_TILED_FILL says.
ROUTES = {
    ("multi_level_blur", 480, 640): "tiled",
    ("multi_level_blur", 240, 320): "tiled",
    ("multi_level_blur", 120, 160): "passes",
    ("multi_level_blur", 60, 80): "passes",
    ("multi_level_blur_adjoint", 480, 640): "tiled",
    ("multi_level_blur_adjoint", 240, 320): "passes",
    ("multi_level_blur_adjoint", 120, 160): "passes",
    ("multi_level_blur_adjoint", 60, 80): "passes",
    # the structure tensor's blurs of the GFTT detector, depth 6 (six
    # levels); large tiles at 480x640, small ones below
    ("fused_separable_blur2d", 480, 640): "tiled",
    ("fused_separable_blur2d", 240, 320): "tiled",
    ("fused_separable_blur2d", 120, 160): "tiled",
    ("fused_separable_blur2d", 60, 80): "tiled",
    # SIFTFeatureScaleSpace's doubled first octave, and its structure
    # tensor's and first level's blurs (step 10)
    ("multi_level_blur", 960, 1280): "tiled",
    ("fused_separable_blur2d", 960, 1280): "tiled",
}
# step 11, the fused blur (k = 5 reflect pyrdowns; k = 9 reflect box blurs):
# every pyrdown source of the Key.Net detector at 480x640 (its pyramid by
# sqrt 2, the 678x905 upscaled level, Key.Net's own pyramid by 1.2 inside
# each level) and of the 32² patch atlas; the stitcher's atlases down to
# 30x40; the stereo box blur (64 cost maps in one launch) at 480x640. Large
# tiles where the grid makes two blocks per SM, small ones below: tiled at
# every shape.
for _hw in [(678, 905), (565, 754), (480, 640), (400, 533), (339, 452),
            (282, 376), (240, 320), (239, 319), (199, 265), (168, 225),
            (140, 187), (120, 160), (118, 159), (98, 132), (60, 80),
            (30, 40)]:
    ROUTES[("fused_separable_blur2d", *_hw)] = "tiled"
# step 14, the fused blur: the per-op sweep's Gaussian (k = 3, 9), box (k =
# 5), canny's (k = 5) and the structure tensors' (k = 7) blurs, JPEG's
# chroma blur (k = 3) and the Laplacian pyramid's pyrdown and pyrup blurs
# (k = 5) on 32 (or 96) planes of 256x256 and below; elastic_transform2d's
# 63-tap smoothing of (1, 2, 1080, 1920) noise. Large tiles down to 128x128
# (the grid fills two blocks per SM), small ones at 64x64; 63 taps fit a
# large tile (csrc/banded_blur.cu::tiled_blur_fits): tiled at every shape.
for _hw in [(256, 256), (128, 128), (64, 64), (1080, 1920)]:
    ROUTES[("fused_separable_blur2d", *_hw)] = "tiled"
# step 17, the fused blur: MKD's 5x5 replicate blur of 1,024 32² patches
# an image (N = 1024 in one launch): tiled
ROUTES[("fused_separable_blur2d", 32, 32)] = "tiled"
# ... and the band adjoint of JPEG's chroma blur (k = 3, reflect) in the
# codec's backward, on 32 planes of 256x256: tiled
ROUTES[("fused_separable_blur2d_adjoint", 256, 256)] = "tiled"


def expected_route(name: str, h: int, w: int) -> str:
    """The route PERF.md names for wrapper `name` at (h, w): ROUTES, and
    the tiled kernel for the fused blur and its adjoint at every shape."""
    return ROUTES.get((name, h, w), "tiled")


def route_of(K, name: str, fn):
    """Run fn once; the route its one launch of wrapper `name` took, from
    the route counters. Fails unless exactly one launch was counted."""
    keys = [f"{name}:tiled", f"{name}:passes"]
    before = [K.launches[k] for k in keys]
    out = fn()
    torch.cuda.synchronize()
    moved = [K.launches[k] - b for k, b in zip(keys, before)]
    if sorted(moved) != [0, 1]:
        fail(f"{name}: route counters moved by {moved}, not one launch")
    return ("tiled", "passes")[moved.index(1)], out


def check_route(K, name: str, h: int, w: int, fn):
    """route_of, failing where the route is not the one PERF.md names."""
    route, out = route_of(K, name, fn)
    want = expected_route(name, h, w)
    if route != want:
        fail(f"{name} at {h}x{w} took the {route} route, PERF.md names "
             f"{want}")
    return route, out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_flush = {}
# the profiler's name of the flush's kernel (a fill of int16, which no timed
# call does), left out of the timed call's sum
FLUSH_KERNEL = "FillFunctor<short>"
# device_profile's windows: one that lost a path kernel's events is taken
# again, up to this many
PROFILE_WINDOWS = 5
# timed_call's spin: about 3 ms at the H100's clock, longer than any timed
# call takes to enqueue
SPIN_CYCLES = 5_000_000


def l2_flush() -> None:
    """Overwrite a buffer larger than the card's L2 with int16 ones. The
    buffer stays until device_ms drops it, so that it counts in no memory
    reading."""
    if "buf" not in _flush:
        _flush["buf"] = torch.empty(L2_FLUSH_BYTES // 2, dtype=torch.int16,
                                    device="cuda")
    _flush["buf"].fill_(1)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call from a cold L2: the kernels' own time summed
    by torch.profiler over `reps` calls (host overhead excluded), each call
    after an l2_flush, whose kernel (FLUSH_KERNEL) is left out of the sum.
    The profiler now and then records no device event, or fewer kernels
    than the calls launched, for a window; such a window is taken again,
    and after three such windows each call is timed by timed_call (the gaps
    between its own kernels included), which is said on a line of its
    own."""
    try:
        return _device_ms(fn, reps, warmup)
    finally:
        _flush.pop("buf", None)


def _device_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    l2_flush()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                l2_flush()
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and FLUSH_KERNEL not in e.key]
        us = sum(e.self_device_time_total for e in kern)
        if us > 0 and sum(e.count for e in kern) >= reps:
            return us / reps / 1e3
    events = []
    for _ in range(reps):
        l2_flush()
        events.append(timed_call(fn))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in events) / reps
    print(f"torch.profiler recorded no device time three times: CUDA "
          f"events (timed_call) give {ms:.4f} ms a call")
    if not ms > 0:
        fail("no device time recorded")
    return ms


def timed_call(fn):
    """fn between two CUDA events, after a spin kernel of SPIN_CYCLES that
    holds the device while the host enqueues the call: the events time the
    device's work, not the host's launches. Returns the events."""
    torch.cuda._sleep(SPIN_CYCLES)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    return start, end


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blur_bound(h: int, w: int, n: int, taps: int):
    """One separable blur of n (h, w) images: one read of x, one write of
    the output; 2 flops a tap, `taps` taps (both axes) a pixel."""
    return bound(2 * n * h * w * 4, 2 * taps * n * h * w)


def ml_bound(h: int, w: int, n: int, levels: int, taps: int):
    """multi_level_blur of n (h, w) images: one read of x, one write of each
    level; the least work is the sequential chain (each level one separable
    blur of the previous), `taps` taps (both axes) a pixel, 2 flops a tap."""
    return bound((1 + levels) * n * h * w * 4, 2 * taps * n * h * w)


def patch_bound(atlas_numel: int, samples: int):
    """patch_sample: the atlas read once, px, py read and the samples
    written once; 13 flops a bilinear sample."""
    return bound(atlas_numel * 4 + 3 * samples * 4, 13 * samples)


def min2_bound(n: int, m: int, d: int):
    """streaming_min2 of (n, d) rows against (m, d): both read once, three
    (n,) results written; the product accurate to f32 is three TF32
    products on the tensor cores (on the CUDA cores in f32 it would be
    one)."""
    t_bytes = ((n + m) * d + 3 * n) * 4 / H100_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * n * m * d / H100_TF32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def path_launch_shapes(h: int, w: int, patch_sizes=(19, 41)):
    """The shapes at which one image of the pair launches each ported
    kernel (SIFTFeature: ScalePyramid(3, 1.6, 32), 19² orientation and 41²
    descriptor patches; BASELINE config 2 describes 32² patches): the
    first-level blur (k = 15, replicate), the pyrdown blurs (k = 5, reflect)
    of each patch atlas, one multi-level launch per octave, and the atlas
    rows and samples per keypoint of each patch call. Mirrors
    ops/pyramid.py and feature/laf.py."""
    from kornia_tpu_torch.ops.pyramid import ScalePyramid
    fused = [(h, w, 15, "replicate")]
    patches = []
    for ps in patch_sizes:
        hh, ww, rows = h, w, h
        for _ in range(max(1, min(h, w) // ps) - 1):
            fused.append((hh, ww, 5, "reflect"))
            hh, ww = hh // 2, ww // 2
            if min(hh, ww) < ps:
                break
            rows += hh
        patches.append((rows, ps * ps))
    octaves = [(h >> o, w >> o)
               for o in range(ScalePyramid(3, 1.6, 32).n_octaves(h, w))]
    return dict(fused_separable_blur2d=fused, multi_level_blur=octaves,
                patch_sample=patches)


# CUDA kernels (as torch.profiler names them) -> the wrapper that launches
# them on the pair's path
PAIR_KERNELS = {
    "fused_separable_blur2d": ("taps_vertical", "taps_horizontal",
                               "tile_taps_blur"),
    "multi_level_blur": ("band_vertical", "band_horizontal",
                         "tile_band_blur"),
    "patch_sample": ("patch_sample_kernel",),
}
# ... and of every other launch counter: the bf16 patch kernel; the band
# adjoints (their tiled kernel, or their two passes), which the fused blur's
# adjoint and the multi-level adjoint share, so a path that sums one by
# these names runs the fused adjoint under a reflect or replicate border
# (the constant and circular adjoints run the forward's kernels) and no
# multi-level adjoint: path_kernel_times checks both; the matcher's three
BAND_ADJOINT = ("tile_band_adjoint", "band_vertical", "band_horizontal_sum")
KERNELS = dict(PAIR_KERNELS, **{
    "patch_sample[bf16]": ("patch_sample_bf16_kernel",),
    "fused_separable_blur2d_adjoint": BAND_ADJOINT,
    "multi_level_blur_adjoint": BAND_ADJOINT,
    "streaming_min2": ("row_norms", "min2_partial", "min2_merge")})


def _kernel_name(key: str) -> str:
    """'void (anonymous namespace)::band_vertical<false>(float const*, ...)'
    -> 'band_vertical'."""
    head = re.split(r"[(<]", key.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0]
    return head.split("::")[-1].split()[-1]


# --- the kernels line: one way for every step -------------------------------
#
# A step that drives a path counts its launches (counted_run), profiles it
# on the device (device_profile), captures every call of its kernels'
# wrappers (capture_launches), holds each captured call against its plain
# version on its ROUTES route (check_captured), sums the path's device time
# and bound per kernel (path_kernel_times) and, for the kernels line, times
# the largest captured call of each kernel (captured_entry, path_entries).

# the launch counters whose wrappers pick a route (tiled or two passes)
ROUTED = ("fused_separable_blur2d", "fused_separable_blur2d_adjoint",
          "multi_level_blur", "multi_level_blur_adjoint")
CAPTURE_TOL = {"fused_separable_blur2d": BLUR_ATOL,
               "fused_separable_blur2d_adjoint": BLUR_ATOL,
               "multi_level_blur": BLUR_ATOL,
               "multi_level_blur_adjoint": BLUR_ATOL,
               "patch_sample": PATCH_ATOL, "patch_sample[bf16]": BF16_ATOL,
               "streaming_min2": MATCH_ATOL}
KERNEL_SOURCES = {
    "fused_separable_blur2d": "kornia_tpu_torch/csrc/banded_blur.cu",
    "fused_separable_blur2d_adjoint": "kornia_tpu_torch/csrc/banded_blur.cu",
    "multi_level_blur": "kornia_tpu_torch/csrc/banded_blur.cu",
    "multi_level_blur_adjoint": "kornia_tpu_torch/csrc/banded_blur.cu",
    "patch_sample": "kornia_tpu_torch/csrc/patch_sample.cu",
    "patch_sample[bf16]": "kornia_tpu_torch/csrc/patch_sample.cu",
    "streaming_min2": "kornia_tpu_torch/csrc/streaming_min2.cu"}
REPLACES = {"fused_separable_blur2d": "kornia_tpu/ops/pallas_kernels.py:239",
            "fused_separable_blur2d_adjoint":
                "kornia_tpu/ops/pallas_kernels.py:216",
            "multi_level_blur": "kornia_tpu/ops/pallas_kernels.py:378",
            "multi_level_blur_adjoint": "kornia_tpu/ops/pallas_kernels.py:351",
            "patch_sample": "kornia_tpu/ops/pallas_kernels.py:539",
            "patch_sample[bf16]": "kornia_tpu/ops/pallas_kernels.py:512",
            "streaming_min2": "kornia_tpu/ops/pallas_kernels.py:71"}


def wrapper_of(K, name: str):
    """A launch counter's wrapper and plain version: 'patch_sample[bf16]'
    counts K.patch_sample's bf16 calls."""
    base = name.split("[")[0]
    return getattr(K, base), getattr(K, base + "_plain")


def counted_run(K, fn, what: str, names=tuple(PAIR_KERNELS)) -> dict:
    """Launch counters set to 0 just before fn, read just after; every
    kernel in `names` must have launched."""
    torch.cuda.synchronize()
    K.reset_launches()
    fn()
    torch.cuda.synchronize()
    launches = dict(K.launches)
    print(f"{what} launches: {launches}")
    for name in names:
        if launches.get(name, 0) <= 0:
            fail(f"{what} never launched kernel {name}")
    return launches


def device_profile(fn, expect=()):
    """fn once under a device-only torch.profiler trace: (busy ms, kernels
    launched, the device-side entries). The profiler now and then drops a
    window's device events, often in runs of windows (device_ms's note): a
    window in which a kernel of a wrapper in `expect` (KERNELS' names) left
    no event is taken again, up to PROFILE_WINDOWS windows;
    path_kernel_times times a kernel still missing with CUDA events."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_WINDOWS):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {_kernel_name(e.key) for e in kern}
        if all(seen & set(KERNELS[n]) for n in expect):
            break
        print(f"torch.profiler recorded no kernel of "
              f"{[n for n in expect if not seen & set(KERNELS[n])]} in "
              f"a window: taken again")
    return (sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern), kern)


def capture_launches(K, fn, names=tuple(PAIR_KERNELS)) -> dict:
    """Run fn once with a spy on each kernel wrapper that counts a launch
    in `names`: the cloned arguments of every call, by launch counter (a
    bf16 patch call under 'patch_sample[bf16]')."""
    from kornia_tpu_torch.feature import laf as laf_mod
    from kornia_tpu_torch.feature import matching as match_mod
    from kornia_tpu_torch.ops import pyramid as pyr_mod
    calls = {name: [] for name in names}
    sites = [(K, "fused_separable_blur2d"),
             (K, "fused_separable_blur2d_adjoint"),
             (pyr_mod, "multi_level_blur"), (K, "multi_level_blur_adjoint"),
             (laf_mod, "patch_sample"), (match_mod, "streaming_min2")]
    wrapped = {name.split("[")[0] for name in names}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites
             if attr in wrapped]

    def counter(attr, args, kwargs):
        if attr != "patch_sample":
            return attr
        mode = args[3] if len(args) > 3 else kwargs.get("mode", "split")
        return "patch_sample[bf16]" if K._PATCH_MODES[mode] else attr

    def spy(attr, real):
        def call(*args, **kwargs):
            key = counter(attr, args, kwargs)
            if key in calls:
                calls[key].append((tuple(a.clone() if torch.is_tensor(a)
                                         else a for a in args), dict(kwargs)))
            return real(*args, **kwargs)
        return call

    try:
        for mod, attr, real in saved:
            setattr(mod, attr, spy(attr, real))
        fn()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return calls


def _max_err(name: str, got, ref) -> float:
    """The largest difference of a kernel's output from its plain version's;
    streaming_min2's argmin must agree but on rows whose two nearest lie
    within TIE_RTOL of each other."""
    if name != "streaming_min2":
        return (got - ref).abs().max().item()
    tie = (ref[1] - ref[0]) <= TIE_RTOL * ref[1]
    if ((got[2] != ref[2]) & ~tie).any():
        fail("streaming_min2's argmin differs from its plain version")
    return max((got[0] - ref[0]).abs().max().item(),
               (got[1] - ref[1]).abs().max().item())


def check_captured(K, calls: dict, what: str) -> dict:
    """Each captured call again through its kernel and its plain version:
    the largest difference per launch counter, and the routes the blurs
    took; every blur's shape must be in ROUTES and take the route listed
    there. CAPTURE_TOL is stated for [0, 1] inputs: a call whose input
    reaches beyond 1 (JPEG's 0-255 chroma planes) is held to it times its
    largest |input|, the same f32 precision; `tol` is the largest such
    limit."""
    out = {}
    for name, cs in calls.items():
        if not cs:
            fail(f"{what}: no call of {name} captured")
        kern, plain = wrapper_of(K, name)
        err, worst, scale, routes = 0.0, 0.0, 1.0, {}
        for args, kwargs in cs:
            if name in ROUTED:
                route, got = route_of(K, name, lambda: kern(*args, **kwargs))
                routes[route] = routes.get(route, 0) + 1
                hw = tuple(args[0].shape[-2:])
                if ROUTES.get((name, *hw)) != route:
                    fail(f"{what}: {name} at {hw[0]}x{hw[1]} took the "
                         f"{route} route, ROUTES lists "
                         f"{ROUTES.get((name, *hw))}")
            else:
                got = kern(*args, **kwargs)
            e = _max_err(name, got, plain(*args, **kwargs))
            s_call = max(1.0, args[0].abs().max().item())
            err, worst = max(err, e), max(worst, e / s_call)
            scale = max(scale, s_call)
        if not worst <= CAPTURE_TOL[name]:
            fail(f"{what}: {name} disagrees with its plain version on the "
                 f"path's inputs: max abs err {err}, {worst} of the input's "
                 f"range")
        shapes = sorted({tuple(a[0].shape) for a, _ in cs})
        out[name] = dict(calls=len(cs), max_abs_err=err, routes=routes,
                         tol=CAPTURE_TOL[name] * scale,
                         shapes=[list(t) for t in shapes])
        print(f"{what} {name}: {len(cs)} calls against the plain version, "
              f"max abs err {err:.3e} ({worst:.3e} of the input's range), "
              f"routes {routes}, shapes {shapes}")
    return out


def launch_bound(name: str, args):
    """(ms, 'bytes' or 'operations'): the bound of one captured launch, at
    its own shapes."""
    x = args[0]
    if name.startswith("patch_sample"):
        return patch_bound(x.numel(), args[1].numel())
    if name == "streaming_min2":
        return min2_bound(x.shape[0], args[1].shape[0], x.shape[1])
    h, w = x.shape[-2:]
    n = x.numel() // (h * w)
    if name in ("fused_separable_blur2d", "fused_separable_blur2d_adjoint"):
        # the adjoint: one read of g, one write of dx, the same taps
        return blur_bound(h, w, n, args[1].numel() + args[2].numel())
    levels = len(args[1])
    taps = sum(k.numel() for k in args[1]) + sum(k.numel() for k in args[2])
    if name == "multi_level_blur_adjoint":
        n //= levels  # g holds one gradient a level
    return ml_bound(h, w, n, levels, taps)


def replay_ms(kern, calls: list) -> float:
    """The captured calls of one wrapper, each launched once more after a
    warm-up call and timed by timed_call: their sum, in ms."""
    with torch.no_grad():
        for args, kwargs in calls:
            kern(*args, **kwargs)
        events = [timed_call(lambda: kern(*args, **kwargs))
                  for args, kwargs in calls]
        torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def path_kernel_times(K, kern, calls: dict, launches: dict,
                      what: str) -> dict:
    """Per ported kernel of one profiled run: its device time summed over
    the run's CUDA kernels, its launches and the sum of each captured
    launch's bound; fails where the captured calls and the counted launches
    disagree. A kernel that left no event in device_profile's windows is
    timed by replay_ms on its captured calls, which is said on a line of
    its own."""
    out = {}
    if ("fused_separable_blur2d_adjoint" in calls
            and (launches.get("multi_level_blur_adjoint")
                 or any((a[3] if len(a) > 3 else kw.get("border_type"))
                        in ("constant", "circular")
                        for a, kw in calls["fused_separable_blur2d_adjoint"]))):
        fail(f"{what}: the band adjoint's kernels are shared with another "
             f"launch of the path (KERNELS' note)")
    for name, cs in calls.items():
        if len(cs) != launches.get(name):
            fail(f"{what}: {len(cs)} calls of {name} captured, "
                 f"{launches.get(name)} launches counted")
        ms = sum(e.self_device_time_total for e in kern
                 if _kernel_name(e.key) in KERNELS[name]) / 1e3
        if not ms > 0:
            ms = replay_ms(wrapper_of(K, name)[0], cs)
            print(f"{what}: torch.profiler recorded no event of {name} in "
                  f"{PROFILE_WINDOWS} windows: CUDA events around its "
                  f"{len(cs)} captured calls give {ms:.4f} ms")
        if not ms > 0:
            fail(f"{what}: no device time of {name}")
        b = sum(launch_bound(name, a)[0] for a, _ in cs)
        out[name] = dict(ms=ms, launches=len(cs), bound_ms=b)
        print(f"{what} {name}: {ms:.4f} ms device in {len(cs)} launches, "
              f"bound {b:.5f} ms")
    return out


def captured_entry(K, name: str, calls: list, checks: dict) -> dict:
    """The kernels line's entry of a path's kernel: kernel and plain
    version timed on the path's largest captured call (by bound), its bound
    at that call's shapes, the largest difference check_captured found.
    patch_sample is timed in turns with F.grid_sample (exact modes: the
    one PyTorch call of the same function) on one call of each distinct
    shape of the path (`per_shape`)."""
    args, kwargs = max(calls, key=lambda c: launch_bound(name, c[0])[0])
    kern, plain = wrapper_of(K, name)
    b_ms, b_by = launch_bound(name, args)
    err, lib_ms, per_shape = checks["max_abs_err"], None, None
    if name.startswith("patch_sample"):
        mode = args[3] if len(args) > 3 else kwargs.get("mode", "split")
        distinct = {}
        for a, _ in calls:
            distinct.setdefault((tuple(a[0].shape), tuple(a[1].shape)), a[:3])
        per_shape = path_patch_times(K, list(distinct.values()), mode)
        for d in per_shape:
            d.pop("inputs")
            err = max(err, d["max_abs_err"])
        top = max(per_shape, key=lambda d: d["bound_ms"])
        ms = statistics.mean(top["kernel_ms"])
        lib_ms = top["library_ms"] and statistics.mean(top["library_ms"])
    else:
        ms = device_ms(lambda: kern(*args, **kwargs))
    return dict(source=KERNEL_SOURCES[name], replaces=REPLACES[name],
                max_abs_err=err, ms=ms,
                plain_ms=device_ms(lambda: plain(*args, **kwargs)),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                tol=checks["tol"], per_shape=per_shape,
                shape=[list(a.shape) for a in args if torch.is_tensor(a)])


def path_entries(K, calls: dict, checks: dict, launches: dict,
                 tag: str = "") -> tuple:
    """The kernels line's entries of one path, keyed name@tag (name alone
    without a tag), and each entry's launches on the path."""
    results, counts = {}, {}
    for name, cs in calls.items():
        key = f"{name}@{tag}" if tag else name
        results[key] = captured_entry(K, name, cs, checks[name])
        counts[key] = launches.get(name, 0)
    return results, counts


def check_launch_list(launches: dict, shapes: dict, n_detect: int,
                      what: str) -> None:
    """The launches counted over `n_detect` detections of a path against
    one detection's launch list (path_launch_shapes, planar_launch_shapes),
    and each blur's launches against the route ROUTES names at its shape:
    fails on any miscount."""
    want = {}
    for name in ("fused_separable_blur2d", "multi_level_blur"):
        for shape in shapes[name]:
            key = f"{name}:{expected_route(name, *shape[:2])}"
            want[key] = want.get(key, 0) + n_detect
    for name in PAIR_KERNELS:
        want[name] = n_detect * len(shapes[name])
    for key, n in want.items():
        if launches.get(key) != n:
            fail(f"{what}: {launches.get(key)} launches of {key}, the launch "
                 f"list and ROUTES give {n}")


def capture_patch_coords(dev, img, feature=None):
    """The (atlas, px, py) of each patch_sample call that `feature`
    (SIFTFeature by default) makes on `img`: the path's own LAFs, 19²
    orientation and 41² descriptor grids."""
    from kornia_tpu_torch.feature import laf as laf_mod
    from kornia_tpu_torch.feature.integrated import SIFTFeature
    calls = []
    real = laf_mod.patch_sample

    def spy(atlas, px, py, mode="split"):
        calls.append((atlas.clone(), px.clone(), py.clone()))
        return real(atlas, px, py, mode)

    laf_mod.patch_sample = spy
    try:
        (feature or SIFTFeature(num_features=NF))(img)
    finally:
        laf_mod.patch_sample = real
    return calls


def in_turns(first, second, reps: int = 20):
    """Device ms of two functions timed first, second, second, first; each
    reading is kept (their spread is the noise of the comparison)."""
    a0 = device_ms(first, reps)
    b0 = device_ms(second, reps)
    b1 = device_ms(second, reps)
    a1 = device_ms(first, reps)
    return (a0, a1), (b0, b1)


def kernel_phase(K, filters, dev) -> dict:
    """Step 1: each kernel of the pair's path against its plain version on
    random inputs at the path's shapes, each blur on the route ROUTES
    names; the patch kernel in both modes on coordinates over and beyond
    the atlas, and on streams that are ragged, at 4-byte offsets, empty or
    one sample long. The kernels line's entries are timed on the pair's own
    calls (main_path)."""
    from kornia_tpu_torch.ops.pyramid import ScalePyramid
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = path_launch_shapes(H, W)
    errs = {}

    def check(name, got, ref, tol):
        e = (got - ref).abs().max().item() if got.numel() else 0.0
        errs[name] = max(errs.get(name, 0.0), e)
        if not e <= tol:
            fail(f"{name} disagrees with its plain version: max abs err "
                 f"{e} > {tol}")

    # --- fused_separable_blur2d: first-level Gaussian (k=15, replicate) and
    # the pyrdown chain of the patch atlas (k=5, reflect)
    k15 = filters.get_gaussian_kernel1d(
        15, math.sqrt(1.6 ** 2 - 0.5 ** 2), device=dev).reshape(-1)
    k5 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=dev) / 16.0
    taps = {15: k15, 5: k5}
    for hh, ww, k, border in dict.fromkeys(shapes["fused_separable_blur2d"]):
        xi = torch.rand((1, 1, hh, ww), device=dev, generator=gen)
        ki = taps[k]
        _, out = check_route(
            K, "fused_separable_blur2d", hh, ww,
            lambda: K.fused_separable_blur2d(xi, ki, ki, border))
        check("fused_separable_blur2d", out,
              K.fused_separable_blur2d_plain(xi, ki, ki, border), BLUR_ATOL)

    # --- multi_level_blur: every octave of the 480x640 pyramid, with the
    # pyramid's own incremental kernels (host tensors, as it passes them)
    kers, _ = ScalePyramid()._level_kernels(1.6)
    for hh, ww in shapes["multi_level_blur"]:
        xi = torch.rand((1, 1, hh, ww), device=dev, generator=gen)
        _, out = check_route(
            K, "multi_level_blur", hh, ww,
            lambda: K.multi_level_blur(xi, kers, kers, "replicate"))
        check("multi_level_blur", out,
              K.multi_level_blur_plain(xi, kers, kers, "replicate"),
              BLUR_ATOL)
    # the band tables are built once per (kernels, size, border, device)
    x = torch.rand((1, 1, H, W), device=dev, generator=gen)
    K._band_tables_cached.cache_clear()
    K._cumulative_cached.cache_clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    K.multi_level_blur(x, kers, kers, "replicate")
    torch.cuda.synchronize()
    tables_ms = (time.perf_counter() - t0) * 1e3
    band_taps = [K._band_tables_cached(K._values(kers), n, "replicate",
                                       str(dev))[2] for n in (H, W)]
    print(f"multi_level_blur 480x640: band taps per pixel "
          f"{sum(map(sum, band_taps))} (levels {list(band_taps[0])} "
          f"vertical), sequential chain {2 * sum(k.numel() for k in kers)}; "
          f"band tables built in {tables_ms:.2f} ms on the first call (host "
          f"clock), cached after")

    # --- patch_sample, both modes: the orienter's (19², atlas 930 rows) and
    # the descriptor's (41², 900 rows) calls of 1024 keypoints on random
    # coordinates (clamping at every edge), then streams the kernel splits
    # into a head, 8-byte pairs and a tail (csrc/patch_sample.cu): ragged,
    # views at 4-byte offsets (px and py on the same and on other 8-byte
    # parities), one sample, none
    def at_offset(t, k):
        flat = torch.empty(t.numel() + 8, device=dev)
        view = flat[k:k + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    cases = [(rows, NF, S, 0, 0) for rows, S in shapes["patch_sample"]] + [
        (900, 1023, 1681, 0, 0), (900, 3, 5, 0, 0), (900, 1, 1, 0, 0),
        (900, 0, 361, 0, 0), (930, NF, 361, 1, 2), (900, NF, 1681, 3, 1),
        (900, 97, 361, 2, 0)]
    for rows, n, S, kx, ky in cases:
        atlas = torch.rand((rows, W), device=dev, generator=gen)
        px = at_offset(torch.rand((n, S), device=dev, generator=gen)
                       * (W + 20) - 10, kx)
        py = at_offset(torch.rand((n, S), device=dev, generator=gen)
                       * (rows + 20) - 10, ky)
        for mode, name, tol in (("split", "patch_sample", PATCH_ATOL),
                                ("bf16", "patch_sample[bf16]", BF16_ATOL)):
            check(name, K.patch_sample(atlas, px, py, mode),
                  K.patch_sample_plain(atlas, px, py, mode), tol)
    print(f"kernels vs plain on random inputs at the path's shapes (patch "
          f"cases {[c[1:] for c in cases]}: N, S, px and py offsets in "
          f"floats): {errs}")
    return errs


def path_patch_times(K, calls, mode: str) -> list:
    """patch_sample on the path's own (atlas, px, py), each call against
    its plain version, then timed in turns with F.grid_sample ('border',
    align_corners=True: the same function on normalised coordinates);
    grid_sample only for the exact modes (nothing rounds as bf16 does)."""
    out = []
    for atlas, px, py in calls:
        rows, cols = atlas.shape
        n, s = px.shape
        got = K.patch_sample(atlas, px, py, mode)
        e = (got - K.patch_sample_plain(atlas, px, py, mode)).abs().max()
        kern = lambda: K.patch_sample(atlas, px, py, mode)  # noqa: E731
        if mode == "bf16":
            k_ms, lib_ms = [device_ms(kern), device_ms(kern)], None
        else:
            grid = torch.stack([2.0 * px / (cols - 1) - 1.0,
                                2.0 * py / (rows - 1) - 1.0], dim=-1)[None]
            lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
                atlas[None, None], grid, "bilinear", "border",
                align_corners=True)
            k_ms, lib_ms = in_turns(kern, lib)
        b_ms, b_by = patch_bound(atlas.numel(), px.numel())
        ext = max(float((px.amax(1) - px.amin(1)).max()),
                  float((py.amax(1) - py.amin(1)).max()))
        print(f"patch_sample[{mode}] path coordinates {n}x{s} on a "
              f"{rows}x{cols} atlas (largest footprint {ext:.1f} px): kernel "
              f"{[round(v, 5) for v in k_ms]} ms, grid_sample "
              f"{lib_ms and [round(v, 5) for v in lib_ms]} ms, bound "
              f"{b_ms:.5f} ms, max abs err {e.item():.3e}")
        out.append(dict(shape=[n, s], atlas=[rows, cols], footprint_px=ext,
                        kernel_ms=list(k_ms),
                        library_ms=lib_ms and list(lib_ms), bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=e.item(),
                        inputs=(atlas, px, py)))
    return out


def report(results: dict) -> None:
    """Print each kernel's numbers; fail where one disagrees with its plain
    version."""
    for name, r in results.items():
        if not r["max_abs_err"] <= r["tol"]:
            fail(f"{name} disagrees with its plain version: max abs err "
                 f"{r['max_abs_err']} > {r['tol']}")
        print(f"kernel {name}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms {r['library_ms']}")


def bench_input(h: int, w: int, dev):
    """bench.py's input: a blurred random image and its 4 px shift."""
    from kornia_tpu_torch.ops.filters import gaussian_blur2d
    from kornia_tpu_torch.ops.warp import warp_perspective
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = gaussian_blur2d(torch.rand((1, 1, h, w), device=dev,
                                      generator=gen), 3, 1.0)
    M = torch.eye(3, device=dev)
    M[0, 2] = -4.0
    warped = warp_perspective(base, M[None], (h, w))
    K = torch.tensor([[0.8 * w, 0.0, w / 2], [0.0, 0.8 * w, h / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    return base, warped, K


def angle_of_rotation(R: torch.Tensor) -> float:
    c = (torch.trace(R.double()).item() - 1.0) / 2.0
    return math.acos(max(-1.0, min(1.0, c)))


def check_pose(res, what: str, planar_twin: bool = False):
    """bench.py's input is a pure x shift: R within 1 deg of I and
    |t_x| > 0.9. Its scene is one fronto-parallel plane, so the essential
    matrix has a second decomposition that explains every match exactly as
    well: t along the optical axis and a rotation of about 4 px / f = 0.45
    deg. With `planar_twin`, |t_z| > 0.99 (and R within 1 deg of I) passes
    too."""
    rot = math.degrees(angle_of_rotation(res.R))
    t = res.t.reshape(-1).cpu()
    n_inl = int(res.num_inliers)
    print(f"{what}: rotation {rot:.4f} deg, t {t.tolist()}, inliers "
          f"{n_inl}, valid matches {int(res.inliers.numel())}")
    if not (torch.isfinite(res.R).all() and torch.isfinite(res.t).all()):
        fail(f"{what}: non-finite pose")
    if not rot < 1.0:
        fail(f"{what}: rotation {rot} deg is not within 1 deg of identity")
    if planar_twin and abs(float(t[2])) > 0.99:
        print(f"{what}: the plane's twin decomposition (t along the optical "
              f"axis) was chosen")
    elif not abs(float(t[0])) > 0.9:
        fail(f"{what}: |t_x| = {abs(float(t[0]))} <= 0.9 for a pure x shift")
    return rot, t, n_inl


def main_path(K, dev, profile_out) -> dict:
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature.integrated import SIFTFeature
    from kornia_tpu_torch.feature.matching import DescriptorMatcher
    from kornia_tpu_torch.geometry.conversions import \
        normalize_points_with_intrinsics
    from kornia_tpu_torch.geometry.epipolar import \
        motion_from_essential_choose_solution
    from kornia_tpu_torch.geometry.ransac import ransac
    from kornia_tpu_torch.slam.twoview import two_view_pose

    img0, img1, Kc = bench_input(H, W, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    K.reset_launches()
    res = two_view_pose(img0, img1, Kc, generator=gen, num_features=NF,
                        device=dev)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    print(f"main path launches per pair: {launches}")
    for name in ("fused_separable_blur2d", "multi_level_blur",
                 "patch_sample"):
        if launches.get(name, 0) <= 0:
            fail(f"main path never launched kernel {name}")
    rot, t, n_inl = check_pose(res, "pose")
    check_launch_list(launches, path_launch_shapes(H, W), 2, "pair")
    # every kernel call of a pair, held to its plain version; the kernels
    # line's entries
    calls = capture_launches(K, lambda: two_view_pose(
        img0, img1, Kc, generator=gen, num_features=NF, device=dev))
    kernels, counts = path_entries(
        K, calls, check_captured(K, calls, "pair"), launches)
    report(kernels)

    # pairs: host clock around synchronised calls
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two_view_pose(img0, img1, Kc, generator=gen, num_features=NF,
                      device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    pair_ms = statistics.median(times)
    print(f"two_view_pose 480x640/1024f: median {pair_ms:.2f} ms/pair "
          f"({1e3 / pair_ms:.3f} pairs/s), runs {[round(v, 2) for v in times]}")

    # stages: the same steps as two_view_pose, synchronised between
    feat = SIFTFeature(num_features=NF)
    matcher = DescriptorMatcher("smnn", 0.95)
    stages = {k: [] for k in ("features x2", "match", "ransac", "pose")}
    for _ in range(3):
        with f32_precision():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l0, _, d0, v0 = feat(img0)
            l1, _, d1, v1 = feat(img1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, idx, valid = matcher(d0[0], d1[0], v0[0], v1[0])
            kp0 = l0[0, :, :, 2]
            kp1 = l1[0, :, :, 2][idx[:, 1]]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            x0 = normalize_points_with_intrinsics(kp0, Kc)
            x1 = normalize_points_with_intrinsics(kp1, Kc)
            rr = ransac(x0, x1, model_type="essential",
                        inl_th=1.5 / (0.8 * W),
                        batch_size=256, max_iterations=32, mask=valid,
                        generator=gen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            eye = torch.eye(3, device=dev)[None]
            motion_from_essential_choose_solution(
                rr.model[None], eye, eye, x0[None], x1[None],
                mask=rr.inliers[None])
            torch.cuda.synchronize()
            t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(v * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    print(f"stages (median ms, host clock, synchronised): "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }, "
          f"ransac rounds {rr.rounds}")

    # device busy share of one pair: kernel time summed by the profiler
    # over the unprofiled median pair time
    ka, kern = profile_kernels(lambda: two_view_pose(
        img0, img1, Kc, generator=gen, num_features=NF, device=dev))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n_kernels = sum(e.count for e in kern)
    if profile_out:
        os.makedirs(profile_out, exist_ok=True)
        with open(os.path.join(profile_out, "twoview_profile.txt"), "w") as f:
            f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print(f"device busy {busy_ms:.3f} ms of a {pair_ms:.2f} ms pair "
          f"(idle share {1.0 - busy_ms / pair_ms:.4f}), device kernels "
          f"launched {n_kernels}")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    per_pair = path_kernel_times(K, kern, calls, launches, "per pair")
    print(json.dumps({"per_pair": per_pair}))
    return dict(launches=launches, pair_ms=pair_ms, stage_ms=stage_ms,
                busy_ms=busy_ms, n_kernels=n_kernels, rotation_deg=rot,
                t=t.tolist(), inliers=n_inl, per_pair=per_pair,
                kernels=kernels, counts=counts)


def profile_kernels(fn):
    """torch.profiler over one synchronised call of fn: (all key averages,
    the device-side entries). The device-side entries are the kernels
    themselves; the operator rows repeat their time, so only they are
    summed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return ka, [e for e in ka
                if e.device_type == torch.autograd.DeviceType.CUDA]


def cross_check(K, dev) -> None:
    """The port at 256x256/512f on the card and on the CPU, same noise."""
    from kornia_tpu_torch.slam.twoview import two_view_pose
    img0, img1, Kc = bench_input(XH, XW, dev)
    T, S = 32, 256
    cpu_gen = torch.Generator().manual_seed(2)
    u = torch.rand((T, S, XNF), generator=cpu_gen).clamp_min(
        torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    gpu = two_view_pose(img0, img1, Kc, num_features=XNF, device=dev,
                        gumbel=gumbel.to(dev))
    cpu = two_view_pose(img0.cpu(), img1.cpu(), Kc.cpu(), num_features=XNF,
                        device="cpu", gumbel=gumbel)
    dR = angle_of_rotation(gpu.R.cpu().double().T @ cpu.R.double())
    tg, tc = gpu.t.reshape(-1).cpu().double(), cpu.t.reshape(-1).double()
    dt = math.acos(max(-1.0, min(1.0, float(tg @ tc))))
    ig, ic = gpu.inliers.cpu(), cpu.inliers
    jac = float((ig & ic).sum()) / max(float((ig | ic).sum()), 1.0)
    both = ig & ic
    dkp = float((gpu.keypoints0.cpu() - cpu.keypoints0)[both].abs().max()) \
        if both.any() else 0.0
    print(f"cross-check 256x256/512f card vs CPU: dR {dR:.2e} rad, dt "
          f"{dt:.2e} rad, inlier Jaccard {jac:.4f} ({int(ig.sum())} vs "
          f"{int(ic.sum())}), max keypoint diff on common inliers "
          f"{dkp:.2e} px")
    # card and CPU sum in different orders (cuDNN, cuBLAS, FMA): a keypoint
    # at a near-tie may differ, so the sets are held to overlap, not equality
    if not (dR <= 1e-3 and dt <= 1e-2 and jac >= 0.9 and dkp <= 1e-2):
        fail("card and CPU runs of the port disagree")


def grad_diff(card: torch.Tensor, cpu: torch.Tensor, what: str) -> float:
    """Card gradient against the CPU gradient of the same step; fails
    beyond 1e-4 of the largest CPU gradient."""
    diff = (card.cpu() - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    print(f"{what}: card vs CPU gradient max abs diff {diff:.3e} "
          f"(max |g| {scale:.3e})")
    if not diff <= GRAD_RTOL * scale:
        fail(f"{what}: card gradient differs from the CPU's by {diff} > "
             f"{GRAD_RTOL} * {scale}")
    return diff


def train_phase(K, dev) -> dict:
    """Training through the blurs: Adam on the SSIM loss at (8, 3, 480, 640)
    and the squared DoG levels of ScalePyramid at 480x640, backward through
    the fused and multi-level adjoint kernels."""
    from kornia_tpu_torch.losses.losses import ssim_loss
    from kornia_tpu_torch.ops.filters import get_gaussian_kernel1d
    from kornia_tpu_torch.ops.pyramid import ScalePyramid

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    target = torch.rand(TRAIN_SHAPE, device=dev, generator=gen)
    init = target + 0.1 * torch.randn(TRAIN_SHAPE, device=dev, generator=gen)
    base = torch.rand((1, 1, H, W), device=dev, generator=gen)

    def dog_energy(x):
        octaves = ScalePyramid(3, 1.6, 32)(x)[0]
        return sum(((o[:, 1:] - o[:, :-1]) ** 2).sum() for o in octaves), \
            octaves

    # the path: five Adam steps, then one pyramid backward
    pred = init.clone().requires_grad_()
    opt = torch.optim.Adam([pred], lr=1e-2)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    K.reset_launches()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = ssim_loss(pred, target)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    ssim_launches = dict(K.launches)
    if loss.grad_fn is None:
        fail("ssim_loss on the card has no grad_fn")
    x = base.clone().requires_grad_()
    K.reset_launches()
    energy, octaves = dog_energy(x)
    energy.backward()
    torch.cuda.synchronize()
    pyr_launches = dict(K.launches)
    if octaves[0].grad_fn is None:
        fail("ScalePyramid on the card has no grad_fn")
    per_step = {k: v / TRAIN_STEPS for k, v in ssim_launches.items()}
    print(f"train: SSIM loss per step {losses}, ms per step (host clock, "
          f"synchronised) {[round(v, 3) for v in step_ms]}, launches per "
          f"step {per_step}")
    print(f"train: ScalePyramid(3, 1.6, 32) 480x640 DoG energy backward, "
          f"{len(octaves)} octaves, launches {pyr_launches}")
    if any(b > a for a, b in zip(losses, losses[1:])):
        fail(f"SSIM loss increased under Adam: {losses}")
    # every blur of the SSIM step and its adjoint (reflect bands) tiled
    expect = {"fused_separable_blur2d": 5, "fused_separable_blur2d_adjoint": 3,
              "fused_separable_blur2d:tiled": 5,
              "fused_separable_blur2d_adjoint:tiled": 3}
    for name, n in expect.items():
        if per_step.get(name) != n:
            fail(f"SSIM step launched {name} {per_step.get(name)} times, "
                 f"expected {n}")
    # the pyramid: one multi-level adjoint an octave, on PERF.md's route,
    # and the first-level blur's adjoint (replicate bands) tiled
    pyr_expect = {"multi_level_blur_adjoint": len(octaves),
                  "fused_separable_blur2d_adjoint": 1,
                  "fused_separable_blur2d_adjoint:tiled": 1}
    for o in octaves:
        key = "multi_level_blur_adjoint:" + expected_route(
            "multi_level_blur_adjoint", *o.shape[-2:])
        pyr_expect[key] = pyr_expect.get(key, 0) + 1
    for name, n in pyr_expect.items():
        if pyr_launches.get(name) != n:
            fail(f"pyramid backward launched {name} "
                 f"{pyr_launches.get(name)} times, expected {n}: "
                 f"{pyr_launches}")
    launches = {k: ssim_launches.get(k, 0) + pyr_launches.get(k, 0)
                for k in set(ssim_launches) | set(pyr_launches)}

    # the card's gradients against the CPU's, on the same inputs
    pc = init.clone().requires_grad_()
    g_card = torch.autograd.grad(ssim_loss(pc, target), pc)[0]
    pc = init.cpu().requires_grad_()
    g_cpu = torch.autograd.grad(ssim_loss(pc, target.cpu()), pc)[0]
    grad_diff(g_card, g_cpu, "SSIM step")
    x = base.clone().requires_grad_()
    g_card = torch.autograd.grad(dog_energy(x)[0], x)[0]
    x = base.cpu().requires_grad_()
    g_cpu = torch.autograd.grad(dog_energy(x)[0], x)[0]
    grad_diff(g_card, g_cpu, "ScalePyramid DoG energy")
    try:
        K.patch_sample(base[0, 0].clone().requires_grad_(), base[0, 0, :4],
                       base[0, 0, :4])
    except RuntimeError as e:
        print(f"patch_sample refuses grad on the card: {e}")
    else:
        fail("patch_sample on the card accepted an input that requires grad")

    # --- fused adjoint: the SSIM blur (11 taps, sigma 1.5, reflect and
    # replicate), the first-level blur of the pyramid (15 taps, replicate)
    # and the flipped-tap borders, each on the route ROUTES names
    k11 = get_gaussian_kernel1d(11, 1.5, device=dev).reshape(-1)
    k15 = get_gaussian_kernel1d(15, math.sqrt(1.6 ** 2 - 0.5 ** 2),
                                device=dev).reshape(-1)
    g = torch.rand(TRAIN_SHAPE, device=dev, generator=gen)
    cases = [(g, k11, "reflect"), (g, k11, "replicate"),
             (base, k15, "replicate")] + [
        (torch.rand((2, 3, 61, 83), device=dev, generator=gen), k11, b)
        for b in ("circular", "constant")]
    for gi, ki, border in cases:
        hh, ww = gi.shape[-2:]
        route, out = check_route(
            K, "fused_separable_blur2d_adjoint", hh, ww,
            lambda: K.fused_separable_blur2d_adjoint(gi, ki, ki, border))
        e = (out - K.fused_separable_blur2d_adjoint_plain(
            gi, ki, ki, border)).abs().max().item()
        print(f"fused_separable_blur2d_adjoint {tuple(gi.shape)} k="
              f"{ki.numel()} {border} ({route}): max abs err {e:.3e}")
        if not e <= BLUR_ATOL:
            fail(f"fused_separable_blur2d_adjoint {border} disagrees with "
                 f"its plain version: {e}")

    # --- multi-level adjoint: every octave of the 480x640 pyramid, on the
    # route ROUTES names for it
    kers, _ = ScalePyramid()._level_kernels(1.6)
    L = len(kers)
    for i in range(4):
        hh, ww = H >> i, W >> i
        gl = torch.rand((L, 1, 1, hh, ww), device=dev, generator=gen)
        route, out = check_route(
            K, "multi_level_blur_adjoint", hh, ww,
            lambda: K.multi_level_blur_adjoint(gl, kers, kers))
        e = (out - K.multi_level_blur_adjoint_plain(gl, kers, kers)
             ).abs().max().item()
        print(f"multi_level_blur_adjoint {hh}x{ww} L={L} ({route}): max abs "
              f"err {e:.3e}")
        if not e <= BLUR_ATOL:
            fail(f"multi_level_blur_adjoint at {hh}x{ww} disagrees with its "
                 f"plain version: {e}")

    # the kernels line: the adjoints of one step of the path (an SSIM step
    # and the pyramid's backward), captured and held to their plain versions
    def one_step():
        ssim_loss(init.clone().requires_grad_(), target).backward()
        dog_energy(base.clone().requires_grad_())[0].backward()

    calls = capture_launches(K, one_step, ("fused_separable_blur2d_adjoint",
                                           "multi_level_blur_adjoint"))
    kernels, counts = path_entries(K, calls, check_captured(K, calls,
                                                            "train"),
                                   launches)
    report(kernels)
    return dict(kernels=kernels, counts=counts, launches=launches,
                losses=losses, step_ms=statistics.median(step_ms))


def match_phase(K, dev) -> dict:
    """The streaming SMNN matcher on 8192x128 non-negative unit-norm sets:
    d2 holds noisy copies of d1's rows, permuted, so that matches exist."""
    from kornia_tpu_torch.feature.matching import DescriptorMatcher

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, d = MATCH_N, MATCH_D

    def unit(t):
        t = t.abs()
        return t / t.norm(dim=-1, keepdim=True)

    d1 = unit(torch.randn((n, d), device=dev, generator=gen))
    perm = torch.randperm(n, device=dev, generator=gen)
    d2 = unit(d1[perm] + 0.02 * torch.randn((n, d), device=dev,
                                            generator=gen))
    th = 0.95
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    K.reset_launches()
    dist, matches, valid = DescriptorMatcher("smnn", th, streaming=True)(
        d1, d2)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    limit = n * n * 4 / 16
    print(f"match: streaming SMNN {n}x{d}: {int(valid.sum())} valid, launches "
          f"{launches}, peak memory growth {peak} B (limit {limit:.0f})")
    if launches.get("streaming_min2") != 2:
        fail(f"streaming matcher launches {launches}")
    if not peak < limit:
        fail(f"streaming matcher grew peak memory by {peak} B >= {limit}")

    # against the dense matcher on the card, near ties left out
    rd, rm, rv = DescriptorMatcher("smnn", th)(d1, d2)
    f1, f2, _ = K.streaming_min2_plain(d1, d2)
    b1, b2, _ = K.streaming_min2_plain(d2, d1)
    near = ((f2 - f1) <= TIE_RTOL * f2) \
        | ((b2 - b1) <= TIE_RTOL * b2)[rm[:, 1]] \
        | ((rd[:, 0] - th).abs() <= TIE_RTOL)
    keep = ~near
    bad = ((matches != rm).any(-1) | (valid != rv)
           | ((dist - rd).abs()[:, 0] > MATCH_ATOL)) & keep
    print(f"match: against the dense matcher, {int(near.sum())} rows left "
          f"out as near ties, {int(bad.sum())} rows differ")
    if bad.any():
        fail(f"streaming matcher differs from the dense matcher in "
             f"{int(bad.sum())} rows")
    if not int(valid.sum()) > n // 2:
        fail(f"only {int(valid.sum())} of {n} rows matched")

    # the kernels line: the matcher's two launches (both directions),
    # captured and held to the plain version
    calls = capture_launches(K, lambda: DescriptorMatcher(
        "smnn", th, streaming=True)(d1, d2), ("streaming_min2",))
    kernels, counts = path_entries(K, calls, check_captured(K, calls,
                                                            "match"),
                                   launches)
    cublas_ms = device_ms(lambda: d1 @ d2.T)
    stream_match_ms = device_ms(lambda: DescriptorMatcher(
        "smnn", th, streaming=True)(d1, d2), reps=5)
    dense_match_ms = device_ms(lambda: DescriptorMatcher("smnn", th)(d1, d2),
                               reps=5)
    e = kernels["streaming_min2"]
    cuda_core_ms = bound((2 * n * d + 3 * n) * 4, 2 * n * n * d)[0]
    print(f"match: streaming_min2 {n}x{n}x{d} (3xTF32, tensor cores): "
          f"{e['ms']:.4f} ms, bound {e['bound_ms']:.5f} ms ({e['bound_by']}, "
          f"3xTF32 at 495 TFLOP/s; {e['ms'] / e['bound_ms']:.2f}x), CUDA-core "
          f"f32 bound {cuda_core_ms:.5f} ms; d1 @ d2.T (cuBLAS f32, TF32 off) "
          f"{cublas_ms:.4f} ms, a yardstick, not the same function; SMNN "
          f"matcher device ms: streaming {stream_match_ms:.4f}, plain "
          f"(dense) {dense_match_ms:.4f}")
    report(kernels)
    return dict(kernels=kernels, counts=counts, launches=launches,
                cublas_ms=cublas_ms, stream_match_ms=stream_match_ms,
                dense_match_ms=dense_match_ms, peak_bytes=peak)


def fast_patches_phase(K, dev) -> dict:
    """two_view_pose with bf16 patch sampling, and the bf16 kernel at the
    path's shapes."""
    from kornia_tpu_torch.feature.integrated import SIFTFeature
    from kornia_tpu_torch.slam.twoview import match_pair, two_view_pose

    img0, img1, Kc = bench_input(H, W, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    feat = SIFTFeature(num_features=NF, fast_patches=True)
    torch.cuda.synchronize()
    K.reset_launches()
    res = two_view_pose(img0, img1, Kc, generator=gen, num_features=NF,
                        feature=feat, device=dev)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    print(f"fast_patches: launches per pair {launches}")
    if launches.get("patch_sample[bf16]", 0) <= 0 or \
            launches.get("patch_sample", 0) != 0:
        fail(f"fast_patches pair did not sample in bf16 only: {launches}")
    check_pose(res, "fast_patches", planar_twin=True)
    # the matches of bf16 patches against those of exact patches
    exact = match_pair(img0, img1, NF, device=dev)
    fast = match_pair(img0, img1, NF, feature=feat, device=dev)
    either = exact["valid"] | fast["valid"]
    same = (exact["valid"] & fast["valid"]
            & (exact["matches"] == fast["matches"]).all(-1))
    agree = float(same.sum()) / max(float(either.sum()), 1.0)
    print(f"fast_patches: {int(same.sum())} of {int(either.sum())} matches "
          f"valid in either run are the same as with exact patches "
          f"({agree:.4f}; limit {FAST_AGREE})")
    if not agree >= FAST_AGREE:
        fail(f"bf16 patches change {1 - agree:.4f} of the matches")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        two_view_pose(img0, img1, Kc, generator=gen, num_features=NF,
                      feature=feat, device=dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"fast_patches: two_view_pose median {statistics.median(times):.2f}"
          f" ms/pair, runs {[round(v, 2) for v in times]}")
    # one pair profiled on the device and captured: each kernel's device
    # time and bound a pair, each call held to its plain version
    names = ("fused_separable_blur2d", "multi_level_blur",
             "patch_sample[bf16]")
    pair = lambda: two_view_pose(img0, img1, Kc,  # noqa: E731
                                 generator=gen, num_features=NF,
                                 feature=feat, device=dev)
    calls = capture_launches(K, pair, names)
    checks = check_captured(K, calls, "fast_patches")
    bf16 = "patch_sample[bf16]"
    kernels, counts = path_entries(K, {bf16: calls[bf16]}, checks, launches)
    report(kernels)
    _, _, kern = device_profile(pair, names)
    per_pair = path_kernel_times(K, kern, calls, launches,
                                 "fast_patches per pair")

    # the bf16 kernel against the exact kernel: bf16 keeps 8 bits
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    split_err = 0.0
    for rows, S in path_launch_shapes(H, W)["patch_sample"]:
        atlas = torch.rand((rows, W), device=dev, generator=gen)
        px = torch.rand((NF, S), device=dev, generator=gen) * (W - 1)
        py = torch.rand((NF, S), device=dev, generator=gen) * (rows - 1)
        split_err = max(split_err, (K.patch_sample(atlas, px, py, "bf16")
                                    - K.patch_sample(atlas, px, py))
                        .abs().max().item())
    print(f"fast_patches: bf16 kernel vs the exact kernel max abs diff "
          f"{split_err:.3e} (limit {BF16_VS_EXACT})")
    if not split_err <= BF16_VS_EXACT:
        fail(f"bf16 patch kernel is {split_err} from the exact kernel")
    return dict(kernels=kernels, counts=counts, launches=launches,
                pair_ms=statistics.median(times),
                per_pair_ms=per_pair[bf16]["ms"],
                per_pair_bound_ms=per_pair[bf16]["bound_ms"])


# --- step 7: the SLAM back end --------------------------------------------

def synced_s(fn) -> float:
    """Seconds of one call of fn on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def peak_bytes(fn) -> int:
    """Peak device memory allocated during one call of fn, above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def no_host_sync(fn):
    """Run fn with every synchronising CUDA call raising."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def _centres(poses) -> torch.Tensor:
    """Camera centres -Rᵀ t of world→camera poses, on the CPU."""
    R, t = poses.r.matrix().cpu(), poses.t.cpu()
    return -(R.transpose(-1, -2) @ t[..., None])[..., 0]


# a cost falls when its last value lies this far below the first (relative):
# far above the rounding of the sums, so that a run whose every step is
# rejected does not pass
DIST_FALL_RTOL = 1e-3
# step 7's and step 12's SfM-scale points lie at least this deep in front of
# every camera that sees them: sfm_scale_arrays' plain draws put 19
# observations closer than 0.5 (one point behind its camera, 1.1e6 px
# residuals, 5.6e6 of the 9.4e6 initial cost), where LM rejects step after
# step (step 7 read 7683070.0 -> 7683070.0 on an H100)
DIST_MIN_DEPTH = 1.0


def _falling_costs(costs, what: str, cost0=None, rise: float = 0.0,
                   after_first: bool = False) -> bool:
    """LM costs after each step (and `cost0`, before the first): finite,
    never rising by more than `rise` of the first step's cost, and the last
    at least DIST_FALL_RTOL below `cost0` (or below the first step's cost,
    without `cost0` or with `after_first`, so that a run that rejects every
    step after the first fails). Prints them."""
    c = np.asarray(costs, dtype=np.float64)
    seq = c if cost0 is None else np.concatenate([[cost0], c])
    from_first = cost0 is None or after_first
    fall = 1.0 - c[-1] / (c[0] if from_first else cost0)
    ok = bool(np.isfinite(seq).all() and np.all(np.diff(seq) <= rise * c[0])
              and fall >= DIST_FALL_RTOL)
    print(f"{what}: costs {seq.tolist()}, fall {fall:.4e} from "
          f"{'the first step' if from_first else 'the initial cost'} "
          f"(limit {DIST_FALL_RTOL}){'' if ok else ': NOT FALLING'}")
    return ok


def bench_ba_arrays():
    """bench.py:102-134's problem, built the same way: rng(0), 50 cameras,
    2,000 points, 10,000 observations, f = 300, 0.5 px noise, 0.05 point
    noise; the poses' rotations by the port's So3.exp on the CPU."""
    from kornia_tpu_torch.geometry.liegroup import So3
    C, P, O = 50, 2000, 10000
    rng = np.random.default_rng(0)
    Xw = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    Xw[:, 2] += 6.0
    angles = rng.normal(0, 0.05, (C, 3)).astype(np.float32)
    ts = np.stack([np.linspace(0, 2, C), np.zeros(C), np.zeros(C)],
                  1).astype(np.float32)
    K = np.array([[300.0, 0, 320], [0, 300.0, 240], [0, 0, 1.0]], np.float32)
    cam_idx = rng.integers(0, C, O).astype(np.int32)
    pt_idx = rng.integers(0, P, O).astype(np.int32)
    r = So3.exp(torch.from_numpy(angles))
    Rm = r.matrix().numpy()
    Xc = np.einsum("oij,oj->oi", Rm[cam_idx], Xw[pt_idx]) + ts[cam_idx]
    uv = (Xc[:, :2] / Xc[:, 2:]) * 300.0 + np.array([320.0, 240.0])
    uv += rng.normal(0, 0.5, uv.shape)
    points = Xw + rng.normal(0, 0.05, Xw.shape).astype(np.float32)
    return C, P, dict(wxyz=r.q.data.numpy(), t=ts, points=points,
                      cam_idx=cam_idx, pt_idx=pt_idx,
                      uv=uv.astype(np.float32), valid=np.ones(O, bool), K=K)


def sfm_scale_arrays(min_depth: float = 0.0):
    """__graft_entry__.py:119-146's SfM-scale problem with numpy draws in
    place of jax.random: 100 cameras on a 0.6 rad arc, 20,000 points, each
    seen by T = 6 consecutive cameras (120,000 observations), 0.2 px noise,
    poses perturbed by 0.02 rad / 0.05 and points by 0.1. With `min_depth`
    a point that lies closer than that in front of a camera observing it
    (or behind it) is drawn again from the same distribution."""
    from kornia_tpu_torch.geometry.liegroup import Se3
    from kornia_tpu_torch.slam.ba import _project
    C, P, T = 100, 20000, 6
    rng = np.random.default_rng(1)
    angles = torch.linspace(-0.3, 0.3, C)
    z = torch.zeros(C)
    poses = Se3.exp(torch.stack([z, z, z, z, angles, z], -1))
    poses = Se3(poses.r, poses.t + torch.stack(
        [torch.linspace(-1, 1, C), z, z], -1))
    X = (rng.standard_normal((P, 3)) * 1.5
         + np.array([0.0, 0, 6.0])).astype(np.float32)
    K = np.array([[200.0, 0, 128], [0, 200, 96], [0, 0, 1]], np.float32)
    start = rng.integers(0, C - T, P)
    cam_idx = (start[:, None] + np.arange(T)[None]).reshape(-1)
    pt_idx = np.repeat(np.arange(P), T)
    R, t = poses.r.matrix().numpy(), poses.t.numpy()
    while min_depth:
        depth = (np.einsum("oj,oj->o", R[cam_idx][:, 2], X[pt_idx])
                 + t[cam_idx, 2])
        bad = np.unique(pt_idx[depth < min_depth])
        if not bad.size:
            break
        X[bad] = (rng.standard_normal((bad.size, 3)) * 1.5
                  + np.array([0.0, 0, 6.0])).astype(np.float32)
    ci, pi = torch.from_numpy(cam_idx), torch.from_numpy(pt_idx)
    uv = _project(poses.r.q.data[ci], poses.t[ci], torch.from_numpy(X)[pi],
                  torch.from_numpy(K)).numpy()
    uv = (uv + 0.2 * rng.standard_normal(uv.shape)).astype(np.float32)
    dr = Se3.exp(torch.from_numpy(
        0.02 * rng.standard_normal((C, 6))).float()).r * poses.r
    t0 = poses.t.numpy() + 0.05 * rng.standard_normal((C, 3))
    X0 = X + 0.1 * rng.standard_normal((P, 3))
    return C, P, T, dict(wxyz=dr.q.data.numpy(), t=t0.astype(np.float32),
                         points=X0.astype(np.float32), cam_idx=cam_idx,
                         pt_idx=pt_idx, uv=uv, valid=np.ones(P * T, bool),
                         K=K)


def ba_on(arrs: dict, device):
    """(BAState, BAProblem) of the arrays on `device`."""
    from kornia_tpu_torch import convert
    return (convert.ba_state_from_numpy(arrs["wxyz"], arrs["t"],
                                        arrs["points"], device),
            convert.ba_problem_from_numpy(arrs["cam_idx"], arrs["pt_idx"],
                                          arrs["uv"], arrs["valid"],
                                          arrs["K"], device))


def _rms(state, problem) -> float:
    from kornia_tpu_torch.slam.ba import reprojection_residuals
    r = reprojection_residuals(state, problem)
    return float(r.pow(2).sum(-1).mean().sqrt())


def backend_dense_ba(dev) -> dict:
    """Dense LM BA at bench.py's configuration."""
    from kornia_tpu_torch.metrics.metrics import ate_rmse
    from kornia_tpu_torch.slam.ba import _cost, bundle_adjust, _robust_kernels
    C, P, arrs = bench_ba_arrays()
    state, prob = ba_on(arrs, dev)

    def run(n):
        return bundle_adjust(state, prob, C, P, num_iters=n)

    run(10)  # warm-up: library handles, allocator
    s, costs = no_host_sync(lambda: run(10))
    cost0 = float(_cost(state, prob, _robust_kernels(3.0)["huber"]))
    c = costs.cpu().numpy()
    if not _falling_costs(c, "dense BA", cost0, after_first=True):
        fail("dense BA: the costs do not fall")
    # bench.py's reckoning: the best of a few synchronised calls of 4 and
    # of 24 iterations; 20 iterations over their difference
    t4 = min(synced_s(lambda: run(4)) for _ in range(5))
    t24 = min(synced_s(lambda: run(24)) for _ in range(5))
    it_s = 20.0 / (t24 - t4)
    walls = [synced_s(lambda: run(10)) for _ in range(3)]
    wall10 = statistics.median(walls)
    _, kern = profile_kernels(lambda: run(10))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    peak = peak_bytes(lambda: run(10))
    s2, costs2 = run(10)
    run_to_run = dict(
        cost_any_iter=float((costs2 - costs).abs().max()),
        cost_last=float((costs2[-1] - costs[-1]).abs()),
        points=float((s2.points - s.points).abs().max()))
    # the same call on the CPU port
    state_c, prob_c = ba_on(arrs, "cpu")
    t0 = time.perf_counter()
    s_c, costs_c = bundle_adjust(state_c, prob_c, C, P, num_iters=10)
    cpu_s = time.perf_counter() - t0
    cost_rel = abs(float(c[-1]) - float(costs_c[-1])) / float(costs_c[-1])
    dq = float((s.poses.r.q.data.cpu() - s_c.poses.r.q.data).abs().max())
    centre = float(ate_rmse(_centres(s.poses), _centres(s_c.poses),
                            with_scale=True))
    out = dict(iters_per_s=it_s, ms_per_iter=1e3 / it_s, t4_s=t4, t24_s=t24,
               cost_initial=cost0, cost_first=float(c[0]),
               cost_last=float(c[-1]), final_rms_px=_rms(s, prob),
               peak_bytes=peak, wall10_ms=wall10 * 1e3,
               wall10_runs_ms=[w * 1e3 for w in walls],
               device_busy10_ms=busy_ms, idle_share=1.0 - busy_ms /
               (wall10 * 1e3), kernels_per_iter=sum(e.count for e in kern)
               / 10, card_run_to_run=run_to_run, cpu_seconds=cpu_s,
               cpu_cost_last=float(costs_c[-1]), cpu_cost_rel=cost_rel,
               cpu_quat_max_diff=dq, cpu_centre_rmse_sim3=centre)
    print(f"backend dense BA 50/2000/10000: {it_s:.2f} LM iterations/s "
          f"({1e3 / it_s:.3f} ms/iteration; t(4) {t4:.4f} s, t(24) "
          f"{t24:.4f} s), cost {cost0:.4f} -> {c[0]:.4f} -> {c[-1]:.4f}, "
          f"RMS {out['final_rms_px']:.4f} px, peak {peak / 2**20:.1f} MiB, "
          f"device busy {busy_ms:.3f} of {wall10 * 1e3:.3f} ms (idle share "
          f"{out['idle_share']:.4f}), {out['kernels_per_iter']:.0f} kernels "
          f"an iteration; two card runs differ by {run_to_run}; CPU port "
          f"{cpu_s:.2f} s, final cost rel diff {cost_rel:.2e}, quaternions "
          f"{dq:.2e}, Sim3-aligned centres {centre:.2e}")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    if not (cost_rel <= BA_COST_RTOL and dq <= BA_QUAT_ATOL
            and centre <= BA_CENTRE_ATOL):
        fail("dense BA: card and CPU port disagree")
    return out


def backend_sparse_ba(dev, dense: dict) -> dict:
    """Sparse-Schur BA on bench.py's problem against the dense result, and
    at SfM scale against the dense path at that scale."""
    from kornia_tpu_torch.slam.ba import (_build_normal_eqs, _cost,
                                          _reduced_system, bundle_adjust,
                                          _robust_kernels)
    from kornia_tpu_torch.slam.ba_sparse import (_sparse_system,
                                                 build_point_tables,
                                                 bundle_adjust_sparse)

    def tables(arrs, P, T=0):
        oi, om = build_point_tables(arrs["cam_idx"], arrs["pt_idx"],
                                    arrs["valid"], P, T)
        return torch.from_numpy(oi).to(dev), torch.from_numpy(om).to(dev)

    C, P, arrs = bench_ba_arrays()
    state, prob = ba_on(arrs, dev)
    oi, om = tables(arrs, P)
    _, c = bundle_adjust_sparse(state, prob, oi, om, C, P, num_iters=10)
    bench_cost = float(c[-1])
    bench_rel = abs(bench_cost - dense["cost_last"]) / dense["cost_last"]
    print(f"backend sparse BA 50/2000/10000: final cost {bench_cost:.4f}, "
          f"dense {dense['cost_last']:.4f} (rel diff {bench_rel:.2e})")
    if not bench_rel <= BA_COST_RTOL:
        fail("sparse and dense BA disagree at bench.py's configuration")

    C, P, T, arrs = sfm_scale_arrays(DIST_MIN_DEPTH)
    state, prob = ba_on(arrs, dev)
    oi, om = tables(arrs, P, T)

    def run(n):
        return bundle_adjust_sparse(state, prob, oi, om, C, P, num_iters=n,
                                    init_lambda=0.1)

    run(1)  # warm-up
    runs = [synced_s(lambda: run(10)) for _ in range(2)]
    peak = peak_bytes(lambda: run(10))
    s, costs = run(10)
    c = costs.cpu().numpy()
    cost0 = float(_cost(state, prob, _robust_kernels(3.0)["huber"]))
    if not _falling_costs(c, "sparse BA at SfM scale", cost0,
                          after_first=True):
        fail("sparse BA at SfM scale: the costs do not fall")
    _, c_again = run(10)
    t_dense = synced_s(lambda: bundle_adjust(state, prob, C, P, num_iters=1,
                                             init_lambda=0.1))
    dense_peak = peak_bytes(lambda: bundle_adjust(state, prob, C, P,
                                                  num_iters=1,
                                                  init_lambda=0.1))
    _, cd = bundle_adjust(state, prob, C, P, num_iters=10, init_lambda=0.1)
    if not _falling_costs(cd.cpu().numpy(), "dense BA at SfM scale", cost0,
                          after_first=True):
        fail("dense BA at SfM scale: the costs do not fall")
    # The cross-check at this scale is the reduced camera system of one
    # step, assembled by both paths from the same state: with camera 0
    # alone fixed the scale is a free gauge (S's smallest eigenvalue is the
    # damping λ; its condition number is printed), so a step, and the path
    # of 10 LM iterations through this problem's points near the camera
    # planes, follow rounding: the same sparse call's final cost moves by
    # percents from one card run to the next (printed as "again"). The
    # final costs are reported.
    wf = _robust_kernels(3.0)["huber"]
    lam = torch.full((), 0.1, device=dev)
    S_d, r_d, _ = _reduced_system(
        *_build_normal_eqs(state, prob, C, P, wf)[:5], lam, 1)
    S_s, r_s, _, _ = _sparse_system(state, lam, prob, oi.long(), om, C, P,
                                    wf, True)
    sys_rel = max(float((S_s - S_d).abs().max() / S_d.abs().max()),
                  float((r_s - r_d).abs().max() / r_d.abs().max()))
    ev = torch.linalg.eigvalsh(S_d.double())
    ev_min, cond = float(ev.min()), float(ev.max() / ev.min())
    rel = abs(float(cd[-1]) - float(c[-1])) / float(cd[-1])
    out = dict(bench_cost_last=bench_cost,
               bench_rel_to_dense=bench_rel,
               sfm_ms_per_iter=min(runs) * 1e3 / 10,
               sfm_runs_s=runs, sfm_peak_bytes=peak,
               sfm_cost_first=float(c[0]), sfm_cost_last=float(c[-1]),
               sfm_cost_last_again=float(c_again[-1]),
               sfm_final_rms_px=_rms(s, prob),
               dense_sfm_ms_one_iter=t_dense * 1e3,
               dense_sfm_peak_bytes=dense_peak,
               dense_sfm_cost_last=float(cd[-1]), sfm_rel_to_dense=rel,
               sfm_system_rel_diff=sys_rel, sfm_system_eig_min=ev_min,
               sfm_system_cond=cond)
    print(f"backend sparse BA 100/20000/120000 (T = 6): "
          f"{out['sfm_ms_per_iter']:.3f} ms/iteration (10-iteration calls "
          f"{[round(v, 4) for v in runs]} s), peak {peak / 2**20:.1f} MiB, "
          f"cost {c[0]:.1f} -> {c[-1]:.1f} (again {float(c_again[-1]):.1f}),"
          f" RMS {out['sfm_final_rms_px']:.2f} px; dense path: "
          f"{t_dense * 1e3:.2f} ms for one iteration, peak "
          f"{dense_peak / 2**20:.1f} MiB, final cost {float(cd[-1]):.1f} "
          f"(rel diff {rel:.2e}); reduced systems of one step, sparse vs "
          f"dense: {sys_rel:.2e} of the largest entry (limit "
          f"{BA_SYSTEM_RTOL}); S's smallest eigenvalue {ev_min:.4g}, "
          f"condition number {cond:.3e}")
    if not sys_rel <= BA_SYSTEM_RTOL:
        fail("sparse and dense BA assemble different reduced systems at SfM "
             "scale")
    return out


def ring_arrays(N: int, n_extra: int = 400):
    """__graft_entry__.py:166-185's pose graph (and
    benchmarks/scaling_bench.py::_make_circuit_graph's) with numpy draws in
    place of jax.random: N poses on a circle of radius 8, the odometry chain
    and the loop edges among `n_extra` random pairs more than N/8 apart,
    measured exactly; initial poses perturbed by exp(0.03 · normal) (pose 0
    kept)."""
    from kornia_tpu_torch.geometry.liegroup import Se3, So3, _matvec
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    t_gt = np.stack([np.cos(ang) * 8, np.sin(ang) * 8, np.zeros(N)], -1)
    q_gt = np.stack([np.cos((ang + np.pi / 2) / 2), np.zeros(N),
                     np.zeros(N), np.sin((ang + np.pi / 2) / 2)], -1)
    gt = Se3(So3.from_wxyz(torch.from_numpy(q_gt).float()),
             torch.from_numpy(t_gt).float())
    extra = np.random.default_rng(0).integers(0, N, size=(n_extra, 2))
    extra = extra[np.abs(extra[:, 0] - extra[:, 1]) > N // 8]
    src = np.concatenate([np.arange(N - 1), extra[:, 0]])
    dst = np.concatenate([np.arange(1, N), extra[:, 1]])
    Ti = Se3(So3.from_wxyz(gt.r.q.data[src]), gt.t[src])
    Tj = Se3(So3.from_wxyz(gt.r.q.data[dst]), gt.t[dst])
    meas = Ti.inverse() * Tj
    nz = 0.03 * np.random.default_rng(9).standard_normal((N, 6))
    nz[0] = 0.0
    dT = Se3.exp(torch.from_numpy(nz).float())
    init = Se3(dT.r * gt.r, _matvec(dT.r.matrix(), gt.t) + dT.t)
    return dict(src=src, dst=dst, meas_wxyz=meas.r.q.data.numpy(),
                meas_t=meas.t.numpy(), weight=np.ones(src.shape[0],
                                                      np.float32),
                valid=np.ones(src.shape[0], bool),
                wxyz=init.r.q.data.numpy(), t=init.t.numpy())


def pose_graph_on(arrs: dict, device):
    from kornia_tpu_torch import convert
    return (convert.se3_from_numpy(arrs["wxyz"], arrs["t"], device),
            convert.pose_graph_from_numpy(arrs["src"], arrs["dst"],
                                          arrs["meas_wxyz"], arrs["meas_t"],
                                          arrs["weight"], arrs["valid"],
                                          device))


def backend_pose_graph(dev) -> dict:
    """Se3 (6 iterations) and Sim3 (15) LM on the 2,048-pose ring; both on
    a 256-pose ring on the card and on the CPU port."""
    from kornia_tpu_torch.slam.posegraph import (optimize_pose_graph,
                                                 optimize_pose_graph_sim3)
    opts = {"se3": (lambda p, g, n: optimize_pose_graph(p, g, num_iters=n)[1],
                    6),
            "sim3": (lambda p, g, n: optimize_pose_graph_sim3(
                p, g, num_iters=n)[2], 15)}
    out = {}
    arrs = ring_arrays(PG_RING)
    poses, graph = pose_graph_on(arrs, dev)
    for name, (opt, iters) in opts.items():
        opt(poses, graph, 1)  # warm-up
        costs = []
        wall = synced_s(lambda: costs.append(opt(poses, graph, iters)))
        peak = peak_bytes(lambda: opt(poses, graph, 1))
        c = costs[0].cpu().numpy()
        if not (np.isfinite(c).all() and c[-1] < c[0]):
            fail(f"pose graph {name} at {PG_RING} poses: costs do not fall: "
                 f"{c}")
        out[name] = dict(poses=PG_RING, edges=int(arrs["src"].shape[0]),
                         iters=iters, ms_per_iter=wall * 1e3 / iters,
                         cost_first=float(c[0]), cost_last=float(c[-1]),
                         cost_ratio=float(c[-1] / c[0]), costs=c.tolist(),
                         peak_bytes=peak)
        print(f"backend pose graph {name} {PG_RING} poses / "
              f"{out[name]['edges']} edges: {out[name]['ms_per_iter']:.2f} "
              f"ms/iteration over {iters}, cost {c[0]:.4e} -> {c[-1]:.4e} "
              f"(ratio {c[-1] / c[0]:.3e}), peak {peak / 2**20:.1f} MiB")
    # the card against the CPU port on a smaller ring
    arrs = ring_arrays(PG_XCHECK)
    on_card = pose_graph_on(arrs, dev)
    on_cpu = pose_graph_on(arrs, "cpu")
    for name, (opt, iters) in opts.items():
        cg = opt(*on_card, iters).cpu().numpy()
        cc = opt(*on_cpu, iters).numpy()
        diff = np.abs(cg - cc)
        tol = BA_COST_RTOL * np.abs(cc) + PG_COST_ATOL * cc[0]
        out[name]["xcheck_diff_over_tol"] = float((diff / tol).max())
        print(f"backend pose graph {name} {PG_XCHECK} poses card vs CPU: "
              f"costs {cg[0]:.4e} -> {cg[-1]:.4e}, largest difference "
              f"{out[name]['xcheck_diff_over_tol']:.3f} of its tolerance")
        if not out[name]["xcheck_diff_over_tol"] <= 1.0:
            fail(f"pose graph {name}: card and CPU costs disagree: {cg} vs "
                 f"{cc}")
    return out


def backend_pnp(dev) -> dict:
    """pnp_ransac on 2,000 points, 30% outliers, 256 samples, the same
    injected Gumbel noise on the card and on the CPU."""
    from kornia_tpu_torch.geometry.calibration import pnp_ransac
    from kornia_tpu_torch.geometry.conversions import \
        axis_angle_to_rotation_matrix
    n, n_out, S = 2000, 600, 256
    rng = np.random.default_rng(11)
    X = (rng.standard_normal((n, 3)) + np.array([0.0, 0.0, 5.0])).astype(
        np.float32)
    R = axis_angle_to_rotation_matrix(torch.tensor([[0.05, -0.1, 0.03]]))[0]
    t = np.array([0.2, 0.1, -0.3], np.float32)
    Xc = X @ R.numpy().T + t
    uv = Xc[:, :2] / Xc[:, 2:]
    uv[:n_out] += 0.5 * rng.standard_normal((n_out, 2))
    u = np.maximum(rng.random((S, n)), np.finfo(np.float32).tiny)
    gumbel = torch.from_numpy(-np.log(-np.log(u))).float()
    X_t, uv_t = torch.from_numpy(X), torch.from_numpy(uv.astype(np.float32))

    def run(device):
        return pnp_ransac(X_t.to(device), uv_t.to(device), None, 5e-3,
                          batch_size=S, gumbel=gumbel.to(device))

    run(dev)  # warm-up
    ms = statistics.median(synced_s(lambda: run(dev)) for _ in range(3)) * 1e3
    Rg, tg, inl_g, _ = run(dev)
    Rc, tc, inl_c, _ = run("cpu")
    deg = math.degrees(angle_of_rotation(Rg.cpu().T @ R))
    truth = torch.arange(n) >= n_out
    out = dict(ms=ms, rotation_err_deg=deg, inliers=int(inl_g.sum()),
               t_err=float((tg.cpu() - torch.from_numpy(t)).abs().max()),
               inliers_equal_truth=bool((inl_g.cpu() == truth).all()),
               inliers_equal_cpu=bool((inl_g.cpu() == inl_c).all()),
               cpu_R_max_diff=float((Rg.cpu() - Rc).abs().max()))
    print(f"backend pnp_ransac 2000 points / 30% outliers: {ms:.2f} ms, "
          f"rotation error {deg:.4f} deg, {out['inliers']} inliers (equal to "
          f"the true set: {out['inliers_equal_truth']}; to the CPU port's: "
          f"{out['inliers_equal_cpu']}), R card vs CPU "
          f"{out['cpu_R_max_diff']:.2e}")
    if not (deg < PNP_MAX_DEG and out["inliers_equal_truth"]
            and out["inliers_equal_cpu"]):
        fail("pnp_ransac: pose, inlier set or card-vs-CPU check failed")
    return out


def backend_sfm(dev) -> dict:
    """incremental_sfm at 12 views x 2,000 points (480 x 640 intrinsics,
    rotation_scale 0.15, translation_scale 0.4, 0.3 px noise, ba_iters 10)
    on the card and on the CPU port."""
    from kornia_tpu_torch.geometry.scene import generate_scene
    from kornia_tpu_torch.metrics.metrics import ate_rmse
    from kornia_tpu_torch.slam.sfm import incremental_sfm
    V, N = 12, 2000
    rng = np.random.default_rng(0)
    draws = {"aa": rng.standard_normal((V, 3)),
             "t": rng.standard_normal((V, 3, 1)),
             "X": rng.standard_normal((N, 3))}
    noise = 0.3 * rng.standard_normal((V, N, 2))
    s = generate_scene(num_views=V, num_points=N, image_size=(480.0, 640.0),
                       rotation_scale=0.15, translation_scale=0.4,
                       draws={k: torch.from_numpy(v) for k, v in
                              draws.items()}, device="cpu")
    obs = (s["points2d"].numpy() + noise).astype(np.float32)
    vis = np.ones((V, N), bool)
    C_gt = -(s["R"].transpose(-1, -2) @ s["t"])[..., 0]

    def run(device):
        return incremental_sfm(obs, vis, s["K"][0], ba_iters=10,
                               device=device)

    first_s = synced_s(lambda: run(dev))
    res = []
    card_s = synced_s(lambda: res.append(run(dev)))
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    card = res[0]
    ate = float(ate_rmse(_centres(card.poses), C_gt, with_scale=True))
    centre = float(ate_rmse(_centres(card.poses), _centres(cpu.poses),
                            with_scale=True))
    out = dict(seconds=card_s, first_call_seconds=first_s,
               cpu_seconds=cpu_s, final_rms_px=card.final_rms,
               cpu_final_rms_px=cpu.final_rms, ate_sim3=ate,
               cpu_centre_rmse_sim3=centre,
               points=int(card.point_valid.sum()))
    print(f"backend incremental_sfm 12 x 2000: {card_s:.3f} s on the card "
          f"(first call {first_s:.3f} s), {cpu_s:.3f} s on the CPU port; "
          f"final RMS {card.final_rms:.4f} px (CPU {cpu.final_rms:.4f}), "
          f"Sim3 ATE {ate:.3e}, card vs CPU centres {centre:.2e}, "
          f"{out['points']} points")
    if not (card.final_rms < SFM_RMS_MAX and ate < SFM_ATE_MAX):
        fail("incremental_sfm: final RMS or ATE over the bounds of "
             "tests/test_sfm.py")
    if not (np.array_equal(card.point_valid, cpu.point_valid)
            and abs(card.final_rms - cpu.final_rms) <= SFM_RMS_ATOL
            and centre <= SFM_CENTRE_ATOL):
        fail("incremental_sfm: card and CPU port disagree")
    return out


def backend_phase(dev, card: str) -> dict:
    """Step 7: the SLAM back end, part by part; one JSON line."""
    t0 = time.perf_counter()
    out = {"card": card}
    out["dense_ba"] = backend_dense_ba(dev)
    out["sparse_ba"] = backend_sparse_ba(dev, out["dense_ba"])
    out["pose_graph"] = backend_pose_graph(dev)
    out["pnp"] = backend_pnp(dev)
    out["sfm"] = backend_sfm(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"backend phase: {out['seconds']:.1f} s")
    print(json.dumps({"backend": out}))
    return out


# --- step 8: the planar tracker -------------------------------------------

def planar_homographies(h: int, w: int) -> np.ndarray:
    """The fixed, seeded sequence of target -> frame homographies, one a
    frame: about the image centre, rotation ramping to 7 deg, scale to 0.92,
    translation to (28, -20) px and perspective terms to (1.8e-5, -1.2e-5),
    each with a little seeded jitter. Consecutive frames differ by under
    25 px at the image corners, so that the tracker's 30 px chaining gate
    keeps the true matches."""
    rng = np.random.default_rng(SEED + 8)
    c = np.array([[1.0, 0.0, (w - 1) / 2], [0.0, 1.0, (h - 1) / 2],
                  [0.0, 0.0, 1.0]])
    out = []
    for i in range(1, PLANAR_FRAMES + 1):
        f = i / PLANAR_FRAMES
        ang = math.radians(7.0 * f + rng.uniform(-0.25, 0.25))
        s = 1.0 - 0.08 * f + rng.uniform(-0.005, 0.005)
        tx, ty = 28.0 * f + rng.uniform(-1, 1), -20.0 * f + rng.uniform(-1, 1)
        A = np.array([[s * math.cos(ang), -s * math.sin(ang), tx],
                      [s * math.sin(ang), s * math.cos(ang), ty],
                      [1.8e-5 * f, -1.2e-5 * f, 1.0]])
        out.append(c @ A @ np.linalg.inv(c))
    return np.stack(out).astype(np.float32)


def map_corners(Hm: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The image's four corners mapped by (3, 3) or (1, 3, 3) Hm."""
    p = torch.tensor([[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
                      [w - 1.0, h - 1.0, 1.0], [0.0, h - 1.0, 1.0]],
                     dtype=torch.float64)
    q = p @ Hm.reshape(3, 3).detach().cpu().double().T
    return q[:, :2] / q[:, 2:]


def planar_launch_shapes(h: int, w: int):
    """The shapes at which one image of the tracker (GFTTSIFTFeature on
    ScalePyramid(3, 1.6, 32)) launches each ported kernel: the pair's
    (path_launch_shapes, depth 1) and, per octave, the structure tensor's
    three blurs (k = 7, reflect) over the octave's six levels."""
    base = path_launch_shapes(h, w)
    fused = [(hh, ww, k, border, 1)
             for hh, ww, k, border in base["fused_separable_blur2d"]]
    for hh, ww in base["multi_level_blur"]:
        fused += [(hh, ww, 7, "reflect", GFTT_LEVELS)] * 3
    return dict(base, fused_separable_blur2d=fused)


def planar_blur_checks(K, filters, dev) -> dict:
    """The structure tensor's blurs at depth 6 on every octave of the
    tracker's pyramid, and SIFTFeatureScaleSpace's 960x1280 octave of
    multi_level_blur, each against its plain version on its named route;
    then a SIFTFeatureScaleSpace run, its launches counted and its
    multi-level calls captured (the kernels line's doubled octave)."""
    from kornia_tpu_torch.feature.integrated import SIFTFeatureScaleSpace
    from kornia_tpu_torch.ops.pyramid import ScalePyramid
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    k7 = filters.get_gaussian_kernel1d(7, 1.0, device=dev).reshape(-1)
    for hh, ww in path_launch_shapes(H, W)["multi_level_blur"]:
        x = torch.rand((GFTT_LEVELS, 1, hh, ww), device=dev, generator=gen)
        route, out = check_route(
            K, "fused_separable_blur2d", hh, ww,
            lambda: K.fused_separable_blur2d(x, k7, k7, "reflect"))
        e = (out - K.fused_separable_blur2d_plain(x, k7, k7, "reflect")
             ).abs().max().item()
        print(f"planar: structure tensor blur {GFTT_LEVELS}x{hh}x{ww} k=7 "
              f"reflect ({route}): max abs err {e:.3e}")
        if not e <= BLUR_ATOL:
            fail(f"structure tensor blur disagrees with its plain version: "
                 f"{e} > {BLUR_ATOL}")

    # the doubled octave: its own launch against the plain version
    pyr = ScalePyramid(3, 1.6, 32, double_image=True)
    kers, _ = pyr._level_kernels(1.6)
    x = torch.rand((1, 1, 2 * H, 2 * W), device=dev, generator=gen)
    route, out = check_route(
        K, "multi_level_blur", 2 * H, 2 * W,
        lambda: K.multi_level_blur(x, kers, kers, "replicate"))
    e = (out - K.multi_level_blur_plain(x, kers, kers, "replicate")
         ).abs().max().item()
    print(f"planar: multi_level_blur {2 * H}x{2 * W} L={len(kers)} "
          f"({route}): max abs err {e:.3e} (tol {ML_ATOL:.0e})")
    if not e <= ML_ATOL:
        fail(f"multi_level_blur at {2 * H}x{2 * W} disagrees with its plain "
             f"version: {e} > {ML_ATOL}")
    # and a SIFTFeatureScaleSpace run: every octave on its named route
    target = bench_input(H, W, dev)[0]
    sss = lambda: SIFTFeatureScaleSpace(  # noqa: E731
        num_features=PLANAR_NF)(target)
    launches = counted_run(K, sss, "planar: SIFTFeatureScaleSpace 480x640",
                           ("multi_level_blur",))
    octaves = [(2 * H >> o, 2 * W >> o)
               for o in range(pyr.n_octaves(H, W))]
    want = {}
    for hh, ww in octaves:
        key = "multi_level_blur:" + expected_route("multi_level_blur", hh, ww)
        want[key] = want.get(key, 0) + 1
    print(f"planar: SIFTFeatureScaleSpace 480x640 doubled octaves {octaves}")
    for key, n in want.items():
        if launches.get(key) != n:
            fail(f"SIFTFeatureScaleSpace launched {key} "
                 f"{launches.get(key)} times, PERF.md's routes give {n}")
    calls = capture_launches(K, sss, ("multi_level_blur",))
    return path_entries(K, calls, check_captured(
        K, calls, "planar: SIFTFeatureScaleSpace"), launches, "double_image")


def planar_phase(K, filters, dev) -> dict:
    """Step 8: the planar tracker on the card (see the module's
    docstring)."""
    from kornia_tpu_torch.ops.warp import warp_perspective
    from kornia_tpu_torch.tracking import planar_tracker as pt

    t_phase = time.perf_counter()
    target = bench_input(H, W, dev)[0]
    Hs = torch.from_numpy(planar_homographies(H, W)).to(dev)
    frames = [warp_perspective(target, Hs[i:i + 1], (H, W))
              for i in range(PLANAR_FRAMES)]
    # RANSAC's noise for each frame, shared by the card and the CPU port
    cpu_gen = torch.Generator().manual_seed(SEED + 9)
    gumbels = []
    for _ in range(PLANAR_FRAMES):
        u = torch.rand((8, 512, PLANAR_NF), generator=cpu_gen).clamp_min(
            torch.finfo(torch.float32).tiny)
        gumbels.append(-torch.log(-torch.log(u)))
    gumbels_dev = [g.to(dev) for g in gumbels]
    # the tracker's RANSAC results, read by a spy (as capture_patch_coords)
    found = []
    real_ransac = pt.ransac

    def spy(*args, **kwargs):
        res = real_ransac(*args, **kwargs)
        found.append(res)
        return res

    def track(device, frames_, gumbels_):
        tr = pt.HomographyTracker(num_features=PLANAR_NF, device=device)
        tr.set_target(target.to(device))
        found.clear()
        out = [tr(f, gumbel=g) for f, g in zip(frames_, gumbels_)]
        return out, list(found)

    pt.ransac = spy
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        card, card_res = track(dev, frames, gumbels_dev)
        torch.cuda.synchronize()
        launches = dict(K.launches)
        cpu, cpu_res = track("cpu", [f.cpu() for f in
                                     frames[:PLANAR_XCHECK]],
                             gumbels[:PLANAR_XCHECK])
    finally:
        pt.ransac = real_ransac
    print(f"planar: launches over {PLANAR_FRAMES} frames: {launches}")
    for name in PAIR_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"planar path never launched kernel {name}")
    errs = []
    for i, ((Hc, ok), res) in enumerate(zip(card, card_res)):
        d = (map_corners(Hc, H, W) - map_corners(Hs[i], H, W)).norm(dim=-1)
        errs.append([float(d.mean()), float(d.max())])
        print(f"planar frame {i}: success {bool(ok)}, inliers "
              f"{int(res.inlier_count)}, RANSAC rounds {res.rounds}, corner "
              f"error mean {errs[-1][0]:.4f} px max {errs[-1][1]:.4f} px")
        if not bool(ok):
            fail(f"planar frame {i}: the tracker failed "
                 f"({int(res.inlier_count)} inliers)")
        if not (errs[-1][0] <= CORNER_MEAN_PX and
                errs[-1][1] <= CORNER_MAX_PX):
            fail(f"planar frame {i}: corners {errs[-1]} px from the true "
                 f"homography's (limits {CORNER_MEAN_PX}, {CORNER_MAX_PX})")
    xcheck = []
    for i in range(PLANAR_XCHECK):
        d = float((map_corners(card[i][0], H, W)
                   - map_corners(cpu[i][0], H, W)).norm(dim=-1).max())
        nc, nx = int(card_res[i].inlier_count), int(cpu_res[i].inlier_count)
        xcheck.append(dict(corner_px=d, inliers_card=nc, inliers_cpu=nx))
        print(f"planar frame {i} card vs CPU port: corners {d:.2e} px apart,"
              f" inliers {nc} vs {nx}")
        if not (d <= XCHECK_CORNER_PX and
                abs(nc - nx) <= XCHECK_INLIER_RTOL * max(nc, nx)):
            fail(f"planar frame {i}: card and CPU port disagree: {xcheck[-1]}")

    # ms per frame: a fresh tracker, host clock around synchronised calls
    tr = pt.HomographyTracker(num_features=PLANAR_NF, device=dev)
    tr.set_target(target)
    times = []
    for f, g in zip(frames, gumbels_dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr(f, gumbel=g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times)
    print(f"planar: HomographyTracker 480x640/{PLANAR_NF}f median "
          f"{frame_ms:.2f} ms/frame, runs {[round(v, 2) for v in times]}")

    # stages: the tracker's steps, synchronised between them
    from kornia_tpu_torch.geometry.homography import oneway_transfer_error
    stages = {k: [] for k in ("features x2", "match", "ransac", "lo")}
    rounds = []
    for i in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, _, d0, v0 = tr.matcher.local_feature(target)
        l1, _, d1, v1 = tr.matcher.local_feature(frames[i])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, idx, valid = tr.matcher.matcher(d0[0], d1[0], v0[0], v1[0])
        kp0 = l0[0, :, :, 2]
        kp1 = l1[0, :, :, 2][idx[:, 1]]
        err = oneway_transfer_error(kp0[None], kp1[None],
                                    card[i - 1][0], False)[0]
        valid = valid & (err < 30.0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rr = real_ransac(kp0, kp1, model_type="homography", inl_th=3.0,
                         batch_size=512, max_iterations=8, mask=valid,
                         polish_iters=0, gumbel=gumbels_dev[i])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        real_ransac(kp0, kp1, model_type="homography", inl_th=3.0,
                    batch_size=512, max_iterations=8, mask=valid,
                    gumbel=gumbels_dev[i])
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        rounds.append(rr.rounds)
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2,
                                 (t4 - t3) - (t3 - t2))):
            stages[k].append(v * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    print(f"planar stages (median ms, host clock, synchronised; lo = full "
          f"RANSAC minus RANSAC without local optimisation): "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }, RANSAC "
          f"rounds {rounds}")

    # the launch list of the tracked sequence (two detections a frame), then
    # one frame (chained from frame 0's estimate) counted, profiled on the
    # device and captured: the busy share, each kernel's device time and
    # bound a frame, each call held to its plain version on its route
    check_launch_list(launches, planar_launch_shapes(H, W),
                      2 * PLANAR_FRAMES, "planar")

    def frame():
        tr.previous_homography = card[0][0]
        tr(frames[1], gumbel=gumbels_dev[1])

    frame_launches = counted_run(K, frame, "planar: one frame")
    calls = capture_launches(K, frame)
    results, counts = path_entries(K, calls, check_captured(K, calls,
                                                            "planar"),
                                   launches, "planar")
    busy_ms, n_kernels, kern = device_profile(frame, tuple(PAIR_KERNELS))
    print(f"planar: device busy {busy_ms:.3f} ms of a {frame_ms:.2f} ms "
          f"frame (idle share {1.0 - busy_ms / frame_ms:.4f}), device kernels "
          f"launched {n_kernels}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    per_frame = path_kernel_times(K, kern, calls, frame_launches,
                                  "planar per frame")
    routes = {k: v for k, v in launches.items() if ":" in k}
    print(f"planar: routes over {PLANAR_FRAMES} frames {routes}")
    doubled, doubled_counts = planar_blur_checks(K, filters, dev)
    results.update(doubled)
    counts.update(doubled_counts)
    report(results)
    out = dict(frame_ms=frame_ms, frame_runs_ms=times, stage_ms=stage_ms,
               ransac_rounds=rounds, busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / frame_ms,
               kernels_per_frame=n_kernels, per_frame=per_frame,
               routes=routes, corner_err_px=errs, xcheck=xcheck,
               inliers=[int(r.inlier_count) for r in card_res],
               seconds=time.perf_counter() - t_phase)
    print(f"planar phase: {out['seconds']:.1f} s")
    print(json.dumps({"planar": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 9: visual odometry and loop closure ------------------------------

# benchmarks/ate_bench.py's protocol at 480x640 with ATE_RESULTS.json's VO
# overrides (incremental_ba=False, global_ba_passes=6, ransac_iters=32)
VO_NF = 512
VO_KW = dict(num_features=VO_NF, ransac_iters=32, ransac_batch=256,
             incremental_ba=False, global_ba_passes=6)
VO_WALK, VO_LOOP = 100, 48       # frames of the walk and of the loop
VO_ATE_PCT = 5.0      # the refined walk's ATE, % of path length: a sanity
#                       limit (parity with the reference is held on the CPU)
LOOP_SLACK = 0.05     # closed ATE at most open ATE + this (metres;
#                       tests/test_loop_closure.py:62)
LOOP_MIN_SEP = 12
VO_XCHECK = 4         # walk frames also tracked by the CPU port
VO_XCHECK_RAD = 1e-3  # card vs CPU port: rotations, and inlier counts
VO_XCHECK_INL = 0.02  # within 2% of each other
VO_PROFILE = 5        # tracked frames under torch.profiler


def vo_setup(dev):
    """K (f = 0.8 W) and the room (tex_size 512), made on the card from a
    seeded generator."""
    from kornia_tpu_torch.utils.render import make_room_scene
    Kt = torch.tensor([[0.8 * W, 0.0, W / 2], [0.0, 0.8 * W, H / 2],
                       [0.0, 0.0, 1.0]], device=dev)
    scene = make_room_scene(torch.Generator(dev).manual_seed(SEED + 7),
                            tex_size=512, device=dev)
    return Kt, scene


def _cam_centres(poses) -> np.ndarray:
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def _ate_pct(poses, gt_c: np.ndarray, length: float) -> float:
    from kornia_tpu_torch.metrics.metrics import ate_rmse
    a = ate_rmse(torch.from_numpy(_cam_centres(poses).astype(np.float64)),
                 torch.from_numpy(gt_c.astype(np.float64)), with_scale=True)
    return 100.0 * float(a) / length


def _path_length(gt_c: np.ndarray) -> float:
    return float(np.sum(np.linalg.norm(np.diff(gt_c, axis=0), axis=1)))


class _StepSpy:
    """Records each pair step's host read (vo.py::_read_step): its time
    and its diagnostics (use_pnp at 2, use_h at 7)."""

    def __init__(self, vo_mod):
        self.mod, self.real = vo_mod, vo_mod._read_step
        self.reads = []

    def __enter__(self):
        def spy(*args):
            h = self.real(*args)
            self.reads.append((time.perf_counter(), h))
            return h
        self.mod._read_step = spy
        return self

    def __exit__(self, *exc):
        self.mod._read_step = self.real


def vo_walk(K, dev, Kt, scene) -> dict:
    """The walk: rendered and degraded on the card, then run(refine=True)
    with the launch counters reset just before and read just after."""
    from kornia_tpu_torch.slam import vo as vo_mod
    from kornia_tpu_torch.utils.render import (degrade_sequence,
                                               render_sequence,
                                               walk_trajectory)
    traj = walk_trajectory(VO_WALK, depth=10.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, _ = render_sequence(scene, Kt, traj, H, W)
    frames = degrade_sequence(frames,
                              torch.Generator(dev).manual_seed(SEED + 5))
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    vo = vo_mod.VisualOdometry(Kt, device=dev, **VO_KW)
    # frame i's tracking time: from its detection to the host read of its
    # pair step; the global BA timed around _refine_tracks
    starts, ba_s = [], []
    detect, refine = vo._detect_fn(), vo._refine_tracks

    def timed_detect(img):
        starts.append(time.perf_counter())
        return detect(img)

    def timed_refine(*args):
        t = time.perf_counter()
        out = refine(*args)
        torch.cuda.synchronize()
        ba_s.append(time.perf_counter() - t)
        return out

    vo._detect_jit, vo._refine_tracks = timed_detect, timed_refine
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    with _StepSpy(vo_mod) as spy:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        res = vo.run(frames, gen, refine=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(K.launches)
    track_ms = [(t - s) * 1e3 for s, (t, _) in zip(starts[1:], spy.reads)]
    gt_c = _cam_centres(traj)
    L = _path_length(gt_c)
    for i, p in enumerate(res.poses):
        if not np.isfinite(p).all():
            fail(f"vo walk: pose {i} is not finite")
    if vo.kf_frames[0] != 0:
        fail(f"vo walk: first keyframe {vo.kf_frames[0]}, not frame 0")
    ate = _ate_pct(res.poses, gt_c, L)
    out = dict(frames=VO_WALK, render_s=render_s, run_s=run_s,
               frames_per_s=VO_WALK / run_s,
               track_ms_median=statistics.median(track_ms),
               track_ms_p90=float(np.percentile(track_ms, 90)),
               global_ba_s=sum(ba_s), keyframes=len(vo.kf_frames),
               path_m=L, ate_pct=ate,
               use_pnp=int(sum(bool(h["diag"][2]) for _, h in spy.reads)),
               use_h=int(sum(bool(h["diag"][7]) for _, h in spy.reads)),
               launches=launches)
    print(f"vo walk {VO_WALK}x{H}x{W}/{VO_NF}f: render+degrade "
          f"{render_s:.2f} s, run {run_s:.2f} s ({out['frames_per_s']:.3f} "
          f"frames/s), tracking median {out['track_ms_median']:.1f} ms p90 "
          f"{out['track_ms_p90']:.1f} ms, global BA {out['global_ba_s']:.2f} "
          f"s, {out['keyframes']} keyframes, PnP on {out['use_pnp']} / H on "
          f"{out['use_h']} of {VO_WALK - 1} steps, ATE {ate:.3f}% of "
          f"{L:.2f} m")
    print(f"vo walk launches: {launches}")
    if not ate < VO_ATE_PCT:
        fail(f"vo walk: refined ATE {ate:.3f}% of the path, limit "
             f"{VO_ATE_PCT}%")
    return dict(out, frames_list=frames, traj=traj)


def vo_stages(dev, Kt, frames) -> dict:
    """The tracking step's stages on the walk's first frames
    (refine=False), each call synchronised: detection, essential RANSAC,
    homography RANSAC, PnP, and the rest of the pair step (matching, pose
    choice, triangulation, map update)."""
    from kornia_tpu_torch.slam import vo as vo_mod
    vo = vo_mod.VisualOdometry(Kt, device=dev, **VO_KW)
    times = {k: [] for k in ("detect", "essential", "homography", "pnp",
                             "pair")}
    real = {"ransac": vo_mod.ransac, "pnp_ransac": vo_mod.pnp_ransac}
    detect, pair = vo._detect_fn(), vo._pair_fn()

    def clock(key, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            k = key(args) if callable(key) else key
            times[k].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    vo_mod.ransac = clock(lambda a: a[3], real["ransac"])
    vo_mod.pnp_ransac = clock("pnp", real["pnp_ransac"])
    vo._detect_jit = clock("detect", detect)
    vo._pair_jit = clock("pair", pair)
    try:
        vo.run(frames[:9], torch.Generator(dev).manual_seed(SEED + 12),
               refine=False)
    finally:
        vo_mod.ransac, vo_mod.pnp_ransac = real["ransac"], real["pnp_ransac"]
    med = {k: statistics.median(v) for k, v in times.items()}
    med["map update and rest"] = med.pop("pair") - med["essential"] \
        - med["homography"] - med["pnp"]
    print(f"vo stages (median ms over 8 steps, synchronised): "
          f"{ {k: round(v, 2) for k, v in med.items()} }")
    return med


def vo_loop(dev, Kt, scene) -> dict:
    """The closed circuit: run(refine=True), then close_loops with
    tests/test_loop_closure.py's parameters."""
    from kornia_tpu_torch.slam.loop_closure import close_loops
    from kornia_tpu_torch.slam.vo import VisualOdometry
    from kornia_tpu_torch.utils.render import (loop_trajectory,
                                               render_sequence)
    traj = loop_trajectory(VO_LOOP, rx=1.2, rz=2.4)
    frames, _ = render_sequence(scene, Kt, traj, H, W)
    vo = VisualOdometry(Kt, device=dev, **VO_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = vo.run(frames, torch.Generator(dev).manual_seed(SEED + 13),
                 refine=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    f = float(Kt[0, 0])
    t0 = time.perf_counter()
    closed, edges = close_loops(vo.frame_cache, res.poses, Kt.cpu().numpy(),
                                min_separation=LOOP_MIN_SEP, sim_th=0.75,
                                min_inliers=15, min_inlier_frac=0.35,
                                inl_th=1.5 / f, loop_weight=10.0,
                                pg_iters=40, device=dev)
    torch.cuda.synchronize()
    close_s = time.perf_counter() - t0
    gt_c = _cam_centres(traj)
    L = _path_length(gt_c)
    open_pct, closed_pct = _ate_pct(res.poses, gt_c, L), \
        _ate_pct(closed, gt_c, L)
    out = dict(frames=VO_LOOP, run_s=run_s, close_s=close_s,
               keyframes=len(vo.kf_frames), path_m=L,
               ate_open_pct=open_pct, ate_closed_pct=closed_pct,
               edges=[(e.i, e.j, e.num_inliers, round(e.similarity, 4))
                      for e in edges])
    print(f"vo loop {VO_LOOP}x{H}x{W}: run {run_s:.2f} s, close_loops "
          f"{close_s:.2f} s, {out['keyframes']} keyframes, edges "
          f"{out['edges']}, ATE open {open_pct:.3f}% closed "
          f"{closed_pct:.3f}% of {L:.2f} m")
    if not any(e.i - e.j >= LOOP_MIN_SEP for e in edges):
        fail(f"vo loop: no accepted loop edge {LOOP_MIN_SEP} or more frames "
             f"apart: {out['edges']}")
    slack_pct = 100.0 * LOOP_SLACK / L
    if not closed_pct < open_pct + slack_pct:
        fail(f"vo loop: closing raised the ATE from {open_pct:.3f}% to "
             f"{closed_pct:.3f}% (slack {slack_pct:.3f}%)")
    return out


def vo_draws(n_steps: int):
    """Seeded CPU Gumbel noise of each pair step (essential and homography
    RANSAC, PnP), shared by the card and the CPU port."""
    gen = torch.Generator().manual_seed(SEED + 14)
    tiny = torch.finfo(torch.float32).tiny

    def g(shape):
        u = torch.rand(shape, generator=gen).clamp_min(tiny)
        return -torch.log(-torch.log(u))

    ri, rb = VO_KW["ransac_iters"], VO_KW["ransac_batch"]
    return [(g((ri, rb, VO_NF)), g((ri, rb, VO_NF)), g((rb // 2, VO_NF)))
            for _ in range(n_steps)]


def vo_xcheck(dev, Kt, frames) -> dict:
    """The walk's first frames (refine=False) on the card and on the CPU
    port with the same injected noise."""
    from kornia_tpu_torch.slam import vo as vo_mod
    draws = vo_draws(VO_XCHECK - 1)
    runs = {}
    for where, fr, dr in (
            ("card", frames[:VO_XCHECK],
             [tuple(d.to(dev) for d in s) for s in draws]),
            ("cpu", [f.cpu() for f in frames[:VO_XCHECK]], draws)):
        vo = vo_mod.VisualOdometry(Kt.cpu(), device=dev if where == "card"
                                   else "cpu", **VO_KW)
        with _StepSpy(vo_mod) as spy:
            res = vo.run(fr, refine=False, draws=dr)
        runs[where] = dict(res=res, kf=list(vo.kf_frames),
                           flags=[(bool(h["diag"][2]), bool(h["diag"][7]))
                                  for _, h in spy.reads])
    c, x = runs["card"], runs["cpu"]
    rot = [angle_of_rotation(torch.from_numpy(a[:3, :3] @ b[:3, :3].T))
           for a, b in zip(c["res"].poses, x["res"].poses)]
    inl = list(zip(c["res"].num_inliers, x["res"].num_inliers))
    out = dict(keyframes_card=c["kf"], keyframes_cpu=x["kf"],
               flags_card=c["flags"], flags_cpu=x["flags"],
               rot_diff_rad=rot, inliers=inl)
    print(f"vo card vs CPU port, {VO_XCHECK} frames: keyframes {c['kf']} / "
          f"{x['kf']}, (use_pnp, use_h) {c['flags']} / {x['flags']}, "
          f"rotations apart {[f'{r:.2e}' for r in rot]} rad, inliers {inl}")
    if c["kf"] != x["kf"] or c["flags"] != x["flags"]:
        fail(f"vo: card and CPU port took other decisions: {out}")
    if not max(rot) <= VO_XCHECK_RAD:
        fail(f"vo: card and CPU port rotations {max(rot):.3e} rad apart "
             f"(limit {VO_XCHECK_RAD})")
    for a, b in inl:
        if abs(a - b) > VO_XCHECK_INL * max(a, b):
            fail(f"vo: card and CPU port inlier counts {a} and {b}")
    return out


def vo_profile(K, dev, Kt, frames, track_ms: float) -> dict:
    """VO_PROFILE tracked frames (detection, pair step, host read) after
    the keyframe's detection, counted, under torch.profiler and captured:
    device busy ms, idle share against the walk's median tracking time,
    kernels a frame, each ported kernel's device time and bound a frame,
    each captured call held to its plain version. Only the device is
    traced: with the host's operators traced too (190k launches in 5
    frames) this part took about two minutes."""
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.slam import vo as vo_mod
    vo = vo_mod.VisualOdometry(Kt, device=dev, **VO_KW)
    detect, pair = vo._detect_fn(), vo._pair_fn()
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    inl_th = float(np.float32(vo.inl_th_px / vo._focal))
    with f32_precision():
        kf = detect(frames[0])
        state = [torch.zeros(VO_NF, device=dev), torch.tensor(False,
                                                               device=dev),
                 torch.eye(3, device=dev), torch.zeros(3, device=dev)]

        def frames_fn():
            for i in range(1, VO_PROFILE + 1):
                cur = detect(frames[i])
                out = pair(*kf, *cur, vo.K, gen, inl_th, *state)
                vo_mod._read_step(out[0], out[1], out[3], out[7], *cur,
                                  out[4], out[5], out[6])

        # counted (also the warm-up), traced, captured
        launches = counted_run(K, frames_fn,
                               f"vo: {VO_PROFILE} profiled frames")
        busy, n_k, kern = device_profile(frames_fn, tuple(PAIR_KERNELS))
        calls = capture_launches(K, frames_fn)
    busy, n_k = busy / VO_PROFILE, n_k / VO_PROFILE
    print(f"vo profile: device busy {busy:.3f} ms of a {track_ms:.1f} ms "
          f"frame (idle share {1.0 - busy / track_ms:.4f}), {n_k:.0f} "
          f"kernels a frame")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / VO_PROFILE:9.3f} ms a "
              f"frame x{e.count // VO_PROFILE:<6d} {e.key[:90]}")
    per = path_kernel_times(K, kern, calls, launches,
                            f"vo: {VO_PROFILE} frames,")
    per_frame = {n: {k: v / VO_PROFILE for k, v in d.items()}
                 for n, d in per.items()}
    return dict(busy_ms=busy, idle_share=1.0 - busy / track_ms,
                kernels_per_frame=n_k, per_frame=per_frame, calls=calls,
                checks=check_captured(K, calls, "vo"))


def vo_phase(K, dev) -> dict:
    """Step 9: visual odometry and loop closure on the card (see the
    module's docstring)."""
    t_phase = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        part_s[name] = time.perf_counter() - t
        return out

    Kt, scene = part("setup", vo_setup, dev)
    walk = part("walk", vo_walk, K, dev, Kt, scene)
    frames = walk.pop("frames_list")
    walk.pop("traj")
    launches = walk.pop("launches")
    for name in PAIR_KERNELS:
        if launches.get(name, 0) <= 0:
            fail(f"vo path never launched kernel {name}")
    stages = part("stages", vo_stages, dev, Kt, frames)
    loop = part("loop", vo_loop, dev, Kt, scene)
    xcheck = part("xcheck", vo_xcheck, dev, Kt, frames)
    prof = part("profile", vo_profile, K, dev, Kt, frames,
                walk["track_ms_median"])
    check_launch_list(launches, planar_launch_shapes(H, W), VO_WALK, "vo")
    results, counts = path_entries(K, prof.pop("calls"), prof.pop("checks"),
                                   launches, "vo")
    report(results)
    out = dict(walk=walk, stage_ms=stages, loop=loop, xcheck=xcheck, **prof,
               routes={k: v for k, v in launches.items() if ":" in k},
               part_s=part_s, seconds=time.perf_counter() - t_phase)
    print(f"vo phase: {out['seconds']:.1f} s, parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }")
    print(json.dumps({"vo": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 10: learned features and dense matching ------------------------------

LEARNED_XCHECK_RTOL = 1e-4  # card vs CPU port: LAFs, of their largest entry
LEARNED_DESC_ATOL = 1e-4    # ... descriptors of the same LAFs (unit rows)
LEARNED_AGREE = 0.99        # ... share of equal matches (near ties may swap)
# Key.Net's LAFs end to end (AffNet's f32 rounding moves OriNet's angle):
# 1.38e-4 of the largest entry on the H100 at 256x256/512f, PERF.md §6
KEYNET_E2E_LAF_RTOL = 1e-3
LEARNED_INLIER_RTOL = 0.02  # ... inlier counts within 2% of each other
LOFTR_RTOL = 1e-4           # LoFTR card vs CPU: maps, tokens, confidences
LOFTR_FINE_PX = 1e-3        # ... fine keypoints, teacher-forced
LOFTR_XH, LOFTR_XW = 240, 320


def config2_feature(dev, nf: int = NF):
    """BASELINE config 2's front end: SIFTFeature's DoG scale-space
    detector, the gradient orientation on 19² patches and HardNet on 32²
    patches (weights from the port's seeded default initialisation)."""
    from kornia_tpu_torch.feature.hardnet import HardNet
    from kornia_tpu_torch.feature.integrated import (LAFDescriptor,
                                                     LAFOrienter,
                                                     LocalFeature,
                                                     SIFTFeature)
    return LocalFeature(SIFTFeature(num_features=nf).detector,
                        LAFDescriptor(HardNet(device=dev), 32),
                        LAFOrienter(19))


def median_ms(fn, n: int = 5):
    """Host clock around n synchronised calls: (median, every run)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def learned_config2(K, dev) -> dict:
    """(a) BASELINE config 2 at 480x640/1024f through two_view_pose."""
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature.matching import DescriptorMatcher
    from kornia_tpu_torch.geometry.conversions import \
        normalize_points_with_intrinsics
    from kornia_tpu_torch.geometry.ransac import ransac
    from kornia_tpu_torch.slam.twoview import two_view_pose
    img0, img1, Kc = bench_input(H, W, dev)
    feat = config2_feature(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    pair = lambda: two_view_pose(img0, img1, Kc, generator=gen,  # noqa: E731
                                 num_features=NF, feature=feat, device=dev)
    launches = counted_run(K, pair, "learned (a) config 2 pair")
    res = pair()
    rot = math.degrees(angle_of_rotation(res.R))
    print(f"learned (a) pose (for information: untrained weights): rotation "
          f"{rot:.4f} deg, t {res.t.reshape(-1).tolist()}, inliers "
          f"{int(res.num_inliers)} of {int(res.inliers.numel())}")
    pair_ms, runs = median_ms(pair)
    print(f"learned (a) two_view_pose 480x640/1024f: median {pair_ms:.2f} "
          f"ms/pair, runs {[round(v, 2) for v in runs]}")
    matcher = DescriptorMatcher("smnn", 0.95)
    stages = {k: [] for k in ("features x2", "match", "ransac")}
    for _ in range(3):
        with f32_precision():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l0, _, d0, v0 = feat(img0)
            l1, _, d1, v1 = feat(img1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, idx, valid = matcher(d0[0], d1[0], v0[0], v1[0])
            kp1 = l1[0, :, :, 2][idx[:, 1]]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            x0 = normalize_points_with_intrinsics(l0[0, :, :, 2], Kc)
            x1 = normalize_points_with_intrinsics(kp1, Kc)
            ransac(x0, x1, model_type="essential", inl_th=1.5 / (0.8 * W),
                   batch_size=256, max_iterations=32, mask=valid,
                   generator=gen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(v * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    print(f"learned (a) stages (median ms, host clock, synchronised): "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }")
    pair()  # warm, then one pair traced on the device only
    busy, n_k, kern = device_profile(pair)
    print(f"learned (a) device busy {busy:.3f} ms of a {pair_ms:.2f} ms pair "
          f"(idle share {1.0 - busy / pair_ms:.4f}), {n_k} kernels")
    check_launch_list(launches, path_launch_shapes(H, W, (19, 32)), 2,
                      "learned (a) pair")
    calls = capture_launches(K, pair)
    per_pair = path_kernel_times(K, kern, calls, launches,
                                 "learned (a) per pair")
    checks = check_captured(K, calls, "learned (a)")
    return dict(launches=launches, pair_ms=pair_ms, runs_ms=runs,
                stage_ms=stage_ms, busy_ms=busy, idle_share=1.0 - busy
                / pair_ms, kernels_per_pair=n_k, per_pair=per_pair,
                checks=checks, rotation_deg=rot,
                inliers=int(res.num_inliers), calls=calls)


def learned_presets(K, dev) -> dict:
    """(b) GFTTAffNetHardNet and HesAffNetHardNet through match_pair at
    480x640/1024f, with autograd on (no torch.no_grad around them)."""
    from kornia_tpu_torch.feature.integrated import (GFTTAffNetHardNet,
                                                     HesAffNetHardNet)
    from kornia_tpu_torch.slam.twoview import match_pair
    if not torch.is_grad_enabled():
        fail("learned (b) must run with autograd on")
    img0, img1, _ = bench_input(H, W, dev)
    out = {}
    for cls in (GFTTAffNetHardNet, HesAffNetHardNet):
        feat = cls(num_features=NF, device=dev)
        name = cls.__name__
        run = lambda: match_pair(img0, img1, NF, feature=feat,  # noqa: E731
                                 device=dev)
        launches = counted_run(K, run, f"learned (b) {name}")
        m = run()
        ms, runs = median_ms(run, 3)
        n_valid = int(m["valid"].sum())
        print(f"learned (b) {name} match_pair 480x640/1024f: median "
              f"{ms:.2f} ms/pair, runs {[round(v, 2) for v in runs]}, "
              f"{n_valid} matches")
        calls = capture_launches(K, lambda: feat(img0))
        out[name] = dict(launches=launches, pair_ms=ms, matches=n_valid,
                         checks=check_captured(K, calls,
                                               f"learned (b) {name}"))
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def learned_xcheck(dev) -> dict:
    """Config 2 and GFTTAffNetHardNet at 256x256/512f on the card and on the
    CPU port with the same injected RANSAC noise: the same keypoints, LAFs
    within 1e-4 of their largest entry, descriptors of the same LAFs (the
    CPU's) within 1e-4, 99% of the matches equal (near ties may swap),
    inlier counts within 2%. End to end, a keypoint's centre moves by up to
    a few thousandths of a pixel in the detector's subpixel fit and HardNet
    follows the shift (up to 3.5e-4 on config 2 on an H100): the
    end-to-end descriptor differences are printed, and the matches they
    give are what is held."""
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature.integrated import GFTTAffNetHardNet
    from kornia_tpu_torch.slam.twoview import match_pair, two_view_pose
    img0, img1, Kc = bench_input(XH, XW, dev)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((32, 256, XNF), generator=gen).clamp_min(
        torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    makers = {"config2": lambda d: config2_feature(d, XNF),
              "GFTTAffNetHardNet": lambda d: GFTTAffNetHardNet(XNF,
                                                                device=d)}
    out = {}
    for name, make in makers.items():
        res = []
        for d in (dev, torch.device("cpu")):
            feat = make(d)
            a, b, k = (t.to(d) for t in (img0, img1, Kc))
            with f32_precision():
                det = feat(a)
            res.append(dict(
                feat=feat, det=det,
                match=match_pair(a, b, XNF, feature=feat, device=d),
                pose=two_view_pose(a, b, k, num_features=XNF, feature=feat,
                                   device=d, gumbel=gumbel.to(d))))
        g, c = res
        (gl, _, gd, gv), (cl, _, cd, cv) = g["det"], c["det"]
        if not torch.equal(gv.cpu(), cv):
            fail(f"learned xcheck {name}: card and CPU keep other keypoints")
        v = cv[0]
        laf_rel = _rel(gl[0][v], cl[0][v])
        with f32_precision():
            forced = g["feat"].descriptor(img0, cl.to(dev))
        forced_err = float((forced.cpu() - cd)[0][v].abs().max())
        e2e = (gd.cpu() - cd)[0][v].abs().amax(-1)
        e2e_share = float((e2e <= LEARNED_DESC_ATOL).float().mean())
        gm, cm = g["match"], c["match"]
        mv = cm["valid"][0]
        agree = float((gm["matches"][0].cpu() == cm["matches"][0])
                      .all(-1)[mv].float().mean())
        ni = (int(g["pose"].num_inliers), int(c["pose"].num_inliers))
        out[name] = dict(keypoints=int(v.sum()), laf_rel=laf_rel,
                         forced_desc_err=forced_err,
                         e2e_desc_share=e2e_share,
                         e2e_desc_err=float(e2e.max()), match_agree=agree,
                         inliers=ni)
        print(f"learned xcheck {name} 256x256/512f card vs CPU: "
              f"{int(v.sum())} keypoints, LAFs {laf_rel:.2e} of the largest, "
              f"descriptors on the CPU's LAFs {forced_err:.2e}, end to end "
              f"{float(e2e.max()):.2e} ({e2e_share:.4f} within "
              f"{LEARNED_DESC_ATOL}), matches equal {agree:.4f}, inliers "
              f"{ni}")
        if not laf_rel <= LEARNED_XCHECK_RTOL:
            fail(f"learned xcheck {name}: LAFs {laf_rel} apart")
        if not forced_err <= LEARNED_DESC_ATOL:
            fail(f"learned xcheck {name}: descriptors of the same LAFs "
                 f"{forced_err} apart")
        if not agree >= LEARNED_AGREE:
            fail(f"learned xcheck {name}: matches agree {agree}")
        if abs(ni[0] - ni[1]) > LEARNED_INLIER_RTOL * max(ni):
            fail(f"learned xcheck {name}: inlier counts {ni}")
    return out


def loftr_pair(dev) -> dict:
    """(c) LoFTR(LoFTRConfig()) on the 480x640 benchmark pair: ms per pair,
    peak memory, busy share, valid matches, and their essential-RANSAC pose
    (for information: the weights are untrained)."""
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature.loftr import LoFTR, LoFTRConfig
    from kornia_tpu_torch.geometry.conversions import \
        normalize_points_with_intrinsics
    from kornia_tpu_torch.geometry.epipolar import \
        motion_from_essential_choose_solution
    from kornia_tpu_torch.geometry.ransac import ransac
    img0, img1, Kc = bench_input(H, W, dev)
    model = LoFTR(LoFTRConfig(), device=dev)
    data = {"image0": img0, "image1": img1}
    model(data)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = model(data)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms, runs = median_ms(lambda: model(data))
    busy, n_k, kern = device_profile(lambda: model(data))
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}")
    v = out["valid"][0]
    n_valid = int(v.sum())
    K_ = model.cfg.top_k
    if not (out["keypoints0"].shape == out["keypoints1"].shape == (1, K_, 2)
            and torch.isfinite(out["keypoints1"]).all()
            and torch.isfinite(out["confidence"]).all()):
        fail("LoFTR: keypoints of another shape, or non-finite outputs")
    # the valid matches through essential RANSAC (with fewer than 5 the
    # minimal samples repeat matches: the pose is then noise)
    gen = torch.Generator(device=dev).manual_seed(4)
    with f32_precision():
        x0 = normalize_points_with_intrinsics(out["keypoints0"][0], Kc)
        x1 = normalize_points_with_intrinsics(out["keypoints1"][0], Kc)
        rr = ransac(x0, x1, model_type="essential", inl_th=1.5 / (0.8 * W),
                    batch_size=256, max_iterations=32, mask=v, generator=gen)
        eye = torch.eye(3, device=dev)[None]
        R, t, _ = motion_from_essential_choose_solution(
            rr.model[None], eye, eye, x0[None], x1[None],
            mask=rr.inliers[None])
    pose = dict(rotation_deg=math.degrees(angle_of_rotation(R[0])),
                t=t[0].reshape(-1).tolist(), inliers=int(rr.inlier_count))
    print(f"learned (c) LoFTR 480x640 (coarse 256, fine 128, 4+1 layer "
          f"pairs, 8 heads, top_k 512): median {ms:.2f} ms/pair, runs "
          f"{[round(x, 2) for x in runs]}, peak {peak / 2**20:.1f} MiB, "
          f"device busy {busy:.3f} ms (busy share {busy / ms:.4f}), {n_k} "
          f"kernels, {n_valid} valid matches, pose (for information) {pose}")
    return dict(pair_ms=ms, runs_ms=runs, peak_bytes=peak, busy_ms=busy,
                busy_share=busy / ms, kernels_per_pair=n_k,
                valid_matches=n_valid, pose=pose)


def loftr_xcheck(dev) -> dict:
    """LoFTR(LoFTRConfig()) at 240x320 on the card and on the CPU port: the
    backbone's maps, the transformer's tokens and the confidence matrix
    within 1e-4 of their largest entry; the fine stage on the card fed the
    CPU's coarse matches (teacher-forced: top-k ties cannot change which
    cells are compared), keypoints within 1e-3 px."""
    from kornia_tpu_torch.feature.loftr import LoFTR, LoFTRConfig, \
        _coarse_match
    cfg = LoFTRConfig()
    cpu = LoFTR(cfg, device="cpu")
    card = LoFTR(cfg, cpu.params, device=dev)
    img0, img1, _ = bench_input(LOFTR_XH, LOFTR_XW, dev)
    st_g = card.coarse_stage(img0, img1)
    st_c = cpu.coarse_stage(img0.cpu(), img1.cpu())
    rel = {k: _rel(st_g[k], st_c[k]) for k in ("c0", "f0", "c1", "f1", "t0",
                                              "t1", "conf")}
    i, j, _, v = _coarse_match(cfg, st_c["conf"], st_c["hw0"], st_c["hw1"],
                               cfg.top_k)
    kp_c = cpu.fine_stage(st_c, i, j)
    kp_g = card.fine_stage(st_g, i.to(dev), j.to(dev))
    fine_px = max(float((g.cpu() - c).abs().max()) for g, c in zip(kp_g,
                                                                    kp_c))
    print(f"learned LoFTR card vs CPU at {LOFTR_XH}x{LOFTR_XW}: "
          f"{ {k: f'{x:.2e}' for k, x in rel.items()} } of the largest "
          f"entry, fine keypoints (teacher-forced, {cfg.top_k} cells, "
          f"{int(v.sum())} valid) {fine_px:.2e} px")
    if not max(rel.values()) <= LOFTR_RTOL:
        fail(f"LoFTR: card and CPU apart by {rel}")
    if not fine_px <= LOFTR_FINE_PX:
        fail(f"LoFTR: fine keypoints {fine_px} px apart")
    return dict(rel=rel, fine_px=fine_px, valid=int(v.sum()))


def learned_phase(K, dev) -> dict:
    """Step 10: learned local features and dense matching (see the
    module's docstring)."""
    t_phase = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        part_s[name] = time.perf_counter() - t
        return r

    a = part("config2", learned_config2, K, dev)
    b = part("presets", learned_presets, K, dev)
    c = part("loftr", loftr_pair, dev)
    xcheck = part("xcheck", learned_xcheck, dev)
    loftr_x = part("loftr_xcheck", loftr_xcheck, dev)

    # the kernels line's entries: each kernel on the config-2 pair (the
    # patch kernel on its 32² HardNet call, 1024 x 1024 samples), its
    # largest difference from the plain version over (a) and (b)
    checks = {name: dict(chk, max_abs_err=max(
        [chk["max_abs_err"]] + [p["checks"][name]["max_abs_err"]
                                for p in b.values()]))
              for name, chk in a["checks"].items()}
    results, counts = path_entries(K, a.pop("calls"), checks, a["launches"],
                                   "learned")
    report(results)
    out = dict(config2=a, presets=b, loftr=c, xcheck=xcheck,
               loftr_xcheck=loftr_x, part_s=part_s,
               seconds=time.perf_counter() - t_phase)
    print(f"learned phase: {out['seconds']:.1f} s, parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }")
    print(json.dumps({"learned": out}))
    return dict(kernels=results, counts=counts, **out)

# --- step 11: the KeyNet presets, stereo depth and the stitcher ------------

KEYNET_NF = 2048
KEYNET_KERNELS = ("fused_separable_blur2d", "patch_sample")
STEREO_KERNELS = ("fused_separable_blur2d",)
STEREO_D, STEREO_WIN = 64, 9
STEREO_BASELINE = 0.12  # metres along the left camera's x axis
STEREO_MEDIAN_PX = 2.0  # median |disparity - f b / z| over LR-valid pixels
#                         (a sanity limit: parity is held on the CPU), of
#                         the winner (soft=False) on the same cost volumes
# the defaults' soft-argmin at temperature 50 is biased on the rendered room
# (3.127 px median, LR-valid share 0.1463 on the H100, PERF.md §6): bounds
# set from those readings, so that a change in it still fails the step
STEREO_SOFT_MEDIAN_PX = 4.0
STEREO_SOFT_VALID_MIN = 0.10
STEREO_XH, STEREO_XW, STEREO_XD = 120, 160, 16  # card vs CPU
STEREO_X_PX = 1e-4      # ... disparities, px
STEREO_X_RTOL = 1e-4    # ... depth, normals, warp: of the largest entry
ROUND_TRIP_PX = 1e-3    # distort / undistort round trips on the pixel grid
UNDISTORT_ATOL = 1e-4   # undistort_image, card vs CPU ([0, 1] images)
# a wide-angle lens (Brown-Conrady k1, k2, p1, p2, k3: 18 px at the corners
# of 480x640 at f = 0.8 W) and a fisheye (Kannala-Brandt k1..k4)
BROWN_CONRADY = (-0.1, 0.02, 1e-3, -5e-4, -0.005)
KANNALA_BRANDT = (0.05, -0.02, 0.006, -0.001)
STITCH_FULL_W, STITCH_SHIFT = 920, 280  # right view = columns 280-919
STITCH_CORNER_PX = 1.0  # estimated H vs the true +280 px shift, corners
STITCH_MAD = 0.01       # columns 648-911: mean |out - source| / range


def keynet_pair(K, dev) -> dict:
    """(a) KeyNetAffNetHardNet(2048) through two_view_pose at 480x640,
    RANSAC 256 x 32: ms per pair, stages, device busy share, kernels a
    pair, each kernel's device time, launches and bound a pair; every
    kernel call of the pair captured and held against its plain version
    on its listed route."""
    from kornia_tpu_torch.feature.integrated import KeyNetAffNetHardNet
    from kornia_tpu_torch.feature.matching import DescriptorMatcher
    from kornia_tpu_torch.geometry.conversions import \
        normalize_points_with_intrinsics
    from kornia_tpu_torch.geometry.ransac import ransac
    from kornia_tpu_torch.slam.twoview import two_view_pose
    img0, img1, Kc = bench_input(H, W, dev)
    feat = KeyNetAffNetHardNet(num_features=KEYNET_NF, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    pair = lambda: two_view_pose(img0, img1, Kc, generator=gen,  # noqa: E731
                                 num_features=KEYNET_NF, feature=feat,
                                 device=dev)
    launches = counted_run(K, pair, "keynet (a) KeyNetAffNetHardNet pair",
                           KEYNET_KERNELS)
    res = pair()
    rot = math.degrees(angle_of_rotation(res.R))
    print(f"keynet (a) pose (for information: untrained weights): rotation "
          f"{rot:.4f} deg, t {res.t.reshape(-1).tolist()}, inliers "
          f"{int(res.num_inliers)} of {int(res.inliers.numel())}")
    pair_ms, runs = median_ms(pair)
    print(f"keynet (a) two_view_pose 480x640/{KEYNET_NF}f: median "
          f"{pair_ms:.2f} ms/pair, runs {[round(v, 2) for v in runs]}")
    matcher = DescriptorMatcher("smnn", 0.95)
    stages = {k: [] for k in ("features x2", "match", "ransac")}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, _, d0, v0 = feat(img0)
        l1, _, d1, v1 = feat(img1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, idx, valid = matcher(d0[0], d1[0], v0[0], v1[0])
        kp1 = l1[0, :, :, 2][idx[:, 1]]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x0 = normalize_points_with_intrinsics(l0[0, :, :, 2], Kc)
        x1 = normalize_points_with_intrinsics(kp1, Kc)
        ransac(x0, x1, model_type="essential", inl_th=1.5 / (0.8 * W),
               batch_size=256, max_iterations=32, mask=valid, generator=gen)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[k].append(v * 1e3)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    print(f"keynet (a) stages (median ms, host clock, synchronised): "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }")
    pair()
    busy, n_k, kern = device_profile(pair, KEYNET_KERNELS)
    print(f"keynet (a) device busy {busy:.3f} ms of a {pair_ms:.2f} ms pair "
          f"(idle share {1.0 - busy / pair_ms:.4f}), {n_k} kernels")
    calls = capture_launches(K, pair, KEYNET_KERNELS)
    per_pair = path_kernel_times(K, kern, calls, launches,
                                 "keynet (a) per pair")
    checks = check_captured(K, calls, "keynet (a)")
    return dict(launches=launches, pair_ms=pair_ms, runs_ms=runs,
                stage_ms=stage_ms, busy_ms=busy,
                idle_share=1.0 - busy / pair_ms, kernels_per_pair=n_k,
                per_pair=per_pair, checks=checks, rotation_deg=rot,
                inliers=int(res.num_inliers), calls=calls)


def keynet_match(K, dev) -> dict:
    """(a) KeyNetHardNet(2048) through match_pair at 480x640 with autograd
    on: ms per pair (median of 3), busy share, kernels, launches; every
    kernel call of the pair held against its plain version."""
    from kornia_tpu_torch.feature.integrated import KeyNetHardNet
    from kornia_tpu_torch.slam.twoview import match_pair
    if not torch.is_grad_enabled():
        fail("keynet (a) match_pair must run with autograd on")
    img0, img1, _ = bench_input(H, W, dev)
    feat = KeyNetHardNet(num_features=KEYNET_NF, device=dev)
    run = lambda: match_pair(img0, img1, KEYNET_NF,  # noqa: E731
                             feature=feat, device=dev)
    launches = counted_run(K, run, "keynet (a) KeyNetHardNet match_pair",
                           KEYNET_KERNELS)
    m = run()
    ms, runs = median_ms(run, 3)
    busy, n_k, kern = device_profile(run, KEYNET_KERNELS)
    n_valid = int(m["valid"].sum())
    print(f"keynet (a) KeyNetHardNet match_pair 480x640/{KEYNET_NF}f: median "
          f"{ms:.2f} ms/pair, runs {[round(v, 2) for v in runs]}, {n_valid} "
          f"matches, device busy {busy:.3f} ms (idle share "
          f"{1.0 - busy / ms:.4f}), {n_k} kernels")
    calls = capture_launches(K, run, KEYNET_KERNELS)
    per_pair = path_kernel_times(K, kern, calls, launches,
                                 "keynet (a) match_pair")
    return dict(launches=launches, pair_ms=ms, runs_ms=runs, busy_ms=busy,
                idle_share=1.0 - busy / ms, kernels_per_pair=n_k,
                matches=n_valid, per_pair=per_pair,
                checks=check_captured(K, calls, "keynet (a) KeyNetHardNet"))


def _by_position(lafs: torch.Tensor, valid: torch.Tensor):
    """The valid LAFs of one image on the CPU, ordered by centre and scale:
    near-tied scores may come out of the top-k in another order on the card
    and on the CPU, so keypoints are compared as a set."""
    l_ = lafs.cpu()[valid.cpu()]
    key = torch.stack([l_[:, 0, 2], l_[:, 1, 2], l_[:, 0, 0].abs()], -1)
    order = sorted(range(len(key)), key=lambda i: tuple(key[i].tolist()))
    return l_[order]


def _match_pairs(m: dict) -> set:
    """The valid matches of image 0 as (centre in image 0, centre in image
    1) pairs, independent of the keypoints' order."""
    v = m["valid"][0].cpu()
    k0, k1 = m["keypoints0"][0].cpu()[v], m["keypoints1"][0].cpu()[v]
    return {(tuple(a.tolist()), tuple(b.tolist())) for a, b in zip(k0, k1)}


def keynet_xcheck(dev) -> dict:
    """KeyNetAffNetHardNet at 256x256/512f on the card and on the CPU port
    (the same seeded weights): Key.Net's response map within 1e-4 of its
    largest entry, the same keypoints (centres and scales, as a set), the
    LAFs of each later stage (AffNet's shape, OriNet's orientation) within
    1e-4 of their largest entry with the card's stage fed the CPU's input to
    it, descriptors of the same LAFs (the CPU's) within 1e-4, 99% of the
    CPU's matches (as centre pairs) also made on the card. End to end, an
    f32 difference in AffNet's shape moves OriNet's angle, so the two
    chains' LAFs are held at KEYNET_E2E_LAF_RTOL."""
    from kornia_tpu_torch.feature.integrated import KeyNetAffNetHardNet
    from kornia_tpu_torch.slam.twoview import match_pair
    img0, img1, _ = bench_input(XH, XW, dev)
    res = []
    for d in (dev, torch.device("cpu")):
        feat = KeyNetAffNetHardNet(XNF, device=d)
        a, b = img0.to(d), img1.to(d)
        res.append(dict(feat=feat, resp=feat.detector.model(a),
                        det=feat.detector.detect(a), full=feat(a),
                        match=match_pair(a, b, XNF, feature=feat, device=d)))
    g, c = res
    resp_rel = _rel(g["resp"], c["resp"])
    (_, gdl, gdv), (_, cdl, cdv) = g["det"], c["det"]
    if int(gdv.sum()) != int(cdv.sum()):
        fail("keynet xcheck: card and CPU keep other numbers of keypoints")
    same_kp = torch.equal(_by_position(gdl[0], gdv[0]),
                          _by_position(cdl[0], cdv[0]))
    # the later stages, each on the card fed the CPU's input to it
    det_g, det_c = g["feat"].detector, c["feat"].detector
    aff_c = det_c.aff(cdl, img0.cpu())
    ori_c = det_c.ori(aff_c, img0.cpu())
    v = cdv[0]
    stage_rel = {
        "affnet": _rel(det_g.aff(cdl.to(dev), img0)[0][v], aff_c[0][v]),
        "orinet": _rel(det_g.ori(aff_c.to(dev), img0)[0][v], ori_c[0][v])}
    (gl, _, _, gv), (cl, _, cd, cv) = g["full"], c["full"]
    e2e_rel = _rel(_by_position(gl[0], gv[0]), _by_position(cl[0], cv[0]))
    forced = g["feat"].descriptor(img0, cl.to(dev))
    forced_err = float((forced.cpu() - cd)[0][cv[0]].abs().max())
    pg, pc = _match_pairs(g["match"]), _match_pairs(c["match"])
    agree = len(pg & pc) / max(len(pc), 1)
    print(f"keynet xcheck KeyNetAffNetHardNet {XH}x{XW}/{XNF}f card vs CPU: "
          f"response {resp_rel:.2e} of the largest, {int(v.sum())} "
          f"keypoints (the same set: {same_kp}), LAFs stage by stage "
          f"{ {k: f'{x:.2e}' for k, x in stage_rel.items()} } of the largest "
          f"(end to end {e2e_rel:.2e}), descriptors on the CPU's LAFs "
          f"{forced_err:.2e}, {len(pc)} CPU matches of which {agree:.4f} also "
          f"on the card")
    if not resp_rel <= LEARNED_XCHECK_RTOL:
        fail(f"keynet xcheck: responses {resp_rel} apart")
    if not same_kp:
        fail("keynet xcheck: card and CPU detect other keypoints")
    if not max(stage_rel.values()) <= LEARNED_XCHECK_RTOL:
        fail(f"keynet xcheck: LAFs {stage_rel} apart")
    if not e2e_rel <= KEYNET_E2E_LAF_RTOL:
        fail(f"keynet xcheck: LAFs end to end {e2e_rel} apart")
    if not forced_err <= LEARNED_DESC_ATOL:
        fail(f"keynet xcheck: descriptors of the same LAFs {forced_err} "
             f"apart")
    if not agree >= LEARNED_AGREE:
        fail(f"keynet xcheck: matches agree {agree}")
    return dict(resp_rel=resp_rel, keypoints=int(v.sum()),
                stage_laf_rel=stage_rel, e2e_laf_rel=e2e_rel,
                forced_desc_err=forced_err, matches=len(pc),
                match_agree=agree)


def stereo_scene(dev, h: int, w: int):
    """The room (tex_size 512, seeded as step 9's) seen from the first pose
    of the walk by a rectified pair STEREO_BASELINE apart along the
    camera's x axis, f = 0.8 W: (left, right, z-depth of the left view, K,
    the right camera's pose in the left's frame (4, 4), StereoCamera)."""
    from kornia_tpu_torch.geometry.camera import StereoCamera
    from kornia_tpu_torch.utils.render import (make_room_scene,
                                               render_scene, walk_trajectory)
    f = 0.8 * w
    Kc = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
                      device=dev)
    scene = make_room_scene(torch.Generator(dev).manual_seed(SEED + 7),
                            tex_size=512, device=dev)
    T_left = torch.from_numpy(walk_trajectory(100)[0]).to(dev)
    r_from_l = torch.eye(4, device=dev)
    r_from_l[0, 3] = -STEREO_BASELINE
    left, z = render_scene(scene, Kc, T_left, h, w)
    right, _ = render_scene(scene, Kc, r_from_l @ T_left, h, w)
    P_left = torch.cat([Kc, torch.zeros(3, 1, device=dev)], 1)[None]
    P_right = P_left.clone()
    P_right[0, 0, 3] = -f * STEREO_BASELINE
    return left, right, z, Kc, r_from_l, StereoCamera(P_left, P_right)


def stereo_stages(left, right, Kc, r_from_l, cam, D: int) -> dict:
    """The stereo path, stage by stage: disparity and LR mask, depth and the
    Q-matrix points, camera points and normals, the right view warped into
    the left one."""
    from kornia_tpu_torch.contrib.stereo import (disparity_to_depth,
                                                 stereo_matching)
    from kornia_tpu_torch.geometry.depth import (depth_to_3d,
                                                 depth_to_normals,
                                                 warp_frame_depth)
    f = float(Kc[0, 0])
    out = {}
    out["disparity"], out["valid"] = stereo_matching(left, right, D,
                                                     STEREO_WIN)
    out["depth"] = disparity_to_depth(out["disparity"], f, STEREO_BASELINE)
    out["points_q"] = cam.reproject_disparity_to_3D(out["disparity"])
    out["points"] = depth_to_3d(out["depth"], Kc[None])
    out["normals"] = depth_to_normals(out["depth"], Kc[None])
    out["warped"] = warp_frame_depth(right, out["depth"], r_from_l[None],
                                     Kc[None])
    return out


def stereo_path(K, dev) -> dict:
    """(b) Stereo depth at 480x640, D = 64, window 9, on a rendered
    rectified pair: undistort_image alone (timed, card vs CPU), the round
    trips of both distortion models on the pixel grid, then the stereo
    stages (ms each and whole, peak memory, the LR-valid share, the
    disparity error against the renderer's f b / z), the box blur's calls
    against their plain version on their listed route."""
    from kornia_tpu_torch.contrib.stereo import stereo_matching
    from kornia_tpu_torch.geometry.calibration import (distort_points,
                                                       undistort_image,
                                                       undistort_points)
    from kornia_tpu_torch.geometry.camera import (
        distort_points_kannala_brandt, undistort_points_kannala_brandt)
    left, right, z, Kc, r_from_l, cam = stereo_scene(dev, H, W)
    f = float(Kc[0, 0])
    # undistort_image on the left view, alone
    dist = torch.tensor([BROWN_CONRADY], device=dev)
    und = lambda: undistort_image(left, Kc[None], dist)  # noqa: E731
    und_ms, _ = median_ms(und)
    und_err = float((und().cpu() - undistort_image(
        left.cpu(), Kc[None].cpu(), dist.cpu())).abs().max())
    # the round trips on the 480x640 pixel grid
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(1, -1, 2)
    bc_px = float((undistort_points(distort_points(grid, Kc[None], dist),
                                    Kc[None], dist) - grid).abs().max())
    kb = torch.tensor([[f, f, W / 2, H / 2, *KANNALA_BRANDT]], device=dev)
    kb_px = float((distort_points_kannala_brandt(
        undistort_points_kannala_brandt(grid, kb), kb) - grid).abs().max())
    print(f"stereo undistort_image 480x640: median {und_ms:.3f} ms, card vs "
          f"CPU {und_err:.2e}; round trips on the pixel grid: Brown-Conrady "
          f"{bc_px:.2e} px, Kannala-Brandt {kb_px:.2e} px")
    if not und_err <= UNDISTORT_ATOL:
        fail(f"stereo: undistort_image card vs CPU {und_err}")
    if not max(bc_px, kb_px) <= ROUND_TRIP_PX:
        fail(f"stereo: round trips {bc_px}, {kb_px} px")

    run = lambda: stereo_stages(left, right, Kc, r_from_l, cam,  # noqa: E731
                                STEREO_D)
    launches = counted_run(K, run, "stereo (b)", STEREO_KERNELS)
    out = run()
    # the disparity against the renderer's z-depth, over LR-valid pixels
    gt = f * STEREO_BASELINE / z
    valid = out["valid"][0, 0] & torch.isfinite(z)
    share = float(out["valid"].float().mean())
    soft_px = float((out["disparity"][0, 0] - gt).abs()[valid].median())
    wta, wta_valid = stereo_matching(left, right, STEREO_D, STEREO_WIN,
                                     soft=False)
    wv = wta_valid[0, 0] & torch.isfinite(z)
    wta_px = float((wta[0, 0] - gt).abs()[wv].median())
    wta_share = float(wta_valid.float().mean())
    for k, v in out.items():
        if v.dtype != torch.bool and not torch.isfinite(v).all():
            fail(f"stereo: non-finite {k}")
    # ms per stage and whole (median of 5)
    from kornia_tpu_torch.contrib.stereo import disparity_to_depth
    from kornia_tpu_torch.geometry.depth import (depth_to_3d,
                                                 depth_to_normals,
                                                 warp_frame_depth)
    d, dep = out["disparity"], out["depth"]
    stage_fns = {
        "stereo_matching": lambda: stereo_matching(left, right, STEREO_D,
                                                   STEREO_WIN),
        "depth + Q points": lambda: (disparity_to_depth(
            d, f, STEREO_BASELINE), cam.reproject_disparity_to_3D(d)),
        "points + normals": lambda: (depth_to_3d(dep, Kc[None]),
                                     depth_to_normals(dep, Kc[None])),
        "warp": lambda: warp_frame_depth(right, dep, r_from_l[None],
                                         Kc[None]),
    }
    stage_ms = {k: median_ms(fn)[0] for k, fn in stage_fns.items()}
    whole_ms, runs = median_ms(run)
    peak = peak_bytes(run)
    busy, n_k, kern = device_profile(run, STEREO_KERNELS)
    calls = capture_launches(K, run, STEREO_KERNELS)
    per_run = path_kernel_times(K, kern, calls, launches, "stereo (b)")
    checks = check_captured(K, calls, "stereo (b)")
    print(f"stereo (b) 480x640 D={STEREO_D} window {STEREO_WIN}: median "
          f"{whole_ms:.2f} ms, runs {[round(v, 2) for v in runs]}, stages "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }, peak "
          f"{peak / 2**20:.1f} MiB, device busy {busy:.3f} ms, {n_k} "
          f"kernels; soft-argmin (the defaults): LR-valid share {share:.4f}, "
          f"median |d - f b / z| {soft_px:.3f} px; winner: LR-valid share "
          f"{wta_share:.4f}, median {wta_px:.3f} px")
    if not wta_px <= STEREO_MEDIAN_PX:
        fail(f"stereo: the winner's median disparity error {wta_px} px")
    if not soft_px <= STEREO_SOFT_MEDIAN_PX:
        fail(f"stereo: the soft-argmin's median disparity error {soft_px} px")
    if not share >= STEREO_SOFT_VALID_MIN:
        fail(f"stereo: the soft-argmin's LR-valid share {share}")
    return dict(launches=launches, undistort_ms=und_ms,
                undistort_err=und_err, round_trip_px=dict(
                    brown_conrady=bc_px, kannala_brandt=kb_px),
                whole_ms=whole_ms, runs_ms=runs, stage_ms=stage_ms,
                peak_bytes=peak, busy_ms=busy, kernels=n_k,
                lr_valid_share=share, median_err_px=soft_px,
                wta_lr_valid_share=wta_share, wta_median_err_px=wta_px,
                per_run=per_run, checks=checks, calls=calls)


def stereo_xcheck(dev) -> dict:
    """The stereo path at 120x160, D = 16, on the card and on the CPU port
    (the same rendered pair): disparities within 1e-4 px and the same
    LR-valid mask; depth, points, normals and the warp within 1e-4 of
    their largest entry, each stage on the card fed the CPU's disparity or
    depth (a soft-argmin difference of 1e-5 px moves depth by f b / d²)."""
    from kornia_tpu_torch.contrib.stereo import disparity_to_depth
    from kornia_tpu_torch.geometry.depth import (depth_to_3d,
                                                 depth_to_normals,
                                                 warp_frame_depth)
    left, right, _, Kc, r_from_l, cam = stereo_scene(dev, STEREO_XH,
                                                     STEREO_XW)
    g = stereo_stages(left, right, Kc, r_from_l, cam, STEREO_XD)
    cpu = torch.device("cpu")
    cam_c = type(cam)(cam.rectified_left_camera.cpu(),
                      cam.rectified_right_camera.cpu())
    c = stereo_stages(left.cpu(), right.cpu(), Kc.cpu(), r_from_l.cpu(),
                      cam_c, STEREO_XD)
    disp_px = float((g["disparity"].cpu() - c["disparity"]).abs().max())
    same_valid = torch.equal(g["valid"].cpu(), c["valid"])
    f = float(Kc[0, 0])
    dc, depc = c["disparity"].to(dev), c["depth"].to(dev)
    forced = dict(
        depth=disparity_to_depth(dc, f, STEREO_BASELINE),
        points_q=cam.reproject_disparity_to_3D(dc),
        points=depth_to_3d(depc, Kc[None]),
        normals=depth_to_normals(depc, Kc[None]),
        warped=warp_frame_depth(right, depc, r_from_l[None], Kc[None]))
    rel = {k: _rel(v, c[k]) for k, v in forced.items()}
    print(f"stereo xcheck {STEREO_XH}x{STEREO_XW} D={STEREO_XD} card vs CPU: "
          f"disparity {disp_px:.2e} px, LR masks equal {same_valid} "
          f"(valid share {float(c['valid'].float().mean()):.4f}), stages on "
          f"the CPU's input { {k: f'{x:.2e}' for k, x in rel.items()} } of "
          f"the largest")
    if not disp_px <= STEREO_X_PX:
        fail(f"stereo xcheck: disparities {disp_px} px apart")
    if not same_valid:
        fail("stereo xcheck: other LR-valid masks")
    if not max(rel.values()) <= STEREO_X_RTOL:
        fail(f"stereo xcheck: stages apart by {rel}")
    return dict(disparity_px=disp_px, rel=rel)


def stitch_path(K, dev) -> dict:
    """(c) ImageStitcher() on two 480x640 views cut from one 480x920 image
    (bench.py's blurred random texture) 280 px apart: ms (median of 5),
    launches, the estimated homography against the true shift at the
    corners, the left view kept exactly, the right view's columns against
    the source; every kernel call held against its plain version."""
    from kornia_tpu_torch.contrib.image_stitching import ImageStitcher
    from kornia_tpu_torch.ops.filters import gaussian_blur2d
    from kornia_tpu_torch.ops.warp import transform_points
    gen = torch.Generator(device=dev).manual_seed(SEED)
    full = gaussian_blur2d(torch.rand((1, 1, H, STITCH_FULL_W), device=dev,
                                      generator=gen), 3, 1.0)
    left = full[..., :W].contiguous()
    right = full[..., STITCH_SHIFT:STITCH_SHIFT + W].contiguous()
    st = ImageStitcher()
    run = lambda: st(left, right)  # noqa: E731
    launches = counted_run(K, run, "stitch (c)")
    Hm = st.estimate_homography(left, right)
    corners = torch.tensor([[[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                             [W - 1.0, H - 1.0]]], device=dev)
    corner_px = float((transform_points(Hm, corners) - corners
                       - torch.tensor([STITCH_SHIFT, 0.0], device=dev))
                      .abs().max())
    out = run()
    left_kept = torch.equal(out[..., :W], left)
    lo, hi = W + 8, STITCH_SHIFT + W - 8
    mad = float((out[..., lo:hi] - full[..., lo:hi]).abs().mean()
                / (full.max() - full.min()))
    ms, runs = median_ms(run)
    busy, n_k, kern = device_profile(run, tuple(PAIR_KERNELS))
    calls = capture_launches(K, run)
    per_run = path_kernel_times(K, kern, calls, launches, "stitch (c)")
    checks = check_captured(K, calls, "stitch (c)")
    print(f"stitch (c) ImageStitcher 2 x 480x640 -> 480x1280: median "
          f"{ms:.2f} ms, runs {[round(v, 2) for v in runs]}, device busy "
          f"{busy:.3f} ms (idle share {1.0 - busy / ms:.4f}), {n_k} kernels; "
          f"H at the corners {corner_px:.4f} px from the true shift, left "
          f"view kept {left_kept}, columns {lo}-{hi - 1} mean |diff| "
          f"{mad:.2e} of the range")
    if not corner_px <= STITCH_CORNER_PX:
        fail(f"stitch: H {corner_px} px from the true shift")
    if not left_kept:
        fail("stitch: the left view was not kept exactly")
    if not mad <= STITCH_MAD:
        fail(f"stitch: the right view's columns differ by {mad}")
    return dict(launches=launches, ms=ms, runs_ms=runs, busy_ms=busy,
                idle_share=1.0 - busy / ms, kernels=n_k,
                corner_px=corner_px, mad_share=mad, per_run=per_run,
                checks=checks, calls=calls)


def keynet_stereo_phase(K, dev) -> dict:
    """Step 11: the KeyNet presets, stereo depth and the stitcher (see the
    module's docstring)."""
    t_phase = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        part_s[name] = time.perf_counter() - t
        return r

    a = part("keynet_pair", keynet_pair, K, dev)
    a2 = part("keynet_match", keynet_match, K, dev)
    ax = part("keynet_xcheck", keynet_xcheck, dev)
    b = part("stereo", stereo_path, K, dev)
    bx = part("stereo_xcheck", stereo_xcheck, dev)
    c = part("stitch", stitch_path, K, dev)
    results, counts = {}, {}
    for path, r in (("keynet", a), ("stereo", b), ("stitch", c)):
        entries = path_entries(K, r.pop("calls"), r["checks"],
                               r["launches"], path)
        results.update(entries[0])
        counts.update(entries[1])
    report(results)
    out = dict(keynet_pair=a, keynet_match=a2, keynet_xcheck=ax, stereo=b,
               stereo_xcheck=bx, stitch=c, part_s=part_s,
               seconds=time.perf_counter() - t_phase)
    print(f"keynet_stereo phase: {out['seconds']:.1f} s, parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }")
    print(json.dumps({"keynet_stereo": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 12: the communication runtime ------------------------------------------

DIST_BA_C, DIST_BA_PTS, DIST_BA_ITERS = 8, 64, 6  # scaling_bench.py:39-80
DIST_SPARSE_ITERS, DIST_SPARSE_CHUNK = 3, 512    # scaling_bench.py:82-132
DIST_PG_SMALL, DIST_PG_LARGE = (256, 64), (2048, 400)  # scaling_bench.py:208
# the JAX package's own dense and streaming paths end 1.50e-3 apart (in
# translation) on the small circuit after 12 iterations, 1.55e-4 after 20
DIST_PG_ITERS, DIST_PG_LARGE_ITERS = 20, 4
DIST_SHARE_ITERS = 4      # iterations of the call timed collective by one
DIST_RMS_ATOL = 0.05      # D = 4 vs single-device BA, tests/test_slam.py:110
DIST_SYSTEM_RTOL = 1e-4   # reduced camera systems D = 4 vs D = 1, of the
#                           largest entry
DIST_PG_T_ATOL = 1e-3     # pose graphs: translations, tests/test_dist_
DIST_PG_DOT_ATOL = 1e-5   # posegraph.py:82-98; |q·q'| within this of 1
DIST_LOFTR_RTOL = 1e-4    # coarse tokens vs _transformer, of the largest
DIST_RESTART_ATOL = 1e-5  # resumed vs uninterrupted run
DIST_RESTART_STEPS, DIST_RESTART_STOP = 6, 5


class RestartStop(Exception):
    """Raised by step 12's restart check to stop a run at a chosen step."""


def dist_ba_arrays(D: int) -> dict:
    """scaling_bench.py:39-80's problem for D ranks with numpy draws: C = 8
    cameras on a 0.6 rad arc, 64 points a rank, every camera sees every
    point, 0.3 px noise; poses perturbed by 0.02 rad / 0.05, points by 0.1.
    Point ids are local to each rank's block (``pt_idx``) and global
    (``pt_global``)."""
    from kornia_tpu_torch.geometry.liegroup import Se3
    from kornia_tpu_torch.slam.ba import _project
    C, Pl = DIST_BA_C, DIST_BA_PTS
    P = D * Pl
    rng = np.random.default_rng(0)
    z = torch.zeros(C)
    poses = Se3.exp(torch.stack([z, z, z, z, torch.linspace(-0.3, 0.3, C),
                                 z], -1))
    poses = Se3(poses.r, poses.t + torch.stack(
        [torch.linspace(-1, 1, C), z, z], -1))
    X = (rng.standard_normal((P, 3)) * 1.5 + [0.0, 0, 6.0]).astype(
        np.float32)
    K = np.array([[200.0, 0, 128], [0, 200, 96], [0, 0, 1]], np.float32)
    cam_idx = np.concatenate([np.repeat(np.arange(C), Pl)] * D)
    pt_local = np.concatenate([np.tile(np.arange(Pl), C)] * D)
    pt_global = np.concatenate([np.tile(np.arange(Pl), C) + s * Pl
                                for s in range(D)])
    ci, pi = torch.from_numpy(cam_idx), torch.from_numpy(pt_global)
    uv = _project(poses.r.q.data[ci], poses.t[ci], torch.from_numpy(X)[pi],
                  torch.from_numpy(K)).numpy()
    uv = (uv + 0.3 * rng.standard_normal(uv.shape)).astype(np.float32)
    r0 = Se3.exp(torch.from_numpy(
        0.02 * rng.standard_normal((C, 6))).float()).r * poses.r
    t0 = poses.t.numpy() + 0.05 * rng.standard_normal((C, 3))
    X0 = X + 0.1 * rng.standard_normal((P, 3))
    return dict(wxyz=r0.q.data.numpy(), t=t0.astype(np.float32),
                points=X0.astype(np.float32), cam_idx=cam_idx,
                pt_idx=pt_local, pt_global=pt_global, uv=uv,
                valid=np.ones(cam_idx.shape[0], bool), K=K, C=C)


def _dist_args(a: dict, dev, keys=("cam_idx", "pt_idx", "uv", "valid", "K")):
    return [torch.from_numpy(np.ascontiguousarray(a[k])).to(dev)
            for k in keys]


def _ranks_agree(mesh, *tensors) -> bool:
    flat = torch.cat([t.reshape(-1).float() for t in tensors])[None]
    every = mesh.all_gather(flat)
    return bool((every == every[:1]).all())


def dist_row(mesh, what: str, run, iters: int) -> dict:
    """One row of step 12: `run(n)` (an entry point's whole call of n LM
    iterations or forwards) warmed with n = 1, then timed with n = `iters`
    on the host clock between synchronised barriers; the bytes all-reduced
    per iteration; the share of a second call (n = DIST_SHARE_ITERS at
    most) spent inside collectives, each one timed between
    synchronisations; every rank's peak memory in that call."""
    import torch.distributed as dist
    run(1)
    mesh.reset_counts()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(mesh.counts)
    mesh.reset_counts()
    mesh.timed = True
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    torch.cuda.synchronize()
    share_iters = min(iters, DIST_SHARE_ITERS)
    t0 = time.perf_counter()
    run(share_iters)
    torch.cuda.synchronize()
    timed_wall = time.perf_counter() - t0
    mesh.timed = False
    peaks = mesh.all_gather(torch.tensor(
        [float(torch.cuda.max_memory_allocated())], device=mesh.device))
    row = dict(what=what, backend=dist.get_backend(),
               world=mesh.shape["data"], iters=iters,
               ms_per_iter=wall * 1e3 / iters, iters_per_s=iters / wall,
               all_reduces_per_iter=counts["all_reduce"] / iters,
               all_reduce_bytes_per_iter=counts["all_reduce_bytes"] / iters,
               all_gathers=counts["all_gather"],
               collective_share=mesh.counts["seconds"] / timed_wall,
               timed_ms_per_iter=timed_wall * 1e3 / share_iters,
               peak_bytes_per_rank=[int(v) for v in peaks.tolist()])
    return row, out


def dist_restart(mesh, a: dict) -> dict:
    """(e): run_restartable over dense distributed BA LM steps (state and λ
    checkpointed every 2): an uninterrupted run, a run stopped by
    RestartStop at step 5 and resumed from step_4; a checkpoint's round
    trip."""
    import tempfile

    from kornia_tpu_torch import convert
    from kornia_tpu_torch.losses.robust import huber_weight
    from kornia_tpu_torch.parallel import dist_ba
    from kornia_tpu_torch.utils.checkpoint import load_checkpoint
    from kornia_tpu_torch.utils.elastic import (latest_checkpoint,
                                                run_restartable)
    dev = mesh.device
    args = _dist_args(a, dev)
    P_local = a["points"].shape[0] // mesh.shape["data"]

    def step(s):
        st_l, prob_l = dist_ba._dense_blocks(mesh, s["state"], *args)
        system, cost_of = dist_ba._dense_step_fns(
            mesh, prob_l, a["C"], P_local, lambda r2: huber_weight(r2, 3.0),
            True)
        st_l, lam, cost = dist_ba._lm_iteration(mesh, st_l, s["lam"], system,
                                                cost_of, True)
        return {"state": dist_ba._gather_state(mesh, st_l), "lam": lam,
                "cost": cost}

    init = {"state": convert.ba_state_from_numpy(a["wxyz"], a["t"],
                                                 a["points"], dev),
            "lam": torch.tensor(1e-3, device=dev),
            "cost": torch.tensor(0.0, device=dev)}
    calls = []

    def stopping(s):
        calls.append(1)
        if len(calls) == DIST_RESTART_STOP:
            raise RestartStop(DIST_RESTART_STOP)
        return step(s)

    # index_add_'s atomics sum in another order in each run, and the free
    # scale gauge amplifies that to 5e-2 in translation after 6 steps (on
    # an H100): two runs are compared under PyTorch's deterministic
    # algorithms
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory(prefix="restart-") as root:
        whole = run_restartable(step, init, DIST_RESTART_STEPS,
                                os.path.join(root, "a"), checkpoint_every=2)
        stopped = None
        try:
            run_restartable(stopping, init, DIST_RESTART_STEPS,
                            os.path.join(root, "b"), checkpoint_every=2)
        except RestartStop as e:
            stopped = e.args[0]
        newest = latest_checkpoint(os.path.join(root, "b"))[0]
        calls.clear()
        resumed = run_restartable(stopping, init, DIST_RESTART_STEPS,
                                  os.path.join(root, "b"),
                                  checkpoint_every=2)
        last = os.path.join(root, "a", f"step_{DIST_RESTART_STEPS}")
        back = load_checkpoint(last, device=dev)
        typed = load_checkpoint(last, init)
    torch.use_deterministic_algorithms(deterministic)

    def leaves(s):
        st = s["state"]
        return [st.poses.r.q.data, st.poses.t, st.points, s["lam"], s["cost"]]

    diff = max(float((x - y).abs().max())
               for x, y in zip(leaves(resumed), leaves(whole)))
    bitwise = all(torch.equal(x, y) and x.device == y.device
                  for b in (back, typed)
                  for x, y in zip(leaves(b), leaves(whole)))
    return dict(stopped_at=stopped, resumed_from=newest,
                resumed_steps=len(calls), max_abs_diff=diff,
                round_trip_bitwise=bitwise)


def dist_world(mesh, plan: dict) -> dict:
    """The rows of step 12 that this world runs; rank 0's results."""
    from kornia_tpu_torch import convert
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.feature import loftr as t_loftr
    from kornia_tpu_torch.losses.robust import huber_weight
    from kornia_tpu_torch.parallel import dist_ba, dist_posegraph as dpg
    dev = mesh.device
    out = {"rows": [], "jax_imported": "jax" in sys.modules}
    if "ba" in plan:
        a = plan["ba"]
        s0 = convert.ba_state_from_numpy(a["wxyz"], a["t"], a["points"], dev)
        args = _dist_args(a, dev)
        row, (st, costs) = dist_row(
            mesh, "dense_ba", lambda n: dist_ba.distributed_bundle_adjust(
                mesh, s0, *args, a["C"], num_iters=n), DIST_BA_ITERS)
        row.update(costs=costs.tolist(), ranks_agree=_ranks_agree(
            mesh, st.poses.r.q.data, st.poses.t, st.points, costs))
        out["rows"].append(row)
        out["ba_state"] = dict(wxyz=st.poses.r.q.data.cpu().numpy(),
                               t=st.poses.t.cpu().numpy(),
                               points=st.points.cpu().numpy())
    if "sparse" in plan:
        a, tables = plan["sparse"]
        s0 = convert.ba_state_from_numpy(a["wxyz"], a["t"], a["points"], dev)
        cams, uv_t, mask = (torch.from_numpy(x).to(dev) for x in tables)
        K = torch.from_numpy(a["K"]).to(dev)
        row, (st, costs) = dist_row(
            mesh, "sparse_ba",
            lambda n: dist_ba.distributed_bundle_adjust_sparse(
                mesh, s0, cams, uv_t, mask, K, a["C"], num_iters=n,
                init_lambda=0.1, point_chunk=DIST_SPARSE_CHUNK),
            DIST_SPARSE_ITERS)
        row.update(costs=costs.tolist(), ranks_agree=_ranks_agree(
            mesh, st.poses.r.q.data, st.poses.t, st.points, costs))
        out["rows"].append(row)
        # the first iteration's summed reduced camera system
        with f32_precision():
            st_l, prob_l = dist_ba._sparse_blocks(mesh, s0, cams, uv_t, mask,
                                                  K)
            S, rhs, _, _ = dist_ba._sparse_system(
                mesh, st_l, prob_l, torch.full((), 0.1, device=dev), a["C"],
                lambda r2: huber_weight(r2, 3.0),
                min(DIST_SPARSE_CHUNK, st_l.points.shape[0]), True)
        out["sparse_system"] = S.cpu().numpy()
    if "pg" in plan:
        for name, (g, part) in plan["pg"].items():
            poses, graph = pose_graph_on(g, dev)
            paths = (("streaming",) if name == "large"
                     else ("dense", "streaming"))
            if name == "large":
                try:
                    dpg.distributed_pose_graph(mesh, poses, graph, part,
                                               num_iters=1)
                    out["large_dense_refused"] = None
                except ValueError as e:
                    if "max_separators" not in str(e):
                        raise
                    out["large_dense_refused"] = str(e).split(";")[0]
            iters = DIST_PG_LARGE_ITERS if name == "large" else DIST_PG_ITERS
            for path in paths:
                fn = (dpg.distributed_pose_graph if path == "dense"
                      else dpg.distributed_pose_graph_streaming)
                row, (p, costs) = dist_row(
                    mesh, f"pose_graph_{name}_{path}",
                    lambda n: fn(mesh, poses, graph, part, num_iters=n),
                    iters)
                row.update(costs=costs.tolist(),
                           separators=int(part.num_separators),
                           ranks_agree=_ranks_agree(mesh, p.r.q.data, p.t,
                                                    costs))
                out["rows"].append(row)
                out[f"pg_{name}_{path}"] = dict(wxyz=p.r.q.data.cpu().numpy(),
                                                t=p.t.cpu().numpy())
    if "loftr" in plan:
        params, f0, f1 = plan["loftr"]
        p = {k: v.to(dev) for k, v in params.items()}
        t0, t1 = f0.to(dev), f1.to(dev)
        cfg = t_loftr.LoFTRConfig()
        with torch.no_grad():
            row, (o0, o1) = dist_row(
                mesh, "loftr_coarse_cp",
                lambda n: t_loftr.loftr_coarse_context_parallel(
                    p, cfg, t0, t1, mesh), 1)
        row.update(tokens=int(f0.shape[1]),
                   ranks_agree=_ranks_agree(mesh, o0, o1))
        out["rows"].append(row)
        out["loftr"] = (o0.cpu(), o1.cpu())
    if "restart" in plan:
        out["restart"] = dist_restart(mesh, plan["restart"])
    return out


def distributed_phase(dev, card: str) -> dict:
    """Step 12: the communication runtime (BASELINE config 5's distributed
    BA and pose graphs, LoFTR's context-parallel coarse stage, restarts)
    over one NCCL rank in this process and 2 and 4 gloo ranks sharing the
    card; every result against its single-device call. One JSON line."""
    import tempfile

    import torch.distributed as dist

    from kornia_tpu_torch.feature import loftr as t_loftr
    from kornia_tpu_torch.parallel import spmd
    from kornia_tpu_torch.parallel.dist_ba import build_sharded_point_tables
    from kornia_tpu_torch.parallel.dist_posegraph import partition_pose_graph
    from kornia_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from kornia_tpu_torch.slam.ba import _cost, _robust_kernels, bundle_adjust
    from kornia_tpu_torch.slam.posegraph import optimize_pose_graph
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (b) SfM scale, (c) the circuits, (d) 480x640 / 8 = 60 x 80 tokens
    C, P, T, sparse = sfm_scale_arrays(DIST_MIN_DEPTH)
    tables = build_sharded_point_tables(sparse["cam_idx"], sparse["pt_idx"],
                                        sparse["uv"], sparse["valid"], P, T)
    sparse["C"] = C
    graphs = {"small": ring_arrays(*DIST_PG_SMALL),
              "large": ring_arrays(*DIST_PG_LARGE)}
    parts = {k: partition_pose_graph(g["src"], g["dst"], g["valid"],
                                     g["t"].shape[0], 4)
             for k, g in graphs.items()}
    cfg = t_loftr.LoFTRConfig()
    params = {k: v for k, v in t_loftr.loftr_init_params(
        torch.Generator().manual_seed(SEED), cfg).items()
        if k.startswith("loftr_coarse.")}
    gen = torch.Generator().manual_seed(SEED)
    f0, f1 = (0.5 * torch.randn((2, 1, 60 * 80, cfg.coarse_dim),
                                generator=gen))
    ba = {D: dist_ba_arrays(D) for D in (1, 2, 4)}
    plans = {
        ("nccl", 1): dict(ba=ba[1], sparse=(sparse, tables),
                          loftr=(params, f0, f1), restart=ba[1]),
        ("gloo", 2): dict(ba=ba[2]),
        ("gloo", 4): dict(ba=ba[4], sparse=(sparse, tables),
                          pg={k: (graphs[k], parts[k]) for k in graphs},
                          loftr=(params, f0, f1)),
    }
    worlds, world_s = {}, {}
    for (backend, D), plan in plans.items():
        t0 = time.perf_counter()
        if D == 1:
            # one NCCL rank in this process: NCCL's collectives run
            with tempfile.TemporaryDirectory(prefix="nccl1-") as d:
                dist.init_process_group(
                    "nccl", init_method="file://" + os.path.join(d, "store"),
                    world_size=1, rank=0, device_id=dev)
                try:
                    mesh = make_mesh(devices=[dev])
                    with use_mesh(mesh):
                        worlds[(backend, D)] = dist_world(mesh, plan)
                finally:
                    dist.destroy_process_group()
        else:
            worlds[(backend, D)] = spmd.spawn(dist_world, D, backend, "cuda",
                                              plan)
        world_s[f"{backend}{D}"] = time.perf_counter() - t0
    rows = [r for w in worlds.values() for r in w["rows"]]
    for r in rows:
        print(f"distributed {r['what']} {r['backend']} D={r['world']}: "
              f"{r['ms_per_iter']:.3f} ms/iteration "
              f"({r['iters_per_s']:.2f}/s), {r['all_reduces_per_iter']:.1f} "
              f"all_reduces, {r['all_reduce_bytes_per_iter']:.0f} B an "
              f"iteration, {100 * r['collective_share']:.1f}% in collectives "
              f"(timed call {r['timed_ms_per_iter']:.3f} ms/iteration), peak "
              f"{[round(b / 2**20, 1) for b in r['peak_bytes_per_rank']]} MiB"
              f", ranks agree {r['ranks_agree']}")
    checks = {}
    failures = [f"{r['what']} {r['backend']} D={r['world']}: ranks differ"
                for r in rows if not r["ranks_agree"]]
    failures += [f"{k}: a rank imported JAX" for k, w in worlds.items()
                 if w["jax_imported"]]
    # (a) the costs fall; D = 4 against single-device BA
    huber = _robust_kernels(3.0)["huber"]
    for D in (1, 2, 4):
        a = ba[D]
        s0, prob = ba_on(dict(a, pt_idx=a["pt_global"]), dev)
        cost0 = float(_cost(s0, prob, huber))
        row = next(r for r in rows if r["what"] == "dense_ba"
                   and r["world"] == D)
        row["cost_initial"] = cost0
        # PG_COST_ATOL of the first step's cost: the rounding floor of a
        # converged pose graph
        if not _falling_costs(row["costs"], f"dense BA D={D}", cost0,
                              PG_COST_ATOL):
            failures.append(f"dense BA D={D}: costs do not fall from "
                            f"{cost0}: {row['costs']}")
    a = ba[4]
    s0, prob = ba_on(dict(a, pt_idx=a["pt_global"]), dev)
    single, _ = bundle_adjust(s0, prob, a["C"], a["points"].shape[0],
                              num_iters=DIST_BA_ITERS)
    w4 = worlds[("gloo", 4)]["ba_state"]
    sd, _ = ba_on(dict(a, pt_idx=a["pt_global"], wxyz=w4["wxyz"], t=w4["t"],
                       points=w4["points"]), dev)
    checks["dense_ba_rms_px"] = dict(D4=_rms(sd, prob),
                                     single=_rms(single, prob))
    if not abs(_rms(sd, prob) - _rms(single, prob)) <= DIST_RMS_ATOL:
        failures.append(f"dense BA D=4 vs single device: RMS "
                        f"{checks['dense_ba_rms_px']}")
    # (b) the costs fall; the first reduced systems D = 4 vs D = 1
    s0, prob = ba_on(sparse, dev)
    cost0 = float(_cost(s0, prob, huber))
    for D in (1, 4):
        row = next(r for r in rows if r["what"] == "sparse_ba"
                   and r["world"] == D)
        row["cost_initial"] = cost0
        if not _falling_costs(row["costs"], f"sparse BA D={D}", cost0,
                              PG_COST_ATOL):
            failures.append(f"sparse BA D={D}: costs do not fall from "
                            f"{cost0}: {row['costs']}")
    S1 = worlds[("nccl", 1)]["sparse_system"]
    S4 = worlds[("gloo", 4)]["sparse_system"]
    checks["sparse_system_rel"] = float(np.abs(S4 - S1).max()
                                        / np.abs(S1).max())
    if not checks["sparse_system_rel"] <= DIST_SYSTEM_RTOL:
        failures.append(f"sparse BA: reduced systems D=4 vs D=1 differ by "
                        f"{checks['sparse_system_rel']:.3e}")
    # (c) dense and streaming agree with each other and with one device
    w = worlds[("gloo", 4)]
    poses, graph = pose_graph_on(graphs["small"], dev)
    ps, _ = optimize_pose_graph(poses, graph, num_iters=DIST_PG_ITERS)
    one = dict(wxyz=ps.r.q.data.cpu().numpy(), t=ps.t.cpu().numpy())
    for x, y, what in ((w["pg_small_dense"], w["pg_small_streaming"],
                        "dense vs streaming"),
                       (w["pg_small_dense"], one, "dense vs one device"),
                       (w["pg_small_streaming"], one,
                        "streaming vs one device")):
        dt = float(np.abs(x["t"] - y["t"]).max())
        dq = float(np.abs(np.abs((x["wxyz"] * y["wxyz"]).sum(-1)) - 1).max())
        checks[f"pose_graph_small {what}"] = dict(t=dt, dot=dq)
        if not (dt <= DIST_PG_T_ATOL and dq <= DIST_PG_DOT_ATOL):
            failures.append(f"pose graph small, {what}: t {dt:.3e}, "
                            f"dots {dq:.3e}")
    checks["pose_graph_large_dense_refused"] = w["large_dense_refused"]
    if w["large_dense_refused"] is None:
        failures.append("pose graph large: the dense path did not refuse")
    for r in rows:
        if r["what"].startswith("pose_graph") and not _falling_costs(
                r["costs"], r["what"], rise=PG_COST_ATOL):
            failures.append(f"{r['what']}: costs do not fall: {r['costs']}")
    # (d) LoFTR's coarse stage against the single-device transformer
    p = {k: v.to(dev) for k, v in params.items()}
    with torch.no_grad():
        ref = t_loftr._transformer(p, "loftr_coarse", cfg.num_coarse_layers,
                                   cfg.num_heads, f0.to(dev), f1.to(dev))
        single_ms, _ = median_ms(lambda: t_loftr._transformer(
            p, "loftr_coarse", cfg.num_coarse_layers, cfg.num_heads,
            f0.to(dev), f1.to(dev)))
    checks["loftr_single_ms"] = single_ms
    for k in (("nccl", 1), ("gloo", 4)):
        o0, o1 = worlds[k]["loftr"]
        rel = max(float((o.to(dev) - r).abs().max() / r.abs().max())
                  for o, r in zip((o0, o1), ref))
        checks[f"loftr_rel_{k[0]}{k[1]}"] = rel
        if not rel <= DIST_LOFTR_RTOL:
            failures.append(f"LoFTR CP {k}: {rel:.3e} from _transformer")
    # (e) the restart
    rs = worlds[("nccl", 1)]["restart"]
    checks["restart"] = rs
    if not (rs["stopped_at"] == DIST_RESTART_STOP
            and rs["resumed_from"] == DIST_RESTART_STOP - 1
            and rs["resumed_steps"] == DIST_RESTART_STEPS
            - DIST_RESTART_STOP + 1
            and rs["max_abs_diff"] <= DIST_RESTART_ATOL
            and rs["round_trip_bitwise"]):
        failures.append(f"restart: {rs}")
    out = dict(card=card, rows=rows, checks=checks, world_s=world_s,
               separators={k: int(v.num_separators) for k, v in parts.items()},
               note="gloo ranks share one card and stage each CUDA "
                    "collective through the host (a synchronisation per "
                    "call); NCCL runs one rank: equivalence, not scaling",
               seconds=time.perf_counter() - t_phase)
    print(f"distributed checks: {checks}")
    print(f"distributed phase: {out['seconds']:.1f} s, worlds "
          f"{ {k: round(v, 1) for k, v in world_s.items()} }")
    print(json.dumps({"distributed": out}))
    if failures:
        fail("distributed: " + "; ".join(failures))
    return out


# --- step 13: multi-object tracking, image containers and file IO -----------

# MOT17-02's geometry (1920x1080, 600 frames at 30 fps), a seeded synthetic
# stream in place of its files: about 60 pedestrians alive at once (at most
# 80), entering and leaving at the borders, h 60-400 px, w = 0.41 h
MOT_W, MOT_H, MOT_FRAMES, MOT_FPS, MOT_N = 1920, 1080, 600, 30, 128
MOT_ALIVE, MOT_MAX_ALIVE, MOT_FALSE_POS = 60, 80, 8
MOT_XCHECK = 150       # frames also tracked by the CPU port
MOT_BOX_RTOL = 1e-3    # card vs CPU boxes, of the largest coordinate
MOT_ID_SHARE = 0.9     # matched ground truth carrying its majority id
MOT_PROFILE = 20       # frames under torch.profiler
BOX_VIS_FRAMES = 60    # (b)'s frames, with and without visualize
TUM_FRAMES, KITTI_FRAMES, TUM_WINDOW = 30, 10, 5
POSE_FILE_ATOL = 1e-6  # poses read back against those written


def mot_stream(seed: int = SEED):
    """(a)'s detections (frames, 128, 6) rows (class, score, x, y, w, h)
    and the ground truth of each frame (target ids, xyxy boxes). Targets
    move at constant velocity (0.5-3 px a frame); a target is missed with
    probability 0.1 a frame, and 10% of them vanish for one run of 5-20
    frames; a detection is scored U(0.6, 1), 15% of them U(0.15, 0.5) (the
    second round's traffic); 8 false positives a frame scored U(0.1,
    0.45); boxes jittered by 1 px, clipped to the frame and kept where at
    least 30% of the box is inside; rows shuffled, padded with score 0."""
    rng = np.random.default_rng(seed)
    targets, next_id = [], 0

    def spawn(frame, inside):
        nonlocal next_id
        bh = rng.uniform(60, 400)
        bw = 0.41 * bh
        speed, ang = rng.uniform(0.5, 3.0), rng.uniform(0, 2 * math.pi)
        v = np.array([math.cos(ang), math.sin(ang)]) * speed
        if inside:
            p = rng.uniform([0, 0], [MOT_W - bw, MOT_H - bh])
        else:  # on a border, half outside, moving in
            side = rng.integers(4)
            p = rng.uniform([0, 0], [MOT_W - bw, MOT_H - bh])
            if side == 0:
                p[0], v[0] = -bw / 2, abs(v[0])
            elif side == 1:
                p[0], v[0] = MOT_W - bw / 2, -abs(v[0])
            elif side == 2:
                p[1], v[1] = -bh / 2, abs(v[1])
            else:
                p[1], v[1] = MOT_H - bh / 2, -abs(v[1])
        occ = None
        if rng.random() < 0.1:
            s0 = frame + int(rng.integers(0, MOT_FRAMES))
            occ = (s0, s0 + int(rng.integers(5, 21)))
        targets.append(dict(id=next_id, p=p, v=v, wh=np.array([bw, bh]),
                            occ=occ))
        next_id += 1

    for _ in range(MOT_ALIVE):
        spawn(0, True)
    dets = np.zeros((MOT_FRAMES, MOT_N, 6), np.float32)
    gt = []
    lim = np.array([MOT_W, MOT_H], np.float64)
    for f in range(MOT_FRAMES):
        if len(targets) < MOT_MAX_ALIVE and (
                rng.random() < (0.5 if len(targets) < MOT_ALIVE else 0.02)):
            spawn(f, False)
        rows, gids, gboxes, keep = [], [], [], []
        for t in targets:
            p = t["p"]
            lo, hi = np.clip(p, 0, lim), np.clip(p + t["wh"], 0, lim)
            vis = np.prod(hi - lo) / np.prod(t["wh"])
            if (p + t["wh"] < 0).any() or (p > lim).any():
                continue  # left the frame
            keep.append(t)
            if vis < 0.3:
                continue
            gids.append(t["id"])
            gboxes.append([*lo, *hi])
            if (t["occ"] and t["occ"][0] <= f < t["occ"][1]) or \
                    rng.random() < 0.1:
                continue
            score = rng.uniform(0.15, 0.5) if rng.random() < 0.15 else \
                rng.uniform(0.6, 1.0)
            j_lo = lo + rng.normal(0, 1, 2)
            rows.append((0.0, score, *j_lo, *(hi - lo)))
        for t in keep:
            t["p"] = t["p"] + t["v"]
        targets = keep
        for _ in range(MOT_FALSE_POS):
            bh = rng.uniform(60, 400)
            xy = rng.uniform([0, 0], [MOT_W - 0.41 * bh, MOT_H - bh])
            rows.append((0.0, rng.uniform(0.1, 0.45), *xy, 0.41 * bh, bh))
        rng.shuffle(rows)
        dets[f, :len(rows)] = np.asarray(rows, np.float32)
        gt.append((np.asarray(gids, np.int64),
                   np.asarray(gboxes, np.float64).reshape(-1, 4)))
    return dets, gt


def identity_share(gt, ids: np.ndarray, boxes: np.ndarray,
                   valid: np.ndarray):
    """Of the ground-truth boxes matched at IoU > 0.5 by a valid track (the
    best one), the share that carries its target's majority track id; and
    the number of such matches."""
    from kornia_tpu_torch.tracking.bytetrack import _iou_matrix
    seen = {}
    for f, (gids, gboxes) in enumerate(gt):
        v = valid[f]
        if not len(gids) or not v.any():
            continue
        iou = _iou_matrix(torch.from_numpy(gboxes),
                          torch.from_numpy(boxes[f][v]).double()).numpy()
        best = iou.argmax(1)
        for g, k, ok in zip(gids, best, iou.max(1) > 0.5):
            if ok:
                seen.setdefault(int(g), []).append(int(ids[f][v][k]))
    n = sum(len(v) for v in seen.values())
    major = sum(max(np.bincount(v)) for v in seen.values())
    return major / max(n, 1), n


def _near_tie_margin(tracker, state, det) -> float:
    """The smallest gap between two IoU entries above the first round's
    threshold that round 1 sees at this frame (CPU state)."""
    from kornia_tpu_torch.tracking import bytetrack as bt
    mean, cov = bt._kf_predict(state.mean, state.cov)
    boxes = torch.stack([det[:, 2], det[:, 3], det[:, 2] + det[:, 4],
                         det[:, 3] + det[:, 5]], -1)
    s = bt.TrackState(mean, cov, *[getattr(state, f) for f in (
        "score", "cls", "track_id", "alive", "misses", "next_id")])
    iou = bt._iou_matrix(s.boxes_xyxy(), boxes)
    ok = state.alive[:, None] & (det[:, 1] > tracker.high)[None]
    v = np.sort(iou[ok & (iou > tracker.match_thresh)].numpy())
    return float(np.diff(v).min()) if v.size > 1 else float("inf")


def bytetrack_stream(dev) -> dict:
    """(a) ByteTracker() over the MOT17-scale stream."""
    from kornia_tpu_torch.tracking.bytetrack import ByteTracker
    dets, gt = mot_stream()
    alive_gt = [len(g[0]) for g in gt]
    n_det = (dets[:, :, 1] > 0).sum(1)
    print(f"tracking_io (a) stream {MOT_W}x{MOT_H}, {MOT_FRAMES} frames at "
          f"{MOT_FPS} fps: ground-truth boxes a frame {min(alive_gt)}-"
          f"{max(alive_gt)} (mean {np.mean(alive_gt):.1f}), detection rows "
          f"{n_det.min()}-{n_det.max()} of {MOT_N}")
    d_dev = torch.from_numpy(dets).to(dev)
    tr = ByteTracker()
    if tr.device.type != "cuda" or tr.init_state().mean.device.type != "cuda":
        fail("tracking_io (a): ByteTracker() is not on the card by default")
    T = tr.capacity
    out = dict(ids=torch.zeros((MOT_FRAMES, T), dtype=torch.int32,
                               device=dev),
               valid=torch.zeros((MOT_FRAMES, T), dtype=torch.bool,
                                 device=dev),
               boxes=torch.zeros((MOT_FRAMES, T, 4), device=dev))

    def run(frames=range(MOT_FRAMES), record=True):
        s = tr.init_state()
        for f in frames:
            s = tr.update(s, d_dev[f])
            if record:
                b, i, _, _, v = tr.current_tracks(s)
                out["boxes"][f], out["ids"][f], out["valid"][f] = b, i, v
        return s

    run(range(10), record=False)  # warm-up: allocator, library handles
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    no_host_sync(run)  # raises on any synchronising call
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    fps = MOT_FRAMES / wall
    # ms a frame: host clock around each synchronised update
    s, per_frame = tr.init_state(), []
    for f in range(MOT_FRAMES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s = tr.update(s, d_dev[f])
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t1) * 1e3)
    med, p90 = float(np.median(per_frame)), float(np.percentile(per_frame,
                                                                90))
    # the device over MOT_PROFILE frames from the middle of the stream
    s_mid = run(range(300), record=False)
    window = range(300, 300 + MOT_PROFILE)

    def prof_run():
        s = s_mid
        for f in window:
            s = tr.update(s, d_dev[f])

    wall_win = synced_s(prof_run) * 1e3
    busy, n_k, kern = device_profile(prof_run)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    print(f"tracking_io (a) ByteTracker(): {fps:.2f} frames/s "
          f"({1e3 / fps:.3f} ms a frame pipelined, no host sync in "
          f"{MOT_FRAMES} updates); synchronised frames median {med:.3f} ms, "
          f"90th percentile {p90:.3f} ms; peak {peak / 2**20:.2f} MiB; "
          f"{n_k / MOT_PROFILE:.0f} kernels a frame, device busy "
          f"{busy:.3f} of {wall_win:.3f} ms over {MOT_PROFILE} frames (idle "
          f"share {1.0 - busy / wall_win:.4f})")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    ids = out["ids"].cpu().numpy()
    valid = out["valid"].cpu().numpy()
    boxes = out["boxes"].cpu().numpy()
    # the first MOT_XCHECK frames on the CPU port
    tc = ByteTracker(device="cpu")
    sc = tc.init_state()
    t1 = time.perf_counter()
    for f in range(MOT_XCHECK):
        d = torch.from_numpy(dets[f])
        prev = sc
        sc = tc.update(sc, d)
        b, i, _, _, v = tc.current_tracks(sc)
        scale = float(b[sc.alive].abs().max()) if sc.alive.any() else 1.0
        err = float((torch.from_numpy(boxes[f]) - b)[v].abs().max()) \
            if v.any() else 0.0
        if not (np.array_equal(i.numpy(), ids[f])
                and np.array_equal(v.numpy(), valid[f])
                and err <= MOT_BOX_RTOL * scale):
            fail(f"tracking_io (a): card and CPU split at frame {f} (ids "
                 f"equal {np.array_equal(i.numpy(), ids[f])}, valid equal "
                 f"{np.array_equal(v.numpy(), valid[f])}, boxes {err:.3e} of "
                 f"{scale:.1f}); the near-tie IoU margin of round 1 there: "
                 f"{_near_tie_margin(tc, prev, d):.3e}")
    cpu_s = time.perf_counter() - t1
    share, n_match = identity_share(gt, ids, boxes, valid)
    print(f"tracking_io (a) card vs CPU port over {MOT_XCHECK} frames: ids "
          f"and valid masks equal, boxes within {MOT_BOX_RTOL} of the "
          f"largest coordinate (CPU {cpu_s * 1e3 / MOT_XCHECK:.2f} ms a "
          f"frame); identity: {n_match} ground-truth boxes matched at IoU > "
          f"0.5, {share:.4f} carry their target's majority id (limit "
          f"{MOT_ID_SHARE}); valid tracks a frame {valid.sum(1).mean():.1f}")
    if not share >= MOT_ID_SHARE:
        fail(f"tracking_io (a): identity share {share:.4f} < {MOT_ID_SHARE}")
    return dict(frames_per_s=fps, ms_pipelined=1e3 / fps,
                ms_median=med, ms_p90=p90, peak_bytes=peak,
                kernels_per_frame=n_k / MOT_PROFILE, busy_ms=busy,
                window_ms=wall_win, idle_share=1.0 - busy / wall_win,
                cpu_ms_per_frame=cpu_s * 1e3 / MOT_XCHECK,
                identity_share=share, identity_matches=n_match,
                gt_boxes_per_frame=float(np.mean(alive_gt)),
                valid_tracks_per_frame=float(valid.sum(1).mean()),
                dets=d_dev)


def boxtracker_visualize(dev, d_dev) -> dict:
    """(b) BoxTracker with a caller's detector over (a)'s detections."""
    from kornia_tpu_torch.tracking.bytetrack import (BoxTracker, ByteTracker,
                                                     TrackState)
    frame = torch.rand((1, 3, MOT_H, MOT_W), device=dev,
                       generator=torch.Generator(dev).manual_seed(SEED))
    count = [0]

    def detector(image):
        d = d_dev[count[0] % MOT_FRAMES][None]
        count[0] += 1
        return d

    bt = BoxTracker(detector)
    times = {False: [], True: []}
    for vis in (False, True):
        bt.reset()
        count[0] = 0
        for _ in range(BOX_VIS_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.update(frame)
            if vis:
                drawn = bt.visualize(frame)
            torch.cuda.synchronize()
            times[vis].append((time.perf_counter() - t0) * 1e3)
    peak = peak_bytes(lambda: bt.visualize(frame))
    n_valid = int(bt.tracker.current_tracks(bt.state)[4].sum())
    cpu = BoxTracker(detector, ByteTracker(device="cpu"))
    cpu.state = TrackState(*[getattr(bt.state, f.name).cpu()
                             for f in dataclasses.fields(TrackState)])
    same = torch.equal(drawn.cpu(), cpu.visualize(frame.cpu()))
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"tracking_io (b) BoxTracker on 1x3x{MOT_H}x{MOT_W}, "
          f"{BOX_VIS_FRAMES} frames: {ms[False]:.3f} ms a frame without "
          f"visualize, {ms[True]:.3f} with it ({n_valid} boxes drawn at the "
          f"last frame); visualize's peak {peak / 2**20:.1f} MiB; the drawn "
          f"frame equals the CPU port's: {same}")
    if not same:
        fail("tracking_io (b): visualize differs from the CPU port's")
    return dict(ms_without_visualize=ms[False], ms_with_visualize=ms[True],
                visualize_peak_bytes=peak, boxes_drawn=n_valid)


def write_sequences(root: str, dev):
    """TUM_FRAMES frames of step 9's room along the walk at 480x640, as a
    TUM RGB-D sequence (rgb/, depth/ (16-bit, 5000 a metre), rgb.txt,
    depth.txt, groundtruth.txt with the depth and pose timestamps 5 and 2
    ms after the colour ones) under root/tum and the first KITTI_FRAMES as
    a KITTI odometry sequence (image_2/, poses.txt) under root/kitti. The
    frames (uint8, H x W), camera centres, (w, x, y, z) quaternions and
    the KITTI frames' rotations, all camera to world."""
    from kornia_tpu_torch.geometry.conversions import \
        rotation_matrix_to_quaternion
    from kornia_tpu_torch.io import write_image
    from kornia_tpu_torch.utils.render import render_scene, walk_trajectory
    Kt, scene = vo_setup(dev)
    traj = walk_trajectory(TUM_FRAMES)
    Rs = np.stack([T[:3, :3].astype(np.float64).T for T in traj])
    quats = rotation_matrix_to_quaternion(torch.from_numpy(Rs)).numpy()
    tum, kitti = os.path.join(root, "tum"), os.path.join(root, "kitti")
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(tum, d))
    os.makedirs(os.path.join(kitti, "image_2"))
    frames, centres = [], []
    with open(os.path.join(tum, "rgb.txt"), "w") as fr, \
            open(os.path.join(tum, "depth.txt"), "w") as fd, \
            open(os.path.join(tum, "groundtruth.txt"), "w") as fg:
        fr.write("# color images\n")
        fd.write("# depth images\n")
        fg.write("# ground truth trajectory\n")
        for i, T in enumerate(traj):
            img, z = render_scene(scene, Kt, torch.from_numpy(T).to(dev),
                                  H, W)
            u8 = (img[0] * 255.0).clamp(0, 255).to(torch.uint8).expand(
                3, H, W)
            depth = (z * 5000.0).clamp(0, 65535).to(torch.int32).cpu(
                ).numpy().astype(np.uint16)[None]
            c = -Rs[i] @ T[:3, 3].astype(np.float64)
            t = 100.0 + i / 30.0
            write_image(os.path.join(tum, "rgb", f"{i:04d}.png"), u8)
            write_image(os.path.join(tum, "depth", f"{i:04d}.png"), depth)
            fr.write(f"{t:.6f} rgb/{i:04d}.png\n")
            fd.write(f"{t + 0.005:.6f} depth/{i:04d}.png\n")
            fg.write(f"{t + 0.002:.6f} " + " ".join(  # qx qy qz qw
                f"{v:.9f}" for v in (*c, *quats[i, 1:], quats[i, 0])) + "\n")
            if i < KITTI_FRAMES:
                write_image(os.path.join(kitti, "image_2", f"{i:06d}.png"),
                            u8)
            frames.append(u8[0].cpu().numpy())
            centres.append(c)
    Rt = np.concatenate([Rs, np.stack(centres)[:, :, None]], 2)
    np.savetxt(os.path.join(kitti, "poses.txt"),
               Rt[:KITTI_FRAMES].reshape(KITTI_FRAMES, 12), fmt="%.9e")
    return (Kt, np.stack(frames), np.stack(centres), quats,
            Rs[:KITTI_FRAMES])


def files_to_path(K, dev) -> dict:
    """(c) TUM and KITTI sequences written and read back, the native
    decoder's throughput where it builds, and two_view_pose on two decoded
    frames."""
    import tempfile

    from kornia_tpu_torch.io import (KittiOdometrySequence, TUMSequence,
                                     native)
    from kornia_tpu_torch.slam.twoview import two_view_pose
    out = {}
    has_native = native.native_available()
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = None
    decoder = "native libjpeg/libpng" if has_native else pil
    print(f"tracking_io (c) decoders: native_available() {has_native}, "
          f"{pil or 'PIL absent'}; PNG frames decode through {decoder}")
    if decoder is None:
        fail("tracking_io (c): no image decoder on this machine (native "
             "library not built and PIL absent)")
    with tempfile.TemporaryDirectory(prefix="tracking-io-") as root:
        t0 = time.perf_counter()
        Kt, frames, centres, quats, Rs = write_sequences(root, dev)
        out["write_s"] = time.perf_counter() - t0
        seq = TUMSequence(os.path.join(root, "tum"), window=TUM_WINDOW,
                          stride=TUM_WINDOW, grayscale=False)
        want = (frames.astype(np.float32) / np.float32(255.0))
        win_ms, img_eq, gt_err = [], True, 0.0
        for w in range(len(seq)):
            t1 = time.perf_counter()
            item = seq[w]
            win_ms.append((time.perf_counter() - t1) * 1e3)
            sl = slice(w * TUM_WINDOW, (w + 1) * TUM_WINDOW)
            img_eq &= bool(np.array_equal(item["images"][:, 0], want[sl])
                           and np.array_equal(item["images"][:, 0],
                                              item["images"][:, 2]))
            q = item["quaternions_wxyz"]
            gt_err = max(gt_err,
                         float(np.abs(item["positions"] - centres[sl]).max()),
                         float(np.abs(q - quats[sl]).max()))
            if w == 0:
                window0 = item
        kseq = KittiOdometrySequence(os.path.join(root, "kitti", "image_2"),
                                     os.path.join(root, "kitti",
                                                  "poses.txt"),
                                     window=TUM_WINDOW, stride=TUM_WINDOW)
        k_eq, k_err = True, 0.0
        for w in range(len(kseq)):
            item = kseq[w]
            sl = slice(w * TUM_WINDOW, (w + 1) * TUM_WINDOW)
            k_eq &= bool(np.array_equal(item["images"][:, 0], want[sl]))
            k_err = max(k_err, float(np.abs(item["R"] - Rs[sl]).max()),
                        float(np.abs(item["t"] - centres[sl]).max()))
        out.update(tum_windows=len(seq), kitti_windows=len(kseq),
                   window_ms=float(np.median(win_ms)), window_runs_ms=win_ms,
                   tum_images_equal=img_eq, tum_pose_err=gt_err,
                   kitti_images_equal=k_eq, kitti_pose_err=k_err,
                   native_available=has_native, decoder=decoder)
        print(f"tracking_io (c) TUM {TUM_FRAMES} frames 480x640 through "
              f"TUMSequence(window={TUM_WINDOW}, stride={TUM_WINDOW}): "
              f"{len(seq)} windows, median {out['window_ms']:.2f} ms a "
              f"window, frames bit for bit {img_eq}, ground truth within "
              f"{gt_err:.2e}; KITTI {KITTI_FRAMES} frames: {len(kseq)} "
              f"windows, frames {k_eq}, R and t within {k_err:.2e} (limit "
              f"{POSE_FILE_ATOL}); written in {out['write_s']:.2f} s")
        if not (img_eq and k_eq and gt_err <= POSE_FILE_ATOL
                and k_err <= POSE_FILE_ATOL):
            fail("tracking_io (c): the sequences read back differ from what "
                 "was written")
        if has_native:
            paths = sorted(os.path.join(root, "tum", "rgb", f)
                           for f in os.listdir(os.path.join(root, "tum",
                                                            "rgb")))
            s_batch = synced_s(lambda: native.read_batch_native(
                paths, (240, 320)))
            t1 = time.perf_counter()
            n = sum(b.shape[0] for b in native.NativeBatchLoader(
                [paths[i:i + TUM_WINDOW] for i in range(0, len(paths),
                                                        TUM_WINDOW)],
                (240, 320)))
            s_loader = time.perf_counter() - t1
            out.update(native_batch_images_per_s=len(paths) / s_batch,
                       native_loader_images_per_s=n / s_loader)
            print(f"tracking_io (c) native decode + resize to 240x320: "
                  f"read_batch_native {len(paths) / s_batch:.1f} images/s, "
                  f"NativeBatchLoader {n / s_loader:.1f} images/s")
    # the main path on frames 0 and 4 of the first decoded window, and on
    # the same frames before they were written
    dec = [torch.from_numpy(window0["images"][i, :1][None]).to(dev)
           for i in (0, 4)]
    mem = [torch.from_numpy(want[i][None, None]).to(dev) for i in (0, 4)]
    if not all(torch.equal(a, b) for a, b in zip(dec, mem)):
        fail("tracking_io (c): decoded inputs differ from the written frames")

    def pair(imgs):
        gen = torch.Generator(device=dev).manual_seed(1)
        return lambda: two_view_pose(imgs[0], imgs[1], Kt, generator=gen,
                                     num_features=NF, device=dev)

    launches = counted_run(K, pair(dec), "tracking_io (c) two_view_pose "
                                         "from disk")
    res, ref = pair(dec)(), pair(mem)()
    dR = float((res.R - ref.R).abs().max())
    dt = float((res.t - ref.t).abs().max())
    bitwise = torch.equal(res.R, ref.R) and torch.equal(res.t, ref.t)
    rot = math.degrees(angle_of_rotation(res.R))
    print(f"tracking_io (c) two_view_pose on decoded frames 0 and 4: "
          f"rotation {rot:.4f} deg, t {res.t.reshape(-1).tolist()}, inliers "
          f"{int(res.num_inliers)}; against the frames before writing: R "
          f"{dR:.2e}, t {dt:.2e} (bitwise {bitwise}; limit "
          f"{POSE_FILE_ATOL})")
    if not (dR <= POSE_FILE_ATOL and dt <= POSE_FILE_ATOL):
        fail("tracking_io (c): the pose from disk differs from the pose of "
             "the frames before writing")
    calls = capture_launches(K, pair(dec))
    checks = check_captured(K, calls, "tracking_io (c)")
    out.update(launches=launches, pose_rotation_deg=rot,
               pose_diff_R=dR, pose_diff_t=dt, pose_bitwise=bitwise,
               inliers=int(res.num_inliers), checks=checks, calls=calls)
    return out


def tracking_io_phase(K, dev) -> dict:
    """Step 13: multi-object tracking, image containers and file IO (see
    the module's docstring)."""
    t_phase = time.perf_counter()
    part_s = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        part_s[name] = time.perf_counter() - t
        return r

    a = part("bytetrack", bytetrack_stream, dev)
    b = part("boxtracker", boxtracker_visualize, dev, a.pop("dets"))
    c = part("files", files_to_path, K, dev)
    results, counts = path_entries(K, c.pop("calls"), c["checks"],
                                   c["launches"], "tracking_io")
    report(results)
    out = dict(bytetrack=a, boxtracker=b, files=c, part_s=part_s,
               seconds=time.perf_counter() - t_phase)
    print(f"tracking_io phase: {out['seconds']:.1f} s, parts "
          f"{ {k: round(v, 1) for k, v in part_s.items()} }")
    print(json.dumps({"tracking_io": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 14: the image-op layer ---------------------------------------------

IMAGE_OPS_SHAPE = (32, 3, 256, 256)  # benchmarks/per_op.py's regime
FRAME_HW = (1080, 1920)              # one video frame
VOLUME_SHAPE = (1, 1, 64, 128, 128)
IMAGE_OPS_REPS = 10                  # device_ms calls per op
IMAGE_OPS_XCHECK = 2                 # images of a batch also run on the CPU
# card against the CPU port, the CPU tests' tolerances (tests/test_torch_
# {color,filters_ops,warp_ops,enhance_morph,volume_jpeg_dcn}.py): 1e-5 for
# [0, 1] maps, 1e-4 for Lab, hue (on the circle), JPEG and deform_conv2d,
# 0 for the integer-valued results (the integer LUTs of equalize, CLAHE
# and posterize among them: the card computes them bit for bit)
IMAGE_ATOL, IMAGE_WIDE_ATOL = 1e-5, 1e-4
# the thin-plate spline's (N + 3)² system, cuSOLVER against LAPACK in f32:
# of the largest weight, as the CPU tests hold the solves. Its condition
# moves a pixel's sampling point by about 2e-3 px between the devices'
# solves, so the warp is compared on the CPU's weights
SOLVE_RTOL = 1e-4
# A warp's sampling coordinates come through matrix products (and
# linspace) that card and CPU round one or two ulps apart; a bilinear or
# bicubic sample of a [0, 1] image moves by at most 1.5 (the cubic's slope)
# times that. Warps are held to 1e-5 plus three ulps of a coordinate of the
# source's size: 9.2e-5 at 256, 4.6e-5 at 128, 3.8e-4 at 1920.


def sample_atol(size: int) -> float:
    return IMAGE_ATOL + 3.0 * float(np.spacing(np.float32(size)))


# per_op.py's homography (benchmarks/per_op.py:59-60)
PER_OP_M3 = [[0.98, 0.05, 3.0], [-0.04, 1.01, -2.0], [1e-5, -2e-5, 1.0]]


def per_op_sweep(dev) -> dict:
    """benchmarks/per_op.py:73-116's 33 ops with its arguments, as
    name -> (fn(x), how card and CPU are compared)."""
    from kornia_tpu_torch.feature.responses import (gftt_response,
                                                    harris_response)
    from kornia_tpu_torch.ops import enhance as E
    from kornia_tpu_torch.ops import filters as Fl
    from kornia_tpu_torch.ops import morphology as Mo
    from kornia_tpu_torch.ops import warp as Wp
    from kornia_tpu_torch.ops.color import (rgb_to_grayscale, rgb_to_hsv,
                                            rgb_to_lab)
    H, W = IMAGE_OPS_SHAPE[-2:]
    M3 = torch.tensor(PER_OP_M3, device=dev)
    ones5 = torch.ones(5, 5, device=dev)
    angle = torch.tensor(30.0, device=dev)

    def bcast(m):
        return lambda x: m.to(x.device).expand(x.shape[0], *m.shape)

    M23, M33 = bcast(M3[:2]), bcast(M3)
    return {
        "hflip": (Wp.hflip, 0.0),
        "vflip": (Wp.vflip, 0.0),
        "rgb_to_grayscale": (rgb_to_grayscale, IMAGE_ATOL),
        "rgb_to_hsv": (rgb_to_hsv, "hue"),
        "rgb_to_lab": (rgb_to_lab, IMAGE_WIDE_ATOL),
        "adjust_brightness": (lambda x: E.adjust_brightness(x, 0.2),
                              IMAGE_ATOL),
        "adjust_contrast": (lambda x: E.adjust_contrast(x, 1.1), IMAGE_ATOL),
        "adjust_saturation": (lambda x: E.adjust_saturation(x, 1.3),
                              IMAGE_ATOL),
        "adjust_hue": (lambda x: E.adjust_hue(x, 0.3), IMAGE_ATOL),
        "adjust_gamma": (lambda x: E.adjust_gamma(x, 1.5), IMAGE_ATOL),
        "solarize": (lambda x: E.solarize(x, 0.6), 0.0),
        "posterize": (lambda x: E.posterize(x, 4), 0.0),
        "sharpness": (lambda x: E.sharpness(x, 0.7), IMAGE_ATOL),
        "equalize": (E.equalize, 0.0),
        "normalize_min_max": (E.normalize_min_max, IMAGE_ATOL),
        "gaussian_blur_3x3": (lambda x: Fl.gaussian_blur2d(x, 3, 0.8),
                              IMAGE_ATOL),
        "gaussian_blur_9x9": (lambda x: Fl.gaussian_blur2d(x, 9, 1.8),
                              IMAGE_ATOL),
        "box_blur_5": (lambda x: Fl.box_blur(x, 5), IMAGE_ATOL),
        "median_blur_3": (lambda x: Fl.median_blur(x, 3), 0.0),
        "bilateral_blur_5": (lambda x: Fl.bilateral_blur(
            x, 5, 0.1, (1.5, 1.5)), IMAGE_ATOL),
        "motion_blur_7": (lambda x: Fl.motion_blur(x, 7, 45.0, 0.0),
                          IMAGE_ATOL),
        "sobel": (Fl.sobel, IMAGE_ATOL),
        "spatial_gradient": (Fl.spatial_gradient, IMAGE_ATOL),
        "canny": (lambda x: Fl.canny(rgb_to_grayscale(x))[0], IMAGE_ATOL),
        "dilation_5": (lambda x: Mo.dilation(x, ones5), 0.0),
        "erosion_5": (lambda x: Mo.erosion(x, ones5), 0.0),
        "resize_half": (lambda x: Wp.resize(x, (H // 2, W // 2)),
                        IMAGE_ATOL),
        "resize_half_aa": (lambda x: Wp.resize(x, (H // 2, W // 2),
                                               antialias=True), IMAGE_ATOL),
        "rotate_30": (lambda x: Wp.rotate(x, angle), sample_atol(W)),
        "warp_affine": (lambda x: Wp.warp_affine(x, M23(x), (H, W)),
                        sample_atol(W)),
        "warp_perspective": (lambda x: Wp.warp_perspective(x, M33(x),
                                                           (H, W)),
                             sample_atol(W)),
        "harris_response": (lambda x: harris_response(rgb_to_grayscale(x)),
                            IMAGE_ATOL),
        "gftt_response": (lambda x: gftt_response(rgb_to_grayscale(x)),
                          IMAGE_ATOL),
    }


def image_ops_inputs(dev) -> dict:
    """(a)'s batch and (b)'s frame, depth map, volume, noise, grids and the
    ALIKED-n16 DCN operands, from one seeded generator (uniform on [0, 1)
    unless said)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def uni(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    Hf, Wf = FRAME_HW
    out = dict(batch=uni(*IMAGE_OPS_SHAPE), frame=uni(1, 3, Hf, Wf),
               depth=uni(1, 1, Hf, Wf), volume=uni(*VOLUME_SHAPE),
               noise=uni(1, 2, Hf, Wf, lo=-1.0, hi=1.0),
               tps_src=uni(1, 16, 2, lo=-0.9, hi=0.9),
               tps_shift=uni(1, 16, 2, lo=-0.05, hi=0.05),
               se5=uni(5, 5, hi=0.1))
    # a 10-degree rotation with a 1.1 zoom as the bicubic sampling grid
    from kornia_tpu_torch.core.grid import create_meshgrid
    c, s = math.cos(math.radians(10.0)) * 1.1, math.sin(math.radians(10.0))
    g = create_meshgrid(Hf, Wf, True, device=dev)
    out["grid"] = torch.stack([c * g[..., 0] - s * g[..., 1],
                               s * g[..., 0] + c * g[..., 1]], dim=-1)
    # ALIKED-n16 at 480x640 (feature/aliked.py:38-40, 119-125): block 3
    # at 60x80 (32 -> 64, 64 -> 64), block 4 at 15x20 (64 -> 128); 3x3
    # kernels, offsets clipped to +-max(H, W) / 4 (:62-63)
    dcn = []
    for c_in, c_out, h, w in ((32, 64, 60, 80), (64, 64, 60, 80),
                              (64, 128, 15, 20)):
        lim = max(h, w) / 4.0
        dcn.append((uni(1, c_in, h, w),
                    uni(1, 18, h, w, lo=-4.0, hi=4.0).clamp(-lim, lim),
                    uni(c_out, c_in, 3, 3, lo=-0.1, hi=0.1)))
    out["dcn"] = dcn
    from kornia_tpu_torch.ops.warp import get_tps_transform, warp_points_tps
    src = out["tps_src"].cpu()
    dst = src + out["tps_shift"].cpu()
    kw, aw = get_tps_transform(src, dst)
    out.update(tps_dst=dst.to(dev), tps_kw=kw.to(dev), tps_aw=aw.to(dev))
    # the spline's own f32 rounding on the CPU: its sampling points against
    # the same weights in f64, in pixels of the frame
    pts = g.reshape(1, -1, 2).cpu()
    p32 = warp_points_tps(pts, dst, kw, aw).double()
    p64 = warp_points_tps(pts.double(), dst.double(), kw.double(),
                          aw.double())
    out["tps_f32_px"] = float(((p32 - p64).abs() * torch.tensor(
        [Wf / 2.0, Hf / 2.0], dtype=torch.float64)).max())
    return out


def image_ops_rest(inp: dict) -> dict:
    """(b): the rest of the slice at the shapes its users run, as
    name -> (fn() on the card inputs, fn(inputs) for any device, how card
    and CPU are compared)."""
    from kornia_tpu_torch.ops import enhance as E
    from kornia_tpu_torch.ops import filters as Fl
    from kornia_tpu_torch.ops import morphology as Mo
    from kornia_tpu_torch.ops import warp as Wp
    from kornia_tpu_torch.ops.colormap import ColorMap
    from kornia_tpu_torch.ops.deform_conv import deform_conv2d
    from kornia_tpu_torch.ops.jpeg import jpeg_codec_differentiable
    from kornia_tpu_torch.ops.pyramid import build_laplacian_pyramid
    from kornia_tpu_torch.ops.warp3d import rotate3d, warp_affine3d
    Hf, Wf = FRAME_HW
    M34 = [[0.98, 0.05, 0.02, 2.0], [-0.04, 1.01, 0.03, -3.0],
           [0.01, -0.02, 0.97, 1.0]]

    def jpeg_backward(d):
        x = d["batch"].detach().requires_grad_(True)
        q = torch.tensor(50.0, device=x.device)
        jpeg_codec_differentiable(x, q).sum().backward()
        return x.grad

    def tps_solve(d):
        return Wp.get_tps_transform(d["tps_src"],
                                    d["tps_src"] + d["tps_shift"])

    def tps(d):
        # the weights solved once on the CPU (tps_solve holds the card's
        # solve to them): the warp is compared on the same spline
        return Wp.warp_image_tps(d["frame"], d["tps_dst"], d["tps_kw"],
                                 d["tps_aw"])

    def cmap(d):
        return ColorMap("jet", 64, device=d["depth"].device)(d["depth"])

    def dcn(i):
        return lambda d: deform_conv2d(*d["dcn"][i], padding=1)

    def affine3d(d):
        M = torch.tensor([M34], device=d["volume"].device)
        return warp_affine3d(d["volume"], M, tuple(VOLUME_SHAPE[-3:]))

    ops = {
        "equalize_clahe": (lambda d: E.equalize_clahe(d["batch"], 40.0,
                                                      (8, 8)), 0.0),
        "equalize_clahe_slow": (lambda d: E.equalize_clahe(
            d["batch"], 40.0, (8, 8), True), IMAGE_ATOL),
        "jpeg_q50": (lambda d: jpeg_codec_differentiable(
            d["batch"], torch.tensor(50.0, device=d["batch"].device)),
                     IMAGE_WIDE_ATOL),
        "jpeg_q50_backward": (jpeg_backward, "grad"),
        "resize_aa_540x960": (lambda d: Wp.resize(d["frame"], (540, 960),
                                                  antialias=True),
                              IMAGE_ATOL),
        "resize_aa_256x256": (lambda d: Wp.resize(d["frame"], (256, 256),
                                                  antialias=True),
                              IMAGE_ATOL),
        "resize_nearest_540x960": (lambda d: Wp.resize(
            d["frame"], (540, 960), "nearest"), 0.0),
        "grid_sample_bicubic_reflection": (lambda d: Wp.grid_sample(
            d["frame"], d["grid"], "bicubic", "reflection"), sample_atol(Wf)),
        "elastic_transform2d": (lambda d: Wp.elastic_transform2d(
            d["frame"], d["noise"]), sample_atol(Wf)),
        "get_tps_transform_16": (tps_solve, "solve"),
        # the spline sums 16 terms of opposite sign: its f32 sampling points
        # lie up to tps_f32_px from the exact ones (2.2e-3 px on the CPU at
        # this frame), so the card's may lie twice that from the CPU's
        "warp_image_tps_16": (tps, IMAGE_ATOL + 2.0 * inp["tps_f32_px"]),
        "median_blur_5_frame": (lambda d: Fl.median_blur(d["frame"], 5),
                                0.0),
        "dcn_block3_32_64": (dcn(0), IMAGE_WIDE_ATOL),
        "dcn_block3_64_64": (dcn(1), IMAGE_WIDE_ATOL),
        "dcn_block4_64_128": (dcn(2), IMAGE_WIDE_ATOL),
        "warp_affine3d": (affine3d, sample_atol(VOLUME_SHAPE[-1])),
        "rotate3d": (lambda d: rotate3d(
            d["volume"], torch.tensor([20.0], device=d["volume"].device),
            10.0, -15.0), sample_atol(VOLUME_SHAPE[-1])),
        "dilation_5_nonflat": (lambda d: Mo.dilation(
            d["batch"], torch.ones_like(d["se5"]), d["se5"]), 0.0),
        "erosion_5_nonflat": (lambda d: Mo.erosion(
            d["batch"], torch.ones_like(d["se5"]), d["se5"]), 0.0),
        "build_laplacian_pyramid_4": (lambda d: build_laplacian_pyramid(
            d["batch"], 4), IMAGE_ATOL),
        "apply_colormap_1080p": (cmap, IMAGE_ATOL),
    }
    return ops


def _outputs(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    return [out]


def card_vs_cpu(name: str, card, cpu, tol) -> dict:
    """Largest card-vs-CPU difference of each output against `tol` (a
    number; "hue": channel 0 on the circle, the rest 1e-5; "solve" and
    "grad": of the largest entry, SOLVE_RTOL and GRAD_RTOL), and whether it
    is within it (`ok`)."""
    worst, bitwise = 0.0, True
    for a, b in zip(_outputs(card), _outputs(cpu)):
        a = a.detach().cpu().to(torch.float64)
        b = b.detach().to(torch.float64)
        if a.shape != b.shape:
            fail(f"image_ops (c) {name}: card shape {tuple(a.shape)}, CPU "
                 f"{tuple(b.shape)}")
        bitwise &= bool(torch.equal(a, b))
        d = (a - b).abs()
        if tol == "hue":
            # hue on the circle, held to 1e-4 rad; S and V to 1e-5
            hue = torch.remainder(a[:, 0] - b[:, 0] + math.pi,
                                  2 * math.pi).sub(math.pi).abs()
            d[:, 0] = hue * (IMAGE_ATOL / IMAGE_WIDE_ATOL)
        if tol in ("solve", "grad"):
            d = d / max(float(b.abs().max()), 1e-30)
        worst = max(worst, float(d.max()))
    limit = {"hue": IMAGE_ATOL, "solve": SOLVE_RTOL,
             "grad": GRAD_RTOL}.get(tol, tol)
    return dict(max_diff=worst, bitwise=bitwise, limit=str(limit),
                ok=worst <= limit)


def _on_cpu_inputs(inp: dict, n: int) -> dict:
    """The inputs for the CPU check: the batch's first n images, the rest
    whole."""
    out = {}
    for k, v in inp.items():
        if k == "dcn":
            out[k] = [tuple(t.cpu() for t in ops) for ops in v]
        elif k == "batch":
            out[k] = v[:n].cpu()
        else:
            out[k] = v.cpu() if torch.is_tensor(v) else v
    return out


def image_ops_grads(inp: dict) -> dict:
    """Card against CPU gradients (of Σ w · f(x), w seeded) at 1e-4 of the
    largest: the JPEG codec, bilateral_blur, warp_affine, the antialiased
    resize and deform_conv2d."""
    from kornia_tpu_torch.ops.deform_conv import deform_conv2d
    from kornia_tpu_torch.ops.filters import bilateral_blur
    from kornia_tpu_torch.ops.jpeg import jpeg_codec_differentiable
    from kornia_tpu_torch.ops.warp import resize, warp_affine
    M = torch.tensor([PER_OP_M3[:2]])
    x2 = inp["batch"][:IMAGE_OPS_XCHECK]
    legs = {
        "jpeg_codec_differentiable": (lambda x: jpeg_codec_differentiable(
            x, torch.tensor(50.0, device=x.device)), x2),
        "bilateral_blur": (lambda x: bilateral_blur(x, 5, 0.1, (1.5, 1.5)),
                           x2),
        "warp_affine": (lambda x: warp_affine(
            x, M.to(x.device).expand(x.shape[0], 2, 3), x.shape[-2:]), x2),
        "resize_antialias": (lambda x: resize(x, (540, 960),
                                              antialias=True),
                             inp["frame"]),
        "deform_conv2d": (lambda x: deform_conv2d(
            x, *[t.to(x.device) for t in inp["dcn"][0][1:]], padding=1),
                          inp["dcn"][0][0]),
    }
    out = {}
    for name, (fn, x) in legs.items():
        grads = []
        for dev_x in (x, x.cpu()):
            xr = dev_x.detach().clone().requires_grad_(True)
            y = fn(xr)
            w = torch.rand(y.shape, generator=torch.Generator().manual_seed(
                SEED)).to(y.device)
            (g,) = torch.autograd.grad((y * w).sum(), xr)
            grads.append(g)
        rel = float((grads[0].cpu() - grads[1]).abs().max()) / max(
            float(grads[1].abs().max()), 1e-30)
        out[name] = dict(max_diff=rel, ok=rel <= GRAD_RTOL,
                         limit=str(GRAD_RTOL))
        print(f"image_ops (c) gradient of {name}: card vs CPU {rel:.3e} of "
              f"the largest (within its limit: {out[name]['ok']})")
    return out


def image_ops_phase(K, dev) -> dict:
    """Step 14: the image-op layer (see the module's docstring)."""
    from kornia_tpu_torch.ops import filters as Fl
    t_phase = time.perf_counter()
    inp = image_ops_inputs(dev)
    sweep = per_op_sweep(dev)
    rest = image_ops_rest(inp)
    x = inp["batch"]
    B, C, H, W = x.shape
    # (a) the per-op sweep
    rows = {}
    for name, (fn, _) in sweep.items():
        fn(x)
        torch.cuda.synchronize()
        Fl.canny_counts.clear()
        host_ms, _ = median_ms(lambda: fn(x), 3)
        canny = dict(Fl.canny_counts)
        dt = host_ms / 1e3
        rows[name] = dict(
            device_ms=device_ms(lambda: fn(x), IMAGE_OPS_REPS, 2),
            host_ms=host_ms, img_per_s=B / dt,
            gb_per_s=B * C * H * W * 4 * 2 / dt / 1e9,
            peak_bytes=peak_bytes(lambda: fn(x)))
        if name == "canny":
            rows[name]["hysteresis"] = {k: v / canny["calls"]
                                        for k, v in canny.items()}
        print(f"image_ops (a) {name:24s} device {rows[name]['device_ms']:8.4f}"
              f" ms  host {host_ms:8.4f} ms  {rows[name]['img_per_s']:10.0f} "
              f"img/s  {rows[name]['gb_per_s']:7.1f} GB/s  peak "
              f"{rows[name]['peak_bytes'] / 2**20:8.1f} MiB")
    geomean = math.exp(statistics.mean(math.log(r["img_per_s"])
                                       for r in rows.values()))
    dev_geomean = math.exp(statistics.mean(
        math.log(B / (r["device_ms"] / 1e3)) for r in rows.values()))

    def sweep_once():
        for fn, _ in sweep.values():
            fn(x)

    wall_ms = synced_s(sweep_once) * 1e3
    busy, n_k, _ = device_profile(sweep_once)
    print(f"image_ops (a) per_op_geomean_throughput {geomean:.1f} img/s "
          f"(host clock; device clock {dev_geomean:.1f}) over {len(rows)} "
          f"ops; the sweep: {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"(busy share {busy / wall_ms:.4f}), {n_k} kernels; canny "
          f"hysteresis per call {rows['canny']['hysteresis']}")
    # (b) the rest of the slice
    extra = {}
    for name, (fn, _) in rest.items():
        fn(inp)
        torch.cuda.synchronize()
        host_ms, _ = median_ms(lambda: fn(inp), 3)
        extra[name] = dict(device_ms=device_ms(lambda: fn(inp), 5, 1),
                           host_ms=host_ms,
                           peak_bytes=peak_bytes(lambda: fn(inp)))
        print(f"image_ops (b) {name:32s} device "
              f"{extra[name]['device_ms']:9.4f} ms  host {host_ms:9.4f} ms"
              f"  peak {extra[name]['peak_bytes'] / 2**20:9.1f} MiB")
    # (c) card against the CPU port
    cpu = _on_cpu_inputs(inp, IMAGE_OPS_XCHECK)
    xcheck = {}
    for name, (fn, tol) in sweep.items():
        xcheck[name] = card_vs_cpu(name, fn(x[:IMAGE_OPS_XCHECK]),
                                   fn(cpu["batch"]), tol)
    from kornia_tpu_torch.ops.color import rgb_to_grayscale
    edges = [Fl.canny(rgb_to_grayscale(t))[1] for t in
             (x[:IMAGE_OPS_XCHECK], cpu["batch"])]
    xcheck["canny_edges"] = card_vs_cpu("canny edges", *edges, 0.0)
    sub = dict(inp, batch=x[:IMAGE_OPS_XCHECK])
    for name, (fn, tol) in rest.items():
        xcheck[name] = card_vs_cpu(name, fn(sub), fn(cpu), tol)
    for name, r in xcheck.items():
        print(f"image_ops (c) {name}: card vs CPU max diff "
              f"{r['max_diff']:.3e} (limit {r['limit']}, bitwise "
              f"{r['bitwise']}){'' if r['ok'] else '  FAILS'}")
    grads = image_ops_grads(inp)
    bad = [n for n, r in list(xcheck.items()) + list(grads.items())
           if not r["ok"]]
    if bad:
        fail(f"image_ops (c): card and CPU disagree beyond the limits on "
             f"{bad}")

    # (d) every fused blur of (a) and (b), against its plain version
    def path():
        sweep_once()
        for fn, _ in rest.values():
            fn(inp)

    names = ("fused_separable_blur2d", "fused_separable_blur2d_adjoint")
    launches = counted_run(K, path, "image_ops (a)+(b)", names)
    _, _, kern = device_profile(path, names)
    calls = capture_launches(K, path, names)
    per_path = path_kernel_times(K, kern, calls, launches, "image_ops")
    checks = check_captured(K, calls, "image_ops")
    results, counts = path_entries(K, calls, checks, launches, "image_ops")
    report(results)
    out = dict(per_op=rows, per_op_geomean_throughput=geomean,
               device_geomean_img_per_s=dev_geomean, sweep_ms=wall_ms,
               sweep_busy_ms=busy, sweep_busy_share=busy / wall_ms,
               sweep_kernels=n_k, rest=extra, xcheck=xcheck, grads=grads,
               launches=launches, per_path=per_path, checks=checks,
               image_ops_seconds=time.perf_counter() - t_phase)
    print(f"image_ops phase: {out['image_ops_seconds']:.1f} s")
    print(json.dumps({"image_ops": out}))
    return dict(kernels=results, counts=counts, **out)


REG_ITERS, REG_LR, REG_LEVELS = 300, 1e-2, 3  # tests/test_registration_vo.py:22-23
REG_ERR_FRACTION = 0.35  # final photometric error / initial, ibid. :29
REG_XCHECK_ITERS = 5     # coarsest-level Adam steps also run on the CPU port
REG_PROFILE_ITERS = 10   # Adam steps a level in the profiled runs
REG_PARAM_ATOL = 1e-4    # card vs CPU parameters (tests/test_torch_registration.py)
MSSSIM_STEPS = 5
METRIC_RTOL = 1e-5       # card vs CPU, non-integer metrics, of the largest
KMEANS_ATOL = 1e-4       # k-means centres, card vs CPU (the CPU tests' limit)
KMEANS_TIE_RTOL = 1e-5   # pixels whose two nearest centres lie this close
DT_XCHECK_HW = (270, 480)  # the distance transform's card-vs-CPU frame
# step 15's band adjoints: MS-SSIM's backward at its five scales, 24 planes
# (8 x 3); a block per 32 x 64 tile fills the card (132 SMs) at least once
# down to 120x160 (2.2 blocks per SM), not at 60x80 (0.7) and 30x40 (0.2)
# (kornia_tpu_torch/ops/kernels.py::_ADJOINT_TILED_FILL)
for _hw, _route in [((480, 640), "tiled"), ((240, 320), "tiled"),
                    ((120, 160), "tiled"), ((60, 80), "passes"),
                    ((30, 40), "passes")]:
    ROUTES[("fused_separable_blur2d_adjoint", *_hw)] = _route


def registration_inputs(dev):
    """A 480x640 frame of step 9's room (grey, repeated into RGB) and the
    same frame warped by a 5° rotation about its centre and a 2 px shift
    (tests/test_registration_vo.py:16-20)."""
    from kornia_tpu_torch.geometry.conversions import \
        convert_affinematrix_to_homography
    from kornia_tpu_torch.ops.color import grayscale_to_rgb
    from kornia_tpu_torch.ops.warp import (get_rotation_matrix2d,
                                           warp_perspective)
    from kornia_tpu_torch.utils.render import render_scene, walk_trajectory
    Kt, scene = vo_setup(dev)
    T = walk_trajectory(2)[0]
    src = grayscale_to_rgb(render_scene(scene, Kt, T, H, W)[0])
    M = convert_affinematrix_to_homography(get_rotation_matrix2d(
        torch.tensor([[(W - 1) / 2.0, (H - 1) / 2.0]], device=dev),
        torch.tensor([5.0], device=dev), torch.ones((1, 2), device=dev)))
    M[:, 0, 2] += 2.0
    return src, warp_perspective(src, M, (H, W)), M


def photometric_error(src, dst, M) -> float:
    """The JAX test's criterion: mean |warp(src, M) - dst| over the pixels
    the warp fills (tests/test_registration_vo.py:26-28)."""
    from kornia_tpu_torch.ops.warp import warp_perspective
    warped = warp_perspective(src, M, (H, W))
    mask = warp_perspective(torch.ones_like(src), M, (H, W)) > 0.99
    return float((warped - dst).abs().mul(mask).sum() / mask.sum())


def registration_run(K, dev, src, dst) -> dict:
    """(a): the registration, timed and profiled level by level, and the
    coarsest level's first steps against the CPU port."""
    from kornia_tpu_torch.geometry.registration import ImageRegistrator
    from kornia_tpu_torch.ops.pyramid import build_pyramid
    from kornia_tpu_torch.ops.warp import homography_warp
    reg = ImageRegistrator("homography", REG_ITERS, REG_LR, REG_LEVELS)
    M_est = reg.register(src, dst)  # warm-up
    reg_ms, runs = median_ms(lambda: reg.register(src, dst), 3)
    M_est = reg.register(src, dst)
    err0 = float((src - dst).abs().mean())
    err = photometric_error(src, dst, M_est)
    print(f"registration_eval (a) photometric error {err:.5f} from "
          f"{err0:.5f} ({err / err0:.4f} of it, limit {REG_ERR_FRACTION}); "
          f"a registration {reg_ms:.2f} ms (synchronised, runs "
          f"{[round(r, 2) for r in runs]})")
    if not err < REG_ERR_FRACTION * err0:
        fail(f"registration_eval (a): photometric error {err} not below "
             f"{REG_ERR_FRACTION} x {err0}")
    pyr_s = build_pyramid(src, REG_LEVELS)
    pyr_d = build_pyramid(dst, REG_LEVELS)
    levels = {}
    p0 = reg.model.init_params(dev)
    for lvl in range(REG_LEVELS - 1, -1, -1):
        s, d = pyr_s[lvl], pyr_d[lvl]
        # a step makes no host read (every synchronising call raises), so
        # the level can replay it as one CUDA graph
        no_host_sync(lambda: reg.run_level(p0, s, d, num_iterations=3,
                                           cuda_graph=False))
        eager = synced_s(lambda: reg.run_level(
            p0, s, d, num_iterations=REG_PROFILE_ITERS,
            cuda_graph=False)) * 1e3 / REG_PROFILE_ITERS
        ms = median_ms(lambda: reg.run_level(p0, s, d), 3)[0] / REG_ITERS
        busy, n_k, _ = device_profile(lambda: reg.run_level(
            p0, s, d, num_iterations=REG_PROFILE_ITERS, cuda_graph=False))
        busy, n_k = busy / REG_PROFILE_ITERS, n_k / REG_PROFILE_ITERS
        hw = f"{s.shape[-2]}x{s.shape[-1]}"
        levels[hw] = dict(ms_per_iteration=ms, eager_ms_per_iteration=eager,
                          kernels_per_iteration=n_k,
                          busy_ms_per_iteration=busy, busy_share=busy / ms)
        print(f"registration_eval (a) level {lvl} ({hw}): {ms:.4f} ms an "
              f"Adam iteration (CUDA graph, median of 3 synchronised "
              f"levels of {REG_ITERS}; launched step by step {eager:.4f} "
              f"ms), {n_k:.1f} kernels and {busy:.4f} ms busy a step (busy "
              f"share {busy / ms:.4f} of the graph's iteration)")
    # the device's share of a registration: its steps' busy time (each
    # level's profiled step, REG_ITERS times) over the synchronised time
    busy = sum(v["busy_ms_per_iteration"] for v in levels.values()) \
        * REG_ITERS
    peak = peak_bytes(lambda: reg.register(src, dst))
    print(f"registration_eval (a) a registration: {busy:.2f} ms of its "
          f"steps' device time in {reg_ms:.2f} ms (busy share "
          f"{busy / reg_ms:.4f}), peak {peak / 2**20:.1f} MiB")
    # the coarsest level's first steps on the card and on the CPU port
    lvl = REG_LEVELS - 1
    pc_s = build_pyramid(src.cpu(), REG_LEVELS)[lvl]
    pc_d = build_pyramid(dst.cpu(), REG_LEVELS)[lvl]
    card, _ = reg.run_level(p0, pyr_s[lvl], pyr_d[lvl],
                            num_iterations=REG_XCHECK_ITERS)
    cpu, _ = reg.run_level(p0.cpu(), pc_s, pc_d,
                           num_iterations=REG_XCHECK_ITERS)
    diff = float((card.cpu() - cpu).abs().max())
    hw = tuple(pc_d.shape[-2:])
    masks = [homography_warp(torch.ones_like(x), reg.model.matrix(p)[None],
                             hw) > 0.999
             for x, p in ((pyr_s[lvl], card), (pc_s, cpu))]
    mask_diff = int((masks[0].cpu() != masks[1]).sum())
    print(f"registration_eval (a) coarsest level, {REG_XCHECK_ITERS} Adam "
          f"steps: card vs CPU parameters max abs diff {diff:.3e} (limit "
          f"{REG_PARAM_ATOL}); {mask_diff} of {masks[1].numel()} mask "
          f"pixels differ")
    if not diff <= REG_PARAM_ATOL:
        fail(f"registration_eval (a): card and CPU parameters differ by "
             f"{diff}")
    return dict(ms=reg_ms, runs_ms=runs, error=err, error0=err0,
                levels=levels, busy_ms=busy, busy_share=busy / reg_ms,
                peak_bytes=peak,
                xcheck_param_diff=diff, xcheck_mask_pixels=mask_diff,
                M=M_est.cpu().tolist())


def msssim_train(dev) -> dict:
    """(b): five Adam steps on ms_ssim_loss at (8, 3, 480, 640), and the
    card's gradient against the CPU's."""
    from kornia_tpu_torch.losses.losses import ms_ssim_loss
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    target = torch.rand(TRAIN_SHAPE, device=dev, generator=gen)
    init = (target + 0.1 * torch.randn(TRAIN_SHAPE, device=dev,
                                       generator=gen)).clamp(0, 1)
    pred = init.clone().requires_grad_()
    opt = torch.optim.Adam([pred], lr=1e-2)
    losses, step_ms = [], []
    for _ in range(MSSSIM_STEPS):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = ms_ssim_loss(pred, target)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    print(f"registration_eval (b) MS-SSIM loss per step {losses}, ms per "
          f"step (synchronised) {[round(v, 3) for v in step_ms]}")
    if any(b > a for a, b in zip(losses, losses[1:])):
        fail(f"registration_eval (b): MS-SSIM loss increased: {losses}")
    # the card's gradient against the CPU's: the first two images
    pc = init[:2].clone().requires_grad_()
    g_card = torch.autograd.grad(ms_ssim_loss(pc, target[:2]), pc)[0]
    pc = init[:2].cpu().requires_grad_()
    g_cpu = torch.autograd.grad(ms_ssim_loss(pc, target[:2].cpu()), pc)[0]
    diff = grad_diff(g_card, g_cpu, "registration_eval (b) MS-SSIM")
    return dict(losses=losses, step_ms=statistics.median(step_ms),
                step_ms_runs=step_ms, grad_diff=diff)


def eval_metrics(dev) -> dict:
    """(c): the metrics at dataset sizes, card against the CPU port."""
    from kornia_tpu_torch.metrics import metrics as Mt
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    out = {}

    def check(name, card_fn, cpu_fn, exact):
        card = card_fn()
        torch.cuda.synchronize()
        ms, _ = median_ms(card_fn, 3)
        cpu = cpu_fn()
        outs = list(zip(_outputs(card), _outputs(cpu)))
        if exact:
            ok = all(torch.equal(a.cpu(), b) for a, b in outs)
            d = max(float((a.cpu().double() - b.double()).abs().max())
                    for a, b in outs)
        else:
            d = max(float((a.cpu().double() - b.double()).abs().max())
                    / max(float(b.abs().max()), 1e-30) for a, b in outs)
            ok = d <= METRIC_RTOL
        out[name] = dict(ms=ms, diff=d, bitwise=exact, ok=ok)
        print(f"registration_eval (c) {name}: {ms:.3f} ms, card vs CPU "
              f"{'bit for bit' if exact else 'relative'} diff {d:.3e}"
              f"{'' if ok else '  FAILS'}")

    # Cityscapes: 19 classes on (4, 1024, 2048); a prediction agreeing with
    # the truth on about 80% of the pixels
    true = torch.randint(0, 19, (4, 1024, 2048), device=dev, generator=gen)
    pred = torch.where(torch.rand(true.shape, device=dev, generator=gen)
                       < 0.8, true, torch.randint(0, 19, true.shape,
                                                  device=dev, generator=gen))
    tc, pcpu = true.cpu(), pred.cpu()
    check("confusion_matrix", lambda: Mt.confusion_matrix(pred, true, 19),
          lambda: Mt.confusion_matrix(pcpu, tc, 19), True)
    check("mean_iou", lambda: Mt.mean_iou(pred, true, 19),
          lambda: Mt.mean_iou(pcpu, tc, 19), True)
    # MPI-Sintel: (4, 2, 436, 1024) flows, the endpoint over the 2 channels
    flow_gt = 5 * torch.randn((4, 2, 436, 1024), device=dev, generator=gen)
    flow = flow_gt + torch.randn(flow_gt.shape, device=dev, generator=gen)
    fa, fb = flow.movedim(1, -1), flow_gt.movedim(1, -1)
    check("aepe", lambda: Mt.aepe(fa, fb),
          lambda: Mt.aepe(fa.cpu(), fb.cpu()), False)
    # KITTI 2015: (4, 375, 1242) disparities, about a third valid
    d_gt = 100 * torch.rand((4, 375, 1242), device=dev, generator=gen)
    d_est = d_gt + 4 * torch.randn(d_gt.shape, device=dev, generator=gen)
    valid = (torch.rand(d_gt.shape, device=dev, generator=gen)
             < 0.35).float()
    for name in ("mean_absolute_disparity_error",
                 "root_mean_squared_disparity_error",
                 "mean_bad_pixel_error"):
        fn = getattr(Mt, name)
        check(name, lambda fn=fn: fn(d_est, d_gt, valid_mask=valid),
              lambda fn=fn: fn(d_est.cpu(), d_gt.cpu(),
                               valid_mask=valid.cpu()), False)
    # detection: 100 predictions against 20 boxes in 80 classes
    xy = 600 * torch.rand((20, 2), device=dev, generator=gen)
    gt_boxes = torch.cat([xy, xy + 20 + 100 * torch.rand(
        (20, 2), device=dev, generator=gen)], -1)
    gt_labels = torch.randint(0, 80, (20,), device=dev, generator=gen)
    pick = torch.randint(0, 20, (100,), device=dev, generator=gen)
    boxes = gt_boxes[pick] + 8 * torch.randn((100, 4), device=dev,
                                             generator=gen)
    labels = torch.where(torch.rand(100, device=dev, generator=gen) < 0.8,
                         gt_labels[pick], torch.randint(
                             0, 80, (100,), device=dev, generator=gen))
    scores = torch.rand(100, device=dev, generator=gen)
    args = (boxes, labels, scores, gt_boxes, gt_labels, 80)
    check("mean_average_precision",
          lambda: Mt.mean_average_precision(*args)[0],
          lambda: Mt.mean_average_precision(
              *[a.cpu() if torch.is_tensor(a) else a for a in args])[0],
          False)
    bad = [n for n, r in out.items() if not r["ok"]]
    if bad:
        fail(f"registration_eval (c): card and CPU disagree on {bad}")
    return out


def contrib_ops(dev, frame) -> dict:
    """(d): the contrib operators and the 3-D refinement at frame sizes,
    card against the CPU port."""
    from kornia_tpu_torch.contrib.ops import (KMeans, connected_components,
                                              distance_transform)
    from kornia_tpu_torch.geometry.subpix import (conv_quad_interp3d,
                                                  nms3d_minmax)
    from kornia_tpu_torch.losses.losses import hausdorff_distance_loss
    from kornia_tpu_torch.ops.filters import gaussian_blur2d
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    out = {}

    def record(name, card_fn, cpu_fn, tol, note="", rel=False):
        """`tol` absolute, or with `rel` of the CPU result's largest
        entry (the CPU tests' relative limits)."""
        card = card_fn()
        torch.cuda.synchronize()
        ms = synced_s(card_fn) * 1e3
        t0 = time.perf_counter()
        cpu = cpu_fn()
        cpu_s = time.perf_counter() - t0
        if rel:
            tol = tol * max(float(t.abs().max()) for t in _outputs(cpu))
        r = card_vs_cpu(name, card, cpu, tol)
        out[name] = dict(ms=ms, cpu_s=cpu_s, **r)
        print(f"registration_eval (d) {name}: {ms:.2f} ms (synchronised; "
              f"the CPU port {cpu_s:.2f} s), card vs CPU max diff "
              f"{r['max_diff']:.3e} (limit "
              f"{r['limit']}, bitwise {r['bitwise']}){note}"
              f"{'' if r['ok'] else '  FAILS'}")

    fh, fw = FRAME_HW
    # seeds of the distance transform: 32 random pixels
    seeds = torch.zeros((1, 1, fh, fw), device=dev)
    idx = torch.randint(0, fh * fw, (32,), device=dev, generator=gen)
    seeds.view(-1)[idx] = 1.0
    # its 1,920 steps make no host read
    dt = no_host_sync(lambda: distance_transform(seeds))
    ms = synced_s(lambda: distance_transform(seeds)) * 1e3
    _, n_k, _ = device_profile(lambda: distance_transform(seeds))
    if not (bool(torch.isfinite(dt).all()) and float(dt.view(-1)[idx].abs()
                                                      .max()) == 0.0):
        fail(f"registration_eval (d): distance_transform at {fh}x{fw} is "
             f"not finite, or not zero at its seeds")
    print(f"registration_eval (d) distance_transform {fh}x{fw} "
          f"({fw} steps): {ms:.2f} ms (synchronised), {n_k} kernels, max "
          f"distance {float(dt.max()):.2f} px")
    small = seeds[..., :DT_XCHECK_HW[0], :DT_XCHECK_HW[1]].clone()
    sh, sw = DT_XCHECK_HW
    small[..., sh // 8, sw // 16] = small[..., 3 * sh // 4, 5 * sw // 6] = 1.0
    record("distance_transform", lambda: distance_transform(small),
           lambda: distance_transform(small.cpu()), 1e-5,
           f" (the CPU check at {DT_XCHECK_HW[0]}x{DT_XCHECK_HW[1]}, "
           f"{DT_XCHECK_HW[1]} steps)", rel=True)
    out["distance_transform_1080p"] = dict(ms=ms, kernels=n_k)
    blobs = (gaussian_blur2d(torch.rand((1, 1, fh, fw), device=dev,
                                        generator=gen), 9, 3.0) > 0.5
             ).float()
    record("connected_components",
           lambda: connected_components(blobs, 100),
           lambda: connected_components(blobs.cpu(), 100), 0.0)
    logits = 3 * torch.randn((1, 4, 256, 256), device=dev, generator=gen)
    labels = torch.randint(0, 4, (1, 1, 256, 256), device=dev,
                           generator=gen).float()
    labels = (gaussian_blur2d(labels, 15, 5.0)[:, 0] * 4 / 3).long().clamp(
        0, 3)
    record("hausdorff_distance_loss",
           lambda: hausdorff_distance_loss(logits, labels),
           lambda: hausdorff_distance_loss(logits.cpu(), labels.cpu()),
           1e-5, rel=True)
    px = frame[0].reshape(3, -1).T.contiguous()
    px = px + 0.05 * torch.rand(px.shape, device=dev, generator=gen)
    draw = torch.randperm(px.shape[0], device=dev, generator=gen)[:8]
    km, kc = KMeans(8), KMeans(8)
    record("KMeans(8)", lambda: km.fit(px, draws=draw) or km.cluster_centers,
           lambda: kc.fit(px.cpu(), draws=draw.cpu()) or kc.cluster_centers,
           KMEANS_ATOL)
    # assignments: equal wherever the two nearest centres are not tied
    d2 = ((px[:, None] - km.cluster_centers[None]) ** 2).sum(-1)
    two = d2.topk(2, largest=False).values
    clear = (two[:, 1] - two[:, 0] > KMEANS_TIE_RTOL * two[:, 1]).cpu()
    a_card = km.predict(px).cpu()
    a_cpu = kc.predict(px.cpu())
    differ = int((a_card != a_cpu).sum())
    differ_clear = int(((a_card != a_cpu) & clear).sum())
    print(f"registration_eval (d) KMeans(8) on {px.shape[0]} pixels: "
          f"{differ} assignments differ, {differ_clear} of them not near "
          f"ties")
    if differ_clear:
        fail(f"registration_eval (d): {differ_clear} k-means assignments "
             f"differ between card and CPU away from ties")
    out["KMeans(8)"].update(assign_differ=differ, near_ties=int(
        (~clear).sum()))
    # a DoG stack of the frame: six Gaussians, five differences
    grey = frame[:, :1]
    g = [gaussian_blur2d(grey, 2 * math.ceil(3 * s) + 1, s)
         for s in (1.6 * 2 ** (i / 3) for i in range(6))]
    dog = torch.stack([b - a for a, b in zip(g, g[1:])], dim=2)
    # coordinates up to 640 px: 1e-5 of the largest
    record("conv_quad_interp3d", lambda: conv_quad_interp3d(dog),
           lambda: conv_quad_interp3d(dog.cpu()), 1e-5, rel=True)
    record("nms3d_minmax", lambda: nms3d_minmax(dog),
           lambda: nms3d_minmax(dog.cpu()), 0.0)
    bad = [n for n, r in out.items() if "ok" in r and not r["ok"]]
    if bad:
        fail(f"registration_eval (d): card and CPU disagree on {bad}")
    return out


def registration_eval_phase(K, dev) -> dict:
    """Step 15: registration, MS-SSIM training, evaluation and contrib ops
    (see the module's docstring)."""
    from kornia_tpu_torch.geometry.registration import ImageRegistrator
    from kornia_tpu_torch.losses.losses import ms_ssim_loss
    t_phase = time.perf_counter()
    parts = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = round(time.perf_counter() - t0, 1)
        return out

    src, dst, _ = part("inputs", registration_inputs, dev)
    reg = part("registration", registration_run, K, dev, src, dst)
    train = part("msssim", msssim_train, dev)
    metrics = part("metrics", eval_metrics, dev)
    contrib = part("contrib", contrib_ops, dev, src)
    t_path = time.perf_counter()
    # the path: one registration and one MS-SSIM training step; every fused
    # blur (the pyramid's pyrdowns, MS-SSIM's five scales) and band adjoint
    # (MS-SSIM's backward) captured and held to its plain version
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    target = torch.rand(TRAIN_SHAPE, device=dev, generator=gen)
    pred = (target + 0.1 * torch.randn(TRAIN_SHAPE, device=dev,
                                       generator=gen)).requires_grad_()
    def path(iters=REG_ITERS):
        ImageRegistrator("homography", iters, REG_LR,
                         REG_LEVELS).register(src, dst)
        ms_ssim_loss(pred, target).backward()

    names = ("fused_separable_blur2d", "fused_separable_blur2d_adjoint")
    launches = counted_run(K, path, "registration_eval", names)
    # profiled and captured with REG_PROFILE_ITERS Adam steps a level: the
    # same launches of both kernels (the pyramid's and MS-SSIM's; the Adam
    # loop launches neither), at a twentieth of the profiler's events
    short = lambda: path(REG_PROFILE_ITERS)  # noqa: E731
    _, _, kern = device_profile(short, names)
    calls = capture_launches(K, short, names)
    per_path = path_kernel_times(K, kern, calls, launches,
                                 "registration_eval")
    checks = check_captured(K, calls, "registration_eval")
    scales = sorted({tuple(a[0].shape[-2:]) for a, _ in
                     calls["fused_separable_blur2d_adjoint"]})
    if len(scales) != 5 or scales[-1] != (H, W):
        fail(f"registration_eval: the band adjoint ran at {scales}, not at "
             f"MS-SSIM's five scales")
    results, counts = path_entries(K, calls, checks, launches,
                                   "registration_eval")
    report(results)
    parts["path"] = round(time.perf_counter() - t_path, 1)
    out = dict(registration=reg, msssim=train, metrics=metrics,
               contrib=contrib, launches=launches, per_path=per_path,
               checks=checks, parts=parts,
               seconds=time.perf_counter() - t_phase)
    print(f"registration_eval phase: {out['seconds']:.1f} s, parts {parts}")
    print(json.dumps({"registration_eval": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 16: the augmentation layer ------------------------------------------

AUG_REPS = 5                      # host-clock calls a pipeline, median
SIMCLR_SHAPE = (256, 3, 256, 256)  # kornia's SimCLR recipe at 256 px
SIMCLR_CROP = 224
DET_SHAPE, DET_BOXES, DET_KP = (16, 3, 512, 512), 20, 50
AUTO_SHAPE = (64, 3, 224, 224)
CLIP_SHAPE = (8, 3, 16, 112, 112)  # (B, C, T, H, W): the Kinetics clip
PATCH_SHAPE = (32, 3, 224, 224)
VOL_SHAPE = (4, 1, 64, 128, 128)
VOL_CROP = (48, 112, 112)
GAN_SHAPE = (64, 3, 256, 256)
MIX_SHAPE = (64, 3, 224, 224)
DISSOLVE_SHAPE = (4, 3, 256, 256)
AUG_XCHECK = (8, 3, 64, 64)        # every class, card against the CPU port
AUG_XCHECK_VOL = (2, 1, 16, 32, 32)
# the chains end to end, card vs CPU: the SimCLR view at its last op's
# limit times the jitter's largest gain (a contrast or saturation factor
# of 1 + 0.8); (f)'s gradient relative to the largest, where JPEG's
# rounding turns the warp's ulps into gradient differences (2.069e-4 in
# five runs on an H100; the ops one by one hold GRAD_RTOL)
AUG_CHAIN_GAIN = 1.8
AUG_CHAIN_GRAD_RTOL = 1e-3
AUG_KP_PX = 1e-2                   # the inverse maps keypoints back, px
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# step 16's fused blurs: (b)'s 5x5 box blur on 48 planes, the elastic
# noise's 63-tap smoothing on 32 (forward and mask path) and JPEG's chroma
# blur on 16 of 512x512; (d)'s 3x3 box blur on 384 frames' planes of
# 112x112; (f)'s box and chroma blurs on 192 and 64 planes of 256x256 (in
# ROUTES) and their band adjoints there. Each grid fills the card two
# blocks per SM or more: tiled
for _hw in [(512, 512), (112, 112)]:
    ROUTES[("fused_separable_blur2d", *_hw)] = "tiled"


def simclr_pipeline(A, size: int = 0):
    """kornia's SimCLR view: resized crop (to SIMCLR_CROP unless `size`),
    flip, colour jitter, grey, blur, solarize, ImageNet normalisation."""
    size = size or SIMCLR_CROP
    return A.ImageSequential(
        A.RandomResizedCrop((size, size), scale=(0.08, 1.0)),
        A.RandomHorizontalFlip(),
        A.ColorJiggle(0.8, 0.8, 0.8, 0.2, p=0.8),
        A.RandomGrayscale(p=0.2),
        A.RandomGaussianBlur((23, 23), (0.1, 2.0), p=0.5),
        A.RandomSolarize(p=0.2),
        A.Normalize(list(IMAGENET_MEAN), list(IMAGENET_STD)))


DET_KEYS = ["input", "mask", "bbox_xyxy", "keypoints"]


def detection_pipeline(A, elastic: bool = True):
    """The detection and segmentation recipe: flip, affine, perspective,
    elastic, box blur, JPEG; every data key."""
    ops = [A.RandomHorizontalFlip(),
           A.RandomAffine(15.0, (0.1, 0.1), (0.8, 1.2), 5.0),
           A.RandomPerspective(0.3)]
    if elastic:
        ops.append(A.RandomElasticTransform(p=0.5))
    ops += [A.RandomBoxBlur((5, 5)), A.RandomJPEG((50.0, 90.0))]
    return A.AugmentationSequential(*ops, data_keys=DET_KEYS)


def detection_inputs(dev, shape=None, gen_seed=SEED + 16):
    """Images (DET_SHAPE unless `shape`), a 5-class label mask in 32 px
    blocks, DET_BOXES xyxy boxes and DET_KP keypoints an image, seeded."""
    shape = shape or DET_SHAPE
    B, _, Hd, Wd = shape
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    img = torch.rand(shape, device=dev, generator=g)
    blocks = torch.randint(0, 5, (B, 1, Hd // 32, Wd // 32), device=dev,
                           generator=g).float()
    mask = blocks.repeat_interleave(32, -2).repeat_interleave(32, -1)
    c = torch.rand((B, DET_BOXES, 2), device=dev, generator=g) * 0.6 + 0.2
    wh = torch.rand((B, DET_BOXES, 2), device=dev, generator=g) * 0.25 + 0.02
    size = torch.tensor([Wd, Hd], device=dev, dtype=torch.float32)
    boxes = torch.cat([(c - wh / 2) * size, (c + wh / 2) * size], -1)
    kp = torch.rand((B, DET_KP, 2), device=dev, generator=g) * (size - 1)
    return img, mask, boxes, kp


def _timed(what: str, fn, n_img: int, expect=()) -> dict:
    """One pipeline's figures: host ms (median of AUG_REPS synchronised
    calls), items a second, device busy ms, kernels and busy share of a
    call, peak memory above what was allocated before it."""
    fn()
    torch.cuda.synchronize()
    ms, runs = median_ms(fn, AUG_REPS)
    busy, n_k, _ = device_profile(fn, expect)
    peak = peak_bytes(fn)
    out = dict(ms=ms, runs_ms=runs, per_s=n_img / (ms / 1e3),
               busy_ms=busy, kernels=n_k, busy_share=busy / ms,
               peak_bytes=peak)
    print(f"augmentation {what}: {ms:.2f} ms ({n_img / (ms / 1e3):.1f} a "
          f"second), device busy {busy:.2f} ms (share {busy / ms:.3f}), "
          f"{n_k} kernels, peak {peak / 2**20:.1f} MiB")
    return out


def aug_simclr(dev) -> dict:
    """(a) two SimCLR views of a 256-image batch, drawn from a device
    generator; the whole forward, sampling included, under no_host_sync
    (after the warm-up call, which fills the per-device constant
    tables)."""
    import kornia_tpu_torch.augmentation as TA
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(SIMCLR_SHAPE, device=dev, generator=g)
    pipe = simclr_pipeline(TA)

    def two_views():
        return pipe(x, g), pipe(x, g)

    out = _timed("(a) SimCLR two views", two_views, 2 * SIMCLR_SHAPE[0])
    v1, v2 = no_host_sync(two_views)
    if v1.shape != (SIMCLR_SHAPE[0], 3, SIMCLR_CROP, SIMCLR_CROP) or \
            not bool(torch.isfinite(v1).all() & torch.isfinite(v2).all()):
        fail("augmentation (a): views of the wrong shape or not finite")
    if torch.equal(v1, v2):
        fail("augmentation (a): the two views are equal")
    out["no_host_sync"] = True
    return out


def aug_detection(dev) -> dict:
    """(b) the detection and segmentation batch through every data key,
    then its inverse; the forward under no_host_sync; the inverse of the
    matrix-only pipeline maps the keypoints back within AUG_KP_PX."""
    import kornia_tpu_torch.augmentation as TA
    inp = detection_inputs(dev)
    pipe = detection_pipeline(TA)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def forward():
        return pipe(*inp, generator=g)

    def both():
        return pipe.inverse(*forward())

    out = _timed("(b) detection forward", forward, DET_SHAPE[0])
    out["with_inverse"] = _timed("(b) detection forward + inverse", both,
                                 DET_SHAPE[0])
    img, mask, boxes, kp = no_host_sync(forward)
    if img.shape != inp[0].shape or mask.shape != inp[1].shape or \
            not bool(torch.isfinite(img).all() & torch.isfinite(boxes).all()):
        fail("augmentation (b): outputs of the wrong shape or not finite")
    # the inverse: elastic moves no point, so the whole pipeline's inverse
    # maps keypoints back; the matrix-only pipeline's too
    back = pipe.inverse(img, mask, boxes, kp)[3]
    err = (back - inp[3]).abs().max().item()
    matrix = detection_pipeline(TA, elastic=False)
    k2 = matrix(inp[0], inp[3], data_keys=["input", "keypoints"],
                generator=g)[1]
    err2 = (matrix.inverse(k2, data_keys=["keypoints"]) - inp[3]).abs()
    out["keypoint_roundtrip_px"] = max(err, err2.max().item())
    out["no_host_sync"] = True
    print(f"augmentation (b): keypoints back within "
          f"{out['keypoint_roundtrip_px']:.2e} px")
    if not out["keypoint_roundtrip_px"] <= AUG_KP_PX:
        fail(f"augmentation (b): the inverse maps keypoints back to "
             f"{out['keypoint_roundtrip_px']} px, over {AUG_KP_PX}")
    return out


def aug_auto(dev) -> dict:
    """(c) RandAugment(2, 10), TrivialAugment and AutoAugment (imagenet,
    cifar10) at 64 x 3 x 224 x 224."""
    import kornia_tpu_torch.augmentation as TA
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.rand(AUTO_SHAPE, device=dev, generator=g)
    pols = {"rand_augment": TA.RandAugment(2, 10),
            "trivial_augment": TA.TrivialAugment(),
            "auto_augment_imagenet": TA.AutoAugment("imagenet"),
            "auto_augment_cifar10": TA.AutoAugment("cifar10")}
    out = {}
    for name, pol in pols.items():
        out[name] = _timed(f"(c) {name}", lambda: pol(x, g), AUTO_SHAPE[0])
        if not bool(torch.isfinite(pol(x, g)).all()):
            fail(f"augmentation (c): {name} not finite")
    return out


def aug_video(dev) -> dict:
    """(d) VideoSequential on Kinetics-shaped clips (each clip's frames
    carry one matrix) and PatchSequential with a 4 x 4 grid."""
    import kornia_tpu_torch.augmentation as TA
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    clip = torch.rand(CLIP_SHAPE, device=dev, generator=g)
    vs = TA.VideoSequential(TA.ColorJiggle(0.2, 0.3, 0.2, 0.05, p=1),
                            TA.RandomAffine(10.0, p=1),
                            TA.RandomBoxBlur((3, 3)),
                            TA.RandomHorizontalFlip(), data_format="BCTHW")
    out = {"video": _timed("(d) VideoSequential", lambda: vs(clip, g),
                           CLIP_SHAPE[0])}
    B, _, T = CLIP_SHAPE[:3]
    params = vs._clip_params(g, B, T, (3,) + CLIP_SHAPE[-2:])
    M = vs.augs[1].transform_matrix(
        torch.empty((B * T, 3) + CLIP_SHAPE[-2:], device=dev),
        params[1]).reshape(B, T, 3, 3)
    spread = (M - M[:, :1]).abs().max().item()
    flips = params[3]["apply_mask"].reshape(B, T)
    if spread != 0.0 or not bool((flips == flips[:, :1]).all()):
        fail(f"augmentation (d): a clip's frames carry different matrices "
             f"({spread}) or flips")
    out["frame_matrix_spread"] = spread
    x = torch.rand(PATCH_SHAPE, device=dev, generator=g)
    ps = TA.PatchSequential(TA.ColorJiggle(0.1, 0.1, 0.1, 0.1, p=0.5),
                            TA.RandomBoxBlur((3, 3)), TA.RandomSolarize(),
                            grid_size=(4, 4))
    recs = ps.forward_parameters(g, PATCH_SHAPE)
    out["patch"] = _timed("(d) PatchSequential (replaying its records)",
                          lambda: ps(x, params=recs), PATCH_SHAPE[0])
    out["patch"]["records"] = len(recs)
    return out


def aug_volumes(dev) -> dict:
    """(e) the volumetric ops at 4 x 1 x 64 x 128 x 128, each timed."""
    import kornia_tpu_torch.augmentation as TA
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    v = torch.rand(VOL_SHAPE, device=dev, generator=g)
    ops = {"affine3d": TA.RandomAffine3D(15.0, (0.1, 0.1, 0.1), (0.9, 1.1),
                                         p=1.0),
           "rotation3d": TA.RandomRotation3D(20.0, p=1.0),
           "motion_blur3d": TA.RandomMotionBlur3D(5, p=1.0),
           "crop3d": TA.RandomCrop3D(VOL_CROP),
           "equalize3d": TA.RandomEqualize3D(p=1.0),
           "depthical_flip3d": TA.RandomDepthicalFlip3D(p=1.0),
           "perspective3d": TA.RandomPerspective3D(0.3, p=1.0)}
    out = {n: _timed(f"(e) {n}", lambda: op(v, g), VOL_SHAPE[0])
           for n, op in ops.items()}
    if ops["crop3d"](v, g).shape != VOL_SHAPE[:2] + VOL_CROP:
        fail("augmentation (e): RandomCrop3D's shape")
    return out


def gan_pipeline(A):
    """(f)'s differentiable augmentation: box blur, colour jitter, affine
    and JPEG, every op differentiable in the image."""
    return A.ImageSequential(A.RandomBoxBlur((5, 5)), A.ColorJiggle(p=1.0),
                             A.RandomAffine(10.0, p=1.0),
                             A.RandomJPEG((50.0, 90.0), p=1.0))


def aug_gan(dev) -> dict:
    """(f) ADA at p = 0.6 with a backward of a sum to the images and an
    update on seeded logits; the differentiable pipeline's backward (the
    blur adjoint); Operation's magnitude gradients on the card against
    the CPU port."""
    import kornia_tpu_torch.augmentation as TA
    from kornia_tpu_torch.augmentation.auto import (Operation, _AA_BINS,
                                                    _AA_FNS)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.rand(GAN_SHAPE, device=dev, generator=g)
    ada = TA.AdaptiveDiscriminatorAugmentation()
    ada.p = 0.6

    def ada_step():
        xr = x.clone().requires_grad_()
        ada(xr, g).sum().backward()
        return xr.grad

    out = {"ada": _timed("(f) ADA forward + backward", ada_step,
                         GAN_SHAPE[0])}
    logits = torch.randn(GAN_SHAPE[0], device=dev, generator=g) + 0.5
    out["ada"]["p_after_update"] = ada.update(logits)
    pipe = gan_pipeline(TA)

    def diff_step():
        xr = x.clone().requires_grad_()
        pipe(xr, g).square().sum().backward()
        return xr.grad

    out["pipeline"] = _timed("(f) differentiable pipeline + backward",
                             diff_step, GAN_SHAPE[0])
    if not bool(torch.isfinite(diff_step()).all()):
        fail("augmentation (f): the pipeline's gradient is not finite")
    # Operation: gradient of Σ op(x, m)² in each magnitude, card vs CPU
    gx = torch.rand(AUG_XCHECK, generator=torch.Generator().manual_seed(5))
    grads = {}
    for name, fn in _AA_FNS.items():
        lo, hi = _AA_BINS[name] or (0.0, 1.0)
        op = Operation(name, fn, probability=1.0)
        vals = []
        for d in (dev, "cpu"):
            m = torch.tensor(0.5 * (lo + hi), device=d, requires_grad=True)
            y = op(gx.to(d), None, magnitude=m,
                   draws={"gate": torch.ones(AUG_XCHECK[0], dtype=torch.bool,
                                             device=d)})
            if not y.requires_grad:  # the op takes no magnitude
                vals.append(0.0)
                continue
            (gm,) = torch.autograd.grad(y.square().sum(), m,
                                        allow_unused=True)
            vals.append(0.0 if gm is None else gm.item())
        scale = max(abs(vals[1]), 1e-30)
        grads[name] = dict(card=vals[0], cpu=vals[1],
                           rel=abs(vals[0] - vals[1]) / scale)
        if not abs(vals[0] - vals[1]) <= GRAD_RTOL * max(abs(vals[1]), 1e-6):
            fail(f"augmentation (f): Operation {name}'s magnitude gradient "
                 f"card {vals[0]} vs CPU {vals[1]}")
    out["operation_grads"] = grads
    print(f"augmentation (f): Operation magnitude gradients card vs CPU "
          f"within {max(r['rel'] for r in grads.values()):.2e} relative")
    return out


def aug_mix(dev) -> dict:
    """(g) MixUp, CutMix, Mosaic, Jigsaw and transplantation with masks at
    64 x 3 x 224 x 224 with labels."""
    import kornia_tpu_torch.augmentation as TA
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.rand(MIX_SHAPE, device=dev, generator=g)
    labels = torch.randint(0, 1000, (MIX_SHAPE[0],), device=dev, generator=g)
    seg = torch.randint(0, 8, (MIX_SHAPE[0], MIX_SHAPE[2] // 32,
                               MIX_SHAPE[3] // 32), device=dev,
                        generator=g).repeat_interleave(32, 1) \
        .repeat_interleave(32, 2)
    ops = {"mixup": lambda: TA.RandomMixUpV2(p=1.0)(x, labels, g),
           "cutmix": lambda: TA.RandomCutMixV2(p=1.0)(x, labels, g),
           "mosaic": lambda: TA.RandomMosaic(MIX_SHAPE[-2:], p=1.0)(x, g),
           "jigsaw": lambda: TA.RandomJigsaw((4, 4), p=1.0)(x, g),
           "transplantation": lambda: TA.RandomTransplantation(p=1.0)(
               x, seg, g)}
    out = {n: _timed(f"(g) {n}", fn, MIX_SHAPE[0]) for n, fn in ops.items()}
    _, mixed = ops["cutmix"]()
    if mixed.shape != (MIX_SHAPE[0], 3) or not bool(
            ((mixed[:, 2] >= 0) & (mixed[:, 2] <= 1)).all()):
        fail("augmentation (g): CutMix's mixed labels")
    return out


def aug_dissolve(dev) -> dict:
    """(h) RandomDissolving with the default configuration and with SD
    1.5's published widths (weights seeded), at 4 x 3 x 256 x 256."""
    import kornia_tpu_torch.augmentation as TA
    from kornia_tpu_torch.models.diffusion import (DiffusionConfig,
                                                   StableDiffusionDissolving)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.rand(DISSOLVE_SHAPE, device=dev, generator=g)
    out = {}
    for name, cfg in (("default", DiffusionConfig()),
                      ("sd15_like", DiffusionConfig.sd15_like())):
        t0 = time.perf_counter()
        model = StableDiffusionDissolving(cfg, device=dev)
        build_s = time.perf_counter() - t0
        aug = TA.RandomDissolving(model=model, p=1.0)
        with torch.no_grad():
            out[name] = _timed(f"(h) RandomDissolving[{name}]",
                               lambda: aug(x, g), DISSOLVE_SHAPE[0])
            y = aug(x, g)
        out[name]["build_s"] = build_s
        out[name]["params"] = sum(p.numel() for p in model.model.parameters())
        if y.shape != x.shape or not bool(((y >= 0) & (y <= 1)).all()):
            fail(f"augmentation (h): {name} out of [0, 1] or misshapen")
        del model, aug
    return out


def _xcheck_cases(TA):
    """Every exported class (and container), the input it takes and the
    card-vs-CPU tolerance: 'int' bit for bit, 'color' 1e-5, 'warp'
    sample_atol of the source's size, 'jpeg' 1e-4 (the CPU tests'
    limits)."""
    I, V = "img", "vol"
    c = {
        "RandomBrightness": (TA.RandomBrightness(p=1.0), I, "color"),
        "RandomContrast": (TA.RandomContrast(), I, "color"),
        "RandomSaturation": (TA.RandomSaturation(p=1.0), I, "color"),
        "RandomHue": (TA.RandomHue(p=1.0), I, "color"),
        "RandomGamma": (TA.RandomGamma(p=1.0), I, "color"),
        "ColorJiggle": (TA.ColorJiggle(0.4, 0.4, 0.4, 0.1, p=1.0), I,
                        "color"),
        "RandomGrayscale": (TA.RandomGrayscale(p=0.5), I, "color"),
        "RandomGaussianBlur": (TA.RandomGaussianBlur((7, 7), p=1.0), I,
                               "color"),
        "RandomGaussianNoise": (TA.RandomGaussianNoise(std=0.1, p=1.0), I,
                                "color"),
        "RandomMotionBlur": (TA.RandomMotionBlur(p=1.0), I, "color"),
        "RandomBoxBlur": (TA.RandomBoxBlur((5, 5), p=1.0), I, "color"),
        "RandomMedianBlur": (TA.RandomMedianBlur(p=1.0), I, "int"),
        "RandomSolarize": (TA.RandomSolarize(p=1.0), I, "color"),
        "RandomPosterize": (TA.RandomPosterize(p=1.0), I, "int"),
        "RandomSharpness": (TA.RandomSharpness(p=1.0), I, "color"),
        "RandomEqualize": (TA.RandomEqualize(p=1.0), I, "int"),
        "RandomCLAHE": (TA.RandomCLAHE(p=1.0), I, "int"),
        "RandomAutoContrast": (TA.RandomAutoContrast(p=1.0), I, "color"),
        "RandomInvert": (TA.RandomInvert(), I, "color"),
        "RandomChannelShuffle": (TA.RandomChannelShuffle(p=1.0), I, "int"),
        "RandomChannelDropout": (TA.RandomChannelDropout(p=1.0), I, "int"),
        "RandomErasing": (TA.RandomErasing(p=1.0), I, "int"),
        "RandomSaltAndPepper": (TA.RandomSaltAndPepper(p=1.0), I, "int"),
        "RandomRGBShift": (TA.RandomRGBShift(p=1.0), I, "color"),
        "RandomPlanckianJitter": (TA.RandomPlanckianJitter(p=1.0), I,
                                  "color"),
        "RandomLinearIllumination": (TA.RandomLinearIllumination(p=1.0), I,
                                     "color"),
        "RandomPlasmaBrightness": (TA.RandomPlasmaBrightness(p=1.0), I,
                                   "color"),
        "RandomPlasmaShadow": (TA.RandomPlasmaShadow(p=1.0), I, "color"),
        "RandomPlasmaContrast": (TA.RandomPlasmaContrast(p=1.0), I, "color"),
        "RandomJPEG": (TA.RandomJPEG(p=1.0), I, "jpeg"),
        "Normalize": (TA.Normalize(list(IMAGENET_MEAN), list(IMAGENET_STD)),
                      I, "color"),
        "Denormalize": (TA.Denormalize(list(IMAGENET_MEAN),
                                       list(IMAGENET_STD)), I, "color"),
        "RandomSnow": (TA.RandomSnow((0.3, 0.6), (1.5, 2.5)), I, "color"),
        "RandomRain": (TA.RandomRain((100, 200), (3, 10), p=1.0), I, "int"),
        "RandomGaussianIllumination": (TA.RandomGaussianIllumination(p=1.0),
                                       I, "color"),
        "RandomLinearCornerIllumination": (
            TA.RandomLinearCornerIllumination(p=1.0), I, "color"),
        "Resize": (TA.Resize((48, 80)), I, "warp"),
        "LongestMaxSize": (TA.LongestMaxSize(96), I, "warp"),
        "SmallestMaxSize": (TA.SmallestMaxSize(40), I, "warp"),
        "RandomHorizontalFlip": (TA.RandomHorizontalFlip(), I, "int"),
        "RandomVerticalFlip": (TA.RandomVerticalFlip(p=1.0), I, "int"),
        "RandomRotation": (TA.RandomRotation(30.0, p=1.0), I, "warp"),
        "RandomRotation90": (TA.RandomRotation90(p=1.0), I, "int"),
        "RandomAffine": (TA.RandomAffine(15.0, (0.1, 0.1), (0.8, 1.2), 5.0,
                                         p=1.0), I, "warp"),
        "RandomPerspective": (TA.RandomPerspective(0.4, p=1.0), I, "warp"),
        "RandomShear": (TA.RandomShear(p=1.0), I, "warp"),
        "RandomTranslate": (TA.RandomTranslate(p=1.0), I, "warp"),
        "RandomCrop": (TA.RandomCrop((40, 48)), I, "warp"),
        "RandomResizedCrop": (TA.RandomResizedCrop((48, 48)), I, "warp"),
        "CenterCrop": (TA.CenterCrop((40, 48)), I, "int"),
        "RandomElasticTransform": (TA.RandomElasticTransform(p=1.0), I,
                                   "warp"),
        "RandomThinPlateSpline": (TA.RandomThinPlateSpline(p=1.0), I,
                                  "warp"),
        "RandomFisheye": (TA.RandomFisheye(p=1.0), I, "warp"),
        "PadTo": (TA.PadTo((72, 80)), I, "int"),
        "RandomMosaic": (TA.RandomMosaic(p=1.0), I, "int"),
        "RandomJigsaw": (TA.RandomJigsaw(p=1.0), I, "int"),
        "RandomPatchMix": (TA.RandomPatchMix(p=1.0), I, "color"),
        "RandomHorizontalFlip3D": (TA.RandomHorizontalFlip3D(p=1.0), V,
                                   "int"),
        "RandomVerticalFlip3D": (TA.RandomVerticalFlip3D(p=1.0), V, "int"),
        "RandomDepthicalFlip3D": (TA.RandomDepthicalFlip3D(p=1.0), V, "int"),
        "RandomRotation3D": (TA.RandomRotation3D(20.0, p=1.0), V, "warp"),
        "RandomAffine3D": (TA.RandomAffine3D(15.0, (0.1, 0.1, 0.1),
                                             (0.9, 1.1), p=1.0), V,
                           "warp"),
        "RandomCrop3D": (TA.RandomCrop3D((12, 24, 24)), V, "int"),
        "CenterCrop3D": (TA.CenterCrop3D((12, 24, 24)), V, "int"),
        "RandomEqualize3D": (TA.RandomEqualize3D(p=1.0), V, "int"),
        "RandomMotionBlur3D": (TA.RandomMotionBlur3D(5, p=1.0), V, "color"),
        "RandomPerspective3D": (TA.RandomPerspective3D(0.4, p=1.0), V,
                                "warp"),
    }
    return c


def _xcheck_limit(tol: str, size: int) -> float:
    return {"int": 0.0, "color": IMAGE_ATOL, "jpeg": IMAGE_WIDE_ATOL,
            "warp": sample_atol(size)}[tol]


def aug_xcheck(dev) -> dict:
    """Every class on the card and on the CPU port with the same params
    (drawn by the port on the CPU), the containers, dispatchers, policies,
    ADA, mixes and the dissolving model too; each op's gradient in (f)'s
    pipeline card vs CPU. The chains (the SimCLR view, ADA's pipeline, the
    policies' steps, (f)) are held op by op, each fed the CPU's input to
    it, and the SimCLR view and (f)'s gradient end to end as well, at the
    chain limits AUG_CHAIN_GAIN and AUG_CHAIN_GRAD_RTOL."""
    import kornia_tpu_torch.augmentation as TA
    from kornia_tpu_torch.convert import aug_params_from_numpy as carried
    from kornia_tpu_torch.models.diffusion import StableDiffusionDissolving
    gc = torch.Generator().manual_seed(SEED + 8)
    xc = torch.rand(AUG_XCHECK, generator=gc)
    vc = torch.rand(AUG_XCHECK_VOL, generator=gc)
    rows = {}

    def compare(name, card, cpu, limit):
        rows[name] = card_vs_cpu(f"augmentation {name}", card, cpu, limit)

    def op_by_op(what, chain, params, x_in, limit_of):
        """Each op of `chain` card vs CPU on the CPU's input to it; the
        CPU's output of the chain."""
        for i, (op, q) in enumerate(zip(chain.augs, params)):
            y = op(x_in, params=q)
            compare(f"{what} op {i} {type(op).__name__}",
                    op(x_in.to(dev), params=carried(q, dev)), y, limit_of(i))
            x_in = y
        return x_in

    for name, (aug, kind, tol) in _xcheck_cases(TA).items():
        x = xc if kind == "img" else vc
        p = aug.generate_parameters(gc, tuple(x.shape))
        cpu = aug(x, params=p)
        card = aug(x.to(dev), params=carried(p, dev))
        compare(name, card, cpu, _xcheck_limit(tol, x.shape[-1]))
    # the detection pipeline, every key, and its inverse
    inp = [t.cpu() for t in detection_inputs(dev, (8, 3, 64, 64))]
    det = detection_pipeline(TA)
    p = det.generate_parameters(gc, inp[0].shape)
    cpu = det(*inp, params=p)
    card = det(*[t.to(dev) for t in inp], params=carried(p, dev))
    compare("AugmentationSequential", card, cpu, sample_atol(64))
    compare("AugmentationSequential.inverse", det.inverse(*card),
            det.inverse(*cpu, params=p, in_hw=(64, 64)), sample_atol(64))
    # the dispatchers draw on the card's generator; the same draws,
    # carried to the CPU, replay each pipeline there
    pipes = [detection_pipeline(TA, elastic=False),
             TA.AugmentationSequential(TA.RandomAffine(10.0, p=1.0),
                                       TA.ColorJiggle(0.2, 0.2, 0.2, p=1.0),
                                       data_keys=["input", "mask"])]
    ins = [inp, [xc, inp[1]]]
    for cls in (TA.ManyToManyAugmentationDispather,
                TA.ManyToOneAugmentationDispather):
        g = torch.Generator(device=dev).manual_seed(SEED + 10)
        state = g.get_state()
        outs = cls(*pipes)(*[[t.to(dev) for t in i] for i in ins],
                           generator=g)
        g.set_state(state)
        for i, (pipe, i_cpu) in enumerate(zip(pipes, ins)):
            if cls is TA.ManyToOneAugmentationDispather:
                g.set_state(state)
            p = pipe.generate_parameters(g, tuple(i_cpu[0].shape))
            compare(f"{cls.__name__} pipeline {i}", outs[i],
                    pipe(*i_cpu, params=carried(p, "cpu")), sample_atol(64))
    # video and patch containers
    clip = torch.rand(2, 3, 4, 32, 32, generator=gc)
    vs = TA.VideoSequential(TA.ColorJiggle(0.2, 0.3, 0.2, 0.05, p=1),
                            TA.RandomAffine(10.0, p=1),
                            TA.RandomBoxBlur((3, 3)),
                            TA.RandomHorizontalFlip(), data_format="BCTHW")
    p = vs._clip_params(gc, 2, 4, (3, 32, 32))
    compare("VideoSequential", vs(clip.to(dev), params=carried(p, dev)),
            vs(clip, params=p), sample_atol(32))
    ps = TA.PatchSequential(TA.ColorJiggle(0.1, 0.1, 0.1, 0.1, p=0.5),
                            TA.RandomSolarize(), grid_size=(4, 4))
    recs = ps.forward_parameters(gc, tuple(xc.shape))
    compare("PatchSequential", ps(xc.to(dev), params=carried(recs, dev)),
            ps(xc, params=recs), IMAGE_ATOL)
    # the chains op by op, each fed the CPU's input on both devices: a
    # warp's ulps would otherwise move a later threshold or bin (solarize,
    # posterize) by a whole step. The SimCLR view whole as well: its
    # draws put no pixel at solarize's threshold, so the warp's ulps pass
    # through the jitter's gain and Normalize's 1 / std alone
    view = simclr_pipeline(TA, 48)
    p = view.generate_parameters(gc, AUG_XCHECK)
    end = op_by_op(
        "SimCLR view", view, p, xc,
        lambda i: sample_atol(64) / (min(IMAGENET_STD) if i == len(p) - 1
                                     else 1.0))
    compare("SimCLR view end to end", view(xc.to(dev), params=carried(p, dev)),
            end, AUG_CHAIN_GAIN * sample_atol(64) / min(IMAGENET_STD))
    # ADA: its pipeline at p = 0.6 with injected params, then `update` on
    # the same logits (its host read is the reference's own)
    ga = torch.Generator().manual_seed(SEED + 11)
    ada = [TA.AdaptiveDiscriminatorAugmentation() for _ in range(2)]
    for a in ada:
        a.p = 0.6
    chain = ada[1]._pipeline()
    op_by_op("ADA", chain, chain.generate_parameters(ga, AUG_XCHECK), xc,
             lambda i: sample_atol(64))
    logits = torch.randn(64, generator=ga)
    p_card, p_cpu = ada[0].update(logits.to(dev)), ada[1].update(logits)
    compare("ADA update", torch.tensor(p_card), torch.tensor(p_cpu), 0.0)
    B = AUG_XCHECK[0]
    draws = [{"op_idx": torch.arange(B, dtype=torch.int32) * 2 % 15,
              "signs": torch.where(torch.arange(B) % 2 == 0, 1.0, -1.0)},
             {"op_idx": (torch.arange(B, dtype=torch.int32) * 2 + 1) % 15,
              "signs": torch.where(torch.arange(B) % 3 == 0, 1.0, -1.0)}]
    x_in = xc
    for i, d in enumerate(draws):
        y = TA.RandAugment()(x_in, draws=[d])
        compare(f"RandAugment step {i}",
                TA.RandAugment()(x_in.to(dev), draws=carried([d], dev)), y,
                sample_atol(64))
        x_in = y
    tdraw = dict(draws[0], mag01=torch.rand(B, generator=gc))
    compare("TrivialAugment",
            TA.TrivialAugment()(xc.to(dev), draws=carried(tdraw, dev)),
            TA.TrivialAugment()(xc, draws=tdraw), sample_atol(64))
    for pol in ("imagenet", "cifar10", "svhn"):
        aa = TA.AutoAugment(pol)
        sub = torch.randint(0, 25, (B,), generator=gc, dtype=torch.int32)
        steps = [{"u": torch.rand(B, generator=gc),
                  "gate": torch.rand(B, generator=gc) < 0.7}
                 for _ in range(aa.n_steps)]
        off = {"u": torch.zeros(B), "gate": torch.zeros(B, dtype=torch.bool)}
        x_in = xc
        for i in range(aa.n_steps):
            # step i alone: every other step's gate shut
            ad = {"sub_idx": sub, "steps": [steps[j] if j == i else off
                                            for j in range(aa.n_steps)]}
            y = aa(x_in, draws=ad)
            compare(f"AutoAugment[{pol}] step {i}",
                    aa(x_in.to(dev), draws=carried(ad, dev)), y,
                    sample_atol(64))
            x_in = y
    # mixes with labels and masks
    labels = torch.arange(B)
    seg = torch.randint(0, 4, (B, 64, 64), generator=gc)
    for name, aug, args in (
            ("RandomMixUpV2", TA.RandomMixUpV2(p=1.0), (labels,)),
            ("RandomCutMixV2", TA.RandomCutMixV2(p=1.0), (labels,)),
            ("RandomTransplantation", TA.RandomTransplantation(p=1.0),
             (seg,))):
        p = aug.generate_parameters(gc, tuple(xc.shape))
        compare(name, aug(xc.to(dev), *[a.to(dev) for a in args],
                          params=carried(p, dev)),
                aug(xc, *args, params=p),
                IMAGE_ATOL if name == "RandomMixUpV2" else 0.0)
    vseg = torch.randint(0, 3, (2,) + AUG_XCHECK_VOL[2:], generator=gc)
    tp3 = TA.RandomTransplantation3D(p=1.0)
    p = tp3.generate_parameters(gc, AUG_XCHECK_VOL)
    compare("RandomTransplantation3D",
            tp3(vc.to(dev), vseg.to(dev), params=carried(p, dev)),
            tp3(vc, vseg, params=p), 0.0)
    # the dissolving model: the same seeded weights on both devices
    dis = [TA.RandomDissolving(model=StableDiffusionDissolving(device=d),
                               p=1.0) for d in (dev, "cpu")]
    p = dis[1].generate_parameters(gc, AUG_XCHECK)
    with torch.no_grad():
        compare("RandomDissolving", dis[0](xc.to(dev), params=carried(p, dev)),
                dis[1](xc, params=p), IMAGE_ATOL)
    # (f)'s differentiable pipeline: each op's gradient (of Σ w · op(x))
    # card vs CPU on the CPU's input to it, and the whole chain's
    pipe = gan_pipeline(TA)
    p = pipe.generate_parameters(gc, AUG_XCHECK)
    w = torch.rand(AUG_XCHECK, generator=gc)

    def grad_of(fn, x, d):
        xr = x.to(d).clone().requires_grad_()
        (fn(xr, d) * w.to(d)).sum().backward()
        return xr.grad

    x_in = xc
    for i, (op, q) in enumerate(zip(pipe.augs, p)):
        name = f"(f) op {i} {type(op).__name__} gradient"
        rows[name] = card_vs_cpu(
            f"augmentation {name}",
            *[grad_of(lambda a, d: op(a, params=carried(q, d)), x_in, d)
              for d in (dev, "cpu")], "grad")
        x_in = op(x_in, params=q)
    g_card, g_cpu = [grad_of(lambda a, d: pipe(a, params=carried(p, d)), xc, d)
                     for d in (dev, "cpu")]
    scale = float(g_cpu.abs().max())
    compare("(f) gradient end to end, of the largest", g_card.cpu() / scale,
            g_cpu / scale, AUG_CHAIN_GRAD_RTOL)
    bad = [n for n, r in rows.items() if not r["ok"]]
    for n, r in rows.items():
        if not r["ok"] or r["limit"] != "0.0" or not r["bitwise"]:
            print(f"augmentation xcheck {n}: max diff {r['max_diff']:.3e} "
                  f"(limit {r['limit']}, bitwise {r['bitwise']})"
                  f"{'' if r['ok'] else '  FAILS'}")
    print(f"augmentation xcheck: {len(rows)} classes and paths card vs CPU, "
          f"{sum(r['bitwise'] for r in rows.values())} bit for bit")
    if bad:
        fail(f"augmentation: card and CPU disagree beyond the limits on "
             f"{bad}")
    return rows


def augmentation_phase(K, dev) -> dict:
    """Step 16: the augmentation layer (see the module's docstring)."""
    t_phase = time.perf_counter()
    parts, res = {}, {}
    for name, fn in (("simclr", aug_simclr), ("detection", aug_detection),
                     ("auto", aug_auto), ("video", aug_video),
                     ("volumes", aug_volumes), ("gan", aug_gan),
                     ("mix", aug_mix), ("dissolve", aug_dissolve),
                     ("xcheck", aug_xcheck)):
        t0 = time.perf_counter()
        res[name] = fn(dev)
        parts[name] = round(time.perf_counter() - t0, 1)
    # the path: (b)'s forward and inverse, (d)'s clips and (f)'s
    # differentiable step; every fused blur and band adjoint captured and
    # held to its plain version on its ROUTES route
    import kornia_tpu_torch.augmentation as TA
    t_path = time.perf_counter()
    det_in = detection_inputs(dev)
    det = detection_pipeline(TA)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    clip = torch.rand(CLIP_SHAPE, device=dev, generator=g)
    vs = TA.VideoSequential(TA.ColorJiggle(0.2, 0.3, 0.2, 0.05, p=1),
                            TA.RandomAffine(10.0, p=1),
                            TA.RandomBoxBlur((3, 3)),
                            TA.RandomHorizontalFlip(), data_format="BCTHW")
    x = torch.rand(GAN_SHAPE, device=dev, generator=g)
    pipe = gan_pipeline(TA)
    p_det = det.generate_parameters(g, DET_SHAPE)
    p_vs = vs._clip_params(g, CLIP_SHAPE[0], CLIP_SHAPE[2],
                           (3,) + CLIP_SHAPE[-2:])
    p_gan = pipe.generate_parameters(g, GAN_SHAPE)

    def path():
        det.inverse(*det(*det_in, params=p_det))
        vs(clip, params=p_vs)
        xr = x.clone().requires_grad_()
        pipe(xr, params=p_gan).square().sum().backward()

    names = ("fused_separable_blur2d", "fused_separable_blur2d_adjoint")
    launches = counted_run(K, path, "augmentation", names)
    _, _, kern = device_profile(path, names)
    calls = capture_launches(K, path, names)
    per_path = path_kernel_times(K, kern, calls, launches, "augmentation")
    checks = check_captured(K, calls, "augmentation")
    results, counts = path_entries(K, calls, checks, launches,
                                   "augmentation")
    report(results)
    parts["path"] = round(time.perf_counter() - t_path, 1)
    out = dict(res, launches=launches, per_path=per_path, checks=checks,
               parts=parts, seconds=time.perf_counter() - t_phase)
    print(f"augmentation phase: {out['seconds']:.1f} s, parts {parts}")
    print(json.dumps({"augmentation": out}))
    return dict(kernels=results, counts=counts, **out)


# --- step 17: patch descriptors and matchers ---------------------------------

DM_NF = 1024             # SIFTFeature's LAFs an image
DM_REPS = 5              # host-clock calls a stage, median
DISK_N = 2048            # DISK keypoints an image
DM_DESC_ATOL = 1e-4      # card vs CPU: descriptors of the same patches
DM_AGREE = 0.99          # ... share of equal SMNN and LightGlue matches
DISK_HEAT_RTOL = 1e-4    # ... DISK's heatmap, of max(1, its largest |entry|)
LG_ASSIGN_RTOL = 1e-3    # ... LightGlue's log assignment, of its largest
DM_KERNELS = ("patch_sample", "fused_separable_blur2d", "multi_level_blur")


def dm_nets(device):
    """(a)'s patch descriptors at their published widths on `device`
    (seeded weights; the default seeds draw the same weights on every
    device), and MKD's seeded whitening model."""
    from kornia_tpu_torch.feature import descriptors as D
    from kornia_tpu_torch.feature.extras import HardNet8
    from kornia_tpu_torch.feature.mkd import MKDDescriptor
    from kornia_tpu_torch.feature.siftdesc import SIFTDescriptor
    rng = np.random.default_rng(SEED + 17)
    q, _ = np.linalg.qr(rng.normal(size=(238, 238)))
    pca = {"mean": rng.normal(0, 0.01, 238).astype(np.float32),
           "eigvecs": q.astype(np.float32),
           "eigvals": np.sort(rng.uniform(0.1, 2.0, 238))[::-1].astype(
               np.float32).copy()}
    return {"HardNet8": HardNet8(device=device),
            "TFeat": D.TFeat(device=device), "SOSNet": D.SOSNet(device=device),
            "HyNet": D.HyNet(device=device),
            "MKD": MKDDescriptor(whitening=None),
            "MKD_pcawt": MKDDescriptor(whitening="pcawt",
                                       whitening_model={"pca": pca}),
            "SIFT32": SIFTDescriptor(32)}


def dm_inputs(dev):
    """bench.py's 480x640 pair and SIFTFeature(1024)'s LAFs on it."""
    from kornia_tpu_torch.feature.integrated import SIFTFeature
    img0, img1, _ = bench_input(H, W, dev)
    sift = SIFTFeature(num_features=DM_NF)
    (l0, _, _, v0), (l1, _, _, v1) = sift(img0), sift(img1)
    return sift, (img0, img1), (l0, l1), (v0, v1)


def _stage_ms(fns: dict) -> dict:
    return {k: median_ms(f, DM_REPS)[0] for k, f in fns.items()}


def dm_describe(dev, imgs, lafs, valid) -> dict:
    """(a) every descriptor at the LAFs of both images, then SMNN and the
    AdaLAM and FGINN matchers; LAFAffineShapeEstimator and dense SIFT."""
    from kornia_tpu_torch.feature import matching as M
    from kornia_tpu_torch.feature.descriptors import LAFAffineShapeEstimator
    from kornia_tpu_torch.feature.extras import (
        GeometryAwareDescriptorMatcher, get_laf_descriptors)
    from kornia_tpu_torch.feature.siftdesc import DenseSIFTDescriptor
    out, descs = {}, {}
    adalam = GeometryAwareDescriptorMatcher("adalam")
    fginn = GeometryAwareDescriptorMatcher("fginn")
    for name, net in dm_nets(dev).items():
        def describe(net=net):
            return [get_laf_descriptors(i, l_, net, 32)
                    for i, l_ in zip(imgs, lafs)]
        d0, d1 = describe()
        descs[name] = (d0, d1)
        stages = _stage_ms({
            "describe x2": describe,
            "smnn": lambda: M.match_smnn(d0[0], d1[0], 0.95, valid[0][0],
                                         valid[1][0]),
            "adalam": lambda: adalam(d0[0], d1[0], *lafs),
            "fginn": lambda: fginn(d0[0], d1[0], *lafs)})

        def pair(net=net):
            a, b = describe(net)
            M.match_smnn(a[0], b[0], 0.95, valid[0][0], valid[1][0])
            adalam(a[0], b[0], *lafs)
            fginn(a[0], b[0], *lafs)

        pair_ms = median_ms(pair, DM_REPS)[0]
        busy, n_k, _ = device_profile(pair)
        m = M.match_smnn(d0[0], d1[0], 0.95, valid[0][0], valid[1][0])
        ia = adalam(d0[0], d1[0], *lafs)[1]
        out[name] = dict(
            pair_ms=pair_ms, stage_ms=stages, busy_ms=busy,
            busy_share=busy / pair_ms, kernels=n_k,
            peak_bytes=peak_bytes(pair), dim=int(d0.shape[-1]),
            smnn_matches=int(m[2].sum()),
            adalam_matches=int((ia[:, 0] >= 0).sum()))
        print(f"descriptors (a) {name}: {pair_ms:.2f} ms a pair, stages "
              f"{ {k: round(v, 3) for k, v in stages.items()} }, busy "
              f"{busy / pair_ms:.3f}, {n_k} kernels, SMNN "
              f"{out[name]['smnn_matches']}, AdaLAM "
              f"{out[name]['adalam_matches']} matches")
    est = LAFAffineShapeEstimator(32)
    est_ms = median_ms(lambda: est(lafs[0], imgs[0]), DM_REPS)[0]
    dense = DenseSIFTDescriptor()
    both = torch.cat(imgs)
    dense_ms = median_ms(lambda: dense(both), DM_REPS)[0]
    out["LAFAffineShapeEstimator"] = dict(ms=est_ms)
    out["DenseSIFT"] = dict(ms=dense_ms, peak_bytes=peak_bytes(
        lambda: dense(both)))
    print(f"descriptors (a) LAFAffineShapeEstimator(32) on {DM_NF} LAFs "
          f"{est_ms:.2f} ms; DenseSIFTDescriptor on 2x480x640 "
          f"{dense_ms:.2f} ms, peak {out['DenseSIFT']['peak_bytes']} B")
    return dict(rows=out, descs=descs)


def dm_disk_lightglue(dev, imgs) -> dict:
    """(b) DISK(n=2048, window 5) on the pair as RGB, then LightGlue("disk")
    at its published widths directly and through LightGlueMatcher."""
    from kornia_tpu_torch.feature.disk import DISK
    from kornia_tpu_torch.feature.extras import LightGlueMatcher
    from kornia_tpu_torch.feature.laf import laf_from_center_scale_ori
    from kornia_tpu_torch.feature.lightglue import LightGlue, LightGlueConfig
    rgb = torch.cat(imgs).expand(2, 3, H, W).contiguous()
    disk = DISK(device=dev)
    cfg = LightGlueConfig("disk")
    lg = LightGlue(cfg, device=dev)
    matcher = LightGlueMatcher("disk", params={"cfg": cfg}, device=dev)

    def glue(f):
        return lg({"image0": {"keypoints": f.keypoints[:1],
                              "descriptors": f.descriptors[:1],
                              "image_size": [float(W), float(H)]},
                   "image1": {"keypoints": f.keypoints[1:],
                              "descriptors": f.descriptors[1:],
                              "image_size": [float(W), float(H)]}})

    def lafs_of(f, i):
        n = f.keypoints.shape[1]
        return laf_from_center_scale_ori(
            f.keypoints[i:i + 1], torch.ones((1, n, 1, 1), device=dev),
            torch.zeros((1, n, 1), device=dev))

    f = disk(rgb, DISK_N, 5)
    stages = _stage_ms({
        "disk x2": lambda: disk(rgb, DISK_N, 5),
        "lightglue": lambda: glue(f),
        "lightglue_matcher": lambda: matcher(
            f.descriptors[0], f.descriptors[1], lafs_of(f, 0),
            lafs_of(f, 1))})

    def pair():
        g = disk(rgb, DISK_N, 5)
        return glue(g)

    pair_ms = median_ms(pair, DM_REPS)[0]
    busy, n_k, _ = device_profile(pair)
    out = glue(f)
    mm = matcher(f.descriptors[0], f.descriptors[1], lafs_of(f, 0),
                 lafs_of(f, 1))
    res = dict(pair_ms=pair_ms, stage_ms=stages, busy_ms=busy,
               busy_share=busy / pair_ms, kernels=n_k,
               peak_bytes=peak_bytes(pair),
               keypoints=[int(v) for v in f.valid.sum(1)],
               matches=int(out["valid"].sum()),
               matcher_matches=int((mm[1][:, 0] >= 0).sum()))
    print(f"descriptors (b) DISK + LightGlue('disk'): {pair_ms:.2f} ms a "
          f"pair, stages { {k: round(v, 3) for k, v in stages.items()} }, "
          f"busy {res['busy_share']:.3f}, {n_k} kernels, peak "
          f"{res['peak_bytes']} B, keypoints {res['keypoints']}, matches "
          f"{res['matches']} (LightGlueMatcher {res['matcher_matches']})")
    return dict(res, disk=disk, lg=lg, rgb=rgb, f=f, out=out)


def dm_doghardnet(dev, lafs, descs) -> dict:
    """(c) LightGlue("doghardnet") on (a)'s HardNet8 descriptors, with the
    LAFs' scales and orientations (radians), called directly as kornia's
    DoG-HardNet recipe does."""
    from kornia_tpu_torch.feature.laf import (get_laf_center,
                                              get_laf_orientation,
                                              get_laf_scale)
    from kornia_tpu_torch.feature.lightglue import LightGlue, LightGlueConfig
    lg = LightGlue(LightGlueConfig("doghardnet"), device=dev)

    def data(lafs, descs):
        return {f"image{i}": {
            "keypoints": get_laf_center(l_), "descriptors": d,
            "image_size": [float(W), float(H)],
            "scales": get_laf_scale(l_)[..., 0, 0],
            "oris": torch.deg2rad(get_laf_orientation(l_)[..., 0])}
            for i, (l_, d) in enumerate(zip(lafs, descs))}

    inp = data(lafs, descs)
    ms = median_ms(lambda: lg(inp), DM_REPS)[0]
    busy, n_k, _ = device_profile(lambda: lg(inp))
    out = lg(inp)
    res = dict(pair_ms=ms, busy_ms=busy, busy_share=busy / ms, kernels=n_k,
               peak_bytes=peak_bytes(lambda: lg(inp)),
               matches=int(out["valid"].sum()))
    print(f"descriptors (c) LightGlue('doghardnet') on HardNet8: {ms:.2f} "
          f"ms a pair, busy {res['busy_share']:.3f}, {n_k} kernels, "
          f"{res['matches']} matches")
    return dict(res, lg=lg, data=data, out=out)


def _near_tie(heat: torch.Tensor, y: int, x: int, cut: float,
              tol: float) -> bool:
    """A DISK keypoint that one device keeps and the other drops: its score
    within `tol` of the n-th score (the top-n cut) or of its 5x5 window's
    largest other score (the NMS)."""
    v = float(heat[y, x])
    win = heat[max(y - 2, 0):y + 3, max(x - 2, 0):x + 3].flatten()
    others = win[win != v]
    return abs(v - cut) <= tol or (others.numel() > 0 and
                                   abs(v - float(others.max())) <= tol)


def dm_xcheck(dev, imgs, lafs, valid, a: dict, b: dict, c: dict) -> dict:
    """The card against the CPU port on the same inputs: each descriptor of
    the card's LAFs, SMNN's matches, AdaLAM's keep mask on the CPU's inputs
    to it, DISK's heatmap and keypoints, LightGlue's log assignment and
    matches (b and c, on the CPU's DISK features and (a)'s CPU HardNet8
    descriptors)."""
    from kornia_tpu_torch.feature import matching as M
    from kornia_tpu_torch.feature.adalam import adalam_filter
    from kornia_tpu_torch.feature.disk import DISK
    from kornia_tpu_torch.feature.extras import get_laf_descriptors
    from kornia_tpu_torch.feature.laf import get_laf_center
    from kornia_tpu_torch.feature.lightglue import LightGlue
    ci = [i.cpu() for i in imgs]
    cl = [l_.cpu() for l_ in lafs]
    cv = [v.cpu() for v in valid]
    out, cpu_descs = {}, {}
    for name, net in dm_nets("cpu").items():
        cd = [get_laf_descriptors(i, l_, net, 32) for i, l_ in zip(ci, cl)]
        cpu_descs[name] = cd
        gd = a["descs"][name]
        err = max(float((g.cpu() - c_).abs().max()) for g, c_ in zip(gd, cd))
        mg = M.match_smnn(gd[0][0], gd[1][0], 0.95, valid[0][0], valid[1][0])
        mc = M.match_smnn(cd[0][0], cd[1][0], 0.95, cv[0][0], cv[1][0])
        either = mg[2].cpu() | mc[2]
        agree = float(((mg[1].cpu() == mc[1]).all(-1) & (mg[2].cpu() == mc[2])
                       )[either].float().mean()) if either.any() else 1.0
        k0 = get_laf_center(cl[0])[0][mc[1][:, 0].clamp_min(0)]
        k1 = get_laf_center(cl[1])[0][mc[1][:, 1].clamp_min(0)]
        keep_c = adalam_filter(k0, k1, mc[2])
        keep_g = adalam_filter(k0.to(dev), k1.to(dev), mc[2].to(dev))
        adalam_equal = bool(torch.equal(keep_g.cpu(), keep_c))
        out[name] = dict(desc_err=err, smnn_agree=agree,
                         adalam_equal=adalam_equal,
                         adalam_kept=int(keep_c.sum()))
        print(f"descriptors xcheck {name}: descriptors {err:.2e} apart, SMNN "
              f"matches equal {agree:.4f}, AdaLAM keep masks equal "
              f"{adalam_equal} ({int(keep_c.sum())} kept)")
        if not err <= DM_DESC_ATOL:
            fail(f"descriptors xcheck {name}: descriptors {err} apart")
        if not agree >= DM_AGREE:
            fail(f"descriptors xcheck {name}: SMNN matches agree {agree}")
        if not adalam_equal:
            fail(f"descriptors xcheck {name}: AdaLAM keeps other matches")
    # DISK
    disk_c = DISK(device="cpu")
    rgb_c = b["rgb"].cpu()
    pad = (0, (-W) % 16, 0, (-H) % 16)
    heat_g = b["disk"].heatmap_and_dense_descriptors(
        torch.nn.functional.pad(b["rgb"], pad))[0][..., :H, :W].cpu()
    heat_c = disk_c.heatmap_and_dense_descriptors(
        torch.nn.functional.pad(rgb_c, pad))[0][..., :H, :W]
    scale = max(1.0, float(heat_c.abs().max()))
    heat_err = float((heat_g - heat_c).abs().max()) / scale
    fc = disk_c(rgb_c, DISK_N, 5)
    fg = b["f"]
    tol = DISK_HEAT_RTOL * scale
    untied = 0
    for i in range(2):
        sg = {tuple(p) for p in fg.keypoints[i][fg.valid[i]].cpu().long()
              .tolist()}
        sc = {tuple(p) for p in fc.keypoints[i][fc.valid[i]].long().tolist()}
        cut = float(fc.detection_scores[i][fc.valid[i]].min()) \
            if fc.valid[i].any() else 0.0
        for x, y in sg ^ sc:
            untied += not _near_tie(heat_c[i, 0], y, x, cut, tol)
    print(f"descriptors xcheck DISK: heatmap {heat_err:.2e} of max(1, its "
          f"largest), valid keypoints {fg.valid.sum().item()} card, "
          f"{fc.valid.sum().item()} CPU, {untied} differing not at a near "
          f"tie")
    if not heat_err <= DISK_HEAT_RTOL:
        fail(f"descriptors xcheck DISK: heatmaps {heat_err} apart")
    if untied:
        fail(f"descriptors xcheck DISK: {untied} keypoints differ away from "
             f"a near tie")
    out["DISK"] = dict(heat_err=heat_err, untied=untied)
    # LightGlue on the CPU's inputs to it
    lg_c = LightGlue(b["lg"].cfg, device="cpu")
    dog_c = LightGlue(c["lg"].cfg, device="cpu")
    f_in = {k: {kk: (vv.to(dev) if torch.is_tensor(vv) else vv)
                for kk, vv in v.items()}
            for k, v in {"image0": {"keypoints": fc.keypoints[:1],
                                    "descriptors": fc.descriptors[:1],
                                    "image_size": [float(W), float(H)]},
                         "image1": {"keypoints": fc.keypoints[1:],
                                    "descriptors": fc.descriptors[1:],
                                    "image_size": [float(W), float(H)]}
                         }.items()}
    d_cpu = c["data"](cl, cpu_descs["HardNet8"])
    d_card = {k: {kk: (vv.to(dev) if torch.is_tensor(vv) else vv)
                  for kk, vv in v.items()} for k, v in d_cpu.items()}
    for name, card_net, cpu_net, cin, gin in (
            ("LightGlue disk", b["lg"], lg_c,
             {k: {kk: (vv.cpu() if torch.is_tensor(vv) else vv)
                  for kk, vv in v.items()} for k, v in f_in.items()}, f_in),
            ("LightGlue doghardnet", c["lg"], dog_c, d_cpu, d_card)):
        og, oc = card_net(gin), cpu_net(cin)
        la_c = oc["log_assignment"]
        rel = float((og["log_assignment"].cpu() - la_c).abs().max()
                    / la_c.abs().max())
        m_g, m_c = og["matches0"].cpu(), oc["matches0"]
        either = (m_g >= 0) | (m_c >= 0)
        agree = float((m_g == m_c)[either].float().mean()) \
            if either.any() else 1.0
        out[name] = dict(assign_rel=rel, match_agree=agree,
                         matches=int((m_c >= 0).sum()))
        print(f"descriptors xcheck {name}: log assignment {rel:.2e} of its "
              f"largest, matches equal {agree:.4f} ({int((m_c >= 0).sum())} "
              f"on the CPU)")
        if not rel <= LG_ASSIGN_RTOL:
            fail(f"descriptors xcheck {name}: log assignments {rel} apart")
        if not agree >= DM_AGREE:
            fail(f"descriptors xcheck {name}: matches agree {agree}")
    return out


def descriptors_matchers_phase(K, dev) -> dict:
    """Step 17: patch descriptors and matchers (see the module's
    docstring)."""
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    sift, imgs, lafs, valid = dm_inputs(dev)
    a = dm_describe(dev, imgs, lafs, valid)
    parts["a"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    b = dm_disk_lightglue(dev, imgs)
    parts["b"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    c = dm_doghardnet(dev, lafs, a["descs"]["HardNet8"])
    parts["c"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    xcheck = dm_xcheck(dev, imgs, lafs, valid, a, b, c)
    parts["xcheck"] = round(time.perf_counter() - t0, 1)
    # the path: SIFTFeature's LAFs of both images, every descriptor at them
    # and the shape estimator; every patch_sample, fused blur and
    # multi-level blur captured and held to its plain version on its
    # ROUTES route
    from kornia_tpu_torch.feature.descriptors import LAFAffineShapeEstimator
    from kornia_tpu_torch.feature.extras import get_laf_descriptors
    t_path = time.perf_counter()
    nets = dm_nets(dev)
    est = LAFAffineShapeEstimator(32)

    def path():
        for img in imgs:
            l_ = sift(img)[0]
            for net in nets.values():
                get_laf_descriptors(img, l_, net, 32)
            est(l_, img)

    launches = counted_run(K, path, "descriptors", DM_KERNELS)
    _, _, kern = device_profile(path, DM_KERNELS)
    calls = capture_launches(K, path, DM_KERNELS)
    per_path = path_kernel_times(K, kern, calls, launches, "descriptors")
    checks = check_captured(K, calls, "descriptors")
    results, counts = path_entries(K, calls, checks, launches,
                                   "descriptors")
    report(results)
    parts["path"] = round(time.perf_counter() - t_path, 1)
    out = dict(describe=a["rows"],
               disk_lightglue={k: v for k, v in b.items() if k in (
                   "pair_ms", "stage_ms", "busy_ms", "busy_share", "kernels",
                   "peak_bytes", "keypoints", "matches", "matcher_matches")},
               doghardnet={k: v for k, v in c.items() if k in (
                   "pair_ms", "busy_ms", "busy_share", "kernels",
                   "peak_bytes", "matches")},
               xcheck=xcheck, launches=launches, per_path=per_path,
               checks=checks, parts=parts,
               seconds=time.perf_counter() - t_phase)
    print(f"descriptors phase: {out['seconds']:.1f} s, parts {parts}")
    print(json.dumps({"descriptors_matchers": out}))
    return dict(kernels=results, counts=counts, **out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-out", default=None,
                        help="directory for the profile table of one pair")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.ops import filters
    from kornia_tpu_torch.ops import kernels as K

    card = card_line()
    print(card)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = K.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}")
    dev = torch.device("cuda", 0)
    with f32_precision():
        kernel_phase(K, filters, dev)
    path = main_path(K, dev, args.profile_out)
    cross_check(K, dev)
    with f32_precision():
        phases = {"train": train_phase(K, dev), "match": match_phase(K, dev),
                  "fast_patches": fast_patches_phase(K, dev)}
    backend = backend_phase(dev, card)
    with f32_precision():
        planar = planar_phase(K, filters, dev)
    vo = vo_phase(K, dev)
    with f32_precision():
        learned = learned_phase(K, dev)
    with f32_precision():
        keynet_stereo = keynet_stereo_phase(K, dev)
    with f32_precision():
        distributed = distributed_phase(dev, card)
    with f32_precision():
        tracking_io = tracking_io_phase(K, dev)
    with f32_precision():
        image_ops = image_ops_phase(K, dev)
    with f32_precision():
        registration_eval = registration_eval_phase(K, dev)
    with f32_precision():
        augmentation = augmentation_phase(K, dev)
    with f32_precision():
        descriptors = descriptors_matchers_phase(K, dev)
    # each kernel's launches are those of the path that runs it
    entries = [(name, r, ph["counts"]) for ph in (
        path, *phases.values(), planar, vo, learned, keynet_stereo,
        tracking_io, image_ops, registration_eval, augmentation,
        descriptors)
        for name, r in ph["kernels"].items()]
    for name, _, counts in entries:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on its path")
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": counts[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r, counts in entries]}
    print(json.dumps({"card": card, "pair_ms": path["pair_ms"],
                      "stage_ms": path["stage_ms"],
                      "device_busy_ms": path["busy_ms"],
                      "device_kernels": path["n_kernels"],
                      "train_step_ms": phases["train"]["step_ms"],
                      "train_losses": phases["train"]["losses"],
                      "match_cublas_ms": phases["match"]["cublas_ms"],
                      "match_streaming_ms": phases["match"]["stream_match_ms"],
                      "match_dense_ms": phases["match"]["dense_match_ms"],
                      "match_peak_bytes": phases["match"]["peak_bytes"],
                      "fast_patches_pair_ms":
                          phases["fast_patches"]["pair_ms"],
                      "fast_patches_bf16_kernel_ms_per_pair":
                          phases["fast_patches"]["per_pair_ms"],
                      "backend_seconds": backend["seconds"],
                      "planar_frame_ms": planar["frame_ms"],
                      "planar_stage_ms": planar["stage_ms"],
                      "planar_device_busy_ms": planar["busy_ms"],
                      "vo_frames_per_s": vo["walk"]["frames_per_s"],
                      "vo_ate_pct": vo["walk"]["ate_pct"],
                      "vo_track_ms": vo["walk"]["track_ms_median"],
                      "vo_stage_ms": vo["stage_ms"],
                      "vo_idle_share": vo["idle_share"],
                      "learned_config2_pair_ms": learned["config2"]["pair_ms"],
                      "learned_config2_stage_ms":
                          learned["config2"]["stage_ms"],
                      "learned_config2_idle_share":
                          learned["config2"]["idle_share"],
                      "learned_preset_pair_ms": {
                          k: v["pair_ms"]
                          for k, v in learned["presets"].items()},
                      "loftr_pair_ms": learned["loftr"]["pair_ms"],
                      "loftr_peak_bytes": learned["loftr"]["peak_bytes"],
                      "loftr_valid_matches":
                          learned["loftr"]["valid_matches"],
                      "keynet_pair_ms": keynet_stereo["keynet_pair"]["pair_ms"],
                      "keynet_match_pair_ms":
                          keynet_stereo["keynet_match"]["pair_ms"],
                      "stereo_ms": keynet_stereo["stereo"]["whole_ms"],
                      "stereo_peak_bytes":
                          keynet_stereo["stereo"]["peak_bytes"],
                      "stitch_ms": keynet_stereo["stitch"]["ms"],
                      "distributed_seconds": distributed["seconds"],
                      "tracking_frames_per_s":
                          tracking_io["bytetrack"]["frames_per_s"],
                      "tracking_ms_median":
                          tracking_io["bytetrack"]["ms_median"],
                      "tracking_peak_bytes":
                          tracking_io["bytetrack"]["peak_bytes"],
                      "boxtracker_visualize_ms":
                          tracking_io["boxtracker"]["ms_with_visualize"],
                      "tum_window_ms": tracking_io["files"]["window_ms"],
                      "tracking_io_seconds": tracking_io["seconds"],
                      "image_ops_geomean_img_per_s":
                          image_ops["per_op_geomean_throughput"],
                      "image_ops_device_geomean_img_per_s":
                          image_ops["device_geomean_img_per_s"],
                      "image_ops_sweep_busy_share":
                          image_ops["sweep_busy_share"],
                      "image_ops_seconds": image_ops["image_ops_seconds"],
                      "registration_ms":
                          registration_eval["registration"]["ms"],
                      "registration_error_fraction":
                          registration_eval["registration"]["error"]
                          / registration_eval["registration"]["error0"],
                      "msssim_step_ms": registration_eval["msssim"]["step_ms"],
                      "registration_eval_seconds":
                          registration_eval["seconds"],
                      "augmentation_simclr_ms":
                          augmentation["simclr"]["ms"],
                      "augmentation_img_per_s":
                          augmentation["simclr"]["per_s"],
                      "augmentation_seconds": augmentation["seconds"],
                      "descriptors_pair_ms": {
                          k: v["pair_ms"] for k, v in
                          descriptors["describe"].items() if "pair_ms" in v},
                      "disk_lightglue_pair_ms":
                          descriptors["disk_lightglue"]["pair_ms"],
                      "disk_lightglue_matches":
                          descriptors["disk_lightglue"]["matches"],
                      "doghardnet_lightglue_ms":
                          descriptors["doghardnet"]["pair_ms"],
                      "descriptors_seconds": descriptors["seconds"]}))
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
