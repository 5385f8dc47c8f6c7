#!/usr/bin/env python3
"""Smoke run of the PyTorch port (paddle3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

drives the port's main paths, PointPillars-KITTI inference and training
(configs/pointpillars/pointpillars_xyres16_kitti_car.yml, full width, seeded
random weights) on 8 scans of 20,000 clustered points, CenterPoint-pillars
nuScenes serving
(configs/centerpoint/centerpoint_pillars_02voxel_nuscenes_10sweep.yml, full
width, seeded random weights) on 8 scans of 250,000, and CenterPoint-voxels
nuScenes serving
(configs/centerpoint/centerpoint_voxels_0075voxel_nuscenes_10sweep.yml, full
width, seeded random weights) on 4 scans of 250,000, PV-RCNN and Voxel-RCNN
KITTI serving (configs/pv_rcnn/pv_rcnn_005voxel_kitti.yml,
configs/voxel_rcnn/voxel_rcnn_005voxel_kitti_car.yml) on 4 scans of 20,000
IA-SSD KITTI serving (configs/iassd/iassd_kitti.yml) on 4 scans of 16,384,
CenterPoint-pillars nuScenes training on 8 scans of 250,000, Voxel-RCNN
then PV-RCNN KITTI training on 2 scans of 20,000 (the configs' batch), the
row-window segment sum and the row gather as ops, CenterPoint-voxels
nuScenes training on 4 scans of 250,000, IA-SSD KITTI training on 8 scans
of 16,384 (the configs' batches), SMOKE, the first camera model
(configs/smoke/smoke_dla34_no_dcn_kitti.yml, full width, seeded random
weights), serving 1 and 8 images of 384 x 1280 and training on 8, and
CADDN, the second (configs/caddn/caddn_ocrnet_hrnetw18_kitti.yml, full
width, seeded random weights), serving 1 and 4 images of 384 x 1248 and
training on 4, and PETR and PETRv2, the third and fourth
(configs/petr/petr{,v2}_vovnet_gridmask_p4_800x320.yml, full width, seeded
random weights), serving 1 and 2 frames of six 320 x 800 images (PETRv2:
1 frame of twelve) and training on 2, and BEVFormer-tiny and BEVDet4D,
the fifth and sixth (configs/bevformer/bevformer_tiny_r50_fpn_nuscenes.yml,
configs/bevdet/bevdet4d_r50_depth_nuscenes.yml, full width, seeded random
weights), serving two consecutive frames of six 450 x 800 images padded to
480 x 800 and training on 1 with a history frame, serving 1 and 8 frames
of six 256 x 704 images and training on 8 with an adjacent frame, and
CAPE / CAPE-T and RTEBev, the seventh and eighth
(configs/cape/cape{,_t}_*.yml,
configs/rtebev/rtebev_r50_nuscenes_256x704_msdepth_hybrid_{1f,4f}.yml,
full width, seeded random weights), serving 1 and 2 frames of six 512 x
1408 images and training CAPE-T on 2, serving 1 and 4 frames of six 256 x
704 images and training on 4 with an adjacent frame, and BEVFusion
(configs/bevfusion/bevf_{pp,lidar,cam}_nuscenes.yml, full width, seeded
random weights), serving 1 and 2 frames of a 250,000-point nuScenes scan
and six 448 x 800 images and training on 2, and DD3D
(configs/dd3d/dd3d_{dla34,v2_99}_kitti.yml, full width, seeded random
weights), serving 1 and 8 images of 384 x 1280 and training on 8, and
SqueezeSegV3 (configs/squeezesegv3/*_semantickitti.yml, RangeNet-21 and
-53), PAConv (configs/paconv/paconv_modelnet40.yml) and BEV-LaneDet
(configs/bev_lanedet/bev_lanedet_apollo_576x1024.yml), full width, seeded
random weights, serving and training at their configs' batches, and then
the runtime (Config, Trainer, DataLoader, the datasets, evaluate() and
the metrics) on trees generated from the seed: the LiDAR configs, the
KITTI camera configs on PNGs and the nuScenes multi-view and Apollo
configs on JPEGs, in phases; any failing phase exits non-zero, names the
phase and prints no result (each phase's first line leads with the
seconds since the start):

  1. the card's name and power limit; build the CUDA kernels from
     paddle3d_tpu_torch/csrc/ with nvcc (first use builds them);
  2. each kernel against its plain PyTorch version on the card, at its
     path's shapes (K1/K2 inference, K3/K4/K5 train, the two-layer K1 and
     K6 CenterPoint inference), with the stated tolerance (K1, one layer
     at KITTI serving and at the train shape with the batch statistics
     folded in, and two layers, by bit pattern, tolerance 0, the one-layer
     K1 also against a second call and timed in parts, its C entry alone
     and through its wrapper; K6 on the path's rows and on random
     rows bit for bit against the row-order sum, and within 1e-5 of the
     largest value of index_add_ on random rows; K3 and K4 also bit for
     bit against a second call of their own, and their wrappers timed in
     parts); kernel, plain
     and library-call times and each kernel's bound (a scatter's library
     call, index_add_, goes from the kernel's own inputs to a fresh table:
     index_add_call); K2 through its wrapper bit for bit against the
     row-order sum (row_order_sum, tolerance 0) here and at every later K2
     call of a path, each logged with its index_add_call factor, its bound
     and the share of its 128-cell tiles that hold a row;
  3. the model's test_forward (eval BatchNorm) through the kernels (launch
     counters must move), then again with the plain versions swapped in:
     the outputs must agree; the tiny config's canvas on the card against
     the CPU path;
  4. 10 timed iterations of each path (scans/s) and a profile of the
     kernel path, with cuDNN autotuning on as a server would run;
  5. training (train BatchNorm, the config's Adam, clip and StepDecay):
     from one saved state, one train step through the kernels (all five
     counters must move; K2 held at the step's call) and one on the plain
     versions (none may): losses, grads and running stats must agree; the
     tiny config's train step on
     the card against the CPU path; 10 steps on the fixed batch (finite
     losses, the last below the first); train scans/s of both paths; peak
     memory and a profile of one step;
  6. CenterPoint-nuScenes serving: test_forward through the kernels (the
     two-layer K1 and K6 counters must move, K2's must not; pillars before
     and after the max_voxels cap, the longest segment and the boxes NMS
     keeps are logged), then on the plain versions (the outputs must
     agree); 10 timed iterations of each path (scans/s), peak memory, a
     profile and the time of each stage of the forward;
  7. CenterPoint-voxels nuScenes serving: the sparse conv kernel (K8) at
     each of the nine conv shapes of the path, given the neighbour map the
     path hands it and building its own, bit-equal to its plain version;
     its map kernel at each of the forward's eight map builds, equal to
     neighbour_map; the dense row-major sum (K7) at the dense BEV's, on
     the inputs a forward hands them, against its plain version and bit
     for bit against the row-order sum and a second call, and on random
     keys bit for bit against the row-order sum;
     test_forward through the kernels (21 K8 conv and 8 map launches, one
     K7, no K2) and on the plain versions (canvas, head outputs and
     decoded boxes must agree); timing, memory, a profile and the time of
     each stage;
  8. PV-RCNN then Voxel-RCNN KITTI serving: the ball query (K9) at each of
     its call shapes and farthest-point sampling (K10) on the inputs a
     forward hands them, against their plain versions (indices and counts
     equal; K9 logged with the tests of the first kernel's walk, the tests
     the culled kernel runs and the in-ball points its bound counts, the
     share of chunks its boxes skip and of points its block boxes mark,
     failing if a skipped chunk or an unmarked point holds a hit (ball_work,
     from ops/ball_query.cull_plain); K10 also at every cluster size that
     holds the scan, logged with
     its plan, us a step and chain floor: the same picks over one point a
     thread of the chosen cluster); K8 at the forward's 8 convs and 7 map
     builds (bit-equal, index-equal); test_forward through the kernels
     (PV-RCNN: 7 K9 launches, one K10, 8 K8 conv and 7 map launches and one
     row-major segment sum, K2 or K7 as the density rule picks; Voxel-RCNN:
     2 K9, no K10) and on the plain versions (BEV, keypoints, proposals and
     outputs must agree); no valid stage voxel
     outside its grid; timing, memory, a profile and the time of each
     stage;
  9. IA-SSD KITTI serving: K10 at its three call shapes and K9 at its ten,
     against plain; test_forward through the kernels (10 K9 launches, 3
     K10) and on the plain versions; timing, memory, a profile and the time
     of each stage;
 10. CenterPoint-pillars nuScenes training (the config's OneCycleAdam,
     clip 35 and OneCycleWarmupDecayLr; bench.make_gt's boxes): the
     segmented window max (K12) forward and backward at both PFN layers'
     shapes, on the inputs a train step hands them, against their plain
     versions (values, offsets, gradients equal bit for bit), with the
     share of (row, step) pairs the forward works on and the in-segment
     probes a row the backward makes, from the step's keys; K7 on the
     step's canvas rows (8 x 250,000 x 64 onto 512 x 512 cells) bit for
     bit against the row-order sum and a second call, timed with its
     index_add_call yardstick and its bound; one train step
     through the kernels (2 K12 forward, 2 K12 backward, one K7, one K5
     launch; no K1, K2, K3, K4 or K6) against one on the plain versions
     from the same state; the tiny two-layer train step on the card
     against the CPU; 10 steps with finite losses that fall; train scans/s
     of both paths, peak memory, a profile and the time of each stage;
 11. two-stage KITTI training (the configs' AdamWOnecycle, clip 10 and
     OneCycle; the RPN head from the upstream init; bench.make_gt's boxes,
     half of them the model's own first proposals, jittered; 20 warm-up
     steps on them before what follows): the rotated-box intersection
     kernel (K11) bit for bit against its plain version on the train step's
     own corners, at 8 x 1,000 x 1,000 clustered boxes and on a tie
     lattice, with its chain floor (one launch on one clipped pair); one
     Voxel-RCNN train step through the kernels (one K11, two
     K9 held as in phase 8, the dense BEV's segment sum, K2 held at its
     call, and its VJP; no
     K8: training takes the gather route) against one on the plain
     versions from the same state
     and sampler seed (targets equal, losses, grads, running stats); 10
     steps with finite losses that fall and fg / hard-bg / easy-bg pools
     that are non-empty at every step (logged beside the same steps on
     the plain versions when one is empty), run twice from one state:
     losses and pools equal bit for bit. The warm-up, the compared steps
     and the 10 steps run under torch's deterministic mode with
     deterministic cuDNN, so every run takes the same trajectory; train
     scans/s of both paths, peak
     memory, a profile and the time of each stage; then PV-RCNN: 3 steps
     with finite losses (K10 and K11 each step; the first step's K10 call
     and 7 K9 calls held as in phase 8), its train scans/s, memory, profile
     and stages;
 12. the row-window channel-major segment sum (K13), which no model path
     reaches, and the row gather (K14) as ops: each called once at two
     shapes through its entry point (K13's launches the record counts), K13
     at tools/bench_scatter_rw.py's 8 x 250,000 x 64 onto 512 x 512 cells
     and at 2 x 5,000 x 64 onto 4,096, bit-equal to the row-order sum (its
     plain version) and to K6, within 1e-5 of index_add_; K14 at
     8 x 1,000 x 7 from 107,136 and 4 x 120,000 x 64 from 160,000, equal to
     its plain version and to torch.gather; kernel, plain and library times
     (each library call from the kernel's own inputs: K13's index_add_
     makes the targets, the zeroed table and the transposed rows inside
     its timing, torch.gather its int64 index), the kernel / library
     factor and bounds; K13 launches K6's kernel;
 13. CenterPoint-voxels nuScenes training (the config's OneCycleAdam, clip
     35 and OneCycleWarmupDecayLr; bench.make_gt's boxes): one train step
     through the kernels (the dense BEV's K2 or K7, as the density rule
     picks, held at its call, and its VJP K5; nothing else: the sparse
     convs train on the gather route) against one on the plain versions
     from the same state
     (targets equal, losses, grads, running stats); 10 steps with finite
     losses that fall; train scans/s of both paths, peak memory, a profile
     and the time of each stage;
 14. IA-SSD KITTI training (the config's AdamWOnecycle, clip 10 and
     OneCycle; bench.make_gt's boxes): one train step through the kernels
     (10 K9, 3 K10, all held as in phase 9) against one on
     the plain versions from the same state;
     10 steps with finite losses that fall; train scans/s of both paths,
     peak memory, a profile and the time of each stage;
 15. SMOKE KITTI (DLA-34, 3 classes, 256-channel heads, 50 detections) at
     tools/bench_camera.py's 384 x 1280 images and intrinsics:
     test_forward at batch 1 and 8 through the kernels (one K14 launch a
     forward, nothing else; the decode reads the NCHW regression map in
     place) and on the plain versions (every output equal by bit
     pattern); K14 at both decode calls bit for bit against its plain
     version and a second call, timed through its wrapper and alone,
     beside torch.gather, its byte bound and its chain floor (one
     launch on one float); frames/s of both paths at batch 1 and 8, peak
     memory,
     a profile at batch 8; training at batch 8 (the config's Adam and
     PiecewiseDecay, targets from the port's Gt2SmokeTarget; no kernel
     launches: the loss gathers with torch.gather under autograd), 10
     steps with finite losses that fall (train frames/s and peak memory:
     phase 29's Trainer run of the config);
 16. CADDN KITTI (HRNet-W18 + OCRNet, 80 LID bins, BEV 376 x 280 x 64,
     CenterHead of 3 classes, NMS pre 1,000 / post 100) at 384 x 1248
     under a KITTI camera (caddn_camera: f = 721.5, the principal point at
     the centre, KITTI's lidar -> camera axes and offsets; the share of
     frustum rows in the grid and the most rows of a cell and of a
     512-cell span logged): test_forward at batch 1 and 4 through the
     kernels (one K7 a forward: the frustum pool of 2,396,160 rows a
     frame onto 105,280 cells, dense by the density rule; nothing else)
     and on the plain versions (labels equal, the pooled BEV, scores and
     boxes within CADDN_TOL); K7 at both pools bit for bit against the
     row-order sum and a second call, timed through its wrapper and alone
     beside index_add_call and its bound (in-grid rows only) and its
     plain version; the tiny config's test_forward on the card (its pool
     of 192 rows onto 32 x 32 cells is sparse: one K2, held bit for bit)
     against the CPU (CADDN_TINY_TOL); frames/s of both paths at batch 1
     and 4, at batch 4 peak memory and a profile (caddn_stages, the time
     of each stage, by hand); training at batch 4 (the config's AdamWOnecycle, clip
     10 and OneCycle; 8 boxes an image in range and in view, depth maps
     at the feature stride): one step through the kernels (one K7, one
     K5, nothing else) against one on the plain versions from the same
     state, both in torch's deterministic mode (whose index_add_ adds in
     row order: the pooled BEVs bit-equal, so K7 is held at the step's
     pool; losses, grads, running stats compared), K5 held at its VJP (bit
     for bit against its plain version and a second call, timed through
     its wrapper and alone beside torch.gather and its bound); its falling
     losses, train frames/s and peak memory are phase 29's Trainer run of
     the config.
 17. PETR and PETRv2 (VoVNet-99-eSE, CPFPN 768 / 1024 -> 256, 900
     queries, 6 decoder layers, 8 heads, 64 LID bins, 10 classes) at 320 x
     800 under petr_rig (tools/bench_camera.py's six-camera ring, its
     intrinsics for [0, 1] image coordinates; PETRv2's previous frame
     0.5 m behind); PETR reaches no hand-written kernel: test_forward of
     PETR at batch 1 and 2 and of PETRv2 at batch 1, each twice (outputs
     equal by bit pattern, no launch counter moves); the tiny config's
     test_forward on the card against the CPU (PETR_TINY_TOL); frames/s,
     GFLOP a frame by module, peak memory, a profile and the stage times
     (backbone, neck, tokens + position embedding, decoder with its self-
     and cross-attention apart, decode); training PETR at batch 2 (the
     config's AdamW, clip 35 and CosineDecay; 8 boxes a frame in range and
     in view, two padded slots): one step, no launch, a host match a
     decoder layer (its falling losses, train frames/s and memory: phase
     30's Trainer run of the config); one train step each of PETRv2 with
     query denoising and of PETRv2-BEVseg at batch 1, finite losses and
     grads.
 18. BEVFormer-tiny (ResNet-50 to C5, FPN 2048 -> 256, a 50 x 50 BEV of
     256 channels, 3 encoder layers of temporal self-attention and
     spatial cross-attention on ops/ms_deform_attn, 900 queries, 6
     decoder layers with box refinement) under bevformer_rig (petr_rig's
     pixel lidar2img divided by the image size; the share of BEV queries
     some camera sees logged), the sampling offsets given seeded weights;
     BEVFormer reaches no hand-written kernel: two consecutive frames at
     batch 1 (the second with the first's bev_feature and a can_bus, so
     that the rotation and the shift run), each twice (outputs equal by
     bit pattern, no launch counter moves); the tiny model on the card
     against the CPU over two frames (BEVFORMER_TINY_TOL); frames/s, GFLOP
     a frame by module, peak memory, a profile and the stage times
     (backbone + FPN, the encoder with its TSA and SCA apart, the
     decoder, predict); training at batch 1 with a one-frame history queue
     (the config's AdamW, clip 35, CosineDecay; petr_gt's boxes): two steps
     from one state in deterministic mode, bit-equal; 10 steps in
     deterministic mode with finite losses that fall; train frames/s, peak
     memory, a profile, the
     Hungarian matches' host time.
 19. BEVDet4D (ResNet-50 to C4, the LSS view transformer of 59 depth bins
     onto 128 x 128 cells of 64 channels, the previous frame's BEV,
     CustomResNet + FPN_LSS, CenterHead of 10 classes, NMS 1,000 / 500)
     under bevdet_rig (tools/bench_camera.py's ring through the
     ResizeCropFlipImage test transform; the frustum's in-grid share
     logged): serving at batch 1 and 8 with a prev_bev state through the
     kernels (one K7 a forward: 249,216 rows a frame onto 16,384 cells,
     dense by the density rule; nothing else) and on the plain versions,
     both in deterministic mode (index_add_ in row order: every output
     equal by bit pattern); K7 at both pools bit for bit against the
     row-order sum and a second call, timed through its wrapper and alone
     beside index_add_call and its bound (in-grid rows); the tiny model on
     the card (one K7 a forward, held the same way) against the CPU
     (BEVDET_TINY_TOL); frames/s of both paths, GFLOP a frame, peak
     memory, a profile and the stage times (backbone, depth net, frustum
     ranks, sort, row rebuild, K7, BEV encoder + neck, head convs, decode
     + NMS); training at batch 8 with an adjacent frame (the config's
     AdamW, clip 5, CosineDecay): one step through the kernels (K7 twice,
     the adjacent frame's pool without gradient too, and one K5) against
     one on the plain versions from the same state in deterministic mode
     (the pooled BEVs, losses, grads and running stats bit-equal), K5
     held and timed at the step's VJP (its falling losses, train frames/s
     and memory: phase 30's Trainer run of the config).
 20. CAPE and CAPE-T (phase_cape): CAPE at batch 1 and 2 and CAPE-T at
     batch 1 served twice (bit-equal, no launch counter moves); CAPE-T
     training at batch 2 (DN queries, the previous stream's aux loss):
     two steps from one state in deterministic mode, 10 steps in
     deterministic mode with finite losses that fall; the VoVNet-99
     CAPE-T config served once; the tiny CAPE-T card vs CPU.
 21. RTEBev (phase_rtebev): serving 1f at batch 1 and 4 with the first
     frame's own BEV as bev_adj (one K7 a forward, kernel vs plain path
     bit-equal), K7 held and timed with its skew, 4f served at batch 1;
     training at batch 4 with an adjacent frame and a projected gt_depth
     (two K7 and one K5 a step, kernel vs plain step bit-equal, K5 held
     and timed), 10 steps in deterministic mode with finite losses that
     fall, one 4f step (five K7); the tiny model card vs CPU.
 22. BEVFusion (phase_bevfusion): the L+C config serving at batch 1 and 2
     through the kernels (the [V, P, C] hard voxelization and buffer PFN,
     the pillar scatter on K2 as the density rule picks for 40,000 pillars
     on 400 x 400 cells, the LSS pool on K7: one of each a forward) and on
     the plain versions in deterministic mode (every output equal by bit
     pattern); K2 and K7 held bit for bit at both calls and timed; the
     lidar-only (one K2) and camera-only (one K7) configs at batch 1; the
     tiny model card vs CPU (a K2 and a K7); frames/s of both paths, GFLOP,
     memory, profiles, stages; training at batch 2 with img_depth from
     each frame's own scan (bevfusion_img_depth, the dataset's math): a
     step through the kernels (K2, K7, two K5) against one on the plain
     versions from the same state, bit-equal; K5 held and timed at both
     VJPs (its falling losses, train frames/s and memory: phase 30's
     Trainer run of the config).
 23. DD3D (phase_dd3d): both KITTI configs serving at batch 1 and 8 (no
     launch counter moves); frames/s, GFLOP, memory, profiles, stages;
     the tiny model card vs CPU; the DLA-34 config training at batch 8 on
     dd3d_gt's projected boxes, 10 falling losses, train frames/s,
     memory, profile.
 24. SqueezeSegV3 (phase_squeezeseg): RangeNet-21 and -53 serving at
     batch 1 and the configs' batch (4, 2) on range_batch's 64 x 2,048
     images (120,000-point sweeps through the port's range projection and
     the configs' normalisation; no launch counter moves), frames/s,
     GFLOP by module, memory, profiles, stages (each SAC block); the tiny
     config card vs CPU; RangeNet-21 training at batch 4 (SGD, clip 10,
     LinearWarmup over StepDecay: the first step at rate 0, the 10
     falling steps past the warm-up), train frames/s, memory, profile;
     RangeNet-53 training at batch 2.
 25. PAConv (phase_paconv): serving at batch 1 and 32 on primitive_clouds
     of 1,024 points (no launch), assign_score_withk at each layer's call
     against the JAX order (PACONV_ASSIGN_TOL), both timed; frames/s,
     GFLOP, memory, profiles, stages; the tiny config card vs CPU;
     training at batch 32 (SGD, clip 10, CosineDecay), 10 falling losses,
     train frames/s, memory, profile.
 26. BEV-LaneDet (phase_lanedet): serving at batch 1 and 16 on 576 x 1,024
     uniform-pixel images with the identity bev_grid (no launch),
     frames/s, GFLOP, memory, profiles, stages (backbone, reduce, warp,
     BEV convs, heads); a small model card vs CPU; training at batch 16
     on lane_batch's rasterised lanes (AdamW, clip 35, CosineDecay), 10
     falling losses, train frames/s, memory, profile.
 27. The runtime (phase_runtime), tools/train.py's path through the
     port's own modules: a KITTI tree of 16 train and 8 val frames in a
     temp dir (kitti_tree: bench.make_scans scans, 6-10 cars a frame with
     a share of the points on them, labels through the port's kitti_utils,
     no images), Config(dic=...) of the KITTI car config, a Trainer at the
     config's batch (2) with its Adam, clip and StepDecay, an EMA, 4
     loader threads, do_eval and a checkpoint every 8 of 16 steps: the
     step count, the checkpoint queue and records, finite losses whose
     mean over the last four steps is under the first four's, the
     kernels once a step (K1, K3, K4, K5 and the scatter) and once an
     eval forward (K1 and the scatter; the counters split by evaluate()
     call), the scatter by the density rule on collate_lidar's 120,000
     rows a scan: K7 in train, K6 in serving; peak memory; a second Trainer(resume=True) on other
     random weights restores the model, the optimizer moments, the LR
     schedule and the EMA bit for bit, at the uninterrupted rate;
     evaluate() through postprocess_to_samples and KittiMetric, timed in
     parts (device forward, postprocess, metric), its AP dict printed; the
     val ground truths given as predictions with score 1 score 100 AP on
     Car 3-D and BEV "easy" (R11 and R40); a NaN-padded train step
     bit-equal to the same batch padded out of range (kernel path,
     deterministic mode); what the runtime costs, in windows of 10 steps
     inside one epoch of a 40-frame tree (no epoch start, no pool
     shutdown): the Trainer's scans/s at 4 and 1 loader threads and on
     prebuilt batches against the bare train step, the host time of each
     step call, the reader's wait a step in the windows and at epoch
     starts, the loader alone, the host-to-device copy and a profiled
     window; and `python -m paddle3d_tpu_torch.tools.train
     --iters 4` and `tools.evaluate` on its checkpoint as subprocesses,
     both exiting 0 with the kernel library loaded, not rebuilt.
 28. The runtime's other LiDAR configs (phase_lidar_runtime), each leg
     through Config(dic=...) -> Trainer -> DataLoader -> dataset ->
     transforms -> train steps -> evaluate() -> the dataset's metric on a
     tree written under a temp dir from the seed (real scan and object
     sizes, few frames): (a) PV-RCNN-KITTI (three classes) on a GT-paste
     database built by `python -m
     paddle3d_tpu_torch.tools.create_det_gt_database` as a process
     (pastes of every class, each pasted object's points in its box),
     KittiMetric finite for all three classes; (b)
     CenterPoint-pillars-KITTI; (c) CenterPoint-pillars nuScenes 10-sweep
     at batch 4 on a database with velocities (pasted boxes carry their
     entries' velocities, some moving), NuScenesMetric; (d) IA-SSD-Waymo,
     WaymoMetric. On every leg: the loader's first two batches equal at 1
     and 4 threads, the launch counters of the Trainer's steps and of
     evaluate()'s forwards equal to the routes the density rule gives the
     batch's rows (pillars) or the dense BEV's recorded rows (PV-RCNN),
     Trainer scans/s in a window of 3 steps against the bare step, the
     database's and the metric's seconds, peak memory;
 29. the runtime's camera path: a KITTI tree with image_2/ (kitti_tree's
     images: the frames' objects rendered through P2 over a textured
     background, PNGs written by png_bytes with zlib alone, every filter
     type in turn across the rows; most frames 1242 x 375, every fourth
     1224 x 370 or 1241 x 376): every image read back by the port's
     decoder equal to the array written, the native unfilter byte-equal
     to the plain one on an image of each size; the loader's host work a
     sample by part (decode, resize, targets, normalize; CADDN's depth
     map); SMOKE-KITTI (configs/smoke/smoke_dla34_no_dcn_kitti.yml, batch
     8: KittiMonoDataset, LoadImage, Gt2SmokeTarget with its flips,
     Normalize) and CADDN-KITTI (the HRNet-W18 + OCR config, batch 4:
     KittiDepthDataset) through Config, Trainer, DataLoader, evaluate() and
     KittiMetric / KittiDepthMetric: the loader's first two batches equal
     at 1 and 4 threads, a Trainer run inside one epoch with finite,
     falling losses, the launch counters against the routes derived from
     the recorded pools (SMOKE: none a step, K14 a forward; CADDN: K7 and
     K5 a step, K7 a forward), Trainer frames/s at 4 and 1 threads and on
     prebuilt batches against the bare step, evaluate() by part, peak
     memory; then the three synthetic camera tiny configs (SMOKE, CADDN,
     PETR) through the Trainer and evaluate() (the tiny CADDN's pool on
     K2, K5 a step), the tiny SMOKE's evaluate() on the card against the
     CPU within SMOKE_TINY_TOL.
 30. the nuScenes multi-view and Apollo camera runtime: phase 28's
     nuScenes tree with six 1600 x 900 cameras a key frame (4:2:0
     baseline JPEGs from jpeg_bytes, numpy alone: the card's machine has
     no Pillow; NUSC_CAM_VARIANTS distinct images a camera, hard-linked
     in turn over the frames), `prev` links between key frames and BEV maps for
     PETRv2-BEVseg, and an Apollo tree of 1080 x 1920 JPEGs; the port's
     native JPEG decoder byte-equal to its plain one on a small image of
     every supported form and on a full view, its ms a view; BEVDet4D
     (batch 8, an adjacent frame), PETR (batch 2, the full multi-view
     pipeline with GridMask, on the fixed path) and BEVFusion L+C (batch
     2) each through Config, Trainer, DataLoader, evaluate() and
     NuScenesMetric: the loader's first batch equal at 1 and 4 threads,
     the loader's ms a sample by stage (decode, BICUBIC resize,
     transforms, depth map), a Trainer run with finite losses, the last
     under the first, launches equal to the routes the density rule gives
     the recorded pools (K7 / K2 a pool, K5 a pool with a gradient), K2 /
     K7 and K5 held at the run's first calls, Trainer frames/s at 4 and 1
     threads and on the run's own batches prebuilt against the bare
     step, evaluate() by part with its launches, peak memory; BEVFormer,
     CAPE-T, RTEBev (with_depth), PETRv2-BEVseg (NuScenesSegMetric),
     BEVFusion's camera config and BEV-LaneDet (ApolloLaneMetric) a
     Trainer step and an evaluate() batch each, launches as derived.

The seconds of every phase are logged before the record lines. Since
phases 22 and 23 came, the timing loops of phases 4-10, 13 and
15-17 run fewer iterations; since phases 24-26 came, fewer again (ITERS
6, CP_TRAIN_ITERS, TS_TRAIN_ITERS, VX_TRAIN_ITERS and IA_TRAIN_ITERS 4,
SMOKE_ITERS 6, CADDN_ITERS, CADDN_TRAIN_ITERS, PETR_ITERS and
PETR_TRAIN_ITERS 4); since phase 27 came, fewer again where a plain path
takes a second or more a call: ITERS 2 (phases 4-9's serving halves and
phase 5's train timing, one call a half), TS_TRAIN_ITERS, VX_TRAIN_ITERS,
IA_TRAIN_ITERS, CADDN_ITERS, CADDN_TRAIN_ITERS and BEVF_ITERS 2; since
phase 28 came, fewer again: SMOKE_ITERS and SMOKE_TRAIN_ITERS 6 -> 4,
BEVFORMER_ITERS, BEVDET_ITERS and RTEBEV_ITERS 6 -> 4, and CP_TRAIN_ITERS,
PETR_ITERS, PETR_TRAIN_ITERS, BEVFORMER_TRAIN_ITERS, BEVDET_TRAIN_ITERS,
RTEBEV_TRAIN_ITERS, BEVF_TRAIN_ITERS, DD3D_ITERS, DD3D_TRAIN_ITERS,
SSG_ITERS, SSG_TRAIN_ITERS, PACONV_ITERS, PACONV_TRAIN_ITERS, LANE_ITERS
and LANE_TRAIN_ITERS 4 -> 2 (one step or forward a half), and profile()
traces the device's activity alone (the host's ops made reading a trace
~4 s longer); since phase 29 came, phases 15 and 16 leave their train
timing, peak memory and train profile to phase 29's Trainer runs of the
same configs (phase 16 its ten falling steps too: phase 29 checks that the
config's losses fall through the Trainer; phase 15 its tiny card-vs-CPU
forward: phase 29 holds the tiny config's evaluate() on the card to the
CPU's within the same SMOKE_TINY_TOL), trace at the configs' batches only,
no longer time CADDN's stages (caddn_stages, by hand) and take CADDN's work
a frame as the constant CADDN_GFLOP; phase 29's tree is written beside
phase 28's database processes; since phase 30 came, phases 17, 19 and 22
leave their ten falling steps, train timing, peak memory and train
profile to phase 30's Trainer runs of the same configs (BEVDET_TRAIN_ITERS
and BEVF_TRAIN_ITERS went; PETR_TRAIN_ITERS stays CAPE-T's), and phase
30's trees are written with phase 28's; no other check changed.

The last two lines are the kernels' JSON record (K2, K5 and K7 at CADDN's
calls, K7 and K5 at BEVDet4D's and at RTEBev's, and K2, K7 and both K5
at BEVFusion's in entries of their own, each with a "path" key, after
the entries of their earlier paths) and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --parts TREE [TREE ...]

times, in one process a checkout (TREE: a directory holding the package,
e.g. a `git archive` of another commit), the row gather (K14) at
gather.py's 8 x 1,000 x 7, a voxel-row gather's 4 x 120,000 x 64,
SMOKE's decode (8 x 50 rows of 10 from the NCHW map, read in place) and
8 x 100,000 rows of 3, each through its wrapper and its C entry alone
(parts_one); list parent,
change, change, parent to compare two trees on one card.
f32 throughout, with TF32 off for convolutions and matmuls; deterministic
cuDNN for the comparisons; phase 11's checked steps under
torch.use_deterministic_algorithms (main() sets CUBLAS_WORKSPACE_CONFIG
for it).
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
KITTI = os.path.join(REPO, "configs", "pointpillars",
                     "pointpillars_xyres16_kitti_car.yml")
TINY = os.path.join(REPO, "configs", "pointpillars",
                    "pointpillars_synthetic_tiny.yml")
NUSCENES = os.path.join(REPO, "configs", "centerpoint",
                        "centerpoint_pillars_02voxel_nuscenes_10sweep.yml")
VOXELS = os.path.join(REPO, "configs", "centerpoint",
                      "centerpoint_voxels_0075voxel_nuscenes_10sweep.yml")
PV_RCNN = os.path.join(REPO, "configs", "pv_rcnn",
                       "pv_rcnn_005voxel_kitti.yml")
VOXEL_RCNN = os.path.join(REPO, "configs", "voxel_rcnn",
                          "voxel_rcnn_005voxel_kitti_car.yml")
IASSD = os.path.join(REPO, "configs", "iassd", "iassd_kitti.yml")
SMOKE_KITTI = os.path.join(REPO, "configs", "smoke",
                           "smoke_dla34_no_dcn_kitti.yml")
SMOKE_TINY = os.path.join(REPO, "configs", "smoke", "smoke_synthetic_tiny.yml")
BATCH, POINTS, SEED, ITERS, TRAIN_STEPS = 8, 20000, 0, 2, 10
TS_BATCH = 4            # bench.py's batch for pv_rcnn and iassd
CP_POINTS = 250000
VX_BATCH = 4            # bench.py's batch for centerpoint_voxels
SENT = 2**31 - 1
# iterations a profile traces: the tracer costs ~9 s an iteration of the
# ~16,000-launch NMS-bound forwards on the card's host, so one
PROFILE_ITERS = 1

# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): HBM bytes/s, and
# f32 / f64 FLOP/s outside the tensor cores
HBM_BYTES_S, F32_FLOP_S, F64_FLOP_S = 3.35e12, 67e12, 34e12

# kernel -> (source, replaced TPU kernel, tolerance against the plain
# version). K1 runs the plain version's arithmetic in the same order
# (bit-equal by design: compared by bit pattern, tolerance 0, at both of
# its calls, and to a second call), K5 is a gather (exact); K3/K4 sum ~1e5
# exact f64 products in another order, so their tolerance is relative:
# max |kernel - plain| <= tol * max |plain|, per output.
KERNELS = {
    "fused_pfn_rows": ("paddle3d_tpu_torch/csrc/fused_pfn.cu",
                       "paddle3d_tpu/ops/pallas/fused_pfn.py:133", 0.0),
    # K2 adds each cell's rows in row order from +0: bit-equal to
    # row_order_sum at every call, tolerance 0
    "sorted_segment_sum": ("paddle3d_tpu_torch/csrc/sorted_scatter.cu",
                           "paddle3d_tpu/ops/pallas/sorted_scatter.py:54",
                           0.0),
    "pfn_stats": ("paddle3d_tpu_torch/csrc/fused_pfn_train.cu",
                  "paddle3d_tpu/ops/pallas/fused_pfn_train.py:54", 1e-9),
    "pfn_bwd": ("paddle3d_tpu_torch/csrc/fused_pfn_train.cu",
                "paddle3d_tpu/ops/pallas/fused_pfn_train.py:102", 1e-9),
    "sorted_table_gather": ("paddle3d_tpu_torch/csrc/sorted_scatter.cu",
                            "paddle3d_tpu/ops/pallas/sorted_scatter.py:1315",
                            0.0),
    # the two-layer branch of K1 (bit-equal by design: compared by bit
    # pattern, tolerance 0) and K6, which adds each cell's rows in row order
    # from +0: bit-equal to row_order_sum, tolerance 0
    "fused_pfn_rows_2l": ("paddle3d_tpu_torch/csrc/fused_pfn.cu",
                          "paddle3d_tpu/ops/pallas/fused_pfn.py:156", 0.0),
    "sorted_segment_sum_cm": ("paddle3d_tpu_torch/csrc/sorted_scatter.cu",
                              "paddle3d_tpu/ops/pallas/sorted_scatter.py:568",
                              0.0),
    # K7, which adds each cell's rows in row order from +0: bit-equal to
    # row_order_sum at both of its calls and on random keys, tolerance 0;
    # K8, whose plain version repeats its products and sums in its order:
    # bit-equal; K8's neighbour map is indices, equal to its plain version
    "sorted_segment_sum_dense": (
        "paddle3d_tpu_torch/csrc/sorted_scatter.cu",
        "paddle3d_tpu/ops/pallas/sorted_scatter.py:396", 0.0),
    "sparse_conv3d": ("paddle3d_tpu_torch/csrc/sparse_conv.cu",
                      "paddle3d_tpu/ops/pallas/sparse_conv.py:60", 0.0),
    "sparse_conv3d_map": ("paddle3d_tpu_torch/csrc/sparse_conv.cu",
                          "paddle3d_tpu/ops/pallas/sparse_conv.py:60", 0.0),
    # K9 and K10 give indices (and counts): equal to their plain versions,
    # whose distance arithmetic they repeat in its order
    "ball_query": ("paddle3d_tpu_torch/csrc/ball_query.cu",
                   "paddle3d_tpu/ops/pallas/ball_query.py:50", 0.0),
    "farthest_point_sample": ("paddle3d_tpu_torch/csrc/fps.cu",
                              "paddle3d_tpu/ops/pallas/fps.py:38", 0.0),
    # K12: maxes and offsets compared, and the backward adds in the plain
    # version's order: bit-equal
    "seg_window_max": ("paddle3d_tpu_torch/csrc/seg_window.cu",
                       "paddle3d_tpu/ops/pallas/seg_window.py:57", 0.0),
    "seg_window_max_bwd": ("paddle3d_tpu_torch/csrc/seg_window.cu",
                           "paddle3d_tpu/ops/pallas/seg_window.py:113", 0.0),
    # K11 rounds every operation in its plain version's order: bit-equal
    "pairwise_intersection_area": ("paddle3d_tpu_torch/csrc/iou_clip.cu",
                                   "paddle3d_tpu/ops/pallas/iou_clip.py:36",
                                   0.0),
    # K13, K6's kernel, adds each cell's rows in row order, as its plain
    # version does: bit-equal; K14 copies rows: equal
    "sorted_segment_sum_rw": ("paddle3d_tpu_torch/csrc/sorted_scatter.cu",
                              "paddle3d_tpu/ops/pallas/sorted_scatter.py:860",
                              0.0),
    "gather_rows": ("paddle3d_tpu_torch/csrc/gather.cu",
                    "paddle3d_tpu/ops/pallas/gather.py:25", 0.0),
}
INFER_KERNELS = ("fused_pfn_rows", "sorted_segment_sum")
TRAIN_KERNELS = INFER_KERNELS + ("pfn_stats", "pfn_bwd",
                                 "sorted_table_gather")
CP_KERNELS = ("fused_pfn_rows_2l", "sorted_segment_sum_cm")
VX_KERNELS = ("sparse_conv3d", "sparse_conv3d_map",
              "sorted_segment_sum_dense")
PT_KERNELS = ("ball_query", "farthest_point_sample")
SW_KERNELS = ("seg_window_max", "seg_window_max_bwd")
# a CenterPoint-pillars train step: K12 both ways, K7 (the dense scan) and
# its VJP K5, and none of the eval or one-layer kernels
CPT_LAUNCHES = {"seg_window_max": 2, "seg_window_max_bwd": 2,
                "sorted_segment_sum_dense": 1, "sorted_table_gather": 1,
                "fused_pfn_rows": 0, "fused_pfn_rows_2l": 0,
                "sorted_segment_sum": 0, "pfn_stats": 0, "pfn_bwd": 0,
                "sorted_segment_sum_cm": 0}


class PhaseError(RuntimeError):
    pass


_START = time.perf_counter()


def log(msg):
    """Print a line; a phase's first line ("phase N: ...") leads with the
    seconds since the script started."""
    if msg.startswith("phase "):
        msg = "[{:.0f} s] {}".format(time.perf_counter() - _START, msg)
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters launches (CUDA events, after a
    warm-up launch)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, f32_ops=0, f64_ops=0):
    """The least time (ms) the card could take for work that moves nbytes
    and does the given operations: -> (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = (f32_ops / F32_FLOP_S + f64_ops / F64_FLOP_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_bytes(keys, cells, c, out_numel):
    """Bytes a sorted segment sum must move: the keys, the c channels of
    every row whose key lies in [0, cells) (the kernels never read the
    others) and the table written, once each."""
    inside = int(((keys >= 0) & (keys < cells)).sum())
    return 4 * (keys.numel() + inside * c + out_numel)


def index_add_call(keys, rows, cells, channel_major=False):
    """The library yardstick of a sorted segment sum (K2, K6, K7, K13): one
    index_add_ that goes from the kernel's own inputs to a fresh table, as
    the kernel does. Inside the call that is timed: the flattened int64
    targets (keys outside [0, cells) to a dump row a scan), the zeroed
    table [B * (cells + 1), C] and, for channel-major rows [B, C, N], their
    transposed copy. -> fn() giving that table."""
    import torch

    def call():
        b = keys.shape[0]
        r = rows.transpose(1, 2) if channel_major else rows
        c = r.shape[-1]
        inside = (keys >= 0) & (keys < cells)
        tgt = (torch.where(inside, keys, cells).long() + torch.arange(
            b, device=keys.device)[:, None] * (cells + 1)).reshape(-1)
        return torch.zeros((b * (cells + 1), c), device=keys.device
                           ).index_add_(0, tgt, r.reshape(-1, c))
    return call


def row_order_sum(keys, rows, cells):
    """The segment sum of sorted keys [B, N] and rows [B, N, C] with each
    cell's rows added one at a time in row order from +0, as K2, K6, K7 and
    K13 add them: those kernels must agree with it bit for bit (index_add_
    adds through atomics, in an order that changes from run to run)."""
    import torch
    b, n, c = rows.shape
    keys = keys.long()
    inside = (keys >= 0) & (keys < cells)
    rank = torch.arange(n, device=keys.device) - torch.searchsorted(keys,
                                                                     keys)
    out = torch.zeros((b, cells, c), dtype=rows.dtype, device=rows.device)
    batch = torch.arange(b, device=keys.device)[:, None].expand(b, n)
    for j in range(int(rank[inside].max()) + 1 if inside.any() else 0):
        m = inside & (rank == j)        # at most one row a cell
        out[batch[m], keys[m]] += rows[m]
    return out


def segments(keys, P, maxV):
    """Pillar statistics of sorted keys [B, N]: -> dict of per-scan pillar
    counts before and after the max_voxels cap, kept rows (at most P per
    pillar within the cap) and the longest segment (rows of one cell)."""
    import torch
    out = {"pillars": [], "capped": [], "kept": 0, "longest": 0}
    for row in keys:
        _, cnt = torch.unique_consecutive(row[row != SENT],
                                          return_counts=True)
        out["pillars"].append(int(cnt.numel()))
        out["capped"].append(min(int(cnt.numel()), maxV))
        out["kept"] += int(cnt[:maxV].clamp(max=P).sum())
        out["longest"] = max(out["longest"], int(cnt.max()))
    return out


@contextlib.contextmanager
def plain_path():
    """The model with every kernel of its paths swapped for its plain
    version (forward and backward): all but K13, which no model path
    reaches."""
    from paddle3d_tpu_torch.ops import ball_query, fps, fused_pfn, \
        fused_pfn_train, gather, iou_clip, pillar_ops, seg_window, \
        sorted_scatter, sparse_conv
    with mock.patch.multiple(gather, gather_rows=gather.gather_rows_plain), \
            mock.patch.multiple(
            iou_clip, pairwise_intersection_area=(
                iou_clip.pairwise_intersection_area_plain)), \
            mock.patch.multiple(
            seg_window, seg_window_max_fwd=seg_window.seg_window_max_plain,
            seg_window_max_bwd=lambda off, g, max_len, keys: (
                seg_window.seg_window_max_bwd_plain(off, g, max_len))), \
            mock.patch.multiple(
            ball_query, ball_query_batched=ball_query.ball_query_plain), \
            mock.patch.multiple(
                fps, farthest_point_sample_batched=(
                    fps.farthest_point_sample_plain)), \
            mock.patch.multiple(
                sparse_conv, sparse_conv3d=sparse_conv.sparse_conv3d_plain,
                sparse_conv3d_map=sparse_conv.neighbour_map), \
            mock.patch.multiple(
                fused_pfn, fused_pfn_rows=fused_pfn.fused_pfn_rows_plain), \
            mock.patch.multiple(
                fused_pfn_train, pfn_stats=fused_pfn_train.pfn_stats_plain,
                pfn_bwd=fused_pfn_train.pfn_bwd_plain), \
            mock.patch.multiple(
                sorted_scatter, scatter_rows=sorted_scatter.scatter_rows_plain,
                sorted_table_gather=sorted_scatter.sorted_table_gather_plain), \
            mock.patch.multiple(
                pillar_ops, sorted_segment_sum_cm=(
                    sorted_scatter.sorted_segment_sum_cm_plain)):
        yield


def make_points(device):
    import numpy as np
    import torch

    import bench
    _, n, (lo, hi), _ = bench.MODELS["pointpillars"]
    pts = bench.make_scans(np.random.default_rng(SEED), BATCH, n, lo, hi,
                           "clustered")
    check(pts.shape == (BATCH, POINTS, 4), "unexpected scan shape")
    return torch.from_numpy(pts).to(device)


def phase_build():
    from paddle3d_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    log("phase 1: kernels built in {:.1f} s into {}".format(
        time.perf_counter() - t0, os.path.relpath(_build.BUILD_DIR, REPO)))
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log("  ptxas: " + line.strip())


def phase_kernels(model, points):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn, pillar_ops, sorted_scatter
    vox, pfn, mid = model.voxelizer, model.pillar_encoder, \
        model.middle_encoder
    keys, pts_t = pillar_ops.sort_points_by_cell(points, vox.voxel_size,
                                                 vox.point_cloud_range)
    w1t, b1, _, _ = pillar_ops.pfn_folded_weights(pfn)
    kw = dict(n_layers=1, P=pfn.max_num_points_in_voxel,
              maxV=vox.max_num_voxels_for(False), nx=mid.nx, vx=pfn.vx,
              vy=pfn.vy, x_off=pfn.x_offset, y_off=pfn.y_offset,
              with_distance=pfn.with_distance, occupancy=True)
    check(tuple(w1t.shape) == (64, 9) and kw["P"] == 32 and
          kw["maxV"] == 40000, "not the KITTI PFN shapes")
    cells = mid.ny * mid.nx
    check(cells == 214272, "not the KITTI grid")

    rows_t, k1_err = k1_held("KITTI serving", keys, pts_t, w1t, b1, kw)
    rows = rows_t.transpose(1, 2).contiguous()
    check(tuple(rows.shape) == (BATCH, POINTS, 65), "K1 output shape")
    # K2 through the wrapper the canvas calls, held and timed by k2_call
    k2 = k2_call("KITTI serving", keys, rows, cells, True,
                 call=lambda: sorted_scatter.sorted_segment_sum_split(
                     keys, rows, cells))
    errs = {"fused_pfn_rows": k1_err, "sorted_segment_sum": k2[0]}
    times = {
        "fused_pfn_rows": (
            cuda_ms(lambda: fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1,
                                                     **kw), 50),
            cuda_ms(lambda: fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t,
                                                           b1, **kw), 10)),
        "sorted_segment_sum": (
            k2[1],
            cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
                keys, rows, cells, True), 10)),
    }
    log("phase 2: kernels vs plain at B={} N={} C_in=4 C_dec=9 u1=64 P=32 "
        "maxV=40000 cells={} C=65 (split), pillars emitted per scan {}"
        .format(BATCH, POINTS, cells,
                rows_t[:, -1].sum(dim=1).int().tolist()))
    # yardsticks: one PyTorch call for the same function where there is
    # one (index_add_ for K2, none for K1), and each kernel's bound
    seg = segments(keys, kw["P"], kw["maxV"])
    extra = {
        "fused_pfn_rows": (None,) + bound(
            4 * (keys.numel() + pts_t.numel() + rows_t.numel()),
            f32_ops=seg["kept"] * 2 * w1t.numel()),
        "sorted_segment_sum": k2[2:],
    }
    report(INFER_KERNELS, errs, times, extra)
    k1_parts("KITTI serving", keys, pts_t, w1t, b1,
             {k: v for k, v in kw.items() if k != "n_layers"})
    return errs, times, extra


def k1_held(label, keys, pts_t, w1t, b1, kw):
    """The one-layer K1 at one call of a path: bit for bit (by bit pattern)
    against its plain version and a second call. -> (its rows, the largest
    absolute difference from the plain version)."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn
    rows_t = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    again = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    ref_t = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, **kw)
    torch.cuda.synchronize()
    err = (rows_t - ref_t).abs().max().item()
    check(same_bits(rows_t, ref_t), "{}: the one-layer fused_pfn_rows "
          "differs from its plain version in its bits (max_abs_err "
          "{:.3e})".format(label, err))
    check(same_bits(again, rows_t), "{}: the one-layer fused_pfn_rows gave "
          "other bits on a second call".format(label))
    log("  K1 one layer at {}: bit-equal to its plain version and to a "
        "second call; pillars emitted per scan {}".format(
            label, rows_t[:, -1].sum(dim=1).int().tolist()
            if kw["occupancy"] else "(no occupancy channel)"))
    return rows_t, err


def report(names, errs, times, extra):
    """Log each kernel's error against its tolerance and its times; fail
    past the tolerance."""
    for name in names:
        tol = KERNELS[name][2]
        ms, plain_ms = times[name]
        lib_ms, bound_ms, bound_by = extra[name]
        log("  {}: max_abs_err {:.3e} (tolerance {:.0e}), {:.4f} ms vs "
            "plain {:.4f} ms, library call {}, bound {:.4f} ms ({})".format(
                name, errs[name], tol, ms, plain_ms,
                "none" if lib_ms is None else
                "{:.4f} ms (kernel / library {:.3f})".format(lib_ms,
                                                            ms / lib_ms),
                bound_ms, bound_by))
        check(errs[name] <= tol, "{} disagrees with its plain version"
              .format(name))


def check_outputs(out):
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    check(tuple(boxes.shape) == (BATCH, 300, 7), "box3d_lidar shape")
    check(tuple(scores.shape) == (BATCH, 300) and
          tuple(labels.shape) == (BATCH, 300), "scores/labels shape")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite outputs")
    kept = scores >= 0
    check(bool((scores[kept] >= 0.05).all() & (scores[~kept] == -1).all()),
          "scores outside the threshold / padding convention")
    check(bool((labels[kept] == 0).all() & (labels[~kept] == -1).all()),
          "labels outside the one-class / padding convention")
    check(bool(kept.any(dim=1).all()), "a scan kept no box")
    return kept.sum(dim=1).tolist()


def phase_model(model, points):
    import torch

    from paddle3d_tpu_torch.ops import _build
    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_outputs(out)
    log("phase 3: test_forward through the kernels: launches {}, kept "
        "boxes per scan {}".format(launches, kept))
    check(all(launches[name] > 0 for name in INFER_KERNELS),
          "the main path missed a kernel: {}".format(launches))
    _build.reset_launches()
    with plain_path():
        ref = model.test_forward({"data": points})
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          "the plain path launched a kernel: {}".format(_build.LAUNCHES))
    check(torch.equal(out["label_preds"], ref["label_preds"]),
          "labels differ from the plain path")
    s_err = (out["scores"] - ref["scores"]).abs().max().item()
    b_err = (out["box3d_lidar"] - ref["box3d_lidar"]).abs().max().item()
    log("  vs the plain path on the card: labels equal, scores max_abs_err "
        "{:.3e} (tolerance 1e-5), boxes {:.3e} (tolerance 1e-4)".format(
            s_err, b_err))
    check(s_err <= 1e-5 and b_err <= 1e-4, "outputs differ from plain path")
    return launches


def phase_tiny_canvas():
    """A small input against the CPU path: the tiny config's canvas and
    occupancy, kernels on the card vs plain versions on the CPU."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    model = Config(path=TINY, device="cpu").model.eval()
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.uniform([0, -16, -2, 0], [32, 16, 2, 1],
                                       (2, 1024, 4)).astype(np.float32))
    mods = (model.voxelizer, model.pillar_encoder, model.middle_encoder)
    ref_canvas, ref_occ = fused_pillar_canvas(*mods, pts, False,
                                              with_occupancy=True)
    model.cuda()
    canvas, occ = fused_pillar_canvas(*mods, pts.cuda(), False,
                                      with_occupancy=True)
    err = (canvas.cpu() - ref_canvas).abs().max().item()
    log("  tiny config canvas, card kernels vs CPU plain: max_abs_err {:.3e} "
        "(tolerance 1e-5), occupancy equal: {}".format(
            err, torch.equal(occ.cpu(), ref_occ)))
    check(err <= 1e-5 and torch.equal(occ.cpu(), ref_occ),
          "tiny canvas differs from the CPU path")


def timed_scans_per_s(model, points, iters):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.test_forward({"data": points})
    torch.cuda.synchronize()
    return points.shape[0] * iters / (time.perf_counter() - t0)


def phase_timing(model, points, phase="phase 4", warmups=3):
    import torch
    # timing runs as a server would: cuDNN free to pick (and autotune) its
    # fastest algorithms for the fixed shapes; TF32 stays off
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for _ in range(warmups):                # warm-up, both paths
        model.test_forward({"data": points})
        with plain_path():
            model.test_forward({"data": points})
    rates = {"kernels": [], "plain": []}
    half = ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            if path == "plain":
                with plain_path():
                    rates[path].append(timed_scans_per_s(model, points,
                                                         half))
            else:
                rates[path].append(timed_scans_per_s(model, points, half))
    rate = {k: ITERS / sum(half / r for r in v) for k, v in rates.items()}
    log("{}: {} iterations of batch {} (kernel/plain/plain/kernel "
        "halves, cudnn.benchmark on): kernel path {:.2f} scans/s, plain "
        "path {:.2f} scans/s; halves {}".format(
            phase, ITERS, points.shape[0], rate["kernels"], rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    model.test_forward({"data": points})
    log("  peak device memory of one forward: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: model.test_forward({"data": points}))
    return rate


def profile(fn, iters=PROFILE_ITERS):
    """Device time by kernel over `iters` calls of fn (the kernel path).
    The device's activity alone: a ~16,000-launch forward's trace then
    takes ~4 s less to read than with the host's ops beside it (the same
    kernels, counts and device time), and the tracer lengthens the traced
    wall less."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    log_profile(prof, wall_ms, iters)


def log_profile(prof, wall_ms, iters):
    """Log a finished trace's device time by kernel over `iters`
    iterations of wall_ms each."""
    from torch.autograd import DeviceType
    # device-side events only: a CPU op's own device time repeats the time
    # of the kernels it launched, and so does a user annotation's range on
    # the device (the optimizer's step)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / iters
    if not events:
        log("  profile: no device time in the trace (not measured)")
        return
    log("  profile per iteration: wall {:.3f} ms, device busy {:.3f} ms "
        "in {} kernel launches (idle share {:.3f}); top device ops:".format(
            wall_ms, dev_ms, sum(e.count for e in events) // iters,
            1 - dev_ms / wall_ms))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:12]:
        log("    {:9.3f} ms  x{:<5d} {}".format(
            e.self_device_time_total / 1e3 / iters, e.count // iters,
            e.key[:90]))


def held(name, got, ref, tol):
    """K3/K4: each output within tol of its largest plain magnitude.
    -> the largest absolute error over the outputs."""
    worst = 0.0
    for g, r in zip(got, ref):
        err = (g - r).abs().max().item()
        worst = max(worst, err)
        check(err <= tol * r.abs().max().item(),
              "{} disagrees with its plain version: {:.3e} against a "
              "largest magnitude of {:.3e}".format(
                  name, err, r.abs().max().item()))
    return worst


def pfn_parts(keys, pts_t, w1t, bwd_args, kw, iters=50):
    """K3's and K4's wrappers timed in parts (CUDA events, ms a call) on the
    train shapes: the C entry alone (its launches, buffers made before),
    the whole wrapper, and the parts the earlier 64-row-block wrappers
    added around their kernels, timed at these shapes: pillar_ordinals
    (their cap input) and the PyTorch sum of their per-block f64 partials.
    -> dict of part -> ms."""
    import torch

    from paddle3d_tpu_torch.ops import _build, fused_pfn, fused_pfn_train
    b, c_in, n = pts_t.shape
    u1, c_dec = w1t.shape
    g_t, vecs = bwd_args[2], bwd_args[4:]
    geo = (kw["P"], kw["maxV"], kw["nx"], kw["vx"], kw["vy"], kw["x_off"],
           kw["y_off"], int(kw["with_distance"]))
    stream = _build.stream_ptr(keys.device)
    parts = {"pillar_ordinals": cuda_ms(
        lambda: fused_pfn.pillar_ordinals(keys), iters)}
    rows = {"pfn_stats": 4 + c_dec, "pfn_bwd": 2 + c_dec}
    for name, r in rows.items():
        part = torch.zeros((b, -(-n // 64), r, u1), dtype=torch.float64,
                           device=keys.device)
        parts[name + " partials' sum"] = cuda_ms(
            lambda: part.sum(dim=(0, 1)), iters)
    fns = {k: _build.function("p3d_" + k) for k in rows}
    spans = fused_pfn.spans(b, n, keys.device)
    outs = {k: torch.empty((spans * b + 1) * r * u1, dtype=torch.float64,
                           device=keys.device) for k, r in rows.items()}
    stats_args = (keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr(),
                  outs["pfn_stats"].data_ptr(), spans, b, n, c_in, c_dec,
                  u1) + geo + (stream,)
    bwd_args_c = (keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr()) + \
        tuple(v.data_ptr() for v in vecs) + (
            g_t.data_ptr(), *g_t.stride(), outs["pfn_bwd"].data_ptr(),
            spans, b, n, c_in, c_dec, u1) + geo + (stream,)
    parts["pfn_stats kernel alone"] = cuda_ms(
        lambda: fns["pfn_stats"](*stats_args), iters)
    parts["pfn_bwd kernel alone"] = cuda_ms(
        lambda: fns["pfn_bwd"](*bwd_args_c), iters)
    parts["pfn_stats wrapper"] = cuda_ms(
        lambda: fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw), iters)
    parts["pfn_bwd wrapper"] = cuda_ms(
        lambda: fused_pfn_train.pfn_bwd(*bwd_args, **kw), iters)
    log("  K3 / K4 wrapper parts (the C entry alone: the kernel and its "
        "reduce launch; the whole wrapper; beside them the parts the "
        "earlier wrappers added, timed at these shapes), ms a call: {}"
        .format(", ".join("{} {:.4f}".format(k, v)
                          for k, v in parts.items())))
    return parts


def pfn_train_inputs(model, points):
    """K3's and K4's inputs at the KITTI train shapes (maxV 16000), with the
    batch statistics and the cotangent layout a train step gives them.
    -> (keys, pts_t, w1t, kw, bwd_args, plain K3 sums, the generator that
    made the cotangent, for the next random inputs)."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn_train, pillar_ops
    vox, pfn, mid = model.voxelizer, model.pillar_encoder, \
        model.middle_encoder
    keys, pts_t = pillar_ops.sort_points_by_cell(points, vox.voxel_size,
                                                 vox.point_cloud_range)
    mlp = pfn.pfn_layers[0].mlp
    w1t = mlp.linear.weight.detach()
    kw = dict(P=pfn.max_num_points_in_voxel,
              maxV=vox.max_num_voxels_for(True), nx=mid.nx, vx=pfn.vx,
              vy=pfn.vy, x_off=pfn.x_offset, y_off=pfn.y_offset,
              with_distance=pfn.with_distance)
    check(tuple(w1t.shape) == (64, 9) and kw["P"] == 32 and
          kw["maxV"] == 16000, "not the KITTI train PFN shapes")
    gen = torch.Generator(device=points.device).manual_seed(SEED)
    ref_stats = fused_pfn_train.pfn_stats_plain(keys, pts_t, w1t, **kw)
    # the batch statistics and BN fold of the train forward
    m = float(keys.numel())
    mu = (ref_stats[0] / m).float()
    invsig = torch.rsqrt((ref_stats[1] / m - (ref_stats[0] / m) ** 2).float()
                         + mlp.bn.eps)
    a = mlp.bn.weight.detach() * invsig
    c = mlp.bn.bias.detach() - mu * a
    # the rows cotangent as autograd hands it to K4: a [B, C, N] view of
    # the [B, N, C] rows K5 gives
    g_t = torch.randn((BATCH, POINTS, 65), generator=gen,
                      device=points.device).transpose(1, 2)
    return (keys, pts_t, w1t, kw, (keys, pts_t, g_t, w1t, a, c, mu, invsig),
            ref_stats, gen)


def gather_work(keys, g, g_extra, num_cells, c):
    """Bytes K5's data needs: the keys read, each distinct in-range cell of
    a scan read once (c_main = g.shape[-1] values, and one of g_extra where
    it is given) and the rows [B, N, c] written; beside them the earlier
    count, c_main values read for every in-range row. -> (bytes, earlier
    bytes, distinct cells)."""
    import torch
    b, n = keys.shape
    c_main = g.shape[-1]
    k = keys.long()
    inside = (k >= 0) & (k < num_cells)
    lin = (torch.arange(b, device=k.device)[:, None] * num_cells + k)[inside]
    distinct = int(torch.unique(lin).numel())
    per_cell = c_main + (1 if g_extra is not None and c > c_main else 0)
    nbytes = 4 * (keys.numel() + distinct * per_cell + b * n * c)
    old = 4 * (keys.numel() + int(inside.sum()) * c_main + b * n * c)
    return nbytes, old, distinct


def gather_sectors(keys, g, num_cells):
    """The 32-byte sectors of g that hold the values K5 needs (c_main of
    each in-range row's cell, g's own strides; g_extra's one value a cell
    aside): what device memory must deliver at the least when each sector
    comes from it once. -> sectors."""
    import torch
    b, n = keys.shape
    gsb, gsk, gsc = g.stride()
    k = keys.long()
    inside = (k >= 0) & (k < num_cells)
    lin = (torch.arange(b, device=k.device)[:, None] * num_cells + k)[inside]
    cells = torch.unique(lin)
    base = (cells // num_cells) * gsb + (cells % num_cells) * gsk
    ch = torch.arange(g.shape[-1], device=k.device) * gsc
    first = g.data_ptr() // 4 % 8               # floats into the first sector
    return int(torch.unique((base[:, None] + ch[None, :] + first) // 8)
               .numel())


def phase_train_kernels(model, points):
    """K3, K4 and K5 against their plain versions at the KITTI train shapes
    (maxV 16000), on the statistics and cotangents the train step gives
    them; K3 and K4 also against a second call of their own (bit for bit)
    and timed in parts."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn_train, sorted_scatter
    mid = model.middle_encoder
    keys, pts_t, w1t, kw, bwd_args, ref_stats, gen = pfn_train_inputs(
        model, points)
    cells = mid.ny * mid.nx
    stats = [fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw)
             for _ in range(2)]
    bwd = [fused_pfn_train.pfn_bwd(*bwd_args, **kw) for _ in range(2)]
    ref_bwd = fused_pfn_train.pfn_bwd_plain(*bwd_args, **kw)
    # the canvas cotangent as the NCHW backbone hands it to K5
    g_canvas = torch.randn((BATCH, 64, cells), generator=gen,
                           device=points.device).transpose(1, 2)
    gather_args = (keys, g_canvas, None, cells, 65)
    rows = sorted_scatter.sorted_table_gather(*gather_args)
    ref_rows = sorted_scatter.sorted_table_gather_plain(*gather_args)
    torch.cuda.synchronize()
    for name, (one, two) in (("pfn_stats", stats), ("pfn_bwd", bwd)):
        check(all(same_bits(x, y) for x, y in zip(one, two)),
              "{} gave other bits on a second call".format(name))
    stats, bwd = stats[0], bwd[0]
    check(stats[2].item() == ref_stats[2].item(), "K3 kept-row count")
    check(tuple(rows.shape) == (BATCH, POINTS, 65), "K5 output shape")
    errs = {
        "pfn_stats": held("pfn_stats", stats, ref_stats,
                          KERNELS["pfn_stats"][2]),
        "pfn_bwd": held("pfn_bwd", bwd, ref_bwd, KERNELS["pfn_bwd"][2]),
        "sorted_table_gather": (rows - ref_rows).abs().max().item(),
    }
    times = {
        "pfn_stats": (
            cuda_ms(lambda: fused_pfn_train.pfn_stats(keys, pts_t, w1t,
                                                      **kw), 50),
            cuda_ms(lambda: fused_pfn_train.pfn_stats_plain(
                keys, pts_t, w1t, **kw), 10)),
        "pfn_bwd": (
            cuda_ms(lambda: fused_pfn_train.pfn_bwd(*bwd_args, **kw), 50),
            cuda_ms(lambda: fused_pfn_train.pfn_bwd_plain(*bwd_args, **kw),
                    10)),
        "sorted_table_gather": (
            cuda_ms(lambda: sorted_scatter.sorted_table_gather(*gather_args),
                    50),
            cuda_ms(lambda: sorted_scatter.sorted_table_gather_plain(
                *gather_args), 10)),
    }
    log("  train kernels at B={} N={} C_dec=9 u1=64 P=32 maxV=16000 "
        "cells={} C=65: kept rows {:.0f}; K3 and K4 bit-equal to a second "
        "call".format(BATCH, POINTS, cells, stats[2].item()))
    pfn_parts(keys, pts_t, w1t, bwd_args, kw)
    k1_args = k1_train_call(model, points)
    k1_held("KITTI training", *k1_args[:4], dict(k1_args[4], n_layers=1))
    k1_parts("KITTI training", *k1_args)
    seg = segments(keys, kw["P"], kw["maxV"])
    check(seg["kept"] == int(stats[2].item()), "kept-row count")
    u1, c_dec = w1t.shape
    kept, emitted = seg["kept"], sum(seg["capped"])
    inside = (keys >= 0) & (keys < cells)
    c_main = g_canvas.shape[-1]
    safe = torch.where(inside, keys, 0).long()[..., None].expand(
        -1, -1, c_main)
    k5_bytes, k5_old, distinct = gather_work(*gather_args)
    # K3: f32 products z = W1 x and f64 sums over every kept row. K4: z and
    # t = a z + c in f32 over every kept row, f64 sums only where dt is
    # non-zero, at most one (argmax) row a pillar and channel: Σdt, Σdt·ẑ
    # and Σx⊗dt (the earlier bound counted them over every kept row); the
    # cotangent at emission rows only. K5 reads each distinct cell its keys
    # name once (gather_work)
    k4_bytes = 4 * (keys.numel() + pts_t.numel() + emitted * u1)
    k4_old = bound(k4_bytes, f32_ops=kept * 2 * u1 * (c_dec + 1),
                   f64_ops=kept * (3 * u1 + 2 * c_dec * u1))
    extra = {
        "pfn_stats": (None,) + bound(
            4 * (keys.numel() + pts_t.numel()),
            f32_ops=kept * 2 * u1 * c_dec,
            f64_ops=kept * (3 * u1 + 2 * c_dec * u1 + c_dec)),
        "pfn_bwd": (None,) + bound(
            k4_bytes, f32_ops=kept * 2 * u1 * (c_dec + 1),
            f64_ops=emitted * u1 * (2 * c_dec + 3)),
        "sorted_table_gather": (
            cuda_ms(lambda: torch.gather(g_canvas, 1, safe), 10),) + bound(
                k5_bytes),
    }
    log("  K4's bound counts its f64 sums on argmax rows only ({} emitted "
        "pillars): {:.4f} ms ({}); over every kept row, as before: {:.4f} "
        "ms ({})".format(emitted, extra["pfn_bwd"][1], extra["pfn_bwd"][2],
                         *k4_old))
    sectors = gather_sectors(keys, g_canvas, cells)
    log("  K5's bound counts each of the {} distinct in-range cells read once "
        "({} in-range rows): {:.4f} ms ({}); one read a row, as before: "
        "{:.4f} ms ({}); the values needed lie in {} 32-byte sectors of the "
        "cotangent: with the rows written {:.4f} ms at the card's memory "
        "rate".format(distinct, int(inside.sum()),
                      *extra["sorted_table_gather"][1:], *bound(k5_old),
                      sectors, bound(32 * sectors + 4 * (
                          keys.numel() + rows.numel()))[0]))
    names = ("pfn_stats", "pfn_bwd", "sorted_table_gather")
    for name in names:
        tol = KERNELS[name][2]
        ms, plain_ms = times[name]
        lib_ms, bound_ms, bound_by = extra[name]
        log("  {}: max_abs_err {:.3e} (tolerance {}), {:.4f} ms vs plain "
            "{:.4f} ms, library call {}, bound {:.4f} ms ({})".format(
                name, errs[name], "{:.0e} of each output's largest value"
                .format(tol) if name != "sorted_table_gather" else "0",
                ms, plain_ms,
                "none" if lib_ms is None else "{:.4f} ms".format(lib_ms),
                bound_ms, bound_by))
    check(errs["sorted_table_gather"] == 0.0,
          "sorted_table_gather disagrees with its plain version")
    return errs, times, extra


def make_train_batch(device, points=None):
    """The KITTI train batch: the scans and bench.make_gt's boxes (24 a
    scan, one class, a quarter padding)."""
    import numpy as np
    import torch

    import bench
    boxes, labels = bench.make_gt(np.random.default_rng(SEED), BATCH,
                                  "pointpillars")
    return {"data": points, "gt_boxes": torch.from_numpy(boxes).to(device),
            "gt_labels": torch.from_numpy(labels).to(device)}


def record_step(step, model, optimizer, batch):
    """One train step -> (losses, grads after the optimizer's clip, running
    stats, launches of the step)."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    _build.reset_launches()
    losses = step(model, optimizer, batch)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    return ({k: v.item() for k, v in losses.items()}, grads, stats,
            launches)


def saved_state(model, optimizer, scheduler):
    """-> restore(), which puts the three back as they are now."""
    import copy
    saved = ({k: v.clone() for k, v in model.state_dict().items()},
             copy.deepcopy(optimizer.state_dict()),
             copy.deepcopy(scheduler.state_dict()))

    def restore():
        model.load_state_dict(saved[0])
        # copies each time: an optimizer keeps the state tensors it is
        # given (same dtype and device) and updates them in place, which
        # changed the saved state at every step after a restore
        optimizer.load_state_dict(copy.deepcopy(saved[1]))
        scheduler.load_state_dict(copy.deepcopy(saved[2]))
    return restore


def falling_losses(step, model, optimizer, batch, fixed=False):
    """TRAIN_STEPS steps on the fixed batch: finite losses, the last under
    the first. fixed runs them in torch's deterministic mode (warn_only)
    with deterministic cuDNN, for a set-prediction loss: its Hungarian
    matches flip from step to step, so that its loss jumps, and where the
    autotuner's pick of algorithms steers the steps the last loss against
    the first differs from run to run. In the mode the ten steps take one
    path on every run of the card and software (the ops that have no
    deterministic form are logged), when the steps before them ran in
    fixed_path too."""
    with warnings.catch_warnings(record=True) as warned, \
            fixed_path() if fixed else contextlib.nullcontext():
        warnings.simplefilter("always")
        losses = [step(model, optimizer, batch)["loss"].item()
                  for _ in range(TRAIN_STEPS)]
    log("  {} steps on the fixed batch{}, loss per step: {}".format(
        TRAIN_STEPS, " in deterministic mode (ops without a deterministic "
        "form: {})".format(sorted({str(w.message).split(" does not")[0]
                                   for w in warned
                                   if "deterministic" in str(w.message)}))
        if fixed else "", [round(v, 4) for v in losses]))
    check(all(v == v and abs(v) < float("inf") for v in losses),
          "non-finite train loss")
    check(losses[-1] < losses[0], "the loss did not fall: {} steps, loss "
          "per step {}".format(TRAIN_STEPS, losses))


def compare_steps(got, ref, loss_tol, grad_tol, stat_tol,
                  keys=("loss", "loss_cls", "loss_reg", "loss_dir"),
                  dead=()):
    """-> (worst loss, grad, stat relative errors); fails past the
    tolerances (grads and stats relative to each tensor's largest value).
    dead: parameters with no gradient but rounding noise (a conv's bias
    that feeds a batch-statistics BN, which takes its mean away): their
    grads must stay within 1e-6 of the largest grad on both steps."""
    (l1, g1, s1, _), (l2, g2, s2, _) = got, ref
    check(set(l1) == set(l2) == set(keys), "loss keys")
    check(all(map(lambda v: v == v and abs(v) < float("inf"), l1.values())),
          "non-finite losses: {}".format(l1))
    errs = [max(abs(l1[k] - l2[k]) / max(abs(l2[k]), 1e-30) for k in l2)]
    largest = max(v.abs().max().item() for v in g2.values())
    check(all(max(g1[k].abs().max().item(), g2[k].abs().max().item()) <=
              1e-6 * largest for k in dead),
          "a parameter with no gradient got one: {}".format(
              {k: g2[k].abs().max().item() for k in dead}))
    worst = [max(l2, key=lambda k: abs(l1[k] - l2[k]) /
                 max(abs(l2[k]), 1e-30))]
    for a, b in ((g1, g2), (s1, s2)):
        check(set(a) == set(b), "tensor names differ")
        rel = {k: (a[k] - b[k]).abs().max().item() /
               max(b[k].abs().max().item(), 1e-30) for k in b
               if k not in dead}
        worst.append(max(rel, key=rel.get))
        errs.append(rel[worst[-1]])
    for err, tol, what, name in zip(errs, (loss_tol, grad_tol, stat_tol),
                                    ("losses", "grads", "running stats"),
                                    worst):
        check(err <= tol, "{} differ: {:.3e} > {:.0e} (worst: {})".format(
            what, err, tol, name))
    return errs


def phase_tiny_train():
    """A small input against the CPU path: the tiny config's train step,
    kernels on the card vs plain versions on the CPU."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    rng = np.random.default_rng(SEED)
    pts = rng.uniform([0, -16, -2, 0], [32, 16, 2, 1], (2, 1024, 4))
    boxes = np.zeros((2, 4, 7), np.float32)
    boxes[..., :2] = rng.uniform([2, -14], [30, 14], (2, 4, 2))
    boxes[..., 2:6] = [-1., 1.6, 3.9, 1.56]
    boxes[..., 6] = rng.uniform(-3, 3, (2, 4))
    pts[:, :512, :2] = boxes[:, :4, :2].repeat(128, axis=1) + rng.normal(
        0, 1., (2, 512, 2))
    labels = np.array([[0, 0, 0, -1], [0, 0, -1, -1]])
    out = []
    for device in ("cpu", "cuda"):
        cfg = Config(path=TINY, device=device)
        model = cfg.model.train()
        step = make_train_step(lr_scheduler=cfg.lr_scheduler)
        batch = {"data": torch.from_numpy(pts.astype(np.float32)),
                 "gt_boxes": torch.from_numpy(boxes),
                 "gt_labels": torch.from_numpy(labels)}
        res = record_step(step, model, cfg.optimizer,
                          {k: v.to(device) for k, v in batch.items()})
        out.append(tuple({k: v.cpu() for k, v in r.items()}
                         if i in (1, 2) else r for i, r in enumerate(res)))
    errs = compare_steps(out[1], out[0], 1e-4, 1e-3, 1e-4)
    check(out[1][3]["pfn_bwd"] > 0, "the tiny card step missed K4")
    log("  tiny config train step, card kernels vs CPU plain: losses "
        "{:.3e} (tolerance 1e-4), grads {:.3e} (1e-3), running stats "
        "{:.3e} (1e-4), relative".format(*errs))


def timed_train_scans_per_s(step, model, optimizer, batch, iters):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(model, optimizer, batch)
    torch.cuda.synchronize()
    return batch["data"].shape[0] * iters / (time.perf_counter() - t0)


def phase_train(points):
    """Training on the KITTI config: the kernel step against the plain step
    from one saved state, 10 steps, timing, memory and a profile."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=KITTI, device=points.device)
    model = cfg.model.train()
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    step = make_train_step(lr_scheduler=scheduler)
    batch = make_train_batch(points.device, points)
    restore = saved_state(model, optimizer, scheduler)

    with recorded(sorted_scatter, "scatter_rows") as k2s:
        kernel = record_step(step, model, optimizer, batch)
    restore()
    check(len(k2s) == 1, "expected one K2 call a train step, got {}".format(
        len(k2s)))
    k2_call("KITTI training", *k2s[0][0])
    del k2s
    with plain_path():
        plain = record_step(step, model, optimizer, batch)
    restore()
    launches = kernel[3]
    log("phase 5: KITTI train step (Adam, clip 10, StepDecay 2e-4), "
        "losses {}; launches {}; plain step launches {}".format(
            {k: round(v, 5) for k, v in kernel[0].items()}, launches,
            plain[3]))
    check(all(launches[name] > 0 for name in TRAIN_KERNELS),
          "the train path missed a kernel: {}".format(launches))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6)
    log("  vs the plain step (deterministic cuDNN, TF32 off): losses "
        "{:.3e} (tolerance 1e-6), grads {:.3e} (1e-4), running stats "
        "{:.3e} (1e-6), each relative to the tensor's largest value"
        .format(*errs))
    phase_tiny_train()

    # training runs as a trainer would: cuDNN free to pick its algorithms
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch)

    for _ in range(2):                       # warm-up, both paths
        step(model, optimizer, batch)
        with plain_path():
            step(model, optimizer, batch)
    rates = {"kernels": [], "plain": []}
    half = ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx:
                rates[path].append(timed_train_scans_per_s(
                    step, model, optimizer, batch, half))
    rate = {k: BATCH * ITERS / sum(BATCH * half / r for r in v)
            for k, v in rates.items()}
    log("  {} train steps of batch {} per path (kernel/plain/plain/kernel "
        "halves, cudnn.benchmark on): kernel path {:.2f} scans/s, plain "
        "path {:.2f} scans/s; halves {}".format(
            ITERS, BATCH, rate["kernels"], rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    step(model, optimizer, batch)
    log("  peak device memory of one train step: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: step(model, optimizer, batch))
    return launches


def make_cp_points(device, name="centerpoint", batch=BATCH):
    """`batch` nuScenes-like scans of 250,000 clustered (x, y, z, intensity,
    dt) points over bench.MODELS[name]'s range (bench.make_scans, seed
    0)."""
    import numpy as np
    import torch

    import bench
    _, n, (lo, hi), _ = bench.MODELS[name]
    pts = bench.make_scans(np.random.default_rng(SEED), batch, n, lo, hi,
                           "clustered")
    check(pts.shape == (batch, CP_POINTS, 5), "unexpected scan shape")
    return torch.from_numpy(pts).to(device)


def build_centerpoint(device, path=NUSCENES):
    """A nuScenes CenterPoint config at full width, seeded random weights,
    eval. The dense conv kernels are scaled by sqrt(6): with
    uniform(±1/sqrt(fan_in)) weights the activations shrink ~3x a layer
    through the 19-conv stack, which would leave a flat heatmap; the gain
    keeps their variance under relu, so the head sees the scene and the NMS
    has work. Sparse convs keep their scale (their residual blocks carry
    the signal)."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    model = Config(path=path, device=device).model.eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(6 ** 0.5)
    return model


def phase_cp_kernels(model, points):
    """The two-layer K1 and K6 against their plain versions at the
    CenterPoint-nuScenes shapes: K6 on the path's own rows and on random
    rows, bit for bit against the row-order sum (tolerance 0) and within
    1e-5 of the largest value of its plain version (index_add_, whose
    atomics add in a run-dependent order)."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn, pillar_ops, sorted_scatter
    vox, pfn, mid = model.voxelizer, model.voxel_encoder, \
        model.middle_encoder
    keys, pts_t = pillar_ops.sort_points_by_cell(points, vox.voxel_size,
                                                 vox.point_cloud_range)
    w1t, b1, w2t, b2 = pillar_ops.pfn_folded_weights(pfn)
    kw = dict(n_layers=2, P=pfn.max_num_points_in_voxel,
              maxV=vox.max_num_voxels_for(False), nx=mid.nx, vx=pfn.vx,
              vy=pfn.vy, x_off=pfn.x_offset, y_off=pfn.y_offset,
              with_distance=pfn.with_distance, occupancy=False)
    cells = mid.ny * mid.nx
    check(tuple(w1t.shape) == (32, 10) and tuple(w2t.shape) == (64, 64) and
          kw["P"] == 20 and kw["maxV"] == 60000 and cells == 512 * 512,
          "not the CenterPoint-nuScenes PFN shapes")
    check(pillar_ops.is_dense_scan(CP_POINTS, cells),
          "the nuScenes scan is not dense")

    rows_t = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, w2t, b2, **kw)
    ref_t = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, w2t, b2,
                                           **kw)
    table = sorted_scatter.sorted_segment_sum_cm(keys, rows_t, cells)
    ref_table = sorted_scatter.sorted_segment_sum_cm_plain(keys, rows_t,
                                                           cells)
    gen = torch.Generator(device=points.device).manual_seed(SEED)
    rnd = torch.randn(rows_t.shape, generator=gen, device=points.device)
    rnd_table = sorted_scatter.sorted_segment_sum_cm(keys, rnd, cells)
    rnd_ref = sorted_scatter.sorted_segment_sum_cm_plain(keys, rnd, cells)
    n = keys.shape[1]
    row_sum = row_order_sum(keys, rows_t[:, :, :n].transpose(1, 2), cells)
    rnd_row_sum = row_order_sum(keys, rnd[:, :, :n].transpose(1, 2), cells)
    torch.cuda.synchronize()
    check(tuple(table.shape) == (BATCH, cells, 64), "K6 output shape")
    check(same_bits(rows_t, ref_t), "the two-layer fused_pfn_rows differs "
          "from its plain version in its bits")
    errs = {"fused_pfn_rows_2l": (rows_t - ref_t).abs().max().item(),
            "sorted_segment_sum_cm": max(
                (table - ref_table).abs().max().item(),
                (table - row_sum).abs().max().item(),
                (rnd_table - rnd_row_sum).abs().max().item())}
    check(torch.equal(table, row_sum) and torch.equal(rnd_table, rnd_row_sum),
          "sorted_segment_sum_cm differs from the row-order sum (tolerance "
          "0): max_abs_err {:.3e} on the path's rows, {:.3e} on random "
          "rows".format((table - row_sum).abs().max().item(),
                        (rnd_table - rnd_row_sum).abs().max().item()))
    del row_sum, rnd_row_sum
    rnd_err = (rnd_table - rnd_ref).abs().max().item()
    rnd_scale = rnd_ref.abs().max().item()
    seg = segments(keys, kw["P"], kw["maxV"])
    log("phase 2 (CenterPoint): kernels vs plain at B={} N={} C_in=5 "
        "C_dec=10 u1=32 u2=64 P=20 maxV=60000 cells={} C=64 (dense); "
        "pillars per scan {} before the cap, {} after; kept rows {}; "
        "longest segment {} rows".format(
            BATCH, CP_POINTS, cells, seg["pillars"], seg["capped"],
            seg["kept"], seg["longest"]))
    log("  sorted_segment_sum_cm bit-equal to the row-order sum on the "
        "path's rows and on random rows; on random rows against its plain "
        "version (index_add_): max_abs_err {:.3e} against a largest value of "
        "{:.3e} (tolerance 1e-5 of it: sums in another order)".format(
            rnd_err, rnd_scale))
    check(rnd_err <= 1e-5 * rnd_scale,
          "sorted_segment_sum_cm disagrees with its plain version on random "
          "rows")

    u1, c_dec = w1t.shape
    u2 = w2t.shape[0]
    times = {
        "fused_pfn_rows_2l": (
            cuda_ms(lambda: fused_pfn.fused_pfn_rows(
                keys, pts_t, w1t, b1, w2t, b2, **kw), 20),
            cuda_ms(lambda: fused_pfn.fused_pfn_rows_plain(
                keys, pts_t, w1t, b1, w2t, b2, **kw), 3)),
        "sorted_segment_sum_cm": (
            cuda_ms(lambda: sorted_scatter.sorted_segment_sum_cm(
                keys, rows_t, cells), 20),
            cuda_ms(lambda: sorted_scatter.sorted_segment_sum_cm_plain(
                keys, rows_t, cells), 5)),
    }
    # K1: per kept row the W1 products and the y1 half of W2, per pillar
    # the m1 half; K6 moves keys, in-grid rows and the dense table once;
    # library call: index_add_ from the channel-major rows to a fresh table
    extra = {
        "fused_pfn_rows_2l": (None,) + bound(
            4 * (keys.numel() + pts_t.numel() + rows_t.numel()),
            f32_ops=2 * (seg["kept"] * (u1 * c_dec + u2 * u1) +
                         sum(seg["capped"]) * u2 * u1)),
        "sorted_segment_sum_cm": (
            cuda_ms(index_add_call(keys, rows_t, cells, True), 5),) + bound(
                scatter_bytes(keys, cells, u2, table.numel())),
    }
    report(CP_KERNELS, errs, times, extra)
    return errs, times, extra, seg


def check_cp_outputs(out, post, batch=BATCH):
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    k = 6 * post
    check(tuple(boxes.shape) == (batch, k, 9), "box3d_lidar shape")
    check(tuple(scores.shape) == (batch, k) and
          tuple(labels.shape) == (batch, k), "scores/labels shape")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite outputs")
    kept = scores >= 0
    check(bool((scores[kept] >= 0.1).all() & (scores[~kept] == -1).all()),
          "scores outside the threshold / padding convention")
    check(bool(((labels[kept] >= 0) & (labels[kept] < 10)).all() &
               (labels[~kept] == -1).all()),
          "labels outside the ten classes / padding convention")
    return kept.sum(dim=1).tolist()


def phase_centerpoint(device):
    """CenterPoint-nuScenes serving through the kernels and on the plain
    versions, timing, memory and a profile."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = build_centerpoint(device)
    points = make_cp_points(device)
    errs, times, extra, _ = phase_cp_kernels(model, points)
    post = model.test_cfg["nms"]["nms_post_max_size"]

    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_cp_outputs(out, post)
    log("phase 6: CenterPoint-nuScenes test_forward through the kernels: "
        "launches {}; boxes NMS kept per scan (of {} = 6 tasks x {}) {}"
        .format(launches, 6 * post, post, kept))
    check(all(launches[name] > 0 for name in CP_KERNELS),
          "the CenterPoint path missed a kernel: {}".format(launches))
    check(launches["sorted_segment_sum"] == 0,
          "the dense nuScenes scan took the row-major scatter")
    _build.reset_launches()
    with plain_path():
        ref = model.test_forward({"data": points})
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          "the plain path launched a kernel: {}".format(_build.LAUNCHES))
    check(torch.equal(out["label_preds"], ref["label_preds"]),
          "labels differ from the plain path")
    s_err = (out["scores"] - ref["scores"]).abs().max().item()
    b_err = (out["box3d_lidar"] - ref["box3d_lidar"]).abs().max().item()
    log("  vs the plain path on the card: labels equal, scores max_abs_err "
        "{:.3e} (tolerance 1e-5), boxes {:.3e} (tolerance 1e-4)".format(
            s_err, b_err))
    check(s_err <= 1e-5 and b_err <= 1e-4, "outputs differ from plain path")
    phase_timing(model, points, "phase 6")
    cp_stages(model, points, [("canvas", lambda p: fused_pillar_canvas(
        model.voxelizer, model.voxel_encoder, model.middle_encoder, p,
        False))], 3)
    return errs, times, extra, launches


def stage_times(stages, points, iters):
    """Host-clock ms of each stage [(name, fn)], each fn taking the output
    of the stage before it and ended by a synchronize, averaged over
    `iters` runs after a warm-up."""
    import torch

    def run():
        x, out = points, []
        for _, fn in stages:
            t0 = time.perf_counter()
            x = fn(x)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        run()
        ms = [sum(v) / iters for v in zip(*(run() for _ in range(iters)))]
    log("  stages per batch (host clock, synchronised): " + ", ".join(
        "{} {:.3f} ms".format(name, t) for (name, _), t in zip(stages, ms)))


def cp_stages(model, points, first, iters):
    """The stage times of the CenterPoint test_forward. first: [(name,
    fn)], the stages from the points to the BEV canvas."""
    stage_times(first + [
        ("backbone + neck", lambda canvas: model.neck(model.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))),
        ("head convs", model.bbox_head),
        ("decode + NMS", lambda preds: model.bbox_head.predict(
            preds, model.test_cfg))], points, iters)


def capture_vx_inputs(model, points, n_convs=21, n_maps=8):
    """One kernel-path forward, recording what it hands K8 (n_convs conv
    calls, each with the neighbour map it was given, and n_maps map
    builds: one a submanifold key set and one a strided conv) and the
    dense BEV's sorted segment sum."""
    from paddle3d_tpu_torch.ops import sorted_scatter, sparse_conv
    convs, maps, bevs = [], [], []
    conv_fn, map_fn, sum_fn = sparse_conv.sparse_conv3d, \
        sparse_conv.sparse_conv3d_map, sorted_scatter.sorted_segment_sum

    def conv_rec(*a, **k):
        convs.append((a, k))
        return conv_fn(*a, **k)

    def map_rec(*a):
        maps.append(a)
        return map_fn(*a)

    def sum_rec(*a):
        bevs.append(a)
        return sum_fn(*a)

    with mock.patch.object(sparse_conv, "sparse_conv3d", conv_rec), \
            mock.patch.object(sparse_conv, "sparse_conv3d_map", map_rec), \
            mock.patch.object(sorted_scatter, "sorted_segment_sum", sum_rec):
        model.test_forward({"data": points})
    check(len(convs) == n_convs and len(maps) == n_maps and len(bevs) == 1,
          "expected {} sparse convs, {} neighbour maps and one dense BEV, "
          "got {}, {} and {}".format(n_convs, n_maps, len(convs), len(maps),
                                     len(bevs)))
    check(all(k.get("nbr") is not None for _, k in convs),
          "a sparse conv of the path was handed no neighbour map")
    return convs, maps, bevs


def conv_work(a, nbr):
    """The work one sparse conv's data needs, from its neighbour map nbr:
    -> (bytes moved once: keys, map, features, weights, shift and output;
    hits per tap (queries with a neighbour there); products computed /
    products needed (ops/sparse_conv.kernel_pairs: what the kernel's thread
    mapping multiplies); valid query rows)."""
    from paddle3d_tpu_torch.ops.sparse_conv import kernel_pairs
    qbase, _, feats, w, d, h, w_ = a[:7]
    b, vq = qbase.shape
    cout = w.shape[-1]
    taps = (nbr >= 0).sum(dim=(0, 1)).tolist()
    nbytes = 4 * (qbase.numel() + nbr.numel() + feats.numel() + w.numel() +
                  cout + b * vq * cout)
    valid = int(((qbase >= 0) & (qbase < d * h * w_)).sum())
    return nbytes, taps, kernel_pairs(nbr, cout) / max(sum(taps), 1), valid


def map_case(m):
    """The neighbour-map kernel on one captured map build m = (qbase,
    in_keys, D, H, W, kernel_size), against its plain version
    (neighbour_map, index-equal): -> (kernel ms, plain ms, bytes moved
    once: both key sets read, the map written)."""
    import torch

    from paddle3d_tpu_torch.ops import sparse_conv
    got = sparse_conv.sparse_conv3d_map(*m)
    ref = sparse_conv.neighbour_map(*m)
    torch.cuda.synchronize()
    check(got.dtype == ref.dtype == torch.int32 and torch.equal(got, ref),
          "the neighbour-map kernel differs from neighbour_map at {}".format(
              tuple(got.shape)))
    return (cuda_ms(lambda: sparse_conv.sparse_conv3d_map(*m), 10),
            cuda_ms(lambda: sparse_conv.neighbour_map(*m), 3),
            4 * (m[0].numel() + m[1].numel() + got.numel()))


def conv_case(a, k):
    """K8 on one captured conv call (a, k), k holding the map the path
    handed it: the map equals neighbour_map, and the conv through the
    kernel, with that map and with one it builds itself, equals the plain
    version (which builds its own map) bit for bit. -> dict of the conv's
    kernel and plain ms (both given the map), max_abs_err, its largest
    output, and conv_work's numbers."""
    import torch

    from paddle3d_tpu_torch.ops import sparse_conv
    qbase, in_keys, feats, w, d, h, w_, ks = a[:8]
    own = {key: v for key, v in k.items() if key != "nbr"}
    nbr = k["nbr"]
    check(torch.equal(nbr, sparse_conv.neighbour_map(qbase, in_keys, d, h,
                                                     w_, ks)),
          "the map the path handed a sparse conv differs from neighbour_map")
    got = sparse_conv.sparse_conv3d(*a, **k)
    alone = sparse_conv.sparse_conv3d(*a, **own)
    ref = sparse_conv.sparse_conv3d_plain(*a, **own)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    top = ref.abs().max().item()
    check(torch.equal(got, alone), "sparse_conv3d differs with and without "
          "a prebuilt map")
    check(err <= KERNELS["sparse_conv3d"][2] and torch.equal(got, ref),
          "sparse_conv3d is not bit-equal to its plain version at {} -> {}: "
          "max_abs_err {:.3e} of {:.3e}".format(
              tuple(feats.shape), w.shape[-1], err, top))
    check(top > 0, "a sparse conv's output is all zero")
    nbytes, taps, ratio, valid = conv_work(a, nbr)
    return {"ms": cuda_ms(lambda: sparse_conv.sparse_conv3d(*a, **k), 10),
            "plain_ms": cuda_ms(
                lambda: sparse_conv.sparse_conv3d_plain(*a, **k), 1),
            "err": err, "top": top, "bytes": nbytes, "taps": taps,
            "computed": ratio, "valid": valid,
            "ops": 2 * feats.shape[-1] * w.shape[-1] * sum(taps)}


def row_major_direct(name, keys, rows, cells):
    """The row-major segment sum through the C entry of kernel `name` (K2,
    "sorted_segment_sum", or K7, "sorted_segment_sum_dense") whatever the
    density rule would pick; a comparison launch, so LAUNCHES is not
    touched."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    b, n, c = rows.shape
    out = torch.empty((b, cells, c), device=rows.device)
    _build.check(_build.function("p3d_" + name)(
        keys.data_ptr(), rows.data_ptr(), out.data_ptr(), None, b, n, c,
        cells, _build.stream_ptr(keys.device)), name)
    return out


def k2_call(label, keys, rows, cells, split, call=None):
    """K2 at one call of a path, on the inputs the path handed it, through
    its wrapper (call; by default scatter_rows, the forward without
    autograd): bit-equal to the row-order sum (tolerance 0), its time,
    index_add_call's, their factor and the bound, logged with the share of
    128-cell tiles that hold a row. -> (max_abs_err, ms, library ms, bound
    ms, bound_by)."""
    import torch

    from paddle3d_tpu_torch.ops import sorted_scatter
    keys, rows = keys.detach().contiguous(), rows.detach().contiguous()
    b, n, c = rows.shape
    check(sorted_scatter.kernel_for(n, cells) == "sorted_segment_sum",
          "{}: the density rule does not send this scan to K2".format(label))
    if call is None:
        def call():
            return sorted_scatter.scatter_rows(keys, rows, cells, split)
    got = call()
    got = torch.cat(got, dim=-1) if split else got
    ref = row_order_sum(keys, rows, cells)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err == 0.0, "{}: K2 differs from the row-order sum by {:.3e}"
          .format(label, err))
    del got, ref
    ms = cuda_ms(call, 50)
    lib = cuda_ms(index_add_call(keys, rows, cells), 10)
    bnd = bound(scatter_bytes(keys, cells, c, b * cells * c))
    inside = (keys >= 0) & (keys < cells)
    tiles_total = -(-cells // 128)
    occupied = [int(torch.unique(r[m] // 128).numel())
                for r, m in zip(keys.long(), inside)]
    log("  K2 at {}: B={} N={} C={}{} cells={}, in-grid rows {}, 128-cell "
        "tiles holding a row {:.3f}: {:.4f} ms, index_add_call {:.4f} ms "
        "(kernel / library {:.3f}), bound {:.4f} ms ({}), bit-equal to the "
        "row-order sum".format(
            label, b, n, c, " (split)" if split else "", cells,
            int(inside.sum()), sum(occupied) / (b * tiles_total), ms, lib,
            ms / lib, bnd[0], bnd[1]))
    return err, ms, lib, bnd[0], bnd[1]


def phase_vx_kernels(convs, maps, bevs):
    """K8 (the map kernel on each of the forward's map builds, the conv
    kernel at each distinct conv shape of the path) and K7 against their
    plain versions and index_add_ at the dense BEV's, on the inputs the
    forward handed them."""
    import torch

    from paddle3d_tpu_torch.ops import sorted_scatter
    groups = {}
    for a, k in convs:
        qbase, in_keys, feats, w, d, h, w_, ks = a[:8]
        key = (tuple(qbase.shape), tuple(feats.shape), tuple(w.shape),
               (d, h, w_), qbase is in_keys)
        groups.setdefault(key, []).append((a, k))
    check(len(groups) == 9, "expected nine distinct conv shapes, got {}"
          .format(len(groups)))
    log("phase 7: CenterPoint-voxels kernels vs plain at B={} (per conv "
        "shape: Vq x Cin -> Cout, launches a forward, conv kernel / plain "
        "ms given the map, bound, valid rows, neighbour hits a valid row, "
        "products computed / needed, max_abs_err; hits per tap)".format(
            VX_BATCH))
    err = ms = plain_ms = tot_bytes = tot_ops = 0.0
    for key, calls in groups.items():
        # the per-shape line describes calls[0], the call that was timed;
        # every call of the shape is held to its plain version
        cases = [conv_case(a, k) for a, k in calls]
        one = cases[0]
        err = max([err] + [c["err"] for c in cases])
        ms += one["ms"] * len(calls)
        plain_ms += one["plain_ms"] * len(calls)
        tot_bytes += sum(c["bytes"] for c in cases)
        tot_ops += sum(c["ops"] for c in cases)
        a = calls[0][0]
        b, vq = a[0].shape
        cin, cout, ks = a[2].shape[-1], a[3].shape[-1], a[7]
        bnd = bound(one["bytes"], f32_ops=one["ops"])
        log("  {} x {} -> {} (K={}, {}): x{}, {:.4f} / {:.4f} ms, bound "
            "{:.4f} ms ({}), valid rows {}, hits a row {:.2f} of {}, "
            "products computed / needed {:.3f}, max_abs_err {:.3e} of "
            "{:.3e}; hits per tap {}".format(
                vq, cin, cout, ks, "subm" if key[4] else "strided",
                len(calls), one["ms"], one["plain_ms"], bnd[0], bnd[1],
                one["valid"], sum(one["taps"]) / max(one["valid"], 1),
                ks ** 3, one["computed"], one["err"], one["top"],
                one["taps"]))
        del cases
    map_ms = map_plain_ms = map_bytes = 0.0
    for m in maps:
        t, tp, nbytes = map_case(m)
        map_ms, map_plain_ms, map_bytes = (map_ms + t, map_plain_ms + tp,
                                           map_bytes + nbytes)
        log("  neighbour map {} over {} keys (K={}, {}): {:.4f} ms vs plain "
            "{:.4f} ms, bound {:.4f} ms (bytes)".format(
                tuple(m[0].shape), m[1].shape[1], m[5],
                "subm" if m[0] is m[1] else "strided", t, tp,
                bound(nbytes)[0]))
    conv_bound = bound(tot_bytes, f32_ops=tot_ops)
    map_bound = bound(map_bytes)
    log("  sparse_conv3d, {} conv launches and {} map launches a forward: "
        "{:.4f} ms (conv {:.4f}, map {:.4f}) against plain {:.4f} ms (conv "
        "{:.4f}, map {:.4f}); conv bound {:.4f} ms ({}), map bound {:.4f} "
        "ms ({}); max_abs_err {:.3e} (tolerance 0: bit-equal)".format(
            len(convs), len(maps), ms + map_ms, ms, map_ms,
            plain_ms + map_plain_ms, plain_ms, map_plain_ms, conv_bound[0],
            conv_bound[1], map_bound[0], map_bound[1], err))

    keys, rows, cells = bevs[0]
    b, n, c = rows.shape
    check(sorted_scatter.kernel_for(n, cells) == "sorted_segment_sum_dense",
          "the dense BEV is not a dense scan")
    table = sorted_scatter.scatter_rows(keys, rows, cells, False)
    again = sorted_scatter.scatter_rows(keys, rows, cells, False)
    ref = sorted_scatter.scatter_rows_plain(keys, rows, cells, False)
    row_sum = row_order_sum(keys, rows, cells)
    main_, extra_ = sorted_scatter.scatter_rows(keys, rows, cells, True)
    gen = torch.Generator(device=keys.device).manual_seed(SEED)
    # random keys, ~2.5 rows a cell: index_add_ sums them in another order
    rkeys = torch.sort(torch.randint(0, cells // 8, keys.shape, generator=gen,
                                     device=keys.device) * 8, dim=1)[0].int()
    rrows = torch.randn(rows.shape, generator=gen, device=keys.device)
    rnd = sorted_scatter.scatter_rows(rkeys, rrows, cells, False)
    rnd_ref = row_order_sum(rkeys, rrows, cells)
    torch.cuda.synchronize()
    k7_err = max((table - ref).abs().max().item(),
                 (torch.cat([main_, extra_], -1) - ref).abs().max().item())
    rnd_err = (rnd - rnd_ref).abs().max().item()
    check(same_bits(table, row_sum) and same_bits(again, table) and
          same_bits(torch.cat([main_, extra_], -1), row_sum),
          "sorted_segment_sum_dense differs from the row-order sum or from "
          "a second call on the path's rows")
    check(same_bits(rnd, rnd_ref), "sorted_segment_sum_dense differs from "
          "the row-order sum on random keys: max_abs_err {:.3e}".format(
              rnd_err))
    del row_sum
    # the density rule's choice, measured: K2 and K7 on the path's rows and
    # on the random keys, each bit for bit against the row-order sum
    for label, (k_, r_) in (("path rows", (keys, rows)),
                            ("random keys", (rkeys, rrows))):
        ref_ = row_order_sum(k_, r_, cells)
        for name in ("sorted_segment_sum", "sorted_segment_sum_dense"):
            got_ = row_major_direct(name, k_, r_, cells)
            log("  {} on the {}: {:.4f} ms, max_abs_err {:.3e}".format(
                name, label, cuda_ms(lambda: row_major_direct(
                    name, k_, r_, cells), 50),
                (got_ - ref_).abs().max().item()))
            check(same_bits(got_, ref_), "{} differs from the row-order sum "
                  "on the {}".format(name, label))
        del ref_
    inside = (keys >= 0) & (keys < cells)
    times = {
        "sparse_conv3d": (ms, plain_ms),
        "sparse_conv3d_map": (map_ms, map_plain_ms),
        "sorted_segment_sum_dense": (
            cuda_ms(lambda: sorted_scatter.scatter_rows(keys, rows, cells,
                                                        False), 50),
            cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
                keys, rows, cells, False), 10)),
    }
    extra = {
        "sparse_conv3d": (None,) + conv_bound,
        "sparse_conv3d_map": (None,) + map_bound,
        "sorted_segment_sum_dense": (
            cuda_ms(index_add_call(keys, rows, cells), 10),) + bound(
                scatter_bytes(keys, cells, c, table.numel())),
    }
    errs = {"sparse_conv3d": err, "sparse_conv3d_map": 0.0,
            "sorted_segment_sum_dense": k7_err}
    log("  dense BEV at B={} N={} cells={} C={}: valid rows {}; bit-equal "
        "to the row-order sum and a second call on the path's rows, and to "
        "the row-order sum on random keys (largest value {:.3e})".format(
            b, n, cells, c, int(inside.sum()), rnd_ref.abs().max().item()))
    report(VX_KERNELS, errs, times, extra)
    return errs, times, extra


def voxels_per_scan(model, points):
    """Occupied voxels of each scan, uncapped."""
    import torch

    from paddle3d_tpu_torch.ops.voxelize import points_to_voxel_coords
    vox = model.voxelizer
    _, h, w = model.middle_encoder.grid
    coords, valid = points_to_voxel_coords(points, vox.voxel_size,
                                           vox.point_cloud_range)
    key = (coords[..., 2].long() * h + coords[..., 1]) * w + coords[..., 0]
    return [int(torch.unique(k[v]).numel()) for k, v in zip(key, valid)]


def vx_staged(model, points):
    """The voxel test_forward in its stages: -> (BEV canvas, head outputs,
    decoded outputs)."""
    import torch
    with torch.no_grad():
        canvas = model._canvas(points, False)
        preds = model.bbox_head(model.neck(model.backbone(
            canvas.permute(0, 3, 1, 2).contiguous())))
        return canvas, preds, model.bbox_head.predict(preds, model.test_cfg)


def phase_voxels(device):
    """CenterPoint-voxels nuScenes serving through K8 and K7 and on the
    plain versions, timing, memory, a profile and per-stage times."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    from paddle3d_tpu_torch.ops.voxelize import voxel_mean_batch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = build_centerpoint(device, VOXELS)
    points = make_cp_points(device, "centerpoint_voxels", VX_BATCH)
    post = model.test_cfg["nms"]["nms_post_max_size"]
    log("phase 7: voxels per scan before the cap of {}: {}".format(
        model.voxelizer.max_num_voxels_for(False),
        voxels_per_scan(model, points)))
    convs, maps, bevs = capture_vx_inputs(model, points)
    errs, times, extra = phase_vx_kernels(convs, maps, bevs)
    del convs, maps, bevs

    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_cp_outputs(out, post, VX_BATCH)
    log("  test_forward through the kernels: launches {}; boxes NMS kept "
        "per scan (of {}) {}".format(launches, 6 * post, kept))
    # 21 convs over 8 maps: one a subm key set (stage 1's conv_input and
    # blocks, each later stage's blocks) and one a strided conv
    check(launches["sparse_conv3d"] == 21 and
          launches["sparse_conv3d_map"] == 8 and
          launches["sorted_segment_sum_dense"] == 1,
          "the voxel path missed a kernel: {}".format(launches))
    check(launches["sorted_segment_sum"] == 0,
          "the dense BEV took the sparse row-major scatter")
    got = vx_staged(model, points)
    with plain_path():
        _build.reset_launches()
        ref = vx_staged(model, points)
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          "the plain path launched a kernel: {}".format(_build.LAUNCHES))
    c_err = (got[0] - ref[0]).abs().max().item()
    h_err = max((g[k] - r[k]).abs().max().item()
                for g, r in zip(got[1], ref[1]) for k in r)
    check(torch.equal(got[2]["label_preds"], out["label_preds"]),
          "test_forward and its stages differ")
    check(torch.equal(got[2]["label_preds"], ref[2]["label_preds"]),
          "labels differ from the plain path")
    s_err = (got[2]["scores"] - ref[2]["scores"]).abs().max().item()
    b_err = (got[2]["box3d_lidar"] - ref[2]["box3d_lidar"]).abs().max(
    ).item()
    log("  vs the plain path on the card: BEV canvas max_abs_err {:.3e} "
        "(tolerance 1e-5 of its largest value {:.3e}), head outputs {:.3e} "
        "(tolerance 1e-4), labels equal, scores {:.3e} (1e-5), boxes {:.3e} "
        "(1e-4)".format(c_err, ref[0].abs().max().item(), h_err, s_err,
                        b_err))
    check(c_err <= 1e-5 * ref[0].abs().max().item() and h_err <= 1e-4 and
          s_err <= 1e-5 and b_err <= 1e-4, "outputs differ from plain path")
    del got, ref
    phase_timing(model, points, "phase 7", warmups=1)
    vox = model.voxelizer
    cp_stages(model, points, [
        ("voxel_mean", lambda p: voxel_mean_batch(
            p, vox.voxel_size, vox.point_cloud_range,
            vox.max_num_points_in_voxel, vox.max_num_voxels_for(False),
            model.voxel_encoder.in_channels)),
        ("sparse middle", lambda v: model.middle_encoder(v[0], v[1], v[3]))],
        3)
    return errs, times, extra, launches


def build_scaled(device, path):
    """A config's model at full width, seeded random weights, eval, with
    every dense conv and linear weight scaled by sqrt(6): uniform
    (±1/sqrt(fan_in)) weights shrink the activations ~3x a layer under
    relu, which through the 12-conv RPN stack or IA-SSD's ~20 shared-MLP
    layers would leave flat scores and degenerate boxes; the gain keeps
    their variance, so proposals, votes and the NMS see the scene. Sparse
    convs keep their scale."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    model = Config(path=path, device=device).model.eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
                m.weight.mul_(6 ** 0.5)
    return model


def make_kitti_points(device, name):
    """TS_BATCH KITTI-like scans of clustered (x, y, z, intensity) points
    over bench.MODELS[name]'s range (bench.make_scans, seed 0)."""
    import numpy as np
    import torch

    import bench
    _, n, (lo, hi), _ = bench.MODELS[name]
    pts = bench.make_scans(np.random.default_rng(SEED), TS_BATCH, n, lo, hi,
                           "clustered")
    check(pts.shape == (TS_BATCH, n, 4), "unexpected scan shape")
    return torch.from_numpy(pts).to(device)


def capture_point_inputs(model, points):
    """One kernel-path forward, recording what it hands the ball query and
    farthest-point sampling: -> (K9 calls, K10 calls), argument tuples."""
    from paddle3d_tpu_torch.ops import ball_query, fps
    balls, samples = [], []
    ball_fn, fps_fn = ball_query.ball_query_batched, \
        fps.farthest_point_sample_batched

    def ball_rec(*a):
        balls.append(a)
        return ball_fn(*a)

    def fps_rec(*a):
        samples.append(a)
        return fps_fn(*a)

    with mock.patch.object(ball_query, "ball_query_batched", ball_rec), \
            mock.patch.object(fps, "farthest_point_sample_batched", fps_rec):
        model.test_forward({"data": points})
    return balls, samples


def ball_work(radius, nsample, xyz, new_xyz, mask):
    """What one ball query's data needs and what the kernel runs, from the
    plain distance test and ops/ball_query.cull_plain: -> dict of `walk`
    (the tests of a walk in index order that stops at the nsample-th hit:
    the first kernel's), `need` (the in-ball valid points up to each
    query's nsample-th: the tests no walk can skip, K9's operation bound),
    `run` (the tests the culled kernel runs: the points the
    block's box marks in the chunks whose box the ball reaches, up to the
    chunk of the nsample-th hit), `skipped` (the share of (query, chunk)
    pairs the box test skips), `kept` (the share of (block, point) pairs
    the block's box marks), `hits` a query uncapped and `full` (the share
    of queries that fill nsample). Fails if a skipped chunk or an unmarked
    point holds a hit."""
    import torch
    import torch.nn.functional as F

    from paddle3d_tpu_torch.ops import ball_query
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    size, g = ball_query.CHUNK, ball_query.BLOCK_QUERIES
    visit, keep = ball_query.cull_plain(radius, xyz, new_xyz, mask)
    n_chunks = visit.shape[2]
    pad = n_chunks * size - n
    r2 = torch.tensor(radius * radius, dtype=torch.float32,
                      device=xyz.device)
    step = max(g, (1 << 25) // max(b * n, 1) // g * g)
    work = dict(walk=0, need=0, run=0, hits=0, full=0, missed=0)
    for lo in range(0, m, step):
        d = new_xyz[:, lo:lo + step, None, :] - xyz[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + \
            d[..., 2] * d[..., 2]
        inb = (d2 <= r2) & mask[:, None, :]
        mq = inb.shape[1]
        cum = torch.cumsum(inb, dim=2)
        total = cum[..., -1]
        work["walk"] += int(torch.clamp((cum < nsample).sum(dim=2) + 1,
                                        max=n).sum())
        work["need"] += int(torch.clamp(total, max=nsample).sum())
        work["hits"] += int(total.sum())
        work["full"] += int((total >= nsample).sum())
        marked = keep[:, lo // g:(lo + mq + g - 1) // g].repeat_interleave(
            g, dim=1)[:, :mq]
        vis = visit[:, lo:lo + mq]
        hit_c = F.pad(inb, (0, pad)).reshape(b, mq, n_chunks, size).sum(-1)
        mark_c = F.pad(marked, (0, pad)).reshape(b, mq, n_chunks,
                                                 size).sum(-1)
        work["missed"] += int((hit_c * ~vis).sum()) + int(
            (inb & ~marked).sum())
        before = torch.cumsum(hit_c, dim=2) - hit_c
        work["run"] += int((mark_c * (vis & (before < nsample))).sum())
    check(work["missed"] == 0, "the ball query's cull skips {} in-ball "
          "points".format(work["missed"]))
    work["skipped"] = 1.0 - visit.float().mean().item() if visit.numel() \
        else 0.0
    work["kept"] = keep.float().mean().item() if keep.numel() else 0.0
    work["hits"] /= max(b * m, 1)
    work["full"] /= max(b * m, 1)
    return work


def fps_plans(a, ref):
    """K10 at one call beyond its own choice: its plan, the time at every
    cluster size that holds the scan (each index-equal to ref) and the
    chain floor, the time of the same npoint picks over one point a thread
    of the chosen cluster (comparison launches, not counted). -> (plan,
    {cluster: ms}, floor ms or None on the scratch path)."""
    import torch

    from paddle3d_tpu_torch.ops import fps
    xyz, mask, npoint = a
    b, n, _ = xyz.shape
    plan = fps.plan(b, n)
    by_c = {}
    for c in (1, 2, 4, 8, 16):
        p = fps.plan(b, n, c)
        if p["points_a_thread"] == 0 or p["resident"] == 0:
            continue
        wrong = int((fps._call(xyz, mask, npoint, c) != ref).sum())
        check(wrong == 0, "farthest_point_sample at cluster size {} differs "
              "from its plain version: {} elements".format(c, wrong))
        by_c[c] = round(cuda_ms(lambda: fps._call(xyz, mask, npoint, c), 3),
                        4)
    floor = None
    if plan["cluster"] > 0:
        gen = torch.Generator(device=xyz.device).manual_seed(SEED)
        m = plan["cluster"] * plan["threads"]
        xf = torch.randn((b, m, 3), generator=gen, device=xyz.device)
        mf = torch.ones((b, m), dtype=torch.bool, device=xyz.device)
        floor = cuda_ms(lambda: fps._call(xf, mf, npoint, plan["cluster"]),
                        3)
    return plan, by_c, floor


def phase_point_kernels(balls, samples, label):
    """K9 and K10 against their plain versions on the inputs a forward
    handed them (indices and counts equal), their times and bounds.
    -> (errs, times, extra), each kernel summed over its calls."""
    import torch

    from paddle3d_tpu_torch.ops import ball_query, fps
    errs = {"ball_query": 0.0, "farthest_point_sample": 0.0}
    ms = {k: [0.0, 0.0] for k in errs}
    nbytes = {k: 0 for k in errs}
    ops = {k: 0 for k in errs}
    if balls:
        log("{}: the ball query at its {} call shapes, on the forward's "
            "inputs (per call: B x N supports, M queries, radius, nsample; "
            "kernel / plain ms, bound, tests: the first kernel's walk, run "
            "by the culled kernel, needed (the bound's count); share of "
            "(query, chunk) pairs the chunk boxes skip and of (block, point) "
            "pairs the block boxes mark; hits a query, share of queries that "
            "fill nsample)".format(label, len(balls)))
    if samples:
        log("{}: farthest-point sampling at its {} calls, on the inputs it "
            "was handed".format(label, len(samples)))
    for i, a in enumerate(balls):
        radius, nsample, xyz, new_xyz, mask = a
        idx, cnt = ball_query.ball_query_batched(*a)
        ref_idx, ref_cnt = ball_query.ball_query_plain(*a)
        torch.cuda.synchronize()
        wrong = int((idx != ref_idx).sum()) + int((cnt != ref_cnt).sum())
        errs["ball_query"] = max(errs["ball_query"], float(wrong))
        check(wrong == 0, "ball_query disagrees with its plain version at "
              "call {}: {} elements".format(i, wrong))
        b, n, _ = xyz.shape
        m = new_xyz.shape[1]
        t = cuda_ms(lambda: ball_query.ball_query_batched(*a), 20)
        tp = cuda_ms(lambda: ball_query.ball_query_plain(*a), 2)
        work = ball_work(*a)
        # supports, queries and mask read once, indices and counts written;
        # 8 f32 operations (3 differences, 3 products, 2 sums) an in-ball
        # valid point up to the query's nsample-th: tests no cull can skip
        call_bytes = 4 * (xyz.numel() + new_xyz.numel() + idx.numel() +
                          cnt.numel()) + mask.numel()
        one = bound(call_bytes, f32_ops=8 * work["need"])
        ms["ball_query"][0] += t
        ms["ball_query"][1] += tp
        nbytes["ball_query"] += call_bytes
        ops["ball_query"] += 8 * work["need"]
        log("  {} x {} supports ({} valid), {} queries, r {}, nsample {}: "
            "{:.4f} / {:.4f} ms, bound {:.5f} ms ({}; by the walk's tests "
            "{:.5f}), tests walk {} / run {} / need {} of {}, chunks skipped "
            "{:.4f}, points marked {:.4f}, hits a query {:.2f}, full {:.3f}"
            .format(b, n, int(mask.sum()), m, radius, nsample, t, tp, one[0],
                    one[1], bound(call_bytes, f32_ops=8 * work["walk"])[0],
                    work["walk"], work["run"], work["need"], b * m * n,
                    work["skipped"], work["kept"], work["hits"],
                    work["full"]))
    for i, a in enumerate(samples):
        xyz, mask, npoint = a
        idx = fps.farthest_point_sample_batched(*a)
        ref = fps.farthest_point_sample_plain(*a)
        torch.cuda.synchronize()
        wrong = int((idx != ref).sum())
        errs["farthest_point_sample"] = max(errs["farthest_point_sample"],
                                            float(wrong))
        check(wrong == 0, "farthest_point_sample disagrees with its plain "
              "version at call {}: {} elements".format(i, wrong))
        b, n, _ = xyz.shape
        t = cuda_ms(lambda: fps.farthest_point_sample_batched(*a), 5)
        tp = cuda_ms(lambda: fps.farthest_point_sample_plain(*a), 1)
        # the scan and its mask read once, the picks written; a step is 10
        # f32 operations a point (3 differences, 3 products, 2 sums, a
        # minimum and a comparison)
        call_bytes = 4 * (xyz.numel() + idx.numel()) + mask.numel()
        call_ops = 10 * b * n * (npoint - 1)
        one = bound(call_bytes, f32_ops=call_ops)
        ms["farthest_point_sample"][0] += t
        ms["farthest_point_sample"][1] += tp
        nbytes["farthest_point_sample"] += call_bytes
        ops["farthest_point_sample"] += call_ops
        plan, by_c, floor = fps_plans(a, ref)
        log("  farthest-point sampling {} x {} ({} valid) -> {}: {:.4f} / "
            "{:.4f} ms, {:.3f} us a step over {} dependent steps, cluster "
            "of {} CTAs x {} threads x {} points a thread ({} clusters "
            "resident as launched, {} with an SM a CTA), bound {:.5f} ms "
            "({}), chain floor {} (one point a thread, the same cluster); "
            "ms by cluster size {}, each index-equal".format(
                b, n, mask.sum(dim=1).tolist(), npoint, t, tp,
                t * 1e3 / max(npoint - 1, 1), npoint - 1, plan["cluster"],
                plan["threads"], plan["points_a_thread"], plan["resident"],
                plan["resident_alone"], one[0], one[1],
                "none (scratch path)" if floor is None else
                "{:.4f} ms, {:.3f} us a step".format(
                    floor, floor * 1e3 / max(npoint - 1, 1)), by_c))
    times = {k: tuple(v) for k, v in ms.items()}
    # no single PyTorch call computes either function: no library time
    extra = {k: (None,) + bound(nbytes[k], f32_ops=ops[k]) for k in errs}
    for name in PT_KERNELS:
        if times[name][0] > 0:
            log("  {}, a forward's calls together: {:.4f} ms against plain "
                "{:.4f} ms, bound {:.5f} ms ({}), elements that differ {:.0f}"
                .format(name, times[name][0], times[name][1],
                        extra[name][1], extra[name][2], errs[name]))
    return errs, times, extra


def check_box_outputs(out, k, classes):
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    check(tuple(boxes.shape) == (TS_BATCH, k, 7), "box3d_lidar shape")
    check(tuple(scores.shape) == (TS_BATCH, k) and
          tuple(labels.shape) == (TS_BATCH, k), "scores/labels shape")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite outputs")
    kept = labels >= 0
    check(bool((labels[kept] < classes).all() & (labels[~kept] == -1).all()
               & (scores[~kept] == -1).all() & (scores[kept] >= 0).all()),
          "labels or scores outside the classes / padding convention")
    return kept.sum(dim=1).tolist()


def compare_outputs(out, ref):
    """Labels equal, scores within 1e-5, boxes within 1e-4 of the plain
    path's."""
    import torch
    check(torch.equal(out["label_preds"], ref["label_preds"]),
          "labels differ from the plain path")
    s_err = (out["scores"] - ref["scores"]).abs().max().item()
    b_err = (out["box3d_lidar"] - ref["box3d_lidar"]).abs().max().item()
    check(s_err <= 1e-5 and b_err <= 1e-4, "outputs differ from plain path: "
          "scores {:.3e}, boxes {:.3e}".format(s_err, b_err))
    return s_err, b_err


def ts_staged(model, points):
    """The two-stage test_forward in its stages: -> (BEV, sparse stages,
    proposals, support set, outputs)."""
    import torch
    with torch.no_grad():
        preds, bev, stages = model._stage1(points, False)
        rois = model.rpn_head.proposals(preds)
        supports = model._support_set(points, bev, stages)
        cls_pred, reg_pred = model.roi_head(rois[0], supports)
        return bev, stages, rois, supports, model._refine(*rois, cls_pred,
                                                          reg_pred)


def ts_stages(model, points):
    from paddle3d_tpu_torch.ops.voxelize import voxel_mean_batch
    vox = model.voxelizer

    def rpn(v):
        bev, stages = v
        preds = model.rpn_head(model.neck(model.backbone(
            bev.permute(0, 3, 1, 2).contiguous())))
        return bev, stages, preds

    stage_times([
        ("voxel_mean", lambda p: voxel_mean_batch(
            p, vox.voxel_size, vox.point_cloud_range,
            vox.max_num_points_in_voxel, vox.max_num_voxels_for(False),
            model.voxel_encoder.in_channels)),
        ("sparse middle", lambda v: model.middle_encoder(
            v[0], v[1], v[3], return_stages=True)),
        ("backbone + neck + RPN convs", rpn),
        ("proposals (decode + NMS)", lambda v: v[:2] + (
            model.rpn_head.proposals(v[2]),)),
        ("support set", lambda v: (v[2], model._support_set(points, v[0],
                                                            v[1]))),
        ("RoI head", lambda v: model.roi_head(v[0][0], v[1])),
    ], points, 3)


def phase_kitti_voxel_kernels(model, points):
    """K8 at the eight conv calls of the KITTI voxel grid (map kernel at its
    seven builds) and the dense BEV's segment sum (K2 or K7, as the density
    rule picks), on the inputs a forward hands them, against their plain
    versions (the conv bit-equal, the map index-equal); logged beside the
    nuScenes shapes of phase 7, which stay the ones in the record."""
    import torch

    from paddle3d_tpu_torch.ops import sorted_scatter
    convs, maps, bevs = capture_vx_inputs(model, points, 8, 7)
    ms = plain_ms = tot_bytes = tot_ops = 0.0
    for a, k in convs:
        one = conv_case(a, k)
        ms, plain_ms = ms + one["ms"], plain_ms + one["plain_ms"]
        tot_bytes += one["bytes"]
        tot_ops += one["ops"]
        bnd = bound(one["bytes"], f32_ops=one["ops"])
        log("  sparse conv {} x {} -> {} ({}): {:.4f} / {:.4f} ms, bound "
            "{:.4f} ms ({}), valid rows {}, hits a row {:.2f}, products "
            "computed / needed {:.3f}, max_abs_err {:.3e} of {:.3e}".format(
                a[0].shape[1], a[2].shape[-1], a[3].shape[-1],
                "subm" if a[0] is a[1] else "strided", one["ms"],
                one["plain_ms"], bnd[0], bnd[1], one["valid"],
                sum(one["taps"]) / max(one["valid"], 1), one["computed"],
                one["err"], one["top"]))
    map_ms = map_plain_ms = map_bytes = 0.0
    for m in maps:
        t, tp, nbytes = map_case(m)
        map_ms, map_plain_ms, map_bytes = (map_ms + t, map_plain_ms + tp,
                                           map_bytes + nbytes)
    both = bound(tot_bytes, f32_ops=tot_ops)
    log("  sparse_conv3d on the KITTI grid, 8 conv and 7 map launches a "
        "forward: {:.4f} ms (conv {:.4f}, map {:.4f}) against plain {:.4f} "
        "ms (conv {:.4f}, map {:.4f}), conv bound {:.4f} ms ({}), map bound "
        "{:.4f} ms (bytes); bit-equal".format(
            ms + map_ms, ms, map_ms, plain_ms + map_plain_ms, plain_ms,
            map_plain_ms, both[0], both[1], bound(map_bytes)[0]))
    keys, rows, cells = bevs[0]
    b, n, c = rows.shape
    name = sorted_scatter.kernel_for(n, cells)
    if name == "sorted_segment_sum":
        k2_call("PV-RCNN / Voxel-RCNN serving (the dense BEV of their "
                "shared stage 1)", keys, rows, cells, False)
    table = sorted_scatter.scatter_rows(keys, rows, cells, False)
    ref = sorted_scatter.scatter_rows_plain(keys, rows, cells, False)
    torch.cuda.synchronize()
    e = (table - ref).abs().max().item()
    check(e <= 1e-5 * ref.abs().max().item(),
          "{} disagrees with its plain version on the KITTI BEV".format(name))
    one = bound(scatter_bytes(keys, cells, c, table.numel()))
    log("  dense BEV at B={} N={} cells={} C={} through {}: {:.4f} ms vs "
        "plain {:.4f} ms, bound {:.4f} ms ({}), max_abs_err {:.3e}".format(
            b, n, cells, c, name,
            cuda_ms(lambda: sorted_scatter.scatter_rows(keys, rows, cells,
                                                        False), 50),
            cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
                keys, rows, cells, False), 10), one[0], one[1], e))


def _bev_rows(model, points):
    """Rows a scan hands the dense BEV's segment sum: the last stage's
    capacity (an eighth of the voxel rows, which a scan of N points caps
    at N, unless the config sets the stage capacities)."""
    caps = model.middle_encoder.stage_capacities
    if caps is not None:
        return caps[3]
    rows = min(model.voxelizer.max_num_voxels_for(False), points.shape[1])
    return max(rows // 8, 1)


def phase_two_stage(device, path, name, want):
    """One two-stage KITTI model through the kernels and on the plain
    versions. want: the launches a forward must count."""
    import torch

    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = build_scaled(device, path)
    points = make_kitti_points(device, "pv_rcnn")
    log("phase 8: {} KITTI serving at B={} N={}, voxels per scan before "
        "the cap of {}: {}".format(
            name, TS_BATCH, points.shape[1],
            model.voxelizer.max_num_voxels_for(False),
            voxels_per_scan(model, points)))
    balls, samples = capture_point_inputs(model, points)
    check(len(balls) == want["ball_query"] and
          len(samples) == want["farthest_point_sample"],
          "expected {} ball queries and {} samplings, got {} and {}".format(
              want["ball_query"], want["farthest_point_sample"], len(balls),
              len(samples)))
    errs, times, extra = phase_point_kernels(balls, samples, "phase 8")
    del balls, samples
    if want["farthest_point_sample"]:     # once: both models share stage 1
        phase_kitti_voxel_kernels(model, points)

    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_box_outputs(out, model.rpn_head.num_proposals,
                             model.rpn_head.num_classes)
    d, h, w = model.middle_encoder.grid
    rule = sorted_scatter.kernel_for(
        _bev_rows(model, points), (d // 8) * (h // 8) * (w // 8))
    log("  test_forward through the kernels: launches {}; proposals refined "
        "per scan (of {}) {}; the density rule sends the dense BEV to {}"
        .format(launches, model.rpn_head.num_proposals, kept, rule))
    other = ({"sorted_segment_sum", "sorted_segment_sum_dense"} -
             {rule}).pop()
    check(all(launches[k] == v for k, v in want.items()) and
          launches[rule] == 1 and launches[other] == 0,
          "the {} path's launches are not {} and one {}: {}".format(
              name, want, rule, launches))
    check(all(k == model.rpn_head.num_proposals for k in kept),
          "the RPN left proposal slots empty: {}".format(kept))
    got = ts_staged(model, points)
    with plain_path():
        _build.reset_launches()
        ref = ts_staged(model, points)
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          "the plain path launched a kernel: {}".format(_build.LAUNCHES))
    check(torch.equal(got[4]["label_preds"], out["label_preds"]),
          "test_forward and its stages differ")
    c_err = (got[0] - ref[0]).abs().max().item()
    rows = []
    for st, _ in got[1]:
        outside = st.mask & (st.coords[..., 0] >= st.grid[0])
        check(not bool(outside.any()), "a valid stage voxel lies outside "
              "its grid {}".format(st.grid))
        rows.append(st.mask.sum(dim=1).tolist())
    check(torch.equal(got[2][2], ref[2][2]) and
          torch.equal(got[2][0], ref[2][0]),
          "proposals differ from the plain path")
    if isinstance(got[3], tuple):                  # PV-RCNN's keypoints
        check(torch.equal(got[3][0], ref[3][0]) and
              torch.equal(got[3][2], ref[3][2]),
              "keypoints differ from the plain path")
        f_err = (got[3][1] - ref[3][1]).abs().max().item()
        check(f_err <= 1e-4 * ref[3][1].abs().max().item(),
              "keypoint features differ from the plain path")
    s_err, b_err = compare_outputs(got[4], ref[4])
    log("  vs the plain path on the card: BEV max_abs_err {:.3e} (tolerance "
        "1e-5 of its largest value {:.3e}), proposals{} equal, labels equal, "
        "scores {:.3e} (1e-5), boxes {:.3e} (1e-4); valid rows per stage "
        "and scan {} (none outside its grid)".format(
            c_err, ref[0].abs().max().item(),
            " and keypoints" if isinstance(got[3], tuple) else "", s_err,
            b_err, rows))
    check(c_err <= 1e-5 * ref[0].abs().max().item(),
          "the BEV differs from the plain path")
    del got, ref
    phase_timing(model, points, "phase 8 ({})".format(name), warmups=1)
    ts_stages(model, points)
    return errs, times, extra, launches


def iassd_stages(model, points):
    import torch

    def prepare(p):
        mask = torch.isfinite(p).all(dim=-1)
        return (torch.where(mask[..., None], p[..., :3], 0.),
                torch.where(mask[..., None], p[..., 3:], 0.), mask, None)

    def layer(mod):
        def run(v):
            xyz, feats, mask, conf = mod(*v)
            return xyz, feats, mask, conf if conf is not None else v[3]
        return run

    def vote(v):
        votes, vfeats, _ = model.vote(*v[:3])
        return votes, model._aggregate(votes, v[0], vfeats, v[2]), v[2]

    stages = [("mask", prepare)] + [
        ("SA layer {}".format(i + 1), layer(mod))
        for i, mod in enumerate(model.sa_modules)] + [
        ("vote + aggregation", vote),
        ("heads", lambda v: (model.cls_head(v[1]), model.reg_head(v[1])))]
    stage_times(stages, points, 3)


def phase_iassd(device):
    """IA-SSD KITTI serving through K9 and K10 and on the plain versions,
    timing, memory, a profile and per-stage times."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = build_scaled(device, IASSD)
    points = make_kitti_points(device, "iassd")
    balls, samples = capture_point_inputs(model, points)
    check(len(balls) == 10 and len(samples) == 3,
          "expected 10 ball queries and 3 samplings, got {} and {}".format(
              len(balls), len(samples)))
    check(tuple(samples[0][0].shape) == (TS_BATCH, 16384, 3) and
          samples[0][2] == 4096 and
          tuple(balls[0][3].shape) == (TS_BATCH, 4096, 3),
          "not the IA-SSD first-layer shapes")
    errs, times, extra = phase_point_kernels(balls, samples, "phase 9")
    del balls, samples

    _build.reset_launches()
    out = model.test_forward({"data": points})
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    kept = check_box_outputs(out, model.nms_cfg["post_max_size"],
                             model.num_classes)
    log("  IA-SSD test_forward through the kernels: launches {}; boxes NMS "
        "kept per scan (of {}) {}".format(
            launches, model.nms_cfg["post_max_size"], kept))
    check(launches["ball_query"] == 10 and
          launches["farthest_point_sample"] == 3,
          "the IA-SSD path's launches are not 10 and 3: {}".format(launches))
    check(all(k > 0 for k in kept), "a scan kept no box")
    _build.reset_launches()
    with plain_path():
        ref = model.test_forward({"data": points})
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()),
          "the plain path launched a kernel: {}".format(_build.LAUNCHES))
    s_err, b_err = compare_outputs(out, ref)
    log("  vs the plain path on the card: labels equal, scores max_abs_err "
        "{:.3e} (tolerance 1e-5), boxes {:.3e} (tolerance 1e-4)".format(
            s_err, b_err))
    phase_timing(model, points, "phase 9 (IA-SSD)", warmups=1)
    iassd_stages(model, points)
    return errs, times, extra, launches


CP_TRAIN_ITERS = 2      # train steps timed per path (halves of 1)


def cp_train_setup(device):
    """The nuScenes pillar config in train mode (seeded random weights),
    its OneCycleAdam, schedule and step, and the train batch: 8 scans of
    250,000 points and bench.make_gt's boxes (64 a scan, 9 columns, ten
    classes, a quarter padding)."""
    import numpy as np
    import torch

    import bench
    from paddle3d_tpu_torch.apis import Config, make_train_step
    cfg = Config(path=NUSCENES, device=device)
    model = cfg.model.train()
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    check(isinstance(optimizer, torch.optim.AdamW) and
          optimizer.param_groups[0]["betas"] == (0.95, 0.99),
          "not the config's OneCycleAdam")
    boxes, labels = bench.make_gt(np.random.default_rng(SEED), BATCH,
                                  "centerpoint")
    batch = {"data": make_cp_points(device, batch=BATCH),
             "gt_boxes": torch.from_numpy(boxes).to(device),
             "gt_labels": torch.from_numpy(labels).to(device)}
    return model, optimizer, scheduler, make_train_step(
        lr_scheduler=scheduler), batch


def capture_sw_inputs(step, model, optimizer, batch):
    """One kernel-path train step, recording what it hands K12 forward
    (vals, keys, max_len) and backward (offsets, cotangent, max_len, keys)
    and the canvas's row-major sum (keys, rows, cells, split)."""
    from paddle3d_tpu_torch.ops import seg_window, sorted_scatter
    fwds, bwds = [], []
    fwd_fn, bwd_fn = seg_window.seg_window_max_fwd, \
        seg_window.seg_window_max_bwd

    def fwd_rec(*a):
        fwds.append(a)
        return fwd_fn(*a)

    def bwd_rec(*a):
        bwds.append(a)
        return bwd_fn(*a)

    with mock.patch.object(seg_window, "seg_window_max_fwd", fwd_rec), \
            mock.patch.object(seg_window, "seg_window_max_bwd", bwd_rec), \
            recorded(sorted_scatter, "scatter_rows") as sums:
        step(model, optimizer, batch)
    check(len(fwds) == 2 and len(bwds) == 2,
          "expected two K12 forwards and backwards a step, got {} and {}"
          .format(len(fwds), len(bwds)))
    check(len(sums) == 1, "expected one row-major sum a step, got {}".format(
        len(sums)))
    return fwds, bwds, sums[0][0]


def sw_key_stats(keys, win):
    """From sorted keys [B, N]: the share of (row, doubling step) pairs
    with a same-key row at +-d (the rows the K12 forward works on at that
    step) and the mean same-key rows within +-win of a row (the probes its
    backward makes)."""
    import torch
    b, n = keys.shape
    idx = torch.arange(n, device=keys.device).expand(b, n)
    head = torch.ones_like(keys, dtype=torch.bool)
    head[:, 1:] = keys[:, 1:] != keys[:, :-1]
    tail = torch.ones_like(head)
    tail[:, :-1] = head[:, 1:]
    start = torch.cummax(torch.where(head, idx, 0), 1).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(tail, idx, n), [1]),
                                  1).values, [1])
    dn = torch.clamp(idx - start, max=win)
    up = torch.clamp(end - idx, max=win)
    reach = torch.maximum(dn, up)
    live = torch.stack([reach >= (1 << s)
                        for s in range(win.bit_length())]).float()
    return live.mean().item(), (dn + up).float().mean().item()


def same_bits(a, b):
    """Equal f32 or f64 bit patterns (tells -0 from +0, as torch.equal
    does not)."""
    import torch
    bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


def phase_sw_kernels(fwds, bwds):
    """K12 forward and backward against their plain versions on the inputs
    of a train step (layer 0 [8, 250k, 32], layer 1 [8, 250k, 64]); times
    and bounds are the sums of the step's two calls."""
    import torch

    from paddle3d_tpu_torch.ops import seg_window
    errs = {"seg_window_max": 0.0, "seg_window_max_bwd": 0.0}
    times = {name: [0.0, 0.0] for name in SW_KERNELS}
    nbytes = {name: 0 for name in SW_KERNELS}
    ops = {name: 0 for name in SW_KERNELS}
    note_ms = 0.0
    for (vals, keys, p), (off_in, g, _, bkeys) in zip(fwds, bwds[::-1]):
        out, off = seg_window.seg_window_max_fwd(vals, keys, p)
        ref, ref_off = seg_window.seg_window_max_plain(vals, keys, p)
        gin = seg_window.seg_window_max_bwd(off_in, g, p, keys)
        ref_gin = seg_window.seg_window_max_bwd_plain(off_in, g.contiguous(),
                                                      p)
        torch.cuda.synchronize()
        check(tuple(off_in.shape) == tuple(vals.shape) and
              torch.equal(bkeys, keys),
              "a backward met another layer's shape or keys")
        check(torch.equal(off, ref_off), "K12 offsets differ from plain")
        check(same_bits(out, ref) and same_bits(gin, ref_gin),
              "K12 values or gradients differ from plain in their bits")
        errs["seg_window_max"] = max(errs["seg_window_max"],
                                     (out - ref).abs().max().item())
        errs["seg_window_max_bwd"] = max(errs["seg_window_max_bwd"],
                                         (gin - ref_gin).abs().max().item())
        b, n, c = vals.shape
        win = seg_window.window_of(p)
        steps = win.bit_length()
        shape_t = [
            cuda_ms(lambda: seg_window.seg_window_max_fwd(vals, keys, p), 20),
            cuda_ms(lambda: seg_window.seg_window_max_plain(vals, keys, p),
                    3),
            cuda_ms(lambda: seg_window.seg_window_max_bwd(off_in, g, p, keys),
                    20),
            cuda_ms(lambda: seg_window.seg_window_max_bwd_plain(off_in, g, p),
                    2)]
        for i, name in enumerate(SW_KERNELS):
            times[name][0] += shape_t[2 * i]
            times[name][1] += shape_t[2 * i + 1]
        # each element read and written once (f32 values, int8 offsets,
        # int32 keys a row); the data needs two compares a doubling step
        # forward and one add backward (each cotangent lands on one row)
        nbytes["seg_window_max"] += 4 * b * n + 9 * b * n * c
        nbytes["seg_window_max_bwd"] += 9 * b * n * c
        ops["seg_window_max"] += 2 * steps * b * n * c
        ops["seg_window_max_bwd"] += b * n * c
        # no single PyTorch call computes this function (window and
        # arg-max): scatter_reduce_ amax over segment ids plus a gather,
        # timed as a note
        seg = torch.cumsum(torch.nn.functional.pad(
            keys[:, 1:] != keys[:, :-1], (1, 0)), dim=1) + (
                torch.arange(b, device=keys.device)[:, None] * n)
        idx = seg.reshape(-1, 1).expand(-1, c)
        flat = vals.reshape(-1, c)
        acc = torch.full_like(flat, -float("inf"))

        def scatter_gather():
            acc.fill_(-float("inf"))
            acc.scatter_reduce_(0, idx, flat, reduce="amax")
            return torch.gather(acc, 0, idx)
        note_ms += cuda_ms(scatter_gather, 10)
        live, probes = sw_key_stats(keys, win)
        log("  K12 at B={} N={} C={} P={} (window {} rows a side): forward "
            "{:.4f} ms (plain {:.4f}), backward {:.4f} ms (plain {:.4f}); "
            "rows whose max came from another row {:.3f}; live (row, step) "
            "pairs {:.4f}, in-segment probes a row {:.3f} of {}".format(
                b, n, c, p, win, shape_t[0], shape_t[1], shape_t[2],
                shape_t[3], (off != 0).float().mean().item(), live, probes,
                2 * win))
    extra = {name: (None,) + bound(nbytes[name], f32_ops=ops[name])
             for name in SW_KERNELS}
    log("  scatter_reduce_(amax) + gather over segment ids (not the same "
        "function: no window, no arg-max), both layers: {:.4f} ms".format(
            note_ms))
    report(SW_KERNELS, errs, {k: tuple(v) for k, v in times.items()}, extra)
    return errs, {k: tuple(v) for k, v in times.items()}, extra


def cp_train_stages(model, optimizer, batch, iters):
    """Host-clock ms of a train step's stages, each ended by a synchronize
    (averaged over iters steps after a warm-up): the canvas forward, the
    dense stack forward (backbone, neck, head), targets + loss, the dense
    stack backward, the canvas backward, the optimizer (clip and step)."""
    import torch

    from paddle3d_tpu_torch.ops.box_ops import limit_period
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    names = ("canvas forward", "dense stack forward", "targets + loss",
             "dense stack backward", "canvas backward", "optimizer")

    def run():
        ms, t0 = [], time.perf_counter()

        def lap():
            nonlocal t0
            torch.cuda.synchronize()
            t = time.perf_counter()
            ms.append((t - t0) * 1e3)
            t0 = t
        optimizer.zero_grad(set_to_none=True)
        canvas = fused_pillar_canvas(model.voxelizer, model.voxel_encoder,
                                     model.middle_encoder, batch["data"],
                                     True)
        lap()
        leaf = canvas.detach().requires_grad_()
        preds = model.bbox_head(model.neck(model.backbone(
            leaf.permute(0, 3, 1, 2).contiguous())))
        lap()
        gt = batch["gt_boxes"]
        gt = torch.cat([gt[..., :6], limit_period(gt[..., 6:7], 0.5,
                                                  2 * math.pi), gt[..., 7:]],
                       dim=-1)
        loss = model.bbox_head.loss(
            preds, model.target_generator(gt, batch["gt_labels"]))["loss"]
        lap()
        loss.backward()
        lap()
        canvas.backward(leaf.grad)
        lap()
        optimizer.step()
        lap()
        return ms

    run()
    ms = [sum(v) / iters for v in zip(*(run() for _ in range(iters)))]
    log("  train step stages (host clock, synchronised): " + ", ".join(
        "{} {:.3f} ms".format(n, t) for n, t in zip(names, ms)))


def phase_cp_train(device):
    """CenterPoint-pillars nuScenes training through the kernels and on the
    plain versions, from one saved state."""
    import tempfile

    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, optimizer, scheduler, step, batch = cp_train_setup(device)
    restore = saved_state(model, optimizer, scheduler)

    pfn = model.voxel_encoder
    check([layer.units for layer in pfn.pfn_layers] == [32, 64] and
          model.voxelizer.max_num_voxels_for(True) == 30000,
          "not the nuScenes train PFN")
    fwds, bwds, canvas_sum = capture_sw_inputs(step, model, optimizer, batch)
    restore()
    log("phase 10: CenterPoint-nuScenes training at B={} N={}, K12 and K7 "
        "on the train step's inputs".format(BATCH, CP_POINTS))
    errs, times, extra = phase_sw_kernels(fwds, bwds)
    del fwds, bwds
    k7_parts("the CenterPoint-pillars train canvas", *canvas_sum)
    del canvas_sum

    keys = ["loss"] + ["{}_{}".format(k, i) for k in ("hm_loss", "loc_loss")
                       for i in range(6)]
    kernel = record_step(step, model, optimizer, batch)
    restore()
    with plain_path():
        plain = record_step(step, model, optimizer, batch)
    restore()
    launches = kernel[3]
    log("  train step (OneCycleAdam, clip 35, OneCycleWarmupDecayLr), loss "
        "{:.5f}; launches {}; plain step launches {}".format(
            kernel[0]["loss"], launches, plain[3]))
    check(all(launches[k] == v for k, v in CPT_LAUNCHES.items()),
          "the CenterPoint train step launched {} where {} was due".format(
              launches, CPT_LAUNCHES))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    step_errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6, keys)
    log("  vs the plain step (deterministic cuDNN, TF32 off): losses "
        "{:.3e} (tolerance 1e-6), grads {:.3e} (1e-4), running stats "
        "{:.3e} (1e-6), each relative to the tensor's largest value"
        .format(*step_errs))
    with tempfile.TemporaryDirectory() as tmp:
        phase_cp_tiny_train(tmp)

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch)

    for _ in range(2):                       # warm-up, both paths
        step(model, optimizer, batch)
        with plain_path():
            step(model, optimizer, batch)
    rates = {"kernels": [], "plain": []}
    half = CP_TRAIN_ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx:
                rates[path].append(timed_train_scans_per_s(
                    step, model, optimizer, batch, half))
    rate = {k: BATCH * CP_TRAIN_ITERS / sum(BATCH * half / r for r in v)
            for k, v in rates.items()}
    log("  {} train steps of batch {} per path (kernel/plain/plain/kernel "
        "halves, cudnn.benchmark on): kernel path {:.2f} scans/s, plain "
        "path {:.2f} scans/s; halves {}".format(
            CP_TRAIN_ITERS, BATCH, rate["kernels"], rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    step(model, optimizer, batch)
    log("  peak device memory of one train step: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: step(model, optimizer, batch))
    cp_train_stages(model, optimizer, batch, 3)
    return errs, times, extra, launches


def phase_cp_tiny_train(tmp):
    """The tiny two-layer CenterPoint config (PFN [16, 16], 5 channels, two
    tasks, a velocity head) written to tmp: its train step, kernels on the
    card against the plain versions on the CPU."""
    import numpy as np
    import torch
    import yaml

    from paddle3d_tpu_torch.apis import Config, make_train_step
    with open(os.path.join(REPO, "configs", "centerpoint",
                           "centerpoint_synthetic_tiny.yml")) as f:
        dic = yaml.safe_load(f)
    m = dic["model"]
    m["voxel_encoder"].update(in_channels=5, feat_channels=[16, 16])
    m["middle_encoder"]["in_channels"] = 16
    m["backbone"]["in_channels"] = 16
    m["bbox_head"]["tasks"] = [dict(num_class=1, class_names=["car"]),
                               dict(num_class=2, class_names=["truck", "bus"])]
    m["bbox_head"]["common_heads"]["vel"] = [2, 2]
    m["bbox_head"]["code_weights"] = [1.0] * 8 + [0.2, 0.2]
    path = os.path.join(tmp, "centerpoint_tiny_2l.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dic, f)
    rng = np.random.default_rng(SEED)
    boxes = np.zeros((2, 6, 9), np.float32)
    boxes[..., :2] = rng.uniform([2, -14], [30, 14], (2, 6, 2))
    boxes[..., 2:6] = [-1., 1.8, 4.5, 1.6]
    boxes[..., 6] = rng.uniform(-3, 3, (2, 6))
    boxes[..., 7:9] = rng.normal(0, 2., (2, 6, 2))
    labels = np.array([[0, 1, 2, 0, -1, -1], [2, 2, 1, -1, -1, -1]])
    pts = rng.uniform([0, -16, -2, 0, 0], [32, 16, 2, 1, .45], (2, 1024, 5))
    pts[:, :512, :2] = boxes[:, :4, :2].repeat(128, axis=1) + rng.normal(
        0, 1., (2, 512, 2))
    pts[:, -8:, 0] = 100.
    out = []
    for device in ("cpu", "cuda"):
        cfg = Config(path=path, device=device)
        model = cfg.model.train()
        step = make_train_step(lr_scheduler=cfg.lr_scheduler)
        batch = {"data": torch.from_numpy(pts.astype(np.float32)),
                 "gt_boxes": torch.from_numpy(boxes),
                 "gt_labels": torch.from_numpy(labels)}
        res = record_step(step, model, cfg.optimizer,
                          {k: v.to(device) for k, v in batch.items()})
        out.append(tuple({k: v.cpu() for k, v in r.items()}
                         if i in (1, 2) else r for i, r in enumerate(res)))
    keys = ["loss"] + ["{}_{}".format(k, i) for k in ("hm_loss", "loc_loss")
                       for i in range(2)]
    errs = compare_steps(out[1], out[0], 1e-4, 1e-3, 1e-4, keys)
    check(out[1][3]["seg_window_max_bwd"] == 2,
          "the tiny card step missed K12's backward")
    log("  tiny two-layer train step, card kernels vs CPU plain: losses "
        "{:.3e} (tolerance 1e-4), grads {:.3e} (1e-3), running stats "
        "{:.3e} (1e-4), relative".format(*errs))


TS_TRAIN_BATCH = 2      # the KITTI two-stage configs' batch_size
TS_TRAIN_ITERS = 2      # train steps timed per path (halves of 1)
PV_TRAIN_STEPS = 3
# The RPN head starts from the upstream AnchorHeadSingle's init (box weights
# N(0, RPN_BOX_STD), the class bias at the prior RPN_PRIOR) instead of the
# uniform one the JAX package and the port give it: the first proposals are
# then anchor-sized boxes, as a trained RPN's are, and the focal loss starts
# where the upstream training starts it.
RPN_BOX_STD, RPN_PRIOR = 0.001, 0.01
POOL_MIN = 4            # RoIs a pool holds per scan at the compared step
GT_JITTER = 0.03        # of a box's size, a gt box's offset off its proposal
# AdamW's first steps move every weight by lr, which throws the proposals
# off the gt boxes for a few steps until the RPN has learnt them: the
# compared step and the ten checked steps come after these warm-up steps
TS_WARM_STEPS = 20
# f32 arithmetic (add, sub, mul, div, sqrt, abs) that K11's function needs,
# counted from its plain version (paddle3d_tpu/ops/iou3d_nms.py:46-108):
# a box's circle (centre 8, circumradius 24), once a box of either set; the
# four clip edges of a box of the second set (6 each), once a box; the
# guard (centre distance 6, ra + rb 1) a pair; and for a pair the guard
# lets through 22 a slot over 4 + 8 + 16 + 32 slots (the side 5, the
# crossing 9, the projection 8; the next slot's side is its neighbour's),
# 4 a shoelace term over 64 slots and 0.5 |sum|
IOU_BOX_OPS, IOU_EDGE_OPS, IOU_GUARD_OPS = 32, 24, 7
IOU_CLIP_OPS = 22 * (4 + 8 + 16 + 32) + 4 * 64 + 2
# a Voxel-RCNN train step: K11 once (boxes_iou3d of the proposal targets),
# K9 twice (the RoI grid over two sparse levels), the dense BEV's segment
# sum and its VJP; the sparse convs train on the gather route (no K8), and
# no K10 or pillar kernel
TST_LAUNCHES = {"pairwise_intersection_area": 1, "ball_query": 2,
                "sorted_table_gather": 1, "sparse_conv3d": 0,
                "sparse_conv3d_map": 0, "farthest_point_sample": 0,
                "fused_pfn_rows": 0,
                "fused_pfn_rows_2l": 0, "pfn_stats": 0, "pfn_bwd": 0,
                "sorted_segment_sum_cm": 0, "seg_window_max": 0,
                "seg_window_max_bwd": 0}


def tie_lattice(device):
    """Boxes with exactly shared edges and corners: unit and 2 x 1 m boxes
    centred on a 1 m lattice (half of them on half-metres), identical
    duplicates, yaw a multiple of pi/2 (whose f32 cosines are not 0) ->
    (boxes_a, boxes_b) [2, 64, 7]."""
    import numpy as np
    import torch
    g = np.stack(np.meshgrid(np.arange(8.), np.arange(8.), indexing="ij"),
                 -1).reshape(-1, 2)
    a = np.zeros((2, 64, 7), np.float32)
    a[:, :, :2] = g
    a[1, :, :2] += 0.5 * (np.arange(64) % 2)[:, None]
    a[:, :, 2] = -1.
    a[:, :, 3:6] = np.where((np.arange(64) % 3 == 0)[:, None],
                            [2., 1., 1.5], [1., 1., 1.5])
    a[:, :, 6] = (np.arange(64) % 4) * np.pi / 2
    b = a.copy()
    b[:, 1::2] = a[:, ::2]                      # duplicates of neighbours
    b[:, ::4, 6] += np.pi
    return (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def clustered_boxes(device, b=8, n=1000, seed=SEED):
    """b scans of n car-sized boxes over 80 m x 80 m and their jittered
    copies (the all-pairs shape of the JAX docstring, 8 x 1000 x 1000)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = np.zeros((b, n, 7), np.float32)
    a[..., :2] = rng.uniform([0, -40], [80, 40], (b, n, 2))
    a[..., 2] = rng.uniform(-2, 0, (b, n))
    a[..., 3:6] = rng.uniform([1.4, 3.2, 1.3], [2.0, 4.6, 1.8], (b, n, 3))
    a[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    c = a.copy()
    c[..., :2] += rng.normal(0, 1.0, (b, n, 2))
    c[..., 6] += rng.normal(0, 0.3, (b, n))
    return torch.from_numpy(a).to(device), torch.from_numpy(c).to(device)


def iou_work(ca, cb):
    """Bytes and operations K11's data needs: corners read once, areas
    written once; the circles and clip edges once a box, the guard for
    every pair and the clip for the pairs it lets through (the plain
    version's guard). -> (bytes, ops, pairs, pairs clipped)."""
    import torch

    from paddle3d_tpu_torch.ops import iou_clip
    cax, cay, ra = iou_clip._circle(ca)
    cbx, cby, rb = iou_clip._circle(cb)
    dx = cax[..., :, None] - cbx[..., None, :]
    dy = cay[..., :, None] - cby[..., None, :]
    clipped = int((torch.sqrt(dx * dx + dy * dy) <=
                   ra[..., :, None] + rb[..., None, :]).sum())
    pairs = dx.numel()
    nbytes = 4 * (ca.numel() + cb.numel() + pairs)
    ops = IOU_BOX_OPS * (ra.numel() + rb.numel()) + IOU_EDGE_OPS * \
        rb.numel() + IOU_GUARD_OPS * pairs + IOU_CLIP_OPS * clipped
    return nbytes, ops, pairs, clipped


def iou_chain_pair(device):
    """One pair that passes the guard and clips through all four stages: a
    4 x 2 m box at the origin and the same box turned by 0.3 rad ->
    (corners a, corners b), each [1, 1, 4, 2]."""
    import torch

    from paddle3d_tpu_torch.ops.box_ops import boxes_to_corners_bev
    a = torch.tensor([[[0., 0., 0., 4., 2., 1.5, 0.]]], device=device)
    b = a.clone()
    b[..., 6] = 0.3
    return boxes_to_corners_bev(a), boxes_to_corners_bev(b)


def iou_chain_floor(device, iters=50):
    """K11's chain floor: ms a launch of its C entry on one pair that
    passes the guard (iou_chain_pair), the launch and one pair's four
    stages and 64-term fold with nothing in parallel; not counted as a
    path's launch."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    ca, cb = iou_chain_pair(device)
    out = torch.empty((1, 1, 1), device=device)
    fn = _build.function("p3d_pairwise_intersection_area")
    args = (ca.data_ptr(), cb.data_ptr(), out.data_ptr(), 1, 1, 1,
            _build.stream_ptr(device))
    return cuda_ms(lambda: fn(*args), iters)


def phase_iou_kernel(step_inputs, device):
    """K11 against its plain version, bit for bit, on the train step's own
    corners, at 8 x 1,000 x 1,000 clustered boxes and on the tie lattice;
    times and bounds. -> (errs, times, extra), the step's shape in the
    record."""
    import torch

    from paddle3d_tpu_torch.ops import iou_clip
    from paddle3d_tpu_torch.ops.box_ops import boxes_to_corners_bev
    name = "pairwise_intersection_area"
    cases = [("train step", step_inputs)]
    for label, (a, b) in (("8 x 1000 x 1000 clustered",
                           clustered_boxes(device)),
                          ("tie lattice", tie_lattice(device))):
        cases.append((label, (boxes_to_corners_bev(a), boxes_to_corners_bev(
            b))))
    worst, rows = 0.0, {}
    for label, (ca, cb) in cases:
        got = iou_clip.pairwise_intersection_area(ca, cb)
        ref = iou_clip.pairwise_intersection_area_plain(ca, cb)
        torch.cuda.synchronize()
        differ = int((got != ref).sum())
        err = (got - ref).abs().max().item()
        worst = max(worst, err)
        check(differ == 0 and got.shape == ref.shape,
              "{} differs from its plain version on the {} ({} areas, "
              "max_abs_err {:.3e})".format(name, label, differ, err))
        t = cuda_ms(lambda: iou_clip.pairwise_intersection_area(ca, cb), 20)
        tp = cuda_ms(lambda: iou_clip.pairwise_intersection_area_plain(
            ca, cb), 3)
        nbytes, ops, pairs, clipped = iou_work(ca, cb)
        one = bound(nbytes, f32_ops=ops)
        rows[label] = (t, tp, one)
        log("  K11 on the {} {} x {}: {:.4f} ms vs plain {:.4f} ms, bound "
            "{:.5f} ms ({}), {} pairs of which {} pass the guard, areas "
            "that differ 0 (bit-equal), overlapping pairs {}".format(
                label, tuple(ca.shape[:-2]), tuple(cb.shape[-3:-2]), t, tp,
                one[0], one[1], pairs, clipped, int((ref > 0).sum())))
    log("  K11's chain floor (one launch on one clipped pair): {:.4f} ms"
        .format(iou_chain_floor(device)))
    t, tp, one = rows["train step"]
    return ({name: worst}, {name: (t, tp)},
            {name: (None,) + one})


def ts_train_setup(device, path):
    """A two-stage KITTI config in train mode at full width (seeded random
    weights, the RPN head's as upstream initialises it), its AdamWOnecycle
    and OneCycle, the step, and the batch: two scans of 20,000 clustered
    points and bench.make_gt's boxes (24 a scan, a quarter padding), half of
    each scan's boxes replaced by the model's own first proposals, jittered
    by GT_JITTER of their size (every fourth also pushed half its length
    along its heading), so that fg, hard-bg and easy-bg RoIs all exist; then
    TS_WARM_STEPS steps on that batch. -> (model, optimizer, scheduler,
    step, batch, the first proposals' median size [3])."""
    import copy

    import numpy as np
    import torch

    import bench
    from paddle3d_tpu_torch.apis import Config, make_train_step
    cfg = Config(path=path, device=device)
    model = cfg.model.train()
    head = model.rpn_head
    with torch.no_grad():
        head.box_head.weight.copy_(RPN_BOX_STD * torch.randn(
            head.box_head.weight.shape,
            generator=torch.Generator().manual_seed(SEED)))
        head.cls_head.bias.fill_(-math.log((1 - RPN_PRIOR) / RPN_PRIOR))
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    check(isinstance(optimizer, torch.optim.AdamW) and
          optimizer.param_groups[0]["betas"] == (0.95, 0.99) and
          model.voxelizer.max_num_voxels_for(True) == 16000,
          "not the config's AdamWOnecycle or train voxel cap")
    rng = np.random.default_rng(SEED)
    _, n, (lo, hi), _ = bench.MODELS["voxel_rcnn"]
    pts = bench.make_scans(rng, TS_TRAIN_BATCH, n, lo, hi, "clustered")
    points = torch.from_numpy(pts).to(device)
    boxes, labels = bench.make_gt(rng, TS_TRAIN_BATCH, "voxel_rcnn")
    with torch.no_grad():
        probe = copy.deepcopy(model)
        rois, _, roi_labels = probe.rpn_head.proposals(
            probe._stage1(points, True)[0])
        del probe
    rois, roi_labels = rois.cpu().numpy(), roi_labels.cpu().numpy()
    size = np.median(rois[roi_labels >= 0][:, 3:6], axis=0)
    half = boxes.shape[1] // 2
    for i in range(TS_TRAIN_BATCH):
        k = np.flatnonzero(roi_labels[i] >= 0)[:half]
        jit = rois[i, k].copy()
        jit[:, :3] += rng.normal(0, GT_JITTER, (len(k), 3)) * jit[:, 3:6]
        jit[:, 6] += rng.normal(0, 0.02, len(k))
        push = np.arange(len(k)) % 4 == 3
        jit[push, 0] += 0.5 * jit[push, 3] * np.cos(jit[push, 6])
        jit[push, 1] += 0.5 * jit[push, 3] * np.sin(jit[push, 6])
        boxes[i, :len(k)] = jit
        labels[i, :len(k)] = roi_labels[i, k]
    batch = {"data": points, "gt_boxes": torch.from_numpy(boxes).to(device),
             "gt_labels": torch.from_numpy(labels).to(device)}
    step = make_train_step(lr_scheduler=scheduler)
    for _ in range(TS_WARM_STEPS):
        step(model, optimizer, batch)
    return model, optimizer, scheduler, step, batch, size


@contextlib.contextmanager
def recorded(obj, name):
    """Record what obj.name hands back during the block: -> list of
    (args, output), one a call."""
    calls = []
    fn = getattr(obj, name)

    def rec(*args):
        out = fn(*args)
        calls.append((args, out))
        return out
    with mock.patch.object(obj, name, rec):
        yield calls


def train_stages(step, model, optimizer, batch, iters, names, marks):
    """Host-clock ms of a train step's stages, averaged over iters steps
    after a warm-up: make_train_step itself, with the calls that end a
    stage wrapped to synchronize and read the clock. marks: (object,
    attribute, "after" or "before") for each stage's end but the last (the
    step's return)."""
    import torch
    ms, t0 = [], [0.0]

    def lap():
        torch.cuda.synchronize()
        t = time.perf_counter()
        ms.append((t - t0[0]) * 1e3)
        t0[0] = t

    def wrap(fn, when):
        def wrapped(*a, **k):
            if when == "before":
                lap()
            out = fn(*a, **k)
            if when == "after":
                lap()
            return out
        return wrapped

    with contextlib.ExitStack() as stack:
        for target, name, when in marks:
            stack.enter_context(mock.patch.object(
                target, name, wrap(getattr(target, name), when)))
        runs = []
        for _ in range(iters + 1):
            ms.clear()
            torch.cuda.synchronize()
            t0[0] = time.perf_counter()
            step(model, optimizer, batch)
            lap()
            check(len(ms) == len(names), "{} stage marks in a train step, "
                  "{} expected".format(len(ms), len(names)))
            runs.append(list(ms))
    ms = [sum(v) / iters for v in zip(*runs[1:])]
    log("  train step stages (host clock, synchronised): " + ", ".join(
        "{} {:.3f} ms".format(n, t) for n, t in zip(names, ms)))


def ts_train_stages(step, model, optimizer, batch, iters):
    """The two-stage train step's stages: the sparse encoder, the RPN head,
    its loss, its proposals, the proposal targets, the refinement loss, the
    optimizer's step before its clip, the step's return."""
    from paddle3d_tpu_torch.models.detection.pv_rcnn import pv_rcnn
    from paddle3d_tpu_torch.models.heads.roi_head import RoIGridHead
    head = model.rpn_head
    train_stages(step, model, optimizer, batch, iters, (
        "canvas and sparse forward", "dense stack", "RPN loss", "proposals",
        "targets", "support set, RoI head and loss", "backward",
        "clip, optimizer and scheduler"), (
        (model.middle_encoder, "forward", "after"),
        (head, "forward", "after"), (head, "loss", "after"),
        (head, "proposals", "after"),
        (pv_rcnn, "proposal_targets", "after"),
        (RoIGridHead, "refine_loss", "after"), (optimizer, "step", "before")))


def timed_train(step, model, optimizer, batch, label, iters, stages,
                plain=True):
    """Train scans/s over iters steps a path (kernel/plain/plain/kernel
    halves after a warm-up of each path; kernels only when plain is False),
    peak memory, a profile and stages(step, model, optimizer, batch,
    iters) of three steps."""
    import torch
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    b = batch["data"].shape[0]
    paths = ("kernels", "plain") if plain else ("kernels",)
    for path in paths:                              # warm-up
        with plain_path() if path == "plain" else contextlib.nullcontext():
            step(model, optimizer, batch)
    rates = {p: [] for p in paths}
    half = iters // 2
    for order in (paths, paths[::-1]):
        for path in order:
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(half):
                    step(model, optimizer, batch)
                torch.cuda.synchronize()
                rates[path].append(b * half / (time.perf_counter() - t0))
    rate = {k: 2 * half / sum(half / r for r in v) for k, v in rates.items()}
    log("  {}: {} train steps of batch {} per path ({}halves, "
        "cudnn.benchmark on): {}; halves {}".format(
            label, 2 * half, b,
            "kernel/plain/plain/kernel " if plain else "",
            ", ".join("{} path {:.2f} scans/s".format(k, v)
                      for k, v in rate.items()),
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    step(model, optimizer, batch)
    log("  peak device memory of one train step: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: step(model, optimizer, batch))
    stages(step, model, optimizer, batch, 3)


@contextlib.contextmanager
def deterministic(warn_only=False):
    """Run the block deterministically: torch's deterministic mode (an op
    with no deterministic form raises, or with warn_only runs as it is
    with a warning), deterministic cuDNN with no autotuning. The mode
    needs main()'s cuBLAS workspace setting."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def fixed_path():
    """deterministic(warn_only=True), with cuDNN's flags put back after: for
    the train steps falling_losses(fixed=True) runs and every step before
    them on the same state."""
    import torch
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        with deterministic(warn_only=True):
            yield
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.backends.cudnn.benchmark = flags[1]


def phase_ts_train(device):
    """Two-stage KITTI training: Voxel-RCNN at full width through the
    kernels against the plain versions, K11 bit for bit, 10 steps run
    twice from one state (deterministic, equal bit for bit), timing; then
    PV-RCNN's steps and timing."""
    import torch

    from paddle3d_tpu_torch.models.detection.pv_rcnn import pv_rcnn
    from paddle3d_tpu_torch.ops import (_build, ball_query, fps, iou_clip,
                                        sorted_scatter)
    # the checked trajectory (the warm-up, the compared steps and the ten
    # steps) runs deterministically, so that every run of one tree on one
    # card takes the same steps; the kernel checks and the timing do not
    with deterministic():
        model, optimizer, scheduler, step, batch, size = ts_train_setup(
            device, VOXEL_RCNN)
    restore_state = saved_state(model, optimizer, scheduler)

    def restore():
        restore_state()
        model.sampler_generator.manual_seed(SEED)

    def pools(targets):
        return [tuple(r) for r in targets["pool_sizes"].tolist()]

    def ten_steps(plain=False):
        """TRAIN_STEPS deterministic steps -> (losses, pools a step)."""
        with deterministic(), recorded(pv_rcnn, "proposal_targets") as calls, \
                plain_path() if plain else contextlib.nullcontext():
            losses = [step(model, optimizer, batch)["loss"].item()
                      for _ in range(TRAIN_STEPS)]
        return losses, [pools(out) for _, out in calls]

    log("phase 11: Voxel-RCNN KITTI training at B={} N={} (AdamWOnecycle, "
        "clip 10, OneCycle), {} gt boxes a scan ({} valid); the RPN head "
        "from the upstream init (box weights N(0, {}), class prior {}), "
        "first proposals' median size {} m".format(
            TS_TRAIN_BATCH, batch["data"].shape[1],
            batch["gt_boxes"].shape[1],
            (batch["gt_labels"] >= 0).sum(dim=1).tolist(), RPN_BOX_STD,
            RPN_PRIOR, [round(float(v), 3) for v in size]))
    restore()
    ious = []
    fn = iou_clip.pairwise_intersection_area

    def iou_rec(*a):
        ious.append(a)
        return fn(*a)
    with deterministic(), recorded(pv_rcnn, "proposal_targets") as kcalls, \
            recorded(sorted_scatter, "scatter_rows") as bevs, \
            recorded(ball_query, "ball_query_batched") as balls, \
            mock.patch.object(iou_clip, "pairwise_intersection_area",
                              iou_rec):
        kernel = record_step(step, model, optimizer, batch)
    check(len(ious) == 1, "expected one K11 call a step, got {}".format(
        len(ious)))
    check(len(balls) == TST_LAUNCHES["ball_query"],
          "expected {} K9 calls a step, got {}".format(
              TST_LAUNCHES["ball_query"], len(balls)))
    phase_point_kernels([a for a, _ in balls], [],
                        "phase 11 (Voxel-RCNN training)")
    del balls
    check(len(bevs) == 1, "expected one dense-BEV segment sum a step")
    if sorted_scatter.kernel_for(bevs[0][0][1].shape[1],
                                 bevs[0][0][2]) == "sorted_segment_sum":
        k2_call("Voxel-RCNN training (the dense BEV)", *bevs[0][0])
    del bevs
    errs, times, extra = phase_iou_kernel(ious[0], device)
    del ious
    restore()
    with deterministic(), recorded(pv_rcnn, "proposal_targets") as pcalls, \
            plain_path():
        plain = record_step(step, model, optimizer, batch)
    restore()
    launches = kernel[3]
    first = pools(kcalls[0][1])
    log("  train step: losses {}; launches {}; plain step launches {}; "
        "pools (fg, hard bg, easy bg) per scan {}".format(
            {k: round(v, 5) for k, v in kernel[0].items()}, launches,
            plain[3], first))
    check(all(launches[k] == v for k, v in TST_LAUNCHES.items()) and
          launches["sorted_segment_sum"] + launches[
              "sorted_segment_sum_dense"] == 1,
          "the Voxel-RCNN train step launched {} where {} and one dense "
          "BEV segment sum were due".format(launches, TST_LAUNCHES))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    check(all(min(p) >= POOL_MIN for p in first),
          "a sampling pool of the compared step held fewer than {} RoIs: "
          "{}".format(POOL_MIN, first))
    kt, pt = kcalls[0][1], pcalls[0][1]
    check(set(kt) == set(pt) and all(torch.equal(kt[k], pt[k]) for k in kt),
          "the proposal targets differ between the kernel and plain steps")
    keys = ["loss", "loss_rpn_cls", "loss_rpn_reg", "loss_rcnn_cls",
            "loss_rcnn_reg"]
    step_errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6, keys)
    log("  vs the plain step (deterministic cuDNN, TF32 off, the sampler "
        "reseeded): proposal targets equal; losses {:.3e} (tolerance 1e-6), "
        "grads {:.3e} (1e-4), running stats {:.3e} (1e-6), each relative to "
        "the tensor's largest value".format(*step_errs))
    del kcalls, pcalls

    losses, per_step = ten_steps()
    restore()
    again = ten_steps()
    log("  {} deterministic steps on the fixed batch, loss per step: {} "
        "(hex {}); pools (fg, hard bg, easy bg) per step and scan: {}".format(
            TRAIN_STEPS, [round(v, 4) for v in losses],
            [v.hex() for v in losses], per_step))
    check(([v.hex() for v in again[0]], again[1]) ==
          ([v.hex() for v in losses], per_step),
          "the {} steps run again from the same state differ: losses {}, "
          "pools {}".format(TRAIN_STEPS, [v.hex() for v in again[0]],
                            again[1]))
    log("  the same steps run again from the same state: losses and pools "
        "equal bit for bit")
    check(all(v == v and abs(v) < float("inf") for v in losses),
          "non-finite train loss")
    check(losses[-1] < losses[0], "the loss did not fall")
    if not all(min(p) > 0 for scans in per_step for p in scans):
        # is the empty pool the batch's or a kernel's? the plain versions
        # from the same state
        restore()
        plain_losses, plain_pools = ten_steps(plain=True)
        log("  the same steps on the plain path: losses {}; pools {}".format(
            [round(v, 4) for v in plain_losses], plain_pools))
    check(all(min(p) > 0 for scans in per_step for p in scans),
          "a sampling pool was empty at a step")
    timed_train(step, model, optimizer, batch, "Voxel-RCNN", TS_TRAIN_ITERS,
                ts_train_stages)
    del model, optimizer, scheduler, step, batch

    model, optimizer, _, step, batch, _ = ts_train_setup(device, PV_RCNN)
    _build.reset_launches()
    with recorded(fps, "farthest_point_sample_batched") as samples, \
            recorded(ball_query, "ball_query_batched") as balls:
        pv_losses = [step(model, optimizer, batch)]
    pv_losses += [step(model, optimizer, batch)
                  for _ in range(PV_TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    log("  PV-RCNN at B={}: {} steps, losses {}; launches {}".format(
        TS_TRAIN_BATCH, PV_TRAIN_STEPS,
        [{k: round(v.item(), 4) for k, v in ls.items()} for ls in pv_losses],
        dict(_build.LAUNCHES)))
    check(all(v.item() == v.item() and abs(v.item()) < float("inf")
              for ls in pv_losses for v in ls.values()),
          "non-finite PV-RCNN train loss")
    check(_build.LAUNCHES["farthest_point_sample"] == PV_TRAIN_STEPS and
          _build.LAUNCHES["pairwise_intersection_area"] == PV_TRAIN_STEPS,
          "PV-RCNN's steps missed K10 or K11")
    check(len(samples) == 1 and len(balls) == 7,
          "expected one K10 and 7 K9 calls a PV-RCNN step, got {} and {}"
          .format(len(samples), len(balls)))
    phase_point_kernels([a for a, _ in balls], [a for a, _ in samples],
                        "phase 11 (PV-RCNN training, first step)")
    del samples, balls
    timed_train(step, model, optimizer, batch, "PV-RCNN", TS_TRAIN_ITERS,
                ts_train_stages, plain=False)
    return errs, times, extra, launches


# K13 at tools/bench_scatter_rw.py's shape (the JAX package's micro-bench:
# 8 x 250,000 channel-major rows of 64 channels onto 512 x 512 cells, 60 %
# of the rows in a quarter of the cells) and at the dense case of its test
# (tests/ops/test_sorted_scatter.py:263); K14 at the shape of
# paddle3d_tpu/ops/pallas/gather.py:3-4 (8 x 1,000 rows of 7 from 107,136
# anchors) and at a voxel-row gather's (4 x 120,000 rows of 64 from
# 160,000). No model path reaches K13: the record counts phase 12's calls
# of it (K14's come from SMOKE's decode, phase 15)
RW_CASES = ((8, 250000, 64, 512 * 512), (2, 5000, 64, 4096))
GATHER_CASES = ((8, 107136, 7, 1000), (4, 160000, 64, 120000))
OP_KERNELS = ("sorted_segment_sum_rw", "gather_rows")


def rw_inputs(device, b, n, c, cells):
    """Sorted keys and channel-major f32 rows [B, C, N]: for the bench case
    tools/bench_scatter_rw.py's (seed 0: 60 % of the keys in
    [cells / 4, cells / 2), the rest over the table), else the JAX test's
    (_mk, seed 5: keys over cells + 40, a tail past the table)."""
    import numpy as np
    import torch
    if (b, n, c, cells) == RW_CASES[0]:
        rng = np.random.default_rng(SEED)
        dense = int(n * 0.6)
        keys = np.sort(np.concatenate([
            rng.integers(cells // 4, cells // 2, size=(b, dense)),
            rng.integers(0, cells, size=(b, n - dense))], axis=1),
            axis=1).astype(np.int32)
        rows_cm = rng.standard_normal((b, c, n)).astype(np.float32)
    else:
        rng = np.random.default_rng(5)
        keys = np.sort(rng.integers(0, cells + 40, size=(b, n)).astype(
            np.int32), axis=1)
        rows_cm = np.ascontiguousarray(rng.normal(size=(b, n, c)).astype(
            np.float32).transpose(0, 2, 1))
    return (torch.from_numpy(keys).to(device),
            torch.from_numpy(rows_cm).to(device))


def gather_inputs(device, b, a, c, k):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    src = rng.standard_normal((b, a, c)).astype(np.float32)
    idx = rng.integers(0, a, (b, k)).astype(np.int32)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(idx).to(device))


def host_us(fn, n=2000):
    """Host-clock microseconds a call of fn, over n calls after a warm-up,
    the queue drained before and after (the device keeps up with a call
    this small, so this is the host's cost of issuing it)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def k14_host_parts(src, idx):
    """K14's launch path at a launch-bound shape, part by part (host us a
    call), beside the library call's and the stream routes' costs."""
    import torch

    from paddle3d_tpu_torch.ops import _build, gather
    b, a, c = src.shape
    k = idx.shape[1]
    out = gather.gather_rows(src, idx)
    fn = _build.function("p3d_gather_rows")
    args = (src.data_ptr(), *src.stride(), idx.data_ptr(), out.data_ptr(), b,
            a, k, c, _build.stream_ptr(src.device))
    index = idx.long()[..., None].expand(-1, -1, c)
    dev, i = src.device, src.device.index
    parts = (
        ("gather_rows", lambda: gather.gather_rows(src, idx)),
        ("its checks", lambda: (
            src.dtype is not torch.float32 or idx.dtype is not torch.int32 or
            src.dim() != 3 or idx.dim() != 2 or
            idx.shape[0] != src.shape[0] or not idx.is_contiguous() or
            idx.device != src.device)),
        ("new_empty", lambda: src.new_empty((b, k, c))),
        ("_build.function", lambda: _build.function("p3d_gather_rows")),
        ("stream_ptr", lambda: _build.stream_ptr(dev)),
        ("pointers and strides", lambda: (
            src.data_ptr(), src.stride(), idx.data_ptr(), out.data_ptr())),
        ("ctypes call and launch", lambda: fn(*args)),
        ("torch.gather, int64 index made inside", lambda: torch.gather(
            src, 1, idx.long()[..., None].expand(-1, -1, c))),
        ("torch.gather, index given", lambda: torch.gather(src, 1, index)),
        ("current_stream(device).cuda_stream (the torch.device route)",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("current_stream(index).cuda_stream",
         lambda: torch.cuda.current_stream(i).cuda_stream),
        ("torch._C._cuda_getCurrentRawStream (private)",
         lambda: torch._C._cuda_getCurrentRawStream(i)),
    )
    log("  K14 launch path at B={} A={} C={} K={}, host us a call: {}".format(
        b, a, c, k, ", ".join("{} {:.3f}".format(name, host_us(f))
                              for name, f in parts)))


def phase_ops(device):
    """K13 and K14 as ops: each called once a case through its entry point
    (the launches the record counts), then held against its plain version
    and the library call on the same inputs, timed and bounded (the first
    case of each goes into the record)."""
    import torch

    from paddle3d_tpu_torch.ops import _build, gather, sorted_scatter
    rw = [rw_inputs(device, *case) for case in RW_CASES]
    gt = [gather_inputs(device, *case) for case in GATHER_CASES]
    _build.reset_launches()
    outs_rw = [sorted_scatter.sorted_segment_sum_rw(keys, rows, c, cells)
               for (keys, rows), (_, _, c, cells) in zip(rw, RW_CASES)]
    outs_g = [gather.gather_rows(src, idx) for src, idx in gt]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log("phase 12: K13 and K14 as ops, launches {}".format(
        {k: v for k, v in launches.items() if v}))
    check(launches["sorted_segment_sum_rw"] == len(RW_CASES) and
          launches["gather_rows"] == len(GATHER_CASES) and
          sum(launches.values()) == len(RW_CASES) + len(GATHER_CASES),
          "the op calls launched {}".format(launches))
    errs, times, extra = {}, {}, {}
    for i, ((keys, rows_cm), (b, n, c, cells), out) in enumerate(zip(
            rw, RW_CASES, outs_rw)):
        ref = sorted_scatter.sorted_segment_sum_rw_plain(keys, rows_cm, c,
                                                         cells)
        k6 = sorted_scatter.sorted_segment_sum_cm(keys, rows_cm, cells, c=c)
        lib_call = index_add_call(keys, rows_cm, cells, True)
        inside = (keys >= 0) & (keys < cells)
        lib = lib_call().view(b, cells + 1, c)[:, :cells]
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        lib_err = (out - lib).abs().max().item()
        rank = torch.arange(n, device=keys.device) - torch.searchsorted(
            keys, keys)
        longest = int(rank[inside].max()) + 1
        check(torch.equal(out, ref), "K13 differs from the row-order sum "
              "(its plain version): max_abs_err {:.3e}".format(err))
        check(torch.equal(out, k6), "K13 differs from K6 on its inputs")
        check(lib_err <= 1e-5 * ref.abs().max().item(),
              "K13 strays from index_add_: {:.3e}".format(lib_err))
        t = (cuda_ms(lambda: sorted_scatter.sorted_segment_sum_rw(
                 keys, rows_cm, c, cells), 20),
             cuda_ms(lambda: sorted_scatter.sorted_segment_sum_rw_plain(
                 keys, rows_cm, c, cells), 3),
             cuda_ms(lib_call, 20),
             cuda_ms(lambda: sorted_scatter.sorted_segment_sum_cm(
                 keys, rows_cm, cells, c=c), 20))
        bnd = bound(scatter_bytes(keys, cells, c, out.numel()))
        log("  K13 at B={} N={} C={} cells={} (longest segment {} rows): "
            "bit-equal to the row-order sum and to K6, index_add_ "
            "max_abs_err {:.3e}; {:.4f} ms (plain {:.4f}, index_add_ from "
            "the channel-major rows to a fresh table {:.4f}, K6 {:.4f}; "
            "kernel / library {:.3f}), bound {:.4f} ms ({})".format(
                b, n, c, cells, longest, lib_err, *t, t[0] / t[2], *bnd))
        errs["sorted_segment_sum_rw"] = max(
            errs.get("sorted_segment_sum_rw", 0.0), err)
        if i == 0:
            times["sorted_segment_sum_rw"] = t[:2]
            extra["sorted_segment_sum_rw"] = (t[2],) + bnd
        del ref, k6, lib
    del rw, outs_rw
    for i, ((src, idx), (b, a, c, k), out) in enumerate(zip(
            gt, GATHER_CASES, outs_g)):
        ref = gather.gather_rows_plain(src, idx)

        def lib_call():     # the int64 expanded index made inside, timed
            return torch.gather(src, 1, idx.long()[..., None].expand(
                -1, -1, c))
        lib = lib_call()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), "K14 differs from its plain version")
        check(torch.equal(out, lib), "K14 differs from torch.gather")
        t = (cuda_ms(lambda: gather.gather_rows(src, idx), 50),
             cuda_ms(lambda: gather.gather_rows_plain(src, idx), 20),
             cuda_ms(lib_call, 50))
        # each index read once, each gathered row read once and written once
        bnd = bound(4 * b * k + 8 * b * k * c)
        log("  K14 at B={} A={} C={} K={}: equal to its plain version and "
            "to torch.gather; {:.4f} ms (plain {:.4f}, torch.gather with its "
            "int64 index made inside {:.4f}; factor {:.3f}), bound {:.4f} ms "
            "({})".format(b, a, c, k, *t, t[0] / t[2], *bnd))
        errs["gather_rows"] = max(errs.get("gather_rows", 0.0),
                                  (out - ref).abs().max().item())
        if i == 0:
            times["gather_rows"] = t[:2]
            extra["gather_rows"] = (t[2],) + bnd
            k14_host_parts(src, idx)
    report(OP_KERNELS, errs, times, extra)
    return errs, times, extra, launches


VX_TRAIN_ITERS = 2      # train steps timed per path (halves of 1)
def vx_train_setup(device):
    """The nuScenes voxel config in train mode (seeded random weights), its
    OneCycleAdam (clip 35) and OneCycleWarmupDecayLr inherited from the
    pillar config, the step, and the batch: 4 scans of 250,000 clustered
    points and bench.make_gt's boxes (64 a scan, 9 columns, ten classes, a
    quarter padding)."""
    import numpy as np
    import torch

    import bench
    from paddle3d_tpu_torch.apis import Config, make_train_step
    cfg = Config(path=VOXELS, device=device)
    model = cfg.model.train()
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    check(isinstance(optimizer, torch.optim.AdamW) and
          optimizer.param_groups[0]["betas"] == (0.95, 0.99) and
          model.voxelizer.max_num_voxels_for(True) == 120000,
          "not the voxel config's OneCycleAdam or train voxel cap")
    boxes, labels = bench.make_gt(np.random.default_rng(SEED), VX_BATCH,
                                  "centerpoint")
    batch = {"data": make_cp_points(device, "centerpoint_voxels", VX_BATCH),
             "gt_boxes": torch.from_numpy(boxes).to(device),
             "gt_labels": torch.from_numpy(labels).to(device)}
    return model, optimizer, scheduler, make_train_step(
        lr_scheduler=scheduler), batch


def vx_train_stages(step, model, optimizer, batch, iters):
    train_stages(step, model, optimizer, batch, iters, (
        "voxel mean, sparse forward and dense BEV",
        "dense stack (backbone, neck, head)", "targets and loss", "backward",
        "clip, optimizer and scheduler"), (
        (model.middle_encoder, "forward", "after"),
        (model.bbox_head, "forward", "after"),
        (model.bbox_head, "loss", "after"), (optimizer, "step", "before")))


def phase_vx_train(device):
    """CenterPoint-voxels nuScenes training through the kernels and on the
    plain versions, from one saved state; 10 steps; timing."""
    import torch

    from paddle3d_tpu_torch.models.layers import SparseConv3D
    from paddle3d_tpu_torch.ops import sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, optimizer, scheduler, step, batch = vx_train_setup(device)
    restore = saved_state(model, optimizer, scheduler)
    with recorded(sorted_scatter, "sorted_segment_sum") as bevs, \
            recorded(model, "target_generator") as ktargets:
        kernel = record_step(step, model, optimizer, batch)
    restore()
    with recorded(model, "target_generator") as ptargets, plain_path():
        plain = record_step(step, model, optimizer, batch)
    restore()
    (keys, rows, cells), _ = bevs[0]
    bev = sorted_scatter.kernel_for(keys.shape[1], cells)
    launches = kernel[3]
    log("phase 13: CenterPoint-voxels nuScenes training at B={} N={} "
        "(OneCycleAdam, clip 35, OneCycleWarmupDecayLr), train voxel cap "
        "{}: the dense BEV sums {} rows a scan onto {} cells ({}); losses "
        "{}; launches {}; plain step launches {}".format(
            VX_BATCH, CP_POINTS, model.voxelizer.max_num_voxels_for(True),
            keys.shape[1], cells, bev,
            {k: round(v, 5) for k, v in kernel[0].items()},
            {k: v for k, v in launches.items() if v},
            {k: v for k, v in plain[3].items() if v}))
    check(len(bevs) == 1 and rows.requires_grad,
          "expected one dense-BEV segment sum with a gradient a step")
    check(launches[bev] == 1 and launches["sorted_table_gather"] == 1 and
          sum(launches.values()) == 2,
          "the voxel train step launched {} where one {} and one "
          "sorted_table_gather were due".format(launches, bev))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    kt, pt = ktargets[0][1], ptargets[0][1]
    check(len(kt) == len(pt) == 6 and all(
        torch.equal(a, b) for x, y in zip(kt, pt) for a, b in zip(x, y)),
        "the targets differ between the kernel and plain steps")
    if bev == "sorted_segment_sum":
        k2_call("CenterPoint-voxels training (the dense BEV)", keys, rows,
                cells, False)
    del bevs, ktargets, ptargets, keys, rows
    keys = ["loss"] + ["{}_{}".format(k, i) for k in ("hm_loss", "loc_loss")
                       for i in range(6)]
    # the residual blocks' sparse convs carry a bias, and each feeds a
    # batch-statistics MaskedBatchNorm
    dead = ["{}.bias".format(n) for n, m in model.named_modules()
            if isinstance(m, SparseConv3D) and m.bias is not None]
    step_errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6, keys, dead)
    log("  vs the plain step (deterministic cuDNN, TF32 off): targets "
        "equal; losses {:.3e} (tolerance 1e-6), grads {:.3e} (1e-4), "
        "running stats {:.3e} (1e-6), each relative to the tensor's largest "
        "value; the {} sparse conv biases that feed a batch-statistics BN "
        "have no gradient on either step (within 1e-6 of the largest)"
        .format(*step_errs, len(dead)))
    del kernel, plain
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch)
    cap = model.voxelizer.max_num_voxels_for(True)
    log("  gathered stage-1 rows a subm conv keeps for its backward: "
        "{:.1f} MiB ({} scans x {} rows x 27 taps x 16 channels, f32)"
        .format(VX_BATCH * cap * 27 * 16 * 4 / 2**20, VX_BATCH, cap))
    timed_train(step, model, optimizer, batch, "CenterPoint-voxels",
                VX_TRAIN_ITERS, vx_train_stages)
    return launches


IA_TRAIN_BATCH = 8      # configs/iassd/iassd_kitti.yml's batch_size
IA_TRAIN_ITERS = 2      # train steps timed per path (halves of 1)


def ia_train_setup(device):
    """The IA-SSD KITTI config in train mode (seeded random weights), its
    AdamWOnecycle (clip 10) and OneCycle, the step, and the batch: 8 scans
    of 16,384 clustered points and bench.make_gt's boxes (24 a scan, a
    quarter padding)."""
    import numpy as np
    import torch

    import bench
    from paddle3d_tpu_torch.apis import Config, make_train_step
    cfg = Config(path=IASSD, device=device)
    model = cfg.model.train()
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    check(isinstance(optimizer, torch.optim.AdamW) and
          optimizer.param_groups[0]["weight_decay"] == 0.01,
          "not the IA-SSD config's AdamWOnecycle")
    rng = np.random.default_rng(SEED)
    _, n, (lo, hi), _ = bench.MODELS["iassd"]
    pts = bench.make_scans(rng, IA_TRAIN_BATCH, n, lo, hi, "clustered")
    check(pts.shape == (IA_TRAIN_BATCH, 16384, 4), "unexpected scan shape")
    boxes, labels = bench.make_gt(rng, IA_TRAIN_BATCH, "iassd")
    batch = {"data": torch.from_numpy(pts).to(device),
             "gt_boxes": torch.from_numpy(boxes).to(device),
             "gt_labels": torch.from_numpy(labels).to(device)}
    return model, optimizer, scheduler, make_train_step(
        lr_scheduler=scheduler), batch


def ia_train_stages(step, model, optimizer, batch, iters):
    train_stages(step, model, optimizer, batch, iters, (
        "SA layers", "vote and aggregation", "heads",
        "assignment and losses", "backward",
        "clip, optimizer and scheduler"), (
        (model.sa_modules[-1], "forward", "after"),
        (model, "_aggregate", "after"), (model.reg_head, "forward", "after"),
        (model, "train_forward", "after"), (optimizer, "step", "before")))


def phase_ia_train(device):
    """IA-SSD KITTI training through K9 and K10 and on the plain versions,
    from one saved state; 10 steps; timing."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from paddle3d_tpu_torch.ops import ball_query, fps
    model, optimizer, scheduler, step, batch = ia_train_setup(device)
    restore = saved_state(model, optimizer, scheduler)
    with recorded(fps, "farthest_point_sample_batched") as samples, \
            recorded(ball_query, "ball_query_batched") as balls:
        kernel = record_step(step, model, optimizer, batch)
    restore()
    with plain_path():
        plain = record_step(step, model, optimizer, batch)
    restore()
    launches = kernel[3]
    log("phase 14: IA-SSD KITTI training at B={} N=16384 (AdamWOnecycle, "
        "clip 10, OneCycle): losses {}; launches {}; plain step launches "
        "{}".format(IA_TRAIN_BATCH,
                    {k: round(v, 5) for k, v in kernel[0].items()},
                    {k: v for k, v in launches.items() if v},
                    {k: v for k, v in plain[3].items() if v}))
    check(launches["ball_query"] == 10 and
          launches["farthest_point_sample"] == 3 and
          sum(launches.values()) == 13,
          "the IA-SSD train step launched {} where 10 K9 and 3 K10 were "
          "due".format(launches))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    phase_point_kernels([a for a, _ in balls], [a for a, _ in samples],
                        "phase 14 (IA-SSD training)")
    del samples, balls
    step_errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6,
                              ("loss", "loss_cls", "loss_box", "loss_sa"))
    log("  vs the plain step: losses {:.3e} (tolerance 1e-6), grads {:.3e} "
        "(1e-4), running stats {:.3e} (1e-6), each relative to the "
        "tensor's largest value".format(*step_errs))
    del kernel, plain
    falling_losses(step, model, optimizer, batch)
    timed_train(step, model, optimizer, batch, "IA-SSD", IA_TRAIN_ITERS,
                ia_train_stages)
    return launches


# Phase 15: SMOKE, the first camera model, on KITTI's image size
# (tools/bench_camera.py:70-83: 384 x 1280, f = 721.5, the principal point
# at the image centre, down_ratio 4); batch 1 as a camera stack serves it,
# batch 8 the config's batch_size
SMOKE_HW = (384, 1280)
SMOKE_FOCAL = 721.5
SMOKE_BATCH = 8
SMOKE_ITERS = 4         # timed forwards per path and batch (halves of 2)
SMOKE_OBJECTS = 8       # synthetic objects an image
# the tiny config's class head gets this contrast before the card-vs-CPU
# check: its random heatmap is flat at sigmoid(-2.19), and near-equal
# scores would order differently on the two devices
SMOKE_CLS_GAIN = 8.0
# its outputs on the card against the CPU, relative to the largest value:
# about 10x the readings on an H100 (scores 1.1e-5, box3d_cam 4.0e-6,
# bbox_2d 5.8e-7, alphas 1.1e-5)
SMOKE_TINY_TOL = {"scores": 1e-4, "box3d_cam": 5e-5, "bbox_2d": 1e-5,
                  "alphas": 1e-4}


def smoke_intrinsics(h, w):
    import numpy as np
    return np.array([[SMOKE_FOCAL, 0., w / 2], [0., SMOKE_FOCAL, h / 2],
                     [0., 0., 1.]], np.float32)


def smoke_serve_batch(device, b, seed=SEED, hw=None):
    """b synthetic images in [0, 255), NHWC, at hw (SMOKE_HW by default),
    and tools/bench_camera.py's serving target (K, K_inv, trans_mat,
    image_size, down_ratio 4) each."""
    import numpy as np
    import torch
    h, w = hw or SMOKE_HW
    rng = np.random.default_rng(seed)
    k = np.broadcast_to(smoke_intrinsics(h, w), (b, 3, 3))
    target = {"K": k, "K_inv": np.linalg.inv(k).astype(np.float32),
              "trans_mat": np.broadcast_to(np.eye(3, dtype=np.float32),
                                           (b, 3, 3)),
              "image_size": np.tile(np.array([h, w], np.float32), (b, 1)),
              "down_ratio": np.full((b, 2), 4, np.float32)}
    return {"data": torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3))
                                     .astype(np.float32)).to(device),
            "target": {key: torch.from_numpy(np.array(v)).to(device)
                       for key, v in target.items()}}


def smoke_train_batch(device, cfg_dic, b=None, seed=SEED):
    """b (SMOKE_BATCH) synthetic images with SMOKE_OBJECTS objects each
    (classes from the config's dim_ref, in front of the camera, random
    yaw), through the port's Gt2SmokeTarget built from the config's train
    transform (flips seeded): -> the collated batch on `device`."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.sample import Sample
    from paddle3d_tpu_torch.transforms import Gt2SmokeTarget
    params = dict(next(t for t in cfg_dic["train_dataset"]["transforms"]
                       if t["type"] == "Gt2SmokeTarget"))
    params.pop("type")
    gen = Gt2SmokeTarget(**params)
    h, w = gen.input_h, gen.input_w
    b = b or SMOKE_BATCH
    dim_ref = np.asarray(cfg_dic["model"]["dim_ref"], np.float32)  # l, h, w
    rng = np.random.default_rng(seed)
    flips = np.random.RandomState(seed)     # Gt2SmokeTarget's flips
    made = []
    for _ in range(b):
        s = Sample(path=None, modality="image")
        s.rng = flips
        s.data = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        s.meta.camera_intrinsic = smoke_intrinsics(h, w)
        labels = rng.integers(0, len(dim_ref), SMOKE_OBJECTS)
        lhw = dim_ref[labels] * rng.uniform(0.9, 1.1, (SMOKE_OBJECTS, 3))
        z = rng.uniform(8, 45, SMOKE_OBJECTS)
        boxes = np.stack([rng.uniform(-0.3, 0.3, SMOKE_OBJECTS) * z,
                          rng.uniform(1.5, 1.8, SMOKE_OBJECTS), z,
                          lhw[:, 1], lhw[:, 2], lhw[:, 0],
                          rng.uniform(-np.pi, np.pi, SMOKE_OBJECTS)], 1)
        s.bboxes_3d = boxes.astype(np.float32)  # x, y, z, h, w, l, ry
        s.labels = labels.astype(np.int64)
        made.append(gen(s))
    return {"data": torch.from_numpy(np.stack([s.data for s in made])).to(
                device),
            "target": {key: torch.from_numpy(np.stack(
                [s.target[key] for s in made])).to(device)
                for key in made[0].target}}


def gather_bytes(b, k, c):
    """Bytes K14 must move: each index read once, each gathered row read
    once and written once."""
    return 4 * b * k + 8 * b * k * c


def gather_chain_floor(device, iters=50):
    """K14's chain floor: ms a launch of its C entry on one row of one
    float (an index load, a row load, a store, nothing in parallel); not
    counted as a path's launch."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    src = torch.zeros((1, 1, 1), device=device)
    idx = torch.zeros((1, 1), dtype=torch.int32, device=device)
    out = torch.empty((1, 1, 1), device=device)
    fn = _build.function("p3d_gather_rows")
    args = (src.data_ptr(), *src.stride(), idx.data_ptr(), out.data_ptr(), 1,
            1, 1, 1, _build.stream_ptr(device))
    return cuda_ms(lambda: fn(*args), iters)


def k14_parts(label, src, idx, iters=50):
    """K14 at one call, on its inputs: bit for bit against its plain
    version and a second call, then its wrapper and its C entry alone (the
    output made before), timed; torch.gather with its int64 index made
    inside as the yardstick, the byte bound and the chain floor. -> (dict of part -> ms, max_abs_err
    against the plain version)."""
    import torch

    from paddle3d_tpu_torch.ops import _build, gather
    b, a, c = src.shape
    k = idx.shape[1]
    ref = gather.gather_rows_plain(src, idx)
    got, again = (gather.gather_rows(src, idx) for _ in range(2))
    check(same_bits(got, ref) and same_bits(again, got), "{}: K14 differs "
          "from its plain version or a second call".format(label))
    out = torch.empty((b, k, c), device=src.device)
    head = (src.data_ptr(), *src.stride(), idx.data_ptr(), out.data_ptr(), b,
            a, k, c)
    stream = _build.stream_ptr(src.device)
    fn = _build.function("p3d_gather_rows")
    parts = {"wrapper": cuda_ms(lambda: gather.gather_rows(src, idx), iters),
             "kernel alone": cuda_ms(lambda: fn(*head, stream), iters),
             "plain": cuda_ms(lambda: gather.gather_rows_plain(src, idx),
                              iters)}
    parts["torch.gather"] = cuda_ms(lambda: torch.gather(
        src, 1, idx.long()[..., None].expand(-1, -1, c)), iters)
    parts["chain floor"] = gather_chain_floor(src.device, iters)
    log("  K14 at {}: B={} A={} C={} K={}, src strides {}; bit-equal to its "
        "plain version and a second call; ms a call: {}; bound {:.5f} ms "
        "({})".format(label, b, a, c, k, tuple(src.stride()), ", ".join(
            "{} {:.4f}".format(n, v) for n, v in parts.items()),
            *bound(gather_bytes(b, k, c))))
    return parts, (got - ref).abs().max().item()


def check_smoke_outputs(out, b, k, classes):
    """SMOKE's fixed-shape outputs: finite, -1 padded, labels in range."""
    import torch
    check(tuple(out["box3d_cam"].shape) == (b, k, 7) and
          tuple(out["bbox_2d"].shape) == (b, k, 4) and
          tuple(out["scores"].shape) == tuple(out["label_preds"].shape) ==
          tuple(out["alphas"].shape) == (b, k), "SMOKE output shapes")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite SMOKE outputs")
    kept = out["scores"] >= 0
    labels = out["label_preds"]
    check(bool((labels[kept] >= 0).all() & (labels[kept] < classes).all() &
               (labels[~kept] == -1).all() & (out["scores"][~kept] == -1)
               .all()), "SMOKE scores / labels outside the padding "
          "convention")
    return kept.sum(dim=1).tolist()


def smoke_frames_per_s(model, batch, iters):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.test_forward(batch)
    torch.cuda.synchronize()
    return batch["data"].shape[0] * iters / (time.perf_counter() - t0)


def smoke_timing(model, batch, traced=True):
    """Frames/s of both paths in kernel/plain/plain/kernel halves after a
    warm-up (cudnn.benchmark on, as a server runs), peak memory and, if
    traced, a profile of one forward through the kernels."""
    import torch
    b = batch["data"].shape[0]
    for _ in range(2):
        model.test_forward(batch)
        with plain_path():
            model.test_forward(batch)
    rates = {"kernels": [], "plain": []}
    half = SMOKE_ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx:
                rates[path].append(smoke_frames_per_s(model, batch, half))
    rate = {k: SMOKE_ITERS / sum(half / r for r in v)
            for k, v in rates.items()}
    log("  batch {}: {} forwards a path (kernel/plain/plain/kernel halves, "
        "cudnn.benchmark on): kernel path {:.2f} frames/s ({:.3f} ms a "
        "frame), plain path {:.2f} frames/s ({:.3f} ms); halves {}".format(
            b, SMOKE_ITERS, rate["kernels"], 1e3 / rate["kernels"],
            rate["plain"], 1e3 / rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    torch.cuda.reset_peak_memory_stats()
    model.test_forward(batch)
    log("  peak device memory of one forward at batch {}: {:.1f} "
        "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
    if traced:
        profile(lambda: model.test_forward(batch))


def phase_smoke(device):
    """SMOKE on the KITTI config at full width (DLA-34, 3 classes,
    256-channel heads, 50 detections, seeded random weights, f32, TF32
    off): serving at batch 1 and 8 through K14 and on the plain versions
    (outputs equal by bit pattern under deterministic cuDNN), K14 held and
    timed at the decode's calls, frames/s, memory, a profile at batch 8
    (the tiny config card vs CPU: phase 29's evaluate()); training at
    batch 8 (the config's Adam
    and PiecewiseDecay, targets from the port's Gt2SmokeTarget), 10
    falling losses (its train frames/s, memory and profile: phase 29's
    Trainer run of the config). -> (errs, times, extra,
    launches) of K14 for the record: its launches on the two forwards, its
    times at the config's batch."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build, gather
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=SMOKE_KITTI, device=device)
    model = cfg.model.eval()
    head = model.head
    batches = {b: smoke_serve_batch(device, b) for b in (1, SMOKE_BATCH)}
    outs = {}
    with torch.no_grad(), recorded(gather, "gather_rows") as calls:
        _build.reset_launches()
        for b, batch in batches.items():
            outs[b] = model.test_forward(batch)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    kept = {b: check_smoke_outputs(out, b, model.max_detection,
                                   head.num_classes)
            for b, out in outs.items()}
    log("phase 15: SMOKE KITTI serving at {} x {} (DLA-34, {} classes, "
        "{}-channel heads, {} detections): launches {}; boxes over the "
        "threshold a frame {}".format(
            *SMOKE_HW, head.num_classes, head.cls_conv1.out_channels,
            model.max_detection, {k: v for k, v in launches.items() if v},
            kept))
    check(launches["gather_rows"] == len(batches) and
          sum(launches.values()) == len(batches),
          "the SMOKE forwards launched {} where one K14 a forward was "
          "due".format(launches))
    hw = (SMOKE_HW[0] // 4) * (SMOKE_HW[1] // 4)
    for (src, idx), _ in calls:
        check(tuple(src.stride()) == (head.reg_heads * hw, 1, hw),
              "the decode did not read the NCHW map in place")
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            with plain_path():
                ref = model.test_forward(batch)
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "the plain path launched a kernel")
            differ = [k for k in ref if not same_bits(outs[b][k], ref[k])]
            check(not differ, "batch {}: {} differ from the plain path by "
                  "bit pattern".format(b, differ))
    log("  vs the plain path (deterministic cuDNN): every output equal by "
        "bit pattern at batch 1 and {}".format(SMOKE_BATCH))
    parts = {b: k14_parts("SMOKE's decode at batch {}".format(b), *args)
             for b, (args, _) in zip(batches, calls)}
    src, idx = calls[-1][0]                 # the config's batch
    k14_bytes = gather_bytes(idx.shape[0], idx.shape[1], src.shape[2])
    del calls, outs, src, idx

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        for b, batch in batches.items():
            smoke_timing(model, batch, traced=b == SMOKE_BATCH)
    del batches

    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    batch = smoke_train_batch(device, cfg.dic)
    _build.reset_launches()
    losses = step(model, cfg.optimizer, batch)
    torch.cuda.synchronize()
    log("  training at batch {} ({}, {}; {} objects an "
        "image, {} kept by Gt2SmokeTarget): first step losses {}; launches "
        "{}".format(SMOKE_BATCH, cfg.dic["optimizer"]["type"],
                    cfg.dic["lr_scheduler"],
                    SMOKE_OBJECTS, int(batch["target"]["reg_mask"].sum()),
                    {k: round(v.item(), 4) for k, v in losses.items()},
                    {k: v for k, v in _build.LAUNCHES.items() if v}))
    check(not any(_build.LAUNCHES.values()), "the SMOKE train step launched "
          "a kernel (its loss gathers with torch.gather under autograd)")
    # the ten steps also autotune the step's convolutions, which phase 29's
    # SMOKE Trainer then finds tuned; its train frames/s and peak memory
    # are phase 29's (the bare step beside the Trainer)
    falling_losses(step, model, cfg.optimizer, batch)
    del model, step, batch, cfg

    p, err = parts[SMOKE_BATCH]
    return ({"gather_rows": err}, {"gather_rows": (p["wrapper"], p["plain"])},
            {"gather_rows": (p["torch.gather"],) + bound(k14_bytes)},
            {"gather_rows": launches["gather_rows"]})


# Phase 16: CADDN (HRNet-W18 + OCRNet), the second camera model, at the
# config's image size (configs/caddn/caddn_ocrnet_hrnetw18_kitti.yml:
# 384 x 1248, BEV 376 x 280 x 64, 80 LID bins at stride 4), under a KITTI
# camera: smoke_intrinsics' f = 721.5 with the principal point at the centre
# times lidar -> camera axes (x_cam = -y, y_cam = -z, z_cam = x) with the
# offsets of KITTI's Tr_velo_to_cam (training frame 000000); batch 1 as
# tools/bench_camera.py serves it, batch 4 the config's batch_size
CADDN_KITTI = os.path.join(REPO, "configs", "caddn",
                           "caddn_ocrnet_hrnetw18_kitti.yml")
CADDN_TINY = os.path.join(REPO, "configs", "caddn", "caddn_synthetic_tiny.yml")
CADDN_HW = (384, 1248)
CADDN_BATCH = 4
CADDN_ITERS = 2         # timed forwards per path and batch (halves of 1)
# a frame's convolutions and matmuls, by torch.utils.flop_counter over a
# forward at the config's image size (the same in every run since the
# config's widths were fixed)
CADDN_GFLOP = 637.1
CADDN_OBJECTS = 8       # synthetic boxes an image
KITTI_VELO_TO_CAM_T = (-4.069766e-03, -7.631618e-02, -2.717806e-01)
# the tiny config (64 x 96 images) sees its 16 x 16 m grid through a camera
# of this focal length
CADDN_TINY_FOCAL = 60.0
# the tiny config's outputs on the card against the CPU, relative to the
# largest value: cuDNN and the CPU's convolutions sum in other orders
CADDN_TINY_TOL = {"scores": 2e-6, "box3d_lidar": 5e-7}
# the CADDN kernel and plain paths on the card, relative to the largest
# value (BEV) or absolute (scores, boxes): K7 adds a cell's rows in row
# order, index_add_ in a run-dependent order
CADDN_TOL = {"bev": 1e-5, "scores": 1e-5, "box3d_lidar": 1e-4}
CADDN_LOSSES = ("loss", "hm_loss_0", "loc_loss_0", "loss_depth")


def caddn_camera(h, w, focal=SMOKE_FOCAL, yaw=0.0):
    """img2lidar [4, 4] f32 of a camera looking along lidar x (turned by
    yaw about lidar z): the inverse of K @ lidar2cam, K the pinhole with the
    principal point at the image centre, lidar2cam KITTI's axes and
    offsets."""
    import numpy as np
    k = np.eye(4)
    k[:3, :3] = smoke_intrinsics(h, w)
    k[0, 0] = k[1, 1] = focal
    c, s = np.cos(yaw), np.sin(yaw)
    l2c = np.eye(4)
    l2c[:3, :3] = np.array([[0., -1, 0], [0, 0, -1], [1, 0, 0]]) @ np.array(
        [[c, s, 0], [-s, c, 0], [0, 0, 1]])
    l2c[:3, 3] = KITTI_VELO_TO_CAM_T
    return np.linalg.inv(k @ l2c).astype(np.float32)


def caddn_serve_batch(device, b, seed=SEED, hw=None, focal=SMOKE_FOCAL):
    """b images of uniform pixels in [0, 255), NHWC at hw (CADDN_HW by
    default), each with caddn_camera's img2lidar."""
    import numpy as np
    import torch
    h, w = hw or CADDN_HW
    rng = np.random.default_rng(seed)
    cam = np.broadcast_to(caddn_camera(h, w, focal), (b, 4, 4))
    return {"data": torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3))
                                     .astype(np.float32)).to(device),
            "img2lidars": torch.from_numpy(np.array(cam)).to(device)}


def caddn_train_batch(device, model, b=None, seed=SEED):
    """caddn_serve_batch of b (CADDN_BATCH) images with CADDN_OBJECTS boxes
    an image (the config's classes, KITTI-sized, on the ground, inside the
    point-cloud range and in the camera's view, random yaw) and a depth map
    at the feature stride with depths in the config's range, all from the
    seed."""
    import numpy as np
    import torch
    b = b or CADDN_BATCH
    batch = caddn_serve_batch(device, b, seed)
    rng = np.random.default_rng(seed + 1)
    lo, hi = model.pc_range[:3], model.pc_range[3:]
    n = CADDN_OBJECTS
    x = rng.uniform(lo[0] + 4, hi[0] - 3, (b, n))
    half_view = x * (CADDN_HW[1] / 2 - 40) / SMOKE_FOCAL
    y = rng.uniform(-1, 1, (b, n)) * np.minimum(half_view, hi[1] - 2)
    # the config's Car, Cyclist, Pedestrian: KITTI's mean sizes (l, w, h)
    labels = rng.integers(0, sum(model.bbox_head.num_classes), (b, n))
    lwh = np.array([[3.9, 1.6, 1.56], [1.76, 0.6, 1.73],
                    [0.8, 0.6, 1.73]])[labels % 3] * rng.uniform(
                        0.9, 1.1, (b, n, 3))
    boxes = np.concatenate([x[..., None], y[..., None],
                            np.full((b, n, 1), -1.73), lwh,
                            rng.uniform(-np.pi, np.pi, (b, n, 1))], -1)
    h, w = (-(-s // model.downsample) for s in CADDN_HW)
    d0, d1 = model.depth_range
    batch.update(
        gt_boxes=torch.from_numpy(boxes.astype(np.float32)).to(device),
        gt_labels=torch.from_numpy(labels).to(device),
        depth_map=torch.from_numpy(rng.uniform(d0, d1, (b, h, w)).astype(
            np.float32)).to(device))
    return batch


def frustum_stats(model, img2lidars):
    """The first image's frustum at the feature map's size (image_size /
    downsample): rows, the share in the grid, BEV cells hit, the most rows
    of a cell and of a 512-cell span. -> dict."""
    import torch
    h, w = (-(-s // model.downsample) for s in model.image_size)
    rank, valid = model.frustum_ranks(img2lidars[:1], h, w)
    keys = rank[valid].long()
    counts = torch.bincount(keys)
    return {"rows": valid.numel(), "in_grid": int(valid.sum()),
            "share": valid.float().mean().item(),
            "cells": int((counts > 0).sum()), "longest": int(counts.max()),
            "span": int(torch.bincount(keys // 512).max())}


def check_caddn_outputs(out, b, k, classes):
    """CADDN's CenterHead outputs: shapes, finite, -1 padded."""
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    check(tuple(boxes.shape) == (b, k, 7) and tuple(scores.shape) ==
          tuple(labels.shape) == (b, k), "CADDN output shapes")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite CADDN outputs")
    kept = scores >= 0
    check(bool((labels[kept] >= 0).all() & (labels[kept] < classes).all() &
               (labels[~kept] == -1).all() & (scores[~kept] == -1).all()),
          "CADDN scores / labels outside the padding convention")
    return kept.sum(dim=1).tolist()


def k5_parts(label, keys, g, g_extra, cells, c, iters=20):
    """K5 at one call of a path, on the inputs the path handed it: bit for
    bit against its plain version and a second call, then its wrapper and
    its C entry alone (output made before) timed, beside its plain version,
    torch.gather with its int64 index made inside the timing, and the byte
    bound (gather_work). -> (dict of part -> ms, max_abs_err, bound)."""
    import torch

    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    args = (keys, g, g_extra, cells, c)
    ref = sorted_scatter.sorted_table_gather_plain(*args)
    got, again = (sorted_scatter.sorted_table_gather(*args)
                  for _ in range(2))
    check(same_bits(got, ref) and same_bits(again, got), "{}: K5 differs "
          "from its plain version or a second call".format(label))
    err = (got - ref).abs().max().item()
    del again, ref
    b, n = keys.shape
    es = g_extra.stride()[:2] if g_extra is not None else (0, 0)
    fn = _build.function("p3d_sorted_table_gather")
    head = (keys.data_ptr(), g.data_ptr(), *g.stride(),
            g_extra.data_ptr() if g_extra is not None else None, *es,
            got.data_ptr(), b, n, c, g.shape[-1], cells,
            _build.stream_ptr(keys.device))

    def library():
        inside = (keys >= 0) & (keys < cells)
        idx = torch.where(inside, keys, 0).long()[..., None].expand(
            -1, -1, g.shape[-1])
        return torch.where(inside[..., None], torch.gather(g, 1, idx), 0.)
    parts = {"wrapper": cuda_ms(lambda: sorted_scatter.sorted_table_gather(
                 *args), iters),
             "kernel alone": cuda_ms(lambda: fn(*head), iters),
             "plain": cuda_ms(lambda: sorted_scatter.sorted_table_gather_plain(
                 *args), 5),
             "torch.gather": cuda_ms(library, 5)}
    nbytes, _, distinct = gather_work(*args)
    bnd = bound(nbytes)
    log("  K5 at {}: B={} N={} C={} cells={} (cotangent strides {}), {} "
        "distinct in-range cells; bit-equal to its plain version and a "
        "second call; ms a call: {}; kernel / library {:.3f}; bound {:.4f} "
        "ms ({})".format(label, b, n, c, cells, tuple(g.stride()), distinct,
                         ", ".join("{} {:.4f}".format(k, v)
                                   for k, v in parts.items()),
                         parts["wrapper"] / parts["torch.gather"], *bnd))
    return parts, err, bnd


def caddn_stages(model, batch, iters):
    """The stage times of CADDN's test_forward: the image branch (HRNet and
    the OCR features), the FFE (depth head, softmax, channel reduce), the
    frustum ranks (the model's pool_inputs), the sort of the scalar payloads
    and the row rebuild (ops/scatter's halves of bev_pool_sorted), K7, the
    BEV net, the head convs, decode + NMS."""
    import torch

    from paddle3d_tpu_torch.ops import scatter, sorted_scatter
    gx, gy, _ = model.grid_size
    cells = gx * gy

    def ffe(f):
        prob = torch.softmax(model.depth_head(f), dim=1)[:, :-1]
        return model.chan_reduce(f), prob

    def sort(x):
        tab, pix, dep, rank, valid = x
        return (tab,) + scatter.sort_payloads(pix, dep, rank, valid,
                                              tab.dtype)

    def rebuild(x):
        tab, keys, spix, sdep = x
        return keys, scatter.rebuild_rows(tab, spix, sdep)

    stage_times([
        ("image branch", lambda bt: model._image_features(bt["data"])),
        ("FFE", ffe),
        ("frustum ranks", lambda x: model.pool_inputs(
            *x, batch["img2lidars"])),
        ("sort", sort), ("row rebuild", rebuild),
        ("K7", lambda x: sorted_scatter.scatter_rows(*x, cells, False)),
        ("BEV net", lambda t: model.bev_backbone(t.reshape(
            t.shape[0], gy, gx, -1).permute(0, 3, 1, 2).contiguous())),
        ("head convs", model.bbox_head),
        ("decode + NMS", lambda preds: model.bbox_head.predict(
            preds, model.test_cfg))], batch, iters)


def caddn_timing(model, batch, traced=True):
    """Frames/s of both paths in kernel/plain/plain/kernel halves after a
    warm-up (cudnn.benchmark on) and, if traced, peak memory and a profile
    of one forward through the kernels. The convolutions' and matmuls'
    work is the config's CADDN_GFLOP a frame, which gives the TFLOP/s
    logged at the kernel path's ms a frame. caddn_stages times the
    forward's stages (since phase 29 came, by hand: the readings are in
    PERF.md)."""
    import torch
    b = batch["data"].shape[0]
    for _ in range(2):
        model.test_forward(batch)
        with plain_path():
            model.test_forward(batch)
    rates = {"kernels": [], "plain": []}
    half = CADDN_ITERS // 2
    for order in (("kernels", "plain"), ("plain", "kernels")):
        for path in order:
            ctx = plain_path() if path == "plain" else contextlib.nullcontext()
            with ctx:
                rates[path].append(smoke_frames_per_s(model, batch, half))
    rate = {k: CADDN_ITERS / sum(half / r for r in v)
            for k, v in rates.items()}
    log("  batch {}: {} forwards a path (kernel/plain/plain/kernel halves, "
        "cudnn.benchmark on): kernel path {:.2f} frames/s ({:.3f} ms a "
        "frame), plain path {:.2f} frames/s ({:.3f} ms); halves {}".format(
            b, CADDN_ITERS, rate["kernels"], 1e3 / rate["kernels"],
            rate["plain"], 1e3 / rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()}))
    log("  {:.1f} GFLOP a frame in convolutions and matmuls: {:.2f} TFLOP/s "
        "at the kernel path's ms a frame".format(
            CADDN_GFLOP, CADDN_GFLOP * rate["kernels"] / 1e3))
    if not traced:
        return
    torch.cuda.reset_peak_memory_stats()
    model.test_forward(batch)
    log("  peak device memory of one forward at batch {}: {:.1f} "
        "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: model.test_forward(batch))


def phase_caddn_tiny():
    """The tiny config's test_forward on the card (its pool: 192 rows a
    frame onto 32 x 32 cells, sparse, so K2, held bit for bit at its call)
    against the CPU path: labels equal, scores and boxes within
    CADDN_TINY_TOL of the largest value. -> K2's (max_abs_err, ms, library
    ms, bound ms, bound_by), its plain version's ms and its launches."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    model = Config(path=CADDN_TINY, device="cpu").model.eval()
    batch = caddn_serve_batch("cpu", 2, hw=model.image_size,
                              focal=CADDN_TINY_FOCAL)
    with torch.no_grad():
        ref = model.test_forward(batch)
        model.cuda()
        with recorded(sorted_scatter, "scatter_rows") as calls:
            _build.reset_launches()
            got = model.test_forward({k: v.cuda() for k, v in batch.items()})
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
    check(launches["sorted_segment_sum"] == 1 and
          sum(launches.values()) == 1, "the tiny CADDN on the card launched "
          "{} where one K2 was due".format(launches))
    check(torch.equal(got["label_preds"].cpu(), ref["label_preds"]),
          "tiny CADDN labels differ between the card and the CPU")
    errs = {key: ((got[key].cpu() - ref[key]).abs().max() /
                  ref[key].abs().max()).item() for key in CADDN_TINY_TOL}
    log("  tiny config test_forward, card (K2) vs CPU (plain): labels "
        "equal; relative errors {} (tolerances {})".format(
            {k: "{:.3e}".format(v) for k, v in errs.items()},
            CADDN_TINY_TOL))
    check(all(errs[k] <= tol for k, tol in CADDN_TINY_TOL.items()),
          "tiny CADDN outputs differ between the card and the CPU")
    (keys, rows, cells, split), _ = calls[0]
    k2 = k2_call("the tiny CADDN's pool", keys, rows, cells, split)
    plain_ms = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys, rows, cells, split), 20)
    log("  K2 at the tiny CADDN's pool, plain version: {:.4f} ms".format(
        plain_ms))
    return k2, plain_ms, launches["sorted_segment_sum"]


def caddn_compare(out, ref, bev, bev_ref):
    """The kernel path against the plain path: labels equal, the BEV
    table, scores and boxes within CADDN_TOL. -> the errors."""
    import torch
    check(torch.equal(out["label_preds"], ref["label_preds"]),
          "CADDN labels differ from the plain path")
    errs = {"bev": ((bev - bev_ref).abs().max() / bev_ref.abs().max())
            .item(),
            "scores": (out["scores"] - ref["scores"]).abs().max().item(),
            "box3d_lidar": (out["box3d_lidar"] - ref["box3d_lidar"]).abs()
            .max().item()}
    check(all(errs[k] <= tol for k, tol in CADDN_TOL.items()),
          "CADDN outputs differ from the plain path: {}".format(errs))
    return errs


def phase_caddn(device):
    """CADDN on the OCRNet-HRNet-W18 KITTI config at full width (seeded
    random weights, f32, TF32 off): serving at batch 1 and 4 through K7
    and on the plain versions (BEV, scores, boxes within CADDN_TOL, labels
    equal), K7 held bit for bit and timed at both pools, the tiny config
    card (K2) vs CPU, frames/s, memory, profiles, stages; training at
    batch 4 (AdamWOnecycle, clip 10, OneCycle; depth maps): one step
    through K7 and K5 against one on the plain versions from the same
    state (deterministic mode), K5 held and timed at the step's VJP (its
    falling losses, train frames/s and memory: phase 29's Trainer run of
    the same config). -> the record's entries of K7, K5 and K2 at CADDN's
    calls."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=CADDN_KITTI, device=device)
    model = cfg.model.eval()
    gx, gy, _ = model.grid_size
    post = model.test_cfg["nms"]["nms_post_max_size"]
    classes = model.bbox_head.num_classes[0]
    batches = {b: caddn_serve_batch(device, b) for b in (1, CADDN_BATCH)}
    stats = frustum_stats(model, batches[1]["img2lidars"])
    log("phase 16: CADDN KITTI (HRNet-W18 + OCRNet, {} LID bins, BEV {} x "
        "{} x {}, {} classes) at {} x {}: a frame's frustum has {} rows, "
        "{} in the grid (share {:.4f}) on {} cells, at most {} rows a cell "
        "and {} a 512-cell span".format(
            model.depth_bins, gy, gx, model.feat_channels, classes,
            *CADDN_HW, stats["rows"], stats["in_grid"], stats["share"],
            stats["cells"], stats["longest"], stats["span"]))
    check(stats["share"] > 0.5, "less than half the frustum is in the grid")
    outs, launches = {}, {}
    with torch.no_grad(), recorded(sorted_scatter, "scatter_rows") as calls, \
            recorded(model, "_frustum_to_bev") as pooled:
        for b, batch in batches.items():
            _build.reset_launches()
            outs[b] = model.test_forward(batch)
            torch.cuda.synchronize()
            launches[b] = dict(_build.LAUNCHES)
    kept = {b: check_caddn_outputs(out, b, post, classes)
            for b, out in outs.items()}
    log("  serving through the kernels: launches by batch {}; boxes over "
        "the threshold a frame {}".format(
            {b: {k: v for k, v in n.items() if v}
             for b, n in launches.items()}, kept))
    check(all(n["sorted_segment_sum_dense"] == 1 and sum(n.values()) == 1
              for n in launches.values()),
          "the CADDN forwards launched {} where one K7 a forward was "
          "due".format(launches))
    bevs = {b: out for b, ((_, out)) in zip(batches, pooled)}
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            with plain_path(), recorded(model, "_frustum_to_bev") as ref_bev:
                ref = model.test_forward(batch)
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "the plain path launched a kernel")
            errs = caddn_compare(outs[b], ref, bevs[b], ref_bev[0][1])
            log("  batch {} vs the plain path: labels equal; BEV {:.3e} of "
                "its largest value, scores {:.3e}, boxes {:.3e} (tolerances "
                "{})".format(b, errs["bev"], errs["scores"],
                             errs["box3d_lidar"], CADDN_TOL))
    del outs, bevs, pooled, ref, ref_bev
    k7 = {}
    for b, ((keys, rows, cells, split), _) in zip(batches, calls):
        k7[b] = k7_parts("CADDN's pool at batch {}".format(b), keys, rows,
                         cells, split, iters=20)
    keys, rows, cells, _ = calls[-1][0]
    k7_bytes = scatter_bytes(keys, cells, rows.shape[-1],
                             keys.shape[0] * cells * rows.shape[-1])
    k7_plain = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys, rows, cells, False), 5)
    log("  K7 at CADDN's pool at batch {}, plain version: {:.4f} ms".format(
        CADDN_BATCH, k7_plain))
    del calls, keys, rows
    k2, k2_plain, k2_launches = phase_caddn_tiny()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        for b, batch in batches.items():
            caddn_timing(model, batch, traced=b == CADDN_BATCH)
    del batches

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch = caddn_train_batch(device, model)
    restore = saved_state(model, optimizer, scheduler)
    # both steps in torch's deterministic mode: its index_add_ then adds
    # each cell's rows in row order, as K7 does, so the two BEVs agree bit
    # for bit and no relu input near 0 falls on another side (with
    # index_add_'s atomics the BEV differs by ~3e-6 of its largest value,
    # and a BEV conv's grads by up to 1.5e-2 of their largest). The
    # upsamplings' backward (HRNet) has no deterministic form: warn_only
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        with deterministic(warn_only=True), \
                recorded(sorted_scatter, "scatter_rows") as fwd, \
                recorded(sorted_scatter, "sorted_table_gather") as bwd, \
                recorded(model, "_frustum_to_bev") as kbev:
            kernel = record_step(step, model, optimizer, batch)
        restore()
        with deterministic(warn_only=True), plain_path(), \
                recorded(model, "_frustum_to_bev") as pbev:
            plain = record_step(step, model, optimizer, batch)
        restore()
    equal = same_bits(kbev[0][1], pbev[0][1])
    log("  train forward's BEV, kernel step vs plain step (deterministic "
        "mode): {}; ops the mode ran without a deterministic form: {}"
        .format("bit-equal" if equal else "differ by {:.3e}".format(
            (kbev[0][1] - pbev[0][1]).abs().max().item()),
                sorted({str(w.message).split(" does not")[0]
                        for w in warned})))
    check(equal, "the train step's pool (K7) differs from the plain step's "
          "row-order index_add_")
    del kbev, pbev
    log("  training at batch {} ({}, clip {}, {}; {} boxes an image, depth "
        "maps at the feature stride): kernel step losses {}; launches {}; "
        "plain step launches {}".format(
            CADDN_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], CADDN_OBJECTS,
            {k: round(v, 5) for k, v in kernel[0].items()},
            {k: v for k, v in kernel[3].items() if v},
            {k: v for k, v in plain[3].items() if v}))
    check(kernel[3]["sorted_segment_sum_dense"] == 1 and
          kernel[3]["sorted_table_gather"] == 1 and
          sum(kernel[3].values()) == 2, "the CADDN train step launched {} "
          "where one K7 and one K5 were due".format(kernel[3]))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    # the OCR head's aux-classifier bias shifts every pixel of a region's
    # logits alike, and f_object's bias every region of a pixel's
    # similarities: both softmaxes take them away; f_down's and f_up's
    # shift every pixel of a context channel alike, which the projection's
    # batch-statistics BN takes away
    names = dict(model.named_parameters())
    dead = [n for n in ("class_head.aux_head.layers.1.bias",
                        "class_head.spatial_ocr.f_object.bias",
                        "class_head.spatial_ocr.f_down.bias",
                        "class_head.spatial_ocr.f_up.bias") if n in names]
    step_errs = compare_steps(kernel, plain, 1e-6, 1e-4, 1e-6, CADDN_LOSSES,
                              dead)
    log("  vs the plain step (deterministic mode): losses {:.3e} "
        "(tolerance 1e-6), grads {:.3e} (1e-4), running stats {:.3e} "
        "(1e-6), relative; {} have no gradient on either step".format(
            *step_errs, dead))
    # K7 at the step's pool: held above (its BEV bit-equal to the plain
    # step's, whose index_add_ adds in row order in deterministic mode)
    check(len(fwd) == 1 and fwd[0][0][0].shape == (CADDN_BATCH, stats[
        "rows"]), "expected one pool of whole frames a train step")
    k5 = k5_parts("CADDN's train backward", *bwd[0][0])
    k5_launches = kernel[3]["sorted_table_gather"]
    # its falling losses, train frames/s, memory and profile are phase
    # 29's: the same config through the Trainer at this batch
    del fwd, bwd, kernel, plain
    del model, step, batch, cfg, optimizer, scheduler, restore

    p7, k7_err = k7[CADDN_BATCH]
    k5_ms, k5_err, k5_bound = k5

    def entry(name, path, launches, err, ms, plain_ms, library_ms, bnd):
        src, tpu, _ = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, "path": path}
    return [entry("sorted_segment_sum_dense", "CADDN serving, batch {}"
                  .format(CADDN_BATCH),
                  launches[CADDN_BATCH]["sorted_segment_sum_dense"], k7_err,
                  p7["wrapper"], k7_plain, p7["index_add_call"],
                  bound(k7_bytes)),
            entry("sorted_table_gather", "CADDN training, batch {}".format(
                CADDN_BATCH), k5_launches, k5_err, k5_ms["wrapper"],
                  k5_ms["plain"], k5_ms["torch.gather"], k5_bound),
            entry("sorted_segment_sum", "the tiny CADDN config's serving",
                  k2_launches, k2[0], k2[1], k2_plain, k2[2], k2[3:])]


# Phase 17: PETR and PETRv2 (VoVNet-99-eSE + CPFPN + the 3-D position-
# embedded DETR head: 900 queries, 6 layers, 64 LID bins), bench.py's third
# and fourth camera models, at the configs' 320 x 800 images of uniform
# pixels under tools/bench_camera.py's six-camera ring (_rig: a yaw ring,
# fx = fy = 800, principal point (400, 225)) with its intrinsics for the [0,
# 1] image coordinates the head lifts; PETRv2's previous frame is the same
# ring PETR_EGO m behind. A frame is one sample: 6 images (PETRv2: 12, the
# current and the previous frame's), one set of boxes
PETR_V1 = os.path.join(REPO, "configs", "petr",
                       "petr_vovnet_gridmask_p4_800x320.yml")
PETR_V2 = os.path.join(REPO, "configs", "petr",
                       "petrv2_vovnet_gridmask_p4_800x320.yml")
PETR_DN = os.path.join(REPO, "configs", "petr",
                       "petrv2_dn_vovnet_gridmask_p4_800x320.yml")
PETR_SEG = os.path.join(REPO, "configs", "petr", "petrv2_BEVseg_800x320.yml")
PETR_TINY = os.path.join(REPO, "configs", "petr", "petr_synthetic_tiny.yml")
PETR_HW = (320, 800)
PETR_CAMS = 6
PETR_BATCH = 2          # the configs' batch_size; bench.py serves batch 1
PETR_ITERS = 2          # timed forwards per batch (halves of 1)
PETR_TRAIN_ITERS = 2    # timed train steps (halves of 1)
PETR_OBJECTS = 8        # gt boxes a frame, then two padded slots
PETR_EGO = 0.5          # m the ego moved between PETRv2's two frames
# the tiny config's class branch gets this contrast before the card-vs-CPU
# check: its random scores sit near sigmoid(-2.19), and near-equal scores
# would order differently on the two devices
PETR_CLS_GAIN = 8.0
# its outputs on the card against the CPU, relative to the largest value:
# about 10x the readings on an H100 (scores 8.4e-7, boxes 7.8e-7)
PETR_TINY_TOL = {"scores": 1e-5, "box3d_lidar": 1e-5}


def bench_camera():
    """tools/bench_camera.py as a module (it imports numpy only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_camera", os.path.join(REPO, "tools", "bench_camera.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def petr_rig(hw, n=PETR_CAMS, frames=1, ego=PETR_EGO):
    """tools/bench_camera.py's ring of n cameras (_rig) for h x w images:
    its K scaled by w / 800 (the 800-wide image's field of view at any
    width), then for [0, 1] image coordinates. -> (img2lidars [frames * n,
    4, 4] f32, frame f's cameras f * ego m behind along lidar x, and
    lidar2img [n, 4, 4] in pixels)."""
    import numpy as np
    h, w = hw
    l2c, ks = bench_camera()._rig(None, n)
    k4 = np.tile(np.eye(4), (n, 1, 1))
    k4[:, :3, :3] = ks
    k4[:, :2] *= w / 800.0
    l2i = k4 @ l2c
    to_unit = np.diag([1.0 / w, 1.0 / h, 1.0, 1.0])
    cams = []
    for f in range(frames):
        back = np.eye(4)
        back[0, 3] = -f * ego
        cams.append(back @ np.linalg.inv(to_unit @ l2i))
    return np.concatenate(cams).astype(np.float32), l2i


def cape_rig(hw, n=PETR_CAMS, frames=1, ego=PETR_EGO):
    """petr_rig's img2lidars and the lidar2cams that agree with them:
    frame f's lidar -> camera maps are tools/bench_camera.py's lidar2cam
    after the frame's ego offset, so that lidar2cam @ img2lidar is the
    camera-frame lift of [0, 1] image coordinates, the same for every
    frame. -> (img2lidars, lidar2cams), both [frames * n, 4, 4] f32."""
    import numpy as np
    cams = petr_rig(hw, n, frames, ego)[0]
    l2c = bench_camera()._rig(None, n)[0].astype(np.float64)
    out = []
    for f in range(frames):
        back = np.eye(4)
        back[0, 3] = -f * ego
        out.append(l2c @ np.linalg.inv(back))
    return cams, np.concatenate(out).astype(np.float32)


def petr_serve_batch(device, b, frames=1, seed=SEED, hw=None, n=PETR_CAMS):
    """b frames of n uniform-pixel images in [0, 255) each (frames x n
    for PETRv2), NHWC at hw (PETR_HW by default), with petr_rig's
    img2lidars."""
    import numpy as np
    import torch
    h, w = hw or PETR_HW
    rng = np.random.default_rng(seed)
    cams = petr_rig((h, w), n, frames)[0]
    return {"img": torch.from_numpy(rng.uniform(
                0, 255, (b, frames * n, h, w, 3)).astype(np.float32)).to(
                    device),
            "img2lidars": torch.from_numpy(np.broadcast_to(
                cams, (b, frames * n, 4, 4)).copy()).to(device)}


def petr_gt(rng, b, hw, classes, n=PETR_CAMS, objects=PETR_OBJECTS):
    """b frames of `objects` car-sized boxes each, 10-45 m out, their
    centres in some camera's image (rejection sampled), then two padded
    slots: gt_boxes [b, objects + 2, 9] (x, y, bottom z, w, l, h, yaw,
    vx, vy), gt_labels [b, objects + 2] (-1 padded)."""
    import numpy as np
    h, w = hw
    l2i = petr_rig(hw, n)[1]
    boxes = np.zeros((b, objects + 2, 9), np.float32)
    labels = np.full((b, objects + 2), -1, np.int64)
    for s in range(b):
        k = 0
        while k < objects:
            az = rng.uniform(-np.pi, np.pi)
            r = rng.uniform(10, 45)
            dims = np.array([1.9, 4.6, 1.7]) * rng.uniform(0.9, 1.1, 3)
            zb = rng.uniform(-2.0, -1.4)
            ctr = np.array([r * np.cos(az), r * np.sin(az), zb + dims[2] / 2,
                            1.0])
            p = l2i @ ctr
            seen = (p[:, 2] > 0.1) & np.all(
                (p[:, :2] / p[:, 2:3] >= 0) & (p[:, :2] / p[:, 2:3] < [w, h]),
                axis=1)
            if not seen.any():
                continue
            boxes[s, k] = [ctr[0], ctr[1], zb, *dims,
                           rng.uniform(-np.pi, np.pi), *rng.uniform(-2, 2, 2)]
            labels[s, k] = rng.integers(0, classes)
            k += 1
    return boxes, labels


def petr_train_batch(device, model, b, frames=1, seed=SEED, hw=None):
    """petr_serve_batch with petr_gt's targets (and, with a seg head, a
    random occupancy gt_semantic_map [b, bev_h, bev_w, classes] at 0.2)."""
    import numpy as np
    import torch
    hw = hw or PETR_HW
    batch = petr_serve_batch(device, b, frames, seed, hw)
    rng = np.random.default_rng(seed + 1)
    boxes, labels = petr_gt(rng, b, hw, model.head.num_classes)
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device))
    seg = model.seg_head
    if seg is not None:
        batch["gt_semantic_map"] = torch.from_numpy(
            (rng.random((b, seg.bev_h, seg.bev_w, seg.num_classes)) < 0.2)
            .astype(np.float32)).to(device)
    return batch


def check_petr_outputs(out, b, k, code, classes):
    """PETR's fixed-shape outputs: finite, labels in range, scores in
    (0, 1) (the threshold is 0: every top-k score is kept)."""
    import torch
    check(tuple(out["box3d_lidar"].shape) == (b, k, code - 1) and
          tuple(out["scores"].shape) == tuple(out["label_preds"].shape) ==
          (b, k), "PETR output shapes")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite PETR outputs")
    labels = out["label_preds"]
    check(bool(((labels >= 0) & (labels < classes)).all() &
               (out["scores"] > 0).all() & (out["scores"] < 1).all()),
          "PETR scores / labels out of range")


def petr_stages(model, batch, iters=3):
    """Host-clock ms of test_forward's stages (each ended by a
    synchronize): backbone, neck, tokens + position embedding, decoder
    (its self- and cross-attention apart: each attention call timed
    between two synchronizes), decode; averaged over iters after a
    warm-up. PETRv2's time-embedding add is left out (one add)."""
    import torch
    head = model.head
    b, n, h, w, c = batch["img"].shape
    attn = {"self-attention": [], "cross-attention": []}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            attn[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    stages = [
        ("backbone", lambda bt: model.backbone(
            bt["img"].reshape(b * n, h, w, c).permute(0, 3, 1, 2)
            .contiguous())),
        ("neck", model.neck),
        ("tokens + position embedding", lambda feats: head.tokens(
            feats[0].reshape((b, n) + tuple(feats[0].shape[1:])),
            batch["img2lidars"])),
        ("decoder", lambda tk: head._decode(*tk)),
        ("decode", lambda out: head.predict(*out))]
    patches = [mock.patch.object(layer.attns[i].attn, "forward",
                                 timed(key, layer.attns[i].attn.forward))
               for layer in head.decoder.layers
               for i, key in ((0, "self-attention"),
                              (1, "cross-attention"))]

    def run():
        x, out = batch, []
        for _, fn in stages:
            t0 = time.perf_counter()
            x = fn(x)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad(), contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        run()
        for v in attn.values():
            v.clear()
        ms = [sum(v) / iters for v in zip(*(run() for _ in range(iters)))]
    parts = {k: sum(v) / iters for k, v in attn.items()}
    times = dict(zip((s for s, _ in stages), ms))
    log("  stages a batch (host clock, synchronised; each attention call "
        "between two synchronizes): {}; of the decoder: self-attention "
        "{:.3f} ms, cross-attention {:.3f} ms, the rest {:.3f} ms".format(
            ", ".join("{} {:.3f} ms".format(k, v) for k, v in times.items()),
            parts["self-attention"], parts["cross-attention"],
            times["decoder"] - sum(parts.values())))
    return times, parts


def petr_flops(model, batch):
    """GFLOP a frame of one test_forward's convolutions and matmuls
    (torch.utils.flop_counter), in all and by module: backbone, neck,
    head, and the decoder's attention products."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    b = batch["img"].shape[0]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.test_forward(batch)
    counts = counter.get_flop_counts()
    total = counter.get_total_flops()

    def of(name):
        return sum(counts.get(name, {}).values()) / 1e9 / b

    # the attention products (q.k and weights.v): each attention module's
    # count (the tracker names it by its path under the head, whose count
    # holds its children's) less its four projections'
    head = type(model.head).__name__
    attn = [k for k in counts if k.startswith(head + ".decoder.") and
            k.endswith(".attn")]
    products = sum(of(k) - sum(of(k + "." + p) for p in (
        "query", "key", "value", "out")) for k in attn)
    return {"total": total / 1e9 / b,
            "backbone": of(type(model.backbone).__name__),
            "neck": of(type(model.neck).__name__), "head": of(head),
            "attention products": products}


def petr_timing(model, batch, label, stages=None):
    """Frames/s over PETR_ITERS forwards in two halves after a warm-up
    (cudnn.benchmark on, as a server runs), the convolutions' and
    matmuls' work a frame, peak memory, a profile of one forward and the
    stage times (stages(model, batch), petr_stages by default)."""
    import torch
    b = batch["img"].shape[0]
    for _ in range(2):
        model.test_forward(batch)
    half = PETR_ITERS // 2
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(half):
            model.test_forward(batch)
        torch.cuda.synchronize()
        rates.append(b * half / (time.perf_counter() - t0))
    rate = PETR_ITERS / sum(half / r for r in rates)
    flops = petr_flops(model, batch)
    log("  {} batch {}: {} forwards (two halves, cudnn.benchmark on): {:.2f} "
        "frames/s ({:.3f} ms a frame; {} images a frame); halves {}; "
        "GFLOP a frame (torch.utils.flop_counter) {}: {:.2f} TFLOP/s at that "
        "rate".format(label, b, PETR_ITERS, rate, 1e3 / rate,
                      batch["img"].shape[1], [round(r, 2) for r in rates],
                      {k: round(v, 1) for k, v in flops.items()},
                      flops["total"] * rate / 1e3))
    torch.cuda.reset_peak_memory_stats()
    model.test_forward(batch)
    log("  peak device memory of one forward at batch {}: {:.1f} "
        "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: model.test_forward(batch))
    (stages or petr_stages)(model, batch)


def petr_serve(model, batches, label):
    """test_forward at each batch twice: outputs equal by bit pattern, no
    hand-kernel launch, the outputs' shapes and ranges. -> outputs."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    head = model.head
    outs = {}
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            out, again = (model.test_forward(batch) for _ in range(2))
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "{} launched {}: PETR reaches no hand-written kernel"
                  .format(label, {k: v for k, v in _build.LAUNCHES.items()
                                  if v}))
            differ = [k for k in out if not same_bits(out[k], again[k])]
            check(not differ, "{} at batch {}: two calls differ in {}"
                  .format(label, b, differ))
            check_petr_outputs(out, b, min(300, head.num_query *
                                            head.num_classes),
                               head.code_size, head.num_classes)
            outs[b] = out
    log("  {}: test_forward at batch {}: no kernel launch; two calls equal "
        "by bit pattern; top scores a frame {}".format(
            label, list(batches), {b: [round(v, 4) for v in o["scores"][
                :, 0].tolist()] for b, o in outs.items()}))
    return outs


def phase_petr_tiny():
    """The tiny config's test_forward on the card against the CPU, its
    class branch's last weight scaled by PETR_CLS_GAIN: labels equal,
    scores and boxes within PETR_TINY_TOL of the largest value (cuDNN and
    cuBLAS against the CPU's convolutions and matmuls). -> the errors."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops import _build
    model = Config(path=PETR_TINY, device="cpu").model.eval()
    with torch.no_grad():
        model.head.cls_branch.layers[2].weight.mul_(PETR_CLS_GAIN)
    batch = petr_serve_batch("cpu", 2, hw=(32, 48), n=2)
    with torch.no_grad():
        ref = model.test_forward(batch)
        model.cuda()
        _build.reset_launches()
        got = model.test_forward({k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()), "the tiny PETR launched a "
          "kernel")
    check(torch.equal(got["label_preds"].cpu(), ref["label_preds"]),
          "tiny PETR labels differ between the card and the CPU")
    errs = {key: ((got[key].cpu() - ref[key]).abs().max() /
                  ref[key].abs().max()).item() for key in PETR_TINY_TOL}
    log("  tiny config test_forward, card vs CPU: labels equal; relative "
        "errors {} (tolerances {})".format(
            {k: "{:.3e}".format(v) for k, v in errs.items()}, PETR_TINY_TOL))
    check(all(errs[k] <= tol for k, tol in PETR_TINY_TOL.items()),
          "tiny PETR outputs differ between the card and the CPU")
    return errs


@contextlib.contextmanager
def hungarian_clock():
    """Host ms of the train step's Hungarian work: -> dict of lists, a
    value a call: "match" (hungarian_match: the cost's copy to the host,
    which waits for the queued forward, then the solves) and "solve" (each
    scipy solve alone)."""
    from paddle3d_tpu_torch.models.heads import target_assigners as ta
    ms = {"match": [], "solve": []}

    def clocked(key, fn):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    with mock.patch.object(ta, "hungarian_match",
                           clocked("match", ta.hungarian_match)), \
            mock.patch.object(ta, "_solve_host",
                              clocked("solve", ta._solve_host)):
        yield ms


def petr_one_step(device, path, label):
    """One train step of a PETRv2 config at batch 1 (two frames of six
    cameras): finite losses and grads. -> the losses."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    cfg = Config(path=path, device=device)
    model = cfg.model.train()
    batch = petr_train_batch(device, model, 1, frames=2)
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = step(model, cfg.optimizer, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check(not any(_build.LAUNCHES.values()), "{} launched a kernel"
          .format(label))
    finite = all(bool(torch.isfinite(v).all()) for v in losses.values())
    grads = all(bool(torch.isfinite(p.grad).all())
                for p in model.parameters())
    log("  {} train step at batch 1 ({} images): losses {}; grads finite: "
        "{}; {:.3f} s (the first, cold); peak {:.1f} MiB".format(
            label, batch["img"].shape[1],
            {k: round(v.item(), 5) for k, v in losses.items()}, grads, sec,
            torch.cuda.max_memory_allocated() / 2**20))
    check(finite and grads, "{}: non-finite losses or grads".format(label))
    return losses


def phase_petr(device):
    """PETR and PETRv2 at full width (VoVNet-99-eSE, CPFPN 768 / 1024 ->
    256, 900 queries, 6 layers, 8 heads, 64 LID bins, 10 classes; seeded
    random weights, f32, TF32 off) at 320 x 800 under petr_rig: serving v1
    at batch 1 and 2 and v2 at batch 1 (two calls equal, no hand-kernel
    launch), the tiny config card vs CPU, frames/s, GFLOP, memory,
    profiles, stages; training v1 at batch 2 (the config's AdamW, clip 35,
    CosineDecay; petr_gt's boxes): one step, no launch, a host match a
    decoder layer (its falling losses and train frames/s: phase 30's
    Trainer run); one step each of PETRv2 with query denoising and
    PETRv2-BEVseg at batch 1."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=PETR_V1, device=device)
    model = cfg.model.eval()
    head = model.head
    log("phase 17: PETR (VoVNet-99-eSE + CPFPN, {} queries, {} layers, {} "
        "LID bins, {} classes) at {} x {} under a ring of {} cameras".format(
            head.num_query, head.num_layers, head.depth_num,
            head.num_classes, *PETR_HW, PETR_CAMS))
    batches = {b: petr_serve_batch(device, b) for b in (1, PETR_BATCH)}
    petr_serve(model, batches, "PETR")
    phase_petr_tiny()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        for batch in batches.values():
            petr_timing(model, batch, "PETR")
    del batches

    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer = cfg.optimizer
    batch = petr_train_batch(device, model, PETR_BATCH)
    _build.reset_launches()
    with hungarian_clock() as hung:
        losses = step(model, optimizer, batch)
        torch.cuda.synchronize()
    log("  training at batch {} ({}, clip {}, {}; {} boxes a frame in range "
        "and in view, 2 padded slots): first step losses {}; launches {}; "
        "{} Hungarian matches ({} scipy solves)".format(
            PETR_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], PETR_OBJECTS,
            {k: round(v.item(), 5) for k, v in losses.items()},
            {k: v for k, v in _build.LAUNCHES.items() if v},
            len(hung["match"]), len(hung["solve"])))
    check(not any(_build.LAUNCHES.values()), "the PETR train step launched "
          "a kernel")
    check(len(hung["match"]) == head.num_layers and
          len(hung["solve"]) == head.num_layers * PETR_BATCH,
          "expected one host match a decoder layer, a solve a frame")
    # its falling losses, train frames/s, memory and profile: phase 30's
    # Trainer run of the config
    del model, step, batch, cfg, optimizer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = Config(path=PETR_V2, device=device).model.eval()
    batches = {1: petr_serve_batch(device, 1, frames=2)}
    petr_serve(model, batches, "PETRv2")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        petr_timing(model, batches[1], "PETRv2")
    del model, batches
    dn = petr_one_step(device, PETR_DN, "PETRv2 with query denoising")
    check({"loss_cls_dn", "loss_bbox_dn"} <= set(dn), "no DN losses")
    seg = petr_one_step(device, PETR_SEG, "PETRv2-BEVseg")
    check({"loss_seg_bce", "loss_seg_dice"} <= set(seg), "no seg losses")


# Phase 18: BEVFormer-tiny (ResNet-50 to C5, FPN to 256, a 50 x 50 BEV of
# 256 channels, 3 encoder layers of temporal self-attention and spatial
# cross-attention, the 6-layer decoder of 900 queries with box refinement),
# bench.py's fifth camera model, on six 450 x 800 uniform-pixel images a
# frame padded to 480 x 800 (PadMultiViewImage's size_divisor 32) under
# bevformer_rig: tools/bench_camera.py's ring for [0, 1] image coordinates.
BEVFORMER = os.path.join(REPO, "configs", "bevformer",
                         "bevformer_tiny_r50_fpn_nuscenes.yml")
BEVFORMER_HW = (480, 800)       # the padded images
BEVFORMER_IMAGE = (450, 800)    # the images before padding


def bevformer_rig(hw, n=PETR_CAMS):
    """lidar2imgs [n, 4, 4] f32 for [0, 1] image coordinates of h x w
    images: petr_rig's pixel lidar2img (tools/bench_camera.py's ring, its
    K scaled by w / 800) divided by w and h."""
    import numpy as np
    h, w = hw
    l2i = petr_rig(hw, n)[1]
    return (np.diag([1.0 / w, 1.0 / h, 1.0, 1.0]) @ l2i).astype(np.float32)


# Phase 19: BEVDet4D (ResNet-50 to C4, the LSS view transformer of 59 depth
# bins onto a 128 x 128 BEV of 64 channels, the previous frame's BEV
# concatenated, CustomResNet + FPN_LSS, CenterHead of 10 classes), bench.py's
# sixth camera model, on six 256 x 704 uniform-pixel images a frame under
# bevdet_rig.
BEVDET = os.path.join(REPO, "configs", "bevdet",
                      "bevdet4d_r50_depth_nuscenes.yml")
BEVDET_HW = (256, 704)


def _small_rotation(rng, std):
    """A rotation [3, 3] about a random axis by a normal angle of std rad
    (Rodrigues' formula)."""
    import numpy as np
    v = rng.normal(0.0, std, 3)
    t = np.linalg.norm(v)
    if t == 0:
        return np.eye(3)
    k = v / t
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(t) * kx + (1 - np.cos(t)) * kx @ kx


def bevdet_rig(hw, n=PETR_CAMS, b=1, tilt=0.0, bda_yaw=0.0, seed=SEED):
    """BEVDet's camera matrices for b frames of n h x w images:
    tools/bench_camera.py's ring (_rig: a yaw ring, K for 450 x 800 images)
    as BEVDet's test pipeline hands it, the 450 x 800 image resized by w /
    800 and its top rows cropped to h (ResizeCropFlipImage: post_rots
    diag(r, r, 1), post_trans (0, -crop, 0)); rots / trans camera -> ego;
    with tilt, each camera turned by a small rotation of that std (rad,
    seeded: real rigs pitch and roll a little); bda a yaw of bda_yaw rad.
    -> dict of f32 numpy arrays, each with a leading [b]."""
    import numpy as np
    h, w = hw
    l2c, ks = bench_camera()._rig(None, n)
    c2l = np.linalg.inv(l2c.astype(np.float64))
    rng = np.random.default_rng(seed)
    if tilt:
        c2l[:, :3, :3] = np.stack([c2l[i, :3, :3] @ _small_rotation(
            rng, tilt) for i in range(n)])
    r = w / 800.0
    crop = round(450 * r) - h
    post_rots = np.tile(np.diag([r, r, 1.0]), (n, 1, 1))
    post_trans = np.tile([0.0, -crop, 0.0], (n, 1))
    c, s = np.cos(bda_yaw), np.sin(bda_yaw)
    bda = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def tile(x):
        return np.broadcast_to(x, (b,) + x.shape).astype(np.float32).copy()
    return {"rots": tile(c2l[:, :3, :3]), "trans": tile(c2l[:, :3, 3]),
            "cam2imgs": tile(ks.astype(np.float64)),
            "post_rots": tile(post_rots), "post_trans": tile(post_trans),
            "bda": tile(bda)}


BEVFORMER_ITERS = 4         # timed forwards (halves of 2)
BEVFORMER_TRAIN_ITERS = 2   # timed train steps (halves of 1)
# the second served frame's ego motion: dx, dy (m), the ego's yaw and the
# yaw delta (rad)
BEVFORMER_MOTION = (0.6, 0.15, 0.4, 0.03)
# the images are normalised as the configs' NormalizeMultiviewImage does
BEVFORMER_MEAN, BEVFORMER_STD = (103.530, 116.280, 123.675), (1., 1., 1.)
BEVDET_MEAN, BEVDET_STD = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
# the tiny configs on the card against the CPU, relative to the largest
# value: cuDNN and cuBLAS against the CPU's convolutions and matmuls
# (BEVFormer: 2.5 to 16x its readings on an H100, scores 4.0e-6, boxes
# 6.3e-7, BEV 1.6e-6, the class gain amplifying the encoder's rounding;
# BEVDet4D: about 10x, scores 1.5e-7, boxes 1.8e-8, BEV 3.2e-7)
BEVFORMER_TINY_TOL = {"scores": 1e-5, "box3d_lidar": 1e-5,
                      "bev_feature": 1e-5}
BEVDET_TINY_TOL = {"scores": 2e-6, "box3d_lidar": 2e-7,
                   "bev_feature": 5e-6}
TINY_CLS_GAIN = 8.0         # as PETR_CLS_GAIN: near-equal random scores
BEVDET_BATCH = 8            # the config's batch_size
BEVDET_ITERS = 4            # timed forwards per path and batch (halves)
BEVDET_OBJECTS = 16         # gt boxes a frame, then two padded slots
BEVDET_LOSSES = ("loss", "hm_loss_0", "loc_loss_0")


def normalised_images(rng, shape, mean, std, pad_to=None):
    """Uniform pixels in [0, 255) of shape [..., H, W, 3], normalised by
    mean / std, zero-padded at the bottom and right to pad_to (h, w)."""
    import numpy as np
    img = (rng.uniform(0, 255, shape) - np.asarray(mean)) / np.asarray(std)
    if pad_to is not None:
        pads = [(0, 0)] * (img.ndim - 3) + [
            (0, pad_to[0] - shape[-3]), (0, pad_to[1] - shape[-2]), (0, 0)]
        img = np.pad(img, pads)
    return img.astype(np.float32)


def move_samples(model, generator):
    """Give every deformable attention's sampling offsets lecun-normal
    weights from generator (the JAX package starts them at zero, so an
    untrained model samples at its reference points; a trained one does
    not)."""
    import torch

    from paddle3d_tpu_torch.models.layers.layer_libs import lecun_normal_
    from paddle3d_tpu_torch.models.transformers import MSDeformableAttention
    for m in model.modules():
        if isinstance(m, MSDeformableAttention):
            w = torch.empty(m.sampling_offsets.weight.shape)
            lecun_normal_(w, generator)
            with torch.no_grad():
                m.sampling_offsets.weight.copy_(w)


def bevformer_serve_batch(device, b, seed=SEED, hw=None, image=None,
                          n=PETR_CAMS, motion=None):
    """b frames of n normalised uniform-pixel images of `image` (by default
    BEVFORMER_IMAGE) padded to hw (BEVFORMER_HW), with bevformer_rig's
    lidar2imgs; with motion (dx, dy, yaw, yaw delta) a can_bus [b, 18]."""
    import numpy as np
    import torch
    hw = hw or BEVFORMER_HW
    image = image or BEVFORMER_IMAGE
    rng = np.random.default_rng(seed)
    batch = {"img": torch.from_numpy(normalised_images(
                 rng, (b, n) + tuple(image) + (3,), BEVFORMER_MEAN,
                 BEVFORMER_STD, pad_to=hw)).to(device),
             "lidar2imgs": torch.from_numpy(np.broadcast_to(
                 bevformer_rig(hw, n), (b, n, 4, 4)).copy()).to(device)}
    if motion is not None:
        can = np.zeros((b, 18), np.float32)
        can[:, 0], can[:, 1], can[:, -2], can[:, -1] = motion
        batch["can_bus"] = torch.from_numpy(can).to(device)
    return batch


def bevformer_train_batch(device, model, b, seed=SEED):
    """bevformer_serve_batch with BEVFORMER_MOTION, a one-frame history
    queue (its own images, the same cameras, a can_bus of its own motion)
    and petr_gt's boxes."""
    import numpy as np
    import torch
    batch = bevformer_serve_batch(device, b, seed,
                                  motion=BEVFORMER_MOTION)
    prev = bevformer_serve_batch(device, b, seed + 2,
                                 motion=(0.5, 0.0, 0.37, 0.0))
    batch.update(img_queue=prev["img"][:, None],
                 lidar2imgs_queue=prev["lidar2imgs"][:, None],
                 can_bus_queue=prev["can_bus"][:, None])
    boxes, labels = petr_gt(np.random.default_rng(seed + 1), b,
                            BEVFORMER_HW, model.head.num_classes)
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device))
    return batch


def bevformer_tiny():
    """The parity tests' tiny BEVFormer (ResNet-18 at base 8 to C5, an 8 x
    8 BEV of 32 channels, 2 encoder layers, a 2-layer BEVFormerHead of 16
    queries and 2 classes over +-10 m), seeded weights, the samples moved
    off their reference points, the class branches' last weights scaled by
    TINY_CLS_GAIN; on the CPU, in eval mode."""
    import torch

    from paddle3d_tpu_torch.models.backbones import ResNet
    from paddle3d_tpu_torch.models.detection import BEVFormer
    from paddle3d_tpu_torch.models.heads import BEVFormerHead
    pc = [-10., -10., -3., 10., 10., 3.]
    gen = torch.Generator().manual_seed(SEED)
    head = BEVFormerHead(with_box_refine=True, num_classes=2, in_channels=32,
                         embed_dims=32, num_query=16, num_heads=4,
                         num_layers=2, depth_num=4, pc_range=pc,
                         position_range=pc, generator=gen)
    model = BEVFormer(ResNet(depth=18, base_channels=8, out_indices=(3,),
                             generator=gen), None, head, bev_h=8, bev_w=8,
                      embed_dims=32, num_heads=4, encoder_layers=2,
                      pc_range=pc, generator=gen)
    move_samples(model, gen)
    with torch.no_grad():
        for branch in head.cls_branches:
            branch.layers[2].weight.mul_(TINY_CLS_GAIN)
    return model.eval()


def tiny_card_vs_cpu(label, model, frames, tol, carry,
                     labels="label_preds"):
    """frames (CPU batches, each later one taking carry(the one before's
    outputs) as prev_bev) through model on the CPU, then on the card:
    the output `labels` equal (none compared when None), every key of tol
    within tol of its largest value (the last frame's). -> (errors, the
    card's launches over the frames)."""
    import torch

    from paddle3d_tpu_torch.ops import _build

    def run(on_card):
        out = None
        for f in frames:
            batch = {k: v.cuda() if on_card else v for k, v in f.items()}
            if out is not None:
                batch["prev_bev"] = carry(out)
            out = model.test_forward(batch)
        return out
    with torch.no_grad():
        ref = run(False)
        model.cuda()
        _build.reset_launches()
        got = run(True)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        model.cpu()
    check(labels is None or torch.equal(got[labels].cpu(), ref[labels]),
          "tiny {} labels differ between the card and the CPU".format(label))
    errs = {k: ((got[k].cpu() - ref[k]).abs().max() /
                ref[k].abs().max()).item() for k in tol}
    log("  tiny {}, {} frames, card vs CPU: {}relative errors "
        "{} (tolerances {}); card launches over the frames {}".format(
            label, len(frames), "labels equal; " if labels else "",
            {k: "{:.3e}".format(v) for k, v in errs.items()}, tol,
            launches))
    check(all(errs[k] <= t for k, t in tol.items()),
          "tiny {} outputs differ between the card and the CPU".format(label))
    return errs, launches


def bevformer_sees(model, lidar2imgs):
    """The share of BEV queries whose pillar some camera sees, and the
    cameras seeing a query on average."""
    hit = model.encoder[0].sca.project(model.bev_reference(), lidar2imgs)[1]
    seen = hit.sum(dim=1).float()
    return (seen > 0).float().mean().item(), seen.mean().item()


@contextlib.contextmanager
def timed_calls(fns):
    """Host ms of each call of the given (name, obj, attr) methods, each
    between two synchronizes: -> dict name -> list of ms."""
    import torch
    ms = {name: [] for name, _, _ in fns}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    with contextlib.ExitStack() as stack:
        for name, obj, attr in fns:
            stack.enter_context(mock.patch.object(
                obj, attr, timed(name, getattr(obj, attr))))
        yield ms


def bevformer_stages(model, batch, iters=3):
    """Host ms of test_forward's stages (each ended by a synchronize):
    backbone + FPN (the camera tokens), the encoder (its temporal self-
    and spatial cross-attentions apart: each call between two
    synchronizes), the decoder, predict; averaged over iters after a
    warm-up."""
    import torch
    head = model.head
    stages = [
        ("backbone + FPN", lambda bt: model.camera_tokens(bt["img"])),
        ("encoder", lambda tk: model.encode(
            *tk, batch["lidar2imgs"], batch.get("prev_bev"),
            batch.get("can_bus"))),
        ("decoder", lambda bev: head.decode_over_tokens(bev)),
        ("predict", lambda out: head.predict(*out))]
    fns = [(key, getattr(layer, attr), "forward")
           for layer in model.encoder
           for key, attr in (("TSA", "tsa"), ("SCA", "sca"))]

    def run():
        x, out = batch, []
        for _, fn in stages:
            t0 = time.perf_counter()
            x = fn(x)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out
    with torch.no_grad(), timed_calls(fns) as attn:
        run()
        for v in attn.values():
            v.clear()
        ms = [sum(v) / iters for v in zip(*(run() for _ in range(iters)))]
    parts = {k: sum(v) / iters for k, v in attn.items()}
    times = dict(zip((s for s, _ in stages), ms))
    log("  stages a batch (host clock, synchronised; each attention call "
        "between two synchronizes): {}; of the encoder's {} layers: TSA "
        "{:.3f} ms, SCA {:.3f} ms, the rest {:.3f} ms".format(
            ", ".join("{} {:.3f} ms".format(k, v) for k, v in times.items()),
            len(model.encoder), parts["TSA"], parts["SCA"],
            times["encoder"] - sum(parts.values())))
    return times, parts


def module_flops(model, fn, b, names):
    """GFLOP a frame of fn()'s convolutions and matmuls
    (torch.utils.flop_counter), in all and by module (the counter names a
    module by its class and path: names maps a label to such a key)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    counts = counter.get_flop_counts()
    out = {"total": counter.get_total_flops() / 1e9 / b}
    for label, key in names.items():
        out[label] = sum(counts.get(key, {}).values()) / 1e9 / b
    return out


def frames_per_s(model, batch, iters, ctx=contextlib.nullcontext):
    """Frames/s of iters test_forward calls ended by a synchronize, after
    a warm-up call, all inside ctx()."""
    import torch
    with ctx():
        model.test_forward(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.test_forward(batch)
        torch.cuda.synchronize()
    return batch["img"].shape[0] * iters / (time.perf_counter() - t0)


def bevformer_timing(model, batch, label):
    """Frames/s (two halves of BEVFORMER_ITERS, cudnn.benchmark on), GFLOP
    a frame by module, peak memory, a profile of one forward and the
    stage times."""
    import torch
    half = BEVFORMER_ITERS // 2
    with torch.no_grad():
        rates = [frames_per_s(model, batch, half) for _ in range(2)]
    rate = 2 / sum(1 / r for r in rates)
    b = batch["img"].shape[0]
    flops = module_flops(model, lambda: model.test_forward(batch), b, {
        "backbone": "ResNet", "neck": "FPN",
        "encoder": "BEVFormerEncoderLayer", "encoder TSA":
        "BEVFormerEncoderLayer.tsa", "encoder SCA":
        "BEVFormerEncoderLayer.sca",
        # the decode runs outside the head's forward: its layers are
        # counted under their own class
        "decoder layers": "BaseTransformerLayer"})
    log("  {} batch {}: {} forwards (two halves, cudnn.benchmark on): {:.2f} "
        "frames/s ({:.3f} ms a frame); halves {}; GFLOP a frame "
        "(torch.utils.flop_counter) {}: {:.2f} TFLOP/s at that rate".format(
            label, b, BEVFORMER_ITERS, rate, 1e3 / rate,
            [round(r, 2) for r in rates],
            {k: round(v, 2) for k, v in flops.items()},
            flops["total"] * rate / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    bevformer_stages(model, batch)


def train_rate(step, model, optimizer, batch, iters, label):
    """Train frames/s over iters steps in two halves after a warm-up step
    (cudnn.benchmark on), peak memory and a profile of one step."""
    import torch
    b = batch["img"].shape[0]
    half = iters // 2
    step(model, optimizer, batch)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(half):
            step(model, optimizer, batch)
        torch.cuda.synchronize()
        rates.append(b * half / (time.perf_counter() - t0))
    log("  {}: {} train steps of batch {} (two halves, cudnn.benchmark on): "
        "{:.2f} frames/s; halves {}".format(
            label, 2 * half, b, 2 * half / sum(half / r for r in rates),
            [round(r, 2) for r in rates]))
    torch.cuda.reset_peak_memory_stats()
    step(model, optimizer, batch)
    log("  peak device memory of one train step: {:.1f} MiB".format(
        torch.cuda.max_memory_allocated() / 2**20))
    profile(lambda: step(model, optimizer, batch))


def steps_agree(label, step, model, optimizer, scheduler, batch, keys,
                plain=False, tols=(1e-6, 1e-4, 1e-6)):
    """Two train steps from one saved state, both in torch's deterministic
    mode (warn_only), the second on the plain versions when plain: losses,
    grads and running stats bit-equal (compare_steps at tolerance 0), or
    within tols (losses, grads, running stats, relative) where the mode
    warned of an op with no deterministic form (their backward adds with
    atomics). -> (the two steps' records, the ops the mode warned of)."""
    restore = saved_state(model, optimizer, scheduler)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        with deterministic(warn_only=True):
            first = record_step(step, model, optimizer, batch)
        restore()
        with deterministic(warn_only=True), \
                plain_path() if plain else contextlib.nullcontext():
            second = record_step(step, model, optimizer, batch)
        restore()
    ops = sorted({str(w.message).split(" does not")[0] for w in warned})
    errs = compare_steps(first, second, *(tols if ops else (0., 0., 0.)),
                         keys)
    log("  {}: two train steps from one state in deterministic mode{}: "
        "losses, grads and running stats {} (relative errors {}); ops "
        "without a deterministic form: {}".format(
            label, " (the second on the plain versions)" if plain else "",
            "within {}".format(tols) if ops else "bit-equal",
            ["{:.3e}".format(e) for e in errs], ops))
    return first, second, ops


def phase_bevformer(device):
    """BEVFormer-tiny at full width (ResNet-50 to C5, FPN 2048 -> 256, a 50
    x 50 BEV of 256 channels, 3 encoder layers, 900 queries, 6 decoder
    layers with box refinement; seeded random weights, the samples moved
    off their reference points, f32, TF32 off) on six 450 x 800 images
    padded to 480 x 800 under bevformer_rig: two consecutive frames at
    batch 1 (the second with the first's bev_feature and a can_bus), each
    served twice (equal by bit pattern, no launch counter moves); the tiny
    model card vs CPU over two frames; frames/s, GFLOP, memory, profile,
    stages; training at batch 1 with a one-frame history queue (the
    config's AdamW, clip 35, CosineDecay): two steps from one state
    bit-equal, 10 falling losses, train frames/s, memory, profile, the
    Hungarian matches' host time; the 10 falling losses in deterministic
    mode."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=BEVFORMER, device=device)
    model = cfg.model.eval()
    move_samples(model, torch.Generator().manual_seed(SEED))
    head = model.head
    frames = [bevformer_serve_batch(device, 1),
              bevformer_serve_batch(device, 1, SEED + 1,
                                    motion=BEVFORMER_MOTION)]
    share, per_query = bevformer_sees(model, frames[0]["lidar2imgs"])
    log("phase 18: BEVFormer-tiny (ResNet-50 + FPN, BEV {} x {} x {}, {} "
        "encoder layers, {} queries, {} decoder layers, box refinement {}) "
        "at {} x {} padded to {} x {} under a ring of {} cameras: {:.4f} of "
        "the BEV queries seen by a camera ({:.3f} cameras a query)".format(
            model.bev_h, model.bev_w, model.embed_dims, len(model.encoder),
            head.num_query, head.num_layers, head.with_box_refine,
            *BEVFORMER_IMAGE, *BEVFORMER_HW, PETR_CAMS, share, per_query))
    check(share > 0.5, "SCA: under half of the BEV queries seen")
    outs = []
    with torch.no_grad():
        _build.reset_launches()
        for i, batch in enumerate(frames):
            if outs:
                batch["prev_bev"] = outs[-1]["bev_feature"]
            out, again = (model.test_forward(batch) for _ in range(2))
            torch.cuda.synchronize()
            differ = [k for k in out if not same_bits(out[k], again[k])]
            check(not differ, "BEVFormer frame {}: two calls differ in {}"
                  .format(i + 1, differ))
            check_petr_outputs(out, 1, min(300, head.num_query *
                                           head.num_classes),
                               head.code_size, head.num_classes)
            outs.append(out)
        torch.cuda.synchronize()
        check(not any(_build.LAUNCHES.values()), "BEVFormer launched {}: it "
              "reaches no hand-written kernel".format(
                  {k: v for k, v in _build.LAUNCHES.items() if v}))
    moved = (outs[1]["bev_feature"] - outs[0]["bev_feature"]).abs().max()
    log("  serving two frames at batch 1 (the second with prev_bev and a "
        "can_bus of dx {}, dy {} m, yaw {} and delta {} rad): no kernel "
        "launch; two calls equal by bit pattern; top scores {}; BEVs differ "
        "by up to {:.4f}".format(*BEVFORMER_MOTION, [round(
            o["scores"][0, 0].item(), 4) for o in outs], moved.item()))
    tiny = bevformer_tiny()
    tiny_frames = [bevformer_serve_batch("cpu", 2, hw=(64, 64),
                                         image=(60, 64), n=2)]
    tiny_frames.append(bevformer_serve_batch("cpu", 2, SEED + 1, hw=(64, 64),
                                             image=(60, 64), n=2,
                                             motion=BEVFORMER_MOTION))
    _, tiny_launches = tiny_card_vs_cpu("BEVFormer", tiny, tiny_frames,
                                        BEVFORMER_TINY_TOL,
                                        lambda out: out["bev_feature"])
    check(not tiny_launches, "the tiny BEVFormer launched a kernel")
    del tiny
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    bevformer_timing(model, frames[1], "BEVFormer-tiny, the second frame")
    del frames, outs

    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch = bevformer_train_batch(device, model, 1)
    steps_agree("BEVFormer", step, model, optimizer, scheduler, batch,
                ("loss", "loss_cls", "loss_bbox"))
    _build.reset_launches()
    # the ten falling steps' path starts from this step's state
    with hungarian_clock() as hung, fixed_path():
        losses = step(model, optimizer, batch)
        torch.cuda.synchronize()
    log("  training at batch 1 ({}, clip {}, {}; a one-frame history queue, "
        "{} boxes in range and in view, 2 padded slots): first step losses "
        "{}; launches {}; {} Hungarian matches ({} scipy solves)".format(
            cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], PETR_OBJECTS,
            {k: round(v.item(), 5) for k, v in losses.items()},
            {k: v for k, v in _build.LAUNCHES.items() if v},
            len(hung["match"]), len(hung["solve"])))
    check(not any(_build.LAUNCHES.values()), "the BEVFormer train step "
          "launched a kernel")
    check(len(hung["match"]) == head.num_layers, "expected one host match "
          "a decoder layer")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch, fixed=True)
    with hungarian_clock() as hung:
        train_rate(step, model, optimizer, batch, BEVFORMER_TRAIN_ITERS,
                   "BEVFormer-tiny")
    steps = BEVFORMER_TRAIN_ITERS + 3
    log("  Hungarian host ms a step: matches (copy to the host, waiting for "
        "the forward, then the solves) {:.3f}, scipy solves alone {:.3f}"
        .format(sum(hung["match"]) / steps, sum(hung["solve"]) / steps))


def bevdet_serve_batch(device, b, seed=SEED, hw=None, n=PETR_CAMS):
    """b frames of n normalised uniform-pixel h x w images (BEVDET_HW by
    default) with bevdet_rig's matrices."""
    import numpy as np
    import torch
    hw = hw or BEVDET_HW
    rng = np.random.default_rng(seed)
    batch = {"img": normalised_images(rng, (b, n) + tuple(hw) + (3,),
                                      BEVDET_MEAN, BEVDET_STD)}
    batch.update(bevdet_rig(hw, n, b))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def bevdet_train_batch(device, model, b, seed=SEED):
    """bevdet_serve_batch with an adjacent frame (its own images, the
    cameras 0.5 m behind: img_adj, rots_adj, trans_adj) and petr_gt's
    boxes (BEVDET_OBJECTS a frame) in the ring's view."""
    import numpy as np
    import torch
    batch = bevdet_serve_batch(device, b, seed)
    adj = bevdet_serve_batch(device, b, seed + 2)
    back = torch.tensor([-0.5, 0.0, 0.0], device=device)
    batch.update(img_adj=adj["img"], rots_adj=adj["rots"],
                 trans_adj=adj["trans"] + back)
    boxes, labels = petr_gt(np.random.default_rng(seed + 1), b,
                            (450, 800), sum(model.bbox_head.num_classes),
                            objects=BEVDET_OBJECTS)
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device))
    return batch


def bevdet_frustum_stats(vt, batch):
    """The first frame's frustum: rows, the share in the grid, BEV cells
    hit, the most rows of a cell."""
    import torch
    mats = {k: batch[k][:1] for k in ("rots", "trans", "cam2imgs",
                                      "post_rots", "post_trans", "bda")}
    rank, valid = vt.frustum_ranks(**mats)
    counts = torch.bincount(rank[valid].long())
    return {"rows": valid.numel(), "in_grid": int(valid.sum()),
            "share": valid.float().mean().item(),
            "cells": int((counts > 0).sum()), "longest": int(counts.max())}


def check_bevdet_outputs(out, b, k, classes, code):
    """CenterHead's fixed-shape outputs: finite, -1 padded."""
    import torch
    boxes, scores, labels = (out["box3d_lidar"], out["scores"],
                             out["label_preds"])
    check(tuple(boxes.shape) == (b, k, code) and tuple(scores.shape) ==
          tuple(labels.shape) == (b, k), "BEVDet4D output shapes")
    check(bool(torch.isfinite(boxes).all() & torch.isfinite(scores).all()),
          "non-finite BEVDet4D outputs")
    kept = scores >= 0
    check(bool((labels[kept] >= 0).all() & (labels[kept] < classes).all() &
               (labels[~kept] == -1).all()), "BEVDet4D labels outside the "
          "padding convention")
    return kept.sum(dim=1).tolist()


def bevdet_stages(model, batch, iters=3):
    """Host ms of test_forward's stages (each ended by a synchronize): the
    backbone, the depth net, the lift (the frustum's ranks, the sort of the
    scalar payloads, the row rebuild), the pool (K7), the BEV encoder +
    neck (the previous BEV concatenated), the head convs, decode + NMS."""
    from paddle3d_tpu_torch.ops import scatter, sorted_scatter
    vt = model.img_view_transformer
    gx, gy, _ = vt.grid_size
    cells = gx * gy
    mats = {k: batch[k] for k in ("rots", "trans", "cam2imgs", "post_rots",
                                  "post_trans", "bda")}

    def sort(x):
        tab, pix, dep, rank, valid = x
        return (tab,) + scatter.sort_payloads(pix, dep, rank, valid,
                                              tab.dtype)

    def rebuild(x):
        tab, keys, spix, sdep = x
        return keys, scatter.rebuild_rows(tab, spix, sdep)

    def encoder(t):
        bev = t.reshape(t.shape[0], gy, gx, -1)
        bev = model._temporal_bev(bev, batch)
        return model.img_bev_encoder_neck(model.img_bev_encoder_backbone(
            bev.permute(0, 3, 1, 2).contiguous()))

    stage_times([
        ("backbone", lambda bt: model.image_features(bt["img"])),
        ("depth net", vt.depth_and_context),
        ("frustum ranks", lambda x: vt.pool_inputs(*x, **mats)),
        ("sort", sort), ("row rebuild", rebuild),
        ("K7", lambda x: sorted_scatter.scatter_rows(*x, cells, False)),
        ("BEV encoder + neck", encoder),
        ("head convs", model.bbox_head),
        ("decode + NMS", lambda preds: model.bbox_head.predict(
            preds, model.test_cfg))], batch, iters)


def bevdet_timing(model, batch):
    """Frames/s of both paths (kernel/plain/plain/kernel halves of
    BEVDET_ITERS, cudnn.benchmark on), GFLOP a frame by module, peak
    memory, a profile of one forward through the kernels and the stage
    times."""
    import torch
    b = batch["img"].shape[0]
    rates = {"kernels": [], "plain": []}
    with torch.no_grad():
        for order in (("kernels", "plain"), ("plain", "kernels")):
            for path in order:
                rates[path].append(frames_per_s(
                    model, batch, BEVDET_ITERS // 2, plain_path
                    if path == "plain" else contextlib.nullcontext))
    rate = {k: 2 / sum(1 / r for r in v) for k, v in rates.items()}
    flops = module_flops(model, lambda: model.test_forward(batch), b, {
        "backbone": "ResNet", "depth net": "LSSViewTransformer.depth_net",
        "BEV encoder": "CustomResNet", "neck": "FPN_LSS",
        "head": "CenterHead"})
    log("  batch {}: forwards a path (kernel/plain/plain/kernel halves, "
        "cudnn.benchmark on): kernel path {:.2f} frames/s ({:.3f} ms a "
        "frame), plain path {:.2f} frames/s ({:.3f} ms); halves {}; GFLOP a "
        "frame (torch.utils.flop_counter) {}: {:.2f} TFLOP/s at the kernel "
        "path's rate".format(
            b, rate["kernels"], 1e3 / rate["kernels"], rate["plain"],
            1e3 / rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()},
            {k: round(v, 2) for k, v in flops.items()},
            flops["total"] * rate["kernels"] / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    bevdet_stages(model, batch)


def bevdet_tiny():
    """The parity tests' tiny BEVDet4D (ResNet-18 at base 8 to C4 on 64 x
    96 images, 8 depth bins onto a 32 x 32 grid of 16 channels at 0.5 m,
    CustomResNet (32 -> 16, 32) + FPN_LSS, a one-class CenterHead), seeded
    weights, the heatmap tower's last weights scaled by TINY_CLS_GAIN; on
    the CPU, in eval mode."""
    import torch

    from paddle3d_tpu_torch.models.backbones import CustomResNet, ResNet
    from paddle3d_tpu_torch.models.detection import BEVDet, CenterHead
    from paddle3d_tpu_torch.models.necks import FPN_LSS
    from paddle3d_tpu_torch.models.transformers import LSSViewTransformer
    gen = torch.Generator().manual_seed(SEED)
    grid = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
                depth=[1., 9., 1.])
    head = CenterHead(in_channels=16, tasks=[dict(num_class=1,
                                                  class_names=["car"])],
                      weight=0.25, code_weights=[1.] * 8,
                      common_heads=dict(reg=(2, 2), height=(1, 2),
                                        dim=(3, 2), rot=(2, 2)),
                      share_conv_channel=16, generator=gen)
    with torch.no_grad():
        head.task_heads[0].towers["hm"][-1].weight.mul_(TINY_CLS_GAIN)
    model = BEVDet(
        img_backbone=ResNet(depth=18, base_channels=8, out_indices=(2,),
                            generator=gen),
        img_neck=None,
        img_view_transformer=LSSViewTransformer(
            grid, input_size=(64, 96), downsample=16, in_channels=32,
            out_channels=16, generator=gen),
        img_bev_encoder_backbone=CustomResNet(
            32, num_layer=(1, 1), num_channels=(16, 32), stride=(1, 2),
            generator=gen),
        img_bev_encoder_neck=FPN_LSS(16 + 32, 16, generator=gen),
        bbox_head=head,
        test_cfg=dict(nms=dict(nms_pre_max_size=64, nms_post_max_size=8,
                               nms_iou_threshold=0.2),
                      score_threshold=0.05,
                      point_cloud_range=[-8., -8., -3., 8., 8., 3.],
                      down_ratio=1, voxel_size=[0.5, 0.5, 6.0],
                      post_center_limit_range=[-12., -12., -5., 12., 12.,
                                               5.]),
        target_assign_cfg=dict(down_ratio=1, max_objs=8), temporal=True)
    return model.eval()


def phase_bevdet_tiny():
    """The tiny BEVDet4D on the card against the CPU over two frames (the
    second with the first's BEV as prev_bev; its pool, 2 x 384 rows onto 32
    x 32 cells, is dense by the density rule: one K7 a forward, held bit
    for bit against the row-order sum at its call)."""
    from paddle3d_tpu_torch.ops import sorted_scatter
    model = bevdet_tiny()
    frames = [bevdet_serve_batch("cpu", 2, SEED + i, hw=(64, 96), n=2)
              for i in range(2)]
    with recorded(sorted_scatter, "scatter_rows") as calls:
        _, launches = tiny_card_vs_cpu(
            "BEVDet4D", model, frames, BEVDET_TINY_TOL,
            lambda out: out["bev_feature"][..., :16].contiguous())
    check(launches == {"sorted_segment_sum_dense": 2}, "the tiny BEVDet4D "
          "on the card launched {} where one K7 a forward was due".format(
              launches))
    k7_parts("the tiny BEVDet4D's pool", *calls[-1][0], iters=20)


def phase_bevdet(device):
    """BEVDet4D on its nuScenes config at full width (ResNet-50 to C4, 59
    depth bins onto 128 x 128 cells of 64 channels, the previous frame's
    BEV, CustomResNet + FPN_LSS, CenterHead of 10 classes, NMS 1,000 /
    500; seeded random weights, f32, TF32 off) on six 256 x 704 images
    under bevdet_rig: serving at batch 1 and 8 with a prev_bev state (from
    a first frame) through the kernels (one K7 a forward, nothing else) and
    on the plain versions, both in deterministic mode (every output equal
    by bit pattern); K7 at both pools bit for bit against the row-order
    sum and a second call, timed beside index_add_call and its bound; the
    tiny model card (K7) vs CPU; frames/s of both paths, GFLOP, memory,
    profiles, stages; training at batch 8 with an adjacent frame (the
    config's AdamW, clip 5, CosineDecay): one step through the kernels (K7
    twice, the adjacent frame's pool without gradient, and one K5) against
    one on the plain versions from the same state, in deterministic mode,
    bit-equal; K5 held and timed at the step's VJP (its falling losses and
    train frames/s: phase 30's Trainer run). -> the record's entries of K7
    and K5 at BEVDet4D's calls."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=BEVDET, device=device)
    model = cfg.model.eval()
    vt = model.img_view_transformer
    gx, gy, _ = vt.grid_size
    c = vt.out_channels
    classes = sum(model.bbox_head.num_classes)
    post = model.test_cfg["nms"]["nms_post_max_size"]
    batches = {b: bevdet_serve_batch(device, b) for b in (1, BEVDET_BATCH)}
    stats = bevdet_frustum_stats(vt, batches[1])
    log("phase 19: BEVDet4D (ResNet-50 to C4, {} depth bins, BEV {} x {} x "
        "{} and the previous frame's, {} classes) at {} x {} under a ring of "
        "{} cameras: a frame's frustum has {} rows, {} in the grid (share "
        "{:.4f}) on {} cells, at most {} rows a cell".format(
            vt.D, gy, gx, c, classes, *BEVDET_HW, PETR_CAMS, stats["rows"],
            stats["in_grid"], stats["share"], stats["cells"],
            stats["longest"]))
    check(stats["share"] > 0.3, "under 0.3 of the frustum is in the grid")
    with torch.no_grad():
        for batch in batches.values():      # a first frame: the state
            first = model.test_forward(batch)
            batch["prev_bev"] = first["bev_feature"][..., :c].contiguous()
    outs, launches = {}, {}
    with torch.no_grad(), recorded(sorted_scatter, "scatter_rows") as calls, \
            deterministic(warn_only=True):
        for b, batch in batches.items():
            _build.reset_launches()
            outs[b] = model.test_forward(batch)
            torch.cuda.synchronize()
            launches[b] = dict(_build.LAUNCHES)
    kept = {b: check_bevdet_outputs(out, b, post, classes, 9)
            for b, out in outs.items()}
    log("  serving with a prev_bev state through the kernels: launches by "
        "batch {}; boxes kept a frame {}".format(
            {b: {k: v for k, v in n.items() if v}
             for b, n in launches.items()}, kept))
    check(all(n["sorted_segment_sum_dense"] == 1 and sum(n.values()) == 1
              for n in launches.values()), "the BEVDet4D forwards launched "
          "{} where one K7 a forward was due".format(launches))
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            with deterministic(warn_only=True), plain_path():
                ref = model.test_forward(batch)
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "the plain path launched a kernel")
            differ = [k for k in ref if not same_bits(outs[b][k], ref[k])]
            check(not differ, "BEVDet4D batch {}: the kernel and plain paths "
                  "differ in {}".format(b, differ))
    log("  batch {} vs the plain path (its index_add_ in row order: "
        "deterministic mode): every output equal by bit pattern".format(
            list(batches)))
    del outs, ref
    k7 = {}
    for b, ((keys, rows, cells, split), _) in zip(batches, calls):
        k7[b] = k7_parts("BEVDet4D's pool at batch {}".format(b), keys, rows,
                         cells, split, iters=20)
    keys, rows, cells, _ = calls[-1][0]
    k7_bytes = scatter_bytes(keys, cells, rows.shape[-1],
                             keys.shape[0] * cells * rows.shape[-1])
    k7_plain = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys, rows, cells, False), 5)
    log("  K7 at BEVDet4D's pool at batch {}, plain version: {:.4f} ms"
        .format(BEVDET_BATCH, k7_plain))
    del calls, keys, rows
    phase_bevdet_tiny()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for batch in batches.values():
        bevdet_timing(model, batch)
    del batches

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch = bevdet_train_batch(device, model, BEVDET_BATCH)
    with recorded(sorted_scatter, "scatter_rows") as fwd, \
            recorded(sorted_scatter, "sorted_table_gather") as bwd, \
            recorded(model, "_camera_bev") as bevs:
        kernel, plain, ops = steps_agree(
            "BEVDet4D at batch {} (an adjacent frame)".format(BEVDET_BATCH),
            step, model, optimizer, scheduler, batch, BEVDET_LOSSES,
            plain=True)
    log("  training at batch {} ({}, clip {}, {}; an adjacent frame, {} "
        "boxes a frame in view, 2 padded slots): kernel step losses {}; "
        "launches {}; plain step launches {}".format(
            BEVDET_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], BEVDET_OBJECTS,
            {k: round(v, 5) for k, v in kernel[0].items()},
            {k: v for k, v in kernel[3].items() if v},
            {k: v for k, v in plain[3].items() if v}))
    # the current frame's pool and the adjacent frame's (no gradient): two
    # K7; the current frame's VJP: one K5
    check(kernel[3]["sorted_segment_sum_dense"] == 2 and
          kernel[3]["sorted_table_gather"] == 1 and
          sum(kernel[3].values()) == 3, "the BEVDet4D train step launched "
          "{} where two K7 and one K5 were due".format(kernel[3]))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    check(len(fwd) == 2 and len(bwd) == 1 and len(bevs) == 4, "expected two "
          "pools and one VJP in the kernel step")
    # the current and the adjacent frame's pooled BEVs: K7 against the plain
    # step's row-order index_add_ (deterministic mode)
    same = [same_bits(bevs[i][1][0], bevs[i + 2][1][0]) for i in range(2)]
    log("  the train step's pooled BEVs (current, adjacent frame), kernel "
        "step vs plain step: {}".format(
            ["bit-equal" if e else "differ" for e in same]))
    check(all(same), "the train step's pools (K7) differ from the plain "
          "step's row-order index_add_")
    del bevs
    k5 = k5_parts("BEVDet4D's train backward", *bwd[0][0])
    k5_launches = kernel[3]["sorted_table_gather"]
    k7_train = kernel[3]["sorted_segment_sum_dense"]
    # its falling losses, train frames/s, memory and profile: phase 30's
    # Trainer run of the config
    del fwd, bwd, kernel, plain
    del model, step, batch, cfg, optimizer, scheduler

    p7, k7_err = k7[BEVDET_BATCH]
    k5_ms, k5_err, k5_bound = k5

    def entry(name, path, launches, err, ms, plain_ms, library_ms, bnd):
        src, tpu, _ = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, "path": path}
    log("  K7 launches: one a serving forward; {} a train step (the "
        "adjacent frame's pool too)".format(k7_train))
    return [entry("sorted_segment_sum_dense", "BEVDet4D serving, batch {}"
                  .format(BEVDET_BATCH),
                  launches[BEVDET_BATCH]["sorted_segment_sum_dense"], k7_err,
                  p7["wrapper"], k7_plain, p7["index_add_call"],
                  bound(k7_bytes)),
            entry("sorted_table_gather", "BEVDet4D training, batch {}".format(
                BEVDET_BATCH), k5_launches, k5_err, k5_ms["wrapper"],
                  k5_ms["plain"], k5_ms["torch.gather"], k5_bound)]


# Phase 20: CAPE and CAPE-T (PETR's model with the camera-view position
# embeddings: every camera decoded in its own frame, fused by visibility;
# CAPE-T's two frames as two fused query streams), bench.py's "cape" key,
# on petr_rig's cameras with the lidar2cams that agree with them
# (cape_rig). CAPE reaches no hand-written kernel.
CAPE = os.path.join(REPO, "configs", "cape", "cape_r50_1408x512.yml")
CAPE_T = os.path.join(REPO, "configs", "cape", "cape_t_r50_704x256.yml")
CAPE_T_V99 = os.path.join(REPO, "configs", "cape", "cape_t_v99_800x320.yml")
CAPE_HW = (512, 1408)
CAPE_T_HW = (256, 704)
CAPE_V99_HW = (320, 800)
CAPE_BATCH = 2          # the configs' batch_size; bench.py serves batch 1
CAPE_MEAN, CAPE_STD = (103.530, 116.280, 123.675), (57.375, 57.120, 58.395)
# the tiny CAPE-T (petr_synthetic_tiny.yml with a CAPE-T head) on the card
# against the CPU, relative to the largest value: cuDNN and cuBLAS against
# the CPU's convolutions and matmuls, as PETR_TINY_TOL
CAPE_TINY_TOL = {"scores": 1e-5, "box3d_lidar": 1e-5}
CAPE_LOSSES = ("loss", "loss_cls", "loss_bbox", "loss_cls_dn",
               "loss_bbox_dn", "loss_cls_prev", "loss_bbox_prev")


def cape_serve_batch(device, b, hw, frames=1, seed=SEED, n=PETR_CAMS):
    """b frames of n normalised uniform-pixel h x w images (frames x n for
    CAPE-T) with cape_rig's img2lidars and lidar2cams."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    i2l, l2c = cape_rig(hw, n, frames)
    views = frames * n
    batch = {"img": normalised_images(rng, (b, views) + tuple(hw) + (3,),
                                      CAPE_MEAN, CAPE_STD),
             "img2lidars": np.broadcast_to(i2l, (b, views, 4, 4)).copy(),
             "lidar2cams": np.broadcast_to(l2c, (b, views, 4, 4)).copy()}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def cape_train_batch(device, model, b, hw, frames, seed=SEED):
    """cape_serve_batch with petr_gt's boxes (in range and in view)."""
    import numpy as np
    import torch
    batch = cape_serve_batch(device, b, hw, frames, seed)
    boxes, labels = petr_gt(np.random.default_rng(seed + 1), b, hw,
                            model.head.num_classes)
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device))
    return batch


def cape_visible(model, batch):
    """The share of (matching query, camera) pairs whose camera sees the
    query's reference point (camera z above 0.1) in the first frame, and
    the queries no camera sees."""
    import torch
    head = model.head
    l2c = batch["lidar2cams"][:1]
    n = l2c.shape[1] // (2 if head.with_time else 1)
    feats = torch.zeros((1, n, head.input_proj.in_channels, 1, 1),
                        device=l2c.device)
    with torch.no_grad():
        vis = head._camera_frame_inputs(feats, batch["img2lidars"][:1, :n],
                                        l2c[:, :n], None)[3]
    return vis.mean().item(), (vis.sum(dim=1) == 0).float().mean().item()


def cape_stages(model, batch, iters=3):
    """Host ms of CAPE's test_forward stages (each ended by a
    synchronize): backbone + neck, the camera-frame inputs (tokens, key and
    query position embeddings, visibility), the decoder (its
    self-attention and its per-camera cross-attention apart: each call
    between two synchronizes; the rest is the FFN, norms and fusion), the
    branches and decode."""
    import torch
    head = model.head
    attn = {"self-attention": [], "cross-attention": []}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            attn[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    n = batch["img"].shape[1]
    half = n // 2

    def decoder(x):
        tokens, key_pos, q_pos_cam, visible, q_pos_global, ref = x
        if not head.with_time:
            return head._decode_layers(tokens, key_pos, q_pos_cam, visible,
                                       q_pos_global, None), ref

        def split_cat(t):
            return torch.cat([t[:, :half], t[:, half:]], dim=0)
        l2c = batch["lidar2cams"]
        ego = torch.matmul(torch.linalg.inv(l2c[:, 0]),
                           l2c[:, half])[:, :3, :3]
        return head._decode_layers(
            split_cat(tokens), split_cat(key_pos), split_cat(q_pos_cam),
            split_cat(visible), torch.cat([q_pos_global] * 2), None,
            fusion_ego=ego)[:, :tokens.shape[0]], ref

    stages = [
        ("backbone + neck", lambda bt: model._extract_feats(bt["img"])),
        ("camera-frame inputs", lambda f: head._camera_frame_inputs(
            f, batch["img2lidars"], batch["lidar2cams"], None)),
        ("decoder", decoder),
        ("branches + decode", lambda x: head.predict(
            *head._branches(*x)))]
    patches = [mock.patch.object(layer.attns[i].attn, "forward",
                                 timed(key, layer.attns[i].attn.forward))
               for layer in head.decoder.layers
               for i, key in ((0, "self-attention"),
                              (1, "cross-attention"))]

    def run():
        x, out = batch, []
        for _, fn in stages:
            t0 = time.perf_counter()
            x = fn(x)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad(), contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        run()
        for v in attn.values():
            v.clear()
        ms = [sum(v) / iters for v in zip(*(run() for _ in range(iters)))]
    parts = {k: sum(v) / iters for k, v in attn.items()}
    times = dict(zip((s for s, _ in stages), ms))
    log("  stages a batch (host clock, synchronised; each attention call "
        "between two synchronizes): {}; of the decoder: self-attention "
        "{:.3f} ms, per-camera cross-attention (the cameras one call) "
        "{:.3f} ms, FFN, norms{} and the rest {:.3f} ms".format(
            ", ".join("{} {:.3f} ms".format(k, v) for k, v in times.items()),
            parts["self-attention"], parts["cross-attention"],
            ", fusion" if head.with_time else "",
            times["decoder"] - sum(parts.values())))
    return times, parts


def cape_tiny_yml(tmp):
    """The tiny PETR config with a CAPE-T head (two fused streams, the
    previous stream's aux loss, version 2 from the head), written to tmp."""
    import yaml
    path = os.path.join(tmp, "cape_t_tiny.yml")
    with open(path, "w") as f:
        yaml.safe_dump({"_base_": PETR_TINY,
                        "model": {"version": None,
                                  "head": {"type": "CAPEHead",
                                           "with_time": True,
                                           "with_prev_aux_loss": True}}}, f)
    return path


def phase_cape_tiny():
    """The tiny CAPE-T's test_forward on the card against the CPU (two
    frames of two cameras at 32 x 48), its class branch's last weight
    scaled by PETR_CLS_GAIN: no launch, labels equal, scores and boxes
    within CAPE_TINY_TOL of the largest value."""
    import tempfile

    import torch

    from paddle3d_tpu_torch.apis import Config
    with tempfile.TemporaryDirectory() as tmp:
        model = Config(path=cape_tiny_yml(tmp), device="cpu").model.eval()
    with torch.no_grad():
        model.head.cls_branch.layers[2].weight.mul_(PETR_CLS_GAIN)
    batch = cape_serve_batch("cpu", 2, (32, 48), frames=2, n=2)
    errs, launches = tiny_card_vs_cpu("CAPE-T", model, [batch],
                                      CAPE_TINY_TOL, None)
    check(not launches, "the tiny CAPE-T launched a kernel")
    return errs


def cape_steps(model, base_step):
    """The train step with the DN noise drawn anew from SEED each call, so
    that two steps from one state see the same noisy queries."""
    def step(m, optimizer, batch):
        model.dn_generator.manual_seed(SEED)
        return base_step(m, optimizer, batch)
    return step


def phase_cape(device):
    """CAPE (ResNet-50 to C4 / C5, CPFPN 1024 / 2048 -> 256, 900 queries, 6
    layers decoded per camera in its frame, 64 LID bins; seeded random
    weights, f32, TF32 off) on six 512 x 1408 images under cape_rig:
    serving at batch 1 and 2 (two calls bit-equal, no launch), the share
    of visible (query, camera) pairs, frames/s, GFLOP, memory, profile,
    stages; CAPE-T (the same at 256 x 704, two frames of six cameras
    PETR_EGO apart, the streams fused after every layer) serving at batch
    1, and training at batch 2 (DN queries, the previous stream's aux loss;
    the config's AdamW, clip 35, CosineDecay): two steps from one state
    compared in deterministic mode, 10 falling losses in deterministic
    mode, train frames/s,
    memory, profile, the Hungarian solves' host time; the VoVNet-99 CAPE-T
    config serving one batch-1 call; the tiny CAPE-T card vs CPU."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = Config(path=CAPE, device=device).model.eval()
    head = model.head
    batches = {b: cape_serve_batch(device, b, CAPE_HW)
               for b in (1, CAPE_BATCH)}
    share, unseen = cape_visible(model, batches[1])
    log("phase 20: CAPE (ResNet-50 + CPFPN, {} queries, {} layers decoded "
        "per camera, {} LID bins, {} classes) at {} x {} under a ring of {} "
        "cameras: {:.4f} of the (query, camera) pairs visible, {:.4f} of "
        "the queries in no camera".format(
            head.num_query, head.num_layers, head.depth_num,
            head.num_classes, *CAPE_HW, PETR_CAMS, share, unseen))
    check(0.2 < share < 0.8, "the visibility share leaves the per-camera "
          "decode idle or full")
    petr_serve(model, batches, "CAPE")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        for batch in batches.values():
            petr_timing(model, batch, "CAPE", cape_stages)
    del model, batches

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=CAPE_T, device=device)
    model = cfg.model.eval()
    head = model.head
    check(model.version == 2 and head.with_time and head.with_prev_aux_loss
          and model.dn_cfg is not None, "not the CAPE-T config")
    batches = {1: cape_serve_batch(device, 1, CAPE_T_HW, frames=2)}
    share, _ = cape_visible(model, batches[1])
    log("  CAPE-T at {} x {}, two frames {} m apart: {:.4f} of the (query, "
        "camera) pairs visible".format(*CAPE_T_HW, PETR_EGO, share))
    petr_serve(model, batches, "CAPE-T")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        petr_timing(model, batches[1], "CAPE-T", cape_stages)
    del batches

    model.train()
    step = cape_steps(model, make_train_step(lr_scheduler=cfg.lr_scheduler))
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch = cape_train_batch(device, model, CAPE_BATCH, CAPE_T_HW, 2)
    with hungarian_clock() as hung:
        first, _, ops = steps_agree(
            "CAPE-T at batch {} (DN queries, the previous stream's aux "
            "loss)".format(CAPE_BATCH), step, model, optimizer, scheduler,
            batch, CAPE_LOSSES)
    log("  CAPE-T training at batch {} ({}, clip {}, {}): first step losses "
        "{}; launches {}; {} Hungarian matches ({} scipy solves) in the two "
        "steps".format(
            CAPE_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"],
            {k: round(v, 5) for k, v in first[0].items()},
            {k: v for k, v in first[3].items() if v}, len(hung["match"]),
            len(hung["solve"])))
    check(not any(first[3].values()), "the CAPE-T train step launched a "
          "kernel")
    check(len(hung["match"]) == 2 * 2 * head.num_layers and
          len(hung["solve"]) == 2 * 2 * head.num_layers * CAPE_BATCH,
          "expected a host match a decoder layer and stream, a solve a "
          "frame")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch, fixed=True)
    with hungarian_clock() as hung:
        train_rate(step, model, optimizer, batch, PETR_TRAIN_ITERS,
                   "CAPE-T")
    steps = PETR_TRAIN_ITERS + 3        # the warm-up, memory and profile
    log("  CAPE-T Hungarian host ms a step: matches (copy to the host, "
        "waiting for the forward, then the solves) {:.3f}, scipy solves "
        "alone {:.3f}".format(sum(hung["match"]) / steps,
                              sum(hung["solve"]) / steps))
    del model, step, batch, cfg, optimizer, scheduler

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model = Config(path=CAPE_T_V99, device=device).model.eval()
    petr_serve(model, {1: cape_serve_batch(device, 1, CAPE_V99_HW,
                                           frames=2)}, "CAPE-T VoVNet-99")
    del model
    phase_cape_tiny()


# Phase 21: RTEBev (ResNet-50 to C3-C5, FPN to 256 at three levels, the
# multi-scale-depth LSS view transformer of 118 depth bins onto a 128 x 128
# BEV of 80 channels, num_adj earlier frames' BEVs concatenated,
# CustomResNet + FPN_LSS, the hybrid-matching RTEBevHead), bench.py's
# "rtebev_1f" key, on six 256 x 704 images a frame under bevdet_rig.
RTEBEV = os.path.join(REPO, "configs", "rtebev",
                      "rtebev_r50_nuscenes_256x704_msdepth_hybrid_1f.yml")
RTEBEV_4F = os.path.join(REPO, "configs", "rtebev",
                         "rtebev_r50_nuscenes_256x704_msdepth_hybrid_4f.yml")
RTEBEV_BATCH = 4            # the configs' batch_size; bench.py serves 1
RTEBEV_ITERS = 4            # timed forwards per path and batch (halves)
RTEBEV_TRAIN_ITERS = 2      # timed train steps (halves of 1)
RTEBEV_POINTS = 34720       # a nuScenes sweep's LiDAR returns, for gt_depth
RTEBEV_LOSSES = ("loss", "loss_cls", "loss_bbox", "loss_cls_one2many",
                 "loss_bbox_one2many", "loss_depth")
# the tiny RTEBev on the card against the CPU, relative to the largest
# value: cuDNN and cuBLAS against the CPU's convolutions and matmuls (in
# eval mode: the camera BatchNorm normalises by its running stats, so the
# train-mode variance noise of tests/test_torch_rtebev.py does not enter)
RTEBEV_TINY_TOL = {"scores": 1e-5, "box3d_lidar": 1e-5}
SKEW_SPAN = 512             # cells of a K7 block's span, for the skew


def depth_maps(scans, mats, hw, near):
    """A LiDAR depth map a camera, [B, N, H, W] f32 (0: no return): each
    frame's scan [B, M, >= 3] (numpy; non-finite rows dropped) moved into
    each camera (rots / trans: camera -> ego), projected by cam2imgs and
    the image augmentation (post_rots, post_trans), the nearest return
    farther than `near` m a pixel kept."""
    import numpy as np
    m = {k: v.detach().cpu().numpy().astype(np.float64)
         for k, v in mats.items()}
    b, n = m["rots"].shape[:2]
    h, w = hw
    out = np.zeros((b, n, h, w), np.float32)
    for i in range(b):
        p = scans[i, :, :3].astype(np.float64)
        p = p[np.isfinite(p).all(axis=1)]
        for c in range(n):
            cam = (p - m["trans"][i, c]) @ m["rots"][i, c]   # R^T (p - t)
            uvd = cam @ m["cam2imgs"][i, c].T
            d = uvd[:, 2]
            keep = d > near
            uv1 = np.stack([uvd[keep, 0] / d[keep], uvd[keep, 1] / d[keep],
                            np.ones(keep.sum())], axis=1)
            aug = uv1 @ m["post_rots"][i, c].T + m["post_trans"][i, c]
            u = np.floor(aug[:, 0]).astype(np.int64)
            v = np.floor(aug[:, 1]).astype(np.int64)
            inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
            depth = np.full(h * w, np.inf)
            np.minimum.at(depth, v[inside] * w + u[inside], d[keep][inside])
            depth[np.isinf(depth)] = 0.0
            out[i, c] = depth.reshape(h, w)
    return out


def rtebev_gt_depth(mats, hw, seed=SEED, points=RTEBEV_POINTS):
    """RTEBev's gt_depth [B, N, H, W]: depth_maps of a bench.make_scans
    sweep a frame (clustered, over the nuScenes range), returns past 0.1
    m."""
    import numpy as np

    import bench
    b = mats["rots"].shape[0]
    rng = np.random.default_rng(seed)
    scans = bench.make_scans(rng, b, points, [-51.2, -51.2, -5.0],
                             [51.2, 51.2, 3.0], "clustered")
    return depth_maps(scans, mats, hw, 0.1)


def rtebev_train_batch(device, model, b, frames=1, seed=SEED):
    """bevdet_serve_batch with `frames` adjacent frames (their own images,
    the cameras 0.5 m further back a frame: img_adj, rots_adj, trans_adj;
    no frame axis for one), petr_gt's boxes (BEVDET_OBJECTS a frame) and
    rtebev_gt_depth. -> (batch, the share of labelled feature pixels)."""
    import numpy as np
    import torch
    batch = bevdet_serve_batch(device, b, seed)
    adj = [bevdet_serve_batch(device, b, seed + 2 + f)
           for f in range(frames)]
    back = [torch.tensor([-0.5 * (f + 1), 0.0, 0.0], device=device)
            for f in range(frames)]
    img_adj = torch.stack([a["img"] for a in adj], dim=1)
    rots_adj = torch.stack([a["rots"] for a in adj], dim=1)
    trans_adj = torch.stack([a["trans"] + t for a, t in zip(adj, back)],
                            dim=1)
    if frames == 1:
        img_adj, rots_adj, trans_adj = img_adj[:, 0], rots_adj[:, 0], \
            trans_adj[:, 0]
    batch.update(img_adj=img_adj, rots_adj=rots_adj, trans_adj=trans_adj)
    boxes, labels = petr_gt(np.random.default_rng(seed + 1), b, (450, 800),
                            model.bbox_head.num_classes,
                            objects=BEVDET_OBJECTS)
    depth = rtebev_gt_depth({k: batch[k] for k in (
        "rots", "trans", "cam2imgs", "post_rots", "post_trans")},
        BEVDET_HW, seed + 5)
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device),
                 gt_depth=torch.from_numpy(depth).to(device))
    labels = model.img_view_transformer.get_downsampled_gt_depth(
        batch["gt_depth"])
    return batch, (labels.amax(dim=1) > 0).float().mean().item()


def k7_skew(keys, cells, span=SKEW_SPAN):
    """The first frame's in-grid rows a span of `span` cells (a K7 block's
    share): the busiest span's rows over the mean, and the busiest cell's
    rows over the mean of the cells hit."""
    import torch
    k = keys[0].long()
    k = k[(k >= 0) & (k < cells)]
    counts = torch.bincount(k, minlength=cells).float()
    spans = counts[:cells // span * span].reshape(-1, span).sum(dim=1)
    return {"span_max_over_mean": (spans.max() / spans.mean()).item(),
            "span_max_rows": int(spans.max()),
            "cell_max_over_mean": (counts.max() /
                                   counts[counts > 0].mean()).item()}


def check_rtebev_outputs(out, b, k, classes):
    """RTEBev's fixed-shape outputs: finite, scores in (0, 1) (threshold
    0: every top-k score kept), labels in range."""
    import torch
    check(tuple(out["box3d_lidar"].shape) == (b, k, 9) and
          tuple(out["scores"].shape) == tuple(out["label_preds"].shape) ==
          (b, k), "RTEBev output shapes")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite RTEBev outputs")
    labels = out["label_preds"]
    check(bool(((labels >= 0) & (labels < classes)).all() &
               (out["scores"] > 0).all() & (out["scores"] < 1).all()),
          "RTEBev scores / labels out of range")


def rtebev_stages(model, batch, iters=3):
    """Host ms of test_forward's stages (each ended by a synchronize): the
    backbone + FPN, the depth net (the camera terms, the MS depth net, the
    softmax), the frustum ranks, the sort of the scalar payloads, the row
    rebuild, the pool (K7), the BEV encoder + neck (the earlier frames'
    BEVs concatenated), the head's decoder, the decode."""
    from paddle3d_tpu_torch.ops import scatter, sorted_scatter
    vt = model.img_view_transformer
    gx, gy, _ = vt.grid_size
    cells = gx * gy
    mats = {k: batch[k] for k in ("rots", "trans", "cam2imgs", "post_rots",
                                  "post_trans", "bda")}

    def sort(x):
        tab, pix, dep, rank, valid = x
        return (tab,) + scatter.sort_payloads(pix, dep, rank, valid,
                                              tab.dtype)

    def rebuild(x):
        tab, keys, spix, sdep = x
        return keys, scatter.rebuild_rows(tab, spix, sdep)

    def encoder(t):
        bev = model._temporal_bev(t.reshape(t.shape[0], gy, gx, -1), batch)
        x = model.img_bev_encoder_neck(model.img_bev_encoder_backbone(
            bev.permute(0, 3, 1, 2).contiguous()))
        return x[0] if isinstance(x, (tuple, list)) else x

    stage_times([
        ("backbone + FPN", lambda bt: model.image_features(bt["img"])),
        ("depth net", lambda f: vt.depth_and_context(
            f[:3], vt.get_mlp_input(**mats))),
        ("frustum ranks", lambda x: vt.pool_inputs(*x, **mats)),
        ("sort", sort), ("row rebuild", rebuild),
        ("K7", lambda x: sorted_scatter.scatter_rows(*x, cells, False)),
        ("BEV encoder + neck", encoder),
        ("head decoder", lambda f: model.bbox_head(f, training=False)),
        ("decode", lambda out: model.bbox_head.predict(*out))], batch, iters)


def rtebev_timing(model, batch):
    """Frames/s of both paths (kernel/plain/plain/kernel halves of
    RTEBEV_ITERS, cudnn.benchmark on), GFLOP a frame by module, peak
    memory, a profile of one forward through the kernels and the stage
    times."""
    import torch
    b = batch["img"].shape[0]
    rates = {"kernels": [], "plain": []}
    with torch.no_grad():
        for order in (("kernels", "plain"), ("plain", "kernels")):
            for path in order:
                rates[path].append(frames_per_s(
                    model, batch, RTEBEV_ITERS // 2, plain_path
                    if path == "plain" else contextlib.nullcontext))
    rate = {k: 2 / sum(1 / r for r in v) for k, v in rates.items()}
    flops = module_flops(model, lambda: model.test_forward(batch), b, {
        "backbone": "ResNet", "FPN": "FPN",
        "depth net": "MSLSSViewTransformerBEVDepth.depth_net",
        "BEV encoder": "CustomResNet", "neck": "FPN_LSS",
        "head": "RTEBevHead"})
    log("  batch {}: forwards a path (kernel/plain/plain/kernel halves, "
        "cudnn.benchmark on): kernel path {:.2f} frames/s ({:.3f} ms a "
        "frame), plain path {:.2f} frames/s ({:.3f} ms); halves {}; GFLOP a "
        "frame (torch.utils.flop_counter) {}: {:.2f} TFLOP/s at the kernel "
        "path's rate".format(
            b, rate["kernels"], 1e3 / rate["kernels"], rate["plain"],
            1e3 / rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()},
            {k: round(v, 2) for k, v in flops.items()},
            flops["total"] * rate["kernels"] / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    rtebev_stages(model, batch)


def rtebev_tiny():
    """tests/test_torch_rtebev.py's tiny RTEBev (ResNet-18 at base 8 to
    C3-C5 on 64 x 96 images, FPN to 16 at three levels, the MS depth LSS
    of 8 bins onto a 32 x 32 grid of 8 channels, one earlier frame,
    CustomResNet + FPN_LSS, a 32-channel head of 8 + 16 queries), seeded
    weights; on the CPU, in eval mode."""
    import torch

    from paddle3d_tpu_torch.models.backbones import CustomResNet, ResNet
    from paddle3d_tpu_torch.models.detection import RTEBev
    from paddle3d_tpu_torch.models.heads import RTEBevHead
    from paddle3d_tpu_torch.models.necks import FPN, FPN_LSS
    from paddle3d_tpu_torch.models.transformers import \
        MSLSSViewTransformerBEVDepth
    gen = torch.Generator().manual_seed(SEED)
    grid = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
                depth=[1., 9., 1.])
    model = RTEBev(
        img_backbone=ResNet(depth=18, base_channels=8, out_indices=(1, 2, 3),
                            generator=gen),
        img_neck=FPN([16, 32, 64], 16, num_outs=3, generator=gen),
        img_view_transformer=MSLSSViewTransformerBEVDepth(
            grid, input_size=(64, 96), downsample=8, in_channels=16,
            out_channels=8, depthnet_cfg=dict(use_sppf=True), generator=gen),
        img_bev_encoder_backbone=CustomResNet(
            16, num_layer=(1, 1), num_channels=(16, 32), stride=(1, 2),
            generator=gen),
        img_bev_encoder_neck=FPN_LSS(16 + 32, 16, generator=gen),
        pts_bbox_head=RTEBevHead(
            num_classes=3, in_channels=16, embed_dims=32, num_query=24,
            num_queries_one2one=8, k_one2many=2, num_layers=2, num_heads=4,
            feedforward_channels=64, bev_h=32, bev_w=32,
            pc_range=[-8., -8., -3., 8., 8., 3.], generator=gen),
        num_adj=1, use_depth=True, use_ms_depth=True,
        test_cfg=dict(score_threshold=0.0))
    move_samples(model, gen)
    return model.eval()


def phase_rtebev_tiny():
    """The tiny RTEBev on the card against the CPU, an earlier frame's BEV
    fed back (its pool, 2 x 1,536 rows onto 32 x 32 cells, dense by the
    density rule: one K7 a forward, held bit for bit at its call)."""
    import torch

    from paddle3d_tpu_torch.ops import sorted_scatter
    model = rtebev_tiny()
    batch = bevdet_serve_batch("cpu", 2, SEED, hw=(64, 96), n=2)
    first = bevdet_serve_batch("cpu", 2, SEED + 1, hw=(64, 96), n=2)
    with torch.no_grad():
        batch["bev_adj"] = model._frame_bev(
            first["img"], *(first[k] for k in (
                "rots", "trans", "cam2imgs", "post_rots", "post_trans",
                "bda")))[0]
    with recorded(sorted_scatter, "scatter_rows") as calls:
        errs, launches = tiny_card_vs_cpu("RTEBev", model, [batch],
                                          RTEBEV_TINY_TOL, None)
    check(launches == {"sorted_segment_sum_dense": 1}, "the tiny RTEBev on "
          "the card launched {} where one K7 was due".format(launches))
    k7_parts("the tiny RTEBev's pool", *calls[-1][0], iters=20)
    return errs


def rtebev_one_step_4f(device):
    """One train step of the 4-frame config at batch 1 (four adjacent
    frames' images, a gt_depth): five K7 (every frame pooled) and one K5,
    finite losses and grads. -> the launches."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    cfg = Config(path=RTEBEV_4F, device=device)
    model = cfg.model.train()
    batch, fg = rtebev_train_batch(device, model, 1, frames=4)
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = step(model, cfg.optimizer, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    grads = all(bool(torch.isfinite(p.grad).all())
                for p in model.parameters())
    log("  RTEBev 4f train step at batch 1 (four adjacent frames, gt_depth "
        "on {:.4f} of the feature pixels): losses {}; grads finite: {}; "
        "launches {}; {:.3f} s (the first, cold); peak {:.1f} MiB".format(
            fg, {k: round(v.item(), 5) for k, v in losses.items()}, grads,
            launches, sec, torch.cuda.max_memory_allocated() / 2**20))
    check(grads and all(bool(torch.isfinite(v)) for v in losses.values()),
          "RTEBev 4f: non-finite losses or grads")
    check(launches == {"sorted_segment_sum_dense": 5,
                       "sorted_table_gather": 1}, "the RTEBev 4f step "
          "launched {} where five K7 and one K5 were due".format(launches))
    return launches


def phase_rtebev(device):
    """RTEBev on its nuScenes 1f config at full width (ResNet-50 to C3-C5,
    FPN 256 x 3, 118 depth bins onto 128 x 128 cells of 80 channels, the
    previous frame's BEV, CustomResNet + FPN_LSS, 512 + 1,024 queries;
    seeded random weights, the deformable samples moved, f32, TF32 off) on
    six 256 x 704 images under bevdet_rig: serving at batch 1 and 4 with
    bev_adj (the first frame's
    own pooled BEV) through the kernels (one K7 a forward, nothing else)
    and on the plain versions, in deterministic mode (every output equal
    by bit pattern); K7 at both pools bit for bit against the row-order
    sum, timed beside index_add_call and its bound, the skew; the 4f
    config serving at batch 1 with a [1, 4, 128, 128, 80] bev_adj; the
    tiny model card vs CPU; frames/s of both paths, GFLOP, memory,
    profiles, stages; training at batch 4 with an adjacent frame and a
    gt_depth (the config's AdamW, clip 5, CosineDecay): a step through the
    kernels (K7 twice, one K5) against one on the plain versions from the
    same state, in deterministic mode; K5 held and timed at the step's
    VJP; 10 falling losses in deterministic mode, train frames/s, memory,
    profile; one 4f train
    step at batch 1 (five K7). -> the record's entries of K7 and K5 at
    RTEBev's calls."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=RTEBEV, device=device)
    model = cfg.model.eval()
    # the deformable samples moved off their reference points, as a
    # trained model's are
    move_samples(model, torch.Generator().manual_seed(SEED))
    vt = model.img_view_transformer
    head = model.bbox_head
    gx, gy, _ = vt.grid_size
    c = vt.out_channels
    mats_keys = ("rots", "trans", "cam2imgs", "post_rots", "post_trans",
                 "bda")
    batches = {b: bevdet_serve_batch(device, b) for b in (1, RTEBEV_BATCH)}
    stats = bevdet_frustum_stats(vt, batches[1])
    log("phase 21: RTEBev (ResNet-50 + FPN, {} depth bins, BEV {} x {} x "
        "{} and the previous frame's, {} + {} queries, {} classes) at {} x "
        "{} under a ring of {} cameras: a frame's frustum has {} rows, {} in "
        "the grid (share {:.4f}) on {} cells, at most {} rows a cell".format(
            vt.D, gy, gx, c, head.num_queries_one2one,
            head.num_query - head.num_queries_one2one, head.num_classes,
            *BEVDET_HW, PETR_CAMS, stats["rows"], stats["in_grid"],
            stats["share"], stats["cells"], stats["longest"]))
    check(stats["rows"] == 1993728 and stats["share"] > 0.3,
          "not RTEBev's frustum, or under 0.3 of it in the grid")
    with torch.no_grad():
        for b, batch in batches.items():    # frame 1: its own BEV
            first = bevdet_serve_batch(device, b, SEED + 7)
            batch["bev_adj"] = model._frame_bev(
                first["img"], *(first[k] for k in mats_keys))[0]
    outs, launches = {}, {}
    with torch.no_grad(), recorded(sorted_scatter, "scatter_rows") as calls, \
            deterministic(warn_only=True):
        for b, batch in batches.items():
            _build.reset_launches()
            outs[b] = model.test_forward(batch)
            torch.cuda.synchronize()
            launches[b] = dict(_build.LAUNCHES)
    for b, out in outs.items():
        check_rtebev_outputs(out, b, min(300, head.num_queries_one2one *
                                         head.num_classes),
                             head.num_classes)
    log("  serving with bev_adj (frame 1's own pooled BEV) through the "
        "kernels: launches by batch {}; top scores a frame {}".format(
            {b: {k: v for k, v in n.items() if v}
             for b, n in launches.items()},
            {b: [round(v, 4) for v in o["scores"][:, 0].tolist()]
             for b, o in outs.items()}))
    check(all(n["sorted_segment_sum_dense"] == 1 and sum(n.values()) == 1
              for n in launches.values()), "the RTEBev forwards launched "
          "{} where one K7 a forward was due".format(launches))
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            with deterministic(warn_only=True), plain_path():
                ref = model.test_forward(batch)
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "the plain path launched a kernel")
            differ = [k for k in ref if not same_bits(outs[b][k], ref[k])]
            check(not differ, "RTEBev batch {}: the kernel and plain paths "
                  "differ in {}".format(b, differ))
    log("  batch {} vs the plain path (its index_add_ in row order: "
        "deterministic mode): every output equal by bit pattern".format(
            list(batches)))
    del outs, ref
    k7 = {}
    for b, ((keys, rows, cells, split), _) in zip(batches, calls):
        k7[b] = k7_parts("RTEBev's pool at batch {}".format(b), keys, rows,
                         cells, split, iters=20)
    keys, rows, cells, _ = calls[-1][0]
    skew = k7_skew(keys, cells)
    log("  K7 skew at RTEBev's pool (the first frame, {}-cell spans): the "
        "busiest span {} rows, {:.3f} x the mean; the busiest cell {:.1f} x "
        "the mean of the cells hit".format(
            SKEW_SPAN, skew["span_max_rows"], skew["span_max_over_mean"],
            skew["cell_max_over_mean"]))
    k7_bytes = scatter_bytes(keys, cells, rows.shape[-1],
                             keys.shape[0] * cells * rows.shape[-1])
    k7_plain = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys, rows, cells, False), 5)
    log("  K7 at RTEBev's pool at batch {}, plain version: {:.4f} ms"
        .format(RTEBEV_BATCH, k7_plain))
    del calls, keys, rows

    model4 = Config(path=RTEBEV_4F, device=device).model.eval()
    batch4 = bevdet_serve_batch(device, 1)
    with torch.no_grad():
        frames = [model4._frame_bev(*(lambda f: [f["img"]] + [
            f[k] for k in mats_keys])(bevdet_serve_batch(
                device, 1, SEED + 10 + i)))[0] for i in range(4)]
        batch4["bev_adj"] = torch.stack(frames, dim=1)
        _build.reset_launches()
        out4 = model4.test_forward(batch4)
        torch.cuda.synchronize()
    check_rtebev_outputs(out4, 1, min(300, head.num_queries_one2one *
                                      head.num_classes), head.num_classes)
    log("  RTEBev 4f serving at batch 1 with bev_adj {} (four earlier "
        "frames' own BEVs): launches {}; top score {:.4f}".format(
            list(batch4["bev_adj"].shape),
            {k: v for k, v in _build.LAUNCHES.items() if v},
            out4["scores"][0, 0].item()))
    check(dict((k, v) for k, v in _build.LAUNCHES.items() if v) ==
          {"sorted_segment_sum_dense": 1}, "the RTEBev 4f forward did not "
          "launch one K7")
    del model4, batch4, frames, out4
    phase_rtebev_tiny()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for batch in batches.values():
        rtebev_timing(model, batch)
    del batches

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch, fg = rtebev_train_batch(device, model, RTEBEV_BATCH)
    with recorded(sorted_scatter, "scatter_rows") as fwd, \
            recorded(sorted_scatter, "sorted_table_gather") as bwd, \
            recorded(model, "_frame_bev") as bevs, \
            hungarian_clock() as hung:
        kernel, plain, ops = steps_agree(
            "RTEBev at batch {} (an adjacent frame, gt_depth)".format(
                RTEBEV_BATCH), step, model, optimizer, scheduler, batch,
            RTEBEV_LOSSES, plain=True)
    log("  training at batch {} ({}, clip {}, {}; an adjacent frame, {} "
        "boxes a frame in view, 2 padded slots, gt_depth from a {}-point "
        "sweep on {:.4f} of the feature pixels): kernel step losses {}; "
        "launches {}; plain step launches {}; Hungarian host ms a step "
        "{:.3f} ({} matches, {} scipy solves {:.3f} ms)".format(
            RTEBEV_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], BEVDET_OBJECTS, RTEBEV_POINTS,
            fg, {k: round(v, 5) for k, v in kernel[0].items()},
            {k: v for k, v in kernel[3].items() if v},
            {k: v for k, v in plain[3].items() if v},
            sum(hung["match"]) / 2, len(hung["match"]) // 2,
            len(hung["solve"]) // 2, sum(hung["solve"]) / 2))
    check(0.05 < fg < 1.0, "the gt_depth labels no foreground")
    # the current frame's pool and the adjacent frame's (no gradient): two
    # K7; the current frame's VJP: one K5
    check(kernel[3]["sorted_segment_sum_dense"] == 2 and
          kernel[3]["sorted_table_gather"] == 1 and
          sum(kernel[3].values()) == 3, "the RTEBev train step launched "
          "{} where two K7 and one K5 were due".format(kernel[3]))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    check(len(fwd) == 2 and len(bwd) == 1 and len(bevs) == 4, "expected two "
          "pools and one VJP in the kernel step")
    same = [same_bits(bevs[i][1][0], bevs[i + 2][1][0]) for i in range(2)]
    log("  the train step's pooled BEVs (current, adjacent frame), kernel "
        "step vs plain step: {}".format(
            ["bit-equal" if e else "differ" for e in same]))
    check(all(same), "the train step's pools (K7) differ from the plain "
          "step's row-order index_add_")
    del bevs
    k5 = k5_parts("RTEBev's train backward", *bwd[0][0])
    k5_launches = kernel[3]["sorted_table_gather"]
    k7_train = kernel[3]["sorted_segment_sum_dense"]
    del fwd, bwd, kernel, plain
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    falling_losses(step, model, optimizer, batch, fixed=True)
    train_rate(step, model, optimizer, batch, RTEBEV_TRAIN_ITERS, "RTEBev")
    del model, step, batch, cfg, optimizer, scheduler
    rtebev_one_step_4f(device)

    p7, k7_err = k7[RTEBEV_BATCH]
    k5_ms, k5_err, k5_bound = k5

    def entry(name, path, launches, err, ms, plain_ms, library_ms, bnd):
        src, tpu, _ = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, "path": path}
    log("  K7 launches: one a serving forward; {} a train step (the "
        "adjacent frame's pool too)".format(k7_train))
    return [entry("sorted_segment_sum_dense", "RTEBev serving, batch {}"
                  .format(RTEBEV_BATCH),
                  launches[RTEBEV_BATCH]["sorted_segment_sum_dense"], k7_err,
                  p7["wrapper"], k7_plain, p7["index_add_call"],
                  bound(k7_bytes)),
            entry("sorted_table_gather", "RTEBev training, batch {}".format(
                RTEBEV_BATCH), k5_launches, k5_err, k5_ms["wrapper"],
                  k5_ms["plain"], k5_ms["torch.gather"], k5_bound)]


# Phase 22: BEVFusion (pillars + camera), its lidar-only and camera-only
# variants: the [V, P, C] hard voxelization, the buffer PFN and the pillar
# scatter (K2 by the density rule at 30,000 / 40,000 pillars on 400 x 400
# cells), the LSS pool (K7), both VJPs on K5 in training.
BEVF = os.path.join(REPO, "configs", "bevfusion", "bevf_pp_nuscenes.yml")
BEVF_LIDAR = os.path.join(REPO, "configs", "bevfusion",
                          "bevf_lidar_nuscenes.yml")
BEVF_CAM = os.path.join(REPO, "configs", "bevfusion", "bevf_cam_nuscenes.yml")
BEVF_HW = (448, 800)
BEVF_BATCH = 2              # the config's batch_size
BEVF_ITERS = 2              # timed forwards per path and batch (halves)
BEVF_DEPTH_STRIDE = 16      # the L+C train_dataset's depth_stride
BEVF_TINY_TOL = {"scores": 1e-5, "box3d_lidar": 1e-5}


def bevfusion_batch(device, b, seed=SEED, hw=BEVF_HW, n=PETR_CAMS):
    """b nuScenes 10-sweep scans of 250,000 points (make_cp_points) and b
    frames of n normalised uniform-pixel images under bevdet_rig(hw):
    tools/bench_camera.py's ring with its K for 450 x 800 images, which a
    448 x 800 image keeps once its top two rows are cropped (post_trans):
    the matrices are those of the images handed."""
    batch = bevdet_serve_batch(device, b, seed, hw=hw, n=n)
    batch["data"] = make_cp_points(device, batch=b)
    return batch


def bevfusion_img_depth(scans, mats, hw, stride, depth_range):
    """BEVFusion's camera depth target, [B, N, H / s, W / s, 1 + D] f32, as
    paddle3d_tpu/datasets/nuscenes/nuscenes_multi_modality.py:58-94 builds
    it (its math copied): the frame's scan projected into every camera
    (depth_maps: the nearest return a pixel past 1 m, as the dataset's
    _depth_maps keeps them), cut into s x s patches; channel 0 a patch's
    least depth (0 where it holds none), then the differences at the depth
    bins' edges of a normal CDF with the least depth as mean and the
    patch's depth std (1 where it holds one return), both in bin units."""
    import numpy as np
    from scipy.special import erf
    lo, hi, step = depth_range
    full = depth_maps(scans, mats, hw, 1.0)
    b, n, hh, ww = full.shape
    s = stride
    patches = full.reshape(b, n, hh // s, s, ww // s, s).transpose(
        0, 1, 2, 4, 3, 5).reshape(b, n, hh // s, ww // s, s * s)
    valid = patches > 0
    vnum = np.maximum(valid.sum(-1), 1)
    min_depth = np.min(np.where(valid, patches, np.inf), axis=-1)
    min_depth = np.where(np.isfinite(min_depth), min_depth, 0.)
    mean = np.where(valid, patches, 0.).sum(-1) / vnum
    var = np.where(valid, (patches - mean[..., None]) ** 2, 0.).sum(-1) / vnum
    std = np.where(valid.sum(-1) <= 1, 1.0, np.sqrt(var))
    edges = np.arange(lo, hi + 1, step, np.float32)
    mu = (min_depth / step)[..., None]
    sg = np.maximum(std / step, 1e-3)[..., None]
    cdf = 0.5 * (1 + erf((edges / step - mu) / (sg * np.sqrt(2.0))))
    dist = (cdf[..., 1:] - cdf[..., :-1]).astype(np.float32)
    return np.concatenate([min_depth[..., None].astype(np.float32), dist],
                          axis=-1)


def bevfusion_train_batch(device, model, b, seed=SEED):
    """bevfusion_batch with petr_gt's boxes (BEVDET_OBJECTS a frame in the
    ring's view, 2 padded slots) and img_depth from each frame's own scan.
    -> (batch, the share of feature patches whose least depth lies in
    camera_depth_range)."""
    import numpy as np
    import torch
    batch = bevfusion_batch(device, b, seed)
    boxes, labels = petr_gt(np.random.default_rng(seed + 1), b, (450, 800),
                            sum(model.bbox_head.num_classes),
                            objects=BEVDET_OBJECTS)
    lo, hi, step = model.camera_depth_range
    depth = bevfusion_img_depth(
        batch["data"].cpu().numpy(), {k: batch[k] for k in (
            "rots", "trans", "cam2imgs", "post_rots", "post_trans")},
        BEVF_HW, BEVF_DEPTH_STRIDE, (lo, hi, step))
    batch.update(gt_boxes=torch.from_numpy(boxes).to(device),
                 gt_labels=torch.from_numpy(labels).to(device),
                 img_depth=torch.from_numpy(depth).to(device))
    md = depth[..., 0]
    return batch, float(((md >= lo) & (md <= hi)).mean())


def bevfusion_voxels(model, points, training):
    """The voxelizer's pillars a scan and the most points a pillar (of the
    first scan), and the share of slots the buffer fills."""
    vox = model.lidar_voxelizer(points, training)
    n, mask = vox[2], vox[3]
    return {"pillars": mask.sum(dim=1).tolist(), "cap": mask.shape[1],
            "most_points": int(n[0].max()),
            "slots_filled": (n.sum().item() / n.numel() /
                             model.lidar_voxelizer.max_num_points_in_voxel)}


def check_bevfusion_outputs(out, b, k, code=9):
    """CenterHead's fixed-shape outputs (`code`-dof boxes: 9 with
    velocity), finite, -1 padded. -> the boxes kept a frame."""
    import torch
    check(tuple(out["box3d_lidar"].shape) == (b, k, code) and
          tuple(out["scores"].shape) == tuple(out["label_preds"].shape) ==
          (b, k), "BEVFusion output shapes {}".format(
              {key: tuple(v.shape) for key, v in out.items()}))
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite BEVFusion outputs")
    kept = out["scores"] >= 0
    check(bool(((out["label_preds"] >= 0) == kept).all()),
          "BEVFusion labels and scores disagree on the padding")
    return kept.sum(dim=1).tolist()


def bevfusion_stages(model, batch, iters=3):
    """Host ms of the L+C test_forward's stages (each ended by a
    synchronize): the hard voxelization, the buffer PFN, the pillar
    scatter (K2), the lidar backbone + neck, the image backbone, the depth
    net, the frustum ranks, the sort, the row rebuild, the pool (K7), the
    fusion conv + SE, the head convs, decode + NMS."""
    import torch

    from paddle3d_tpu_torch.ops import scatter, sorted_scatter
    vt = model.img_view_transformer
    gx, gy, _ = vt.grid_size
    cells = gx * gy
    mid = model.lidar_middle_encoder
    mats = {k: batch[k] for k in ("rots", "trans", "cam2imgs", "post_rots",
                                  "post_trans", "bda")}
    keep = {}

    def pfn(v):
        feats = model.lidar_voxel_encoder(v[0], v[2], v[1])
        return feats * v[3][..., None].to(feats.dtype), v[1], v[3]

    def scatter_k2(x):
        return scatter.pillar_scatter(*x, mid.ny, mid.nx)

    def lidar_net(canvas):
        x = model.pts_neck(model.pts_backbone(canvas.permute(
            0, 3, 1, 2).contiguous()))
        keep["lidar"] = x
        return batch["img"]

    def sort(x):
        tab, pix, dep, rank, valid = x
        return (tab,) + scatter.sort_payloads(pix, dep, rank, valid,
                                              tab.dtype)

    def rebuild(x):
        tab, keys, spix, sdep = x
        return keys, scatter.rebuild_rows(tab, spix, sdep)

    def fuse(t):
        cam = t.reshape(t.shape[0], gy, gx, -1).permute(0, 3, 1, 2)
        return model.seblock(model.fuse_conv(torch.cat(
            [keep["lidar"], cam], dim=1).contiguous()))

    stage_times([
        ("voxelize", lambda bt: model.lidar_voxelizer(bt["data"], False)),
        ("PFN", pfn), ("pillar scatter (K2)", scatter_k2),
        ("lidar backbone + neck", lidar_net),
        ("image backbone", model.image_features),
        ("depth net", vt.depth_and_context),
        ("frustum ranks", lambda x: vt.pool_inputs(*x, **mats)),
        ("sort", sort), ("row rebuild", rebuild),
        ("pool (K7)", lambda x: sorted_scatter.scatter_rows(*x, cells,
                                                           False)),
        ("fusion conv + SE", fuse), ("head convs", model.bbox_head),
        ("decode + NMS", lambda preds: model.bbox_head.predict(
            preds, model.test_cfg))], batch, iters)


def bevfusion_timing(model, batch):
    """Frames/s of both paths (kernel/plain/plain/kernel halves of
    BEVF_ITERS, cudnn.benchmark on), GFLOP a frame by module, peak memory,
    a profile of one forward through the kernels and the stage times."""
    import torch
    b = batch["img"].shape[0]
    rates = {"kernels": [], "plain": []}
    with torch.no_grad():
        for order in (("kernels", "plain"), ("plain", "kernels")):
            for path in order:
                rates[path].append(frames_per_s(
                    model, batch, BEVF_ITERS // 2, plain_path
                    if path == "plain" else contextlib.nullcontext))
    rate = {k: 2 / sum(1 / r for r in v) for k, v in rates.items()}
    flops = module_flops(model, lambda: model.test_forward(batch), b, {
        "PFN": "PillarFeatureNet", "lidar backbone": "SecondBackbone",
        "lidar neck": "SecondFPN", "image backbone": "ResNet",
        "depth net": "LSSViewTransformer.depth_net",
        "fusion conv": "ConvBNReLU", "head": "CenterHead"})
    log("  batch {}: forwards a path (kernel/plain/plain/kernel halves, "
        "cudnn.benchmark on): kernel path {:.2f} frames/s ({:.3f} ms a "
        "frame), plain path {:.2f} frames/s ({:.3f} ms); halves {}; GFLOP a "
        "frame (torch.utils.flop_counter) {}: {:.2f} TFLOP/s at the kernel "
        "path's rate".format(
            b, rate["kernels"], 1e3 / rate["kernels"], rate["plain"],
            1e3 / rate["plain"],
            {k: [round(x, 2) for x in v] for k, v in rates.items()},
            {k: round(v, 2) for k, v in flops.items()},
            flops["total"] * rate["kernels"] / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    bevfusion_stages(model, batch)


def bevfusion_tiny():
    """The parity tests' tiny L+C BEVFusion (tests/test_torch_bevfusion.py:
    pillars of 0.5 m onto 32 x 32 cells, a cap of 100, a PFN of 16,
    SecondBackbone + SecondFPN, ResNet-18 at base 8 to C4, 8 depth bins
    onto the same grid, SE fusion to 32, a one-class CenterHead), seeded
    weights, the heatmap tower's last weights scaled by TINY_CLS_GAIN; on
    the CPU, in eval mode."""
    import torch

    from paddle3d_tpu_torch.models.backbones import ResNet, SecondBackbone
    from paddle3d_tpu_torch.models.detection import BEVFusion, CenterHead
    from paddle3d_tpu_torch.models.middle_encoders import PointPillarsScatter
    from paddle3d_tpu_torch.models.necks import SecondFPN
    from paddle3d_tpu_torch.models.transformers import LSSViewTransformer
    from paddle3d_tpu_torch.models.voxel_encoders import PillarFeatureNet
    from paddle3d_tpu_torch.models.voxelizers import HardVoxelizer
    gen = torch.Generator().manual_seed(SEED)
    pc, vs = [-8., -8., -3., 8., 8., 3.], [0.5, 0.5, 6.0]
    grid = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
                depth=[1., 9., 1.])
    head = CenterHead(in_channels=32, tasks=[dict(num_class=1,
                                                  class_names=["car"])],
                      weight=0.25, code_weights=[1.] * 8,
                      common_heads=dict(reg=(2, 2), height=(1, 2),
                                        dim=(3, 2), rot=(2, 2)),
                      share_conv_channel=16, generator=gen)
    with torch.no_grad():
        head.task_heads[0].towers["hm"][-1].weight.mul_(TINY_CLS_GAIN)
    model = BEVFusion(
        bbox_head=head, point_cloud_range=pc, voxel_size=vs,
        lidar_voxelizer=HardVoxelizer(vs, pc, 8, 100),
        lidar_voxel_encoder=PillarFeatureNet(
            4, (16,), max_num_points_in_voxel=8, voxel_size=vs,
            point_cloud_range=pc, legacy=False, generator=gen),
        lidar_middle_encoder=PointPillarsScatter(16, vs, pc),
        pts_backbone=SecondBackbone(in_channels=16, out_channels=(16, 32),
                                    layer_nums=(1, 1),
                                    downsample_strides=(1, 2),
                                    generator=gen),
        pts_neck=SecondFPN(in_channels=(16, 32), out_channels=(8, 8),
                           upsample_strides=(1, 2), generator=gen),
        img_backbone=ResNet(depth=18, base_channels=8, out_indices=(2,),
                            generator=gen),
        img_view_transformer=LSSViewTransformer(
            grid, input_size=(64, 96), downsample=16, in_channels=32,
            out_channels=16, generator=gen),
        fusion_channels=32, lidar_channels=16, camera_channels=16, se=True,
        camera_depth_range=[1.0, 9.0, 1.0],
        test_cfg=dict(nms=dict(nms_pre_max_size=64, nms_post_max_size=8,
                               nms_iou_threshold=0.2),
                      score_threshold=0.05, point_cloud_range=pc,
                      down_ratio=1, voxel_size=vs,
                      post_center_limit_range=[-12., -12., -5., 12., 12.,
                                               5.]),
        target_assign_cfg=dict(down_ratio=1, max_objs=8), generator=gen)
    return model.eval()


def bevfusion_tiny_batch(b=2, seed=SEED):
    """The tiny model's CPU batch: 300 points a frame over its range (a
    tenth NaN, a tenth past it), two cameras of 64 x 96 under bevdet_rig."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-8, -8, -3, 0], [8, 8, 3, 1], (b, 300, 4))
    pts[:, ::10] = np.nan
    pts[:, 5::10, 0] = 9.5
    batch = bevdet_serve_batch("cpu", b, seed, hw=(64, 96), n=2)
    batch["data"] = torch.from_numpy(pts.astype(np.float32))
    return batch


def phase_bevfusion_tiny():
    """The tiny L+C BEVFusion on the card against the CPU (the hard
    voxelization's sorts, cumulative max and index writes on both; by the
    density rule its pillar scatter, 100 pillars onto 32 x 32 cells, is
    sparse: one K2; its pool, 2 x 384 rows onto the same cells, dense: one
    K7)."""
    model = bevfusion_tiny()
    _, launches = tiny_card_vs_cpu("BEVFusion", model,
                                   [bevfusion_tiny_batch()], BEVF_TINY_TOL,
                                   None)
    check(launches == {"sorted_segment_sum": 1,
                       "sorted_segment_sum_dense": 1}, "the tiny BEVFusion "
          "on the card launched {} where one K2 and one K7 were due".format(
              launches))


def build_bevfusion(device, path=BEVF):
    """A BEVFusion config (returned: its model and optimizer) at full
    width, seeded random weights, the model in eval mode. The
    plain conv stacks (the lidar backbone and neck, the fusion conv, the
    head) are scaled by sqrt(6), as build_centerpoint scales CenterPoint's
    same stack, so that the head sees the scene and the NMS has work; the
    image backbone, a residual net, keeps its scale (scaled, its sums grow
    block by block until the head's exp overflows)."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    cfg = Config(path=path, device=device)
    model = cfg.model.eval()
    stacks = [model.pts_backbone, model.pts_neck, model.fuse_conv,
              model.bbox_head]
    with torch.no_grad():
        for stack in filter(None, stacks):
            for m in stack.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    m.weight.mul_(6 ** 0.5)
    return cfg


def bevfusion_one_stream(device, path, label, want):
    """One forward at batch 1 of a one-stream config (build_bevfusion):
    outputs finite and -1 padded, `want` the launches."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    model = build_bevfusion(device, path).model
    batch = bevfusion_batch(device, 1, SEED + 3)
    with torch.no_grad():
        _build.reset_launches()
        t0 = time.perf_counter()
        out = model.test_forward(batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    kept = check_bevfusion_outputs(out, 1, out["scores"].shape[1])
    log("  {} at batch 1: launches {}; boxes kept {}; {:.3f} s (the "
        "first forward, cold)".format(label, launches, kept, sec))
    check(launches == want, "{} launched {} where {} was due".format(
        label, launches, want))


def phase_bevfusion(device):
    """BEVFusion on its nuScenes L+C config at full width (pillars of 0.25
    m onto 400 x 400 cells, 64 points a pillar, 30,000 / 40,000 pillars,
    PFN [64, 64] in the [V, P, C] buffer, SecondBackbone + SecondFPN to
    384 channels at 200 x 200; ResNet-50 to C4, 41 depth bins onto 200 x
    200 cells of 80 channels; SE fusion to 384; CenterHead of 6 tasks with
    velocity, NMS 1,000 / 83; seeded random weights, the plain conv
    stacks scaled by build_bevfusion; f32, TF32 off) on make_cp_points'
    nuScenes scans and six 448 x 800 images under bevdet_rig((448, 800)):
    serving at batch 1 and 2 through the kernels (a K2 for the pillar
    scatter, as the density rule picks, and a K7 for the pool, each once a
    forward) and on the plain versions, both in deterministic mode (every
    output equal by bit pattern); K2 and K7 held bit for bit and timed at
    both calls; the lidar-only and camera-only configs at batch 1; the
    tiny model card vs CPU; frames/s of both paths, GFLOP, memory,
    profiles, stages; training at batch 2 with img_depth (the config's
    AdamW, clip 35, CosineDecay): one step through the kernels (K2, K7 and
    two K5) against one on the plain versions from the same state, in
    deterministic mode, bit-equal; K5 held and timed at both VJPs; 10
    falling losses, train frames/s, memory, profile. -> the record's
    entries of K2, K7 and K5 at BEVFusion's calls."""
    import torch

    from paddle3d_tpu_torch.apis import make_train_step
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = build_bevfusion(device)
    model = cfg.model
    vt, mid = model.img_view_transformer, model.lidar_middle_encoder
    gx, gy, _ = vt.grid_size
    post = model.test_cfg["nms"]["nms_post_max_size"]
    k = post * len(model.bbox_head.num_classes)
    batches = {b: bevfusion_batch(device, b) for b in (1, BEVF_BATCH)}
    stats = bevdet_frustum_stats(vt, batches[1])
    vox = bevfusion_voxels(model, batches[BEVF_BATCH]["data"], False)
    log("phase 22: BEVFusion L+C (pillars {} x {}, a [V, P, C] buffer of "
        "{} x {} x {}, PFN [64, 64]; ResNet-50 to C4, {} depth bins onto {} "
        "x {} x {}; SE fusion to {}; {} tasks) on scans of {} points and six "
        "{} x {} images: pillars a scan {} of the cap {} (most points a "
        "pillar {}, buffer slots filled {:.4f}); a frame's frustum has {} "
        "rows, {} in the grid (share {:.4f}) on {} cells, at most {} rows a "
        "cell".format(
            mid.ny, mid.nx, vox["cap"],
            model.lidar_voxelizer.max_num_points_in_voxel, 5, vt.D, gy, gx,
            vt.out_channels, model.fuse_conv.conv.out_channels,
            len(model.bbox_head.num_classes), CP_POINTS, *BEVF_HW,
            vox["pillars"], vox["cap"], vox["most_points"],
            vox["slots_filled"], stats["rows"], stats["in_grid"],
            stats["share"], stats["cells"], stats["longest"]))
    check(stats["rows"] == 6 * 41 * 28 * 50 and stats["share"] > 0.3,
          "not BEVFusion's frustum, or under 0.3 of it in the grid")
    check(sorted_scatter.kernel_for(vox["cap"], mid.ny * mid.nx) ==
          "sorted_segment_sum" and sorted_scatter.kernel_for(
              stats["rows"], gy * gx) == "sorted_segment_sum_dense",
          "the density rule no longer sends the pillar scatter to K2 and "
          "the pool to K7")
    outs, launches = {}, {}
    with torch.no_grad(), recorded(sorted_scatter, "scatter_rows") as calls, \
            deterministic(warn_only=True):
        for b, batch in batches.items():
            _build.reset_launches()
            outs[b] = model.test_forward(batch)
            torch.cuda.synchronize()
            launches[b] = {n: v for n, v in _build.LAUNCHES.items() if v}
    kept = {b: check_bevfusion_outputs(out, b, k) for b, out in outs.items()}
    log("  serving through the kernels: launches by batch {}; boxes kept a "
        "frame {}; top scores {}".format(
            launches, kept, {b: [round(v, 4) for v in o["scores"][:, 0]
                                 .tolist()] for b, o in outs.items()}))
    check(all(n == {"sorted_segment_sum": 1, "sorted_segment_sum_dense": 1}
              for n in launches.values()), "the BEVFusion forwards launched "
          "{} where one K2 and one K7 a forward were due".format(launches))
    with torch.no_grad():
        for b, batch in batches.items():
            _build.reset_launches()
            with deterministic(warn_only=True), plain_path():
                ref = model.test_forward(batch)
            torch.cuda.synchronize()
            check(not any(_build.LAUNCHES.values()),
                  "the plain path launched a kernel")
            differ = [key for key in ref
                      if not same_bits(outs[b][key], ref[key])]
            check(not differ, "BEVFusion batch {}: the kernel and plain "
                  "paths differ in {}".format(b, differ))
    log("  batch {} vs the plain path (its index_add_ in row order: "
        "deterministic mode): every output equal by bit pattern".format(
            list(batches)))
    del outs, ref
    # a forward's calls: the pillar scatter (K2), then the pool (K7)
    check(len(calls) == 4 and [sorted_scatter.kernel_for(
        a[1].shape[1], a[2]) for a, _ in calls] == [
            "sorted_segment_sum", "sorted_segment_sum_dense"] * 2,
        "expected a pillar scatter then a pool a forward")
    k2, k7 = {}, {}
    for i, b in enumerate(batches):
        k2[b] = k2_call("BEVFusion's pillar scatter at batch {}".format(b),
                        *calls[2 * i][0])
        k7[b] = k7_parts("BEVFusion's pool at batch {}".format(b),
                         *calls[2 * i + 1][0], iters=20)
    keys2, rows2, cells2, _ = calls[2][0]
    k2_plain = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys2, rows2, cells2, False), 5)
    keys7, rows7, cells7, _ = calls[3][0]
    k7_bytes = scatter_bytes(keys7, cells7, rows7.shape[-1],
                             keys7.shape[0] * cells7 * rows7.shape[-1])
    k7_plain = cuda_ms(lambda: sorted_scatter.scatter_rows_plain(
        keys7, rows7, cells7, False), 5)
    log("  at batch {}, plain versions: the pillar scatter {:.4f} ms, the "
        "pool {:.4f} ms".format(BEVF_BATCH, k2_plain, k7_plain))
    del calls, keys2, rows2, keys7, rows7
    bevfusion_one_stream(device, BEVF_LIDAR, "BEVFusion lidar-only",
                         {"sorted_segment_sum": 1})
    bevfusion_one_stream(device, BEVF_CAM, "BEVFusion camera-only",
                         {"sorted_segment_sum_dense": 1})
    phase_bevfusion_tiny()

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for batch in batches.values():
        bevfusion_timing(model, batch)
    del batches

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    batch, in_range = bevfusion_train_batch(device, model, BEVF_BATCH)
    keys = ["loss", "img_depth_loss"] + [
        "{}_loss_{}".format(kind, t)
        for t in range(len(model.bbox_head.num_classes))
        for kind in ("hm", "loc")]
    vox = bevfusion_voxels(model, batch["data"], True)
    with recorded(sorted_scatter, "scatter_rows") as fwd, \
            recorded(sorted_scatter, "sorted_table_gather") as bwd:
        kernel, plain, ops = steps_agree(
            "BEVFusion at batch {} (img_depth)".format(BEVF_BATCH), step,
            model, optimizer, scheduler, batch, keys, plain=True)
    log("  training at batch {} ({}, clip {}, {}; {} boxes a frame in view, "
        "2 padded slots; pillars a scan {} of the train cap {}; img_depth "
        "from each frame's scan, {:.4f} of the patches in the depth range): "
        "kernel step losses {}; launches {}; plain step launches {}".format(
            BEVF_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], BEVDET_OBJECTS, vox["pillars"],
            vox["cap"], in_range,
            {key: round(v, 5) for key, v in kernel[0].items()},
            {key: v for key, v in kernel[3].items() if v},
            {key: v for key, v in plain[3].items() if v}))
    check(0.01 < in_range < 1.0, "img_depth has no patch in the depth range")
    # the pillar scatter (K2), the pool (K7) and both VJPs (two K5)
    check({key: v for key, v in kernel[3].items() if v} == {
        "sorted_segment_sum": 1, "sorted_segment_sum_dense": 1,
        "sorted_table_gather": 2}, "the BEVFusion train step launched {} "
        "where K2, K7 and two K5 were due".format(kernel[3]))
    check(not any(plain[3].values()), "the plain step launched a kernel")
    check(len(fwd) == 2 and len(bwd) == 2, "expected two scatters and two "
          "VJPs in the kernel step")
    k2_train = k2_call("BEVFusion's train pillar scatter", *fwd[0][0])
    # the two VJPs told apart by their tables: the pillar canvas's cells
    # and the camera BEV's
    vjp = {"the pillar scatter" if args[3] == mid.ny * mid.nx else
           "the pool": args for args, _ in bwd}
    check(len(vjp) == 2, "the two VJPs' tables are not the canvas and the "
          "camera BEV")
    k5 = {what: k5_parts("BEVFusion's train backward, {}".format(what),
                         *args) for what, args in sorted(vjp.items())}
    # its falling losses, train frames/s, memory and profile: phase 30's
    # Trainer run of the config
    del fwd, bwd, vjp, kernel, plain
    del model, step, batch, cfg, optimizer, scheduler

    def entry(name, path, launches, err, ms, plain_ms, library_ms, bnd):
        src, tpu, _ = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms, "path": path}
    err2, ms2, lib2, b2, by2 = k2[BEVF_BATCH]
    p7, err7 = k7[BEVF_BATCH]
    log("  K2 at the train step's pillar scatter: {:.4f} ms".format(
        k2_train[1]))
    serving = "BEVFusion serving, batch {}".format(BEVF_BATCH)
    return [entry("sorted_segment_sum", serving + ", the pillar scatter",
                  launches[BEVF_BATCH]["sorted_segment_sum"], err2, ms2,
                  k2_plain, lib2, (b2, by2)),
            entry("sorted_segment_sum_dense", serving + ", the LSS pool",
                  launches[BEVF_BATCH]["sorted_segment_sum_dense"], err7,
                  p7["wrapper"], k7_plain, p7["index_add_call"],
                  bound(k7_bytes))] + [
        entry("sorted_table_gather", "BEVFusion training, batch {}, {}'s "
              "VJP".format(BEVF_BATCH, what), 1, err, ms["wrapper"],
              ms["plain"], ms["torch.gather"], bnd)
        for what, (ms, err, bnd) in k5.items()]


# Phase 23: DD3D (DLA-34 or VoVNet-99 + FPN, FCOS-style towers and heads),
# a monocular KITTI detector that reaches no hand-written kernel: its convs
# run on cuDNN, its decode is a stable sort and gathers.
DD3D_DLA = os.path.join(REPO, "configs", "dd3d", "dd3d_dla34_kitti.yml")
DD3D_V99 = os.path.join(REPO, "configs", "dd3d", "dd3d_v2_99_kitti.yml")
DD3D_BATCH = 8              # the configs' batch_size
DD3D_ITERS = 2              # timed forwards per batch (halves of 1)
DD3D_TRAIN_ITERS = 2        # timed train steps (halves of 1)
DD3D_OBJECTS = 8            # synthetic objects an image
# served with seeded random weights, DD3D's class logits sit at the head's
# bias (-2.19), every score under the 0.2 threshold; scaled, as SMOKE's
# class head is (SMOKE_CLS_GAIN), some pass it and the decode keeps them
DD3D_CLS_GAIN = 8.0
# the tiny DD3D on the card against the CPU, relative to the largest
# value: cuDNN's and the CPU's convolutions sum in other orders, which the
# depth's scale (depth_ref 8 m a unit) and the unprojection carry into
# the boxes
DD3D_TINY_TOL = {"scores": 1e-5, "box3d_cam": 1e-4}


def dd3d_serve_batch(device, b, seed=SEED, hw=None):
    """b synthetic images in [0, 255), NHWC, at hw (SMOKE_HW, KITTI's 384 x
    1280, by default), and K_inv of smoke_intrinsics (f = 721.5 px, the
    principal point at the centre)."""
    import numpy as np
    import torch
    h, w = hw or SMOKE_HW
    rng = np.random.default_rng(seed)
    k_inv = np.linalg.inv(smoke_intrinsics(h, w)).astype(np.float32)
    return {"data": torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3))
                                     .astype(np.float32)).to(device),
            "K_inv": torch.from_numpy(np.broadcast_to(
                k_inv, (b, 3, 3)).copy()).to(device)}


def dd3d_gt(rng, b, hw, dim_ref, objects=DD3D_OBJECTS):
    """b frames of `objects` objects each, then two padded slots: classes
    of dim_ref (l, h, w a class, each scaled by 0.9-1.1), 8-45 m in front
    of smoke_intrinsics' camera, a random yaw (KITTI's camera axes: y
    down; y at the box's bottom). The 2-D box is the box's eight corners
    projected and clipped to the image (rejection sampled until it holds
    pixels). -> gt_boxes_2d [b, G, 4], gt_boxes_cam [b, G, 7] (x, y, z and
    the dims in dim_ref's order, ry), gt_labels [b, G] (-1 padded)."""
    import numpy as np
    h, w = hw
    kmat = smoke_intrinsics(h, w).astype(np.float64)
    dim_ref = np.asarray(dim_ref, np.float64)
    g = objects + 2
    box2d = np.zeros((b, g, 4), np.float32)
    box3d = np.zeros((b, g, 7), np.float32)
    labels = np.full((b, g), -1, np.int64)
    for s in range(b):
        j = 0
        while j < objects:
            cls = int(rng.integers(0, len(dim_ref)))
            dims = dim_ref[cls] * rng.uniform(0.9, 1.1, 3)
            ln, ht, wd = dims
            z = rng.uniform(8, 45)
            x, y = rng.uniform(-0.4, 0.4) * z, rng.uniform(1.4, 1.9)
            ry = rng.uniform(-np.pi, np.pi)
            cx, cz = np.array([1, 1, -1, -1]) * ln / 2, \
                np.array([1, -1, -1, 1]) * wd / 2
            c, sn = np.cos(ry), np.sin(ry)
            corners = np.stack([
                np.tile(c * cx + sn * cz, 2) + x,
                np.repeat([y, y - ht], 4),
                np.tile(-sn * cx + c * cz, 2) + z], axis=1)
            if (corners[:, 2] < 1.0).any():
                continue
            uvw = corners @ kmat.T
            u, v = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
            x1, y1 = max(u.min(), 0.), max(v.min(), 0.)
            x2, y2 = min(u.max(), w - 1.), min(v.max(), h - 1.)
            if x2 - x1 < 4 or y2 - y1 < 4:
                continue
            box2d[s, j] = [x1, y1, x2, y2]
            box3d[s, j] = [x, y, z, *dims, ry]
            labels[s, j] = cls
            j += 1
    return box2d, box3d, labels


def dd3d_train_batch(device, cfg_dic, b, seed=SEED, hw=None):
    """dd3d_serve_batch with dd3d_gt's targets for the config's classes."""
    import numpy as np
    import torch
    hw = hw or SMOKE_HW
    batch = dd3d_serve_batch(device, b, seed, hw)
    box2d, box3d, labels = dd3d_gt(np.random.default_rng(seed + 1), b, hw,
                                   cfg_dic["model"]["dim_ref"])
    batch.update(gt_boxes_2d=torch.from_numpy(box2d).to(device),
                 gt_boxes_cam=torch.from_numpy(box3d).to(device),
                 gt_labels=torch.from_numpy(labels).to(device))
    return batch


def check_dd3d_outputs(out, b, k):
    """DD3D's fixed-shape outputs: finite, the labels -1 exactly where the
    scores are. -> the detections kept a frame."""
    import torch
    check(tuple(out["box3d_cam"].shape) == (b, k, 7) and
          tuple(out["scores"].shape) == tuple(out["label_preds"].shape) ==
          (b, k), "DD3D output shapes {}".format(
              {key: tuple(v.shape) for key, v in out.items()}))
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          "non-finite DD3D outputs")
    kept = out["scores"] >= 0
    check(bool(((out["label_preds"] >= 0) == kept).all()),
          "DD3D labels and scores disagree on the padding")
    return kept.sum(dim=1).tolist()


def dd3d_stages(model, batch, iters=3):
    """Host ms of test_forward's stages (each ended by a synchronize): the
    backbone, the FPN, the towers and heads, the decode."""
    stage_times([
        ("backbone", lambda bt: model.backbone(model._images(bt))),
        ("FPN", model.neck), ("towers + heads", model.level_outputs),
        ("decode", lambda outs: model.decode(outs, batch["K_inv"]))],
        batch, iters)


def dd3d_timing(model, batch, label):
    """Frames/s (two halves of DD3D_ITERS, cudnn.benchmark on), GFLOP a
    frame by module, peak memory, a profile of one forward and the stage
    times."""
    import torch
    b = batch["data"].shape[0]
    half = DD3D_ITERS // 2
    with torch.no_grad():
        rates = [frames_per_s(model, {"img": batch["data"], **batch}, half)
                 for _ in range(2)]
    rate = 2 / sum(1 / r for r in rates)
    flops = module_flops(model, lambda: model.test_forward(batch), b, {
        "backbone": type(model.backbone).__name__, "neck": "FPN"})
    log("  {} batch {}: {} forwards (two halves, cudnn.benchmark on): {:.2f} "
        "frames/s ({:.3f} ms a frame); halves {}; GFLOP a frame "
        "(torch.utils.flop_counter) {}: {:.2f} TFLOP/s at that rate".format(
            label, b, DD3D_ITERS, rate, 1e3 / rate,
            [round(r, 2) for r in rates],
            {k: round(v, 2) for k, v in flops.items()},
            flops["total"] * rate / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    dd3d_stages(model, batch)


def dd3d_tiny():
    """The parity tests' tiny DD3D (tests/test_torch_dd3d.py: ResNet-18 at
    base 8 to C3-C5, FPN to 16, a one-conv tower, two classes, 16
    detections a level), seeded weights, the class head's scaled by
    TINY_CLS_GAIN (scores spread apart, so that the top-k order does not
    hang on rounding); on the CPU, in eval mode, every top-k kept."""
    import torch

    from paddle3d_tpu_torch.models.backbones import ResNet
    from paddle3d_tpu_torch.models.detection import DD3D
    from paddle3d_tpu_torch.models.necks import FPN
    gen = torch.Generator().manual_seed(SEED)
    model = DD3D(ResNet(depth=18, base_channels=8, out_indices=(1, 2, 3),
                       generator=gen),
                FPN(in_channels=[16, 32, 64], out_channels=16,
                    generator=gen),
                num_classes=2, in_channels=16, feat_channels=16,
                num_convs=1, strides=(8, 16, 32),
                size_ranges=((0, 32), (32, 64), (64, 1e8)),
                depth_ref=(15., 8.),
                dim_ref=((3.88, 1.63, 1.53), (0.8, 1.7, 0.7)),
                max_detection=16, score_threshold=0.0, generator=gen)
    with torch.no_grad():
        model.cls_head.weight.mul_(TINY_CLS_GAIN)
    return model.eval()


def phase_dd3d_tiny():
    """The tiny DD3D's test_forward on the card against the CPU (no
    launch: DD3D reaches no hand-written kernel)."""
    _, launches = tiny_card_vs_cpu(
        "DD3D", dd3d_tiny(), [dd3d_serve_batch("cpu", 2, hw=(64, 96))],
        DD3D_TINY_TOL, None)
    check(not launches, "the tiny DD3D launched {}".format(launches))


def dd3d_serve(device, path, label):
    """One config at full width, seeded random weights (the class head's
    scaled by DD3D_CLS_GAIN), eval: test_forward at batch 1 and
    DD3D_BATCH, a full top-k a level, finite outputs, no launch counter
    moving. -> the model."""
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops import _build
    model = Config(path=path, device=device).model.eval()
    with torch.no_grad():
        model.cls_head.weight.mul_(DD3D_CLS_GAIN)
    levels = len(model.strides)
    for b in (1, DD3D_BATCH):
        with torch.no_grad():
            _build.reset_launches()
            out = model.test_forward(dd3d_serve_batch(device, b))
            torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        k = out["scores"].shape[1]
        kept = check_dd3d_outputs(out, b, k)
        log("  {} batch {}: {} levels, {} detections a frame; kept (score "
            ">= {}) {}; top scores {}; launches {}".format(
                label, b, levels, k, model.score_threshold, kept,
                [round(v, 4) for v in out["scores"][:, 0].tolist()],
                launches))
        check(k == levels * model.max_detection, "not a full top-k a level")
        check(not launches, "DD3D launched {}".format(launches))
    return model


def phase_dd3d(device):
    """DD3D on both KITTI configs at full width (DLABase34 with batch-stat
    BN at strides 8 / 16 / 32, or VoVNet-99-eSE's stage4 / stage5 with an
    extra conv at strides 16 / 32 / 64; FPN to 256; four GroupNorm convs a
    tower; 3 classes, 100 detections a level; seeded random weights, f32,
    TF32 off) at 384 x 1280 under smoke_intrinsics: serving at batch 1 and
    8 (no launch), frames/s, GFLOP, memory, profiles, stages; the tiny
    model card vs CPU; training the DLA-34 config at batch 8 (its SGD,
    clip 10, OneCycle; dd3d_gt's projected boxes): 10 falling losses,
    train frames/s, memory, profile."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log("phase 23: DD3D at {} x {} (KITTI), no hand-written kernel".format(
        *SMOKE_HW))
    models = {label: dd3d_serve(device, path, label)
              for label, path in (("DD3D DLA-34", DD3D_DLA),
                                  ("DD3D V-99", DD3D_V99))}
    phase_dd3d_tiny()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for label, model in models.items():
        for b in (1, DD3D_BATCH):
            dd3d_timing(model, dd3d_serve_batch(device, b), label)
    del models

    cfg = Config(path=DD3D_DLA, device=device)
    model = cfg.model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    batch = dd3d_train_batch(device, cfg.dic, DD3D_BATCH)
    losses = step(model, cfg.optimizer, batch)
    log("  training DD3D DLA-34 at batch {} ({}, clip {}, {}; {} objects "
        "an image, 2 padded slots): first step losses {}".format(
            DD3D_BATCH, cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"], DD3D_OBJECTS,
            {k: round(v.item(), 5) for k, v in losses.items()}))
    check(all(bool(torch.isfinite(v)) for v in losses.values()) and
          losses["loss_3d"] > 0, "DD3D: non-finite losses or no foreground")
    falling_losses(step, model, cfg.optimizer, batch)
    train_rate(step, model, cfg.optimizer, {"img": batch["data"], **batch},
               DD3D_TRAIN_ITERS, "DD3D DLA-34")


# Phases 24-26: SqueezeSegV3 (range-image segmentation), PAConv (point-cloud
# classification) and BEV-LaneDet (BEV lane detection), the last model
# families of configs/ outside rendering and quant. None reaches a
# hand-written kernel: convs, unfolds, resizes, gathers, einsums and the
# knn's stable sort run as torch ops.
SSG21 = os.path.join(REPO, "configs", "squeezesegv3",
                     "squeezesegv3_rangenet21_semantickitti.yml")
SSG53 = os.path.join(REPO, "configs", "squeezesegv3",
                     "squeezesegv3_rangenet53_semantickitti.yml")
SSG_TINY = os.path.join(REPO, "configs", "squeezesegv3",
                        "squeezesegv3_synthetic_tiny.yml")
SSG_HW = (64, 2048)         # the configs' proj_H x proj_W
SSG_POINTS = 120000         # the returns of an HDL-64 sweep
SSG_CLASSES = 20            # the train ids (0 ignored by the metric)
SSG_ITERS = 2               # timed forwards per batch (halves of 1)
SSG_TRAIN_ITERS = 2         # timed train steps (halves of 1)
# LinearWarmup holds the configs' rate at 0 and ramps it over 1,000
# updates: the ten-step smoke starts past it
SSG_WARM = 1000
# the tiny model on the card against the CPU, relative to the largest
# logit: cuDNN's and the CPU's convolutions sum in other orders
SSG_TINY_TOL = {"logits": 1e-5}
PACONV = os.path.join(REPO, "configs", "paconv", "paconv_modelnet40.yml")
PACONV_TINY = os.path.join(REPO, "configs", "paconv",
                           "paconv_synthetic_tiny.yml")
PACONV_POINTS = 1024        # the config's num_points
PACONV_ITERS = 2
PACONV_TRAIN_ITERS = 2
# assign_score_withk in the transformed order against the JAX order
# (assign_score_withk_plain) on the card, relative to the largest value:
# the same sums of Cin x M products in another order (f32, TF32 off)
PACONV_ASSIGN_TOL = 1e-5
PACONV_TINY_TOL = {"logits": 1e-5}
LANEDET = os.path.join(REPO, "configs", "bev_lanedet",
                       "bev_lanedet_apollo_576x1024.yml")
LANE_HW = (576, 1024)       # the config's image_size
LANE_RANGE = ((3.0, 103.0), (-10.0, 10.0))   # ApolloLaneDataset's x, y
LANE_ITERS = 2
LANE_TRAIN_ITERS = 2
LANE_TINY_TOL = {"lane_conf": 1e-5, "lane_offset": 1e-5,
                 "lane_height": 1e-5, "lane_embed": 1e-5}


def launched():
    """The launch counters that moved since the last reset."""
    from paddle3d_tpu_torch.ops import _build
    return {k: v for k, v in _build.LAUNCHES.items() if v}


def no_launches(fn):
    """fn() with the launch counters set to 0 first -> (its result, the
    counters that moved)."""
    import torch

    from paddle3d_tpu_torch.ops import _build
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, launched()


def forward_stages(model, batch, fns, iters=3):
    """Host ms of test_forward (ended by a synchronize) and of each (name,
    obj, attr) call inside it, each call between two synchronizes,
    averaged over iters after a warm-up: the model's own code, timed where
    it runs."""
    import torch
    with torch.no_grad(), timed_calls(fns) as ms:
        model.test_forward(batch)
        torch.cuda.synchronize()
        for v in ms.values():
            v.clear()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.test_forward(batch)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / iters
    parts = {k: sum(v) / iters for k, v in ms.items()}
    log("  stages a batch (host clock, each call between two synchronizes): "
        "test_forward {:.3f} ms; {}".format(total, ", ".join(
            "{} {:.3f} ms".format(k, v) for k, v in parts.items())))
    return total, parts


def serving_timing(model, batch, label, iters, fns, names):
    """Frames/s (two halves of iters, cudnn.benchmark on), GFLOP a frame by
    module (names: module_flops'), peak memory, a profile of one forward
    and the stage times (forward_stages over fns)."""
    import torch
    b = batch["data"].shape[0]
    timed = {"img": batch["data"], **batch}
    with torch.no_grad():
        rates = [frames_per_s(model, timed, iters // 2) for _ in range(2)]
    rate = 2 / sum(1 / r for r in rates)
    flops = module_flops(model, lambda: model.test_forward(batch), b, names)
    log("  {} batch {}: {} forwards (two halves, cudnn.benchmark on): {:.2f} "
        "frames/s ({:.3f} ms a frame); halves {}; GFLOP a frame "
        "(torch.utils.flop_counter) {}: {:.2f} TFLOP/s at that rate".format(
            label, b, iters, rate, 1e3 / rate, [round(r, 2) for r in rates],
            {k: round(v, 3) for k, v in flops.items()},
            flops["total"] * rate / 1e3))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        model.test_forward(batch)
        log("  peak device memory of one forward at batch {}: {:.1f} "
            "MiB".format(b, torch.cuda.max_memory_allocated() / 2**20))
        profile(lambda: model.test_forward(batch))
    forward_stages(model, batch, fns)


def ssg_norm():
    """The RangeNet configs' NormalizeRangeImage mean and std."""
    from paddle3d_tpu_torch.apis import Config
    for t in Config(path=SSG21, device="cpu").dic["train_dataset"][
            "transforms"]:
        if t["type"] == "NormalizeRangeImage":
            return t["mean"], t["std"]
    raise PhaseError("no NormalizeRangeImage in {}".format(SSG21))


def range_scans(rng, b, n=None):
    """b velodyne-like sweeps [b, n, 4] (x, y, z, remission in [0, 1)):
    bench.make_scans' clustered scans over the KITTI pillar config's range
    mirrored behind the sensor, so that they cover the whole circle as a
    sweep does."""
    import bench
    lo, hi = bench.MODELS["pointpillars"][2]
    return bench.make_scans(rng, b, n or SSG_POINTS,
                            [-hi[0]] + list(lo[1:]), hi,
                            "clustered")


def range_batch(device, b, seed=SEED, hw=None, points=None):
    """b range_scans through the port's range projection at hw (the
    LoadSemanticKITTIRange of the configs) and the configs'
    NormalizeRangeImage, each point's label drawn from the 20 train ids:
    {"data" [b, H, W, 5], "proj_mask" [b, H, W] bool, "proj_labels" [b,
    H, W] int64} on device."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.sample import Sample
    from paddle3d_tpu_torch.transforms import (NormalizeRangeImage,
                                               project_range)
    normalise = NormalizeRangeImage(*ssg_norm())
    hw = hw or SSG_HW
    rng = np.random.default_rng(seed)
    out = {"data": [], "proj_mask": [], "proj_labels": []}
    for pts in range_scans(rng, b, points):
        labels = rng.integers(0, SSG_CLASSES, len(pts)).astype(np.int32)
        proj = project_range(pts[:, :3], pts[:, 3], hw[0], hw[1],
                             labels=labels)
        s = Sample(None, "lidar")
        s.data, s.proj_mask = proj["data"], proj["proj_mask"]
        out["data"].append(normalise(s).data)
        out["proj_mask"].append(proj["proj_mask"])
        out["proj_labels"].append(proj["proj_labels"].astype(np.int64))
    return {k: torch.from_numpy(np.stack(v)).to(device)
            for k, v in out.items()}


def check_seg_outputs(out, b, hw, classes):
    """SqueezeSegV3's outputs: shapes, finite logits, labels in range. ->
    the share of each frame's pixels per predicted class (the top three)."""
    import torch
    check(tuple(out["pred_labels"].shape) == (b,) + tuple(hw) and
          tuple(out["logits"].shape) == (b,) + tuple(hw) + (classes,),
          "SqueezeSegV3 output shapes {}".format(
              {k: tuple(v.shape) for k, v in out.items()}))
    check(bool(torch.isfinite(out["logits"]).all()),
          "non-finite SqueezeSegV3 logits")
    labels = out["pred_labels"]
    check(bool(((labels >= 0) & (labels < classes)).all()),
          "SqueezeSegV3 labels out of range")
    share = torch.bincount(labels.flatten(), minlength=classes).float()
    share = share / labels.numel()
    top = torch.topk(share, 3)
    return {int(i): round(v, 4) for v, i in zip(top.values.tolist(),
                                                top.indices.tolist())}


def ssg_fns(model):
    """The calls forward_stages times inside SqueezeSegV3's test_forward:
    the backbone whole, its stem and each SAC block, the head."""
    bb = model.backbone
    return ([("backbone", bb, "forward"), ("stem", bb.stem, "forward")] +
            [("SAC block {}".format(i), blk, "forward")
             for i, blk in enumerate(bb.blocks)] +
            [("head", model.head, "forward")])


def phase_squeezeseg(device):
    """SqueezeSegV3 on both SemanticKITTI configs at full width (RangeNet-21
    [32, 64, 128, 256] and RangeNet-53 [64, 128, 256, 512, 1024], 20
    classes; seeded random weights, f32, TF32 off) on range_batch's 64 x
    2,048 images: serving at batch 1 and the configs' batch (4, 2) with no
    launch counter moving, frames/s, GFLOP by module, memory, a profile and
    the stage times; the tiny config card vs CPU; training RangeNet-21 at
    batch 4 (the config's SGD, clip 10, LinearWarmup over StepDecay): the
    first step at the warm-up's rate 0, then, past the warm-up, 10 steps
    with finite losses that fall, train frames/s, memory, profile;
    RangeNet-53 at batch 2: train frames/s and memory."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    full = range_batch(device, 4)
    batches = {b: {k: v[:b] for k, v in full.items()} for b in (1, 2, 4)}
    filled = full["proj_mask"].float().mean(dim=(1, 2)).tolist()
    log("phase 24: SqueezeSegV3 (SAC range nets, 20 classes) on {} x {} "
        "range images of {}-point sweeps: pixels holding a point {}; no "
        "hand-written kernel".format(*SSG_HW, SSG_POINTS,
                                     [round(v, 4) for v in filled]))
    models = {}
    for label, path in (("RangeNet-21", SSG21), ("RangeNet-53", SSG53)):
        cfg = Config(path=path, device=device)
        model = cfg.model.eval()
        for b in (1, cfg.dic["batch_size"]):
            with torch.no_grad():
                out, launches = no_launches(
                    lambda: model.test_forward(batches[b]))
            log("  {} batch {}: classes by pixel share {}; launches "
                "{}".format(label, b, check_seg_outputs(
                    out, b, SSG_HW, model.num_classes), launches))
            check(not launches, "SqueezeSegV3 launched {}".format(launches))
        models[label] = (model, cfg.dic["batch_size"])
    model = Config(path=SSG_TINY, device="cpu").model.eval()
    x = torch.randn((2, 16, 64, 5), generator=torch.Generator().manual_seed(
        SEED))
    _, launches = tiny_card_vs_cpu("SqueezeSegV3", model, [{"data": x}],
                                   SSG_TINY_TOL, None, labels="pred_labels")
    check(not launches, "the tiny SqueezeSegV3 launched {}".format(launches))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for label, (model, bsz) in models.items():
        for b in (1, bsz):
            serving_timing(model, batches[b], label, SSG_ITERS,
                           ssg_fns(model), dict(
                               [("backbone", "SACRangeNet"),
                                ("stem", "SACRangeNet.stem")] +
                               [("SAC block {}".format(i),
                                 "SACRangeNet.blocks.{}".format(i))
                                for i in range(len(model.backbone.blocks))] +
                               [("head", "Sequential")]))
    del models

    cfg = Config(path=SSG21, device=device)
    model = cfg.model.train()
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    step = make_train_step(lr_scheduler=scheduler)
    batch = batches[cfg.dic["batch_size"]]
    lr0 = optimizer.param_groups[0]["lr"]
    _build.reset_launches()
    losses = step(model, optimizer, batch)
    log("  training RangeNet-21 at batch {} ({}, clip {}, {} over {}): "
        "first step at rate {} losses {}".format(
            cfg.dic["batch_size"], cfg.dic["optimizer"]["type"],
            cfg.dic["optimizer"].get("grad_clip_norm"),
            cfg.dic["lr_scheduler"]["type"],
            cfg.dic["lr_scheduler"]["learning_rate"]["type"], lr0,
            {k: round(v.item(), 5) for k, v in losses.items()}))
    check(all(bool(torch.isfinite(v)) for v in losses.values()),
          "SqueezeSegV3: non-finite losses")
    # the ten steps start past LinearWarmup's ramp (at rate 0 they could
    # not move the weights): the scheduler read at update SSG_WARM
    scheduler.last_epoch = SSG_WARM - 1
    scheduler.step()
    log("  the {} steps below start at update {}, past the warm-up, at "
        "rate {}".format(TRAIN_STEPS, SSG_WARM,
                         optimizer.param_groups[0]["lr"]))
    falling_losses(step, model, optimizer, batch)
    train_rate(step, model, optimizer, {"img": batch["data"], **batch},
               SSG_TRAIN_ITERS, "SqueezeSegV3 RangeNet-21")
    del model, optimizer, scheduler
    cfg = Config(path=SSG53, device=device)
    model = cfg.model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    batch = {k: v[:cfg.dic["batch_size"]] for k, v in batch.items()}
    train_rate(step, model, cfg.optimizer, {"img": batch["data"], **batch},
               SSG_TRAIN_ITERS, "SqueezeSegV3 RangeNet-53")
    check(not launched(), "SqueezeSegV3 training launched {}".format(
        launched()))


def primitive_clouds(rng, b, n=None, classes=40):
    """b clouds of n points sampled on random primitive surfaces (a class
    picks the primitive, class % 4: ellipsoid, box, cylinder, cone, and
    its aspect ratios), randomly rotated, centred and scaled into the unit
    sphere, as ModelNet40's are. -> (points [b, n, 3] f32, labels [b]
    int64)."""
    import numpy as np
    n = n or PACONV_POINTS
    labels = rng.integers(0, classes, b)
    out = np.empty((b, n, 3), np.float32)
    for i, c in enumerate(labels):
        aspect = 0.4 + 0.6 * np.array([(c * 7 % 10) / 9, (c * 3 % 10) / 9,
                                       1.0])
        u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
        kind = c % 4
        if kind == 0:                           # ellipsoid
            p = rng.normal(size=(n, 3))
            p /= np.linalg.norm(p, axis=1, keepdims=True)
        elif kind == 1:                         # box surface
            p = rng.uniform(-1, 1, (n, 3))
            face = rng.integers(0, 3, n)
            p[np.arange(n), face] = np.sign(rng.uniform(-1, 1, n))
        elif kind == 2:                         # cylinder
            t = 2 * np.pi * u
            p = np.stack([np.cos(t), np.sin(t), 2 * v - 1], axis=1)
        else:                                   # cone
            t = 2 * np.pi * u
            r = 1 - v
            p = np.stack([r * np.cos(t), r * np.sin(t), 2 * v - 1], axis=1)
        p = p * aspect + rng.normal(0, 0.01, (n, 3))
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        p = p @ q.T
        p -= p.mean(axis=0)
        out[i] = p / np.linalg.norm(p, axis=1).max()
    return out, labels.astype(np.int64)


def paconv_batch(device, b, seed=SEED):
    import numpy as np
    import torch
    pts, labels = primitive_clouds(np.random.default_rng(seed), b)
    return {"data": torch.from_numpy(pts).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def paconv_assign(model, batch):
    """assign_score_withk at each layer's call of one forward (recorded),
    against the JAX order (assign_score_withk_plain) on the same inputs:
    relative error, both timed (CUDA events), their products counted."""
    import torch

    from paddle3d_tpu_torch.models.classification import paconv
    calls = []
    fn = paconv.assign_score_withk

    def rec(*a):
        calls.append(a)
        return fn(*a)
    with torch.no_grad(), mock.patch.object(paconv, "assign_score_withk",
                                            rec):
        model.test_forward(batch)
    check(len(calls) == len(model.weight_banks),
          "expected one assign_score_withk call a layer")
    worst = 0.
    with torch.no_grad():
        for i, a in enumerate(calls):
            got = fn(*a)
            ref = paconv.assign_score_withk_plain(*a)
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            worst = max(worst, err)
            b, n, k, m = a[0].shape
            cin, cout = a[4].shape[1:]
            ms = cuda_ms(lambda: fn(*a), 10)
            plain_ms = cuda_ms(lambda: paconv.assign_score_withk_plain(*a),
                               10)
            del got, ref
            log("  assign_score_withk, layer {}: B={} N={} K={} M={} {} -> "
                "{}: transformed {:.4f} ms ({:.3f} GFLOP), JAX order {:.4f} "
                "ms ({:.3f} GFLOP); relative error {:.3e}".format(
                    i, b, n, k, m, cin, cout, ms,
                    2 * b * n * m * cout * (cin + 2 * k) / 1e9, plain_ms,
                    2 * b * n * k * m * cout * (cin + 1) / 1e9, err))
    check(worst <= PACONV_ASSIGN_TOL, "assign_score_withk differs from the "
          "JAX order by {:.3e} (tolerance {})".format(worst,
                                                      PACONV_ASSIGN_TOL))
    return worst


def paconv_fns(model):
    from paddle3d_tpu_torch.models.classification import paconv
    return ([("knn", paconv, "knn_query"),
             ("assign_score_withk", paconv, "assign_score_withk")] +
            [("ScoreNet {}".format(i), net, "forward")
             for i, net in enumerate(model.score_nets)] +
            [("classifier", model.classifier, "forward")])


def phase_paconv(device):
    """PAConv on paconv_modelnet40.yml at full width (k 20, 8 kernels,
    channels [64, 64, 128, 256], 40 classes; seeded random weights, f32,
    TF32 off) on primitive_clouds of 1,024 points: serving at batch 1 and
    32 (no launch), assign_score_withk held against the JAX order on each
    layer's call, frames/s, GFLOP, memory, profile, stages; the tiny
    config card vs CPU; training at batch 32 (the config's SGD, clip 10,
    CosineDecay): 10 falling losses, train frames/s, memory, profile."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=PACONV, device=device)
    bsz = cfg.dic["batch_size"]
    model = cfg.model.eval()
    log("phase 25: PAConv (k {}, {} kernels, channels {}, {} classes) on "
        "clouds of {} points; no hand-written kernel".format(
            model.k, model.weight_banks[0].shape[0],
            [p.shape[-1] for p in model.weight_banks], model.num_classes,
            PACONV_POINTS))
    batches = {b: paconv_batch(device, b) for b in (1, bsz)}
    for b, batch in batches.items():
        with torch.no_grad():
            out, launches = no_launches(lambda: model.test_forward(batch))
        check(tuple(out["logits"].shape) == (b, model.num_classes) and
              bool(torch.isfinite(out["logits"]).all()),
              "PAConv logits {}".format(tuple(out["logits"].shape)))
        log("  batch {}: predicted classes {}; launches {}".format(
            b, out["pred"].tolist()[:8], launches))
        check(not launches, "PAConv launched {}".format(launches))
    paconv_assign(model, batches[bsz])
    tiny = Config(path=PACONV_TINY, device="cpu").model.eval()
    pts = torch.randn((2, 128, 3), generator=torch.Generator().manual_seed(
        SEED))
    _, launches = tiny_card_vs_cpu("PAConv", tiny, [{"data": pts}],
                                   PACONV_TINY_TOL, None, labels="pred")
    check(not launches, "the tiny PAConv launched {}".format(launches))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for b, batch in batches.items():
        # the einsums and the scored gather's products run outside any
        # module: they count in the total only
        serving_timing(model, batch, "PAConv", PACONV_ITERS,
                       paconv_fns(model), {"ScoreNets": "ScoreNet",
                                           "classifier": "Sequential"})
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    batch = batches[bsz]
    _build.reset_launches()
    losses = step(model, cfg.optimizer, batch)
    log("  training at batch {} ({}, clip {}, {}): first step losses "
        "{}".format(bsz, cfg.dic["optimizer"]["type"],
                    cfg.dic["optimizer"].get("grad_clip_norm"),
                    cfg.dic["lr_scheduler"]["type"],
                    {k: round(v.item(), 5) for k, v in losses.items()}))
    check(all(bool(torch.isfinite(v)) for v in losses.values()),
          "PAConv: non-finite losses")
    falling_losses(step, model, cfg.optimizer, batch)
    train_rate(step, model, cfg.optimizer, {"img": batch["data"], **batch},
               PACONV_TRAIN_ITERS, "PAConv")
    check(not launched(), "PAConv training launched {}".format(launched()))


def lane_grid(hb, wb):
    """ApolloLaneDataset's identity image-to-BEV grid [hb, wb, 2]: (u, v) =
    (column, 1 - row) in [0, 1]."""
    import numpy as np
    gy, gx = np.meshgrid(np.linspace(0, 1, hb), np.linspace(0, 1, wb),
                         indexing="ij")
    return np.stack([gx, 1 - gy], axis=-1).astype(np.float32)


def lane_polylines(rng, lanes=(4, 8), x_range=LANE_RANGE[0]):
    """One frame's 4-8 lanes as [K, 3] (x, y, z) polylines in ego space,
    a point every 0.5 m from 3 to 103 m ahead: about 2.1-2.6 m apart,
    with a gentle curve and grade, as ApolloLaneDataset's laneLines."""
    import numpy as np
    n = int(rng.integers(lanes[0], lanes[1] + 1))
    xs = np.arange(x_range[0], x_range[1], 0.5)
    y0 = (np.arange(n) - (n - 1) / 2) * 3.5 * rng.uniform(0.6, 0.75) + \
        rng.normal(0, 0.3)
    curve = rng.normal(0, 2e-4)
    grade = rng.normal(0, 0.01)
    return [np.stack([xs, y0[li] + curve * xs ** 2,
                      grade * xs + rng.normal(0, 0.02)], axis=1)
            for li in range(n)]


def rasterise_lanes(lanes, hb, wb, x_range=LANE_RANGE[0],
                    y_range=LANE_RANGE[1]):
    """ApolloLaneDataset's targets of one frame's polylines on the hb x wb
    grid: a cell holds the last lane point landing in it (conf 1, the
    lateral offset in the cell, the height, the instance id 1..8). ->
    conf, offset, height [hb, wb] f32, instance [hb, wb] int64."""
    import numpy as np
    conf = np.zeros((hb, wb), np.float32)
    offset = np.zeros((hb, wb), np.float32)
    height = np.zeros((hb, wb), np.float32)
    inst = np.zeros((hb, wb), np.int64)
    dx = (x_range[1] - x_range[0]) / hb
    dy = (y_range[1] - y_range[0]) / wb
    for li, lane in enumerate(lanes[:8]):
        for p in np.asarray(lane, np.float32):
            r = int((p[0] - x_range[0]) / dx)
            c = (p[1] - y_range[0]) / dy
            ci = int(c)
            if 0 <= r < hb and 0 <= ci < wb:
                conf[r, ci] = 1.0
                offset[r, ci] = c - ci
                height[r, ci] = p[2]
                inst[r, ci] = li + 1
    return conf, offset, height, inst


def lane_targets(rng, b, hb, wb):
    """b frames of lane_polylines rasterised (rasterise_lanes) -> conf,
    offset, height [b, hb, wb] f32, instance [b, hb, wb] int64."""
    import numpy as np
    return tuple(np.stack(v) for v in zip(*(
        rasterise_lanes(lane_polylines(rng), hb, wb) for _ in range(b))))


def lane_batch(device, b, bev, seed=SEED, hw=None):
    """b uniform-pixel NHWC images in [0, 255) at hw, the identity
    bev_grid and lane_targets on device."""
    import numpy as np
    import torch
    hw = hw or LANE_HW
    rng = np.random.default_rng(seed)
    conf, offset, height, inst = lane_targets(rng, b, *bev)
    arrays = {
        "data": rng.uniform(0, 255, (b,) + tuple(hw) + (3,)).astype(
            np.float32),
        "bev_grid": np.broadcast_to(lane_grid(*bev), (b,) + tuple(bev) +
                                    (2,)).copy(),
        "lane_conf": conf, "lane_offset": offset, "lane_height": height,
        "lane_instance": inst}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def lanedet_tiny():
    """A small BEV-LaneDet (ResNet-18 at base 8 to its third stage, 32
    channels at stride 16, reduced to 8, a 20 x 8 BEV) on the CPU, seeded,
    in eval mode."""
    import torch

    from paddle3d_tpu_torch.models.backbones import ResNet
    from paddle3d_tpu_torch.models.detection import BEVLaneDet
    gen = torch.Generator().manual_seed(SEED)
    return BEVLaneDet(ResNet(depth=18, base_channels=8, out_indices=(2,),
                             generator=gen),
                      bev_size=(20, 8), in_channels=32, feat_channels=8,
                      generator=gen).eval()


def lanedet_fns(model):
    from paddle3d_tpu_torch.models.detection.bev_lanedet import bev_lanedet
    return [("backbone", model.backbone, "forward"),
            ("reduce", model.reduce, "forward"),
            ("warp", bev_lanedet, "bilinear_warp"),
            ("BEV convs", model.bev_conv, "forward")] + [
        (name, getattr(model, name), "forward")
        for name in ("conf_head", "offset_head", "embed_head",
                     "height_head")]


def phase_lanedet(device):
    """BEV-LaneDet on bev_lanedet_apollo_576x1024.yml at full width
    (ResNet-34 to its third stage, 256 channels at stride 16, reduced to
    64, warped onto the 100 x 25 BEV; seeded random weights, f32, TF32 off)
    on 576 x 1,024 uniform-pixel images with the identity bev_grid:
    serving at batch 1 and 16 (no launch), frames/s, GFLOP, memory,
    profile, stages; the small model card vs CPU; training at batch 16 on
    lane_targets (the config's AdamW, clip 35, CosineDecay): 10 falling
    losses, train frames/s, memory, profile."""
    import torch

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.ops import _build
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = Config(path=LANEDET, device=device)
    bsz = cfg.dic["batch_size"]
    model = cfg.model.eval()
    bev = (model.bev_h, model.bev_w)
    batches = {b: lane_batch(device, b, bev) for b in (1, bsz)}
    lanes = [len(v.unique()) - 1 for v in batches[bsz]["lane_instance"]]
    log("phase 26: BEV-LaneDet (ResNet-34 to stride 16, BEV {} x {}) at {} "
        "x {}: lanes a frame {}, lane cells a frame {}; no hand-written "
        "kernel".format(*bev, *LANE_HW, lanes, batches[bsz]["lane_conf"]
                        .sum(dim=(1, 2)).int().tolist()))
    for b, batch in batches.items():
        with torch.no_grad():
            out, launches = no_launches(lambda: model.test_forward(batch))
        check(all(tuple(out[k].shape) == (b,) + bev for k in (
            "lane_conf", "lane_offset", "lane_height")) and
            tuple(out["lane_embed"].shape) == (b,) + bev + (4,),
            "BEV-LaneDet output shapes {}".format(
                {k: tuple(v.shape) for k, v in out.items()}))
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              "non-finite BEV-LaneDet outputs")
        log("  batch {}: cells with conf > 0.5 a frame {}; launches "
            "{}".format(b, (out["lane_conf"] > 0.5).sum(dim=(1, 2))
                        .tolist(), launches))
        check(not launches, "BEV-LaneDet launched {}".format(launches))
    tiny = lanedet_tiny()
    small = lane_batch("cpu", 2, (20, 8), hw=(64, 96))
    _, launches = tiny_card_vs_cpu(
        "BEV-LaneDet", tiny, [{k: small[k] for k in ("data", "bev_grid")}],
        LANE_TINY_TOL, None, labels=None)
    check(not launches, "the small BEV-LaneDet launched {}".format(launches))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    for b, batch in batches.items():
        serving_timing(model, batch, "BEV-LaneDet", LANE_ITERS,
                       lanedet_fns(model), {
                           "backbone": "ResNet", "reduce": "ConvBNReLU",
                           "BEV convs": "Sequential", "heads": "Conv2d"})
    model.train()
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    batch = batches[bsz]
    _build.reset_launches()
    losses = step(model, cfg.optimizer, batch)
    log("  training at batch {} ({}, clip {}, {}): first step losses "
        "{}".format(bsz, cfg.dic["optimizer"]["type"],
                    cfg.dic["optimizer"].get("grad_clip_norm"),
                    cfg.dic["lr_scheduler"]["type"],
                    {k: round(v.item(), 5) for k, v in losses.items()}))
    check(all(bool(torch.isfinite(v)) for v in losses.values()),
          "BEV-LaneDet: non-finite losses")
    falling_losses(step, model, cfg.optimizer, batch)
    train_rate(step, model, cfg.optimizer, {"img": batch["data"], **batch},
               LANE_TRAIN_ITERS, "BEV-LaneDet")
    check(not launched(), "BEV-LaneDet training launched {}".format(
        launched()))


# --------------------------------------------------------------- phase 27
RT_TRAIN, RT_VAL = 16, 8    # frames of the KITTI tree's train and val splits
RT_ITERS = 16               # Trainer steps: two epochs at the config's batch
RT_TIMED = 10               # steps of a timed window
RT_WARM = 3                 # steps of a run before its timed window
RT_TIMED_TRAIN = 40         # frames of the timing tree's train split: an
                            # epoch of 20 steps holds a run's warm-up, window
                            # and the step that ends the window
RT_WORKERS = 4              # loader threads (tools/train.py's default)
RT_EMA = 0.9998             # the Trainer's EMA decay (the JAX default)
# KITTI's calibration of frame 000000 (training/calib), the standard one
KITTI_CALIB = {
    "P2": (7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01, 0.0, 7.215377e+02,
           1.728540e+02, 2.163791e-01, 0.0, 0.0, 1.0, 2.745884e-03),
    "R0_rect": (9.999239e-01, 9.837760e-03, -7.445048e-03, -9.869795e-03,
                9.999421e-01, -4.278459e-03, 7.402527e-03, 4.351614e-03,
                9.999631e-01),
    "Tr_velo_to_cam": (7.533745e-03, -9.999714e-01, -6.166020e-04,
                       -4.069766e-03, 1.480249e-02, 7.280733e-04,
                       -9.998902e-01, -7.631618e-02, 9.998621e-01,
                       7.523790e-03, 1.480755e-02, -2.717806e-01)}
# car slots (lidar x, y, m): 5 m apart in x and 6 m in y, so that boxes of
# 1.6 x 3.9 m jittered by 0.5 m never touch; x <= 22.5 m keeps every car's
# image box taller than 40 px under P2, KITTI's "easy" gate for a detection
RT_SLOTS = [(x, y) for x in (7.5, 12.5, 17.5, 22.5)
            for y in (-12.0, -6.0, 0.0, 6.0, 12.0)]
RT_SURFACE = 0.3            # share of a scan's points moved onto its cars
# pedestrian and cyclist slots: beyond the car rows' reach in y (a car's
# slot, jitter and half diagonal end within 14.6 m of the axis)
RT_SMALL_SLOTS = [(x, y) for x in (7.5, 12.5, 17.5, 22.5)
                  for y in (-18.0, 18.0)]
# KITTI's mean object sizes (w, l, h), m
KITTI_SIZES = {"Car": (1.6, 3.9, 1.56), "Pedestrian": (0.6, 0.8, 1.73),
               "Cyclist": (0.6, 1.76, 1.73)}
KITTI_CLASSES = ["Car", "Cyclist", "Pedestrian"]   # the configs' order


def car_boxes(rng, zg):
    """6-10 Car boxes in distinct RT_SLOTS (jittered 0.5 m, any yaw, sizes
    within 5 % of the config's anchor), bottoms on the ground zg: [G, 7]
    (x, y, z bottom, w, l, h, yaw)."""
    import numpy as np
    g = int(rng.integers(6, 11))
    slots = np.asarray(RT_SLOTS)[rng.permutation(len(RT_SLOTS))[:g]]
    xy = slots + rng.uniform(-0.5, 0.5, (g, 2))
    size = np.array(KITTI_SIZES["Car"]) * rng.uniform(0.95, 1.05, (g, 3))
    yaw = rng.uniform(-np.pi, np.pi, g)
    return np.c_[xy, np.full(g, zg), size, yaw].astype(np.float32)


def surface_points(rng, boxes, n, which=None):
    """n points on the boxes' four sides and tops (lidar boxes (x, y, z
    bottom, w, l, h, yaw), w along the box's x axis as BBoxes3D's corners
    put it), intensity in [0, 1); which: each point's box (drawn uniformly
    if None). -> [n, 4]."""
    import numpy as np
    if which is None:
        which = rng.integers(0, len(boxes), n)
    b = boxes[which]
    local = rng.uniform(-0.5, 0.5, (n, 3))
    face = rng.integers(0, 5, n)                # +-x, +-y sides, top
    for f, (axis, side) in enumerate(((0, .5), (0, -.5), (1, .5),
                                      (1, -.5), (2, .5))):
        local[face == f, axis] = side
    local = local * b[:, 3:6]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    x = c * local[:, 0] - s * local[:, 1] + b[:, 0]
    y = s * local[:, 0] + c * local[:, 1] + b[:, 1]
    z = local[:, 2] + b[:, 5] / 2 + b[:, 2]
    return np.c_[x, y, z, rng.uniform(0, 1, n)].astype(np.float32)


def small_boxes(rng, zg, classes):
    """1-3 boxes of each class of `classes` (Pedestrian, Cyclist) in
    distinct RT_SMALL_SLOTS (jittered 0.25 m, any yaw, KITTI's mean sizes
    within 5 %), bottoms on zg: -> ([G, 7], [G] class names)."""
    import numpy as np
    n = {c: int(rng.integers(1, 4)) for c in classes}
    g = sum(n.values())
    slots = np.asarray(RT_SMALL_SLOTS)[
        rng.permutation(len(RT_SMALL_SLOTS))[:g]]
    names = [c for c in classes for _ in range(n[c])]
    xy = slots + rng.uniform(-0.25, 0.25, (g, 2))
    size = np.asarray([KITTI_SIZES[c] for c in names]) * rng.uniform(
        0.95, 1.05, (g, 3))
    yaw = rng.uniform(-np.pi, np.pi, g)
    return (np.c_[xy, np.full(g, zg), size, yaw].astype(np.float32), names)


def kitti_tree(root, train=RT_TRAIN, val=RT_VAL, seed=SEED, points=None,
               classes=("Car",), images=False, hashes=None):
    """A KITTI tree under root: `train` + `val` frames of bench.make_scans
    KITTI scans (as make_points draws them, `points` a scan) with car_boxes
    (and, where `classes` names them, small_boxes of pedestrians and
    cyclists), RT_SURFACE of each scan's points moved onto its objects,
    label_2 lines written through the port's kitti_utils under KITTI_CALIB
    with a 2-D box at least 60 px tall (every object "easy"), and
    ImageSets/{train,val}.txt. With images, image_2/ too: kitti_image's
    render of the frame's objects, as PNGs that png_bytes writes (no
    Pillow on the card's machine), most at 1242 x 375 and every fourth
    frame at one of CAM_SIZES' other two in turn; their texture draws from
    a generator of the seed and frame, so the scans and boxes are those of
    a tree without images; hashes, a dict, gets each image's sha256 by
    frame id.
    -> {frame id: [G, 7] lidar boxes}."""
    import numpy as np

    import bench
    from paddle3d_tpu_torch.datasets.kitti import kitti_utils
    _, n, (lo, hi), _ = bench.MODELS["pointpillars"]
    n = points or n
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "training")
    for sub in ("velodyne", "label_2", "calib") + (
            ("image_2",) if images else ()):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    calib_text = "".join(
        "{}: {}\n".format(k, " ".join("{:.6e}".format(v) for v in vals))
        for k, vals in (("P0", KITTI_CALIB["P2"]), ("P1", KITTI_CALIB["P2"]),
                        ("P2", KITTI_CALIB["P2"]), ("P3", KITTI_CALIB["P2"]),
                        ("R0_rect", KITTI_CALIB["R0_rect"]),
                        ("Tr_velo_to_cam", KITTI_CALIB["Tr_velo_to_cam"])))
    ids = ["{:06d}".format(i) for i in range(train + val)]
    zg = lo[2] + 0.28 * (hi[2] - lo[2])         # make_scans' ground plane
    written = {}
    for idx in ids:
        calib_path = os.path.join(base, "calib", idx + ".txt")
        with open(calib_path, "w") as f:
            f.write(calib_text)
        calib = kitti_utils.Calibration.from_file(calib_path)
        scan = bench.make_scans(rng, 1, n, lo, hi, "clustered")[0]
        boxes = car_boxes(rng, zg)
        names = ["Car"] * len(boxes)
        small = [c for c in classes if c != "Car"]
        if small:
            more, more_names = small_boxes(rng, zg, small)
            boxes, names = np.vstack([boxes, more]), names + more_names
        k = int(RT_SURFACE * n)
        scan[:k] = surface_points(rng, boxes, k)
        scan.astype(np.float32).tofile(os.path.join(base, "velodyne",
                                                    idx + ".bin"))
        cam = kitti_utils.lidar_boxes_to_camera_anno(boxes, calib)
        lines = []
        for j in range(len(boxes)):
            x1, y1, x2, y2 = cam["bbox"][j]
            lines.append(kitti_utils.format_label_line(
                names[j], 0.0, 0, -np.arctan2(-boxes[j, 1], boxes[j, 0]) +
                boxes[j, 6], (x1, min(y1, y2 - 60.0), x2, y2),
                cam["dimensions"][j], cam["location"][j],
                cam["rotation_y"][j]))
        with open(os.path.join(base, "label_2", idx + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if images:
            i = int(idx)
            hw = CAM_SIZES[1 + (i // 4) % 2 if i % 4 == 3 else 0]
            img = kitti_image(np.random.default_rng([seed, i]), boxes,
                              [KITTI_CLASSES.index(c) for c in names],
                              calib, hw)
            with open(os.path.join(base, "image_2", idx + ".png"),
                      "wb") as f:
                f.write(png_bytes(img))
            if hashes is not None:
                import hashlib
                hashes[idx] = hashlib.sha256(img.tobytes()).hexdigest()
        written[idx] = boxes
    for split, part in (("train", ids[:train]), ("val", ids[train:])):
        with open(os.path.join(root, "ImageSets", split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    return written


# ------------------------------------------------------ phase 28's trees
# nuScenes: detection class -> (category, mean size (w, l, h) m, speed m/s)
NUSC_CLASSES = {
    "car": ("vehicle.car", (1.95, 4.62, 1.73), 6.0),
    "truck": ("vehicle.truck", (2.51, 6.93, 2.84), 4.0),
    "construction_vehicle": ("vehicle.construction", (2.85, 6.37, 3.19),
                             0.0),
    "bus": ("vehicle.bus.rigid", (2.94, 10.5, 3.47), 5.0),
    "trailer": ("vehicle.trailer", (2.9, 10.0, 3.9), 3.0),
    "barrier": ("movable_object.barrier", (2.53, 0.5, 0.98), 0.0),
    "motorcycle": ("vehicle.motorcycle", (0.77, 2.11, 1.47), 4.0),
    "bicycle": ("vehicle.bicycle", (0.6, 1.7, 1.28), 2.0),
    "pedestrian": ("human.pedestrian.adult", (0.67, 0.73, 1.77), 1.2),
    "traffic_cone": ("movable_object.trafficcone", (0.41, 0.41, 1.07),
                     0.0)}
NUSC_SWEEP_POINTS = 34000   # a LIDAR_TOP sweep (HDL-32E): ~34,000 returns
NUSC_SWEEPS = 10            # sweeps before a key frame (the config's
                            # max_sweeps); key frames at 2 Hz, sweeps 20 Hz
NUSC_SURFACE = 0.15         # share of a sweep's points on its objects
NUSC_TRAIN, NUSC_VAL = 8, 4  # key frames of the train and val scenes
# the LIDAR_TOP's yaw on the ego in nuScenes' calibrated_sensor (its
# rotation without the ~0.01 rad of roll and pitch, so that
# bench.make_scans' flat ground stays the road), mounted at the height that
# puts that ground on the road
NUSC_LIDAR_YAW = -1.568763018216323
WAYMO_POINTS = 180000       # a Waymo top-LiDAR scan: ~180,000 returns
WAYMO_TRAIN, WAYMO_VAL = 8, 4
# Waymo's mean sizes (w, l, h), m
WAYMO_SIZES = {"Vehicle": (2.1, 4.8, 1.8), "Pedestrian": (0.9, 0.9, 1.7),
               "Cyclist": (0.8, 1.8, 1.7)}


# the six cameras (channel, yaw on the ego in rad, mount (x, y, z) m, focal
# px at 1600 x 900): nuScenes' rig, rounded
NUSC_CAMERAS = (("CAM_FRONT", 0.0, (1.70, 0.02, 1.51), 1266.4),
                ("CAM_FRONT_RIGHT", -0.96, (1.55, -0.49, 1.50), 1260.8),
                ("CAM_FRONT_LEFT", 0.96, (1.52, 0.49, 1.51), 1272.6),
                ("CAM_BACK", math.pi, (0.03, 0.0, 1.57), 809.2),
                ("CAM_BACK_LEFT", 1.92, (1.04, 0.48, 1.57), 1256.7),
                ("CAM_BACK_RIGHT", -1.92, (1.03, -0.48, 1.56), 1259.5))
NUSC_CAM_HW = (900, 1600)   # nuScenes' camera images, h x w
NUSC_CAM_VARIANTS = 2       # distinct images a camera, in turn over frames
NUSC_JPEG_QUALITY = 90


def _mat_quat(r):
    """A rotation matrix -> its (w, x, y, z) quaternion."""
    import numpy as np
    w = np.sqrt(max(0.0, 1.0 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - r[0, 0] + r[1, 1] - r[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - r[0, 0] - r[1, 1] + r[2, 2])) / 2
    x = np.copysign(x, r[2, 1] - r[1, 2])
    y = np.copysign(y, r[0, 2] - r[2, 0])
    z = np.copysign(z, r[1, 0] - r[0, 1])
    return [float(w), float(x), float(y), float(z)]


def camera_image(rng, hw):
    """A camera view [h, w, 3] uint8: a sky / road gradient with a grain of
    +-12 levels and a few shaded blocks."""
    import numpy as np
    h, w = hw
    grad = np.linspace(170, 60, h, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(grad, (h, w, 3)).copy()
    img[:h * 11 // 20] += np.array([15, 30, 60], np.float32)
    img += rng.integers(-12, 13, (h, w, 3)).astype(np.float32)
    for _ in range(6):
        y0, x0 = int(rng.integers(h // 3, h - 2)), int(rng.integers(0, w))
        bh, bw = max(2, h // int(rng.integers(5, 12))), max(
            2, w // int(rng.integers(6, 16)))
        img[y0:y0 + bh, x0:x0 + bw] = rng.uniform(20, 230, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def place_file(path, data, written):
    """data at path: a hard link to the file written with the same bytes
    before (written: bytes -> path), else written anew."""
    first = written.get(data)
    if first is not None:
        try:
            os.link(first, path)
            return
        except OSError:
            pass
    with open(path, "wb") as f:
        f.write(data)
    written.setdefault(data, path)


def _nusc_cameras(tables, root, hw, seed):
    """The six cameras of every key frame of the tables' scenes: a
    calibrated_sensor a camera and scene (NUSC_CAMERAS, the principal
    point at the image's centre, the focal scaled to w), a sample_data a
    key frame and camera (the key frame's ego pose and timestamp) at
    samples/<channel>/<token>.jpg, listed in the sample's data. The files
    are NUSC_CAM_VARIANTS baseline 4:2:0 JPEGs a camera (jpeg_bytes),
    written once and hard-linked in turn over the frames."""
    import numpy as np
    h, w = hw
    rng = np.random.default_rng([seed, 7])
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    files = {}
    for cam, yaw, mount, focal in NUSC_CAMERAS:
        os.makedirs(os.path.join(root, "samples", cam), exist_ok=True)
        files[cam] = [jpeg_bytes(camera_image(rng, hw), NUSC_JPEG_QUALITY)
                      for _ in range(NUSC_CAM_VARIANTS)]
    lidar = {sd["token"]: sd for sd in tables["sample_data"]}
    written = {}
    for scene in tables["scene"]:
        name = scene["name"]
        for cam, yaw, mount, focal in NUSC_CAMERAS:
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            f = focal * w / NUSC_CAM_HW[1]
            tables["calibrated_sensor"].append({
                "token": "{}_cs_{}".format(name, cam),
                "sensor_token": cam.lower(), "translation": list(mount),
                "rotation": _mat_quat(rot @ base),
                "camera_intrinsic": [[f, 0.0, w / 2], [0.0, f, h / 2],
                                     [0.0, 0.0, 1.0]]})
        frames = [smp for smp in tables["sample"]
                  if smp["scene_token"] == scene["token"]]
        for k, smp in enumerate(frames):
            key = lidar[smp["data"]["LIDAR_TOP"]]
            for cam, *_ in NUSC_CAMERAS:
                tok = "{}_{}".format(key["token"], cam)
                fname = "samples/{}/{}.jpg".format(cam, tok)
                place_file(os.path.join(root, fname),
                           files[cam][k % NUSC_CAM_VARIANTS], written)
                tables["sample_data"].append({
                    "token": tok, "sample_token": smp["token"],
                    "ego_pose_token": key["ego_pose_token"],
                    "calibrated_sensor_token": "{}_cs_{}".format(name, cam),
                    "timestamp": key["timestamp"], "filename": fname,
                    "fileformat": "jpg", "is_key_frame": True,
                    "height": h, "width": w, "prev": "", "next": ""})
                smp["data"][cam] = tok
    tables["sensor"] += [{"token": cam.lower(), "channel": cam,
                          "modality": "camera"}
                         for cam, *_ in NUSC_CAMERAS]


APOLLO_HW = (1080, 1920)    # Apollo synthetic 3D-lane images, h x w
APOLLO_LANES = (-5.4, -1.8, 1.8, 5.4)   # lane lines' lateral offsets, m
APOLLO_VARIANTS = 2         # distinct images, in turn over frames


def apollo_tree(root, train, val, seed=SEED, hw=APOLLO_HW):
    """An Apollo 3D-lane tree under root: standard/{train,test}.json (one
    json a line: raw_file, laneLines of [K, 3] ego-space points from 3 to
    103 m ahead at APOLLO_LANES' offsets, gently curved and some cut
    short, cam_intrinsics) and images/<split>_<i>.jpg, APOLLO_VARIANTS
    baseline JPEGs at hw written once and hard-linked in turn. -> {split:
    list of annotations}."""
    import json

    import numpy as np
    rng = np.random.default_rng([seed, 13])
    for sub in ("images", "standard"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    files = [jpeg_bytes(camera_image(rng, hw), NUSC_JPEG_QUALITY)
             for _ in range(APOLLO_VARIANTS)]
    out, written = {}, {}
    for split, frames in (("train", train), ("test", val)):
        annos = []
        for i in range(frames):
            raw = "images/{}_{:04d}.jpg".format(split, i)
            place_file(os.path.join(root, raw), files[i % APOLLO_VARIANTS],
                       written)
            bend = rng.uniform(-2e-3, 2e-3)
            lanes = []
            for y0 in APOLLO_LANES:
                x = np.arange(3.0, rng.uniform(60.0, 103.0), 2.0)
                y = y0 + bend * x * x + rng.uniform(-0.1, 0.1)
                z = 0.01 * x + rng.uniform(-0.05, 0.05, len(x))
                lanes.append(np.stack([x, y, z], 1).round(3).tolist())
            annos.append({"raw_file": raw, "laneLines": lanes,
                          "cam_intrinsics": [[2015.0, 0.0, hw[1] / 2],
                                             [0.0, 2015.0, hw[0] / 2],
                                             [0.0, 0.0, 1.0]]})
        with open(os.path.join(root, "standard", split + ".json"),
                  "w") as f:
            f.write("\n".join(json.dumps(a) for a in annos) + "\n")
        out[split] = annos
    return out



def _yaw_quat(yaw):
    import numpy as np
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _nusc_scene(rng, name, frames, t0, n, tables, root):
    """One scene of a nuScenes tree: `frames` key frames at 2 Hz, each
    after NUSC_SWEEPS sweeps at 20 Hz (the first key frame's too), one
    LIDAR_TOP chain; two instances a lane on 15 lanes 6 m apart, each lane
    one class (every class at least once) moving along x at its speed
    (+-20 %), so that the annotations' finite differences give the
    instance's velocity; every sweep's points from bench.make_scans in its
    own lidar frame, NUSC_SURFACE of them moved onto the objects' boxes at
    its time. Appends to tables; -> the lidar-frame boxes of each key
    frame."""
    import numpy as np

    import bench
    from paddle3d_tpu_torch.utils.transform3d import (
        invert_transform, make_transform, quat_inverse, quat_multiply,
        quat_yaw)
    _, _, (lo, hi), _ = bench.MODELS["centerpoint"]
    zg = lo[2] + 0.28 * (hi[2] - lo[2])         # make_scans' ground plane
    cs = {"token": name + "_cs", "sensor_token": "lidar_top",
          "translation": [0.943713, 0.0, -zg],
          "rotation": _yaw_quat(NUSC_LIDAR_YAW), "camera_intrinsic": []}
    tables["calibrated_sensor"].append(cs)
    classes = list(NUSC_CLASSES)
    lanes = np.arange(-42.0, 43.0, 6.0)
    inst = []
    for i, y in enumerate(lanes):
        cls = classes[i % len(classes)] if i < len(classes) else \
            classes[int(rng.integers(0, len(classes)))]
        cat, size, speed = NUSC_CLASSES[cls]
        sign = 1.0 if i % 2 else -1.0
        v = sign * speed * rng.uniform(0.8, 1.2)
        x0 = -sign * rng.uniform(30.0, 40.0)
        for j in range(2):
            inst.append({"token": "{}_inst{}_{}".format(name, i, j),
                         "cls": cls, "cat": cat, "size": size,
                         "x0": x0 + sign * 22.0 * j,
                         "y": y + rng.uniform(-0.5, 0.5), "v": v,
                         "yaw": (0.0 if sign > 0 else np.pi) +
                         rng.uniform(-0.05, 0.05)})
    times = [t0 + 0.05 * k for k in range(NUSC_SWEEPS * frames + 1)]

    def ego(t):
        t = t - t0
        return [2.0 * t, 0.05 * t * t, 0.0], _yaw_quat(0.02 * t)

    def boxes_at(t, lidar_from_global, q_ref):
        """Instance boxes at t in the lidar frame of q_ref / the transform:
        [G, 7] (x, y, z bottom, w, l, h, yaw), as the dataset computes."""
        out = []
        for o in inst:
            cg = np.array([o["x0"] + o["v"] * (t - t0), o["y"],
                           o["size"][2] / 2])
            cl = lidar_from_global[:3, :3] @ cg + lidar_from_global[:3, 3]
            q = quat_multiply(q_ref, _yaw_quat(o["yaw"]))
            out.append([cl[0], cl[1], cl[2] - o["size"][2] / 2,
                        *o["size"], quat_yaw(q)])
        return np.asarray(out, np.float32)

    sd_tokens, key = [], {}
    for k, t in enumerate(times):
        is_key = k >= NUSC_SWEEPS and (k - NUSC_SWEEPS) % NUSC_SWEEPS == 0
        tok = "{}_sd{:03d}".format(name, k)
        ts = int(round(t * 1e6))
        trans, rot = ego(t)
        tables["ego_pose"].append({"token": tok + "_ep", "timestamp": ts,
                                   "translation": trans, "rotation": rot})
        lidar_from_global = invert_transform(
            make_transform(trans, rot) @ make_transform(
                cs["translation"], cs["rotation"]))
        q_ref = quat_multiply(quat_inverse(cs["rotation"]),
                              quat_inverse(rot))
        boxes = boxes_at(t, lidar_from_global, q_ref)
        scan = bench.make_scans(rng, 1, n, lo, hi, "clustered")[0]
        scan[:, 4] = rng.integers(0, 32, n)     # the ring index column
        m = int(NUSC_SURFACE * n)
        which = rng.integers(0, len(boxes), m)
        scan[:m, :4] = surface_points(rng, boxes, m, which)
        kind = "samples" if is_key else "sweeps"
        fname = "{}/LIDAR_TOP/{}.pcd.bin".format(kind, tok)
        scan.astype(np.float32).tofile(os.path.join(root, fname))
        sd_tokens.append(tok)
        tables["sample_data"].append({
            "token": tok, "ego_pose_token": tok + "_ep",
            "calibrated_sensor_token": cs["token"], "timestamp": ts,
            "filename": fname, "fileformat": "pcd", "is_key_frame": is_key,
            "prev": sd_tokens[-2] if k else "", "next": ""})
        if k:
            tables["sample_data"][-2]["next"] = tok
        if is_key:
            key[len(key)] = (tok, ts, boxes,
                             np.bincount(which, minlength=len(boxes)))
    samples = ["{}_s{:02d}".format(name, f) for f in range(frames)]
    for sd in tables["sample_data"]:
        if sd["token"].startswith(name + "_"):
            k = int(sd["token"][-3:])
            f = min(frames - 1, max(0, (k - 1) // NUSC_SWEEPS))
            sd["sample_token"] = samples[f]
    tables["scene"].append({
        "token": name, "name": name, "nbr_samples": frames,
        "first_sample_token": samples[0], "last_sample_token": samples[-1]})
    for f, tok in enumerate(samples):
        sd, ts, _, _ = key[f]
        tables["sample"].append({
            "token": tok, "timestamp": ts, "scene_token": name,
            "prev": samples[f - 1] if f else "",
            "next": samples[f + 1] if f + 1 < frames else "",
            "data": {"LIDAR_TOP": sd}})
    for o in inst:
        anns = ["{}_ann{:02d}".format(o["token"], f) for f in range(frames)]
        tables["instance"].append({
            "token": o["token"], "category_token": o["cat"],
            "nbr_annotations": frames, "first_annotation_token": anns[0],
            "last_annotation_token": anns[-1]})
        moving = o["v"] != 0.0
        attr = {"car": "vehicle", "truck": "vehicle", "bus": "vehicle",
                "trailer": "vehicle", "construction_vehicle": "vehicle",
                "motorcycle": "cycle", "bicycle": "cycle",
                "pedestrian": "pedestrian"}.get(o["cls"])
        attr = [] if attr is None else [{
            "vehicle": ("vehicle.moving", "vehicle.parked"),
            "cycle": ("cycle.with_rider", "cycle.without_rider"),
            "pedestrian": ("pedestrian.moving", "pedestrian.standing")}[
                attr][0 if moving else 1]]
        for f, tok in enumerate(anns):
            t = times[NUSC_SWEEPS * (f + 1)]
            hits = int(key[f][3][inst.index(o)])
            tables["sample_annotation"].append({
                "token": tok, "sample_token": samples[f],
                "instance_token": o["token"],
                "translation": [o["x0"] + o["v"] * (t - t0), o["y"],
                                o["size"][2] / 2],
                "size": list(o["size"]),
                "rotation": _yaw_quat(o["yaw"]),
                "num_lidar_pts": hits, "num_radar_pts": 0,
                "attribute_tokens": attr, "visibility_token": "4",
                "prev": anns[f - 1] if f else "",
                "next": anns[f + 1] if f + 1 < frames else ""})
    return {samples[f]: key[f][2] for f in range(frames)}


def nuscenes_tree(root, train=NUSC_TRAIN, val=NUSC_VAL, seed=SEED,
                  points=NUSC_SWEEP_POINTS, version="v1.0-trainval",
                  cameras=None, maps=None):
    """A nuScenes tree under root: the v1.0 tables of a train and a val
    scene (_nusc_scene: `train` and `val` key frames, each after
    NUSC_SWEEPS sweeps of `points` five-column points over the
    CenterPoint-nuScenes range, objects of the ten detection classes with
    velocities) and splits/{train,val}.txt; with cameras = (h, w), the six
    cameras of every key frame (_nusc_cameras: JPEGs at that size); with
    maps = (h, w), a BEV map npz a key frame under maps_bev/ (three random
    occupancy masks, NuscenesMVSegDataset's layout). -> {sample token:
    [G, 7] lidar-frame boxes}."""
    import json

    import numpy as np
    rng = np.random.default_rng(seed)
    for sub in (version, "splits", "samples/LIDAR_TOP", "sweeps/LIDAR_TOP"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    tables = {k: [] for k in (
        "scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
        "sample_annotation", "instance")}
    tables["sensor"] = [{"token": "lidar_top", "channel": "LIDAR_TOP",
                         "modality": "lidar"}]
    tables["category"] = [{"token": cat, "name": cat}
                          for cat, _, _ in NUSC_CLASSES.values()]
    tables["attribute"] = [{"token": a, "name": a} for a in (
        "vehicle.moving", "vehicle.parked", "vehicle.stopped",
        "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
        "pedestrian.standing")]
    written = {}
    for split, frames, t0 in (("train", train, 100.0), ("val", val, 500.0)):
        name = "scene-{}".format(split)
        written.update(_nusc_scene(rng, name, frames, t0, points, tables,
                                   root))
        with open(os.path.join(root, "splits", split + ".txt"), "w") as f:
            f.write(name + "\n")
    if cameras:
        _nusc_cameras(tables, root, cameras, seed)
    if maps:
        mrng = np.random.default_rng([seed, 11])
        os.makedirs(os.path.join(root, "maps_bev"), exist_ok=True)
        for tok in written:
            np.savez(os.path.join(root, "maps_bev", tok + ".npz"),
                     (mrng.random(tuple(maps) + (3,)) < 0.2).astype(
                         np.uint8))
    for k, rows in tables.items():
        with open(os.path.join(root, version, k + ".json"), "w") as f:
            json.dump(rows, f)
    return written


def waymo_tree(root, train=WAYMO_TRAIN, val=WAYMO_VAL, seed=SEED,
               points=WAYMO_POINTS):
    """A converted Waymo tree under root: {mode}_infos.pkl and
    points/{id}.npy, each scan `points` bench.make_scans points over
    iassd_waymo.yml's range (x, y, z, intensity), 10-20 vehicles, 4-8
    pedestrians and 2-5 cyclists in distinct cells of a 10 m grid
    (jittered 1 m, any yaw, Waymo's mean sizes within 5 %), RT_SURFACE of
    the points moved onto them; num_points_in_gt counts them.
    -> {frame id: [G, 7] boxes}."""
    import pickle

    import numpy as np

    import bench
    lo = np.array([-75.2, -75.2, -2.0, 0.0], np.float32)
    hi = np.array([75.2, 75.2, 4.0, 1.0], np.float32)
    zg = lo[2] + 0.28 * (hi[2] - lo[2])
    cells = [(x, y) for x in range(-60, 61, 10) for y in range(-60, 61, 10)
             if abs(x) + abs(y) > 0]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "points"), exist_ok=True)
    written = {}
    for split, frames in (("train", train), ("val", val)):
        infos = []
        for f in range(frames):
            fid = "{}_{:04d}".format(split, f)
            counts = [int(rng.integers(10, 21)), int(rng.integers(4, 9)),
                      int(rng.integers(2, 6))]
            labels = np.repeat(np.arange(3), counts).astype(np.int32)
            g = len(labels)
            xy = np.asarray(cells, np.float32)[
                rng.permutation(len(cells))[:g]] + rng.uniform(-1, 1, (g, 2))
            size = np.asarray([list(WAYMO_SIZES.values())[c]
                               for c in labels]) * rng.uniform(0.95, 1.05,
                                                               (g, 3))
            boxes = np.c_[xy, np.full(g, zg), size,
                          rng.uniform(-np.pi, np.pi, g)].astype(np.float32)
            scan = bench.make_scans(rng, 1, points, lo, hi, "clustered")[0]
            k = int(RT_SURFACE * points)
            which = rng.integers(0, g, k)
            scan[:k] = surface_points(rng, boxes, k, which)
            fname = "points/{}.npy".format(fid)
            np.save(os.path.join(root, fname), scan.astype(np.float32))
            infos.append({"lidar_file": fname, "boxes": boxes,
                          "labels": labels, "frame_id": fid,
                          "num_points_in_gt": np.bincount(which,
                                                          minlength=g)})
            written[fid] = boxes
        with open(os.path.join(root, "{}_infos.pkl".format(split)),
                  "wb") as f:
            pickle.dump(infos, f)
    return written


def lidar_dic(path, root):
    """The config at path (its _base_ chain resolved) with both datasets'
    dataset_root at root and its SamplingDatabase's database_root and
    database_anno_path moved under root as they sit under the config's
    own root. -> the dic."""
    from paddle3d_tpu_torch.apis import Config
    dic = Config(path=path, device="cpu").dic
    for split in ("train_dataset", "val_dataset"):
        old = dic[split]["dataset_root"]
        dic[split]["dataset_root"] = root
        for t in dic[split].get("transforms") or []:
            if t["type"] == "SamplingDatabase":
                t["database_anno_path"] = os.path.join(root, os.path.relpath(
                    t["database_anno_path"], old))
                t["database_root"] = os.path.join(root, os.path.relpath(
                    t["database_root"], old))
    return dic


def write_yaml(dic, path):
    """dic as a YAML file (no _base_) that Config(path) reads back."""
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(dic, f, sort_keys=False)
    return path


def runtime_config(root, device):
    """The KITTI car config with both datasets' dataset_root at root, built
    through Config(dic=...) on device."""
    from paddle3d_tpu_torch.apis import Config
    dic = Config(path=KITTI, device=device).dic
    for split in ("train_dataset", "val_dataset"):
        dic[split]["dataset_root"] = root
    return Config(dic=dic, device=device)


def runtime_trainer(cfg, save_dir, iters, **kw):
    """A Trainer of cfg as tools/train.py builds it, with an EMA."""
    from paddle3d_tpu_torch.apis import Trainer
    kw.setdefault("dataloader_fn", {"num_workers": RT_WORKERS})
    return Trainer(model=cfg.model, optimizer=cfg.optimizer,
                   lr_scheduler=cfg.lr_scheduler, iters=iters,
                   train_dataset=cfg.train_dataset,
                   val_dataset=cfg.val_dataset, batch_size=cfg.batch_size,
                   save_dir=save_dir, ema_decay=RT_EMA, **kw)


def runtime_launches(model, rows):
    """The launches of one KITTI train step and of one forward on batches
    of `rows` rows a scan, by the JAX package's density rule (a scan is
    dense by its row count, padding included): a step runs K1, K3, K4 and
    the scatter's VJP K5 once, and K7 (dense) or K2; a forward K1 and K6
    (dense) or K2. -> (train, serve) dicts."""
    from paddle3d_tpu_torch.ops.sorted_scatter import is_dense_scan, \
        kernel_for
    me = model.middle_encoder
    cells = me.ny * me.nx
    train = {"fused_pfn_rows": 1, "pfn_stats": 1, "pfn_bwd": 1,
             "sorted_table_gather": 1, kernel_for(rows, cells): 1}
    serve = {"fused_pfn_rows": 1,
             "sorted_segment_sum_cm" if is_dense_scan(rows, cells)
             else "sorted_segment_sum": 1}
    return train, serve


def counts_sub(a, b):
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)
            if a.get(k, 0) - b.get(k, 0)}


@contextlib.contextmanager
def counted_evals(trainer):
    """Split the launch counters of a Trainer run: -> a dict that the block
    fills with the launches its evaluate() calls made ("serve") and the
    number of those calls ("evals")."""
    from paddle3d_tpu_torch.ops import _build
    serve = {"evals": 0, "serve": {}}
    orig = trainer.evaluate

    def evaluate(*args, **kw):
        before = dict(_build.LAUNCHES)
        out = orig(*args, **kw)
        serve["evals"] += 1
        for k, v in counts_sub(_build.LAUNCHES, before).items():
            serve["serve"][k] = serve["serve"].get(k, 0) + v
        serve["metrics"] = out
        return out
    trainer.evaluate = evaluate
    try:
        yield serve
    finally:
        del trainer.evaluate


@contextlib.contextmanager
def recorded_waits():
    """-> list of each Trainer step's reader wait in s (Timer's bracket)."""
    from paddle3d_tpu_torch.apis import trainer as trainer_mod
    waits = []

    class WaitTimer(trainer_mod.Timer):
        def after_reader(self):
            waits.append(time.time() - self._reader_t0)
            super().after_reader()
    with mock.patch.object(trainer_mod, "Timer", WaitTimer):
        yield waits


@contextlib.contextmanager
def recorded_losses(trainer):
    """-> list of each train step's loss tensor (no host sync a step)."""
    losses = []
    step = trainer._train_step

    def rec(*args):
        out = step(*args)
        losses.append((out[0] if isinstance(out, tuple) else out)["loss"])
        return out
    trainer._train_step = rec
    try:
        yield losses
    finally:
        trainer._train_step = step


def same_state(a, b):
    """Two nested state dicts (tensors compared by bit pattern, the rest by
    ==): -> the keys that differ."""
    import torch
    bad = []

    def walk(x, y, path):
        if isinstance(x, dict):
            if set(x) != set(y):
                bad.append(path + " keys")
            for k in x:
                if k in y:
                    walk(x[k], y[k], "{}.{}".format(path, k))
        elif isinstance(x, (list, tuple)):
            if len(x) != len(y):
                bad.append(path + " length")
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, "{}[{}]".format(path, i))
        elif isinstance(x, torch.Tensor):
            if not (x.shape == y.shape and x.dtype == y.dtype and (
                    same_bits(x.cpu(), y.cpu()) if x.is_floating_point()
                    else torch.equal(x.cpu(), y.cpu()))):
                bad.append(path)
        elif x != y:
            bad.append(path)
    walk(a, b, "")
    return bad


def gt_round_trip(model, dataset):
    """The val split's ground truths handed as the model's outputs (score
    1, -1 padded) through postprocess_to_samples into the dataset's
    KittiMetric: -> its AP dict."""
    import numpy as np
    samples = [dataset[i] for i in range(len(dataset))]
    g = max(len(s.bboxes_3d) for s in samples)
    b = len(samples)
    boxes = np.zeros((b, g, 7), np.float32)
    scores = np.full((b, g), -1.0, np.float32)
    labels = np.full((b, g), -1, np.int32)
    for i, s in enumerate(samples):
        n = len(s.bboxes_3d)
        boxes[i, :n] = np.asarray(s.bboxes_3d)
        scores[i, :n] = 1.0
        labels[i, :n] = s.labels
    _, metas = dataset.collate_fn(samples)
    metric = dataset.metric
    metric.update(model.postprocess_to_samples(
        {"box3d_lidar": boxes, "scores": scores, "label_preds": labels},
        metas))
    return metric.compute()


def eval_parts(trainer):
    """evaluate() with its parts timed on the host clock: the eval step
    (ended by a synchronize: the device forward), postprocess_to_samples
    and the metric (the val dataset's: update and compute). -> (metrics,
    {part: s}, wall s)."""
    import torch
    metric_cls = type(trainer.val_dataset.metric)
    parts = {"forward": 0.0, "postprocess": 0.0, "metric": 0.0}

    def timed(part, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if part == "forward":
                torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            return out
        return call
    model = trainer.model
    with mock.patch.object(trainer, "_eval_step",
                           timed("forward", trainer._eval_step)), \
            mock.patch.object(model, "postprocess_to_samples", timed(
                "postprocess", model.postprocess_to_samples)), \
            mock.patch.object(metric_cls, "update", timed(
                "metric", metric_cls.update)), \
            mock.patch.object(metric_cls, "compute", timed(
                "metric", metric_cls.compute)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.evaluate()
        wall = time.perf_counter() - t0
    return metrics, parts, wall


def bare_batches(dataset, batch_size, n, device):
    """The first n collated batches of a shuffled loader over dataset
    (epoch 0, as the Trainer's first), on the host and on the device."""
    from paddle3d_tpu_torch.apis import DataLoader
    from paddle3d_tpu_torch.apis.trainer import to_device
    loader = iter(DataLoader(dataset, batch_size=batch_size, shuffle=True,
                             drop_last=True, num_workers=RT_WORKERS))
    host = [next(loader)[0] for _ in range(n)]
    loader.close()
    return host, [to_device(b, device) for b in host]


def windowed_trainer_run(trainer, prof=None, warm=RT_WARM, timed=RT_TIMED):
    """trainer.train() for warm + timed + 1 more steps, inside the first
    epoch of the run's loader (its split holds more batches), the
    checkpoint write stubbed. The window runs from the entry of step warm
    to the entry of step warm + timed, with a synchronize at both ends and
    prof (a torch.profiler.profile) on over it: it holds no epoch start and
    no loader shutdown. -> (scans/s in the window, window seconds, the
    reader wait of each step of the run in s, the host time of each step
    call in the window in s)."""
    import torch
    steps = warm + timed + 1
    check(len(trainer.train_dataloader) >= steps,
          "the timing split holds {} batches, a run needs {}".format(
              len(trainer.train_dataloader), steps))
    start, stamps, host = trainer.cur_iter, [], []
    step = trainer._train_step

    def stamped(*args):
        if trainer.cur_iter - start in (warm, warm + timed):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if prof is not None:
                (prof.start if len(stamps) == 1 else prof.stop)()
        t0 = time.perf_counter()
        out = step(*args)
        if len(stamps) == 1:
            host.append(time.perf_counter() - t0)
        return out
    trainer.iters = start + steps
    with recorded_waits() as waits, \
            mock.patch.object(trainer, "_train_step", stamped), \
            mock.patch.object(trainer, "_save_checkpoint", lambda: None):
        trainer.train()
    torch.cuda.synchronize()
    secs = stamps[1] - stamps[0]
    return timed * trainer.batch_size / secs, secs, waits, host


def timed_bare_steps(trainer, batches):
    """The Trainer's own step (EMA included) over device batches, host
    clock with synchronizes: -> (scans/s, the host time of each step call
    in s)."""
    import torch
    step, ema = trainer._train_step, trainer.ema_params
    host = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        t1 = time.perf_counter()
        step(trainer.model, trainer.optimizer, ema, b, RT_EMA)
        host.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    return (len(batches) * trainer.batch_size /
            (time.perf_counter() - t0)), host


class Prebuilt:
    """A loader over batches built beforehand: the Trainer's loop with no
    loader work on the host beside the step."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return ((b, []) for b in self.batches)


def loader_alone(dataset, batch_size, workers):
    """A shuffled DataLoader over dataset with nothing else on the host:
    scans/s from batch RT_WARM to batch RT_WARM + RT_TIMED of its first
    epoch (the pool's own rate; the consumer takes each batch at once)."""
    from paddle3d_tpu_torch.apis import DataLoader
    loader = iter(DataLoader(dataset, batch_size=batch_size, shuffle=True,
                             drop_last=True, num_workers=workers))
    for _ in range(RT_WARM):
        next(loader)
    t0 = time.perf_counter()
    for _ in range(RT_TIMED):
        next(loader)
    secs = time.perf_counter() - t0
    loader.close()
    return RT_TIMED * batch_size / secs


def nan_vs_out_of_range(trainer, host_batch):
    """One kernel-path train step on a collated batch (NaN padding to
    max_points) and on the same batch with its padding rows moved out of
    range (x = 1000 m), from one saved state in deterministic mode:
    -> (NaN step, out-of-range step) as record_step gives them."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import make_train_step
    from paddle3d_tpu_torch.apis.trainer import to_device
    pts = host_batch["data"]
    far = np.where(np.isnan(pts), np.float32(0), pts)
    far[np.isnan(pts[..., 0]), 0] = 1000.0
    check(np.isnan(pts[..., 0]).sum() > 0, "the batch has no NaN padding")
    step = make_train_step(lr_scheduler=trainer.lr_scheduler)
    model, opt = trainer.model, trainer.optimizer
    restore = saved_state(model, opt, trainer.lr_scheduler)
    out = []
    with deterministic():
        for data in (pts, far):
            out.append(record_step(step, model, opt, to_device(
                dict(host_batch, data=data), trainer.device)))
            restore()
    torch.cuda.synchronize()
    return out


def cli_runs(tmp, root):
    """Start, in a thread, `python -m paddle3d_tpu_torch.tools.train
    --iters 4` on the KITTI car config pointed at root (a YAML with
    `_base_` on it), then `tools.evaluate` on its checkpoint, as
    subprocesses. -> finish(), which joins them, logs them and checks that
    both exited 0 and that the kernel library was loaded, not rebuilt."""
    import threading

    from paddle3d_tpu_torch.ops import _build
    yml = os.path.join(tmp, "kitti_tree.yml")
    with open(yml, "w") as f:
        f.write("_base_: {}\ntrain_dataset:\n  dataset_root: {}\n"
                "val_dataset:\n  dataset_root: {}\n".format(KITTI, root,
                                                            root))
    lib = _build._lib_path(sorted(_build.CSRC.glob("*.cu")) +
                           sorted(_build.CSRC.glob("*.cuh")))
    before = (sorted(os.listdir(_build.BUILD_DIR)), os.stat(lib).st_mtime_ns)
    cli = os.path.join(tmp, "cli")
    runs = [("train", ["--iters", "4", "--save_dir", cli, "--save_interval",
                       "2", "--log_interval", "2", "--seed", str(SEED)]),
            ("evaluate", ["--model", os.path.join(cli, "checkpoints",
                                                  "iter_4")])]
    done = []

    def run():
        for tool, args in runs:
            t0 = time.perf_counter()
            done.append((tool, args, subprocess.run(
                [sys.executable, "-m", "paddle3d_tpu_torch.tools." + tool,
                 "--config", yml] + args, cwd=REPO, capture_output=True,
                text=True, timeout=300), time.perf_counter() - t0))
            if done[-1][2].returncode:
                return
    thread = threading.Thread(target=run)
    thread.start()

    def finish():
        thread.join()
        for tool, args, res, secs in done:
            tail = [line.split("\t")[-1] for line in res.stdout.splitlines()
                    if "[TRAIN]" in line or "results" in line]
            log("  python -m paddle3d_tpu_torch.tools.{} ... {}: exit {} in "
                "{:.1f} s; {}".format(tool, " ".join(args[:2]),
                                      res.returncode, secs, tail[-2:]))
            check(res.returncode == 0, "tools.{} exited {}: {}".format(
                tool, res.returncode, res.stderr[-2000:]))
        check(len(done) == 2, "the CLI ran {} of 2 tools".format(len(done)))
        after = (sorted(os.listdir(_build.BUILD_DIR)),
                 os.stat(lib).st_mtime_ns)
        check(after == before, "the CLI rebuilt the kernels")
        log("  the CLI loaded {} from the build directory (not rebuilt)"
            .format(os.path.relpath(str(lib), REPO)))
    return finish


def phase_runtime(device, beside=None):
    """Phase 27: the runtime's LiDAR path, tools/train.py's: Config ->
    Trainer -> DataLoader -> KittiPCDataset -> transforms -> collate_lidar
    -> train step -> Checkpoint -> evaluate -> postprocess_to_samples ->
    KittiMetric, on a KITTI tree in a temp dir; resume, the NaN padding,
    the CLI (in subprocesses beside the checks, joined before anything is
    timed), and what the runtime costs."""
    import tempfile

    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Trainer
    from paddle3d_tpu_torch.apis.trainer import to_device
    from paddle3d_tpu_torch.ops import _build
    t_phase = time.perf_counter()

    def since():
        return "[+{:.1f} s]".format(time.perf_counter() - t_phase)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "KITTI")
        written = kitti_tree(root)
        cfg = runtime_config(root, device)
        log("phase 27: runtime: KITTI tree of {} + {} frames ({} cars) in "
            "{:.1f} s; Config(dic=...) of {}, batch {}, {} loader threads"
            .format(RT_TRAIN, RT_VAL, sum(map(len, written.values())),
                    time.perf_counter() - t_phase,
                    os.path.relpath(KITTI, REPO), cfg.batch_size,
                    RT_WORKERS))
        finish_cli = cli_runs(tmp, root)
        # cuDNN as tools/train.py leaves it (torch's defaults): no
        # autotuning, whose trial workspaces would count in the peak
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False
        torch.manual_seed(SEED)
        out = os.path.join(tmp, "out")
        t1 = runtime_trainer(cfg, out, RT_ITERS, save_interval=RT_ITERS // 2,
                             log_interval=RT_ITERS // 2, do_eval=True)
        check(len(t1.train_dataloader) == RT_TRAIN // cfg.batch_size,
              "loader length")
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        with counted_evals(t1) as evals, recorded_losses(t1) as losses, \
                recorded_waits() as waits:
            t1.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = dict(_build.LAUNCHES)
        losses = [v.item() for v in losses]
        main_waits = list(waits)
        peak = torch.cuda.max_memory_allocated() / 2**20
        trained = counts_sub(total, evals["serve"])
        forwards = evals["evals"] * -(-RT_VAL // cfg.batch_size)
        rows = t1.train_dataset.max_points
        step_launches, forward_launches = runtime_launches(t1.model, rows)
        want_train = {k: v * RT_ITERS for k, v in step_launches.items()}
        want_serve = {k: v * forwards for k, v in forward_launches.items()}
        log("  collate_lidar pads a scan to {:,} rows: dense by the density "
            "rule, so a step scatters on {} and a forward on {}".format(
                rows, [k for k in step_launches if "segment" in k][0],
                [k for k in forward_launches if "segment" in k][0]))
        log("  {} Trainer: {} steps, {} evaluate() calls ({} forwards) in "
            "{:.2f} s (the CLI beside it); launches: train {} (want {}), "
            "serve {} (want {}); peak device memory {:.1f} MiB".format(
                since(), t1.cur_iter, evals["evals"], forwards, wall,
                trained, want_train, evals["serve"], want_serve, peak))
        log("  loss per step: {}".format([round(v, 4) for v in losses]))
        check(t1.cur_iter == RT_ITERS and len(losses) == RT_ITERS,
              "the Trainer ran {} steps".format(t1.cur_iter))
        check(trained == want_train and evals["serve"] == want_serve,
              "launch counts off the expected ones")
        check(all(np.isfinite(losses)), "non-finite train loss")
        head, tail = np.mean(losses[:4]), np.mean(losses[-4:])
        check(tail < head, "the loss did not fall: mean of the last four "
              "steps {:.4f} against the first four's {:.4f}".format(
                  tail, head))
        queue = t1.checkpoint.queue
        rec = {k: t1.checkpoint.get_record(k)
               for k in ("iters", "train_by_epoch", "ema_step")}
        log("  mean loss of the first four steps {:.4f}, of the last four "
            "{:.4f}; checkpoint queue {}, records {}".format(
                head, tail, queue, rec))
        check(queue == ["iter_{}".format(RT_ITERS // 2),
                        "iter_{}".format(RT_ITERS)], "checkpoint queue")
        check(rec == {"iters": RT_ITERS, "train_by_epoch": False,
                      "ema_step": RT_ITERS}, "checkpoint records")
        check(evals["evals"] == 2, "do_eval ran {} evaluations".format(
            evals["evals"]))
        log("  AP at iteration {} (EMA weights): {}".format(
            RT_ITERS, {k: round(v, 4) for k, v in
                       evals["metrics"].items()}))

        # resume: a second Trainer on other random weights
        torch.manual_seed(SEED + 1)
        cfg2 = runtime_config(root, device)
        t2 = runtime_trainer(cfg2, out, RT_ITERS, resume=True)
        bad = (same_state(t1.model.state_dict(), t2.model.state_dict()) +
               same_state(t1.optimizer.state_dict(),
                          t2.optimizer.state_dict()) +
               same_state(t1.lr_scheduler.state_dict(),
                          t2.lr_scheduler.state_dict()) +
               same_state(t1.ema_params, t2.ema_params))
        lr1 = t1.optimizer.param_groups[0]["lr"]
        lr2 = t2.optimizer.param_groups[0]["lr"]
        sched = cfg._schedule()
        want_lr = sched.learning_rate * sched.factor(RT_ITERS)
        log("  {} resume from {}: model, optimizer moments, LR schedule "
            "(last_epoch {}) and EMA bit-equal: {}; rate at step {} {!r} "
            "(uninterrupted {!r}, StepDecay {!r}); ema_step {}".format(
                since(), t2.checkpoint.queue[-1], t2.lr_scheduler.last_epoch,
                not bad, RT_ITERS, lr2, lr1, want_lr, t2.ema_step))
        check(not bad, "resumed state differs: {}".format(bad[:8]))
        check(t2.cur_iter == RT_ITERS and t2.ema_step == RT_ITERS,
              "resumed counters")
        check(lr2 == lr1 == want_lr and t2.lr_scheduler.last_epoch ==
              RT_ITERS, "resumed rate")
        del t2, cfg2

        # the ground truths given back score 100
        rt = gt_round_trip(t1.model, t1.val_dataset)
        keys = ["Car {} easy AP_R{}".format(m, r) for m in ("3d", "bev")
                for r in (11, 40)]
        log("  val ground truths as predictions (score 1): {}".format(
            {k: rt[k] for k in keys}))
        check(all(rt[k] == 100.0 for k in keys),
              "the ground truths scored under 100 AP")

        # NaN padding against out-of-range padding, kernel path
        host, _ = bare_batches(t1.train_dataset, t1.batch_size, 1, device)
        nan_step, far_step = nan_vs_out_of_range(t1, host[0])
        diff = [k for k in nan_step[0] if nan_step[0][k] != far_step[0][k]]
        diff += [k for k in nan_step[1]
                 if not same_bits(nan_step[1][k], far_step[1][k])]
        diff += [k for k in nan_step[2]
                 if not same_bits(nan_step[2][k], far_step[2][k])]
        log("  {} NaN-padded step ({} of {} rows padding) vs out-of-range "
            "padding, deterministic mode: losses {} / {}, launches {}; "
            "losses, grads and running stats bit-equal (tolerance 0): {}"
            .format(since(), int(np.isnan(host[0]["data"][..., 0]).sum()),
                    host[0]["data"].shape[0] * host[0]["data"].shape[1],
                    {k: round(v, 6) for k, v in nan_step[0].items()},
                    {k: round(v, 6) for k, v in far_step[0].items()},
                    {k: v for k, v in nan_step[3].items() if v}, not diff))
        check(all(np.isfinite(list(nan_step[0].values()))),
              "non-finite loss on the NaN-padded batch")
        check(all(nan_step[3][k] for k in step_launches),
              "the NaN-padded step missed a kernel")
        check(not diff, "NaN and out-of-range padding differ: {}".format(
            diff[:8]))

        # the CLI's subprocesses end before anything is timed; beside them,
        # the next phase's untimed host work
        if beside is not None:
            beside()
        finish_cli()
        log("  {} the CLI joined".format(since()))

        # evaluate, in parts
        metrics, parts, ewall = eval_parts(t1)
        check(t1.model.training, "evaluate left the model in eval mode")
        log("  evaluate: {} val frames in {:.3f} s ({:.2f} frames/s): "
            "device forward {:.3f} s, postprocess {:.3f} s, metric {:.3f} "
            "s".format(RT_VAL, ewall, RT_VAL / ewall, parts["forward"],
                       parts["postprocess"], parts["metric"]))
        log("  AP: {}".format({k: round(v, 4) for k, v in metrics.items()}))

        # what the runtime costs, in windows inside one epoch of a larger
        # split: the Trainer at 4 and 1 loader threads and on prebuilt
        # batches against the bare step, in mirrored order, and the loader
        # alone
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        t_tree = time.perf_counter()
        timed_root = os.path.join(tmp, "KITTI_timed")
        kitti_tree(timed_root, train=RT_TIMED_TRAIN, val=1, seed=SEED + 1)
        timed_set = runtime_config(timed_root, device).train_dataset
        t_tree = time.perf_counter() - t_tree
        trainers = {w: Trainer(
            model=t1.model, optimizer=t1.optimizer,
            lr_scheduler=t1.lr_scheduler, iters=0, train_dataset=timed_set,
            batch_size=t1.batch_size,
            save_dir=os.path.join(tmp, "timed{}".format(w)),
            ema_decay=RT_EMA, log_interval=0, save_interval=0,
            dataloader_fn={"num_workers": w}) for w in (RT_WORKERS, 1)}
        host, dev = bare_batches(timed_set, t1.batch_size,
                                 RT_WARM + RT_TIMED + 1, device)
        trainers["prebuilt"] = Trainer(
            model=t1.model, optimizer=t1.optimizer,
            lr_scheduler=t1.lr_scheduler, iters=0, train_dataset=timed_set,
            batch_size=t1.batch_size, save_dir=os.path.join(tmp, "timedp"),
            ema_decay=RT_EMA, log_interval=0, save_interval=0)
        trainers["prebuilt"].train_dataloader = Prebuilt(host)
        timed_bare_steps(trainers[1], dev[:2])      # warm-up
        order = ("trainer4", "trainer1", "prebuilt", "bare", "bare",
                 "prebuilt", "trainer1", "trainer4")
        rates = {k: [] for k in order}
        waits = {k: [] for k in order}
        step_host = {k: [] for k in order}
        for path in order:
            if path == "bare":
                r, h = timed_bare_steps(trainers[1], dev[:RT_TIMED])
            else:
                r, _, w, h = windowed_trainer_run(trainers[
                    {"trainer4": RT_WORKERS, "trainer1": 1}.get(path, path)])
                waits[path].append(w)
            rates[path].append(r)
            step_host[path] += h
        rate = {k: 2 / sum(1 / x for x in v) for k, v in rates.items()}

        def ms(xs):
            return round(1e3 * float(np.mean(xs)), 3)
        # the main run fetched each epoch's batches and then, but for the
        # last epoch, the end of the epoch
        period = len(t1.train_dataloader) + 1
        alone = {w: loader_alone(timed_set, t1.batch_size, w)
                 for w in (RT_WORKERS, 1)}
        h2d = [cuda_ms(lambda: to_device(b, device), 5) for b in host[:3]]
        log("  {} timing split: {} train frames ({} steps an epoch) in "
            "{:.1f} s; windows of {} steps from step {} of a run, inside "
            "its loader's first epoch (no epoch start, no pool shutdown), "
            "cudnn.benchmark on, order t4/t1/prebuilt/bare/bare/prebuilt/t1/"
            "t4".format(
                since(), RT_TIMED_TRAIN, len(trainers[1].train_dataloader),
                t_tree, RT_TIMED, RT_WARM))
        log("  scans/s at batch {}: Trainer, {} loader threads {:.2f}, 1 "
            "thread {:.2f}, on prebuilt batches (no loader work) {:.2f}; "
            "bare make_train_step on {} batches of the split {:.2f} "
            "(runtime cost {:.1f} % at {} threads, {:.1f} % at 1, {:.1f} % "
            "prebuilt); halves {}".format(
                t1.batch_size, RT_WORKERS, rate["trainer4"],
                rate["trainer1"], rate["prebuilt"], RT_TIMED, rate["bare"],
                100 * (1 - rate["trainer4"] / rate["bare"]), RT_WORKERS,
                100 * (1 - rate["trainer1"] / rate["bare"]),
                100 * (1 - rate["prebuilt"] / rate["bare"]),
                {k: [round(x, 2) for x in v] for k, v in rates.items()}))
        log("  host time of a step call (the step's own launches), ms: "
            "Trainer {} threads {}, 1 thread {}, prebuilt {}, bare {}"
            .format(RT_WORKERS, ms(step_host["trainer4"]),
                    ms(step_host["trainer1"]), ms(step_host["prebuilt"]),
                    ms(step_host["bare"])))
        log("  reader wait a step, ms: in the windows, {} threads {}, 1 "
            "thread {}; at a run's first step (a cold epoch start) {} / "
            "{}; the main run's {} fetches: at its {} epoch starts {}, at "
            "the end of its first epoch (the pool's shutdown) {}, at the "
            "other steps {}".format(
                RT_WORKERS,
                [ms(w[RT_WARM + 1:RT_WARM + RT_TIMED + 1])
                 for w in waits["trainer4"]],
                [ms(w[RT_WARM + 1:RT_WARM + RT_TIMED + 1])
                 for w in waits["trainer1"]],
                [ms(w[:1]) for w in waits["trainer4"]],
                [ms(w[:1]) for w in waits["trainer1"]], len(main_waits),
                len(main_waits[::period]), ms(main_waits[::period]),
                ms(main_waits[period - 1::period]),
                ms([w for i, w in enumerate(main_waits)
                    if 0 < i % period < period - 1])))
        log("  the loader alone (nothing else on the host, batches {} to "
            "{} of an epoch): {} threads {:.2f} scans/s, 1 thread {:.2f}; "
            "host-to-device copy of a batch ({:.2f} MB) {} ms".format(
                RT_WARM, RT_WARM + RT_TIMED, RT_WORKERS, alone[RT_WORKERS],
                alone[1], sum(v.nbytes for v in host[0].values()) / 1e6,
                [round(v, 3) for v in h2d]))
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        _, secs, _, _ = windowed_trainer_run(trainers[RT_WORKERS], prof)
        log("  profile of a window of {} Trainer steps ({} threads):"
            .format(RT_TIMED, RT_WORKERS))
        log_profile(prof, secs * 1e3 / RT_TIMED, RT_TIMED)
        log("  phase 27 took {:.1f} s".format(time.perf_counter() - t_phase))


# --------------------------------------------------------------- phase 28
P28_WARM, P28_TIMED = 4, 3  # a leg's Trainer run: steps before its timed
                            # window (the loader's prefetch depth: the
                            # window's batches are built beside its steps)
                            # and in it; one more step ends the window
P28_KITTI = (32, 4)         # frames of the KITTI tree's train and val splits
P28_NUSC = (40, 4)          # key frames of the nuScenes tree's scenes
                            # (40: five batches of phase 30's BEVDet4D)
P28_WAYMO = (32, 4)         # frames of the Waymo tree's splits
P28_PASTE_CHECKS = 4        # train samples whose pastes are checked
CP_KITTI = os.path.join(REPO, "configs", "centerpoint",
                        "centerpoint_pillars_016voxel_kitti.yml")
IASSD_WAYMO = os.path.join(REPO, "configs", "iassd", "iassd_waymo.yml")
# a train step / forward of the point models (phases 8, 9, 11, 14): K9,
# K10, and PV-RCNN's K11 and sparse convs; the dense BEV's segment sum
# (by the density rule) and its VJP K5 are added from the run's shapes
PV_STEP = {"ball_query": 7, "farthest_point_sample": 1,
           "pairwise_intersection_area": 1, "sorted_table_gather": 1}
PV_FORWARD = {"ball_query": 7, "farthest_point_sample": 1,
              "sparse_conv3d": 8, "sparse_conv3d_map": 7}
IA_STEP = IA_FORWARD = {"ball_query": 10, "farthest_point_sample": 3}


@contextlib.contextmanager
def recorded_scatters():
    """-> list of (rows, cells) of each sorted_segment_sum call (the sparse
    stacks' dense BEV) in the block."""
    from paddle3d_tpu_torch.ops import sorted_scatter
    calls = []
    orig = sorted_scatter.sorted_segment_sum

    def rec(keys, rows, num_cells):
        calls.append((keys.shape[1], num_cells))
        return orig(keys, rows, num_cells)
    with mock.patch.object(sorted_scatter, "sorted_segment_sum", rec):
        yield calls


def pillar2_launches(model, rows):
    """A two-layer pillar model's (CenterPoint) train step and forward on
    batches of `rows` rows a scan, by the density rule: K12 both ways twice
    a step, the canvas's scatter (K7 dense / K2) and its VJP K5; a forward
    the two-layer K1 and K6 (dense) or K2. -> (step, forward) dicts."""
    from paddle3d_tpu_torch.ops.sorted_scatter import is_dense_scan, \
        kernel_for
    me = model.middle_encoder
    cells = me.ny * me.nx
    step = {"seg_window_max": 2, "seg_window_max_bwd": 2,
            "sorted_table_gather": 1, kernel_for(rows, cells): 1}
    forward = {"fused_pfn_rows_2l": 1,
               "sorted_segment_sum_cm" if is_dense_scan(rows, cells)
               else "sorted_segment_sum": 1}
    return step, forward


def with_scatters(base, scatters):
    """base plus one launch of the route the density rule gives each
    recorded (rows, cells) scatter."""
    from paddle3d_tpu_torch.ops.sorted_scatter import kernel_for
    out = dict(base)
    for n, cells in scatters:
        out[kernel_for(n, cells)] = out.get(kernel_for(n, cells), 0) + 1
    return out


def batch_hashes(dataset, batch_size, workers, n=2):
    """sha256 of each collated array (those of a nested dict under
    "key/name") of the first n batches of a shuffled loader (seed 0, epoch
    0) at `workers` threads."""
    import hashlib
    from paddle3d_tpu_torch.apis import DataLoader
    loader = iter(DataLoader(dataset, batch_size=batch_size, shuffle=True,
                             drop_last=True, num_workers=workers))

    def hashes(batch, prefix=""):
        out = {}
        for k, v in batch.items():
            if isinstance(v, dict):             # SMOKE's targets
                out.update(hashes(v, prefix + k + "/"))
            else:
                out[prefix + k] = hashlib.sha256(v.tobytes()).hexdigest()
        return out
    out = [hashes(next(loader)[0]) for _ in range(n)]
    loader.close()
    return out


def built_databases(dics, tmp, during=None):
    """Run `python -m paddle3d_tpu_torch.tools.create_det_gt_database` on
    each config dic of {label: dic} (written to a YAML under tmp), as
    processes at once, and during() (if given) while they run. -> {label:
    (seconds from the start to its exit, {class: entries})}."""
    import pickle
    procs = {}
    t0 = time.perf_counter()
    for label, dic in dics.items():
        yml = write_yaml(dic, os.path.join(tmp, label + ".yml"))
        procs[label] = subprocess.Popen(
            [sys.executable, "-m", "paddle3d_tpu_torch.tools."
             "create_det_gt_database", "--config", yml], cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    if during is not None:
        during()
    ends = {}
    while len(ends) < len(procs):
        for label, proc in procs.items():
            if label not in ends and proc.poll() is not None:
                ends[label] = time.perf_counter() - t0
        time.sleep(0.05)
    out = {}
    for label, proc in procs.items():
        err = proc.stderr.read()
        check(proc.returncode == 0, "{}: the database tool exited {}: {}"
              .format(label, proc.returncode, err[-2000:]))
        entry = [t for t in dics[label]["train_dataset"]["transforms"]
                 if t["type"] == "SamplingDatabase"][0]
        with open(entry["database_anno_path"], "rb") as f:
            out[label] = (ends[label], {k: len(v) for k, v in
                                        pickle.load(f).items()})
    return out


def pasted_objects(dic, n):
    """The first n train samples through the pipeline up to and with its
    SamplingDatabase: -> list of (pasted labels, pasted velocities or None,
    each pasted object's points lie in its box grown by 2 mm (the database
    stores them relative to the centre), the entries' velocities by box)."""
    import numpy as np

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.geometries import points_in_rbbox_bev
    from paddle3d_tpu_torch.transforms import SamplingDatabase
    ds_cfg = dict(dic["train_dataset"])
    types = [t["type"] for t in ds_cfg["transforms"]]
    ds_cfg["transforms"] = ds_cfg["transforms"][
        :types.index("SamplingDatabase")]
    ds = Config(dic={"train_dataset": ds_cfg}, device="cpu").train_dataset
    db = SamplingDatabase(**{k: v for k, v in dic["train_dataset"][
        "transforms"][types.index("SamplingDatabase")].items()
        if k != "type"})
    entries = {tuple(np.float32(a["box3d"])): a.get("velocity")
               for s in db.samplers.values() for a in s.annos}
    out = []
    for i in range(n):
        smp = ds[i]
        n0, g0 = len(smp.data), len(smp.labels)
        smp = db(smp)
        pts, boxes = np.asarray(smp.data), np.asarray(smp.bboxes_3d).copy()
        boxes[:, 3:6] += 2e-3
        boxes[:, 2] -= 1e-3
        start, inside_all = n0, True
        for j in range(g0, len(smp.labels)):
            inside = points_in_rbbox_bev(pts[start:], boxes[j:j + 1],
                                         origin=smp.bboxes_3d.origin)[:, 0]
            run = len(inside) if inside.all() else int(np.argmin(inside))
            inside_all &= run >= 5          # min_num_points_in_box
            start += run
        vel = smp.bboxes_3d.velocities
        want = [entries.get(tuple(b)) for b in np.asarray(
            smp.bboxes_3d)[g0:]]
        out.append((smp.labels[g0:], None if vel is None else
                    np.asarray(vel)[g0:], inside_all and start == len(pts),
                    want))
    return out


def runtime_leg(device, label, dic, tmp, launches, check_metrics,
                database=None, pastes=None):
    """One leg of phase 28: Config(dic=...) on device, the database
    (built_databases' (seconds, counts), checked by pastes(dic, counts)),
    the loader's first two
    batches at 1 and 4 threads, a Trainer (EMA, RT_WORKERS threads) run of
    P28_WARM + P28_TIMED + 1 steps inside its first epoch with its window
    timed, the bare step on the window's batches, evaluate() in parts, the
    launch counters against launches(model, host batch, scatters) -> (step,
    forward) and check_metrics(metrics). -> a dict of the leg's numbers."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops import _build
    t_leg = time.perf_counter()
    rec = {}
    if database is not None:
        rec["db_s"], counts = database
        log("  {}: database built by the tool (a process, beside the other "
            "database) in {:.2f} s: {}".format(label, rec["db_s"], counts))
        check(counts, "{}: an empty database".format(label))
        pastes(dic, counts)
    torch.manual_seed(SEED)
    cfg = Config(dic=dic, device=device)
    ds = cfg.train_dataset
    h1, h4 = (batch_hashes(ds, cfg.batch_size, w) for w in (1, RT_WORKERS))
    log("  {}: the loader's first two batches at 1 and {} threads equal "
        "(sha256 of every collated array): {}".format(
            label, RT_WORKERS, h1 == h4))
    check(h1 == h4, "{}: the batches depend on the thread count".format(
        label))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    trainer = runtime_trainer(cfg, os.path.join(tmp, label + "_out"), 0,
                              log_interval=0, save_interval=0)
    host, dev = bare_batches(ds, cfg.batch_size, P28_WARM + P28_TIMED + 1,
                             device)
    rows = host[0]["data"].shape[1]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with recorded_losses(trainer) as losses, \
            recorded_scatters() as scatters:
        rate, secs, waits, step_host = windowed_trainer_run(
            trainer, warm=P28_WARM, timed=P28_TIMED)
    steps = P28_WARM + P28_TIMED + 1
    trained = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = [v.item() for v in losses]
    step_want, forward_want = launches(trainer.model, rows,
                                       scatters[:len(scatters) // steps])
    want = {k: v * steps for k, v in step_want.items()}
    bare, bare_host = timed_bare_steps(trainer, dev[:P28_TIMED])
    log("  {}: {} Trainer steps at batch {} ({} rows a scan) in the first "
        "epoch of {} batches; losses {}; launches {} (want {}: {} a step)"
        .format(label, steps, cfg.batch_size, rows,
                len(trainer.train_dataloader), [round(v, 4) for v in losses],
                trained, want, step_want))
    check(all(np.isfinite(losses)) and len(losses) == steps,
          "{}: non-finite or missing losses".format(label))
    check(trained == want, "{}: train launches off the derived ones"
          .format(label))
    log("  {}: scans/s in a window of {} steps from step {}: Trainer ({} "
        "threads) {:.2f}, bare make_train_step {:.2f} (runtime cost "
        "{:.1f} %); step call host ms {} (bare {}); reader wait a step, ms: "
        "first {:.3f}, window {}".format(
            label, P28_TIMED, P28_WARM, RT_WORKERS, rate, bare,
            100 * (1 - rate / bare), round(1e3 * float(np.mean(step_host)),
                                           3),
            round(1e3 * float(np.mean(bare_host)), 3), 1e3 * waits[0],
            round(1e3 * float(np.mean(waits[P28_WARM + 1:])), 3)))
    before = dict(_build.LAUNCHES)
    with recorded_scatters() as scatters:
        metrics, parts, ewall = eval_parts(trainer)
    served = counts_sub(_build.LAUNCHES, before)
    nval = len(trainer.val_dataset)
    forwards = -(-nval // cfg.batch_size)
    _, forward_want = launches(trainer.model, rows,
                               scatters[:len(scatters) // forwards])
    swant = {k: v * forwards for k, v in forward_want.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    log("  {}: evaluate(): {} val frames in {:.3f} s ({:.2f} frames/s): "
        "device forward {:.3f} s, postprocess {:.3f} s, metric {:.3f} s; "
        "launches {} (want {}); peak device memory {:.1f} MiB".format(
            label, nval, ewall, nval / ewall, parts["forward"],
            parts["postprocess"], parts["metric"], served, swant, peak))
    log("  {}: metrics {}".format(label, {k: round(v, 4) for k, v in
                                          metrics.items()}))
    check(served == swant, "{}: eval launches off the derived ones".format(
        label))
    check_metrics(metrics)
    rec.update(rate=rate, bare=bare, metric_s=parts["metric"], peak=peak,
               secs=time.perf_counter() - t_leg)
    log("  {}: leg took {:.1f} s".format(label, rec["secs"]))
    del trainer, cfg
    torch.cuda.empty_cache()
    return rec


def finite_metrics(label, keys):
    def check_metrics(metrics):
        import numpy as np
        missing = [k for k in keys if k not in metrics]
        check(not missing, "{}: the metric lacks {}".format(label, missing))
        check(all(np.isfinite(metrics[k]) for k in keys),
              "{}: non-finite metrics".format(label))
    return check_metrics


def phase_lidar_runtime_prep(tmp, during=None):
    """Phase 28's untimed host work under tmp: the KITTI (three classes),
    nuScenes and Waymo trees, each leg's config dic pointed at its tree,
    and the PV-RCNN and CenterPoint-nuScenes databases (built_databases,
    which runs during() beside its processes); the nuScenes tree holds
    phase 30's cameras and maps, beside phase 30's Apollo tree (mv_trees).
    -> {"dics", "databases", "log", "mv"}."""
    t0 = time.perf_counter()
    kitti, waymo = (os.path.join(tmp, d) for d in ("KITTI", "waymo"))
    written = kitti_tree(kitti, *P28_KITTI, seed=SEED + 2, points=POINTS,
                         classes=tuple(KITTI_SIZES))
    # the nuScenes tree with phase 30's cameras and maps, and its Apollo
    # tree
    mv = mv_trees(tmp)
    nusc = mv["nuscenes"]
    waymo_tree(waymo, *P28_WAYMO, seed=SEED + 4)
    lines = ["trees in {:.1f} s: KITTI {} + {} frames of {} points ({} "
             "objects: cars, pedestrians, cyclists), nuScenes {} + {} key "
             "frames after {} sweeps of {} points (with phase 30's cameras "
             "and maps, and its Apollo tree: {:.1f} s), Waymo {} + {} frames "
             "of {} points".format(
                 time.perf_counter() - t0, *P28_KITTI, POINTS,
                 sum(map(len, written.values())), *P28_NUSC, NUSC_SWEEPS,
                 NUSC_SWEEP_POINTS, mv["secs"], *P28_WAYMO, WAYMO_POINTS)]
    dics = {"PV-RCNN": lidar_dic(PV_RCNN, kitti),
            "CenterPoint-KITTI": lidar_dic(CP_KITTI, kitti),
            "CenterPoint-nuScenes": lidar_dic(NUSCENES, nusc),
            "IA-SSD-Waymo": lidar_dic(IASSD_WAYMO, waymo)}
    databases = built_databases(
        {k: dics[k] for k in ("PV-RCNN", "CenterPoint-nuScenes")}, tmp,
        during)
    return {"dics": dics, "databases": databases, "log": lines, "mv": mv}


def phase_lidar_runtime(device, prep=None):
    """Phase 28: the runtime's other LiDAR configs, each through Config ->
    Trainer -> DataLoader -> dataset -> transforms -> train steps ->
    evaluate -> the dataset's metric: (a) PV-RCNN-KITTI on a database the
    tool builds, (b) CenterPoint-pillars-KITTI, (c) CenterPoint-pillars
    nuScenes 10-sweep on a database with velocities, (d) IA-SSD-Waymo.
    prep: phase_lidar_runtime_prep's result (main() runs it beside phase
    27's CLI); without it the phase prepares its own under a temp dir."""
    import tempfile

    import numpy as np
    t_phase = time.perf_counter()
    if not prep:
        with tempfile.TemporaryDirectory() as tmp:
            prep = phase_lidar_runtime_prep(tmp)
            prep["where"] = "before the legs"
            return phase_lidar_runtime(device, prep)
    log("phase 28: the runtime's other LiDAR configs; prepared {}: {}"
        .format(prep.get("where", "beside phase 27's CLI processes"),
                prep["log"][0]))
    dics, dbs, out = prep["dics"], prep["databases"], {}
    tmp = os.path.dirname(dics["PV-RCNN"]["train_dataset"]["dataset_root"])

    def pv_pastes(dic, counts):
        check(set(counts) == set(KITTI_SIZES),
              "PV-RCNN: the database lacks a class: {}".format(counts))
        pasted = pasted_objects(dic, P28_PASTE_CHECKS)
        names = dic["train_dataset"]["class_names"]
        got = {names[k] for lab, _, _, _ in pasted for k in lab}
        log("  PV-RCNN: pastes in the first {} samples {}; each pasted "
            "object's points in its box: {}".format(
                P28_PASTE_CHECKS, [np.bincount(lab, minlength=3).tolist()
                                   for lab, _, _, _ in pasted],
                all(ok for _, _, ok, _ in pasted)))
        check(got == set(counts), "PV-RCNN: pasted {}, not every class "
              "of {}".format(got, counts))
        check(all(ok for _, _, ok, _ in pasted),
              "PV-RCNN: a pasted object's points leave its box")

    def nusc_pastes(dic, counts):
        pasted = pasted_objects(dic, P28_PASTE_CHECKS)
        vel = np.concatenate([v for _, v, _, _ in pasted])
        want = np.asarray([w for _, _, _, ws in pasted for w in ws],
                          np.float32)
        moving = np.hypot(vel[:, 0], vel[:, 1]) > 0.5
        same = vel.shape == want.shape and np.array_equal(vel, want)
        log("  CenterPoint-nuScenes: {} pastes in the first {} samples, {} "
            "with velocity over 0.5 m/s; velocities equal their entries': "
            "{}; points in their boxes: {}".format(
                len(vel), P28_PASTE_CHECKS, int(moving.sum()), same,
                all(ok for _, _, ok, _ in pasted)))
        check(same, "CenterPoint-nuScenes: pasted velocities differ from "
              "their entries'")
        check(moving.any(), "CenterPoint-nuScenes: no pasted box moves")
        check(all(ok for _, _, ok, _ in pasted),
              "CenterPoint-nuScenes: a pasted object's points leave its box")

    def pv_launches(model, rows, scatters):
        return (with_scatters(PV_STEP, scatters),
                with_scatters(PV_FORWARD, scatters))

    def pillar_launches(model, rows, _):
        return pillar2_launches(model, rows)
    kitti_keys = ["{} {} easy AP_R40".format(c, m) for c in KITTI_SIZES
                  for m in ("3d", "bev")]
    legs = [
        ("PV-RCNN", pv_launches, kitti_keys, pv_pastes),
        ("CenterPoint-KITTI", pillar_launches, kitti_keys, None),
        ("CenterPoint-nuScenes", pillar_launches,
         ["mAP", "NDS", "mATE", "mAVE"], nusc_pastes),
        ("IA-SSD-Waymo", lambda model, rows, _: (IA_STEP, IA_FORWARD),
         ["{} {} AP".format(c, lv) for c in WAYMO_SIZES
          for lv in ("L1", "L2")], None)]
    for label, launches, keys, pastes in legs:
        out[label] = runtime_leg(
            device, label, dics[label], tmp, launches,
            finite_metrics(label, keys), database=dbs.get(label),
            pastes=pastes)
    log("  phase 28: {}".format({k: {n: round(x, 3) for n, x in v.items()}
                                 for k, v in out.items()}))
    log("  phase 28's legs took {:.1f} s (its trees and databases were "
        "prepared before them)".format(time.perf_counter() - t_phase))
    return out


# --------------------------------------------------------------- phase 29
# KITTI's image sizes (h, w): most frames are 1242 x 375, a few of the other
# sizes KITTI's camera gave, so that the resize runs from more than one size
CAM_SIZES = ((375, 1242), (370, 1224), (376, 1241))
CAM_TREE = (64, 8)          # frames of the camera tree's train, val splits
CAM_TIMED = 3               # steps of a Trainer run's timed window; one
                            # more step ends it
# steps before the window: SMOKE's, the loader's prefetch depth (its
# window's batches are built beside its steps: a loader-bound run shows
# there), CADDN's one (its loader keeps up with its step)
SMOKE_WARM, CADDN_WARM = RT_WORKERS, 1
CAM_SAMPLES = 8             # train samples timed part by part
CAM_TINY_STEPS = 3          # Trainer steps of each synthetic tiny config


def png_bytes(img, filters=None, level=6, chunk=65536):
    """img [H, W, C] uint8 (C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA) as
    the bytes of a non-interlaced 8-bit PNG, written with zlib alone (the
    card's machine has no Pillow). Row y is filtered with filters[y %
    len(filters)], by default the five filter types in turn (None, Sub,
    Up, Average, Paeth), so that a reader's every unfilter path runs; the
    image data goes out in IDAT chunks of `chunk` bytes."""
    import struct
    import zlib

    import numpy as np
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]                    # the byte one pixel to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                          # the byte above
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]                # above and to the left
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    types = np.asarray(filters or (0, 1, 2, 3, 4))[np.arange(h) % len(
        filters or (0, 1, 2, 3, 4))]
    rows = ((x - preds[types, np.arange(h)]) & 0xFF).astype(np.uint8)
    raw = np.concatenate([types.astype(np.uint8)[:, None], rows], axis=1)
    data = zlib.compress(raw.tobytes(), level)

    def chunk_of(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload +
                struct.pack(">I", zlib.crc32(kind + payload)))
    out = [b"\x89PNG\r\n\x1a\n", chunk_of(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    out += [chunk_of(b"IDAT", data[i:i + chunk])
            for i in range(0, len(data), chunk)]
    out.append(chunk_of(b"IEND", b""))
    return b"".join(out)


# JPEG Annex K tables: quantisation (zigzag order is applied below) and the
# standard Huffman tables (counts of each code length, symbols)
JPEG_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99))
JPEG_HUFFMAN = {
    "dc0": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            tuple(range(12))),
    "dc1": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
            tuple(range(12))),
    "ac0": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
        "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
        "5455565758595a636465666768696a737475767778797a838485868788898a9293"
        "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
        "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    "ac1": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f015"
        "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a82838485868788898a"
        "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
        "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))}
JPEG_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
JPEG_SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
                 "4:4:0": (1, 2)}


def jpeg_tables(quality):
    """The Annex K luminance and chrominance tables scaled to quality
    (1-100) as libjpeg's jpeg_quality_scaling does, natural order:
    -> [2, 64] int64."""
    import numpy as np
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    base = np.asarray(JPEG_QUANT, np.int64)
    return np.clip((base * scale + 50) // 100, 1, 255)


def jpeg_coefficients(img, quality=90, sampling="4:2:0"):
    """The quantised DCT coefficients of a baseline JPEG of img ([H, W, 3]
    RGB or [H, W] grey uint8): JFIF's YCbCr, chroma averaged over each
    sampling box, planes padded to whole MCUs by repeating the edge, a
    float DCT. -> (list of [rows, cols, 64] int64 blocks a component,
    natural order; the [2, 64] tables; the luma (h, v) factors)."""
    import numpy as np
    img = np.asarray(img, np.float64)
    grey = img.ndim == 2
    hv = (1, 1) if grey else JPEG_SAMPLING[sampling]
    h, w = img.shape[:2]
    mh, mw = 8 * hv[1], 8 * hv[0]
    ph, pw = -(-h // mh) * mh, -(-w // mw) * mw
    if grey:
        planes = [img]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
                  0.5 * r - 0.418687589 * g - 0.081312411 * b + 128]
    planes = [np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")
              for p in planes]
    for i in range(1, len(planes)):       # chroma: the box mean
        planes[i] = planes[i].reshape(ph // hv[1], hv[1], pw // hv[0],
                                      hv[0]).mean(axis=(1, 3))
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    tables = jpeg_tables(quality)
    out = []
    for i, p in enumerate(planes):
        rows, cols = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3) - 128
        coef = dct @ blocks @ dct.T
        out.append(np.rint(coef.reshape(rows, cols, 64) /
                           tables[min(i, 1)]).astype(np.int64))
    return out, tables, hv


def _huffman_codes(counts, symbols):
    """symbol -> (code, length) arrays [256] of a table (Annex C)."""
    import numpy as np
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _jpeg_events(blocks, comp, first, codes):
    """The Huffman events of a run of blocks ([n, 64] natural order, comp
    [n] the component of each, first [n] whether a block restarts its
    component's DC prediction): -> (sort keys, values, bit lengths)."""
    import numpy as np
    zz = blocks[:, list(JPEG_ZIGZAG)]
    n = len(zz)
    dc = zz[:, 0].copy()
    prev = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        d = dc[idx]
        p = np.concatenate([[0], d[:-1]])
        p[first[idx]] = 0
        prev[idx] = p
    diff = dc - prev

    def size_bits(v):
        size = np.where(v == 0, 0, np.floor(np.log2(np.maximum(
            np.abs(v), 1))).astype(np.int64) + 1)
        bits = np.where(v < 0, v + (1 << size) - 1, v)
        return size, bits
    tbl = np.minimum(comp, 1)
    keys, vals, lens = [], [], []
    s, bits = size_bits(diff)
    if s.max(initial=0) > 11 or np.abs(zz[:, 1:]).max(initial=0) > 1023:
        raise ValueError("a DC difference past 11 bits or an AC value past "
                         "10: not baseline")
    code, clen = codes["dc"][tbl, s], codes["dcl"][tbl, s]
    keys.append(np.arange(n) * 256)
    vals.append((code << s) | bits)
    lens.append(clen + s)
    blk, j = np.nonzero(zz[:, 1:])
    v = zz[:, 1:][blk, j]
    start = np.ones(len(blk), bool)
    start[1:] = blk[1:] != blk[:-1]
    pj = np.where(start, -1, np.concatenate([[-1], j[:-1]]))
    run = j - pj - 1
    zrl, run = run // 16, run % 16
    for z in range(1, 4):                   # at most three ZRLs a symbol
        m = zrl >= z
        t = tbl[blk[m]]
        keys.append(blk[m] * 256 + 4 * j[m] + z)
        vals.append(codes["ac"][t, 0xF0])
        lens.append(codes["acl"][t, 0xF0])
    s, bits = size_bits(v)
    t = tbl[blk]
    sym = run * 16 + s
    keys.append(blk * 256 + 4 * j + 4)
    vals.append((codes["ac"][t, sym] << s) | bits)
    lens.append(codes["acl"][t, sym] + s)
    last = np.full(n, -1)
    last[blk] = j                            # row-major: the last wins
    eob = np.nonzero(last < 62)[0]
    keys.append(eob * 256 + 255)
    vals.append(codes["ac"][tbl[eob], 0])
    lens.append(codes["acl"][tbl[eob], 0])
    keys, vals, lens = (np.concatenate(a) for a in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    return vals[order], lens[order]


def _jpeg_pack(vals, lens):
    """Bit-pack the events (MSB first), pad the last byte with ones and
    stuff a 0x00 after every 0xFF: -> bytes. Each event's bits go left-
    aligned into a big-endian uint32, unpacked to one byte a bit, and the
    first `len` of each row are kept."""
    import numpy as np
    words = (vals << (32 - lens)).astype(">u4")
    bits = np.unpackbits(words.view(np.uint8).reshape(-1, 4), axis=1)
    stream = bits[np.arange(32)[None] < lens[:, None]]
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    data = np.packbits(stream)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def jpeg_encode(coefs, tables, hv, width, height, restart=0):
    """A baseline JFIF file of quantised coefficients (jpeg_coefficients'
    layout: luma at (h, v) = hv, chroma at 1 x 1; one component is grey)
    with the Annex K Huffman tables, one interleaved scan, and a restart
    marker every `restart` MCUs (0: none). -> bytes."""
    import struct

    import numpy as np
    ncomp = len(coefs)
    hs, vs = hv if ncomp == 3 else (1, 1)
    codes = {}
    for kind in ("dc", "ac"):
        pairs = [_huffman_codes(*JPEG_HUFFMAN[kind + str(t)]) for t in (0, 1)]
        codes[kind] = np.stack([p[0] for p in pairs])
        codes[kind + "l"] = np.stack([p[1] for p in pairs])
    rows, cols = coefs[0].shape[0] // vs, coefs[0].shape[1] // hs
    # the blocks in MCU order: luma's hs x vs, then each chroma's one
    parts, comp = [], []
    luma = coefs[0].reshape(rows, vs, cols, hs, 64).transpose(0, 2, 1, 3, 4)
    parts.append(luma.reshape(rows, cols, hs * vs, 64))
    comp += [0] * (hs * vs)
    for i in range(1, ncomp):
        parts.append(coefs[i][:, :, None])
        comp.append(i)
    mcus = np.concatenate(parts, axis=2).reshape(rows * cols, -1, 64)
    comp = np.asarray(comp)
    per = mcus.shape[1]
    step = restart or rows * cols
    body = []
    for k, m0 in enumerate(range(0, rows * cols, step)):
        chunk = mcus[m0:m0 + step].reshape(-1, 64)
        cc = np.tile(comp, len(chunk) // per)
        first = np.zeros(len(chunk), bool)
        for i in range(ncomp):
            first[np.nonzero(cc == i)[0][:1]] = True
        body.append(_jpeg_pack(*_jpeg_events(chunk, cc, first, codes)))
        if m0 + step < rows * cols:
            body.append(bytes([0xFF, 0xD0 + k % 8]))

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + \
            payload
    zz = list(JPEG_ZIGZAG)
    out = [b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                   b"\x00\x00")]
    for t in range(min(ncomp, 2)):
        out.append(seg(0xDB, bytes([t]) + bytes(
            tables[t][zz].astype(np.uint8).tolist())))
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for i in range(ncomp):
        sof += bytes([i + 1, (hs << 4 | vs) if i == 0 else 0x11, min(i, 1)])
    out.append(seg(0xC0, sof))
    for kind, tc in (("dc", 0), ("ac", 1)):
        for t in range(min(ncomp, 2)):
            counts, syms = JPEG_HUFFMAN[kind + str(t)]
            out.append(seg(0xC4, bytes([tc << 4 | t]) + bytes(counts) +
                           bytes(syms)))
    if restart:
        out.append(seg(0xDD, struct.pack(">H", restart)))
    sos = bytes([ncomp])
    for i in range(ncomp):
        sos += bytes([i + 1, min(i, 1) << 4 | min(i, 1)])
    out.append(seg(0xDA, sos + b"\x00\x3f\x00"))
    out += body
    out.append(b"\xff\xd9")
    return b"".join(out)


def jpeg_bytes(img, quality=90, sampling="4:2:0", restart=0):
    """img ([H, W, 3] RGB or [H, W] grey uint8) as the bytes of a baseline
    JFIF JPEG, written with numpy alone (the card's machine has no Pillow):
    jpeg_coefficients, then jpeg_encode, vectorised over blocks (the run
    lengths, the Huffman events and the bit packing)."""
    h, w = img.shape[:2]
    coefs, tables, hv = jpeg_coefficients(img, quality, sampling)
    return jpeg_encode(coefs, tables, hv, w, h, restart)


def kitti_image(rng, boxes, labels, calib, hw):
    """A camera image [h, w, 3] uint8 of a kitti_tree frame: a sky / road
    gradient with a grain of +-12 levels (a texture the filters and zlib
    have work on), the frame's lidar boxes (x, y, z bottom, w, l, h, yaw)
    drawn as shaded cuboids through the calib's P2 (the synthetic camera
    datasets' renderer), far to near."""
    import numpy as np

    from paddle3d_tpu_torch.datasets import synthetic
    from paddle3d_tpu_torch.datasets.kitti import kitti_utils
    h, w = hw
    cam = kitti_utils.lidar_boxes_to_camera_anno(boxes, calib)
    horizon = int(calib.P2[1, 2])
    grad = np.linspace(150, 70, h, dtype=np.float32)[:, None, None]
    img = np.broadcast_to(grad, (h, w, 3)).copy()
    img[:horizon] += np.array([20, 35, 70], np.float32)
    img += rng.integers(-12, 13, (h, w, 3)).astype(np.float32)
    corners, depths = [], []
    for loc, dims, ry in zip(cam["location"], cam["dimensions"],
                             cam["rotation_y"]):
        c3 = synthetic._camera_box_corners(np.r_[loc, dims, ry])
        if np.any(c3[:, 2] <= 0.5):
            corners.append(None)
        else:
            uv, _ = calib.rect_to_img(c3.astype(np.float32))
            corners.append(uv.astype(np.float32))
        depths.append(float(loc[2]))
    synthetic._render_cuboids(img, corners, depths, labels)
    return np.clip(img, 0, 255).astype(np.uint8)


def camera_dic(path, root):
    """The config at path (its _base_ chain resolved) with both datasets'
    dataset_root at root. -> the dic."""
    from paddle3d_tpu_torch.apis import Config
    dic = Config(path=path, device="cpu").dic
    for split in ("train_dataset", "val_dataset"):
        dic[split]["dataset_root"] = root
    return dic


def unfilter_checks(root, hashes):
    """Every image of the camera tree read by the port's decoder equals the
    array written (sha256); on one image of each size, the native unfilter
    byte-equal to the plain NumPy one, with each of the five filter types
    in its rows. -> (images read, {size: native ms, plain ms})."""
    import hashlib

    import numpy as np

    from paddle3d_tpu_torch.utils import png
    base = os.path.join(root, "training", "image_2")
    read, sizes = 0, {}
    for idx, want in sorted(hashes.items()):
        path = os.path.join(base, idx + ".png")
        img = png.read_png(path)
        check(hashlib.sha256(img.tobytes()).hexdigest() == want,
              "{}: the decoded image differs from the one written".format(
                  path))
        read += 1
        if img.shape[:2] in sizes:
            continue
        with open(path, "rb") as f:
            hdr, raw = png.inflate(f.read())
        stride, bpp = hdr["width"] * 3, 3
        types = set(np.frombuffer(raw, np.uint8)[::stride + 1].tolist())
        t0 = time.perf_counter()
        native = png.unfilter(raw, hdr["height"], stride, bpp)
        t1 = time.perf_counter()
        plain = png.unfilter_plain(raw, hdr["height"], stride, bpp)
        t2 = time.perf_counter()
        check(types == {0, 1, 2, 3, 4}, "{}: filter types {}".format(
            path, sorted(types)))
        check(np.array_equal(native, plain), "{}: the native unfilter "
              "differs from the plain one".format(path))
        sizes[img.shape[:2]] = (1e3 * (t1 - t0), 1e3 * (t2 - t1))
    return read, sizes


def loader_parts(label, ds, n=CAM_SAMPLES):
    """ds.get(i) for the first n samples on this thread, its parts timed:
    -> {part: ms a sample}. SMOKE: decode (the dataset's read and
    LoadImage's), resize (Gt2SmokeTarget's BILINEAR), targets (the rest of
    Gt2SmokeTarget), normalize; CADDN: decode, resize (BICUBIC), the
    depth map; each with the sample's whole time."""
    from paddle3d_tpu_torch.datasets.kitti import (kitti_depth_det,
                                                   kitti_mono_det)
    from paddle3d_tpu_torch.transforms import normalize, reader, \
        target_generator
    targets = [("decode", kitti_mono_det, "read_png"),
               ("decode", kitti_depth_det, "read_png"),
               ("decode", reader, "read_image"),
               ("resize", target_generator, "resize"),
               ("resize", kitti_depth_det, "resize"),
               ("targets", target_generator.Gt2SmokeTarget, "__call__"),
               ("normalize", normalize.Normalize, "__call__"),
               ("depth map", kitti_depth_det.KittiDepthDataset,
                "_depth_map")]
    with timed_calls(targets) as ms:
        t0 = time.perf_counter()
        for i in range(n):
            ds.get(i)
        total = time.perf_counter() - t0
    out = {k: sum(v) / n for k, v in ms.items() if v}
    if "targets" in out:                # Gt2SmokeTarget holds the resize
        out["targets"] -= out["resize"]
    out["sample"] = 1e3 * total / n
    log("  {}: the loader's host work a sample on one thread, ms (over the "
        "first {} train samples): {}".format(label, n, {
            k: round(v, 3) for k, v in out.items()}))
    return out


def camera_leg(device, label, dic, tmp, launches, metric_keys, warm,
               one_thread=True, benchmark=True):
    """One full-width KITTI camera config through Config(dic=...) on
    device, cudnn.benchmark as given: the loader's first batch at 1 and
    RT_WORKERS threads (sha256), a Trainer (EMA, RT_WORKERS threads) run
    of warm + CAM_TIMED + 1 steps inside its first epoch with its window
    timed (finite losses, the mean of the last three under the first
    three's; launches against launches(scatters) -> (step, forward),
    scatters the (rows, cells) of each recorded segment sum; peak memory),
    then with one_thread a Trainer at 1 thread, a Trainer on prebuilt
    batches and the bare step, windows in t4 / t1 / prebuilt / bare order,
    evaluate() in parts with its launches and the dataset's metric
    (metric_keys finite). -> a dict of the leg's numbers."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config, Trainer
    from paddle3d_tpu_torch.ops import _build
    t_leg = time.perf_counter()
    torch.manual_seed(SEED)
    cfg = Config(dic=dic, device=device)
    ds = cfg.train_dataset
    t0 = time.perf_counter()
    h1, h4 = (batch_hashes(ds, cfg.batch_size, w, n=1)
              for w in (1, RT_WORKERS))
    log("  {}: the loader's first batch of {} at 1 and {} threads equal "
        "(sha256 of every collated array, {}): {} ({:.1f} s)".format(
            label, cfg.batch_size, RT_WORKERS, sorted(h1[0]), h1 == h4,
            time.perf_counter() - t0))
    check(h1 == h4, "{}: the batches depend on the thread count".format(
        label))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = benchmark
    steps = warm + CAM_TIMED + 1
    trainer = runtime_trainer(cfg, os.path.join(tmp, label + "_out"), 0,
                              log_interval=0, save_interval=0)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with recorded_losses(trainer) as losses, \
            recorded_scatters() as scatters:
        rate4, _, waits, host4 = windowed_trainer_run(
            trainer, warm=warm, timed=CAM_TIMED)
    trained = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = [v.item() for v in losses]
    step_want, _ = launches(scatters[:len(scatters) // steps])
    want = {k: v * steps for k, v in step_want.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    head, tail = np.mean(losses[:3]), np.mean(losses[-3:])
    log("  {}: {} Trainer steps at batch {} in the first epoch of {} "
        "batches (cudnn.benchmark {}); losses {}; launches {} (want {}: {} "
        "a step); peak device memory {:.1f} MiB".format(
            label, steps, cfg.batch_size, len(trainer.train_dataloader),
            "on" if benchmark else "off (torch's default)",
            [round(v, 4) for v in losses], trained, want, step_want, peak))
    check(all(np.isfinite(losses)) and len(losses) == steps,
          "{}: non-finite or missing losses".format(label))
    check(tail < head, "{}: the loss did not fall: mean of the last three "
          "steps {:.4f} against the first three's {:.4f}".format(
              label, tail, head))
    check(trained == want, "{}: train launches off the derived ones"
          .format(label))
    # the same model and optimizer at 1 loader thread, on prebuilt
    # batches, and the bare step on those batches

    def trainer_like(name, **kw):
        return Trainer(model=trainer.model, optimizer=trainer.optimizer,
                       lr_scheduler=trainer.lr_scheduler, iters=0,
                       train_dataset=ds, batch_size=cfg.batch_size,
                       save_dir=os.path.join(tmp, label + name),
                       ema_decay=RT_EMA, log_interval=0, save_interval=0,
                       **kw)
    rate1, waits1, host1 = None, [], []
    if one_thread:
        # one thread builds the batches one after another, so the loader
        # holds the steps back from the first: a window from step 1
        rate1, _, waits1, host1 = windowed_trainer_run(
            trainer_like("_t1", dataloader_fn={"num_workers": 1}),
            warm=1, timed=CAM_TIMED)
    host, dev = bare_batches(ds, cfg.batch_size, steps, device)
    pre = trainer_like("_pre")
    pre.train_dataloader = Prebuilt(host)
    ratep, _, _, hostp = windowed_trainer_run(pre, warm=warm,
                                              timed=CAM_TIMED)
    bare, bare_host = timed_bare_steps(trainer, dev[:CAM_TIMED])
    del pre, dev, host

    def ms(xs):
        return round(1e3 * float(np.mean(xs)), 3) if len(xs) else None
    log("  {}: frames/s in a window of {} steps from step {} (t4 / {}"
        "prebuilt / bare): Trainer {} threads {:.2f}{}, prebuilt batches "
        "{:.2f}, bare make_train_step {:.2f} (runtime cost {:.1f} % at {} "
        "threads{}, {:.1f} % prebuilt); step call host ms {} / {} / {} "
        "(bare {}); reader wait a step in the window, ms: {} threads {}, 1 "
        "thread {}".format(
            label, CAM_TIMED, warm,
            "t1 (from step 1) / " if one_thread else "",
            RT_WORKERS, rate4, ", 1 thread {:.2f}".format(rate1)
            if one_thread else "", ratep, bare, 100 * (1 - rate4 / bare),
            RT_WORKERS, ", {:.1f} % at 1".format(100 * (1 - rate1 / bare))
            if one_thread else "", 100 * (1 - ratep / bare), ms(host4),
            ms(host1), ms(hostp), ms(bare_host), RT_WORKERS,
            ms(waits[warm + 1:]), ms(waits1[2:])))
    before = dict(_build.LAUNCHES)
    with recorded_scatters() as scatters:
        metrics, parts, ewall = eval_parts(trainer)
    served = counts_sub(_build.LAUNCHES, before)
    nval = len(trainer.val_dataset)
    forwards = -(-nval // cfg.batch_size)
    _, forward_want = launches(scatters[:len(scatters) // forwards])
    swant = {k: v * forwards for k, v in forward_want.items()}
    log("  {}: evaluate(): {} val frames in {:.3f} s ({:.2f} frames/s): "
        "device forward {:.3f} s, postprocess {:.3f} s, metric {:.3f} s; "
        "launches {} (want {})".format(
            label, nval, ewall, nval / ewall, parts["forward"],
            parts["postprocess"], parts["metric"], served, swant))
    log("  {}: metrics {}".format(label, {k: round(v, 4) for k, v in
                                          metrics.items()
                                          if k in metric_keys}))
    check(served == swant, "{}: eval launches off the derived ones".format(
        label))
    finite_metrics(label, metric_keys)(metrics)
    rec = dict(t4=rate4, t1=rate1, prebuilt=ratep, bare=bare, peak=peak,
               eval_s=ewall, metric_s=parts["metric"],
               secs=time.perf_counter() - t_leg)
    log("  {}: leg took {:.1f} s".format(label, rec["secs"]))
    del trainer, cfg
    torch.cuda.empty_cache()
    return rec


def tiny_camera_run(device, path, label, tmp, launches):
    """A synthetic tiny camera config through Config -> Trainer (EMA,
    RT_WORKERS loader threads) for CAM_TINY_STEPS steps -> evaluate() -> its
    metric on device, the launches against launches(scatters) -> (step,
    forward), scatters the (rows, cells) of each recorded segment sum.
    -> (trainer, the pool's routes)."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops import _build
    torch.manual_seed(SEED)
    cfg = Config(path=path, device=device)
    trainer = runtime_trainer(cfg, os.path.join(tmp, label), CAM_TINY_STEPS,
                              log_interval=0, save_interval=0)
    _build.reset_launches()
    with recorded_losses(trainer) as losses, \
            recorded_scatters() as train_scatters, \
            mock.patch.object(trainer, "_save_checkpoint", lambda: None):
        trainer.train()
    trained = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = [v.item() for v in losses]
    _build.reset_launches()
    with recorded_scatters() as eval_scatters:
        metrics = trainer.evaluate()
    served = {k: v for k, v in _build.LAUNCHES.items() if v}
    forwards = -(-len(trainer.val_dataset) // cfg.batch_size)
    step_want, _ = launches(train_scatters[:len(train_scatters) //
                                           CAM_TINY_STEPS])
    _, forward_want = launches(eval_scatters[:len(eval_scatters) //
                                             forwards])
    want_t = {k: v * CAM_TINY_STEPS for k, v in step_want.items()}
    want_s = {k: v * forwards for k, v in forward_want.items()}
    log("  {}: {} Trainer steps at batch {}, losses {}, launches {} (want "
        "{}); evaluate() over {} frames: launches {} (want {}), metrics {}"
        .format(label, CAM_TINY_STEPS, cfg.batch_size,
                [round(v, 4) for v in losses], trained, want_t,
                len(trainer.val_dataset), served, want_s,
                {k: round(v, 4) for k, v in metrics.items()}))
    check(all(np.isfinite(losses)) and len(losses) == CAM_TINY_STEPS,
          "{}: non-finite or missing losses".format(label))
    check(trained == want_t and served == want_s,
          "{}: launches off the derived ones".format(label))
    check(all(np.isfinite(v) for v in metrics.values()),
          "{}: non-finite metrics".format(label))
    return trainer, sorted({r for r in step_want if "segment" in r})


def camera_launches(scatters):
    """A camera model's launches by its recorded pools: each pool's route
    by the density rule a forward, plus its VJP (K5) a step."""
    forward = with_scatters({}, scatters)
    step = dict(forward)
    if scatters:
        step["sorted_table_gather"] = len(scatters)
    return step, forward


def phase_camera_tiny(device, tmp):
    """The three synthetic camera tiny configs through the runtime on the
    card: SMOKE (K14 a forward, no kernel a step), CADDN (its pool by the
    density rule, K2 for its 192 rows a frame on 1,024 cells, and K5 a
    step) and PETR (no kernel); then the tiny SMOKE's evaluate() on the CPU
    with the same weights (the class head's kernel scaled by SMOKE_CLS_GAIN
    first): its eval steps' outputs against the card's, labels equal, the
    rest within SMOKE_TINY_TOL of the largest value. -> the tiny CADDN's
    pool routes."""
    import copy

    import torch
    trainer, _ = tiny_camera_run(
        device, SMOKE_TINY, "tiny SMOKE", tmp,
        lambda _: ({}, {"gather_rows": 1}))
    model = trainer.model
    with torch.no_grad():
        model.head.cls_conv2.weight.mul_(SMOKE_CLS_GAIN)
    outs = {}
    for where, m in (("card", model), ("cpu", copy.deepcopy(model).cpu())):
        trainer.model, trainer.device = m, next(m.parameters()).device
        got = []
        step = trainer._eval_step

        def rec(model_, batch, _step=step, _got=got):
            out = _step(model_, batch)
            _got.append({k: v.cpu() for k, v in out.items()})
            return out
        with mock.patch.object(trainer, "_eval_step", rec):
            metrics = trainer.evaluate()
        outs[where] = (got, metrics)
    (card, cm), (cpu, pm) = outs["card"], outs["cpu"]
    check(len(card) == len(cpu) and all(
        torch.equal(a["label_preds"], b["label_preds"])
        for a, b in zip(card, cpu)), "tiny SMOKE evaluate(): labels differ "
        "between the card and the CPU")
    errs = {key: max(((a[key] - b[key]).abs().max() / b[key].abs().max())
                     .item() for a, b in zip(card, cpu))
            for key in SMOKE_TINY_TOL}
    log("  tiny SMOKE evaluate(), card vs CPU ({} eval steps): labels "
        "equal; relative errors {} (tolerances {}); metrics {} / {}".format(
            len(card), {k: "{:.3e}".format(v) for k, v in errs.items()},
            SMOKE_TINY_TOL, cm, pm))
    check(all(errs[k] <= tol for k, tol in SMOKE_TINY_TOL.items()),
          "tiny SMOKE evaluate() outputs differ between the card and the "
          "CPU")
    del trainer, model, outs
    _, routes = tiny_camera_run(device, CADDN_TINY, "tiny CADDN", tmp,
                                camera_launches)
    check(routes == ["sorted_segment_sum"], "the tiny CADDN's pool ran on "
          "{}, not K2".format(routes))
    tiny_camera_run(device, PETR_TINY, "tiny PETR", tmp,
                    lambda _: ({}, {}))
    return routes


def camera_tree(tmp):
    """Phase 29's KITTI tree with images under tmp (CAM_TREE frames, three
    classes): -> {"root", "hashes", "written", "secs"}."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "KITTI_camera")
    hashes = {}
    written = kitti_tree(root, *CAM_TREE, seed=SEED + 5,
                         classes=tuple(KITTI_SIZES), images=True,
                         hashes=hashes)
    return {"root": root, "hashes": hashes, "written": written,
            "secs": time.perf_counter() - t0}


def phase_camera_runtime(device, prep=None):
    """Phase 29: the runtime's camera path, through Config -> Trainer ->
    DataLoader -> KITTI camera dataset (PNG read by the port's decoder,
    Pillow's resize) -> transforms -> collate -> train step -> evaluate ->
    postprocess_to_samples -> metric, on a KITTI tree with images: SMOKE
    (DLA-34, KittiMonoDataset, Gt2SmokeTarget with its flips) at the
    config's batch 8 and CADDN (HRNet-W18 + OCR, KittiDepthDataset) at 4,
    each against the bare step; the native unfilter against the plain one;
    the loader's cost a sample by part; the three synthetic camera tiny
    configs. prep: camera_tree's result (main() writes the tree beside
    phase 28's database processes); without it the phase writes its own
    under a temp dir."""
    import tempfile

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.utils.png import png_size
    t_phase = time.perf_counter()
    if not prep:
        with tempfile.TemporaryDirectory() as tmp:
            prep = camera_tree(tmp)
            prep["where"] = "before the legs"
            return phase_camera_runtime(device, prep)
    root, hashes, written = prep["root"], prep["hashes"], prep["written"]
    tmp = os.path.dirname(root)
    images = os.path.join(root, "training", "image_2")
    sizes = {}
    for idx in hashes:
        hw = png_size(os.path.join(images, idx + ".png"))
        sizes[hw] = sizes.get(hw, 0) + 1
    mb = sum(os.path.getsize(os.path.join(images, i + ".png"))
             for i in hashes) / 2**20
    log("phase 29: the runtime's camera path; KITTI tree of {} + {} frames "
        "with images ({} objects; frames by size (h, w) {}; {:.1f} MiB of "
        "PNG) written in {:.1f} s {}".format(
            *CAM_TREE, sum(map(len, written.values())), sizes, mb,
            prep["secs"], prep.get("where", "beside phase 28's database "
                                   "processes")))
    read, times = unfilter_checks(root, hashes)
    log("  the port's decoder read all {} images equal to the arrays "
        "written; native unfilter byte-equal to the plain one on one image "
        "of each size, all five filter types in its rows (ms native / "
        "plain): {}".format(read, {k: (round(a, 3), round(b, 1))
                                   for k, (a, b) in times.items()}))
    smoke_dic = camera_dic(SMOKE_KITTI, root)
    caddn_dic = camera_dic(CADDN_KITTI, root)
    for label, dic in (("SMOKE", smoke_dic), ("CADDN", caddn_dic)):
        loader_parts(label, Config(dic={"train_dataset": dic[
            "train_dataset"]}, device="cpu").train_dataset)
    kitti_keys = ["{} {} easy AP_R40".format(c, m) for c in KITTI_SIZES
                  for m in ("3d", "bev")]
    legs = {"SMOKE": camera_leg(device, "SMOKE", smoke_dic, tmp,
                                lambda _: ({}, {"gather_rows": 1}),
                                kitti_keys, SMOKE_WARM),
            # torch's cuDNN defaults, as tools/train.py leaves them: the
            # autotuner's first steps of this config took ~14 s on the card
            "CADDN": camera_leg(device, "CADDN", caddn_dic, tmp,
                                camera_launches, kitti_keys, CADDN_WARM,
                                one_thread=False, benchmark=False)}
    phase_camera_tiny(device, tmp)
    log("  phase 29: {}".format(
        {k: {n: round(x, 3) for n, x in v.items() if x is not None}
         for k, v in legs.items()}))
    log("  phase 29 took {:.1f} s (its tree written before it)".format(
        time.perf_counter() - t_phase))
    return legs


# ------------------------------------------------------------- phase 30
# The nuScenes multi-view and Apollo camera runtime: phase 28's nuScenes
# tree with its six cameras (NUSC_CAM_HW JPEGs) and BEV maps, and an
# Apollo tree, both written beside phase 27's CLI.
MV_SEG_MAP = (256, 256)     # PETRv2-BEVseg's seg head bev_size (h, w)
MV_APOLLO = (16, 4)         # frames of the Apollo train and test splits
MV_PARTS = 2                # train samples a timed leg times part by part
MV_CHECK_BATCH = 1          # frames of the two batches hashed at 1 and 4
                            # threads
MV_DECODES = 5              # native decodes of a full view, timed
MV_KERNEL_ITERS = 5         # timed calls of each kernel held
# the timed legs: label -> (config, 4-thread window (warm, timed), 1-thread
# window (warm, timed), on the fixed path). A loader thread builds a whole
# batch, so 4 threads hand batches over in bursts of 4: a 4-thread window
# spans RT_WORKERS steps, past the first burst where it can (BEVDet4D's
# five batches of 8 hold one burst and the first batch of the next: its
# window runs from the first step's entry); a batch-8 BEVDet4D batch (96
# decodes and BICUBIC resizes of a 1600 x 900 view) is ~17 s of one
# thread's work, so its 1-thread window is a step long
MV_TIMED = {"BEVDet4D": (BEVDET, (0, RT_WORKERS), (0, 1), False),
            "PETR": (PETR_V1, (RT_WORKERS, RT_WORKERS), (1, 2), True),
            "BEVFusion L+C": (BEVF, (RT_WORKERS, RT_WORKERS), (1, 2),
                              False)}
# the untimed legs: label -> config; a Trainer step on one batch, then
# evaluate() over one batch of the val split
MV_UNTIMED = {"BEVFormer": BEVFORMER, "CAPE-T": CAPE_T_V99,
              "RTEBev": RTEBEV, "PETRv2-BEVseg": PETR_SEG,
              "BEVFusion-cam": BEVF_CAM, "BEV-LaneDet": LANEDET}
MV_METRICS = ("mAP", "NDS", "F-score", "IoU_drive", "IoU_lane",
              "IoU_vehicle")


@contextlib.contextmanager
def recorded_pools():
    """-> list of (rows, cells, grad) of each sorted_segment_sum(_split)
    call in the block (the camera pools, BEVFusion's pillar scatter):
    grad when its rows carry a gradient, so that the step's backward runs
    its VJP (K5) once."""
    import torch

    from paddle3d_tpu_torch.ops import sorted_scatter
    calls = []

    def recorder(orig):
        def rec(keys, rows, num_cells):
            calls.append((keys.shape[1], num_cells, bool(
                rows.requires_grad and torch.is_grad_enabled())))
            return orig(keys, rows, num_cells)
        return rec
    with mock.patch.object(sorted_scatter, "sorted_segment_sum", recorder(
            sorted_scatter.sorted_segment_sum)), \
            mock.patch.object(sorted_scatter, "sorted_segment_sum_split",
                              recorder(
                                  sorted_scatter.sorted_segment_sum_split)):
        yield calls


@contextlib.contextmanager
def first_calls(obj, name, k):
    """The arguments of the first k calls of obj.name in the block (tensors
    detached): -> list of argument tuples."""
    import torch
    calls = []
    fn = getattr(obj, name)

    def rec(*args):
        if len(calls) < k:
            calls.append(tuple(a.detach() if isinstance(a, torch.Tensor)
                               else a for a in args))
        return fn(*args)
    with mock.patch.object(obj, name, rec):
        yield calls


def pool_launches(pools):
    """The launches of recorded pools: each pool's route by the density
    rule (K7 dense, K2 sparse), and a VJP (K5) for each that carries a
    gradient."""
    out = with_scatters({}, [(n, cells) for n, cells, _ in pools])
    grads = sum(g for _, _, g in pools)
    if grads:
        out["sorted_table_gather"] = grads
    return out


def held_kernels(label, fwd, bwd):
    """K2 / K7 at a leg's first pools (scatter_rows' arguments: the route
    by the density rule) and K5 at its first VJP, each bit for bit against
    the row-order sum or its plain version and a second call, and timed:
    -> {kernel: (ms through the wrapper, max_abs_err)}."""
    from paddle3d_tpu_torch.ops import sorted_scatter
    held = {}
    where = "{}'s Trainer step".format(label)
    for keys, rows, cells, split in fwd:
        dense = sorted_scatter.kernel_for(
            rows.shape[1], cells) == "sorted_segment_sum_dense"
        if ("K7" if dense else "K2") in held:
            continue
        if dense:
            parts, err = k7_parts(where, keys, rows, cells, split,
                                  iters=MV_KERNEL_ITERS)
            held["K7"] = (parts["wrapper"], err)
        else:
            err, ms = k2_call(where, keys, rows, cells, split)[:2]
            held["K2"] = (ms, err)
    for args in bwd[:1]:
        parts, err, _ = k5_parts("{}'s Trainer backward".format(label),
                                 *args, iters=MV_KERNEL_ITERS)
        held["K5"] = (parts["wrapper"], err)
    return held


def jpeg_checks(root):
    """The port's JPEG decoder on the card's host: the native decoder equal
    to the plain one byte for byte on a 37 x 53 image of every supported
    form (4:4:4, 4:2:2, 4:2:0, 4:4:0, grey; a restart marker every 2
    MCUs) and on one full camera view of the tree; the native decode of
    that view timed. -> (forms checked, {"native_ms", "plain_s", "hw",
    "kib"})."""
    import numpy as np

    from paddle3d_tpu_torch.utils import jpeg
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    forms = [(s, img) for s in JPEG_SAMPLING] + [("grey", img[..., 0])]
    for form, im in forms:
        data = jpeg_bytes(im, 75, "4:4:4" if form == "grey" else form, 2)
        check(np.array_equal(jpeg.decode_jpeg(data),
                             jpeg.decode_jpeg_plain(data)),
              "{}: the native JPEG decoder differs from the plain one"
              .format(form))
    path = os.path.join(root, "samples", "CAM_FRONT")
    path = os.path.join(path, sorted(os.listdir(path))[0])
    with open(path, "rb") as f:
        data = f.read()
    native = jpeg.decode_jpeg(data)
    t0 = time.perf_counter()
    for _ in range(MV_DECODES):
        jpeg.decode_jpeg(data)
    native_ms = 1e3 * (time.perf_counter() - t0) / MV_DECODES
    t0 = time.perf_counter()
    plain = jpeg.decode_jpeg_plain(data)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(native, plain), "{}: the native JPEG decoder "
          "differs from the plain one".format(path))
    return [f for f, _ in forms], {"native_ms": native_ms,
                                   "plain_s": plain_s,
                                   "hw": native.shape[:2],
                                   "kib": len(data) / 1024}


def mv_loader_parts(label, ds, n=MV_PARTS):
    """ds.get(i) for the first n samples on this thread, its parts timed:
    -> {part: ms a sample}: decode (the JPEG reads), resize (the dataset's
    BICUBIC resizes to its image_size), transforms (the pipeline: its
    BILINEAR resizes, LoadPointCloud's sweeps), depth map (with_depth's
    maps; the multi-modality set's Gaussian targets, its maps within),
    with the sample's whole time."""
    from paddle3d_tpu_torch.datasets.nuscenes import (
        nuscenes_multi_modality as mm, nuscenes_multiview_det as mv)
    from paddle3d_tpu_torch.transforms import base
    depth = ((mm.NuscenesMMDataset, "_gaussian_depth_targets")
             if isinstance(ds, mm.NuscenesMMDataset) else
             (mv.NuscenesMVDataset, "_depth_maps"))
    targets = [("decode", mv, "read_image"), ("resize", mv, "resize"),
               ("transforms", base.Compose, "__call__"),
               ("depth map",) + depth]
    with timed_calls(targets) as ms:
        t0 = time.perf_counter()
        for i in range(n):
            ds.get(i)
        total = time.perf_counter() - t0
    out = {k: sum(v) / n for k, v in ms.items() if v}
    out["sample"] = 1e3 * total / n
    log("  {}: the loader's host work a sample on one thread, ms (over the "
        "first {} train samples): {}".format(label, n, {
            k: round(v, 3) for k, v in out.items()}))
    return out


class Recording:
    """A loader that keeps the host batches it hands out."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for item in self.loader:
            self.batches.append(item[0])
            yield item


def first_frames(ds, n):
    """A shallow copy of a nuScenes or Apollo dataset that holds its first
    n frames."""
    import copy
    ds = copy.copy(ds)
    if hasattr(ds, "sample_tokens"):
        ds.sample_tokens = ds.sample_tokens[:n]
    else:
        ds.annos = ds.annos[:n]
    return ds


def mv_leg(device, label, dic, tmp, warm, timed, t1, fixed):
    """One full-width multi-view config through Config(dic=...) on device
    (torch's cuDNN defaults, as tools/train.py leaves them; on the fixed
    path, deterministic mode, as falling_losses(fixed=True)): the loader's
    two batches of MV_CHECK_BATCH at 1 and RT_WORKERS threads (sha256),
    the loader's work a sample by part; a Trainer (EMA, RT_WORKERS
    threads) run of warm + timed + 1 steps over a train split of that many
    batches (no batch is built past the run) with its window timed: finite
    losses, the last under the first, launches against the recorded
    pools' routes, K2 / K7 at its first pools and K5 at its first VJP held
    (held_kernels), peak memory; a Trainer at 1 thread (window t1 = (warm,
    timed)), one on the run's own batches prebuilt and the bare step on
    them; evaluate() in parts with its launches and NuScenesMetric. -> a
    dict of the leg's numbers."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config, Trainer
    from paddle3d_tpu_torch.apis.trainer import to_device
    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    t_leg = time.perf_counter()
    torch.manual_seed(SEED)
    cfg = Config(dic=dic, device=device)
    bs = cfg.batch_size
    t0 = time.perf_counter()
    # a split of the two batches alone: no batch is built past them
    two = first_frames(cfg.train_dataset, 2 * MV_CHECK_BATCH)
    h1, h4 = (batch_hashes(two, MV_CHECK_BATCH, w) for w in (1, RT_WORKERS))
    log("  {}: the loader's two batches of {} at 1 and {} threads equal "
        "(sha256 of every collated array, {}): {} ({:.1f} s)".format(
            label, MV_CHECK_BATCH, RT_WORKERS, sorted(h1[0]), h1 == h4,
            time.perf_counter() - t0))
    check(h1 == h4, "{}: the batches depend on the thread count".format(
        label))
    parts = mv_loader_parts(label, cfg.train_dataset)

    def path():
        return fixed_path() if fixed else contextlib.nullcontext()
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    steps = warm + timed + 1

    def trainer_of(name, frames, **kw):
        return Trainer(model=cfg.model, optimizer=cfg.optimizer,
                       lr_scheduler=cfg.lr_scheduler, iters=0,
                       train_dataset=first_frames(cfg.train_dataset,
                                                  frames),
                       val_dataset=cfg.val_dataset, batch_size=bs,
                       save_dir=os.path.join(tmp, label + name),
                       ema_decay=RT_EMA, log_interval=0, save_interval=0,
                       **kw)
    trainer = trainer_of("_t4", steps * bs,
                         dataloader_fn={"num_workers": RT_WORKERS})
    trainer.train_dataloader = Recording(trainer.train_dataloader)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with path(), recorded_losses(trainer) as losses, \
            recorded_pools() as pools, \
            first_calls(sorted_scatter, "scatter_rows", 2) as fwd, \
            first_calls(sorted_scatter, "sorted_table_gather", 1) as bwd:
        rate4, _, waits, host4 = windowed_trainer_run(
            trainer, warm=warm, timed=timed)
    trained = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = [v.item() for v in losses]
    step_want = pool_launches(pools[:len(pools) // steps])
    want = {k: v * steps for k, v in step_want.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    log("  {}: {} Trainer steps at batch {} ({}); losses {}; launches {} "
        "(want {}: {} a step); peak device memory {:.1f} MiB".format(
            label, steps, bs, "the fixed path" if fixed else
            "torch's cuDNN defaults", [round(v, 4) for v in losses],
            trained, want, step_want, peak))
    check(all(np.isfinite(losses)) and len(losses) == steps,
          "{}: non-finite or missing losses".format(label))
    check(losses[-1] < losses[0], "{}: the loss did not fall: {:.4f} at the "
          "last step against {:.4f} at the first".format(
              label, losses[-1], losses[0]))
    check(trained == want, "{}: train launches off the derived ones"
          .format(label))
    held = held_kernels(label, fwd, bwd)
    del fwd, bwd
    host = trainer.train_dataloader.batches
    with path():
        rate1, _, waits1, host1 = windowed_trainer_run(
            trainer_of("_t1", sum(t1) * bs + bs,
                       dataloader_fn={"num_workers": 1}),
            warm=t1[0], timed=t1[1])
        pre = trainer_of("_pre", steps * bs)
        pre.train_dataloader = Prebuilt(host)
        ratep, _, _, hostp = windowed_trainer_run(pre, warm=warm,
                                                  timed=timed)
        dev = [to_device(b, device) for b in host[:timed]]
        bare, bare_host = timed_bare_steps(trainer, dev)
    del pre, dev, host

    def ms(xs):
        return round(1e3 * float(np.mean(xs)), 3) if len(xs) else None
    log("  {}: frames/s (t4: {} steps from step {}; t1: {} from step {}; "
        "prebuilt, bare: as t4): Trainer {} threads {:.2f}, 1 thread {:.2f}, "
        "prebuilt batches {:.2f}, bare make_train_step {:.2f} (runtime cost "
        "{:.1f} % at {} threads, {:.1f} % at 1, {:.1f} % prebuilt); step "
        "call host ms {} / {} / {} (bare {}); reader wait a step in the "
        "window, ms: {} threads {}, 1 thread {}".format(
            label, timed, warm, t1[1], t1[0], RT_WORKERS, rate4, rate1,
            ratep, bare, 100 * (1 - rate4 / bare), RT_WORKERS,
            100 * (1 - rate1 / bare), 100 * (1 - ratep / bare), ms(host4),
            ms(host1), ms(hostp), ms(bare_host), RT_WORKERS,
            ms(waits[warm + 1:]), ms(waits1[t1[0] + 1:])))
    before = dict(_build.LAUNCHES)
    with recorded_pools() as pools:
        metrics, eparts, ewall = eval_parts(trainer)
    served = counts_sub(_build.LAUNCHES, before)
    nval = len(trainer.val_dataset)
    forwards = -(-nval // bs)
    swant = {k: v * forwards for k, v in pool_launches(
        pools[:len(pools) // forwards]).items()}
    log("  {}: evaluate(): {} val frames in {:.3f} s ({:.2f} frames/s): "
        "device forward {:.3f} s, postprocess {:.3f} s, metric {:.3f} s; "
        "launches {} (want {}); metrics {}".format(
            label, nval, ewall, nval / ewall, eparts["forward"],
            eparts["postprocess"], eparts["metric"], served, swant,
            {k: round(v, 4) for k, v in metrics.items()
             if k in MV_METRICS}))
    check(served == swant, "{}: eval launches off the derived ones".format(
        label))
    finite_metrics(label, ["mAP", "NDS"])(metrics)
    rec = dict(t4=rate4, t1=rate1, prebuilt=ratep, bare=bare, peak=peak,
               eval_s=ewall, first=losses[0], last=losses[-1],
               secs=time.perf_counter() - t_leg)
    rec.update({"ms " + k: v for k, v in parts.items()})
    rec.update({"{} ms".format(k): v[0] for k, v in held.items()})
    log("  {}: leg took {:.1f} s".format(label, rec["secs"]))
    del trainer, cfg
    torch.cuda.empty_cache()
    return rec


def mv_step_leg(device, label, dic, tmp):
    """One full-width config through Config(dic=...) on device: a Trainer
    step (EMA) on a train split of one batch (finite loss; launches against
    the recorded pools' routes), then evaluate() over the first batch of
    the val split through the dataset's metric (finite). -> seconds."""
    import numpy as np
    import torch

    from paddle3d_tpu_torch.apis import Config, Trainer
    from paddle3d_tpu_torch.ops import _build
    t0 = time.perf_counter()
    torch.manual_seed(SEED)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    cfg = Config(dic=dic, device=device)
    bs = cfg.batch_size
    trainer = Trainer(model=cfg.model, optimizer=cfg.optimizer,
                      lr_scheduler=cfg.lr_scheduler, iters=1,
                      train_dataset=first_frames(cfg.train_dataset, bs),
                      val_dataset=first_frames(cfg.val_dataset, bs),
                      batch_size=bs, save_dir=os.path.join(tmp, label),
                      ema_decay=RT_EMA, log_interval=0, save_interval=0,
                      dataloader_fn={"num_workers": RT_WORKERS})
    _build.reset_launches()
    with recorded_losses(trainer) as losses, recorded_pools() as pools, \
            mock.patch.object(trainer, "_save_checkpoint", lambda: None):
        trainer.train()
    trained = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = [v.item() for v in losses]
    step_want = pool_launches(pools)
    _build.reset_launches()
    with recorded_pools() as pools:
        metrics = trainer.evaluate()
    served = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = pool_launches(pools)
    keys = [k for k in MV_METRICS if k in metrics]
    secs = time.perf_counter() - t0
    log("  {}: a Trainer step at batch {}: loss {}; launches {} (want {}); "
        "evaluate() over {} val frames: launches {} (want {}); metrics {} "
        "({:.1f} s)".format(
            label, bs, [round(v, 4) for v in losses], trained, step_want,
            len(trainer.val_dataset), served, want,
            {k: round(metrics[k], 4) for k in keys}, secs))
    check(len(losses) == 1 and np.isfinite(losses).all(),
          "{}: a non-finite or missing loss".format(label))
    check(trained == step_want and served == want,
          "{}: launches off the derived ones".format(label))
    check(keys and all(np.isfinite(metrics[k]) for k in keys),
          "{}: non-finite metrics".format(label))
    del trainer, cfg
    torch.cuda.empty_cache()
    return secs


def mv_trees(tmp):
    """Phase 30's trees under tmp: phase 28's nuScenes tree (P28_NUSC key
    frames, seed SEED + 3) with six NUSC_CAM_HW JPEG views a key frame and
    BEV maps of MV_SEG_MAP, and an Apollo tree of MV_APOLLO frames. ->
    {"nuscenes", "apollo", "secs"}."""
    t0 = time.perf_counter()
    nusc, apollo = (os.path.join(tmp, d) for d in ("nuscenes", "apollo"))
    nuscenes_tree(nusc, *P28_NUSC, seed=SEED + 3, cameras=NUSC_CAM_HW,
                  maps=MV_SEG_MAP)
    apollo_tree(apollo, *MV_APOLLO, seed=SEED + 6)
    return {"nuscenes": nusc, "apollo": apollo,
            "secs": time.perf_counter() - t0}


def phase_mv_runtime(device, prep=None):
    """Phase 30: the nuScenes multi-view and Apollo camera runtime, each leg
    through Config -> Trainer -> DataLoader -> the dataset (JPEG views read
    by the port's decoder, Pillow's BICUBIC resize) -> transforms ->
    collate -> train step -> evaluate -> postprocess_to_samples -> metric:
    the JPEG decoder's checks; BEVDet4D (batch 8, an adjacent frame), PETR
    (batch 2, the full multi-view pipeline with GridMask) and BEVFusion
    L+C (batch 2, points and views) timed (mv_leg); BEVFormer, CAPE-T,
    RTEBev (with_depth), PETRv2-BEVseg (NuScenesSegMetric), BEVFusion's
    camera config and BEV-LaneDet (ApolloLaneMetric) a step and an
    evaluate() batch each (mv_step_leg). prep: mv_trees' result (main()
    has phase 28 write them beside phase 27's CLI); without it the phase
    writes its own under a temp dir."""
    import tempfile
    t_phase = time.perf_counter()
    if not prep:
        with tempfile.TemporaryDirectory() as tmp:
            prep = mv_trees(tmp)
            prep["where"] = "before the legs"
            return phase_mv_runtime(device, prep)
    nusc, apollo = prep["nuscenes"], prep["apollo"]
    tmp = os.path.dirname(nusc)
    log("phase 30: the nuScenes multi-view and Apollo camera runtime; the "
        "nuScenes tree's {} + {} key frames with six {} x {} JPEG views each "
        "({} distinct a camera) and BEV maps of {} x {}, an Apollo tree of "
        "{} + {} frames of {} x {} (written in {:.1f} s {})".format(
            *P28_NUSC, *NUSC_CAM_HW, NUSC_CAM_VARIANTS, *MV_SEG_MAP,
            *MV_APOLLO, *APOLLO_HW, prep["secs"],
            prep.get("where", "beside phase 27's CLI")))
    forms, view = jpeg_checks(nusc)
    log("  the native JPEG decoder byte-equal to the plain one on {} and on "
        "a full {} x {} view ({:.1f} KiB): native {:.3f} ms a decode (mean "
        "of {}), plain {:.2f} s".format(
            forms, *view["hw"], view["kib"], view["native_ms"], MV_DECODES,
            view["plain_s"]))
    legs = {}
    for label, (path, (warm, timed), t1, fixed) in MV_TIMED.items():
        legs[label] = mv_leg(device, label, camera_dic(path, nusc), tmp,
                             warm, timed, t1, fixed)
    steps = {label: mv_step_leg(device, label, camera_dic(
        path, apollo if path == LANEDET else nusc), tmp)
        for label, path in MV_UNTIMED.items()}
    log("  phase 30: {}; untimed legs, s: {}; the decoder: {}".format(
        {k: {n: round(x, 3) for n, x in v.items()} for k, v in legs.items()},
        {k: round(v, 1) for k, v in steps.items()},
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in view.items()}))
    log("  phase 30 took {:.1f} s (its trees written before it)".format(
        time.perf_counter() - t_phase))
    return legs


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def k1_parts(label, keys, pts_t, w1t, b1, kw, iters=50):
    """The one-layer K1 timed in parts (CUDA events, ms a call) at one call
    of a path: its C entry alone (buffers made before), the whole wrapper,
    and pillar_ordinals, the cap input that the earlier 128-row-block
    wrapper computed before its kernel (timed at these keys). kw: the
    wrapper's keywords but n_layers. -> dict of part -> ms."""
    import torch

    from paddle3d_tpu_torch.ops import _build, fused_pfn
    b, c_in, n = pts_t.shape
    u1, c_dec = w1t.shape
    occ = int(kw["occupancy"])
    out = torch.empty((b, u1 + occ, n), device=keys.device)
    fn = _build.function("p3d_fused_pfn_rows")
    args = (keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            out.data_ptr(), fused_pfn.spans(b, n, keys.device), b, n, c_in,
            c_dec, u1, kw["P"], kw["maxV"], kw["nx"], kw["vx"], kw["vy"],
            kw["x_off"], kw["y_off"], int(kw["with_distance"]), occ,
            _build.stream_ptr(keys.device))
    parts = {
        "kernel alone": cuda_ms(lambda: fn(*args), iters),
        "wrapper": cuda_ms(lambda: fused_pfn.fused_pfn_rows(
            keys, pts_t, w1t, b1, n_layers=1, **kw), iters),
        "pillar_ordinals": cuda_ms(lambda: fused_pfn.pillar_ordinals(keys),
                                   iters)}
    log("  K1 one layer at {}, ms a call: {}".format(
        label, ", ".join("{} {:.4f}".format(k, v) for k, v in parts.items())))
    return parts


def k1_train_call(model, points):
    """What the KITTI train forward hands the one-layer K1: its inputs at
    max_voxels 16,000 and the weights folded with the batch statistics, as
    fused_pfn_train_rows computes them. -> (keys, pts_t, w1t, b1, kw
    without n_layers)."""
    import torch

    from paddle3d_tpu_torch.ops import fused_pfn, fused_pfn_train, pillar_ops
    vox, pfn, mid = model.voxelizer, model.pillar_encoder, \
        model.middle_encoder
    keys, pts_t = pillar_ops.sort_points_by_cell(points, vox.voxel_size,
                                                 vox.point_cloud_range)
    mlp = pfn.pfn_layers[0].mlp
    calls = []
    fn = fused_pfn.fused_pfn_rows

    def rec(*a, **k):
        calls.append((a, k))
        return fn(*a, **k)
    with torch.no_grad(), mock.patch.object(fused_pfn, "fused_pfn_rows", rec):
        fused_pfn_train.fused_pfn_train_rows(
            keys, pts_t, mlp.linear.weight, mlp.bn.weight, mlp.bn.bias,
            P=pfn.max_num_points_in_voxel,
            maxV=vox.max_num_voxels_for(True), nx=mid.nx, vx=pfn.vx,
            vy=pfn.vy, x_off=pfn.x_offset, y_off=pfn.y_offset,
            with_distance=pfn.with_distance, occupancy=True,
            eps=mlp.bn.eps)
    check(len(calls) == 1, "expected one K1 call in the train forward")
    (keys, pts_t, w1t, b1), kw = calls[0]
    check(kw.pop("n_layers") == 1 and kw["maxV"] == 16000,
          "not the KITTI train K1 call")
    return keys, pts_t, w1t, b1, kw


def k7_parts(label, keys, rows, cells, split, iters=50):
    """K7 at one call of a path, on the inputs the path handed it: bit for
    bit against the row-order sum and a second call (tolerance 0), then its
    wrapper (scatter_rows) and its C entry alone (buffers made before)
    timed, with index_add_call, their factor and the bound. -> (dict of
    part -> ms, max_abs_err against the row-order sum)."""
    import torch

    from paddle3d_tpu_torch.ops import _build, sorted_scatter
    keys, rows = keys.detach().contiguous(), rows.detach().contiguous()
    b, n, c = rows.shape
    check(sorted_scatter.kernel_for(n, cells) == "sorted_segment_sum_dense",
          "{}: the density rule does not send this scan to K7".format(label))
    out = torch.empty((b, cells, c - int(split)), device=keys.device)
    extra = torch.empty((b, cells, 1), device=keys.device) if split else None
    fn = _build.function("p3d_sorted_segment_sum_dense")
    args = (keys.data_ptr(), rows.data_ptr(), out.data_ptr(),
            extra.data_ptr() if split else None, b, n, c, cells,
            _build.stream_ptr(keys.device))
    got, again = (sorted_scatter.scatter_rows(keys, rows, cells, split)
                  for _ in range(2))
    if split:
        got, again = torch.cat(got, dim=-1), torch.cat(again, dim=-1)
    ref = row_order_sum(keys, rows, cells)
    check(same_bits(got, ref) and same_bits(again, got), "{}: K7 differs "
          "from the row-order sum or from a second call".format(label))
    err = (got - ref).abs().max().item()
    del got, again, ref
    parts = {"wrapper": cuda_ms(lambda: sorted_scatter.scatter_rows(
                 keys, rows, cells, split), iters),
             "kernel alone": cuda_ms(lambda: fn(*args), iters),
             "index_add_call": cuda_ms(index_add_call(keys, rows, cells), 10)}
    bnd = bound(scatter_bytes(keys, cells, c, b * cells * c))
    log("  K7 at {}: B={} N={} C={}{} cells={}, bit-equal to the row-order "
        "sum and a second call; ms a call: {}; kernel / library {:.3f}; "
        "bound {:.4f} ms ({})".format(
            label, b, n, c, " (split)" if split else "", cells,
            ", ".join("{} {:.4f}".format(k, v) for k, v in parts.items()),
            parts["wrapper"] / parts["index_add_call"], *bnd))
    return parts, err


def smoke_decode_inputs(device, b=SMOKE_BATCH, k=50, reg=10):
    """K14's inputs at SMOKE's decode without the model (another tree may
    have none): a random NCHW regression map [b, reg, H/4, W/4] as the
    [b, H*W/16, reg] view the decode hands it, and k distinct positions a
    frame, as its top-k gives them."""
    import torch
    hw = (SMOKE_HW[0] // 4, SMOKE_HW[1] // 4)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    nchw = torch.randn((b, reg) + tuple(hw), generator=gen).to(device)
    idx = torch.stack([torch.randperm(hw[0] * hw[1], generator=gen)[:k]
                       for _ in range(b)]).to(torch.int32).to(device)
    return nchw.flatten(2).transpose(1, 2), idx


def parts_one(tree):
    """One process of `--parts`: the package of `tree` (a checkout, first
    on sys.path) built, then K14 held bit for bit and timed in parts
    (k14_parts) at four shapes: gather.py's 8 x 1,000 rows of 7 from
    107,136, a voxel-row gather's 4 x 120,000 rows of 64 from 160,000,
    SMOKE's decode, 8 x 50 rows of 10 from the NCHW map's 30,720 cells
    read in place (smoke_decode_inputs), and 8 x 100,000 rows of 3."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle3d_tpu_torch
    log("card: {}; parts of the package in {}".format(
        card(), os.path.dirname(os.path.dirname(
            os.path.abspath(paddle3d_tpu_torch.__file__)))))
    phase_build()
    dev = torch.device("cuda")
    for case in GATHER_CASES:
        k14_parts("gather.py's shape" if case[2] == 7 else
                  "a voxel-row gather", *gather_inputs(dev, *case))
    k14_parts("SMOKE's decode", *smoke_decode_inputs(dev))
    # rows of 3 floats, 8 x 100,000 from 100,000: the flat form past one
    # launch's latency
    k14_parts("narrow rows", *gather_inputs(dev, 8, 100000, 3, 100000))


def parts_main(trees):
    """`python3 chip_smoke.py --parts TREE [TREE ...]`: parts_one for each
    checkout in turn, each in a process of its own (a package is imported
    once a process), on one card: list parent, change, change, parent to
    compare two trees within one call."""
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--parts-one", os.path.abspath(tree)], check=True)


PHASE_SECONDS = {}


def timed(fn, *args):
    """fn(*args), its host seconds added to PHASE_SECONDS under its name."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[fn.__name__] = (PHASE_SECONDS.get(fn.__name__, 0.0) +
                                      time.perf_counter() - t0)


def main():
    # phase 11's deterministic steps need cuBLAS's fixed workspace, set
    # before any cuBLAS handle exists
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import tempfile
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false)")
    sys.path.insert(0, REPO)
    try:
        import bench  # noqa: F401  (make_scans: numpy only)
        from paddle3d_tpu_torch.apis import Config
    except ImportError as e:
        sys.exit("chip_smoke: the port is not beside this script: {}"
                 .format(e))
    card_line = card()
    log("card: {}".format(card_line))
    # f32 comparisons: no TF32 in convolutions or matmuls; deterministic
    # cuDNN so that the kernel and plain paths see the same conv arithmetic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        timed(phase_build)
        device = torch.device("cuda")
        model = Config(path=KITTI, device=device).model.eval()
        points = make_points(device)
        errs, times, extra = timed(phase_kernels, model, points)
        for into, part in zip((errs, times, extra),
                              timed(phase_train_kernels, model, points)):
            into.update(part)
        launches = timed(phase_model, model, points)
        timed(phase_tiny_canvas)
        timed(phase_timing, model, points)
        del model
        # K1/K2 counted on the KITTI inference path, K3-K5 on the train
        # path, the two-layer K1 and K6 on the CenterPoint path
        launches = {**timed(phase_train, points),
                    **{k: launches[k] for k in INFER_KERNELS}}
        cp_errs, cp_times, cp_extra, cp_launches = timed(
            phase_centerpoint, device)
        for into, part in zip((errs, times, extra, launches),
                              (cp_errs, cp_times, cp_extra,
                               {k: cp_launches[k] for k in CP_KERNELS})):
            into.update(part)
        # K7 and K8 counted on the CenterPoint-voxels path
        vx_errs, vx_times, vx_extra, vx_launches = timed(
            phase_voxels, device)
        for into, part in zip((errs, times, extra, launches),
                              (vx_errs, vx_times, vx_extra,
                               {k: vx_launches[k] for k in VX_KERNELS})):
            into.update(part)
        # K9 and K10 counted on the PV-RCNN path (their times: the seven
        # and the one call of its forward); Voxel-RCNN and IA-SSD run them
        # at other shapes
        pv_errs, pv_times, pv_extra, pv_launches = timed(
            phase_two_stage, device, PV_RCNN, "PV-RCNN",
            {"ball_query": 7, "farthest_point_sample": 1,
             "sparse_conv3d": 8, "sparse_conv3d_map": 7})
        for into, part in zip((errs, times, extra, launches),
                              (pv_errs, pv_times, pv_extra,
                               {k: pv_launches[k] for k in PT_KERNELS})):
            into.update(part)
        timed(phase_two_stage, device, VOXEL_RCNN, "Voxel-RCNN",
              {"ball_query": 2, "farthest_point_sample": 0,
               "sparse_conv3d": 8, "sparse_conv3d_map": 7})
        timed(phase_iassd, device)
        # K12 counted on the CenterPoint-pillars train path
        sw_errs, sw_times, sw_extra, sw_launches = timed(
            phase_cp_train, device)
        for into, part in zip((errs, times, extra, launches),
                              (sw_errs, sw_times, sw_extra,
                               {k: sw_launches[k] for k in SW_KERNELS})):
            into.update(part)
        # K11 counted on the Voxel-RCNN train path
        ts_errs, ts_times, ts_extra, ts_launches = timed(
            phase_ts_train, device)
        for into, part in zip((errs, times, extra, launches),
                              (ts_errs, ts_times, ts_extra,
                               {"pairwise_intersection_area": ts_launches[
                                   "pairwise_intersection_area"]})):
            into.update(part)
        # K13 counted on phase 12's op calls
        op_errs, op_times, op_extra, op_launches = timed(
            phase_ops, device)
        for into, part in zip((errs, times, extra, launches),
                              (op_errs, op_times, op_extra,
                               {"sorted_segment_sum_rw": op_launches[
                                   "sorted_segment_sum_rw"]})):
            into.update(part)
        timed(phase_vx_train, device)
        timed(phase_ia_train, device)
        # K14 counted on SMOKE's serving path (phase 12 runs it as an op)
        for into, part in zip((errs, times, extra, launches),
                              timed(phase_smoke, device)):
            into.update(part)
        # K7, K5 and K2 at CADDN's calls, entries of their own
        caddn = timed(phase_caddn, device)
        # PETR reaches no hand-written kernel
        timed(phase_petr, device)
        # nor does BEVFormer; K7 and K5 at BEVDet4D's calls, entries of
        # their own
        timed(phase_bevformer, device)
        bevdet = timed(phase_bevdet, device)
        # CAPE reaches no hand-written kernel; K7 and K5 at RTEBev's calls,
        # entries of their own
        timed(phase_cape, device)
        rtebev = timed(phase_rtebev, device)
        # K2, K7 and both K5 at BEVFusion's calls, entries of their own
        bevfusion = timed(phase_bevfusion, device)
        # DD3D reaches no hand-written kernel
        timed(phase_dd3d, device)
        # nor do SqueezeSegV3, PAConv and BEV-LaneDet
        timed(phase_squeezeseg, device)
        timed(phase_paconv, device)
        timed(phase_lanedet, device)
        # the runtime: the KITTI kernels reached through the Trainer and
        # evaluate() (K1, K3, K4, K5 and, by the density rule, K7 / K6)
        # and the runtime's other LiDAR configs: PV-RCNN and
        # CenterPoint-KITTI, CenterPoint-nuScenes, IA-SSD-Waymo through
        # their Trainers; their trees and databases built while phase 27
        # waits for its CLI processes
        # and the runtime's camera path: SMOKE's K14 in evaluate(), CADDN's
        # K7 and K5 (and the tiny CADDN's K2) by the density rule, its tree
        # written beside phase 28's database processes
        # and the nuScenes multi-view and Apollo runtime: K2, K7 and K5 by
        # the density rule in BEVDet4D's, BEVFusion's and RTEBev's Trainer
        # steps and forwards, on phase 28's nuScenes tree with cameras
        with tempfile.TemporaryDirectory() as p28_tmp:
            prep, cam = {}, {}
            timed(phase_runtime, device,
                  lambda: prep.update(phase_lidar_runtime_prep(
                      p28_tmp, lambda: cam.update(camera_tree(p28_tmp)))))
            timed(phase_lidar_runtime, device, prep)
            timed(phase_camera_runtime, device, cam)
            timed(phase_mv_runtime, device, prep["mv"])
    except PhaseError as e:
        # the phase that failed: its name from the innermost phase_ frame
        import traceback
        where = [f.name for f in traceback.extract_tb(e.__traceback__)
                 if f.name.startswith("phase_")]
        sys.exit("chip_smoke: FAILED in {}: {}".format(
            where[-1] if where else "main", e))
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": extra[name][1], "bound_by": extra[name][2],
         "library_ms": extra[name][0]}
        for name, (src, tpu, _) in KERNELS.items()] + caddn + bevdet +
        rtebev + bevfusion}
    log("seconds by phase: {}; all {:.1f} s".format(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()},
        time.perf_counter() - _START))
    log(card_line)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parts"]:
        parts_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--parts-one"]:
        sys.path.insert(0, sys.argv[2])
        parts_one(sys.argv[2])
    else:
        main()
